"""Dream backbone + sampler parity vs the reference torch implementation."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from lavida_mod.config import DreamGenerationConfig
from lavida_mod.generation.dream_sampler import dream_generate
from lavida_mod.models import llada as jl
from lavida_mod.models.dream import convert_dream_state_dict, tiny_dream_config

MASK_ID = 500


@pytest.fixture(scope="module")
def ref_dream(reference_llava):
    import llava.model.language_model.dream.modeling_dream as md
    from llava.model.language_model.dream.configuration_dream import DreamConfig

    cfg = DreamConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=10000.0, mask_token_id=MASK_ID, pad_token_id=501,
        attn_implementation="sdpa",
    )
    torch.manual_seed(0)
    model = md.DreamModel(cfg)
    model.eval()
    return md, model


@pytest.fixture(scope="module")
def tiny_pair(ref_dream):
    _, ref_model = ref_dream
    state = {k: v.detach().numpy() for k, v in ref_model.state_dict().items()}
    cfg = tiny_dream_config()
    params = convert_dream_state_dict(state, cfg, dtype=jnp.float32)
    return ref_model, cfg, params


def test_dream_backbone_parity(tiny_pair):
    ref_model, cfg, params = tiny_pair
    ids = np.arange(5, 21)[None]
    with torch.no_grad():
        ref_logits = ref_model(torch.from_numpy(ids)).logits.numpy()
    ours, _ = jl.forward(params, cfg, jl.embed_tokens(params, jnp.asarray(ids)))
    np.testing.assert_allclose(np.asarray(ours), ref_logits, atol=3e-4, rtol=1e-3)


def _make_ref_cache():
    """DreamPrefixLMCache with the new transformers Cache.__init__ bypassed
    (the vendored class predates the layers-based Cache API)."""
    from llava.model.language_model.dream.modeling_dream import DreamPrefixLMCache

    c = DreamPrefixLMCache.__new__(DreamPrefixLMCache)
    c.past_key_values = {}
    return c


def test_dream_cached_decode_parity(tiny_pair):
    """Cached decode == reference DreamPrefixLMCache semantics
    (modeling_dream.py:660-692): prefix written once, decode positions
    continue at past_len."""
    ref_model, cfg, params = tiny_pair
    prompt = np.arange(3, 13)[None]
    gen = np.arange(100, 106)[None]

    with torch.no_grad():
        cache_t = _make_ref_cache()
        ref_model.model(torch.from_numpy(prompt), use_cache=True,
                        past_key_values=cache_t)
        ref_out = ref_model(
            torch.from_numpy(gen), past_key_values=cache_t, use_cache=True,
        ).logits.numpy()

    _, cache = jl.forward(
        params, cfg, jl.embed_tokens(params, jnp.asarray(prompt)),
        use_cache=True, return_logits=False,
    )
    ours, _ = jl.forward(
        params, cfg, jl.embed_tokens(params, jnp.asarray(gen)),
        positions=jnp.arange(10, 16), kv_cache=cache,
    )
    np.testing.assert_allclose(np.asarray(ours), ref_out, atol=3e-4, rtol=1e-3)


def _ref_dream_sample(ref_model, prompt_ids, gen_cfg: DreamGenerationConfig):
    """Literal torch re-execution of generation_utils.py:409-527 (prefix_lm
    path, temp 0) against the reference backbone."""
    G = gen_cfg.max_new_tokens
    steps0 = min(gen_cfg.steps, G)
    timesteps = torch.linspace(1, gen_cfg.eps, steps0 + 1)
    steps = (int(G * gen_cfg.step_ratio) if gen_cfg.step_ratio else steps0)

    with torch.no_grad():
        cache = _make_ref_cache()
        prefill = ref_model(torch.from_numpy(prompt_ids), use_cache=True,
                            past_key_values=cache)
        first = prefill.logits[:, -1:].argmax(dim=-1)
        x = torch.full((1, G), MASK_ID, dtype=torch.long)
        x[:, :1] = first
        for i in range(steps):
            mask_index = x == MASK_ID
            logits = ref_model(x, past_key_values=cache,
                               use_cache=True).logits
            logits = torch.cat([logits[:, :1], logits[:, :-1]], dim=1)
            mask_logits = logits[mask_index]
            t, s = timesteps[i], timesteps[i + 1]
            # sample_tokens keeps the logits dtype (f32) — no upcast
            probs = torch.softmax(mask_logits, dim=-1)
            if gen_cfg.alg == "maskgit_plus":
                confidence, x0 = probs.max(dim=-1)
            elif gen_cfg.alg == "topk_margin":
                _, x0 = probs.max(dim=-1)
                sp, _ = torch.sort(probs, dim=-1, descending=True)
                confidence = sp[:, 0] - sp[:, 1]
            elif gen_cfg.alg == "entropy":
                _, x0 = probs.max(dim=-1)
                confidence = torch.sum(probs * torch.log(probs + 1e-10), -1)
            else:
                raise NotImplementedError(gen_cfg.alg)
            num_mask = mask_index.sum()
            n = int(num_mask * (1 - s / t)) if i < steps - 1 else num_mask
            if n > 0:
                _, ti = torch.topk(confidence, n)
                x0_ = torch.full_like(x0, MASK_ID)
                x0_[ti] = x0[ti]
                x[mask_index] = x0_
    return x.numpy()


@pytest.mark.parametrize("alg", ["maskgit_plus", "topk_margin", "entropy"])
def test_dream_sampler_parity(tiny_pair, alg):
    ref_model, cfg, params = tiny_pair
    prompt = np.arange(3, 13)[None]
    gen_cfg = DreamGenerationConfig(
        max_new_tokens=16, steps=8, alg=alg, prefix_lm=True
    )
    ref = _ref_dream_sample(ref_model, prompt, gen_cfg)
    prefix = jl.embed_tokens(params, jnp.asarray(prompt))
    ours = dream_generate(params, cfg, prefix, gen_cfg)
    np.testing.assert_array_equal(np.asarray(ours), ref)


def test_dream_unrolled_write_index_parity(tiny_pair):
    """Serving layout (list-of-layers params) routes the Dream decode
    through the write-index padded cache instead of per-step concat
    (dream_sampler.py) — tokens must match the stacked scan path
    exactly (every gen position is rewritten each step, so in-place
    writes at [P, P+G) are equivalent to the concat)."""
    _, cfg, params = tiny_pair
    prompt = np.arange(3, 13)[None]
    gen_cfg = DreamGenerationConfig(
        max_new_tokens=16, steps=8, alg="topk_margin", prefix_lm=True
    )
    prefix = jl.embed_tokens(params, jnp.asarray(prompt))
    ref = dream_generate(params, cfg, prefix, gen_cfg)
    ours = dream_generate(jl.unstack_blocks(params), cfg, prefix, gen_cfg)
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))


def test_dream_hooks_identity_matches_fused(tiny_pair):
    """Identity hooks route through the host-side step loop and must be
    token-identical to the fused scan (generation_utils.py:308-309:
    default hooks are identity lambdas)."""
    _, cfg, params = tiny_pair
    prompt = np.arange(3, 13)[None]
    gen_cfg = DreamGenerationConfig(
        max_new_tokens=16, steps=8, alg="topk_margin", prefix_lm=True
    )
    prefix = jl.embed_tokens(params, jnp.asarray(prompt))
    fused = dream_generate(params, cfg, prefix, gen_cfg)
    calls = []

    def tok_hook(step, x, logits):
        calls.append(step)
        return x

    hooked = dream_generate(params, cfg, prefix, gen_cfg,
                            tokens_hook=tok_hook,
                            logits_hook=lambda s, x, l: l)
    np.testing.assert_array_equal(np.asarray(hooked), np.asarray(fused))
    # called once pre-loop with step=None (:451) then per step (:516)
    assert calls == [None] + list(range(8))


def test_dream_tokens_hook_rewrites(tiny_pair):
    """A token-rewriting hook changes the output: pin gen position 1 to a
    fixed id after every step (user-defined token control, :516)."""
    _, cfg, params = tiny_pair
    prompt = np.arange(3, 13)[None]
    gen_cfg = DreamGenerationConfig(
        max_new_tokens=16, steps=8, alg="maskgit_plus", prefix_lm=True
    )
    prefix = jl.embed_tokens(params, jnp.asarray(prompt))

    def pin(step, x, logits):
        return jnp.asarray(x).at[:, 1].set(7)

    out = dream_generate(params, cfg, prefix, gen_cfg, tokens_hook=pin)
    assert int(np.asarray(out)[0, 1]) == 7
    assert (np.asarray(out) != MASK_ID).all()


def test_dream_logits_hook_bans_token(tiny_pair):
    """A logits hook that bans one vocab id keeps it out of the output
    (user-defined logits control, :473)."""
    _, cfg, params = tiny_pair
    prompt = np.arange(3, 13)[None]
    gen_cfg = DreamGenerationConfig(
        max_new_tokens=16, steps=8, alg="maskgit_plus", prefix_lm=True
    )
    prefix = jl.embed_tokens(params, jnp.asarray(prompt))
    base = np.asarray(dream_generate(params, cfg, prefix, gen_cfg))
    # ban the most common generated id (skip pos 0: prefill argmax is
    # committed before the loop, hooks only shape the denoise steps)
    ids, counts = np.unique(base[:, 1:], return_counts=True)
    banned = int(ids[np.argmax(counts)])

    def ban(step, x, logits):
        return logits.at[..., banned].set(-1e30)

    out = np.asarray(dream_generate(params, cfg, prefix, gen_cfg,
                                    logits_hook=ban))
    assert (out[:, 1:] != banned).all()


def test_dream_verbose_history(tiny_pair):
    _, cfg, params = tiny_pair
    prompt = np.arange(3, 13)[None]
    gen_cfg = DreamGenerationConfig(
        max_new_tokens=16, steps=8, alg="entropy", prefix_lm=True
    )
    prefix = jl.embed_tokens(params, jnp.asarray(prompt))
    out, history = dream_generate(params, cfg, prefix, gen_cfg,
                                  verbose=True)
    assert len(history) == 8
    np.testing.assert_array_equal(history[-1], np.asarray(out))


def test_dream_origin_alg_completes(tiny_pair):
    _, cfg, params = tiny_pair
    prompt = np.arange(3, 13)[None]
    prefix = jl.embed_tokens(params, jnp.asarray(prompt))
    out = dream_generate(
        params, cfg, prefix,
        DreamGenerationConfig(max_new_tokens=16, steps=8, alg="origin"),
        key=jax.random.PRNGKey(3),
    )
    assert (np.asarray(out) != MASK_ID).all()


def test_dream_step_ratio_and_schedule(tiny_pair):
    _, cfg, params = tiny_pair
    prompt = np.arange(3, 13)[None]
    prefix = jl.embed_tokens(params, jnp.asarray(prompt))
    out = dream_generate(
        params, cfg, prefix,
        DreamGenerationConfig(max_new_tokens=16, steps=16, alg="maskgit_plus",
                              step_ratio=0.5, schedule="shift",
                              schedule_shift=0.33),
    )
    assert (np.asarray(out) != MASK_ID).all()


def test_dream_schedule_step_ratio_clamped():
    """step_ratio > steps0/max_new_tokens must clamp to steps0 instead of
    indexing the (steps0+1)-entry timestep grid out of bounds."""
    from lavida_mod.generation.dream_sampler import build_dream_schedule

    gen = DreamGenerationConfig(
        max_new_tokens=16, steps=4, step_ratio=1.0, alg="maskgit_plus"
    )
    timesteps, ks, steps = build_dream_schedule(gen, 16)
    assert steps == 4  # clamped to steps0 = min(steps, max_new_tokens)
    assert timesteps.shape == (5,)
    assert ks.shape == (4,) and ks.sum() == 15  # prefix_lm: first from prefill


def test_dream_fuzz_parity(tiny_pair):
    """Randomized Dream-sampler sweep: token-exact vs the torch oracle."""
    ref_model, cfg, params = tiny_pair
    rng = np.random.default_rng(77)
    for trial in range(4):
        G = int(rng.choice([8, 16, 24]))
        steps = int(rng.choice([4, 8, 16]))
        alg = str(rng.choice(["maskgit_plus", "topk_margin"]))
        plen = int(rng.integers(4, 16))
        prompt = rng.integers(3, 400, size=(1, plen))
        gen_cfg = DreamGenerationConfig(
            max_new_tokens=G, steps=steps, alg=alg, prefix_lm=True
        )
        ref = _ref_dream_sample(ref_model, prompt, gen_cfg)
        prefix = jl.embed_tokens(params, jnp.asarray(prompt))
        ours = dream_generate(params, cfg, prefix, gen_cfg)
        np.testing.assert_array_equal(
            np.asarray(ours), ref, err_msg=f"trial {trial}: {gen_cfg}"
        )


def test_dream_mixed_prefill_identity_tree_parity(tiny_pair):
    """prefill_params = the SAME tree must be token-identical to the
    plain fused path (the mixed split is pure plumbing when both trees
    hold the same weights; bench.py --dream --mixed swaps in the int8
    tree for the prefill only)."""
    _, cfg, params = tiny_pair
    prompt = np.arange(3, 13)[None]
    gen_cfg = DreamGenerationConfig(
        max_new_tokens=16, steps=8, alg="topk_margin", prefix_lm=True
    )
    prefix = jl.embed_tokens(params, jnp.asarray(prompt))
    unrolled = jl.unstack_blocks(params)
    ref = dream_generate(unrolled, cfg, prefix, gen_cfg)
    ours = dream_generate(unrolled, cfg, prefix, gen_cfg,
                          prefill_params=unrolled)
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))


def test_dream_mixed_act_int8_prefill_runs(tiny_pair):
    """int8-quantized prefill tree + A8 prefill completes and fills every
    masked position (tokens may differ from bf16 — weight quantization —
    so this checks the contract, not token parity)."""
    from lavida_mod.models.llada import quantize_params

    _, cfg, params = tiny_pair
    prompt = np.arange(3, 13)[None]
    gen_cfg = DreamGenerationConfig(
        max_new_tokens=16, steps=8, alg="topk_margin", prefix_lm=True
    )
    prefix = jl.embed_tokens(params, jnp.asarray(prompt))
    unrolled = jl.unstack_blocks(params)
    q8 = quantize_params(unrolled)
    out = dream_generate(unrolled, cfg, prefix, gen_cfg,
                         prefill_params=q8, act_int8_prefill=True)
    out = np.asarray(out)
    assert out.shape == (1, 16)
    assert (out != cfg.mask_token_id).all()


def test_dream_mixed_rejects_hooks():
    from lavida_mod.models.dream import tiny_dream_config

    cfg = tiny_dream_config()
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    prefix = jl.embed_tokens(params, jnp.arange(3, 13)[None])
    gen_cfg = DreamGenerationConfig(
        max_new_tokens=8, steps=4, alg="topk_margin", prefix_lm=True
    )
    with pytest.raises(NotImplementedError):
        dream_generate(params, cfg, prefix, gen_cfg, verbose=True,
                       act_int8_prefill=True)
