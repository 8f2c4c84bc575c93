"""End-to-end sampler parity: our jitted denoise scan vs the reference
torch sampler (llava/model/language_model/llada/generate.py) on identical
tiny random weights, temperature 0.

Covers: prefix-cache mode, full-context (KV off) mode, shift schedule,
multi-block semi-AR decoding, and FIM draft injection.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from lavida_mod.config import GenerationConfig, tiny_llada_config
from lavida_mod.generation import generate
from lavida_mod.models import llada as jl
from lavida_mod.models.llada_loader import convert_state_dict

from test_llada_parity import _make_ref_model  # shared tiny fixture


MASK_ID = 500


@pytest.fixture(scope="module")
def tiny_pair(reference_llada):
    ref_model, _ = _make_ref_model(reference_llada)
    state = {k: v.detach().numpy() for k, v in ref_model.state_dict().items()}
    cfg = tiny_llada_config()
    params = convert_state_dict(state, cfg, dtype=jnp.float32)
    return ref_model, cfg, params


def _ref_generate(ref_model, prompt_ids, **kw):
    import contextlib
    import io

    inputs_embeds = ref_model.transformer.wte(torch.asarray(prompt_ids))
    with contextlib.redirect_stdout(io.StringIO()):
        out = __import__("llada.generate", fromlist=["generate"]).generate(
            ref_model,
            inputs_embeds=inputs_embeds,
            temperature=0.0,
            mask_id=MASK_ID,
            **kw,
        )
    return np.asarray(out)


def _our_generate(cfg, params, prompt_ids, gen_cfg, **kw):
    prefix_embeds = jl.embed_tokens(params, jnp.asarray(prompt_ids))
    out = generate(params, cfg, prefix_embeds, gen_cfg, **kw)
    return np.asarray(out)


@pytest.mark.parametrize("prefix_lm", [True, False])
def test_basic_parity(tiny_pair, prefix_lm):
    ref_model, cfg, params = tiny_pair
    prompt = np.arange(7, 19)[None]
    ref = _ref_generate(
        ref_model, prompt, max_new_tokens=16, block_length=16,
        prefix_lm=prefix_lm,
    )
    ref_gen = ref[:, -16:] if not prefix_lm else ref
    ours = _our_generate(
        cfg, params, prompt,
        GenerationConfig(max_new_tokens=16, block_length=16,
                         prefix_lm=prefix_lm),
    )
    np.testing.assert_array_equal(ours, ref_gen)


def test_multiblock_shift_schedule(tiny_pair):
    ref_model, cfg, params = tiny_pair
    prompt = np.arange(3, 12)[None]
    ref = _ref_generate(
        ref_model, prompt, max_new_tokens=32, block_length=8,
        prefix_lm=True, schedule="shift", schedule_kwargs={"shift": 0.33},
        step_per_block=4,
    )
    ours = _our_generate(
        cfg, params, prompt,
        GenerationConfig(max_new_tokens=32, block_length=8, prefix_lm=True,
                         schedule="shift", schedule_shift=0.33,
                         step_per_block=4),
    )
    np.testing.assert_array_equal(ours, ref)


def test_step_ratio(tiny_pair):
    ref_model, cfg, params = tiny_pair
    prompt = np.arange(5, 14)[None]
    ref = _ref_generate(
        ref_model, prompt, max_new_tokens=16, block_length=16,
        prefix_lm=True, step_ratio=0.5, schedule="shift",
        schedule_kwargs={"shift": 0.33},
    )
    ours = _our_generate(
        cfg, params, prompt,
        GenerationConfig(max_new_tokens=16, block_length=16, prefix_lm=True,
                         step_ratio=0.5, schedule="shift",
                         schedule_shift=0.33),
    )
    np.testing.assert_array_equal(ours, ref)


def test_draft_tokens_fim(tiny_pair):
    ref_model, cfg, params = tiny_pair
    prompt = np.arange(2, 10)[None]
    rng = np.random.default_rng(0)
    draft = rng.integers(1, 400, size=(1, 12)).astype(np.int64)
    draft[0, [2, 3, 7, 9]] = MASK_ID  # holes to infill
    ref = _ref_generate(
        ref_model, prompt, max_new_tokens=16, block_length=16,
        prefix_lm=True, draft_tokens=torch.asarray(draft),
    )
    ours = _our_generate(
        cfg, params, prompt,
        GenerationConfig(max_new_tokens=16, block_length=16, prefix_lm=True),
        draft_tokens=jnp.asarray(draft),
    )
    np.testing.assert_array_equal(ours, ref)
    # drafted (non-hole) positions survive untouched
    keep = draft[0] != MASK_ID
    np.testing.assert_array_equal(ours[0, :12][keep], draft[0][keep])


def test_remasking_modes_run(tiny_pair):
    _, cfg, params = tiny_pair
    prompt = np.arange(5, 14)[None]
    for mode in ("low_confidence", "random", "entrophy", "margin"):
        out = _our_generate(
            cfg, params, prompt,
            GenerationConfig(max_new_tokens=8, block_length=8,
                             prefix_lm=True, remasking=mode),
        )
        assert (out != MASK_ID).all()


def test_verbose_history(tiny_pair):
    _, cfg, params = tiny_pair
    prompt = np.arange(5, 14)[None]
    prefix_embeds = jl.embed_tokens(params, jnp.asarray(prompt))
    gen_cfg = GenerationConfig(max_new_tokens=8, block_length=8, prefix_lm=True)
    x, history = generate(params, cfg, prefix_embeds, gen_cfg, verbose=True)
    assert len(history) == 8
    np.testing.assert_array_equal(history[-1], np.asarray(x))
    # masks decrease monotonically
    masks = [int((h == cfg.mask_token_id).sum()) for h in history]
    assert masks == sorted(masks, reverse=True)
    # scan path and verbose path agree
    x2 = generate(params, cfg, prefix_embeds, gen_cfg)
    np.testing.assert_array_equal(np.asarray(x), np.asarray(x2))


def test_verbose_matches_fused_at_temperature(tiny_pair):
    """The verbose (history) debug path must reproduce the fused scan
    trajectory token-for-token even when sampling actually consumes the
    key: both advance the stream as key_{i+1}, sk_i = split(key_i), so
    the per-step sample keys are identical.  Regression lock for the
    'verbose reproduces the run' contract at temperature > 0 and under
    the key-consuming remasking modes."""
    _, cfg, params = tiny_pair
    prompt = np.arange(5, 14)[None]
    prefix_embeds = jl.embed_tokens(params, jnp.asarray(prompt))
    for prefix_lm in (True, False):
        for temp, remask in ((0.7, "random"), (0.9, "low_confidence")):
            gen_cfg = GenerationConfig(
                max_new_tokens=8, block_length=4, step_per_block=4,
                prefix_lm=prefix_lm, temperature=temp, remasking=remask)
            key = jax.random.PRNGKey(42)
            x_fused = generate(params, cfg, prefix_embeds, gen_cfg, key=key)
            x_verb, hist = generate(params, cfg, prefix_embeds, gen_cfg,
                                    key=key, verbose=True)
            np.testing.assert_array_equal(
                np.asarray(x_fused), np.asarray(x_verb),
                err_msg=f"prefix_lm={prefix_lm} temp={temp} {remask}")
            np.testing.assert_array_equal(hist[-1], np.asarray(x_verb))


def test_batched_parity(tiny_pair):
    """B=2 with different prompts: our per-row fixed-shape top-k must match
    the reference's python per-row topk loop (generate.py:304-311)."""
    ref_model, cfg, params = tiny_pair
    prompts = np.stack([np.arange(7, 19), np.arange(100, 112)])
    ref = _ref_generate(
        ref_model, prompts, max_new_tokens=16, block_length=8,
        prefix_lm=True, schedule="shift", schedule_kwargs={"shift": 0.33},
    )
    ours = _our_generate(
        cfg, params, prompts,
        GenerationConfig(max_new_tokens=16, block_length=8, prefix_lm=True,
                         schedule="shift", schedule_shift=0.33),
    )
    np.testing.assert_array_equal(ours, ref)


def test_unrolled_write_index_decode_matches_stacked(tiny_pair):
    """The serving layout (unrolled layer list -> write-index fixed-buffer
    decode) must produce the same tokens as the stacked concat path."""
    _, cfg, params = tiny_pair
    prompt = np.arange(7, 19)[None]
    gen_cfg = GenerationConfig(max_new_tokens=16, block_length=8,
                               prefix_lm=True, schedule="shift",
                               schedule_shift=0.33)
    prefix = jl.embed_tokens(params, jnp.asarray(prompt))
    ref = np.asarray(generate(params, cfg, prefix, gen_cfg))
    unrolled = jl.unstack_blocks(params)
    out = np.asarray(generate(unrolled, cfg, prefix, gen_cfg))
    np.testing.assert_array_equal(out, ref)

    # and with a prefix_valid mask (bucketed serving path)
    Pb = 16
    pad = Pb - prefix.shape[1]
    pe = jnp.concatenate(
        [jnp.zeros((1, pad, prefix.shape[-1]), prefix.dtype), prefix], axis=1
    )
    pv = jnp.concatenate(
        [jnp.zeros((1, pad), bool), jnp.ones((1, prefix.shape[1]), bool)],
        axis=1,
    )
    out_b = np.asarray(generate(unrolled, cfg, pe, gen_cfg, prefix_valid=pv))
    np.testing.assert_array_equal(out_b, ref)


def test_fuzz_parity_random_configs(tiny_pair):
    """Randomized sweep over (gen length, blocks, steps, schedule, prompt):
    token-exact parity with the reference sampler on every combo."""
    ref_model, cfg, params = tiny_pair
    rng = np.random.default_rng(1234)
    for trial in range(6):
        gen_len = int(rng.choice([8, 16, 24, 32]))
        divisors = [b for b in (4, 8, 16, 32) if gen_len % b == 0]
        block = int(rng.choice(divisors))
        schedule = rng.choice([None, "shift", "cosine", "linear"])
        shift = float(rng.uniform(0.3, 3.0))
        spb = rng.choice([None, 2, 4])
        plen = int(rng.integers(4, 20))
        prompt = rng.integers(3, 400, size=(1, plen))

        kwargs = dict(max_new_tokens=gen_len, block_length=block,
                      prefix_lm=True)
        ours_cfg = dict(max_new_tokens=gen_len, block_length=block,
                        prefix_lm=True)
        if schedule is not None:
            kwargs.update(schedule=schedule,
                          schedule_kwargs={"shift": shift})
            ours_cfg.update(schedule=schedule, schedule_shift=shift)
        if spb is not None:
            kwargs.update(step_per_block=int(spb))
            ours_cfg.update(step_per_block=int(spb))

        ref = _ref_generate(ref_model, prompt, **kwargs)
        ours = _our_generate(cfg, params, prompt,
                             GenerationConfig(**ours_cfg))
        np.testing.assert_array_equal(
            ours, ref,
            err_msg=f"trial {trial}: {ours_cfg}",
        )


def test_mixed_decode_params_identity_tree_parity(tiny_pair):
    """generate(decode_params=) with the SAME tree for both
    halves must be token-identical to the plain fused path (the mixed
    serving split — int8 prefill / int4 decode, bench.py default — is
    pure plumbing when the trees hold the same weights)."""
    _, cfg, params = tiny_pair
    unrolled = jl.unstack_blocks(params)
    prefix = jl.embed_tokens(params, jnp.arange(3, 13)[None])
    gen = GenerationConfig(max_new_tokens=16, steps=8,
                           block_length=16, prefix_lm=True)
    ref = generate(unrolled, cfg, prefix, gen)
    ours = generate(unrolled, cfg, prefix, gen,
                              decode_params=unrolled)
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))


def test_mixed_decode_params_rejects_no_cache_and_verbose(tiny_pair):
    _, cfg, params = tiny_pair
    prefix = jl.embed_tokens(params, jnp.arange(3, 13)[None])
    with pytest.raises(NotImplementedError):
        generate(
            params, cfg, prefix,
            GenerationConfig(max_new_tokens=8, steps=4, block_length=8,
                             prefix_lm=False),
            decode_params=params)
    with pytest.raises(NotImplementedError):
        generate(
            params, cfg, prefix,
            GenerationConfig(max_new_tokens=8, steps=4, block_length=8,
                             prefix_lm=True),
            decode_params=params, verbose=True)


def test_lavida_prefill_params_surface(tiny_pair):
    """LaViDa.prefill_params drives the mixed split through generate():
    with an int8 prefill tree the model still fills every masked position
    (weight quantization may change tokens; the contract is exercised
    end-to-end the way predict.py --mixed builds it)."""
    _, cfg, params = tiny_pair
    from lavida_mod.config import (
        LaViDaConfig, VisionConfig, tiny_siglip_config,
    )
    from lavida_mod.models.lavida import LaViDa

    vcfg = LaViDaConfig(
        llada=cfg,
        vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32),
    )
    model = LaViDa.random_init(vcfg, 0, jnp.float32)
    lp = jl.unstack_blocks(model.params["llada"])
    model.prefill_params = jl.quantize_params(lp)
    model.params["llada"] = jl.quantize_params(lp, bits=4)
    ids = np.arange(3, 13, dtype=np.int64)
    gen = GenerationConfig(max_new_tokens=16, steps=8,
                           block_length=16, prefix_lm=True)
    out = model.generate(ids, (), (), gen)
    assert out.shape == (16,)
    assert (out != cfg.mask_token_id).all()
