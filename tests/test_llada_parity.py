"""Logit-parity of the JAX LLaDA core against the reference torch model on a
tiny random-initialized config (the gate required by SURVEY.md §7 step 2).

The reference implementation at /root/reference is imported read-only as a
golden oracle; these tests skip when it is unavailable.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from lavida_mod.config import tiny_llada_config
from lavida_mod.models import llada as jl
from lavida_mod.models.llada_loader import convert_state_dict

ATOL = 2e-4


def _make_ref_model(reference_llada, block_type="llama", **kw):
    from llada.configuration_llada import ModelConfig

    cfg = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        n_layers=2,
        mlp_hidden_size=128,
        vocab_size=512,
        embedding_size=512,
        rope=True,
        rope_theta=10000.0,
        rope_full_precision=True,
        block_type=block_type,
        activation_type="silu" if block_type == "llama" else "swiglu",
        layer_norm_type="rms",
        rms_norm_eps=1e-5,
        attention_layer_norm=False,
        include_bias=False,
        include_qkv_bias=False,
        weight_tying=False,
        max_sequence_length=512,
        attention_dropout=0.0,
        residual_dropout=0.0,
        embedding_dropout=0.0,
        init_device="cpu",
        flash_attention=False,
        alibi=False,
    )
    cfg.update(kw)
    torch.manual_seed(0)
    model = reference_llada.LLaDAModel(ModelConfig(**cfg), init_params=True)
    model.eval()
    return model, cfg


def _to_jax(model, cfg_kw):
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    jcfg = tiny_llada_config(
        block_type=cfg_kw["block_type"],
        activation=cfg_kw["activation_type"],
        n_kv_heads=cfg_kw["n_kv_heads"],
        weight_tying=cfg_kw["weight_tying"],
    )
    params = convert_state_dict(state, jcfg, dtype=jnp.float32)
    return params, jcfg


@pytest.mark.parametrize("block_type", ["llama", "sequential"])
def test_forward_logit_parity(reference_llada, block_type):
    model, cfg_kw = _make_ref_model(reference_llada, block_type)
    params, jcfg = _to_jax(model, cfg_kw)

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((2, 12, 64)).astype(np.float32)

    with torch.no_grad():
        ref = model(
            input_ids=None, input_embeddings=torch.from_numpy(emb)
        ).logits.numpy()

    ours, _ = jl.forward(params, jcfg, jnp.asarray(emb))
    np.testing.assert_allclose(np.asarray(ours), ref, atol=ATOL, rtol=1e-4)


def test_kv_cache_parity(reference_llada):
    """Prefill+decode with our rotated-key cache must match the reference's
    unrotated-cache + full-K re-rotation (modeling_llada.py:738-749)."""
    model, cfg_kw = _make_ref_model(reference_llada, "llama")
    params, jcfg = _to_jax(model, cfg_kw)

    rng = np.random.default_rng(1)
    P, T = 9, 5
    emb = rng.standard_normal((1, P + T, 64)).astype(np.float32)
    prefix, suffix = emb[:, :P], emb[:, P:]

    with torch.no_grad():
        out1 = model(None, input_embeddings=torch.from_numpy(prefix), use_cache=True)
        ref = model(
            None,
            input_embeddings=torch.from_numpy(suffix),
            past_key_values=out1.attn_key_values,
        ).logits.numpy()

    _, cache = jl.forward(params, jcfg, jnp.asarray(prefix), use_cache=True)
    ours, _ = jl.forward(params, jcfg, jnp.asarray(suffix), kv_cache=cache)
    np.testing.assert_allclose(np.asarray(ours), ref, atol=ATOL, rtol=1e-4)

    # decode twice with the same cache (the denoising loop's access pattern)
    ours2, _ = jl.forward(params, jcfg, jnp.asarray(suffix), kv_cache=cache)
    np.testing.assert_allclose(np.asarray(ours2), np.asarray(ours))


def test_gqa_repeat_semantics(reference_llada):
    """n_kv_heads < n_heads exercises the grouped-query path on both sides."""
    model, cfg_kw = _make_ref_model(reference_llada, "llama", n_kv_heads=1)
    params, jcfg = _to_jax(model, cfg_kw)
    jcfg = jcfg.replace(n_kv_heads=1)
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((1, 8, 64)).astype(np.float32)
    with torch.no_grad():
        ref = model(None, input_embeddings=torch.from_numpy(emb)).logits.numpy()
    ours, _ = jl.forward(params, jcfg, jnp.asarray(emb))
    np.testing.assert_allclose(np.asarray(ours), ref, atol=ATOL, rtol=1e-4)


def test_weight_tying(reference_llada):
    model, cfg_kw = _make_ref_model(reference_llada, "llama", weight_tying=True)
    params, jcfg = _to_jax(model, cfg_kw)
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((1, 6, 64)).astype(np.float32)
    with torch.no_grad():
        ref = model(None, input_embeddings=torch.from_numpy(emb)).logits.numpy()
    ours, _ = jl.forward(params, jcfg, jnp.asarray(emb))
    np.testing.assert_allclose(np.asarray(ours), ref, atol=ATOL, rtol=1e-4)


def test_padding_mask_equals_unpadded():
    """Right-padded batch with kv_valid/self_valid masks must reproduce the
    unpadded logits on the valid region (the reference never pads at
    inference; our padded buckets must prove equivalence — SURVEY §7)."""
    jcfg = tiny_llada_config()
    params = jl.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((1, 10, 64)).astype(np.float32)

    ref, _ = jl.forward(params, jcfg, jnp.asarray(emb))

    padded = np.concatenate([emb, np.zeros((1, 6, 64), np.float32)], axis=1)
    valid = jnp.asarray(np.arange(16)[None, :] < 10)
    ours, _ = jl.forward(params, jcfg, jnp.asarray(padded), self_valid=valid)
    np.testing.assert_allclose(
        np.asarray(ours)[:, :10], np.asarray(ref), atol=1e-5, rtol=1e-5
    )


def test_padded_prefill_cache_equals_unpadded():
    """Cache built from a padded prefill + kv_valid mask at decode must match
    the unpadded cache path (the padded-prefix hard part, SURVEY §7)."""
    jcfg = tiny_llada_config()
    params = jl.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    P, Pb, T = 7, 12, 4
    prefix = rng.standard_normal((1, P, 64)).astype(np.float32)
    suffix = rng.standard_normal((1, T, 64)).astype(np.float32)

    _, cache = jl.forward(params, jcfg, jnp.asarray(prefix), use_cache=True)
    ref, _ = jl.forward(
        params, jcfg, jnp.asarray(suffix), kv_cache=cache,
        positions=jnp.arange(P, P + T),
    )

    prefix_pad = np.concatenate([prefix, np.zeros((1, Pb - P, 64), np.float32)], 1)
    pvalid = jnp.asarray(np.arange(Pb)[None, :] < P)
    _, cache_pad = jl.forward(
        params, jcfg, jnp.asarray(prefix_pad), self_valid=pvalid, use_cache=True
    )
    # gen tokens sit at absolute positions P..P+T-1 regardless of bucket size
    ours, _ = jl.forward(
        params, jcfg, jnp.asarray(suffix), kv_cache=cache_pad,
        kv_valid=pvalid, positions=jnp.arange(P, P + T),
    )
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_act_int8_path_close_to_weight_only():
    """The opt-in int8-activation prefill path stays within quantization
    tolerance of the weight-only path (tiny random model, f32 weights
    quantized)."""
    import jax
    import jax.numpy as jnp

    from lavida_mod.config import tiny_llada_config
    from lavida_mod.models import llada as jl

    cfg = tiny_llada_config()
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    qparams = jl.quantize_params(jl.unstack_blocks(params))
    ids = jnp.asarray(np.arange(5, 21)[None])
    emb = jl.embed_tokens(qparams, ids)
    base, _ = jl.forward(qparams, cfg, emb)
    act8, _ = jl.forward(qparams, cfg, emb, act_int8=True)
    base = np.asarray(base)
    act8 = np.asarray(act8)
    # same argmax almost everywhere; logits within a few percent rel
    agree = (base.argmax(-1) == act8.argmax(-1)).mean()
    assert agree > 0.9, agree
    rel = np.abs(act8 - base).max() / (np.abs(base).max() + 1e-9)
    assert rel < 0.1, rel


def test_blockwise_attention_matches_dense():
    """Blockwise (online-softmax) attention == dense, incl. prefix-LM mask
    and padding, across kv-block boundaries."""
    import jax
    import jax.numpy as jnp

    from lavida_mod.config import tiny_llada_config
    from lavida_mod.models import llada as jl

    cfg = tiny_llada_config()
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    B, T = 2, 50
    ids = rng.integers(3, 400, size=(B, T))
    emb = jl.embed_tokens(params, jnp.asarray(ids))
    valid = jnp.asarray(rng.random((B, T)) > 0.2)
    pl = jnp.array([11, 23])

    dense, _ = jl.forward(params, cfg, emb, self_valid=valid,
                          prefix_lengths=pl)
    block, _ = jl.forward(params, cfg, emb, self_valid=valid,
                          prefix_lengths=pl, attention_impl="blockwise",
                          kv_block=16)
    d = np.asarray(dense)
    b = np.asarray(block)
    vm = np.asarray(valid)
    np.testing.assert_allclose(b[vm], d[vm], atol=3e-4, rtol=1e-3)


def test_blockwise_long_seq_trains():
    """Loss+grad at a sequence length where dense scores would be large;
    remat + blockwise keeps it tractable."""
    import jax
    import jax.numpy as jnp

    from lavida_mod.config import tiny_llada_config
    from lavida_mod.models import llada as jl
    from lavida_mod.train.loss import diffusion_loss

    cfg = tiny_llada_config()
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    B, T = 1, 2100  # crosses two kv blocks
    ids = rng.integers(3, 400, size=(B, T))
    labels = np.full((B, T), -100, np.int64)
    labels[:, T // 2:] = ids[:, T // 2:]

    def loss_fn(p):
        emb = jl.embed_tokens(p, jnp.asarray(ids))
        # direct forward with blockwise + prefix mask
        logits, _ = jl.forward(
            p, cfg, emb, prefix_lengths=jnp.array([T // 2]),
            attention_impl="blockwise", kv_block=1024, remat=True,
        )
        lg = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        sup = jnp.asarray(labels) != -100
        tgt = jnp.where(sup, jnp.asarray(labels), 0)
        nll = -jnp.take_along_axis(lg, tgt[..., None], -1)[..., 0]
        return jnp.where(sup, nll, 0).sum() / sup.sum()

    loss, grads = jax.value_and_grad(loss_fn)(params)
    assert np.isfinite(float(loss))
    gn = float(
        jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2)
                     for g in jax.tree.leaves(grads)))
    )
    assert np.isfinite(gn) and gn > 0


def test_resize_token_embeddings():
    import jax
    import jax.numpy as jnp

    from lavida_mod.config import tiny_llada_config
    from lavida_mod.models import llada as jl

    cfg = tiny_llada_config()
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    V0 = params["wte"].shape[0]
    grown = jl.resize_token_embeddings(params, V0 + 3)
    assert grown["wte"].shape[0] == V0 + 3
    assert grown["ff_out"]["kernel"].shape[1] == V0 + 3
    # new rows are the mean of the old table (llava_arch.py:930-945)
    mean = np.asarray(params["wte"], np.float32).mean(axis=0)
    np.testing.assert_allclose(
        np.asarray(grown["wte"][V0:], np.float32),
        np.tile(mean, (3, 1)), atol=1e-5,
    )
    # old logits unchanged for old tokens
    emb = jl.embed_tokens(grown, jnp.asarray(np.arange(5, 10)[None]))
    lg, _ = jl.forward(grown, cfg, emb)
    emb0 = jl.embed_tokens(params, jnp.asarray(np.arange(5, 10)[None]))
    lg0, _ = jl.forward(params, cfg, emb0)
    np.testing.assert_allclose(
        np.asarray(lg)[..., :V0], np.asarray(lg0), atol=1e-5
    )
    shrunk = jl.resize_token_embeddings(params, V0 - 4)
    assert shrunk["wte"].shape[0] == V0 - 4


def test_bf16_logit_parity(reference_llada):
    """North-star claim: bit-comparable logits at bf16 — same tiny weights
    cast to bf16 on both sides, logits agree within bf16 resolution."""
    import jax
    import jax.numpy as jnp

    from lavida_mod.config import tiny_llada_config
    from lavida_mod.models import llada as jl
    from lavida_mod.models.llada_loader import convert_state_dict

    model, cfg_kw = _make_ref_model(reference_llada)
    model = model.to(torch.bfloat16)
    state = {k: v.float().detach().numpy()
             for k, v in model.state_dict().items()}
    cfg = tiny_llada_config()
    params = convert_state_dict(state, cfg, dtype=jnp.bfloat16)

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((1, 12, 64)).astype(np.float32)
    with torch.no_grad():
        ref = model(
            input_ids=None,
            input_embeddings=torch.from_numpy(emb).to(torch.bfloat16),
        ).logits.float().numpy()
    ours, _ = jl.forward(params, cfg, jnp.asarray(emb, jnp.bfloat16))
    ours = np.asarray(ours, np.float32)
    # bf16 has ~3 decimal digits; ops orderings differ slightly
    denom = np.abs(ref).max() + 1e-6
    assert np.abs(ours - ref).max() / denom < 0.06
    # argmax tokens agree almost everywhere (what sampling consumes)
    agree = (ours.argmax(-1) == ref.argmax(-1)).mean()
    assert agree > 0.9, agree


def test_fused_layout_equivalence():
    """to_fused_layout: fused att_proj/swiglu layout gives identical logits
    (and identical generation through the cache) to the llama layout."""
    import jax
    import jax.numpy as jnp

    from lavida_mod.config import GenerationConfig, tiny_llada_config
    from lavida_mod.generation import generate
    from lavida_mod.models import llada as jl

    cfg = tiny_llada_config()
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    fused, fcfg = jl.to_fused_layout(jl.unstack_blocks(params), cfg)

    ids = jnp.asarray(np.arange(5, 17)[None])
    a, _ = jl.forward(params, cfg, jl.embed_tokens(params, ids))
    b, _ = jl.forward(fused, fcfg, jl.embed_tokens(fused, ids))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)

    gen_cfg = GenerationConfig(max_new_tokens=16, block_length=8,
                               prefix_lm=True, schedule="shift",
                               schedule_shift=0.33)
    prefix = jl.embed_tokens(params, ids)
    ga = np.asarray(generate(params, cfg, prefix, gen_cfg))
    gb = np.asarray(generate(fused, fcfg,
                             jl.embed_tokens(fused, ids), gen_cfg))
    np.testing.assert_array_equal(ga, gb)


def test_fused_layout_int4_token_exact():
    """Fused layout + int4 quantization is TOKEN-EXACT vs unfused int4:
    the merged kernels' per-(group, column) scales and codes are
    column-independent, and the per-token activation scale depends only
    on the (shared) input — so predict/worker/bench can default to the
    fused layout without a quality caveat."""
    import jax
    import jax.numpy as jnp

    from lavida_mod.config import GenerationConfig, tiny_llada_config
    from lavida_mod.generation import generate
    from lavida_mod.models import llada as jl

    cfg = tiny_llada_config(d_model=128, n_heads=4, n_kv_heads=4,
                            mlp_hidden_size=256)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    up = jl.unstack_blocks(params)
    q_plain = jl.quantize_params(up, bits=4, group=64)
    fused, fcfg = jl.to_fused_layout(up, cfg)
    q_fused = jl.quantize_params(fused, bits=4, group=64)

    ids = jnp.asarray(np.arange(5, 17)[None])
    gen_cfg = GenerationConfig(max_new_tokens=16, block_length=8,
                               prefix_lm=True, schedule="shift",
                               schedule_shift=0.33)
    ga = np.asarray(generate(q_plain, cfg,
                             jl.embed_tokens(q_plain, ids), gen_cfg))
    gb = np.asarray(generate(q_fused, fcfg,
                             jl.embed_tokens(q_fused, ids), gen_cfg))
    np.testing.assert_array_equal(ga, gb)


@pytest.mark.parametrize("bits,block_type,fused", [
    (4, "llama", True), (8, "llama", False), (None, "llama", False),
    (4, "sequential", False)])
def test_serving_block_layout_rule(bits, block_type, fused):
    """serving_block_layout is the one layout rule of the serving entry
    points: only a llama-layout tree bound for int4 is fused; int8 and
    bf16 trees, and a checkpoint already in the fused layout, pass
    through unchanged."""
    import jax

    from lavida_mod.config import tiny_llada_config
    from lavida_mod.models import llada as jl

    cfg = tiny_llada_config(block_type=block_type)
    params = jl.unstack_blocks(jl.init_params(cfg, jax.random.PRNGKey(0)))
    out, ocfg = jl.serving_block_layout(params, cfg, bits)
    assert (ocfg.block_type == "sequential") == (fused or
                                                 block_type == "sequential")
    if fused:
        assert "att_proj" in out["blocks"][0]
        assert "q_proj" not in out["blocks"][0]
    else:
        assert out is params and ocfg is cfg


@pytest.mark.parametrize("quant,block_type", [
    ("int4", "sequential"), ("mixed", "sequential"), ("int8", "llama")])
def test_to_serving_layout_applies_the_rule(quant, block_type):
    """LaViDa.to_serving_layout applies the rule: int4 and mixed serve the
    fused layout, int8 the llama one."""
    from lavida_mod.config import (LaViDaConfig, VisionConfig,
                                   tiny_siglip_config)
    from lavida_mod.models.lavida import LaViDa

    cfg = LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32))
    model = LaViDa.random_init(cfg, 0, jnp.float32)
    model.to_serving_layout(quant=quant)
    assert model.cfg.llada.block_type == block_type
    assert ("att_proj" in model.params["llada"]["blocks"][0]) == (
        block_type == "sequential")
