"""Quantized linears (ops/quant.py) against the f32 dequant reference:
weight-only int8, grouped int4, and W8A8 — at small shapes and at the
model's own in-dims (LLaDA 4096/12288, Dream's 18944 FFN and 151936
head) with few output columns so the CPU suite stays fast."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.ops.quant import (dequantize_w4, linear,
                                  linear_act_int8, quantize_linear,
                                  quantize_linear4)


def _rel(y, ref):
    y = np.asarray(y, np.float32)
    return np.abs(y - ref).max() / (np.abs(ref).max() + 1e-9)


def _w(K, N, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, N)) * scale).astype(np.float32)


def _x(T, K, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((T, K)).astype(np.float32)


def test_grouped_quantize_roundtrip_accuracy():
    w = _w(256, 128, seed=2, scale=1.0)
    p = quantize_linear4({"kernel": jnp.asarray(w)}, group=64)
    assert p["kernel_q4"].dtype == jnp.int4
    assert p["kernel_q4"].shape == (256, 128)
    assert p["scales4"].shape == (4, 128)
    wd = np.asarray(dequantize_w4(p))
    # int4-g64 symmetric: per-element error bounded by scale/2
    rel = np.abs(wd - w).max() / np.abs(w).max()
    assert rel < 0.12, rel
    corr = np.corrcoef(w.ravel(), wd.ravel())[0, 1]
    assert corr > 0.99


def test_int4_values_in_symmetric_range():
    w = _w(128, 64, seed=3, scale=1.0)
    q = np.asarray(quantize_linear4({"kernel": jnp.asarray(w)})
                   ["kernel_q4"].astype(jnp.int32))
    assert q.min() >= -7 and q.max() <= 7
    # every group's largest magnitude hits the grid end
    assert (np.abs(q).max(axis=0) == 7).all()


@pytest.mark.parametrize("K,N,T", [
    (128, 256, 4),        # small
    (256, 384, 32),       # decode rows, odd-ish out dim
    (4096, 64, 32),       # LLaDA d_model in-dim
    (12288, 32, 32),      # LLaDA ff_out in-dim
    (18944, 32, 8),       # Dream FFN in-dim (no power-of-two padding)
])
def test_linear_w4_matches_dequant_reference(K, N, T):
    """linear() over the int4 layout == x @ dequant(W) in f32, to the
    bf16 rounding of the dequantized weight and of x."""
    w = _w(K, N, seed=K)
    p = quantize_linear4({"kernel": jnp.asarray(w)})
    x = _x(T, K, seed=K + 1)
    ref = x @ np.asarray(dequantize_w4(p))
    y = linear(jnp.asarray(x, jnp.bfloat16), p, preferred=jnp.float32)
    assert y.shape == (T, N) and y.dtype == jnp.float32
    assert _rel(y, ref) < 0.02, _rel(y, ref)


@pytest.mark.parametrize("K,N,T", [
    (128, 256, 4),
    (4096, 64, 32),
    (12288, 32, 32),
    (18944, 32, 8),
])
def test_linear_int8_matches_dequant_reference(K, N, T):
    w = _w(K, N, seed=K + 7)
    p = quantize_linear({"kernel": jnp.asarray(w)})
    wd = np.asarray(p["kernel_q"], np.float32) * np.asarray(p["scale"])
    x = _x(T, K, seed=K + 8)
    y = linear(jnp.asarray(x), p)
    assert _rel(y, x @ wd) < 1e-5
    assert _rel(y, x @ w) < 0.02     # int8 weight noise


@pytest.mark.parametrize("K,N,T", [
    (128, 256, 4),
    (4096, 64, 32),
    (12288, 32, 16),
    (18944, 32, 8),
])
def test_linear_act_int8_matches_dequant_reference(K, N, T):
    """W8A8: per-token int8 activations x per-channel int8 weights,
    integer accumulate, both scales on the f32 accumulator."""
    w = _w(K, N, seed=K + 11)
    p = quantize_linear({"kernel": jnp.asarray(w)})
    wd = np.asarray(p["kernel_q"], np.float32) * np.asarray(p["scale"])
    x = _x(T, K, seed=K + 12)
    sx = np.maximum(np.abs(x).max(axis=-1, keepdims=True) / 127.0, 1e-8)
    xd = np.clip(np.round(x / sx), -127, 127) * sx
    y = linear_act_int8(jnp.asarray(x), p, preferred=jnp.float32)
    assert _rel(y, xd @ wd) < 1e-5
    assert _rel(y, x @ w) < 0.03     # activation + weight quant noise


def test_linear_act_int8_keeps_bias_and_plain_fallback():
    w = _w(128, 64, seed=5)
    b = np.linspace(-1, 1, 64).astype(np.float32)
    x = _x(4, 128, seed=6)
    q = quantize_linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)})
    y = np.asarray(linear_act_int8(jnp.asarray(x), q))
    assert _rel(y, x @ w + b) < 0.03
    plain = {"kernel": jnp.asarray(w)}
    np.testing.assert_allclose(
        np.asarray(linear_act_int8(jnp.asarray(x), plain)),
        np.asarray(linear(jnp.asarray(x), plain)), rtol=1e-6)


@pytest.mark.parametrize("N", [126464 // 64, 151936 // 64])
def test_linear_w4_vocab_head_widths(N):
    """The LM heads' out widths (a 1/64 slice of LLaDA's 126464 and
    Dream's 151936 columns) need no column padding: the output keeps the
    exact width, under jit too."""
    w = _w(256, N, seed=N)
    p = quantize_linear4({"kernel": jnp.asarray(w)})
    x = jnp.asarray(_x(4, 256, seed=N + 1))
    y = jax.jit(lambda p, x: linear(x, p, preferred=jnp.float32))(p, x)
    assert y.shape == (4, N)
    assert _rel(y, np.asarray(x) @ np.asarray(dequantize_w4(p))) < 0.02


def test_int4_model_path_accuracy():
    """End-to-end int4-g64 model: logits close to f32, generation runs."""
    from lavida_mod.config import GenerationConfig, tiny_llada_config
    from lavida_mod.generation import generate
    from lavida_mod.models import llada as jl

    cfg = tiny_llada_config(d_model=128, n_heads=4, n_kv_heads=4,
                            mlp_hidden_size=256)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    p4 = jl.quantize_params(jl.unstack_blocks(params), bits=4, group=64)

    ids = jnp.asarray(np.arange(5, 21)[None])
    base, _ = jl.forward(params, cfg, jl.embed_tokens(params, ids))
    q4, _ = jl.forward(p4, cfg, jl.embed_tokens(p4, ids))
    rel = np.abs(np.asarray(q4) - np.asarray(base)).max() / (
        np.abs(np.asarray(base)).max() + 1e-9
    )
    # int4 noise band on a tiny random net (d_model=128, group=64 is an
    # extreme quantization ratio); real-checkpoint quality is gated by
    # scripts/verify_checkpoint.py.
    assert rel < 0.25, rel

    out = generate(p4, cfg, jl.embed_tokens(p4, ids),
                   GenerationConfig(max_new_tokens=8, block_length=8))
    assert (np.asarray(out) != cfg.mask_token_id).all()


def test_quantize_params_int4_vocab_fallback():
    """Any out dim stays on the int4 path at its exact width; only an
    in-dim that breaks the scale grouping falls back to int8."""
    from lavida_mod.models.llada import quantize_params

    rng = np.random.default_rng(0)
    params = {"blocks": [{
        "a": {"kernel": jnp.asarray(
            rng.standard_normal((256, 512)), jnp.float32)},
        "odd_head": {"kernel": jnp.asarray(
            rng.standard_normal((256, 384)), jnp.float32)},
        "odd_in": {"kernel": jnp.asarray(
            rng.standard_normal((100, 512)), jnp.float32)},
    }]}
    q = quantize_params(params, bits=4)
    blk = q["blocks"][0]
    assert "kernel_q4" in blk["a"] and "scales4" in blk["a"]
    assert blk["odd_head"]["kernel_q4"].shape == (256, 384)
    x = jnp.asarray(rng.standard_normal((4, 256)), jnp.float32)

    def rel_err(name):
        yy = linear(x, blk[name]).astype(jnp.float32)
        rr = x @ params["blocks"][0][name]["kernel"]
        return float(jnp.max(jnp.abs(yy - rr)) / jnp.max(jnp.abs(rr)))

    assert linear(x, blk["odd_head"]).shape == (4, 384)
    assert rel_err("odd_head") < 1.5 * rel_err("a") + 1e-6
    # odd IN dim (breaks the group-128 scales): int8 fallback
    assert "kernel_q" in blk["odd_in"] and "scale" in blk["odd_in"]


def test_quantize_linear4_padded_in_dim():
    """An in-dim that is a multiple of the group but of no power of two
    (Qwen2's 18944 = 2^9*37 scaled down here to 9472) quantizes at its
    own width: no row padding, and linear() takes the unpadded x."""
    K, N = 9472, 128
    w = _w(K, N, seed=7)
    qp = quantize_linear4({"kernel": jnp.asarray(w)})
    assert qp["kernel_q4"].shape == (K, N)
    assert qp["scales4"].shape == (K // 128, N)
    x = jnp.asarray(_x(4, K, seed=8))
    y = linear(x, qp, preferred=jnp.float32)
    assert _rel(y, np.asarray(x) @ np.asarray(dequantize_w4(qp))) < 0.02


def test_int4_layout_shapes_matches_real_quantizer():
    """jax.eval_shape of quantize_params(bits=4) — how LaViDa.zero_init
    and bench.py build weight-free int4 layouts — gives the exact pytree
    structure, shapes and dtypes of the real quantization."""
    from lavida_mod.config import tiny_llada_config
    from lavida_mod.models import llada as jl

    cfg = tiny_llada_config(d_model=128, n_heads=4, n_kv_heads=4,
                            mlp_hidden_size=256, vocab_size=500,
                            weight_tying=False)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    real = jl.quantize_params(jl.unstack_blocks(params), bits=4)
    twin = jax.eval_shape(
        lambda k: jl.quantize_params(
            jl.unstack_blocks(jl.init_params(cfg, k)), bits=4),
        jax.random.PRNGKey(0))
    assert jax.tree.structure(real) == jax.tree.structure(twin)
    for rp, tp in zip(jax.tree.leaves(real), jax.tree.leaves(twin)):
        assert rp.shape == tp.shape, (rp.shape, tp.shape)
        assert rp.dtype == tp.dtype, (rp.dtype, tp.dtype)


def test_zero_init_int4_layout():
    """LaViDa.zero_init(quantized="int4") builds the int4 layout from
    shapes alone and runs a forward."""
    from lavida_mod.config import LaViDaConfig, tiny_llada_config
    from lavida_mod.models import llada as jl
    from lavida_mod.models.lavida import LaViDa

    cfg = LaViDaConfig(llada=tiny_llada_config(
        d_model=128, n_heads=4, n_kv_heads=4, mlp_hidden_size=256))
    m = LaViDa.zero_init(cfg, jnp.float32, quantized="int4")
    blk = m.params["llada"]["blocks"][0]
    assert blk["q_proj"]["kernel_q4"].dtype == jnp.int4
    ids = jnp.arange(3, 11)[None]
    lg, _ = jl.forward(m.params["llada"], cfg.llada,
                       jl.embed_tokens(m.params["llada"], ids))
    assert np.isfinite(np.asarray(lg)).all()
