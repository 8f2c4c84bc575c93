"""int8/int4 KV cache decode: attention over the quantized cache vs
dense attention over the dequantized cache, and end-to-end generation
through the kv8 path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.config import GenerationConfig, tiny_llada_config
from lavida_mod.generation.diffusion import generate
from lavida_mod.models import llada as L
from lavida_mod.ops import kv8_attention as KV8
from lavida_mod.ops.attention import (dense_attention, make_mask,
                                      mask_to_bias)


def test_quantize_roundtrip():
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 64, 4, 128),
                          jnp.float32) * 3.0
    q, s = KV8.quantize_kv(x)
    back = KV8.dequantize_kv(q, s)
    err = np.abs(np.asarray(back) - np.asarray(x)).max()
    scale = np.abs(np.asarray(x)).max()
    assert err <= scale / 127.0 + 1e-6


def test_kernel_matches_dense_on_dequant():
    """kernel(q, k8, v8) == dense_attention(q, dequant(k8), dequant(v8))
    — isolates kernel math from quantization error."""
    B, T, H, hd, S = 2, 32, 4, 128, 160
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    q = jax.random.normal(ks[0], (B, T, H, hd), jnp.float32)
    k = jax.random.normal(ks[1], (B, S, H, hd), jnp.float32)
    v = jax.random.normal(ks[2], (B, S, H, hd), jnp.float32)
    k8, ksc = KV8.quantize_kv(k)
    v8, vsc = KV8.quantize_kv(v)
    out = KV8.kv8_decode_attention(q, k8, ksc, v8, vsc)
    ref = dense_attention(q, KV8.dequantize_kv(k8, ksc).astype(jnp.float32),
                          KV8.dequantize_kv(v8, vsc).astype(jnp.float32))
    # tolerance is f32 summation order, not quantization error (that's
    # factored out here)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=6e-3, rtol=6e-3)


def test_kernel_respects_kv_valid():
    B, T, H, hd, S = 1, 8, 2, 128, 64
    ks = jax.random.split(jax.random.PRNGKey(2), 3)
    q = jax.random.normal(ks[0], (B, T, H, hd), jnp.float32)
    k = jax.random.normal(ks[1], (B, S, H, hd), jnp.float32)
    v = jax.random.normal(ks[2], (B, S, H, hd), jnp.float32)
    valid = jnp.arange(S)[None, :] < 40
    k8, ksc = KV8.quantize_kv(k)
    v8, vsc = KV8.quantize_kv(v)
    out = KV8.kv8_decode_attention(q, k8, ksc, v8, vsc, kv_valid=valid)
    # zero out the invalid tail on the dequantized reference via a bias
    ref = dense_attention(
        q, KV8.dequantize_kv(k8, ksc).astype(jnp.float32),
        KV8.dequantize_kv(v8, vsc).astype(jnp.float32),
        bias=mask_to_bias(make_mask(kv_valid=valid)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=6e-3, rtol=6e-3)


def test_write_rows_roundtrip():
    B, H, S, hd, T = 1, 2, 48, 128, 8
    k8 = jnp.zeros((B, H, S, hd), jnp.int8)
    ks = jnp.ones((B, H, 1, S), jnp.float32)
    v8 = jnp.zeros_like(k8)
    vs = jnp.ones_like(ks)
    k_new = jax.random.normal(jax.random.PRNGKey(3), (B, T, H, hd))
    v_new = jax.random.normal(jax.random.PRNGKey(4), (B, T, H, hd))
    k8, ks, v8, vs = KV8.write_rows(k8, ks, v8, vs, k_new, v_new,
                                    jnp.int32(16))
    back = KV8.dequantize_kv(k8, ks)[:, 16:16 + T]
    err = np.abs(np.asarray(back) - np.asarray(k_new)).max()
    assert err <= float(jnp.abs(k_new).max()) / 127.0 + 1e-6


def test_generate_kv8_end_to_end():
    """Full denoise loop through the kv8 cache on an MHA tiny config:
    runs, fills every mask, and tracks the bf16-cache trajectory almost
    everywhere (int8 KV flips at most the odd marginal token)."""
    cfg = tiny_llada_config(n_kv_heads=4)  # kv8 path needs MHA
    params = L.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    params = L.unstack_blocks(params)
    prefix = L.embed_tokens(
        params, jnp.arange(5, 21)[None].astype(jnp.int32))
    gen = GenerationConfig(max_new_tokens=16, block_length=8,
                           step_per_block=4, prefix_lm=True)
    x_ref = np.asarray(generate(params, cfg, prefix, gen))
    x_kv8 = np.asarray(generate(params, cfg, prefix, gen, kv8=True))
    assert (x_kv8 != cfg.mask_token_id).all()
    agree = (x_ref == x_kv8).mean()
    assert agree >= 0.8, f"kv8 trajectory diverged: {agree:.2f} agreement"


def test_quantize_kv4_roundtrip():
    x = jax.random.normal(jax.random.PRNGKey(7), (1, 48, 2, 128),
                          jnp.float32) * 2.0
    q, s = KV8.quantize_kv(x, bits=4)
    assert q.dtype == jnp.int4
    back = KV8.dequantize_kv(q, s)
    err = np.abs(np.asarray(back) - np.asarray(x)).max()
    scale = np.abs(np.asarray(x)).max()
    assert err <= scale / 7.0 + 1e-6


def test_kv4_kernel_matches_dense_on_dequant():
    """int4 cache through the SAME code (astype handles S4): parity vs
    dense attention over the dequantized values."""
    B, T, H, hd, S = 1, 16, 2, 128, 96
    ks = jax.random.split(jax.random.PRNGKey(8), 3)
    q = jax.random.normal(ks[0], (B, T, H, hd), jnp.float32)
    k = jax.random.normal(ks[1], (B, S, H, hd), jnp.float32)
    v = jax.random.normal(ks[2], (B, S, H, hd), jnp.float32)
    k4, ksc = KV8.quantize_kv(k, bits=4)
    v4, vsc = KV8.quantize_kv(v, bits=4)
    out = KV8.kv8_decode_attention(q, k4, ksc, v4, vsc)
    ref = dense_attention(q, KV8.dequantize_kv(k4, ksc).astype(jnp.float32),
                          KV8.dequantize_kv(v4, vsc).astype(jnp.float32))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=6e-3, rtol=6e-3)


def test_generate_kv4_end_to_end():
    """Full denoise loop with the int4 KV cache (kv8=4 plumbing): fills
    every mask; trajectory may drift more than int8 but must stay close
    on the tiny model."""
    cfg = tiny_llada_config()
    params = L.unstack_blocks(
        L.init_params(cfg, jax.random.PRNGKey(0), jnp.float32))
    prefix = L.embed_tokens(
        params, jnp.arange(5, 21)[None].astype(jnp.int32))
    gen = GenerationConfig(max_new_tokens=16, block_length=8,
                           step_per_block=4, prefix_lm=True)
    x_ref = np.asarray(generate(params, cfg, prefix, gen))
    x_kv4 = np.asarray(generate(params, cfg, prefix, gen, kv8=4))
    assert (x_kv4 != cfg.mask_token_id).all()
    agree = (x_ref == x_kv4).mean()
    assert agree >= 0.6, f"kv4 trajectory diverged: {agree:.2f}"


def test_kernel_gqa_matches_dense_on_dequant():
    """GQA (Hq = 4, Hkv = 2): query head j*G+g reads KV head j — same
    oracle as the MHA test with K/V heads repeated."""
    B, T, Hq, Hkv, hd, S = 1, 16, 4, 2, 128, 96
    G = Hq // Hkv
    ks = jax.random.split(jax.random.PRNGKey(5), 3)
    q = jax.random.normal(ks[0], (B, T, Hq, hd), jnp.float32)
    k = jax.random.normal(ks[1], (B, S, Hkv, hd), jnp.float32)
    v = jax.random.normal(ks[2], (B, S, Hkv, hd), jnp.float32)
    k8, ksc = KV8.quantize_kv(k)
    v8, vsc = KV8.quantize_kv(v)
    out = KV8.kv8_decode_attention(q, k8, ksc, v8, vsc)
    kd = KV8.dequantize_kv(k8, ksc).astype(jnp.float32)
    vd = KV8.dequantize_kv(v8, vsc).astype(jnp.float32)
    ref = dense_attention(q, jnp.repeat(kd, G, axis=2),
                          jnp.repeat(vd, G, axis=2))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=6e-3, rtol=6e-3)


def test_generate_kv8_gqa_end_to_end():
    """kv8 through the full denoise loop on the GQA tiny config (the
    default tiny fixture is 4q/2kv) — previously fell back to bf16."""
    cfg = tiny_llada_config()  # 4 heads / 2 kv heads
    params = L.unstack_blocks(
        L.init_params(cfg, jax.random.PRNGKey(0), jnp.float32))
    prefix = L.embed_tokens(
        params, jnp.arange(5, 21)[None].astype(jnp.int32))
    gen = GenerationConfig(max_new_tokens=16, block_length=8,
                           step_per_block=4, prefix_lm=True)
    x_ref = np.asarray(generate(params, cfg, prefix, gen))
    x_kv8 = np.asarray(generate(params, cfg, prefix, gen, kv8=True))
    assert (x_kv8 != cfg.mask_token_id).all()
    agree = (x_ref == x_kv8).mean()
    assert agree >= 0.8, f"kv8 GQA trajectory diverged: {agree:.2f}"


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (28, 4)])
def test_kv_quant_attention_matches_dequant_dense(bits, Hq, Hkv):
    """kv8/kv4 attention == dense attention over dequantize_kv, with a
    key-padding mask, for MHA, GQA and Dream's 28/4 grouping, at a cache
    length that is no multiple of 128."""
    B, T, hd, S = 2, 16, 64, 75
    G = Hq // Hkv
    ks = jax.random.split(jax.random.PRNGKey(Hq + bits), 3)
    q = jax.random.normal(ks[0], (B, T, Hq, hd), jnp.float32)
    k = jax.random.normal(ks[1], (B, S, Hkv, hd), jnp.float32)
    v = jax.random.normal(ks[2], (B, S, Hkv, hd), jnp.float32)
    valid = jnp.arange(S)[None] >= jnp.asarray([[0], [11]])
    k8, ksc = KV8.quantize_kv(k, bits)
    v8, vsc = KV8.quantize_kv(v, bits)
    out = KV8.kv8_decode_attention(q, k8, ksc, v8, vsc, kv_valid=valid)
    kd = KV8.dequantize_kv(k8, ksc)
    vd = KV8.dequantize_kv(v8, vsc)
    with jax.default_matmul_precision("highest"):
        ref = dense_attention(q, jnp.repeat(kd, G, axis=2),
                              jnp.repeat(vd, G, axis=2),
                              bias=mask_to_bias(make_mask(kv_valid=valid)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)
