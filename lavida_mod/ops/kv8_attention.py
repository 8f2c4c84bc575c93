"""Decode attention over an int8- or int4-quantized KV cache.

Decode reads the whole KV cache every denoise step; at the 8B serving
shapes (S=1088, H=32, hd=128, 32 layers) that is ~570 MB/step of bf16
K/V, second only to the weight reads.  Storing K/V as int8 (or int4)
halves (quarters) those bytes:

  - K/V live as int8/int4 with per-(head, position) f32 scales
    ([B, H, S, hd] + [B, H, 1, S], head-major);
  - scores = (q @ k8^T) * k_scale * sm_scale: int8 and int4 values are
    exact in bf16, and the per-position k scale folds into the f32 score
    columns;
  - softmax in f32; the v scale folds into p before the AV dot, so the
    output needs no epilogue.

Quantization error is the standard per-head-per-token symmetric int8 KV
(~0.4% rms on k/v rows); parity vs dense attention over the dequantized
cache is tested, and scripts/verify_checkpoint.py gates it per checkpoint.

Reference hot loop being replaced: modeling_llada.py:712-787 (torch SDPA
over a bf16 cache re-concatenated per step).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -1e30


def quantize_kv(x: jax.Array, bits: int = 8) -> tuple[jax.Array, jax.Array]:
    """[B, S, H, hd] float -> ([B, H, S, hd] int8/int4, [B, H, 1, S] f32).

    Per-(b, h, s) symmetric scale, head-major layout.
    bits=4: native jnp.int4 storage (a quarter of the bf16 cache bytes;
    ~3% rms row error vs int8's ~0.4%, quality-gate per checkpoint with
    verify_checkpoint --kv4-check)."""
    assert bits in (8, 4), bits
    xt = x.transpose(0, 2, 1, 3)                       # [B, H, S, hd]
    xf = xt.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    qmax = 127.0 if bits == 8 else 7.0
    scale = jnp.maximum(amax, 1e-8) / qmax
    q = jnp.clip(jnp.round(xf / scale), -qmax, qmax).astype(
        jnp.int8 if bits == 8 else jnp.int4)
    return q, scale[..., 0][:, :, None, :]             # [B, H, 1, S]


def dequantize_kv(q: jax.Array, scale: jax.Array) -> jax.Array:
    """Inverse of quantize_kv -> [B, S, H, hd] f32 (test oracle)."""
    x = q.astype(jnp.float32) * scale[:, :, 0, :, None]
    return x.transpose(0, 2, 1, 3)


def kv8_decode_attention(
    q: jax.Array,          # [B, T, H, hd] (T = gen length, small)
    k8: jax.Array,         # [B, Hkv, S, hd] int8 / int4
    ks: jax.Array,         # [B, Hkv, 1, S] f32
    v8: jax.Array,         # [B, Hkv, S, hd] int8 / int4
    vs: jax.Array,         # [B, Hkv, 1, S] f32
    kv_valid: jax.Array | None = None,   # [B, S] bool
) -> jax.Array:
    """Softmax(q k^T * scale) v over the quantized cache -> [B, T, H, hd].

    The scales never touch the cache: the per-position k scale folds into
    the f32 score columns and the v scale into p before the AV dot, so the
    only full-size reads are the int8/int4 K and V.  GQA-native: query
    head j*G+g reads KV head j (the grouped order of dense_attention)."""
    B, T, H, hd = q.shape
    Hkv = k8.shape[1]
    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, hd)
    s = jnp.einsum("bthgd,bhsd->bhgts", qg, k8.astype(q.dtype),
                   preferred_element_type=jnp.float32)
    s = s * (ks[:, :, None] * (1.0 / hd ** 0.5))      # [B, Hkv, 1, 1, S]
    if kv_valid is not None:
        s = jnp.where(kv_valid[:, None, None, None, :], s, NEG_INF)
    p = jax.nn.softmax(s, axis=-1) * vs[:, :, None]
    out = jnp.einsum("bhgts,bhsd->bthgd", p.astype(q.dtype),
                     v8.astype(q.dtype), preferred_element_type=jnp.float32)
    return out.reshape(B, T, H, hd).astype(q.dtype)


def write_rows(k8, ks, v8, vs, k_new, v_new, index):
    """Quantize this step's K/V rows and write them into the cache at
    [index, index+T): k_new/v_new [B, T, H, hd], traced `index` ok.
    Quantization width follows the cache dtype (int8 or int4)."""
    bits = 4 if k8.dtype == jnp.int4 else 8
    nk8, nks = quantize_kv(k_new, bits)
    nv8, nvs = quantize_kv(v_new, bits)
    k8 = jax.lax.dynamic_update_slice(k8, nk8, (0, 0, index, 0))
    v8 = jax.lax.dynamic_update_slice(v8, nv8, (0, 0, index, 0))
    ks = jax.lax.dynamic_update_slice(ks, nks, (0, 0, 0, index))
    vs = jax.lax.dynamic_update_slice(vs, nvs, (0, 0, 0, index))
    return k8, ks, v8, vs
