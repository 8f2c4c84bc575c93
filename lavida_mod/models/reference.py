"""Plain float32 reference for the LLaDA forward.

Written straight from the math, independent of models/llada.py's layer
code: RMSNorm, half-rotation RoPE, softmax attention with K/V repeated
per query group, SwiGLU, the untied or tied head.  Every matmul runs in
f32 under `default_matmul_precision("highest")` (on the GPU an f32 product
otherwise defaults to TF32).  The weights are whatever layout the model
holds — bf16, int8 or int4 — decoded to f32, so a comparison isolates the
implementation from the quantization.  One jitted layer runs at a time,
so the 8B model needs only one layer's f32 weights in memory.

No cache, no mask: the prefill of one unpadded prompt (what the serving
checks compare).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import LLaDAConfig
from ..ops.quant import dequantize_w4


def dense_weight(p: dict) -> jax.Array:
    """A linear's [in, out] weight in f32, whatever its layout."""
    if "kernel_q4" in p:
        return dequantize_w4(p, jnp.float32)
    if "kernel_q" in p:
        return p["kernel_q"].astype(jnp.float32) * p["scale"].astype(
            jnp.float32)
    return p["kernel"].astype(jnp.float32)


def _lin(x, p):
    y = x @ dense_weight(p)
    if "bias" in p:
        y = y + p["bias"].astype(jnp.float32)
    return y


def _rms(x, w, eps):
    x = x * jax.lax.rsqrt(jnp.mean(x * x, axis=-1, keepdims=True) + eps)
    return x * w.astype(jnp.float32)


def _rope(x, theta):
    """x: [B, T, H, hd] at positions 0..T-1, halves rotated."""
    T, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (jnp.arange(0, hd, 2, dtype=jnp.float32) / hd)
    ang = jnp.arange(T, dtype=jnp.float32)[:, None] * inv[None]
    ang = jnp.concatenate([ang, ang], axis=-1)[None, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return x * jnp.cos(ang) + jnp.concatenate([-x2, x1], axis=-1) * jnp.sin(ang)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _layer(x, p, cfg: LLaDAConfig):
    B, T, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.effective_n_kv_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    h = _rms(x, p["attn_norm"]["weight"], eps)
    if "att_proj" in p:
        q, k, v = jnp.split(_lin(h, p["att_proj"]), [D, D + Hkv * hd], -1)
    else:
        q, k, v = (_lin(h, p[n]) for n in ("q_proj", "k_proj", "v_proj"))
    q = _rope(q.reshape(B, T, H, hd), cfg.rope_theta)
    k = _rope(k.reshape(B, T, Hkv, hd), cfg.rope_theta)
    v = v.reshape(B, T, Hkv, hd)
    k = jnp.repeat(k, H // Hkv, axis=2)
    v = jnp.repeat(v, H // Hkv, axis=2)
    s = jnp.einsum("bthd,bshd->bhts", q, k) / jnp.sqrt(jnp.float32(hd))
    att = jnp.einsum("bhts,bshd->bthd", jax.nn.softmax(s, axis=-1), v)
    x = x + _lin(att.reshape(B, T, D), p["attn_out"])
    h = _rms(x, p["ff_norm"]["weight"], eps)
    if "up_proj" in p:
        ff = jax.nn.silu(_lin(h, p["ff_proj"])) * _lin(h, p["up_proj"])
    else:
        up, gate = jnp.split(_lin(h, p["ff_proj"]), 2, axis=-1)
        ff = jax.nn.silu(gate) * up
    return x + _lin(ff, p["ff_out"])


@functools.partial(jax.jit, static_argnames=("cfg",))
def _head(x, params, cfg: LLaDAConfig):
    x = _rms(x, params["ln_f"]["weight"], cfg.rms_norm_eps)
    if cfg.weight_tying:
        return x @ params["wte"].astype(jnp.float32).T
    return _lin(x, params["ff_out"])


def llada_logits(params: dict, cfg: LLaDAConfig,
                 embeds: jax.Array) -> jax.Array:
    """[B, T, D] prompt embeddings -> [B, T, V] f32 logits.

    Covers the configurations LaViDa serves: RMSNorm, RoPE, no q/k norm,
    llama or fused ("sequential" + swiglu) blocks, stacked or per-layer
    weights in any linear layout."""
    assert cfg.layer_norm_type == "rms" and cfg.rope
    assert not (cfg.attention_layer_norm or cfg.input_emb_norm
                or cfg.scale_logits)
    blocks = params["blocks"]
    stacked = not isinstance(blocks, (list, tuple))
    n = jax.tree.leaves(blocks)[0].shape[0] if stacked else len(blocks)
    with jax.default_matmul_precision("highest"):
        x = embeds.astype(jnp.float32)
        for i in range(n):
            # slice one layer at a time: a stacked 8B tree is not copied
            p = (jax.tree.map(lambda a: a[i], blocks) if stacked
                 else blocks[i])
            x = _layer(x, p, cfg)
        return _head(x, params, cfg)
