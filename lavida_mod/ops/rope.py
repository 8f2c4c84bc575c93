"""Rotary position embeddings (half-rotation layout).

Matches reference modeling_llada.py:387-452: inv_freq over even dims,
sin/cos duplicated via concat (NOT interleaved), rotate_half splits the head
dim in two contiguous halves, and rotation runs in float32 when
`rope_full_precision` (modeling_llada.py:436-437).

Difference from the reference: the reference caches *un-rotated*
keys and re-applies RoPE to the full concatenated K every denoising step
(modeling_llada.py:738-749).  Positions are absolute and fixed, so rotating
keys once at cache-write time is mathematically identical; we do that and
pass explicit absolute `positions` instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rope_tables(head_dim: int, max_len: int, theta: float) -> tuple[jax.Array, jax.Array]:
    """Precompute (sin, cos) tables of shape [max_len, head_dim], float32."""
    inv_freq = 1.0 / (theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32) / head_dim))
    pos = jnp.arange(max_len, dtype=jnp.float32)
    freqs = jnp.einsum("i,j->ij", pos, inv_freq)
    emb = jnp.concatenate([freqs, freqs], axis=-1)
    return jnp.sin(emb), jnp.cos(emb)


def _rotate_half(x: jax.Array) -> jax.Array:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate([-x2, x1], axis=-1)


def apply_rope(
    x: jax.Array,
    positions: jax.Array,
    sin: jax.Array,
    cos: jax.Array,
    full_precision: bool = True,
) -> jax.Array:
    """Rotate x: [B, T, H, hd] at absolute `positions`: [T] or [B, T]."""
    og_dtype = x.dtype
    if positions.ndim == 1:
        s = sin[positions][None, :, None, :]   # [1, T, 1, hd]
        c = cos[positions][None, :, None, :]
    else:
        s = sin[positions][:, :, None, :]      # [B, T, 1, hd]
        c = cos[positions][:, :, None, :]
    if full_precision:
        x = x.astype(jnp.float32)
    out = x * c + _rotate_half(x) * s
    return out.astype(og_dtype)
