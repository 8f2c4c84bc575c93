"""Device-side sampling ops for the masked-diffusion denoise loop.

All functions are shape-static and jit/scan-safe.  The reference's per-row
`torch.topk` python loop (generate.py:304-311) becomes a rank-based masked
select; its float64 gumbel/softmax upcasts (generate.py:16, 279) become
float32 — accelerators have no fast f64, and at temperature 0 (every published
benchmark config) the gumbel path is exact argmax either way.

Reference: llava/model/language_model/llada/generate.py:8-19 (gumbel),
:278-297 (remasking confidences), :299-311 (block clamp + top-k transfer).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -1e30


def add_gumbel_noise(logits: jax.Array, temperature: float, key: jax.Array) -> jax.Array:
    """LLaDA's nonstandard gumbel-max: exp(logits) / (-log u)**temperature.

    Monotone-equivalent to argmax(logits) at temperature 0 (returned as-is).
    """
    if temperature == 0:
        return logits
    logits = logits.astype(jnp.float32)
    noise = jax.random.uniform(key, logits.shape, dtype=jnp.float32, minval=1e-12)
    gumbel = (-jnp.log(noise)) ** temperature
    return jnp.exp(logits) / gumbel


def remasking_confidence(
    logits: jax.Array,
    x0: jax.Array,
    remasking: str,
    key: jax.Array | None = None,
) -> jax.Array:
    """Per-position confidence used to decide which predictions to commit.

    logits: [B, T, V]; x0: [B, T] argmax tokens. Returns [B, T] f32.
    """
    logits = logits.astype(jnp.float32)
    if remasking == "low_confidence":
        p = jax.nn.softmax(logits, axis=-1)
        return jnp.take_along_axis(p, x0[..., None], axis=-1)[..., 0]
    if remasking == "random":
        assert key is not None
        return jax.random.uniform(key, x0.shape, dtype=jnp.float32)
    if remasking == "entrophy":  # sic — keep the reference's spelling for parity
        p = jax.nn.softmax(logits, axis=-1)
        logp = jnp.log(p + 1e-10)
        return jnp.sum(p * logp, axis=-1)  # negative entropy
    if remasking == "margin":
        # top-2 margin without lax.top_k (a k=2 top_k over the 126k
        # vocab lowers to a per-step sort; two O(V) max passes with
        # exactly one argmax instance masked match torch.topk — same
        # rewrite as the Dream sampler, dream_sampler.py::sample_tokens)
        p = jax.nn.softmax(logits, axis=-1)
        i1 = jnp.argmax(p, axis=-1)
        m1 = jnp.take_along_axis(p, i1[..., None], axis=-1)[..., 0]
        m2 = jnp.max(
            p - jax.nn.one_hot(i1, p.shape[-1], dtype=p.dtype) * 2.0,
            axis=-1)
        return m1 - m2
    raise NotImplementedError(remasking)


def topk_transfer_mask(confidence: jax.Array, k_per_row: jax.Array) -> jax.Array:
    """Boolean [B, T] mask selecting each row's top-`k_per_row[b]` confidences.

    Equivalent to the reference's per-row torch.topk + scatter
    (generate.py:304-311) but fixed-shape: rank positions by descending
    confidence (double argsort) and keep rank < k.  Ties break by position
    index, matching topk's ordering for distinct values.
    """
    order = jnp.argsort(-confidence, axis=-1)
    ranks = jnp.argsort(order, axis=-1)
    return ranks < k_per_row[:, None]


def denoise_commit(
    x: jax.Array,
    logits: jax.Array,
    mask_index: jax.Array,
    k_per_row: jax.Array,
    block_end: jax.Array | int,
    temperature: float = 0.0,
    remasking: str = "low_confidence",
    key: jax.Array | None = None,
) -> jax.Array:
    """One denoise commit: pick x0, score confidence, transfer top-k masked
    positions inside the active region. Mirrors generate.py:274-311.

    x: [B, T] current token buffer; logits: [B, T, V]; mask_index: [B, T]
    bool (x == mask_id); k_per_row: [B] ints for this step; block_end:
    scalar — positions >= block_end get confidence -inf (generate.py:299).
    """
    if temperature == 0:
        x0 = jnp.argmax(logits, axis=-1)
    else:
        assert key is not None
        key, gk = jax.random.split(key)
        x0 = jnp.argmax(add_gumbel_noise(logits, temperature, gk), axis=-1)

    conf = remasking_confidence(logits, x0, remasking, key)
    pos = jnp.arange(x.shape[1])[None, :]
    conf = jnp.where(pos >= block_end, NEG_INF, conf)
    conf = jnp.where(mask_index, conf, NEG_INF)

    x0 = jnp.where(mask_index, x0, x)
    transfer = topk_transfer_mask(conf, k_per_row)
    return jnp.where(transfer, x0, x)
