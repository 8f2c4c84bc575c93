"""Quantized linear layers for serving.

Decode reads every weight at every denoising step, so the bytes a weight
takes decide its speed.  Layouts, each replacing {"kernel": [in, out]}:

  - int8 per output channel: {"kernel_q": int8 [in, out], "scale": f32 [out]};
  - int4 grouped along the input dim: {"kernel_q4": int4 [in, out],
    "scales4": f32 [in/group, out]}.

`linear()` dispatches on the keys, so model code is quantization-agnostic.
All forms are plain XLA; PERF.md ("Kernel findings") records how each
compares with bf16 on the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def quantize_linear(p: dict, dtype=jnp.bfloat16) -> dict:
    """Quantize one linear-param dict (kernel [.., in, out] + optional
    bias).  Works on stacked [L, in, out] kernels too (per (L, out)
    channel scales)."""
    if "kernel" not in p:
        return p
    w = p["kernel"].astype(jnp.float32)
    amax = jnp.max(jnp.abs(w), axis=-2, keepdims=True)  # per-out-channel
    scale = jnp.maximum(amax / 127.0, 1e-8)
    q = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
    out = {"kernel_q": q, "scale": scale.squeeze(-2).astype(jnp.float32)}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quantize_linear4(p: dict, group: int = 128) -> dict:
    """int4 grouped quantization of a single (unstacked) linear param dict:
    {"kernel_q4": int4 [in, out], "scales4": f32 [in/group, out]}.
    AWQ-style grouping along the input dim: each (group, out) block gets a
    symmetric scale, values in [-7, 7].  Plain jnp, so `jax.eval_shape`
    traces it (LaViDa.zero_init builds the layout from shapes)."""
    if "kernel" not in p:
        return p
    k = p["kernel"]
    assert k.ndim == 2, "int4-quantize unstacked (2D) kernels only"
    K, N = k.shape
    assert K % group == 0, (K, group)
    wg = k.astype(jnp.float32).reshape(K // group, group, N)
    scales = jnp.maximum(jnp.max(jnp.abs(wg), axis=1) / 7.0, 1e-8)
    q = jnp.clip(jnp.round(wg / scales[:, None, :]), -7, 7)
    out = {"kernel_q4": q.reshape(K, N).astype(jnp.int4),
           "scales4": scales.astype(jnp.float32)}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def dequantize_w4(p: dict, dtype=jnp.float32) -> jax.Array:
    """int4 layout -> the [in, out] weight it stands for, in `dtype`."""
    q = p["kernel_q4"]
    K, N = q.shape
    G = p["scales4"].shape[0]
    w = q.astype(dtype).reshape(G, K // G, N) * p["scales4"].astype(
        dtype)[:, None, :]
    return w.reshape(K, N)


def _linear_w4(x: jax.Array, p: dict, preferred=None) -> jax.Array:
    """Weight-only int4: dequantize by group into the activation dtype,
    then one dot with f32 accumulation.  The int4 weights are what lives
    in device memory; PERF.md ("Kernel findings") has the on-card timing
    of this form against the integer W4A8 form and bf16."""
    w = dequantize_w4(p, x.dtype)
    y = jnp.matmul(x, w, preferred_element_type=jnp.float32)
    return y.astype(preferred if preferred is not None else x.dtype)


def linear(x: jax.Array, p: dict, preferred=None) -> jax.Array:
    """x @ W (+ bias), W plain / int8 / int4-grouped.  `preferred` sets
    the accumulation/output dtype (e.g. f32 for the logit head).  When LoRA
    factors are attached (train/lora.py), adds (x @ A @ B) * (alpha/r)."""
    if "kernel_q4" in p:
        y = _linear_w4(x, p, preferred)
    elif "kernel_q" in p:
        w = p["kernel_q"].astype(x.dtype)
        y = jnp.matmul(x, w, preferred_element_type=preferred)
        y = y * p["scale"].astype(y.dtype)
    else:
        y = jnp.matmul(x, p["kernel"], preferred_element_type=preferred)
    if "lora_a" in p:
        delta = (x @ p["lora_a"].astype(x.dtype)) @ p["lora_b"].astype(x.dtype)
        y = y + delta.astype(y.dtype) * p["lora_scale"].astype(y.dtype)
    if "bias" in p:
        y = y + p["bias"].astype(y.dtype)
    return y


def linear_act_int8(x: jax.Array, p: dict, preferred=None) -> jax.Array:
    """Dynamic per-token int8 activation quant + int8 weights -> one
    s8 x s8 -> s32 dot_general, with both scales applied to the f32
    accumulator.  Opt-in prefill path; expect ~0.2-0.5% logit error from
    the activation quantization (weight-only stays the default).
    Falls back to `linear` when the weight isn't int8."""
    if "kernel_q" not in p:
        return linear(x, p, preferred)
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    sx = jnp.maximum(amax / 127.0, 1e-8)
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        xq, p["kernel_q"],
        (((xq.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    y = acc.astype(jnp.float32) * sx * p["scale"]
    if "lora_a" in p:
        delta = (x @ p["lora_a"].astype(x.dtype)) @ p["lora_b"].astype(x.dtype)
        y = y + delta.astype(y.dtype) * p["lora_scale"].astype(y.dtype)
    if "bias" in p:
        y = y + p["bias"].astype(y.dtype)
    return y if preferred is not None else y.astype(x.dtype)
