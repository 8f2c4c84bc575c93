"""Attention ops: non-causal GQA attention with optional additive bias.

The reference runs torch SDPA / flash-attn with `is_causal=False` and GQA via
repeat_interleave (modeling_llada.py:648-684).  Here:

  - `attention`: what the models call.  It runs
    `jax.nn.dot_product_attention` with the implementation `attention_impl`
    picks for the backend: cuDNN's fused kernel on the GPU, XLA's form on
    the CPU.
  - `dense_attention`: the plain reference — f32 scores and softmax, GQA by
    reshaping queries into [kv_heads, groups] instead of repeating K/V.
    Tests and the on-card checks compare `attention` against it.
  - `blockwise_attention`: online softmax over KV blocks in plain XLA, for
    training lengths where a [T, S] mask no longer fits.

Masks are bool, broadcastable to [B, H, T, S], True = attend
(`make_mask`); `dense_attention` takes the additive f32 form.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG_INF = -1e30


def dense_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    bias: jax.Array | None = None,
    scale: float | None = None,
) -> jax.Array:
    """q: [B, T, Hq, hd]; k, v: [B, S, Hkv, hd]; Hq % Hkv == 0.

    Returns [B, T, Hq, hd] in q.dtype.
    """
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0, (Hq, Hkv)
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (hd**0.5)

    qg = q.reshape(B, T, Hkv, G, hd)
    # [B, Hkv, G, T, S] f32 scores
    scores = jnp.einsum(
        "bthgd,bshd->bhgts", qg, k, preferred_element_type=jnp.float32
    )
    scores = scores * scale
    if bias is not None:
        # bias broadcast over the query-group axis
        bias = bias.astype(jnp.float32)
        if bias.ndim == 4:  # [B or 1, H or 1, T, S]
            bh = bias.shape[1]
            if bh == 1:
                bias = bias[:, :, None, :, :]
            else:
                bias = bias.reshape(bias.shape[0], Hkv, G, T, S)
        scores = scores + bias
    probs = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum(
        "bhgts,bshd->bthgd", probs.astype(v.dtype), v,
        preferred_element_type=jnp.float32,
    )
    return out.reshape(B, T, Hq, hd).astype(q.dtype)


# The implementation `attention` hands to jax.nn.dot_product_attention on
# each backend.  "gpu" follows the on-card timing in PERF.md ("Kernel
# findings"); "cpu" is XLA's form, which the CPU test suite runs.  A
# backend missing here is an error, not a default.
ATTENTION_IMPL = {"cpu": "xla", "gpu": "cudnn"}

# cuDNN takes a boolean mask as an additive bias, which costs it its lead
# at short keys: on an H100, masked attention over 1029-1061 keys ran
# 1.2-1.8x faster in XLA's form, while from 2048 keys on (training fwd+bwd
# at 2048, 8192) cuDNN stayed ahead.  Unmasked, cuDNN led at every shape.
CUDNN_MASKED_MIN_KEYS = 2048


# Longest training sequence that builds the full [T, S] mask; longer ones
# take `blockwise_attention`, whose memory is O(T x kv_block).
BLOCKWISE_ABOVE = 8192


def training_attention_impl(seq_len: int) -> str:
    """llada.forward's `attention_impl` for a training sequence length."""
    return "dense" if seq_len <= BLOCKWISE_ABOVE else "blockwise"


def attention_impl(q: jax.Array, kv_len: int | None = None,
                   masked: bool = False) -> str:
    """The implementation `attention` uses for `q` on this backend.

    cuDNN's fused kernel takes bf16/fp16 operands with a head dim that is
    a multiple of 8 and at most 256; anything else (the f32 references,
    odd head dims) takes XLA's form on the same backend, and so does a
    masked call over fewer than CUDNN_MASKED_MIN_KEYS keys."""
    backend = jax.default_backend()
    if backend not in ATTENTION_IMPL:
        raise ValueError(
            f"no attention implementation recorded for backend {backend!r}")
    impl = ATTENTION_IMPL[backend]
    hd = q.shape[-1]
    if impl == "cudnn" and not (
            q.dtype in (jnp.bfloat16, jnp.float16)
            and hd % 8 == 0 and hd <= 256):
        return "xla"
    if impl == "cudnn" and masked and (kv_len or 0) < CUDNN_MASKED_MIN_KEYS:
        return "xla"
    return impl


def attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    mask: jax.Array | None = None,
    implementation: str | None = None,
) -> jax.Array:
    """Non-causal GQA attention, the one entry point the models call.

    q: [B, T, Hq, hd]; k, v: [B, S, Hkv, hd] with Hq % Hkv == 0.
    mask: bool, broadcastable to [B, 1 or Hq, T, S], True = attend.
    implementation: None picks `attention_impl(q)`; tests name one.
    Returns [B, T, Hq, hd] in q.dtype."""
    impl = implementation or attention_impl(q, k.shape[1], mask is not None)
    k = k.astype(q.dtype)
    v = v.astype(q.dtype)
    if mask is not None:
        mask = jnp.broadcast_to(
            mask, (q.shape[0], mask.shape[1], q.shape[1], k.shape[1]))
    if impl == "cudnn" and (q.shape[1] % 2 or k.shape[1] % 2):
        return _grad_through_xla(impl, q, k, v, mask)
    return jax.nn.dot_product_attention(q, k, v, mask=mask,
                                        implementation=impl)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _grad_through_xla(impl, q, k, v, mask):
    """`impl` forward, XLA's form for the gradient.

    cuDNN's fused backward in JAX rejects odd sequence lengths (its
    training check counts the unused bias slot as a bias), and SigLIP's
    729 tokens are odd; its forward takes them."""
    return jax.nn.dot_product_attention(q, k, v, mask=mask,
                                        implementation=impl)


def _grad_through_xla_fwd(impl, q, k, v, mask):
    return _grad_through_xla(impl, q, k, v, mask), (q, k, v, mask)


def _grad_through_xla_bwd(impl, res, g):
    q, k, v, mask = res
    _, vjp = jax.vjp(lambda q, k, v: jax.nn.dot_product_attention(
        q, k, v, mask=mask, implementation="xla"), q, k, v)
    return (*vjp(g), None)


_grad_through_xla.defvjp(_grad_through_xla_fwd, _grad_through_xla_bwd)


def blockwise_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    kv_valid: jax.Array | None = None,        # [B, S] bool
    prefix_lengths: jax.Array | None = None,  # [B]
    q_positions: jax.Array | None = None,     # [T] absolute
    scale: float | None = None,
    kv_block: int = 1024,
) -> jax.Array:
    """Memory-bounded attention: online-softmax accumulation over KV blocks
    (flash-attention's algorithm in pure XLA, scan over key blocks).

    Exists for LONG-sequence training: the reference trains at up to 30720
    tokens (llava_llada.py:195-203) where dense scores ([H, T, T] f32) are
    3.8GB/layer; this keeps peak at O(T x kv_block).  The prefix-LM block
    mask and key-padding mask are computed per KV block inside the scan —
    nothing O(T x S) is ever materialized.  Differentiable; remat-friendly.

    Shapes as dense_attention: q [B,T,Hq,hd]; k,v [B,S,Hkv,hd].
    """
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (hd**0.5)
    if q_positions is None:
        q_positions = jnp.arange(T, dtype=jnp.int32)
    nb = -(-S // kv_block)
    Sp = nb * kv_block
    pad = Sp - S
    if pad:
        k = jnp.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
        v = jnp.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
    valid = jnp.ones((B, Sp), bool) if kv_valid is None else jnp.pad(
        kv_valid, ((0, 0), (0, pad))
    )
    if pad:
        valid = valid & (jnp.arange(Sp) < S)[None]

    qg = q.reshape(B, T, Hkv, G, hd)
    kb = k.reshape(B, nb, kv_block, Hkv, hd).transpose(1, 0, 2, 3, 4)
    vb = v.reshape(B, nb, kv_block, Hkv, hd).transpose(1, 0, 2, 3, 4)
    validb = valid.reshape(B, nb, kv_block).transpose(1, 0, 2)
    starts = jnp.arange(nb, dtype=jnp.int32) * kv_block

    def step(carry, xs):
        m, l, acc = carry
        kblk, vblk, vld, start = xs
        s = jnp.einsum("bthgd,bshd->bhgts", qg, kblk,
                       preferred_element_type=jnp.float32) * scale
        # per-block mask: padding + prefix-LM (allowed = kv in prefix
        # OR q in suffix) — O(T x kv_block) only
        allowed = vld[:, None, :]                       # [B, 1, blk]
        if prefix_lengths is not None:
            kv_pos = start + jnp.arange(kv_block, dtype=jnp.int32)
            pl = prefix_lengths[:, None, None].astype(jnp.int32)
            a2 = (kv_pos[None, None, :] < pl) | (
                q_positions[None, :, None] >= pl
            )                                           # [B, T, blk]
            allowed = allowed & a2
        else:
            allowed = jnp.broadcast_to(allowed, (B, T, kv_block))
        s = jnp.where(allowed[:, None, None], s, NEG_INF)
        m_new = jnp.maximum(m, s.max(axis=-1))
        alpha = jnp.exp(m - m_new)
        p = jnp.exp(s - m_new[..., None])
        l = l * alpha + p.sum(axis=-1)
        pv = jnp.einsum("bhgts,bshd->bthgd", p.astype(vblk.dtype), vblk,
                        preferred_element_type=jnp.float32)
        acc = acc * alpha.transpose(0, 3, 1, 2)[..., None] + pv
        return (m_new, l, acc), None

    m0 = jnp.full((B, Hkv, G, T), NEG_INF, jnp.float32)
    l0 = jnp.zeros((B, Hkv, G, T), jnp.float32)
    a0 = jnp.zeros((B, T, Hkv, G, hd), jnp.float32)
    (m, l, acc), _ = jax.lax.scan(step, (m0, l0, a0),
                                  (kb, vb, validb, starts))
    out = acc / jnp.maximum(l, 1e-30).transpose(0, 3, 1, 2)[..., None]
    return out.reshape(B, T, Hq, hd).astype(q.dtype)


def make_mask(
    kv_valid: jax.Array | None = None,
    prefix_lengths: jax.Array | None = None,
    q_positions: jax.Array | None = None,
    kv_positions: jax.Array | None = None,
) -> jax.Array | None:
    """Assemble the boolean attention mask (True = attend).

    kv_valid: [B, S] bool — key-padding mask.
    prefix_lengths: [B] — prefix-LM block mask (modeling_llada.py:1358-1364):
      allowed(q, kv) = (kv_pos < prefix_len) | (q_pos >= prefix_len),
      i.e. everyone sees the prefix; suffix tokens see everything.
    q_positions / kv_positions: [T] / [S] absolute positions (required when
      prefix_lengths is given).
    Returns [B, 1, T or 1, S] bool or None.
    """
    mask = None
    if kv_valid is not None:
        mask = kv_valid[:, None, None, :]
    if prefix_lengths is not None:
        assert q_positions is not None and kv_positions is not None
        pl = prefix_lengths[:, None, None, None].astype(jnp.int32)
        qpos = q_positions.reshape(1, 1, -1, 1)
        kpos = kv_positions.reshape(1, 1, 1, -1)
        allowed = (kpos < pl) | (qpos >= pl)
        mask = allowed if mask is None else mask & allowed
    return mask


def mask_to_bias(mask: jax.Array | None) -> jax.Array | None:
    """Boolean mask -> the additive f32 bias `dense_attention` takes."""
    if mask is None:
        return None
    return jnp.where(mask, 0.0, NEG_INF).astype(jnp.float32)
