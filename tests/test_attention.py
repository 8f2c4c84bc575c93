"""ops/attention.py: the one attention entry point against the plain f32
reference (dense_attention), the backend choice, masks, and the
blockwise long-sequence form.

The CPU runs `implementation="xla"`; the cuDNN route is compared with
the same reference on the card (the `gpu`-marked test, also run by
chip_smoke.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.ops import attention as A


def _qkv(B, T, S, Hq, Hkv, hd, seed=0, dtype=jnp.float32):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(ks[0], (B, T, Hq, hd), jnp.float32)
    k = jax.random.normal(ks[1], (B, S, Hkv, hd), jnp.float32)
    v = jax.random.normal(ks[2], (B, S, Hkv, hd), jnp.float32)
    return q.astype(dtype), k.astype(dtype), v.astype(dtype)


def _mask(kind, B, T, S):
    """Boolean masks of the kinds the models build (make_mask)."""
    kv_valid = jnp.arange(S)[None] >= jnp.asarray([[3], [0]])[:B]
    if kind == "none":
        return None
    if kind == "padding":
        return A.make_mask(kv_valid=kv_valid)
    prefix = jnp.asarray([S // 3, S // 2])[:B]
    q_pos = jnp.arange(S - T, S, dtype=jnp.int32)
    kv_pos = jnp.arange(S, dtype=jnp.int32)
    if kind == "prefix_lm":
        return A.make_mask(prefix_lengths=prefix, q_positions=q_pos,
                           kv_positions=kv_pos)
    return A.make_mask(kv_valid=kv_valid, prefix_lengths=prefix,
                       q_positions=q_pos, kv_positions=kv_pos)


@pytest.mark.parametrize("hd", [72, 128])
@pytest.mark.parametrize("groups", [1, 4, 7])
@pytest.mark.parametrize("mask_kind",
                         ["none", "padding", "prefix_lm", "padding+prefix"])
def test_attention_xla_matches_dense_f32(mask_kind, groups, hd):
    """Lengths that are no multiple of 128; GQA groups of LLaDA (1),
    Dream (7 = 28 q heads over 4 kv heads) and one in between; head dims
    of SigLIP so400m (72) and the LMs (128)."""
    B, T, S, Hkv = 2, 37, 53, 2
    q, k, v = _qkv(B, T, S, groups * Hkv, Hkv, hd, seed=groups + hd)
    mask = _mask(mask_kind, B, T, S)
    out = A.attention(q, k, v, mask, implementation="xla")
    with jax.default_matmul_precision("highest"):
        ref = A.dense_attention(q, k, v, bias=A.mask_to_bias(mask))
    assert out.shape == q.shape and out.dtype == q.dtype
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("mask_kind", ["none", "prefix_lm"])
def test_attention_bf16_matches_dense_f32(mask_kind, groups):
    """bf16 operands (the serving dtype): error is bf16 rounding of the
    inputs and of p before the AV product."""
    B, T, S, Hkv, hd = 2, 33, 65, 2, 128
    q, k, v = _qkv(B, T, S, groups * Hkv, Hkv, hd, seed=5)
    mask = _mask(mask_kind, B, T, S)
    out = A.attention(q.astype(jnp.bfloat16), k.astype(jnp.bfloat16),
                      v.astype(jnp.bfloat16), mask)
    ref = A.dense_attention(q, k, v, bias=A.mask_to_bias(mask))
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("groups", [1, 4, 7])
def test_attention_gradient_matches_dense(groups):
    """The training path differentiates through attention with the
    prefix-LM mask: grads of q, k, v equal the f32 reference's."""
    B, T, Hkv, hd = 2, 29, 1, 64
    q, k, v = _qkv(B, T, T, groups * Hkv, Hkv, hd, seed=9)
    mask = _mask("padding+prefix", B, T, T)
    w = jax.random.normal(jax.random.PRNGKey(3), q.shape)

    def loss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v) * w)

    got = jax.grad(loss(lambda q, k, v: A.attention(q, k, v, mask)),
                   argnums=(0, 1, 2))(q, k, v)
    with jax.default_matmul_precision("highest"):
        ref = jax.grad(loss(lambda q, k, v: A.dense_attention(
            q, k, v, bias=A.mask_to_bias(mask))), argnums=(0, 1, 2))(q, k, v)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("mask_shape", [(1, 1, 1, 40), (2, 1, 1, 40),
                                        (1, 1, 24, 40), (2, 1, 24, 40)])
def test_attention_broadcasts_mask(mask_shape):
    """Masks come as [B|1, 1, T|1, S]; every form gives the answer of the
    fully broadcast mask."""
    B, T, S = 2, 24, 40
    q, k, v = _qkv(B, T, S, 4, 2, 32, seed=11)
    m = jax.random.bernoulli(jax.random.PRNGKey(4), 0.8, mask_shape)
    m = m.at[..., 0].set(True)
    full = jnp.broadcast_to(m, (B, 1, T, S))
    np.testing.assert_allclose(
        np.asarray(A.attention(q, k, v, m)),
        np.asarray(A.attention(q, k, v, full)), atol=1e-6)


def test_attention_casts_cache_dtype():
    """k/v from a cache in another dtype are cast to q's dtype."""
    q, k, v = _qkv(1, 8, 16, 2, 2, 32, seed=12)
    out = A.attention(q.astype(jnp.bfloat16), k, v)
    assert out.dtype == jnp.bfloat16


@pytest.mark.parametrize("kind,expect", [
    ("padding", (2, 1, 1, 53)),
    ("prefix_lm", (2, 1, 37, 53)),
    ("padding+prefix", (2, 1, 37, 53)),
])
def test_make_mask_shapes_and_semantics(kind, expect):
    B, T, S = 2, 37, 53
    m = _mask(kind, B, T, S)
    assert m.shape == expect and m.dtype == jnp.bool_
    full = np.broadcast_to(np.asarray(m), (B, 1, T, S))
    if "prefix" in kind:
        pl = np.asarray([S // 3, S // 2])
        q_pos = np.arange(S - T, S)
        kv_pos = np.arange(S)
        allowed = ((kv_pos[None, None, :] < pl[:, None, None])
                   | (q_pos[None, :, None] >= pl[:, None, None]))
        if kind == "padding+prefix":
            allowed = allowed & (kv_pos >= np.asarray([[3], [0]]))[:, None]
        np.testing.assert_array_equal(full[:, 0], allowed)
    assert A.make_mask() is None
    assert A.mask_to_bias(None) is None


def test_backend_choice_cpu_is_xla():
    q = jnp.zeros((1, 4, 2, 128), jnp.bfloat16)
    assert jax.default_backend() == "cpu"
    assert A.attention_impl(q) == "xla"


@pytest.mark.parametrize("dtype,hd,expect", [
    (jnp.bfloat16, 128, "cudnn"),
    (jnp.bfloat16, 72, "cudnn"),      # SigLIP so400m head dim
    (jnp.float16, 64, "cudnn"),
    (jnp.float32, 128, "xla"),        # f32 references
    (jnp.bfloat16, 100, "xla"),       # not a multiple of 8
    (jnp.bfloat16, 512, "xla"),       # above cuDNN's 256
])
def test_backend_choice_gpu(monkeypatch, dtype, hd, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert A.attention_impl(jnp.zeros((1, 4, 2, hd), dtype)) == expect


@pytest.mark.parametrize("kv_len,masked,expect", [
    (1029, False, "cudnn"),     # unmasked prefill
    (1061, True, "xla"),        # masked decode over the prefix cache
    (2047, True, "xla"),
    (2048, True, "cudnn"),      # masked training rows from 2048 keys on
    (8192, True, "cudnn"),
])
def test_backend_choice_gpu_masked(monkeypatch, kv_len, masked, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    q = jnp.zeros((1, 4, 2, 128), jnp.bfloat16)
    assert A.attention_impl(q, kv_len, masked) == expect


def test_backend_choice_unknown_backend_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(ValueError, match="no attention implementation"):
        A.attention_impl(jnp.zeros((1, 4, 2, 128), jnp.bfloat16))


@pytest.mark.parametrize("seq,expect", [(1024, "dense"), (8192, "dense"),
                                        (8193, "blockwise"),
                                        (30720, "blockwise")])
def test_training_attention_impl(seq, expect):
    assert A.training_attention_impl(seq) == expect


@pytest.mark.parametrize("kv_block", [16, 64])
@pytest.mark.parametrize("prefix", [False, True])
def test_blockwise_matches_attention(kv_block, prefix):
    """The long-sequence form equals one masked attention call (key
    padding + prefix-LM computed per block)."""
    B, T, Hkv, G, hd = 2, 45, 2, 2, 32
    q, k, v = _qkv(B, T, T, Hkv * G, Hkv, hd, seed=21)
    valid = jnp.arange(T)[None] < jnp.asarray([[T], [T - 5]])
    pl = jnp.asarray([10, 20]) if prefix else None
    pos = jnp.arange(T, dtype=jnp.int32)
    out = A.blockwise_attention(q, k, v, kv_valid=valid, prefix_lengths=pl,
                                q_positions=pos, kv_block=kv_block)
    mask = A.make_mask(kv_valid=valid, prefix_lengths=pl,
                       q_positions=pos if prefix else None,
                       kv_positions=pos if prefix else None)
    ref = A.attention(q, k, v, mask)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("mask_kind", ["none", "padding+prefix"])
@pytest.mark.parametrize("T,S", [(29, 29), (30, 31), (729, 729)])
def test_grad_through_xla_matches_plain_attention(mask_kind, T, S):
    """The odd-length route: its forward is the named implementation's,
    its gradient XLA's form's; with XLA named, both equal plain
    attention, masked or not."""
    B = 2
    q, k, v = _qkv(B, T, S, 4, 2, 32, seed=T + S)
    mask = _mask(mask_kind, B, T, S)
    if mask is not None:
        mask = jnp.broadcast_to(mask, (B, 1, T, S))
    w = jax.random.normal(jax.random.PRNGKey(5), q.shape)

    def plain(q, k, v):
        return A.attention(q, k, v, mask, implementation="xla")

    def routed(q, k, v):
        return A._grad_through_xla("xla", q, k, v, mask)

    np.testing.assert_allclose(np.asarray(routed(q, k, v)),
                               np.asarray(plain(q, k, v)), atol=1e-6)
    got, ref = (jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * w),
                         argnums=(0, 1, 2))(q, k, v) for f in (routed, plain))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("T,S,routed", [
    (729, 729, True), (1029, 1029, True), (32, 1061, True),
    (30, 1061, True), (512, 512, False), (32, 1152, False)])
def test_cudnn_odd_lengths_take_the_xla_gradient(monkeypatch, T, S, routed):
    """A cuDNN call with an odd query or key length goes through
    _grad_through_xla; an even one calls cuDNN directly."""
    seen = []
    monkeypatch.setattr(A, "_grad_through_xla",
                        lambda impl, q, k, v, mask: seen.append(impl) or q)
    monkeypatch.setattr(jax.nn, "dot_product_attention",
                        lambda q, k, v, mask, implementation: q)
    q, k, v = _qkv(1, T, S, 2, 2, 8, dtype=jnp.bfloat16)
    A.attention(q, k, v, implementation="cudnn")
    assert seen == (["cudnn"] if routed else [])


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,Hq,hd", [
    (2, 729, 16, 72),       # SigLIP so400m views in stage-2 training
    (1, 1029, 32, 128),     # an odd-length LLaDA row
])
def test_cudnn_odd_length_gradient_on_card(gpu, B, T, Hq, hd):
    """Training through cuDNN at an odd length: grads of q, k, v vs the
    f32 reference (bf16 inputs; max error relative to the largest grad)."""
    q, k, v = _qkv(B, T, T, Hq, Hq, hd, seed=T)
    w = jax.random.normal(jax.random.PRNGKey(6), q.shape)
    bf = [x.astype(jnp.bfloat16) for x in (q, k, v)]
    got = jax.grad(lambda q, k, v: jnp.sum(
        A.attention(q, k, v).astype(jnp.float32) * w),
        argnums=(0, 1, 2))(*bf)
    with jax.default_matmul_precision("highest"):
        ref = jax.grad(lambda q, k, v: jnp.sum(A.dense_attention(
            q, k, v) * w), argnums=(0, 1, 2))(
            *[x.astype(jnp.float32) for x in bf])
    for g, r in zip(got, ref):
        g, r = np.asarray(g, np.float32), np.asarray(r)
        assert np.abs(g - r).max() <= 3e-2 * np.abs(r).max()


@pytest.mark.gpu
@pytest.mark.parametrize("T,S,Hq,Hkv,hd", [
    (1029, 1029, 32, 32, 128),     # LLaDA prefill
    (32, 1061, 32, 32, 128),       # decode rows over the prefix cache
    (64, 1093, 28, 4, 128),        # Dream GQA
    (729, 729, 16, 16, 72),        # SigLIP so400m view
])
def test_cudnn_matches_dense_on_card(gpu, T, S, Hq, Hkv, hd):
    """cuDNN's fused kernel at the serving shapes vs the f32 reference
    (bf16 inputs; tolerance is bf16 rounding of p and the output)."""
    q, k, v = _qkv(1, T, S, Hq, Hkv, hd, seed=T)
    mask = _mask("padding", 1, T, S)
    out = A.attention(q.astype(jnp.bfloat16), k.astype(jnp.bfloat16),
                      v.astype(jnp.bfloat16), mask, implementation="cudnn")
    with jax.default_matmul_precision("highest"):
        ref = A.dense_attention(q, k, v, bias=A.mask_to_bias(mask))
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref),
                               atol=3e-2, rtol=3e-2)
