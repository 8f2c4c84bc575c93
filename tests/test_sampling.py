"""Tests for the device-side denoise-commit ops (jit/scan-safe equivalents of
generate.py:274-311)."""

import jax
import jax.numpy as jnp
import numpy as np

from lavida_mod.ops import sampling as P


def test_topk_transfer_mask_matches_topk():
    rng = np.random.default_rng(0)
    conf = jnp.asarray(rng.standard_normal((3, 16)), jnp.float32)
    k = jnp.array([0, 4, 16])
    mask = P.topk_transfer_mask(conf, k)
    assert mask.sum(axis=1).tolist() == [0, 4, 16]
    # row 1: chosen entries are exactly the 4 largest
    row = np.asarray(conf[1])
    chosen = np.sort(np.where(np.asarray(mask[1]))[0])
    expect = np.sort(np.argsort(-row)[:4])
    np.testing.assert_array_equal(chosen, expect)


def test_denoise_commit_low_confidence():
    V, T = 11, 8
    rng = np.random.default_rng(1)
    logits = jnp.asarray(rng.standard_normal((1, T, V)), jnp.float32)
    mask_id = 10
    x = jnp.full((1, T), mask_id, jnp.int32)
    x = x.at[0, 0].set(3)  # already-committed position
    mask_index = x == mask_id

    k = jnp.array([2])
    out = P.denoise_commit(x, logits, mask_index, k, block_end=T)
    out = np.asarray(out)
    # committed position unchanged
    assert out[0, 0] == 3
    # exactly 2 new commits
    assert (out != mask_id).sum() == 3
    # the commits are argmax tokens at the top-2 most confident masked slots
    p = jax.nn.softmax(logits, axis=-1)
    x0 = np.asarray(jnp.argmax(logits, -1))[0]
    conf = np.array(jnp.take_along_axis(p, jnp.argmax(logits, -1)[..., None], -1))[0, :, 0]
    conf[0] = -np.inf
    top2 = np.argsort(-conf)[:2]
    for t in top2:
        assert out[0, t] == x0[t]


def test_denoise_commit_block_clamp():
    # positions >= block_end must not be committed (generate.py:299)
    V, T = 7, 8
    rng = np.random.default_rng(2)
    logits = jnp.asarray(rng.standard_normal((1, T, V)), jnp.float32)
    mask_id = 100  # outside vocab so a commit is always visible
    x = jnp.full((1, T), mask_id, jnp.int32)
    out = P.denoise_commit(x, logits, x == mask_id, jnp.array([4]), block_end=4)
    out = np.asarray(out)
    assert (out[0, 4:] == mask_id).all()
    assert (out[0, :4] != mask_id).all()


def test_gumbel_temperature_zero_is_identity():
    logits = jnp.ones((1, 2, 3))
    assert P.add_gumbel_noise(logits, 0.0, jax.random.PRNGKey(0)) is logits


def test_remasking_shapes():
    rng = np.random.default_rng(3)
    logits = jnp.asarray(rng.standard_normal((2, 5, 9)), jnp.float32)
    x0 = jnp.argmax(logits, -1)
    key = jax.random.PRNGKey(0)
    for mode in ("low_confidence", "random", "entrophy", "margin"):
        c = P.remasking_confidence(logits, x0, mode, key)
        assert c.shape == (2, 5)
    # negative entropy is <= 0
    assert (np.asarray(P.remasking_confidence(logits, x0, "entrophy")) <= 0).all()
    # margin in [0, 1]
    m = np.asarray(P.remasking_confidence(logits, x0, "margin"))
    assert (m >= 0).all() and (m <= 1).all()
