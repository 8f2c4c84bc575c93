"""Prefix-length bucketing: padded (masked) generation must produce the
same tokens as exact-length generation — RoPE is relative, pads are fully
masked, so the logits over real positions are invariant."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.config import (
    GenerationConfig, LaViDaConfig, VisionConfig,
    tiny_llada_config, tiny_siglip_config,
)
from lavida_mod.models.lavida import LaViDa


@pytest.fixture(scope="module")
def model():
    cfg = LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(
            siglip=tiny_siglip_config(), mm_hidden_size=32,
            grid_pinpoints=((56, 112), (112, 56), (112, 112)),
        ),
    )
    return LaViDa.random_init(cfg, 0, jnp.float32)


@pytest.mark.parametrize("prompt_len", [7, 13, 32])
def test_bucketed_generate_matches_exact(model, prompt_len):
    ids = np.arange(3, 3 + prompt_len)
    gen = GenerationConfig(max_new_tokens=16, block_length=16,
                           prefix_lm=True, schedule="shift",
                           schedule_shift=0.33)
    exact = model.generate(ids, gen=gen)
    bucketed = model.generate(ids, gen=gen, prefix_bucket=32)
    np.testing.assert_array_equal(bucketed, exact)


def test_bucketed_with_image(model):
    from lavida_mod.data.anyres import anyres_grid_shape

    rng = np.random.default_rng(0)
    nw, nh = anyres_grid_shape(
        (100, 60), model.cfg.vision.grid_pinpoints, 56
    )
    views = rng.standard_normal(
        (1 + nw * nh, 3, 56, 56)
    ).astype(np.float32)
    ids = np.array([5, 6, -200, 7, 8, 9])
    gen = GenerationConfig(max_new_tokens=8, block_length=8, prefix_lm=True)
    exact = model.generate(ids, [views], [(100, 60)], gen)
    bucketed = model.generate(ids, [views], [(100, 60)], gen,
                              prefix_bucket=64)
    np.testing.assert_array_equal(bucketed, exact)


def test_bucket_is_noop_when_aligned(model):
    ids = np.arange(3, 35)  # exactly 32
    gen = GenerationConfig(max_new_tokens=8, block_length=8)
    a = model.generate(ids, gen=gen, prefix_bucket=32)
    b = model.generate(ids, gen=gen)
    np.testing.assert_array_equal(a, b)


def test_flash_prefill_padded_matches_dense(model):
    """A prefix front-padded to a 128 multiple, masked by prefix_valid,
    through the masked prefill attention: tokens must match the
    exact-length prefill."""
    from lavida_mod.generation import diffusion

    ids = np.arange(3, 40)  # P=37 -> padded to 128
    gen = GenerationConfig(max_new_tokens=16, block_length=16,
                           prefix_lm=True, schedule="shift",
                           schedule_shift=0.33)
    exact = model.generate(ids, gen=gen)
    prefix = model.encode_prompt(ids)
    P = prefix.shape[1]
    Pb = -(-P // 128) * 128
    padded = jnp.concatenate(
        [jnp.zeros((1, Pb - P, prefix.shape[-1]), prefix.dtype), prefix],
        axis=1)
    valid = jnp.arange(Pb)[None] >= Pb - P
    out = diffusion.generate(
        model.params["llada"], model.cfg.llada, padded, gen,
        prefix_valid=valid,
    )
    np.testing.assert_array_equal(np.asarray(out)[0], exact)


def test_generate_fused_matches_generate(model):
    """Single-executable fused path == multi-dispatch path, token-exact."""
    from lavida_mod.data.anyres import anyres_grid_shape

    rng = np.random.default_rng(1)
    nw, nh = anyres_grid_shape(
        (100, 60), model.cfg.vision.grid_pinpoints, 56
    )
    views = rng.standard_normal((1 + nw * nh, 3, 56, 56)).astype(np.float32)
    ids = np.array([5, 6, -200, 7, 8, 9])
    gen = GenerationConfig(max_new_tokens=16, block_length=8,
                           prefix_lm=True, schedule="shift",
                           schedule_shift=0.33)
    a = model.generate(ids, [views], [(100, 60)], gen)
    b = model.generate_fused(ids, [views], [(100, 60)], gen)
    np.testing.assert_array_equal(a, b)


def test_generate_fused_bucketed_matches(model):
    """Front-padded fused plan (prefix_bucket) == unpadded fused ==
    generate(prefix_bucket): the pad rows are masked via prefix_valid so
    the splice-level bucketing is semantics-free, and two prompt lengths
    in the same bucket share one compiled executable."""
    from lavida_mod.data.anyres import anyres_grid_shape

    rng = np.random.default_rng(2)
    nw, nh = anyres_grid_shape(
        (100, 60), model.cfg.vision.grid_pinpoints, 56
    )
    views = rng.standard_normal((1 + nw * nh, 3, 56, 56)).astype(np.float32)
    gen = GenerationConfig(max_new_tokens=16, block_length=8,
                           prefix_lm=True, schedule="shift",
                           schedule_shift=0.33)
    for ids in (np.array([5, 6, -200, 7, 8, 9]),
                np.array([5, 6, -200, 7, 8, 9, 10, 11, 12])):
        plain = model.generate_fused(ids, [views], [(100, 60)], gen)
        bucketed = model.generate_fused(
            ids, [views], [(100, 60)], gen, prefix_bucket=64)
        np.testing.assert_array_equal(plain, bucketed)
        unfused = model.generate(ids, [views], [(100, 60)], gen,
                                 prefix_bucket=64)
        np.testing.assert_array_equal(unfused, bucketed)
