"""Chunked-prefill batched decode (diffusion.generate_chunked_prefill):
prefilling the batch in chunk-size slices and denoising the merged batch
must be TOKEN-EXACT vs the monolithic fused generate — the KV cache is a
pure function of each row's prefix, so the split is semantics-free."""

import numpy as np

import jax
import jax.numpy as jnp

from lavida_mod.config import GenerationConfig, tiny_llada_config
from lavida_mod.generation import diffusion
from lavida_mod.models import llada as jl

CFG = tiny_llada_config()
PARAMS = jl.init_params(CFG, jax.random.PRNGKey(0))


def _prefix(B, P=8):
    # distinct prompt per row so a batching bug can't hide
    ids = jnp.stack([jnp.arange(3 + i, 3 + i + P) for i in range(B)])
    return jl.embed_tokens(PARAMS, ids)


def _gen_cfg(G=16, steps=8):
    return GenerationConfig(max_new_tokens=G, block_length=G,
                            steps=steps, prefix_lm=True,
                            schedule="shift", schedule_shift=0.33)


def test_chunked_prefill_token_exact():
    B = 4
    prefix = _prefix(B)
    gen = _gen_cfg()
    ref = np.asarray(diffusion.generate(PARAMS, CFG, prefix, gen))
    for chunk in (1, 2, 4):
        out = np.asarray(diffusion.generate_chunked_prefill(
            PARAMS, CFG, prefix, gen, chunk=chunk))
        np.testing.assert_array_equal(out, ref), chunk


def test_chunked_prefill_non_divisible_batch():
    """B % chunk != 0 runs the last chunk as an overlapping window
    ending at B (prefill is deterministic, so re-writing overlapped rows
    is value-identical); B=5/chunk=4 was previously rejected."""
    B = 5
    prefix = _prefix(B)
    gen = _gen_cfg()
    ref = np.asarray(diffusion.generate(PARAMS, CFG, prefix, gen))
    for chunk in (2, 3, 4):
        out = np.asarray(diffusion.generate_chunked_prefill(
            PARAMS, CFG, prefix, gen, chunk=chunk))
        np.testing.assert_array_equal(out, ref), chunk
    # chunk > B degrades to one whole-batch prefill
    out = np.asarray(diffusion.generate_chunked_prefill(
        PARAMS, CFG, prefix, gen, chunk=8))
    np.testing.assert_array_equal(out, ref)


def test_chunked_prefill_unrolled_params():
    """The serving layout (unrolled list-of-layers params) goes through
    the write-index decode branch; chunked prefill must agree there too."""
    B = 2
    params_u = jl.unstack_blocks(PARAMS)
    prefix = _prefix(B)
    gen = _gen_cfg()
    ref = np.asarray(diffusion.generate(params_u, CFG, prefix, gen))
    out = np.asarray(diffusion.generate_chunked_prefill(
        params_u, CFG, prefix, gen, chunk=1))
    np.testing.assert_array_equal(out, ref)


def test_chunked_prefill_kv8():
    """kv8/kv4 over the chunked prealloc path (quantized at decode
    entry; the write-time variant measured 3.4x slower on chip — see
    generate_chunked_prefill) must be token-exact vs the monolithic
    fused path, which quantizes the same prealloc'd [B, P+G] rows."""
    from lavida_mod.ops import kv8_attention as KV8

    B = 5
    params_u = jl.unstack_blocks(PARAMS)
    prefix = _prefix(B)
    gen = _gen_cfg()
    for kv8 in (True, 4):
        ref = np.asarray(diffusion.generate(
            params_u, CFG, prefix, gen, kv8=kv8))
        out = np.asarray(diffusion.generate_chunked_prefill(
            params_u, CFG, prefix, gen, chunk=2, kv8=kv8))
        np.testing.assert_array_equal(out, ref, err_msg=f"kv8={kv8}")


def test_chunked_prefill_mixed_identity_tree():
    """prefill_params= with the SAME tree must be token-exact (the mixed
    int8-prefill/int4-decode split is pure plumbing when both trees hold
    the same weights; bench.py --batch N --mixed)."""
    B = 5
    prefix = _prefix(B)
    gen = _gen_cfg()
    ref = np.asarray(diffusion.generate_chunked_prefill(
        PARAMS, CFG, prefix, gen, chunk=2))
    out = np.asarray(diffusion.generate_chunked_prefill(
        PARAMS, CFG, prefix, gen, chunk=2, prefill_params=PARAMS))
    np.testing.assert_array_equal(out, ref)


def test_chunked_prefill_flash_bucketed_token_exact():
    """The batched worker/eval configuration: bucket-padded prefixes
    (prefix_valid front-pad mask, applied by the masked prefill attention)
    through the chunked prefill must be token-exact vs the unpadded run.
    This is what eval/adapter.generate_until_batch serves."""
    B, P, pad = 5, 8, 8
    prefix = _prefix(B, P)
    gen = _gen_cfg()
    ref = np.asarray(diffusion.generate(PARAMS, CFG, prefix, gen))

    padded = jnp.concatenate(
        [jnp.zeros((B, pad, prefix.shape[-1]), prefix.dtype), prefix],
        axis=1)
    valid = jnp.concatenate(
        [jnp.zeros((B, pad), bool), jnp.ones((B, P), bool)], axis=1)
    out = np.asarray(diffusion.generate_chunked_prefill(
        PARAMS, CFG, padded, gen, chunk=4, prefix_valid=valid))
    np.testing.assert_array_equal(out, ref)

    # unrolled (serving-layout) params through the prealloc path
    lp = jl.unstack_blocks(PARAMS)
    out_u = np.asarray(diffusion.generate_chunked_prefill(
        lp, CFG, padded, gen, chunk=4, prefix_valid=valid))
    np.testing.assert_array_equal(out_u, ref)
