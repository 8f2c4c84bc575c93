"""Multi-chip inference: generation with GSPMD-sharded params must produce
the same tokens as unsharded single-device execution (the serving scale-out
path: tp/fsdp over the mesh, XLA inserts the collectives)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.config import GenerationConfig, tiny_llada_config
from lavida_mod.generation import generate
from lavida_mod.generation.ar_sampler import ar_generate_fused
from lavida_mod.models import llada as jl
from lavida_mod.parallel import make_mesh, shard_params


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_llada_config()
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


def test_sharded_diffusion_generate_matches(tiny):
    cfg, params = tiny
    prompt = jnp.asarray(np.arange(5, 17)[None])
    gen_cfg = GenerationConfig(max_new_tokens=16, block_length=8,
                               prefix_lm=True, schedule="shift",
                               schedule_shift=0.33)
    prefix = jl.embed_tokens(params, prompt)
    ref = np.asarray(generate(params, cfg, prefix, gen_cfg))

    mesh = make_mesh(dp=1, fsdp=4, tp=2)
    sharded = shard_params(params, mesh)
    prefix_s = jl.embed_tokens(sharded, prompt)
    out = np.asarray(generate(sharded, cfg, prefix_s, gen_cfg))
    np.testing.assert_array_equal(out, ref)


def test_sharded_full_context_generate_matches(tiny):
    cfg, params = tiny
    prompt = jnp.asarray(np.arange(3, 12)[None])
    gen_cfg = GenerationConfig(max_new_tokens=8, block_length=8,
                               prefix_lm=False)
    prefix = jl.embed_tokens(params, prompt)
    ref = np.asarray(generate(params, cfg, prefix, gen_cfg))
    mesh = make_mesh(dp=2, fsdp=2, tp=2)
    sharded = shard_params(params, mesh)
    out = np.asarray(generate(sharded, cfg,
                              jl.embed_tokens(sharded, prompt), gen_cfg))
    np.testing.assert_array_equal(out, ref)


def test_sharded_ar_decode_matches(tiny):
    cfg, params = tiny
    prompt = jnp.asarray(np.arange(5, 15)[None])
    prefix = jl.embed_tokens(params, prompt)
    ref = np.asarray(ar_generate_fused(
        params, cfg, prefix, jax.random.PRNGKey(0), 8, eos_id=-1))
    mesh = make_mesh(dp=1, fsdp=2, tp=4)
    sharded = shard_params(params, mesh)
    out = np.asarray(ar_generate_fused(
        sharded, cfg, jl.embed_tokens(sharded, prompt),
        jax.random.PRNGKey(0), 8, eos_id=-1))
    np.testing.assert_array_equal(out, ref)


def test_lavida_shard_method_multimodal_parity():
    """The CLI surface behind predict.py/worker/eval `--tp`: LaViDa.shard
    places the whole composed tree (tower + projector + LM) on a tp mesh
    and model.generate must stay token-identical — the bf16 multi-device
    serving path."""
    from lavida_mod.config import (
        LaViDaConfig, VisionConfig, tiny_siglip_config,
    )
    from lavida_mod.models.lavida import LaViDa

    cfg = LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(
            siglip=tiny_siglip_config(), mm_hidden_size=32,
            grid_pinpoints=((56, 112), (112, 56), (112, 112)),
        ),
    )
    model = LaViDa.random_init(cfg, 0, jnp.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 400, size=12).astype(np.int64)
    ids[4] = -200  # image marker
    # (100, 80) fits the (112, 112) pinpoint -> 2x2 grid + base = 5 views
    views = rng.standard_normal((5, 3, 56, 56)).astype(np.float32)
    gen_cfg = GenerationConfig(max_new_tokens=8, block_length=8,
                               prefix_lm=True)

    ref = np.asarray(model.generate(ids, [views], [(100, 80)], gen_cfg))
    model.shard(tp=2, fsdp=2, dp=2)
    out = np.asarray(model.generate(ids, [views], [(100, 80)], gen_cfg))
    np.testing.assert_array_equal(out, ref)


def test_sharded_batched_chunked_prefill_matches(tiny):
    """Batched serving over the mesh: generate_chunked_prefill (the B>4
    serving route, preallocated merged [B,P+G] KV buffers) with
    GSPMD-sharded serving-layout params must be token-identical to the
    unsharded run — the multi-device form of bench.py --batch.
    B=5 exercises the overlapping last chunk."""
    from lavida_mod.generation.diffusion import generate_chunked_prefill

    cfg, params = tiny
    lp = jl.unstack_blocks(params)  # serving layout (list of layers)
    rng = np.random.default_rng(3)
    prompt = jnp.asarray(rng.integers(5, 400, size=(5, 12)))
    gen_cfg = GenerationConfig(max_new_tokens=8, block_length=8,
                               prefix_lm=True)
    prefix = jl.embed_tokens(lp, prompt)
    ref = np.asarray(generate_chunked_prefill(
        lp, cfg, prefix, gen_cfg, chunk=2, key=jax.random.PRNGKey(0)))

    mesh = make_mesh(dp=1, fsdp=2, tp=4)
    sharded = shard_params(lp, mesh)
    out = np.asarray(generate_chunked_prefill(
        sharded, cfg, jl.embed_tokens(sharded, prompt), gen_cfg,
        chunk=2, key=jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(out, ref)


def test_sharded_batched_monolithic_generate_matches(tiny):
    """The monolithic batched graph (B=4, what bench.py --batch 4 runs)
    under tp sharding: token parity vs unsharded."""
    cfg, params = tiny
    rng = np.random.default_rng(4)
    prompt = jnp.asarray(rng.integers(5, 400, size=(4, 10)))
    gen_cfg = GenerationConfig(max_new_tokens=8, block_length=8,
                               prefix_lm=True)
    prefix = jl.embed_tokens(params, prompt)
    ref = np.asarray(generate(params, cfg, prefix, gen_cfg,
                              key=jax.random.PRNGKey(1)))
    mesh = make_mesh(dp=1, fsdp=1, tp=8)
    sharded = shard_params(params, mesh)
    out = np.asarray(generate(sharded, cfg,
                              jl.embed_tokens(sharded, prompt), gen_cfg,
                              key=jax.random.PRNGKey(1)))
    np.testing.assert_array_equal(out, ref)
