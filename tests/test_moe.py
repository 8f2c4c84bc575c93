"""MoE block tests: routing semantics, core integration, AR decode."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.config import tiny_llada_config
from lavida_mod.models import llada as jl
from lavida_mod.models.moe import init_moe_params, load_balancing_loss, moe_ff


def test_moe_single_expert_equals_dense():
    """E=1, top-1: routing weight is exactly 1, so MoE == that expert's
    SwiGLU."""
    D, H = 16, 32
    p = init_moe_params(D, H, 1, jax.random.PRNGKey(0))
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal((2, 5, D)).astype(np.float32)
    )
    out, load = moe_ff(x, p, top_k=1)
    e = p["experts"]
    ref = (
        jax.nn.silu(x @ e["ff_proj"]["kernel"][0])
        * (x @ e["up_proj"]["kernel"][0])
    ) @ e["ff_out"]["kernel"][0]
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(float(load[0]), 1.0, atol=1e-6)


def test_moe_topk_weights_renormalized():
    D, H, E = 8, 16, 4
    p = init_moe_params(D, H, E, jax.random.PRNGKey(1))
    x = jnp.asarray(
        np.random.default_rng(1).standard_normal((1, 7, D)).astype(np.float32)
    )
    out, load = moe_ff(x, p, top_k=2)
    assert out.shape == x.shape
    assert np.isfinite(np.asarray(out)).all()
    np.testing.assert_allclose(float(load.sum()), 1.0, atol=1e-5)
    aux = load_balancing_loss(load)
    assert float(aux) >= 1.0 - 1e-5  # minimized at uniform load (==1)


def test_moe_in_core_forward_and_ar_decode():
    """Blocks carrying a "moe" entry run through the shared core and the AR
    sampler."""
    from lavida_mod.generation.ar_sampler import ar_generate_fused

    cfg = tiny_llada_config()
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    # swap layer FFs for MoE (stacked over layers like other block params)
    L = cfg.n_layers
    moes = [init_moe_params(cfg.d_model, 32, 4, jax.random.fold_in(
        jax.random.PRNGKey(7), i)) for i in range(L)]
    params["blocks"]["moe"] = jax.tree.map(
        lambda *xs: jnp.stack(xs), *moes
    )
    for k in ("ff_proj", "up_proj", "ff_out"):
        del params["blocks"][k]

    emb = jl.embed_tokens(params, jnp.asarray(np.arange(5, 15)[None]))
    logits, _ = jl.forward(params, cfg, emb)
    assert np.isfinite(np.asarray(logits)).all()

    out = ar_generate_fused(
        params, cfg, emb, jax.random.PRNGKey(0), 6, eos_id=-1
    )
    assert out.shape == (1, 6)
