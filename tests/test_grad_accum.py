"""Gradient accumulation (reference --gradient_accumulation_steps 4 in every
cluster launch script, e.g. scripts/train/exps/cluster/llada-hd-llada-s2.sh:55;
HF Trainer semantics: max_steps counts optimizer steps).

The rebuild wraps the multi-transform optimizer in optax.MultiSteps
(train/step.py::_with_grad_accum): k equal microbatches must step identically
to one k-times-larger batch, params must only move on the k-th microstep, and
the accumulated state must survive an orbax checkpoint round-trip (resume).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.config import LaViDaConfig, tiny_llada_config
from lavida_mod.models import llada as jl
from lavida_mod.train.step import (
    jit_train_step, make_freeze_optimizer, make_optimizer, make_train_step,
)


def _tree_allclose(a, b, rtol=1e-5, atol=1e-7):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(
            np.asarray(x, np.float32), np.asarray(y, np.float32),
            rtol=rtol, atol=atol,
        )


def _toy_params(key):
    k1, k2, k3 = jax.random.split(key, 3)
    return {
        "projector": {"kernel": jax.random.normal(k1, (4, 4))},
        "siglip": {"w": jax.random.normal(k2, (3, 3))},
        "llada": {"w": jax.random.normal(k3, (5,))},
    }


def _toy_grads(key, params):
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(
        treedef,
        [jax.random.normal(k, l.shape) for k, l in zip(keys, leaves)],
    )


def test_accum_two_microsteps_equals_one_combined_step():
    """MultiSteps keeps a running MEAN: applying (g1, g2) under grad_accum=2
    must land exactly where one update with (g1+g2)/2 lands (the combined
    2x-batch gradient of a mean loss), including the LR schedule position
    (inner adamw must see this as its FIRST step, not its second)."""
    import optax

    params = _toy_params(jax.random.PRNGKey(0))
    g1 = _toy_grads(jax.random.PRNGKey(1), params)
    g2 = _toy_grads(jax.random.PRNGKey(2), params)

    kw = dict(lr=1e-2, projector_lr=5e-3, warmup_steps=2, total_steps=10)

    opt_a = make_optimizer(grad_accum=2, **kw)
    st = opt_a.init(params)
    pa = params
    up, st = opt_a.update(g1, st, pa)
    # non-final microstep: zero updates, params must not move
    assert all(
        np.all(np.asarray(u) == 0) for u in jax.tree.leaves(up)
    )
    pa = optax.apply_updates(pa, up)
    _tree_allclose(pa, params, rtol=0, atol=0)
    up, st = opt_a.update(g2, st, pa)
    pa = optax.apply_updates(pa, up)

    opt_b = make_optimizer(**kw)
    stb = opt_b.init(params)
    gmean = jax.tree.map(lambda a, b: (a + b) / 2, g1, g2)
    upb, stb = opt_b.update(gmean, stb, params)
    pb = optax.apply_updates(params, upb)

    _tree_allclose(pa, pb)


def test_freeze_optimizer_accum_keeps_frozen_parts_frozen():
    import optax

    params = _toy_params(jax.random.PRNGKey(3))
    opt = make_freeze_optimizer(
        "mm_mlp_adapter", lr=1e-2, total_steps=10, grad_accum=3
    )
    st = opt.init(params)
    p = params
    for i in range(3):
        g = _toy_grads(jax.random.PRNGKey(10 + i), p)
        up, st = opt.update(g, st, p)
        p = optax.apply_updates(p, up)
    # projector moved; frozen siglip/llada bit-identical
    assert not np.allclose(
        np.asarray(p["projector"]["kernel"]),
        np.asarray(params["projector"]["kernel"]),
    )
    _tree_allclose(p["siglip"], params["siglip"], rtol=0, atol=0)
    _tree_allclose(p["llada"], params["llada"], rtol=0, atol=0)


def test_train_step_with_accum_updates_on_boundary_only():
    """Through the real jitted diffusion train step: params frozen for k-1
    microsteps, updated on the k-th, and the metrics stay finite."""
    cfg = LaViDaConfig(llada=tiny_llada_config())
    params = jl.init_params(cfg.llada, jax.random.PRNGKey(0))
    opt = make_optimizer(lr=1e-2, total_steps=10, grad_accum=2)
    opt_state = opt.init(params)
    step = jit_train_step(make_train_step(cfg, opt, prefix_lm=True,
                                          remat=True))

    rng = np.random.default_rng(0)
    B, L = 2, 16
    ids = rng.integers(3, 400, size=(B, L))
    labels = np.full((B, L), -100, np.int64)
    labels[:, 8:] = ids[:, 8:]
    batch = {
        "inputs_embeds": jl.embed_tokens(params, jnp.asarray(ids)),
        "labels": jnp.asarray(labels),
    }

    p0 = jax.tree.map(np.asarray, params)
    params, opt_state, m1 = step(params, opt_state, batch,
                                 jax.random.PRNGKey(1))
    _tree_allclose(params, p0, rtol=0, atol=0)  # microstep 1: no movement
    assert np.isfinite(float(m1["loss"]))
    params, opt_state, m2 = step(params, opt_state, batch,
                                 jax.random.PRNGKey(2))
    moved = any(
        not np.array_equal(np.asarray(a), b)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p0))
    )
    assert moved  # microstep 2 = the optimizer step
    assert np.isfinite(float(m2["grad_norm"]))


def test_accum_opt_state_orbax_roundtrip(tmp_path):
    """Resume: MultiSteps state (mini_step counter + acc_grads) must survive
    save_checkpoint/restore_checkpoint bit-exactly mid-accumulation."""
    from lavida_mod.utils import restore_checkpoint, save_checkpoint

    params = _toy_params(jax.random.PRNGKey(4))
    opt = make_optimizer(lr=1e-2, total_steps=10, grad_accum=2)
    st = opt.init(params)
    g = _toy_grads(jax.random.PRNGKey(5), params)
    _, st = opt.update(g, st, params)  # mid-accumulation state

    path = save_checkpoint(str(tmp_path), 1, params, st)
    restored = restore_checkpoint(
        path, {"params": params, "opt_state": jax.tree.map(np.asarray, st),
               "step": 0}
    )
    _tree_allclose(restored["opt_state"], st, rtol=0, atol=0)
