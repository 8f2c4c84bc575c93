"""Mixed-precision training policy (DeepSpeed bf16-engine parity).

The reference's stage-2 run is DeepSpeed ZeRO-3 with bf16 enabled
(/root/reference/scripts/zero3.json:10-12, launched by
scripts/train/exps/cluster/llada-hd-llada-s2.sh): the bf16 engine keeps an
fp32 flat master copy of the params and fp32 Adam moments, applying updates
in fp32 and casting to bf16 only for forward/backward.  The rebuild's
equivalent is `compute_dtype=bf16` over f32 master params
(train/step.py::make_train_step) plus `multi_steps_f32` for f32 gradient
accumulation with bf16 params.

Key numerics fact under test: a bf16 weight w absorbs an additive update u
only when |u/w| >~ 2^-9 (~0.2%); at lr 2e-5 on O(1) weights (e.g. RMSNorm
scales, init exactly 1.0) every update rounds to ZERO, so bf16-everything
training silently freezes those params — the failure fp32 masters exist to
prevent.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from lavida_mod.config import (
    LaViDaConfig, VisionConfig, tiny_llada_config, tiny_siglip_config,
)
from lavida_mod.models import llada as jl
from lavida_mod.train.step import (
    cast_floating, jit_train_step, make_freeze_optimizer, make_optimizer,
    make_train_step, make_multimodal_train_step, multi_steps_f32,
)


def _lm_batch(params, seed=0, B=2, L=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 400, size=(B, L))
    labels = np.full((B, L), -100, np.int64)
    labels[:, L // 2:] = ids[:, L // 2:]
    return {
        "inputs_embeds": jl.embed_tokens(params, jnp.asarray(ids)),
        "labels": jnp.asarray(labels),
    }


def test_bf16_updates_round_to_zero_fp32_masters_accumulate():
    """The motivating failure: at lr 1e-6 the RMSNorm scales (exactly 1.0)
    never move in bf16 (1 + 1e-6 rounds back to 1.0) but accumulate in f32
    masters — over 8 steps a measurable drift."""
    cfg = LaViDaConfig(llada=tiny_llada_config())
    # numpy base: the jitted step donates params, and a same-dtype astype
    # aliases rather than copies — numpy leaves force a fresh device copy
    base = jax.tree.map(
        np.asarray, jl.init_params(cfg.llada, jax.random.PRNGKey(0),
                                   jnp.float32))

    def run(params, compute_dtype):
        opt = make_optimizer(lr=1e-6, total_steps=100, schedule="constant",
                             warmup_steps=0)
        opt_state = opt.init(params)
        step = jit_train_step(make_train_step(
            cfg, opt, prefix_lm=True, remat=False,
            compute_dtype=compute_dtype,
        ))
        batch = _lm_batch(base)
        if compute_dtype is not None:
            batch = dict(batch,
                         inputs_embeds=batch["inputs_embeds"].astype(
                             compute_dtype))
        for i in range(8):
            params, opt_state, m = step(params, opt_state, batch,
                                        jax.random.PRNGKey(i))
        assert np.isfinite(float(m["loss"]))
        return params

    p_mixed = run(cast_floating(base, jnp.float32), jnp.bfloat16)
    p_bf16 = run(cast_floating(base, jnp.bfloat16), None)

    norm0 = np.asarray(base["blocks"]["attn_norm"]["weight"], np.float32)
    norm_mixed = np.asarray(
        p_mixed["blocks"]["attn_norm"]["weight"], np.float32)
    norm_bf16 = np.asarray(
        p_bf16["blocks"]["attn_norm"]["weight"], np.float32)

    # bf16: every 1e-6-scale update on the 1.0 norm scales rounded to zero
    np.testing.assert_array_equal(norm_bf16, norm0)
    # f32 masters: the same updates accumulated
    assert np.abs(norm_mixed - norm0).max() > 1e-6, (
        "f32 masters did not accumulate sub-bf16-ulp updates")
    assert p_mixed["blocks"]["attn_norm"]["weight"].dtype == jnp.float32


def test_mixed_forward_matches_bf16_params_exactly():
    """bf16 -> f32 upcast is exact, so the bf16 compute cast of f32 masters
    (fresh from a bf16 checkpoint) sees bit-identical weights: the first
    forward loss must match the bf16-param step exactly."""
    cfg = LaViDaConfig(llada=tiny_llada_config())
    p_bf16 = jl.init_params(cfg.llada, jax.random.PRNGKey(0), jnp.bfloat16)
    p_f32 = cast_floating(p_bf16, jnp.float32)

    opt = make_optimizer(lr=1e-3, total_steps=10)
    batch = _lm_batch(p_f32)
    batch = dict(batch,
                 inputs_embeds=batch["inputs_embeds"].astype(jnp.bfloat16))

    step_bf16 = jit_train_step(make_train_step(
        cfg, opt, prefix_lm=True, remat=False))
    step_mixed = jit_train_step(make_train_step(
        cfg, opt, prefix_lm=True, remat=False, compute_dtype=jnp.bfloat16))

    _, _, m_bf16 = step_bf16(p_bf16, opt.init(p_bf16), batch,
                             jax.random.PRNGKey(1))
    _, _, m_mixed = step_mixed(p_f32, opt.init(p_f32), batch,
                               jax.random.PRNGKey(1))
    assert float(m_bf16["loss"]) == pytest.approx(
        float(m_mixed["loss"]), abs=1e-6)


def test_mixed_policy_states_are_f32():
    """Adam mu/nu and (at grad_accum>1) the accumulator inherit the f32
    masters — DeepSpeed's fp32 optimizer states, structurally."""
    cfg = LaViDaConfig(llada=tiny_llada_config())
    params = cast_floating(
        jl.init_params(cfg.llada, jax.random.PRNGKey(0), jnp.bfloat16),
        jnp.float32)
    opt = make_optimizer(lr=1e-3, total_steps=10, grad_accum=4)
    st = opt.init(params)
    for leaf in jax.tree.leaves(st):
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            assert leaf.dtype == jnp.float32, leaf.dtype


def test_multi_steps_f32_matches_multisteps_on_f32_params():
    """With f32 params the custom f32 accumulator and optax.MultiSteps
    compute the same running mean -> identical updates."""
    params = {"w": jnp.asarray(np.random.default_rng(0)
                               .standard_normal((8, 8)), jnp.float32)}
    grads = [
        {"w": jnp.asarray(np.random.default_rng(i + 1)
                          .standard_normal((8, 8)), jnp.float32)}
        for i in range(4)
    ]
    inner = optax.adamw(1e-2)

    def run(opt):
        p, st = params, opt.init(params)
        for g in grads:
            up, st = opt.update(g, st, p)
            p = optax.apply_updates(p, up)
        return p

    p_ref = run(optax.MultiSteps(inner, every_k_schedule=4))
    p_f32 = run(multi_steps_f32(inner, 4))
    np.testing.assert_allclose(np.asarray(p_f32["w"]),
                               np.asarray(p_ref["w"]), rtol=1e-6, atol=1e-7)


def test_multi_steps_f32_accumulates_f32_with_bf16_params():
    """bf16 params: MultiSteps' acc_grads would be bf16 (zeros_like);
    multi_steps_f32 must hold the running mean in f32 and only update on
    the k-th microstep."""
    params = {"w": jnp.ones((4, 4), jnp.bfloat16)}
    opt = multi_steps_f32(optax.adamw(1e-2), 3)
    st = opt.init(params)
    assert st.acc_grads["w"].dtype == jnp.float32

    g = {"w": jnp.full((4, 4), 0.1, jnp.bfloat16)}
    p = params
    for i in range(3):
        up, st = opt.update(g, st, p)
        if i < 2:
            assert np.all(np.asarray(up["w"], np.float32) == 0)
        p = optax.apply_updates(p, up)
    assert not np.array_equal(np.asarray(p["w"], np.float32),
                              np.asarray(params["w"], np.float32))
    # window reset
    assert np.all(np.asarray(st.acc_grads["w"]) == 0)
    assert int(st.mini_step) == 0


def test_trajectory_divergence_bf16_vs_mixed():
    """N steps at a training-realistic relative LR,
    fixed seeds — the bf16-everything trajectory measurably diverges from
    the f32-master trajectory (rounding accumulates), while the f32 master
    trajectory equals itself re-run (determinism guard)."""
    cfg = LaViDaConfig(llada=tiny_llada_config())
    base = jl.init_params(cfg.llada, jax.random.PRNGKey(0), jnp.bfloat16)

    def run(params, compute_dtype):
        opt = make_optimizer(lr=3e-5, total_steps=1000, schedule="constant")
        opt_state = opt.init(params)
        step = jit_train_step(make_train_step(
            cfg, opt, prefix_lm=True, remat=False,
            compute_dtype=compute_dtype))
        losses = []
        for i in range(12):
            batch = _lm_batch(params if compute_dtype is None else
                              cast_floating(params, jnp.bfloat16),
                              seed=i)
            batch = dict(batch, inputs_embeds=batch["inputs_embeds"]
                         .astype(jnp.bfloat16))
            params, opt_state, m = step(params, opt_state, batch,
                                        jax.random.PRNGKey(100 + i))
            losses.append(float(m["loss"]))
        return params, losses

    p_mixed, l_mixed = run(cast_floating(base, jnp.float32), jnp.bfloat16)
    p_mixed2, l_mixed2 = run(cast_floating(base, jnp.float32), jnp.bfloat16)
    p_bf16, l_bf16 = run(base, None)

    assert l_mixed == l_mixed2  # deterministic
    # the policies genuinely diverge (bf16 loses sub-ulp updates)
    wte_mixed = np.asarray(p_mixed["wte"], np.float32)
    wte_bf16 = np.asarray(p_bf16["wte"], np.float32)
    assert np.abs(wte_mixed - wte_bf16).max() > 0
    assert l_mixed != l_bf16


def test_multimodal_sharded_mixed_tower_grads_flow():
    """The stage-2 multimodal step (pixels ->
    SigLIP -> splice -> loss) under a (dp, fsdp, tp) mesh with f32 masters
    + bf16 compute; tower params must move (tower LR group live)."""
    from lavida_mod.models import multimodal as mm
    from lavida_mod.parallel import make_mesh, shard_params

    cfg = LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32),
    )
    mesh = make_mesh(dp=2, fsdp=2, tp=2)
    params = shard_params(mm.init_params(cfg, jax.random.PRNGKey(0)), mesh)
    params = cast_floating(params, jnp.float32)

    opt = make_freeze_optimizer(
        "mm_mlp_adapter,mm_vision_tower,mm_language_model",
        lr=5e-3, vision_tower_lr=1e-3, total_steps=10,
    )
    opt_state = opt.init(params)
    step = jit_train_step(make_multimodal_train_step(
        cfg, opt, prefix_lm=True, remat=True, mesh=mesh,
        compute_dtype=jnp.bfloat16,
    ))

    B, T_text = 8, 12
    S = cfg.vision.siglip.image_size
    rng = np.random.default_rng(0)
    ids_list = [
        np.concatenate(([5, -200], rng.integers(3, 400, size=T_text - 2)))
        for _ in range(B)
    ]
    labels_list = []
    for ids in ids_list:
        lab = np.full(ids.shape, -100, np.int64)
        lab[len(ids) // 2:] = ids[len(ids) // 2:]
        labels_list.append(lab)
    gather_idx, text_ids, _, labels = mm.build_gather_plan(
        cfg, ids_list, [[1]] * B, [[(S, S)]] * B, labels_list,
    )
    batch = {
        "pixel_values": jnp.asarray(
            rng.standard_normal((B, 3, S, S)), jnp.bfloat16),
        "text_ids": jnp.asarray(text_ids),
        "gather_idx": jnp.asarray(gather_idx),
        "labels": jnp.asarray(labels),
    }
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float32).copy(), params)
    params, opt_state, metrics = step(params, opt_state, batch,
                                      jax.random.PRNGKey(0))
    assert np.isfinite(float(metrics["loss"]))
    # tower grads flowed: a deep tower leaf moved
    moved = not np.allclose(
        np.asarray(params["siglip"]["layers"]["q_proj"]["kernel"],
                   np.float32),
        p0["siglip"]["layers"]["q_proj"]["kernel"], atol=0)
    assert moved
    assert params["siglip"]["pos_embed"].dtype == jnp.float32
