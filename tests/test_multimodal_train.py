"""Gather-plan splicing equivalence + end-to-end multimodal train step."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.config import (
    LaViDaConfig, VisionConfig, tiny_llada_config, tiny_siglip_config,
)
from lavida_mod.models import multimodal as mm
from lavida_mod.train.step import (
    jit_train_step, make_freeze_optimizer, make_multimodal_train_step,
)


@pytest.fixture()
def setup():
    # function-scoped: the jitted train step donates params/opt_state
    cfg = LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(
            siglip=tiny_siglip_config(), mm_hidden_size=32,
            grid_pinpoints=((56, 112), (112, 56), (112, 112)),
        ),
    )
    params = mm.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


def _mk_batch(cfg, with_labels=True):
    rng = np.random.default_rng(0)
    sizes = [(100, 60), (60, 100)]
    n_views = []
    pix = []
    from lavida_mod.data.anyres import anyres_grid_shape

    for s in sizes:
        nw, nh = anyres_grid_shape(s, cfg.vision.grid_pinpoints, 56)
        v = 1 + nw * nh
        n_views.append(v)
        pix.append(rng.standard_normal((v, 3, 56, 56)).astype(np.float32))
    ids = [
        np.array([5, 6, -200, 7, 8, 9, 10]),
        np.array([11, -200, 12, 13]),
    ]
    labels = [
        np.array([-100, -100, -100, 7, 8, 9, 10]),
        np.array([-100, -100, 12, 13]),
    ] if with_labels else None
    return ids, [[v] for v in n_views], [[s] for s in sizes], pix, labels


def test_gather_plan_matches_eager_splice(setup):
    """multimodal_embeds (one fused gather) must reproduce the eager
    per-sample encode_image + splice_embeddings path exactly."""
    cfg, params = setup
    ids, n_views, sizes, pix, labels = _mk_batch(cfg)

    gather_idx, text_ids, valid, labs = mm.build_gather_plan(
        cfg, ids, n_views, sizes, labels
    )
    pixel_values = jnp.asarray(np.concatenate(pix, axis=0))
    fused = mm.multimodal_embeds(
        params, cfg, pixel_values, jnp.asarray(text_ids),
        jnp.asarray(gather_idx),
    )

    eager, valid2, labs2, lens = mm.prepare_multimodal_batch(
        cfg=cfg, params=params,
        batch_input_ids=ids,
        batch_images=[[jnp.asarray(p)] for p in pix],
        batch_image_sizes=sizes,
        batch_labels=labels,
    )
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(valid2))
    np.testing.assert_array_equal(labs, labs2)
    np.testing.assert_allclose(
        np.asarray(fused), np.asarray(eager), atol=1e-5
    )
    # padding rows gather zeros
    assert np.abs(np.asarray(fused)[1, lens[1]:]).max() == 0.0


def test_multimodal_train_step_projector_only(setup):
    """Stage-1 semantics: only projector (+newline) updates; tower and LM
    frozen via the optimizer."""
    cfg, params = setup
    ids, n_views, sizes, pix, labels = _mk_batch(cfg)
    gather_idx, text_ids, valid, labs = mm.build_gather_plan(
        cfg, ids, n_views, sizes, labels
    )
    batch = {
        "pixel_values": jnp.asarray(np.concatenate(pix, axis=0)),
        "text_ids": jnp.asarray(text_ids),
        "gather_idx": jnp.asarray(gather_idx),
        "labels": jnp.asarray(labs),
    }
    opt = make_freeze_optimizer("mm_mlp_adapter", lr=1e-2, total_steps=10)
    opt_state = opt.init(params)
    step = jit_train_step(
        make_multimodal_train_step(cfg, opt, prefix_lm=True, remat=False)
    )
    p0 = jax.tree.map(lambda a: np.asarray(a).copy(), params)
    params2, opt_state, metrics = step(
        params, opt_state, batch, jax.random.PRNGKey(0)
    )
    assert np.isfinite(float(metrics["loss"]))

    def changed(a, b):
        return not np.allclose(np.asarray(a), b, atol=0)

    assert changed(params2["projector"]["layers"][0]["kernel"],
                   p0["projector"]["layers"][0]["kernel"])
    assert not changed(params2["siglip"]["pos_embed"], p0["siglip"]["pos_embed"])
    assert not changed(params2["llada"]["wte"], p0["llada"]["wte"])


def test_multimodal_train_step_full(setup):
    """Stage-2 semantics: everything trains, loss decreases over steps."""
    cfg, params = setup
    ids, n_views, sizes, pix, labels = _mk_batch(cfg)
    gather_idx, text_ids, valid, labs = mm.build_gather_plan(
        cfg, ids, n_views, sizes, labels
    )
    batch = {
        "pixel_values": jnp.asarray(np.concatenate(pix, axis=0)),
        "text_ids": jnp.asarray(text_ids),
        "gather_idx": jnp.asarray(gather_idx),
        "labels": jnp.asarray(labs),
    }
    opt = make_freeze_optimizer(
        "mm_mlp_adapter,mm_vision_tower,mm_language_model",
        lr=5e-3, vision_tower_lr=1e-3, total_steps=20,
    )
    opt_state = opt.init(params)
    step = jit_train_step(
        make_multimodal_train_step(cfg, opt, prefix_lm=True, remat=True)
    )
    losses = []
    for i in range(4):
        params, opt_state, metrics = step(
            params, opt_state, batch, jax.random.PRNGKey(i)
        )
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(l) for l in losses)
    assert losses[-1] < losses[0], losses


def test_multi_image_gather_plan(setup):
    """Two images in one sample: both -200 markers spliced in order."""
    cfg, params = setup
    from lavida_mod.data.anyres import anyres_grid_shape

    rng = np.random.default_rng(2)
    sizes = [(100, 60), (56, 56)]
    n_views, pix = [], []
    for s in sizes:
        nw, nh = anyres_grid_shape(s, cfg.vision.grid_pinpoints, 56)
        v = 1 + nw * nh
        n_views.append(v)
        pix.append(rng.standard_normal((v, 3, 56, 56)).astype(np.float32))
    ids = [np.array([5, -200, 6, 7, -200, 8])]
    gather_idx, text_ids, valid, labs = mm.build_gather_plan(
        cfg, ids, [n_views], [sizes], [np.full(6, -100, np.int64)]
    )
    fused = mm.multimodal_embeds(
        params, cfg, jnp.asarray(np.concatenate(pix, axis=0)),
        jnp.asarray(text_ids), jnp.asarray(gather_idx),
    )
    eager, valid2, _, lens = mm.prepare_multimodal_batch(
        cfg=cfg, params=params, batch_input_ids=ids,
        batch_images=[[jnp.asarray(p) for p in pix]],
        batch_image_sizes=[sizes],
        batch_labels=[np.full(6, -100, np.int64)],
    )
    np.testing.assert_allclose(
        np.asarray(fused), np.asarray(eager), atol=1e-5
    )
