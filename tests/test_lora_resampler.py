"""LoRA + resampler tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.config import (
    LaViDaConfig, VisionConfig, tiny_llada_config, tiny_siglip_config,
)
from lavida_mod.models import llada as jl
from lavida_mod.models import multimodal as mm
from lavida_mod.models import resampler as R
from lavida_mod.train.lora import (
    SHIRG_LORA_TARGETS, add_lora, load_lora_state, make_lora_optimizer,
    merge_lora, split_lora_state,
)


@pytest.fixture()
def tiny():
    cfg = LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32),
    )
    params = mm.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


def test_lora_identity_at_init(tiny):
    cfg, params = tiny
    ids = jnp.asarray(np.arange(5, 15)[None])
    base, _ = jl.forward(params["llada"], cfg.llada,
                         jl.embed_tokens(params["llada"], ids))
    lp = add_lora(params, jax.random.PRNGKey(1), rank=4,
                  target_re=r"(q_proj|ff_out)")
    out, _ = jl.forward(lp["llada"], cfg.llada,
                        jl.embed_tokens(lp["llada"], ids))
    np.testing.assert_allclose(np.asarray(out), np.asarray(base), atol=1e-6)


def test_lora_changes_output_when_b_nonzero_and_merge_matches(tiny):
    cfg, params = tiny
    ids = jnp.asarray(np.arange(5, 15)[None])
    lp = add_lora(params, jax.random.PRNGKey(1), rank=4,
                  target_re=r"q_proj")
    # perturb b
    for _, p in [(k, v) for k, v in _linears(lp)]:
        if "lora_b" in p:
            p["lora_b"] = p["lora_b"] + 0.01
    out_lora, _ = jl.forward(lp["llada"], cfg.llada,
                             jl.embed_tokens(lp["llada"], ids))
    base, _ = jl.forward(params["llada"], cfg.llada,
                         jl.embed_tokens(params["llada"], ids))
    assert np.abs(np.asarray(out_lora) - np.asarray(base)).max() > 1e-5

    merged = merge_lora(lp)
    out_merged, _ = jl.forward(merged["llada"], cfg.llada,
                               jl.embed_tokens(merged["llada"], ids))
    np.testing.assert_allclose(np.asarray(out_merged), np.asarray(out_lora),
                               atol=2e-5)


def _linears(tree):
    from lavida_mod.train.lora import _iter_linears

    return list(_iter_linears(tree))


def test_lora_split_and_load_roundtrip(tiny):
    _, params = tiny
    lp = add_lora(params, jax.random.PRNGKey(2), rank=2,
                  target_re=SHIRG_LORA_TARGETS)
    state = split_lora_state(lp)
    assert len(state) > 0
    lp2 = load_lora_state(params, state)
    for path, factors in state.items():
        got = dict(_linears(lp2))[path]
        np.testing.assert_array_equal(
            np.asarray(got["lora_a"]), np.asarray(factors["lora_a"])
        )


def test_lora_optimizer_trains_only_lora(tiny):
    cfg, params = tiny
    lp = add_lora(params, jax.random.PRNGKey(3), rank=2, target_re=r"q_proj")
    opt = make_lora_optimizer(lr=1e-2)
    opt_state = opt.init(lp)

    ids = jnp.asarray(np.arange(5, 15)[None])
    labels = jnp.asarray(np.arange(5, 15)[None])

    def loss_fn(p):
        logits, _ = jl.forward(p["llada"], cfg.llada,
                               jl.embed_tokens(p["llada"], ids))
        lg = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.take_along_axis(lg, labels[..., None], -1).mean()

    grads = jax.grad(loss_fn)(lp)
    updates, _ = opt.update(grads, opt_state, lp)
    new = jax.tree.map(lambda a, u: a + u, lp, updates)
    lin0 = dict(_linears(new))["llada/blocks/q_proj"]
    old0 = dict(_linears(lp))["llada/blocks/q_proj"]
    assert np.abs(np.asarray(lin0["lora_b"]) - np.asarray(old0["lora_b"])).max() > 0
    np.testing.assert_array_equal(
        np.asarray(lin0["kernel"]), np.asarray(old0["kernel"])
    )
    np.testing.assert_array_equal(
        np.asarray(new["llada"]["wte"]), np.asarray(lp["llada"]["wte"])
    )


# ---------------------------------------------------------------------------
# resamplers
# ---------------------------------------------------------------------------

def test_masked_drop_modes():
    f = jnp.asarray(np.random.default_rng(0).standard_normal((2, 16, 8)))
    out = R.masked_drop(f, jax.random.PRNGKey(0), mode="fixed", ratio=0.5)
    assert out.shape == (2, 8, 8)
    assert R.masked_drop(f, jax.random.PRNGKey(0), training=False).shape == f.shape
    assert R.masked_drop(f, jax.random.PRNGKey(0), mode="cls_only").shape == (2, 1, 8)


def test_spatial_pool_resampler():
    f = jnp.asarray(np.random.default_rng(0).standard_normal((2, 16, 8)))
    assert R.spatial_pool(f, "average", 2).shape == (2, 4, 8)
    assert R.spatial_pool(f, "max", 2).shape == (2, 4, 8)


def test_perceiver_and_qformer():
    f = jnp.asarray(
        np.random.default_rng(1).standard_normal((2, 36, 32)).astype(np.float32)
    )
    p = R.init_perceiver(32, jax.random.PRNGKey(0), depth=2, dim_head=8,
                         heads=4, num_latents=8, ff_mult=2)
    out = R.perceiver_resample(p, f)
    assert out.shape == (2, 8, 32)
    assert bool(jnp.isfinite(out).all())

    qp, qfn = R.build_resampler(
        "qformer", dim=32, key=jax.random.PRNGKey(1), depth=1,
        num_latents=4, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
    )
    assert qfn(qp, f).shape == (2, 4, 32)


def test_build_resampler_registry():
    f = jnp.ones((1, 16, 32))
    for name in (None, "identity", "spatial_pool", "masked_drop"):
        params, fn = R.build_resampler(name, 32, jax.random.PRNGKey(0))
        out = fn(params, f, key=jax.random.PRNGKey(1), training=True)
        assert out.shape[-1] == 32
    params, fn = R.build_resampler("perceiver", 32, jax.random.PRNGKey(0),
                                   depth=1, dim_head=8, heads=4,
                                   num_latents=4, ff_mult=2)
    assert fn(params, f).shape == (1, 4, 32)
