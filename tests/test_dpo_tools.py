"""DPO loss, in-training eval hook, and weight-tool tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.config import tiny_llada_config
from lavida_mod.models import llada as jl
from lavida_mod.tools.weights import apply_delta, make_delta
from lavida_mod.train.dpo import dpo_loss, make_dpo_train_step


@pytest.fixture()
def tiny():
    cfg = tiny_llada_config()
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


def _pair_batch(cfg, params, seed=0):
    rng = np.random.default_rng(seed)
    B, L = 2, 16
    ids_c = rng.integers(3, 400, size=(B, L))
    ids_r = rng.integers(3, 400, size=(B, L))
    labels = np.full((B, L), -100, np.int64)
    labels[:, 8:] = 1
    lab_c = np.where(labels != -100, ids_c, -100)
    lab_r = np.where(labels != -100, ids_r, -100)
    return {
        "chosen_embeds": jl.embed_tokens(params, jnp.asarray(ids_c)),
        "chosen_labels": jnp.asarray(lab_c),
        "rejected_embeds": jl.embed_tokens(params, jnp.asarray(ids_r)),
        "rejected_labels": jnp.asarray(lab_r),
    }


def test_dpo_loss_at_init_is_log2(tiny):
    """policy == reference -> logits 0 -> loss = -log sigmoid(0) = log 2."""
    cfg, params = tiny
    b = _pair_batch(cfg, params)
    loss, metrics = dpo_loss(
        params, params, cfg, b["chosen_embeds"], b["chosen_labels"],
        b["rejected_embeds"], b["rejected_labels"], jax.random.PRNGKey(0),
        remat=False,
    )
    np.testing.assert_allclose(float(loss), np.log(2.0), atol=1e-5)
    np.testing.assert_allclose(float(metrics["reward_margin"]), 0.0, atol=1e-5)


def test_dpo_training_increases_margin(tiny):
    import optax

    cfg, params = tiny
    ref = jax.tree.map(lambda x: x, params)
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)
    step = jax.jit(make_dpo_train_step(cfg, opt, ref, remat=False))
    b = _pair_batch(cfg, params)
    margins = []
    for i in range(6):
        params, opt_state, metrics = step(
            params, opt_state, b, jax.random.PRNGKey(42)
        )
        margins.append(float(metrics["reward_margin"]))
    assert margins[-1] > margins[0], margins
    assert np.isfinite(margins).all()


def test_eval_hook_runs(tiny):
    from lavida_mod.config import (
        LaViDaConfig, VisionConfig, tiny_siglip_config,
    )
    from lavida_mod.eval.tasks import Task, register
    from lavida_mod.train.eval_hook import run_in_training_eval

    cfg = LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32),
    )
    from lavida_mod.models import multimodal as mm

    params = mm.init_params(cfg, jax.random.PRNGKey(0))

    docs = [{"id": i, "text": f"q{i}", "target": "a", "images": []}
            for i in range(2)]
    register(Task(
        name="_hook_probe",
        generation_kwargs={"max_new_tokens": 8},
        score_doc=lambda doc, pred: {"acc": 0.0},
        aggregate=lambda rows: {"acc": 0.0},
    ))
    # monkeypatch load_docs to return synthetic docs
    from lavida_mod.eval import tasks as T

    T.get_task("_hook_probe").load_docs = lambda *a, **k: docs

    class FakeTok:
        bos_token_id = 1
        chat_template = None

        def __call__(self, text):
            class R:
                input_ids = [1] + [10 + (ord(c) % 50) for c in text[:8]]

            return R()

        def decode(self, ids, skip_special_tokens=True):
            return "x"

    flat = run_in_training_eval(cfg, params, FakeTok(), ["_hook_probe"])
    assert "eval/_hook_probe/acc" in flat
    assert "eval/_hook_probe/avg_latency_s" in flat


def test_weight_delta_roundtrip():
    rng = np.random.default_rng(0)
    base = {"a": rng.standard_normal((4, 4)).astype(np.float32),
            "emb": rng.standard_normal((10, 4)).astype(np.float32)}
    target = {"a": rng.standard_normal((4, 4)).astype(np.float32),
              "emb": rng.standard_normal((12, 4)).astype(np.float32),  # grown vocab
              "new": np.ones((2, 2), np.float32)}
    delta = make_delta(base, target)
    back = apply_delta(base, delta)
    for k in target:
        np.testing.assert_allclose(back[k], target[k], atol=1e-6)
