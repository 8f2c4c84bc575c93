"""SHIRG Extra-LoRA end-to-end harness smoke (tiny config): the LoRA
footprint matches shirg_lora_config.py, only LoRA factors move, and the
train loop learns + saves an adapter checkpoint."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lavida_mod.config import (LaViDaConfig, VisionConfig,
                               tiny_llada_config, tiny_siglip_config)
from lavida_mod.models import multimodal as mm
from lavida_mod.train.lora import (add_shirg_lora, make_lora_optimizer,
                                   make_shirg_lora_train_step,
                                   split_lora_state)


def _tiny():
    return LaViDaConfig(
        llada=tiny_llada_config(),
        vision=VisionConfig(siglip=tiny_siglip_config(),
                            mm_hidden_size=32),
    )


def test_shirg_lora_footprint():
    cfg = _tiny()
    params = mm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    params = add_shirg_lora(params, jax.random.PRNGKey(1), rank=4,
                            alpha=8.0)
    sl = params["siglip"]["layers"]
    # per-layer gating: q/k live on blocks 0-5, v on 0-3 (tiny has 3
    # layers, so all-q/k + all-v here; the masks clamp at L)
    L = sl["q_proj"]["lora_scale"].shape[0]
    assert np.all(np.asarray(sl["q_proj"]["lora_scale"])[: min(L, 6)] > 0)
    assert np.all(np.asarray(sl["v_proj"]["lora_scale"])[: min(L, 4)] > 0)
    # projector has factors; the LLaDA LM does NOT (SHIRG trains the
    # vision side only, shirg_lora_config.py target_modules)
    assert "lora_a" in params["projector"]["layers"][0]
    assert "lora_a" not in params["llada"]["blocks"]["q_proj"]
    # out_proj / fc1 / fc2 untouched
    assert "lora_a" not in sl["out_proj"]


def test_shirg_lora_step_moves_only_lora():
    cfg = _tiny()
    params = mm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    params = add_shirg_lora(params, jax.random.PRNGKey(1), rank=4,
                            alpha=8.0)
    opt = make_lora_optimizer(lr=1e-2, warmup_steps=0, total_steps=10)
    opt_state = opt.init(params)
    step = jax.jit(make_shirg_lora_train_step(cfg, opt))

    S = cfg.vision.siglip.image_size
    B, Ttxt = 2, 12
    rng = np.random.default_rng(0)
    pix = rng.standard_normal((B, 2, 3, S, S)).astype(np.float32)
    text = rng.integers(3, 400, size=(B, Ttxt)).astype(np.int32)
    n_img = jax.eval_shape(
        lambda p, v: __import__(
            "lavida_mod.models.shirg", fromlist=["shirg_encode"]
        ).shirg_encode(p, cfg, v),
        params, jax.ShapeDtypeStruct((2, 3, S, S), jnp.float32)).shape[0]
    labels = np.concatenate(
        [np.full((B, n_img), -100), text.astype(np.int64)], axis=1)
    batch = {"pixel_values": jnp.asarray(pix),
             "text_ids": jnp.asarray(text),
             "labels": jnp.asarray(labels)}

    before = jax.tree.map(np.asarray, params)
    losses = []
    p, st = params, opt_state
    for i in range(4):
        p, st, metrics = step(p, st, batch, jax.random.PRNGKey(42))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses

    moved = unmoved_base = 0
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(before),
            jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, p))):
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        changed = not np.array_equal(a, b)
        if "lora_a" in names or "lora_b" in names:
            moved += int(changed)
        else:
            assert not changed, f"frozen leaf moved: {names}"
            unmoved_base += 1
    assert moved > 0 and unmoved_base > 0


def test_shirg_lora_harness_cli(tmp_path):
    """The script end-to-end: 4 steps on synthetic data, adapter saved."""
    from PIL import Image

    rng = np.random.default_rng(0)
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    Image.fromarray(
        (rng.random((90, 120, 3)) * 255).astype("uint8")).save(
        img_dir / "a.png")
    data = [{"image": "a.png", "conversations": [
        {"from": "human", "value": "<image>\nDescribe."},
        {"from": "gpt", "value": "A colorful test pattern."}]}
        for _ in range(4)]
    dp = tmp_path / "d.json"
    with open(dp, "w") as f:
        json.dump(data, f)

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "scripts/train_shirg_lora.py", "--tiny",
         "--data-path", str(dp), "--image-folder", str(img_dir),
         "--output-dir", str(tmp_path / "out"), "--steps", "4",
         "--batch-size", "2", "--warmup-steps", "0", "--save-every", "4"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=420, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "saved adapters" in out.stdout
    assert "[shirg-lora] done" in out.stdout
