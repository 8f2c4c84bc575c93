"""MLCD tower (2D RoPE ViT) parity vs the reference torch implementation
(llava/model/multimodal_encoder/mlcd/vit_rope2d_hf.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from lavida_mod.config import SigLIPConfig
from lavida_mod.models import mlcd


def tiny_cfg():
    return SigLIPConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, image_size=28, patch_size=14,
        layer_norm_eps=1e-5, hidden_act="quick_gelu", drop_last_layer=False,
    )


@pytest.fixture(scope="module")
def torch_mlcd(reference_llava):
    import sys

    sys.path.insert(0, str(reference_llava / "llava" / "model"
                           / "multimodal_encoder"))
    from mlcd.vit_rope2d_hf import MLCDVisionConfig, MLCDVisionModel

    cfg = MLCDVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, image_size=28, patch_size=14,
        layer_norm_eps=1e-5, hidden_act="quick_gelu",
    )
    import torch

    torch.manual_seed(0)
    model = MLCDVisionModel(cfg).eval().float()
    return model


def test_rope_phase_table_matches_torch(torch_mlcd):
    import torch

    cfg = tiny_cfg()
    vt = torch_mlcd.vision_model
    grid = torch.tensor([[1, 2, 2]])  # (t, h, w)
    ref = vt.rot_pos_emb(grid).numpy()
    ours = mlcd.rope_phase_table(cfg, 2, 2)
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def test_mlcd_feature_parity(torch_mlcd):
    import torch

    cfg = tiny_cfg()
    state = {k: v.numpy() for k, v in torch_mlcd.state_dict().items()}
    params = mlcd.convert_mlcd_state_dict(state, cfg, jnp.float32)

    rng = np.random.default_rng(0)
    pix = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    with torch.no_grad():
        out = torch_mlcd(torch.from_numpy(pix), output_hidden_states=True)
    for select_layer in (-2, -1):
        ref = out.hidden_states[select_layer][:, 1:].numpy()
        ours = np.asarray(
            mlcd.forward(params, cfg, jnp.asarray(pix),
                         select_layer=select_layer)
        )
        np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-3)
    # cls_patch keeps the CLS row
    ref = out.hidden_states[-2].numpy()
    ours = np.asarray(
        mlcd.forward(params, cfg, jnp.asarray(pix),
                     select_layer=-2, select_feature="cls_patch")
    )
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-3)


def test_mlcd_random_init_runs():
    import jax

    cfg = tiny_cfg()
    params = mlcd.init_params(cfg, jax.random.PRNGKey(0))
    out = mlcd.forward(params, cfg, jnp.zeros((1, 3, 28, 28)))
    assert out.shape == (1, 4, 32)


def test_tower_builder_dispatch(tmp_path):
    import json

    from lavida_mod.models.tower_builder import build_vision_tower

    cfg, fwd = build_vision_tower("mlcd-vit-large-patch14-336")
    assert cfg.hidden_size == 1024 and fwd.__module__.endswith("mlcd")

    # hf: checkpoint-dir dispatch on config.json model_type
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "model_type": "clip_vision_model", "hidden_size": 64,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 128, "image_size": 28, "patch_size": 14,
    }))
    cfg, fwd = build_vision_tower(f"hf:{d}")
    assert cfg.hidden_size == 64 and fwd.__module__.endswith("clip")

    # eva is implemented as of round 3 (models/eva_clip.py)
    ecfg, efwd = build_vision_tower("eva_clip_g")
    assert efwd.__module__.endswith("eva_clip")
