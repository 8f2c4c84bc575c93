"""CLIP tower parity vs HF transformers CLIPVisionModel + S2 shapes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from lavida_mod.models import clip as jc
from lavida_mod.models.clip import clip_vit_l_config, convert_clip_state_dict
from lavida_mod.models.tower_builder import build_vision_tower


@pytest.fixture(scope="module")
def ref_clip():
    from transformers import CLIPVisionConfig, CLIPVisionModel

    cfg = CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, image_size=56, patch_size=14,
        hidden_act="quick_gelu",
    )
    torch.manual_seed(0)
    m = CLIPVisionModel(cfg)
    m.eval()
    return m


def test_clip_parity_layer_minus2(ref_clip):
    cfg = clip_vit_l_config(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, image_size=56, patch_size=14,
    )
    state = {k: v.detach().numpy() for k, v in ref_clip.state_dict().items()}
    params = convert_clip_state_dict(state, cfg, dtype=jnp.float32)

    rng = np.random.default_rng(0)
    pix = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    with torch.no_grad():
        out = ref_clip(torch.from_numpy(pix), output_hidden_states=True)
        ref = out.hidden_states[-2][:, 1:].numpy()  # select_layer=-2, patch

    ours = jc.forward(params, cfg, jnp.asarray(pix), select_layer=-2,
                      select_feature="patch")
    np.testing.assert_allclose(np.asarray(ours), ref, atol=3e-4, rtol=1e-3)

    # cls_patch keeps the CLS slot
    full = jc.forward(params, cfg, jnp.asarray(pix), select_layer=-2,
                      select_feature="cls_patch")
    assert full.shape[1] == ours.shape[1] + 1


def test_s2_multiscale_shapes(ref_clip):
    cfg = clip_vit_l_config(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, image_size=56, patch_size=14,
    )
    state = {k: v.detach().numpy() for k, v in ref_clip.state_dict().items()}
    params = convert_clip_state_dict(state, cfg, dtype=jnp.float32)
    pix = jnp.asarray(
        np.random.default_rng(1).standard_normal((1, 3, 112, 112))
        .astype(np.float32)
    )
    out = jc.s2_forward(params, cfg, pix, scales=(56, 112))
    # base grid 4x4=16 tokens, channels doubled
    assert out.shape == (1, 16, 64)
    assert bool(jnp.isfinite(out).all())


def test_tower_builder_dispatch():
    cfg, fn = build_vision_tower("siglip-so400m")
    assert cfg.hidden_size == 1152
    cfg, fn = build_vision_tower("openai/clip-vit-large-patch14-336")
    assert cfg.hidden_size == 1024
    # eva is a real tower as of round 3 (models/eva_clip.py)
    ecfg, efwd = build_vision_tower("eva_clip_g")
    assert efwd.__module__.endswith("eva_clip")
    with pytest.raises(ValueError):
        build_vision_tower("resnet50")
