"""EVA-CLIP tower parity vs the reference torch EVAVisionTransformer
(eva_clip/eva_vit.py) on tiny configs covering both block variants:
plain fused-qkv + Mlp (the EVA-CLIP-8B geometry) and the EVA02-style
subln + naiveswiglu + 2D-rope variant."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from lavida_mod.models import eva_clip as E


def _stub_timm():
    """eva_vit.py imports timm.models.layers helpers; timm isn't in the
    image.  Stub the three symbols (drop_path is never called at
    drop_path_rate=0; the other two are trivial)."""
    import sys
    import types

    if "timm.models.layers" in sys.modules:
        return
    timm = types.ModuleType("timm")
    models = types.ModuleType("timm.models")
    layers = types.ModuleType("timm.models.layers")
    layers.drop_path = lambda x, *a, **k: x
    layers.to_2tuple = lambda v: v if isinstance(v, tuple) else (v, v)
    layers.trunc_normal_ = torch.nn.init.trunc_normal_
    timm.models = models
    models.layers = layers
    sys.modules["timm"] = timm
    sys.modules["timm.models"] = models
    sys.modules["timm.models.layers"] = layers


def _torch_eva(reference_llava, cfg, rope):
    _stub_timm()
    from llava.model.multimodal_encoder.eva_clip.eva_vit import (
        EVAVisionTransformer,
    )

    torch.manual_seed(0)
    model = EVAVisionTransformer(
        img_size=cfg.image_size, patch_size=cfg.patch_size,
        num_classes=64, embed_dim=cfg.width, depth=cfg.layers,
        num_heads=cfg.n_heads, mlp_ratio=cfg.mlp_ratio,
        qkv_bias=cfg.qkv_bias, norm_layer=lambda d: torch.nn.LayerNorm(
            d, eps=cfg.layer_norm_eps),
        init_values=cfg.ls_init_value, rope=rope,
        use_mean_pooling=False, xattn=False, postnorm=cfg.postnorm,
        pt_hw_seq_len=cfg.pt_hw_seq_len, intp_freq=False,
        naiveswiglu=cfg.naiveswiglu, subln=cfg.subln,
    )
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    model.eval()
    return model


def _compare(reference_llava, cfg, rope=False):
    model = _torch_eva(reference_llava, cfg, rope)
    state = {k: v.detach().float().numpy() for k, v in
             model.state_dict().items()}
    params = E.convert_eva_state_dict(state, cfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    pix = rng.standard_normal(
        (2, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    with torch.no_grad():
        # EVAEncoderWrapper contract: return_all_features + drop CLS
        ref = model.forward_features(
            torch.from_numpy(pix), return_all_features=True)[:, 1:, :]
    ours = E.forward(params, cfg, jnp.asarray(pix))
    np.testing.assert_allclose(np.asarray(ours), ref.numpy(),
                               atol=2e-4, rtol=1e-3)


def test_eva_plain_qkv_mlp(reference_llava):
    """EVA-CLIP-8B style: fused qkv (no bias), GELU Mlp, pre-norm."""
    _compare(reference_llava, E.tiny_eva_config(qkv_bias=False))


def test_eva_qkv_bias(reference_llava):
    _compare(reference_llava, E.tiny_eva_config(qkv_bias=True))


def test_eva02_subln_swiglu_rope(reference_llava):
    """EVA02 style: subln separate q/k/v + inner LN, naive SwiGLU with
    ffn_ln, 2D rotary on patch tokens."""
    # pt_hw_seq_len must equal the tiny grid: the torch ctor builds the
    # rope tables at pt_hw_seq_len when intp_freq=False (eva_vit.py:560)
    cfg = E.tiny_eva_config(subln=True, naiveswiglu=True, qkv_bias=True,
                            rope=True, pt_hw_seq_len=4)
    _compare(reference_llava, cfg, rope=True)


def test_eva_postnorm_layerscale(reference_llava):
    cfg = E.tiny_eva_config(postnorm=True, ls_init_value=0.1)
    _compare(reference_llava, cfg)


def test_tower_builder_dispatch():
    from lavida_mod.models.tower_builder import build_vision_tower

    cfg, fwd = build_vision_tower("eva-clip-8b",
                                  cfg=E.tiny_eva_config())
    params = E.init_params(cfg, jax.random.PRNGKey(0))
    out = fwd(params, cfg, jnp.zeros((1, 3, 56, 56)))
    assert out.shape == (1, cfg.grid * cfg.grid, cfg.width)
