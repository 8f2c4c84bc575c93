"""open_clip / ImageBind tower parity vs a torch oracle.

The oracle reproduces open_clip's documented visual forward exactly as the
reference runs it (open_clip_encoder.py:80-103: conv1 -> class+pos embed ->
ln_pre -> resblocks, collecting every layer), with resblocks built from
torch primitives using open_clip's parameter naming (ln_1 / attn
nn.MultiheadAttention / ln_2 / mlp.c_fc+c_proj, quick-gelu).  The imagebind
oracle is the same trunk without ln_pre under imagebind's names
(imagebind.py:41-57 takes the final layer and drops CLS)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lavida_mod.models import open_clip as oc  # noqa: E402


class _QuickGELU(torch.nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class _ResBlock(torch.nn.Module):
    def __init__(self, d, heads, mlp, act):
        super().__init__()
        self.ln_1 = torch.nn.LayerNorm(d, eps=1e-5)
        self.attn = torch.nn.MultiheadAttention(d, heads, batch_first=False)
        self.ln_2 = torch.nn.LayerNorm(d, eps=1e-5)
        self.mlp = torch.nn.Sequential()
        self.mlp.add_module("c_fc", torch.nn.Linear(d, mlp))
        self.mlp.add_module("gelu", act())
        self.mlp.add_module("c_proj", torch.nn.Linear(mlp, d))

    def forward(self, x):
        # LND layout like open_clip (open_clip_encoder.py:97-101)
        a, _ = self.attn(self.ln_1(x), self.ln_1(x), self.ln_1(x),
                         need_weights=False, attn_mask=None)
        x = x + a
        return x + self.mlp(self.ln_2(x))


def _build_oracle(d=32, heads=4, mlp=64, layers=3, patch=4, img=16,
                  act=_QuickGELU, seed=0):
    torch.manual_seed(seed)
    vt = torch.nn.Module()
    vt.conv1 = torch.nn.Conv2d(3, d, patch, stride=patch, bias=False)
    n_tok = (img // patch) ** 2 + 1
    vt.class_embedding = torch.nn.Parameter(torch.randn(d) * 0.02)
    vt.positional_embedding = torch.nn.Parameter(
        torch.randn(n_tok, d) * 0.02)
    vt.ln_pre = torch.nn.LayerNorm(d, eps=1e-5)
    vt.transformer = torch.nn.Module()
    vt.transformer.resblocks = torch.nn.ModuleList(
        [_ResBlock(d, heads, mlp, act) for _ in range(layers)])
    return vt


def _oracle_forward(vt, x, use_ln_pre=True):
    feats = []
    h = vt.conv1(x)
    h = h.reshape(h.shape[0], h.shape[1], -1).permute(0, 2, 1)
    cls = vt.class_embedding[None, None].expand(h.shape[0], 1, -1)
    h = torch.cat([cls, h], dim=1) + vt.positional_embedding
    if use_ln_pre:
        h = vt.ln_pre(h)
    h = h.permute(1, 0, 2)  # NLD -> LND
    for r in vt.transformer.resblocks:
        h = r(h)
        feats.append(h.permute(1, 0, 2))
    return feats


def _cfg(layers=3):
    return oc.open_clip_vit_h14_378_config(
        hidden_size=32, intermediate_size=64, num_hidden_layers=layers,
        num_attention_heads=4, image_size=16, patch_size=4)


def test_open_clip_parity_select_layer():
    vt = _build_oracle()
    cfg = _cfg()
    sd = {k: v.detach().numpy() for k, v in vt.state_dict().items()}
    params = oc.convert_open_clip_visual(sd, cfg, dtype=jnp.float32)

    x = torch.randn(2, 3, 16, 16)
    feats = _oracle_forward(vt, x)

    for sel in (-1, -2):
        ours = oc.forward(params, cfg, jnp.asarray(x.numpy()),
                          select_layer=sel, select_feature="patch")
        ref = feats[sel][:, 1:].detach().numpy()
        np.testing.assert_allclose(np.asarray(ours), ref,
                                   rtol=2e-4, atol=2e-4)
    # cls_patch keeps CLS (open_clip_encoder.py feature_select)
    ours = oc.forward(params, cfg, jnp.asarray(x.numpy()),
                      select_layer=-1, select_feature="cls_patch")
    assert ours.shape == (2, 17, 32)


def test_imagebind_parity_final_layer():
    vt = _build_oracle(act=torch.nn.GELU, seed=1)
    cfg = oc.imagebind_huge_vision_config(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, image_size=16, patch_size=4,
        layer_norm_eps=1e-5)

    # repackage the oracle weights under imagebind's names
    sd = {}
    osd = {k: v.detach().numpy() for k, v in vt.state_dict().items()}
    sd["modality_preprocessors.vision.rgbt_stem.proj.weight"] = \
        osd["conv1.weight"][:, :, None]  # Conv3d [D, C, 1, p, p]
    sd["modality_preprocessors.vision.cls_token"] = \
        osd["class_embedding"].reshape(1, 1, -1)
    sd["modality_preprocessors.vision.pos_embedding_helper.pos_embed"] = \
        osd["positional_embedding"][None]
    for i in range(3):
        for a, b in (("norm_1", "ln_1"), ("norm_2", "ln_2")):
            for p in ("weight", "bias"):
                sd[f"modality_trunks.vision.blocks.{i}.{a}.{p}"] = \
                    osd[f"transformer.resblocks.{i}.{b}.{p}"]
        for a, b in (("attn.in_proj_weight", "attn.in_proj_weight"),
                     ("attn.in_proj_bias", "attn.in_proj_bias"),
                     ("attn.out_proj.weight", "attn.out_proj.weight"),
                     ("attn.out_proj.bias", "attn.out_proj.bias"),
                     ("mlp.fc1.weight", "mlp.c_fc.weight"),
                     ("mlp.fc1.bias", "mlp.c_fc.bias"),
                     ("mlp.fc2.weight", "mlp.c_proj.weight"),
                     ("mlp.fc2.bias", "mlp.c_proj.bias")):
            sd[f"modality_trunks.vision.blocks.{i}.{a}"] = \
                osd[f"transformer.resblocks.{i}.{b}"]

    params = oc.convert_imagebind_vision(sd, cfg, dtype=jnp.float32)
    assert params["pre_ln"] is None

    x = torch.randn(2, 3, 16, 16)
    feats = _oracle_forward(vt, x, use_ln_pre=False)
    ours = oc.imagebind_forward(params, cfg, jnp.asarray(x.numpy()))
    # imagebind keeps patch tokens of the FINAL trunk layer
    np.testing.assert_allclose(np.asarray(ours),
                               feats[-1][:, 1:].detach().numpy(),
                               rtol=2e-4, atol=2e-4)
    assert ours.shape == (2, 16, 32)


def test_tower_builder_dispatch():
    from lavida_mod.models.tower_builder import build_vision_tower

    cfg, fwd = build_vision_tower("open_clip_hub:ViT-H-14-378-quickgelu")
    assert cfg.hidden_size == 1280 and cfg.image_size == 378
    assert fwd is oc.forward

    cfg, fwd = build_vision_tower("imagebind_huge")
    assert cfg.image_size == 224 and fwd is oc.imagebind_forward

    # eva dispatches to the round-3 tower (models/eva_clip.py)
    ecfg, efwd = build_vision_tower("eva_clip_g")
    assert ecfg.width == 4096 and efwd.__module__.endswith("eva_clip")
