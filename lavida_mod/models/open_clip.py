"""open_clip and ImageBind vision towers.

The reference dispatches both live from its tower builder
(multimodal_encoder/builder.py:36-46):

* open_clip (open_clip_encoder.py:1-163): wraps
  ``open_clip.create_model_and_transforms`` and forwards the *visual*
  trunk manually — conv1 patchify, class embedding, positional embedding,
  ln_pre, then the resblock stack, collecting every layer's hidden state
  and selecting ``select_layer`` / dropping CLS for "patch" features
  (open_clip_encoder.py:63-103).  The only registered geometry is
  ViT-H-14-378-quickgelu (HIDDEN_SIZE_DICT, open_clip_encoder.py:14-16).

* ImageBind (imagebind.py:1-73): wraps ``imagebind_model.imagebind_huge``
  and keeps the 257-token vision trunk output minus CLS
  (imagebind.py:41-57; the audio path needs torchaudio and is out of
  scope for the vision tower contract).

Both trunks are pre-norm CLIP-style ViTs, so the forward IS
``models/clip.py::forward`` (patchify-as-GEMM, scanned layers, fused
attention); what this module adds is the two geometries and the
weight-name converters from each ecosystem's checkpoint layout:

* open_clip visual: ``conv1.weight``, ``class_embedding``,
  ``positional_embedding``, ``ln_pre``, ``transformer.resblocks.N.
  {ln_1,attn.in_proj_weight/in_proj_bias/out_proj,ln_2,mlp.c_fc/c_proj}``
  — attention ships as ONE fused in_proj [3D, D] (torch
  nn.MultiheadAttention) that splits into q/k/v here.

* imagebind vision: ``modality_preprocessors.vision.cls_token`` /
  ``pos_embedding_helper.pos_embed`` / ``rgbt_stem.proj`` (a Conv3d with
  a leading time dim of 1) and ``modality_trunks.vision.blocks.N.
  {norm_1,attn.in_proj_weight/out_proj,norm_2,mlp.fc1/fc2}``; there is
  no ln_pre (identity here).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np

from ..config import SigLIPConfig
from . import clip

Params = Any

forward = clip.forward  # the trunk math is identical (see module doc)


def open_clip_vit_h14_378_config(**kw) -> SigLIPConfig:
    """ViT-H-14-378-quickgelu — the one geometry the reference registers
    (open_clip_encoder.py:14-16; 378px, patch 14 -> 27x27 grid)."""
    base = dict(
        hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
        num_attention_heads=16, image_size=378, patch_size=14,
        layer_norm_eps=1e-5, hidden_act="quick_gelu",
        image_mean=(0.48145466, 0.4578275, 0.40821073),
        image_std=(0.26862954, 0.26130258, 0.27577711),
        drop_last_layer=False,
    )
    base.update(kw)
    return SigLIPConfig(**base)


def imagebind_huge_vision_config(**kw) -> SigLIPConfig:
    """imagebind_huge vision trunk (224px ViT-H/14 -> 256 patches + CLS;
    gelu MLPs, no pre-layernorm)."""
    base = dict(
        hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
        num_attention_heads=16, image_size=224, patch_size=14,
        layer_norm_eps=1e-6, hidden_act="gelu",
        image_mean=(0.48145466, 0.4578275, 0.40821073),
        image_std=(0.26862954, 0.26130258, 0.27577711),
        drop_last_layer=False,
    )
    base.update(kw)
    return SigLIPConfig(**base)


def _split_in_proj(w: np.ndarray, b: np.ndarray, D: int):
    """torch MultiheadAttention fused in_proj [3D, D] -> (q, k, v) each as
    {kernel [D, D], bias [D]} in our x@W convention."""
    out = []
    for i in range(3):
        out.append({
            "kernel": w[i * D:(i + 1) * D].T,
            "bias": b[i * D:(i + 1) * D],
        })
    return out


def _stack_layers(rows: list[dict], dtype) -> dict:
    keys = rows[0].keys()
    return {k: jnp.asarray(np.stack([r[k] for r in rows]), dtype)
            for k in keys}


def convert_open_clip_visual(
    state: dict[str, np.ndarray], cfg: SigLIPConfig, dtype=jnp.bfloat16,
    prefix: str = "",
) -> Params:
    """open_clip ``model.visual`` state dict -> clip.forward params."""
    def get(name):
        for cand in (prefix + name, "visual." + name, name):
            if cand in state:
                return np.asarray(state[cand], np.float32)
        raise KeyError(f"missing open_clip weight: {prefix + name}")

    D, L = cfg.hidden_size, cfg.num_hidden_layers
    conv_w = get("conv1.weight")  # [D, C, p, p], no bias in CLIP ViTs

    per_layer = {"ln1": [], "ln2": [], "q_proj": [], "k_proj": [],
                 "v_proj": [], "out_proj": [], "fc1": [], "fc2": []}
    for i in range(L):
        lt = f"transformer.resblocks.{i}."
        q, k, v = _split_in_proj(get(lt + "attn.in_proj_weight"),
                                 get(lt + "attn.in_proj_bias"), D)
        per_layer["q_proj"].append(q)
        per_layer["k_proj"].append(k)
        per_layer["v_proj"].append(v)
        per_layer["out_proj"].append({
            "kernel": get(lt + "attn.out_proj.weight").T,
            "bias": get(lt + "attn.out_proj.bias")})
        per_layer["fc1"].append({"kernel": get(lt + "mlp.c_fc.weight").T,
                                 "bias": get(lt + "mlp.c_fc.bias")})
        per_layer["fc2"].append({"kernel": get(lt + "mlp.c_proj.weight").T,
                                 "bias": get(lt + "mlp.c_proj.bias")})
        per_layer["ln1"].append({"weight": get(lt + "ln_1.weight"),
                                 "bias": get(lt + "ln_1.bias")})
        per_layer["ln2"].append({"weight": get(lt + "ln_2.weight"),
                                 "bias": get(lt + "ln_2.bias")})

    return {
        "class_embed": jnp.asarray(get("class_embedding"), dtype),
        "patch_embed": {
            "kernel": jnp.asarray(conv_w.reshape(D, -1).T, dtype)},
        "pos_embed": jnp.asarray(get("positional_embedding"), dtype),
        "pre_ln": {"weight": jnp.asarray(get("ln_pre.weight"), dtype),
                   "bias": jnp.asarray(get("ln_pre.bias"), dtype)},
        "layers": {k: _stack_layers(v, dtype)
                   for k, v in per_layer.items()},
    }


def convert_imagebind_vision(
    state: dict[str, np.ndarray], cfg: SigLIPConfig, dtype=jnp.bfloat16,
) -> Params:
    """imagebind_huge vision preprocessor + trunk -> clip.forward params.
    The rgbt stem is a Conv3d [D, C, 1, p, p] (shared RGB/thermal stem);
    the vision path uses the single time slice."""
    def get(name):
        if name in state:
            return np.asarray(state[name], np.float32)
        raise KeyError(f"missing imagebind weight: {name}")

    D, L = cfg.hidden_size, cfg.num_hidden_layers
    conv_w = get("modality_preprocessors.vision.rgbt_stem.proj.weight")
    if conv_w.ndim == 5:  # [D, C, T=1, p, p] -> [D, C, p, p]
        conv_w = conv_w[:, :, 0]

    per_layer = {"ln1": [], "ln2": [], "q_proj": [], "k_proj": [],
                 "v_proj": [], "out_proj": [], "fc1": [], "fc2": []}
    for i in range(L):
        lt = f"modality_trunks.vision.blocks.{i}."
        q, k, v = _split_in_proj(get(lt + "attn.in_proj_weight"),
                                 get(lt + "attn.in_proj_bias"), D)
        per_layer["q_proj"].append(q)
        per_layer["k_proj"].append(k)
        per_layer["v_proj"].append(v)
        per_layer["out_proj"].append({
            "kernel": get(lt + "attn.out_proj.weight").T,
            "bias": get(lt + "attn.out_proj.bias")})
        per_layer["fc1"].append({"kernel": get(lt + "mlp.fc1.weight").T,
                                 "bias": get(lt + "mlp.fc1.bias")})
        per_layer["fc2"].append({"kernel": get(lt + "mlp.fc2.weight").T,
                                 "bias": get(lt + "mlp.fc2.bias")})
        per_layer["ln1"].append({"weight": get(lt + "norm_1.weight"),
                                 "bias": get(lt + "norm_1.bias")})
        per_layer["ln2"].append({"weight": get(lt + "norm_2.weight"),
                                 "bias": get(lt + "norm_2.bias")})

    pos = get("modality_preprocessors.vision."
              "pos_embedding_helper.pos_embed")
    if pos.ndim == 3:  # stored [1, T, D]
        pos = pos[0]
    cls = get("modality_preprocessors.vision.cls_token").reshape(D)

    return {
        "class_embed": jnp.asarray(cls, dtype),
        "patch_embed": {
            "kernel": jnp.asarray(conv_w.reshape(D, -1).T, dtype)},
        "pos_embed": jnp.asarray(pos, dtype),
        # no ln_pre in the imagebind trunk -> identity layernorm params
        # are NOT equivalent; bypass by scale-1/shift-0 *affine* only is
        # wrong too (LN still normalizes), so forward uses pre_ln=None.
        "pre_ln": None,
        "layers": {k: _stack_layers(v, dtype)
                   for k, v in per_layer.items()},
    }


def imagebind_forward(params: Params, cfg: SigLIPConfig,
                      pixel_values, **kw) -> Any:
    """Vision trunk features, CLS dropped (imagebind.py:53-57 keeps the
    256 patch tokens).  ImageBind has no ln_pre, and the reference takes
    the FINAL trunk layer (select_layer -1), not -2."""
    kw.setdefault("select_layer", -1)
    kw.setdefault("select_feature", "patch")
    return clip.forward(params, cfg, pixel_values, **kw)
