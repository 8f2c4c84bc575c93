"""Vision-tower registry (reference multimodal_encoder/builder.py:13-52).

Name-based dispatch, mirroring the reference's live branches:
  - "siglip" — LaViDa's tower, including the `use_original_encoder` flag
    (in this rebuild the same implementation: the fork's
    original_siglip_encoder.py differs from siglip_encoder.py only by
    SHIRG plumbing);
  - "mlcd"   — CLIP-style ViT with 2D rotary position embeddings
    (mlcd_encoder.py + mlcd/vit_rope2d_hf.py), torch-parity tested;
  - "clip"   — HF CLIPVisionModel equivalent, plus the "s2" multi-scale
    wrapper (clip_encoder.py + s2wrapper semantics);
  - "hf:..." — generic HF vision checkpoint (hf_vision.py): dispatches on
    the checkpoint's config.json model_type to the matching
    implementation above (see hf_vision_tower).

  - "open_clip" — ViT-H-14-378-quickgelu visual trunk with the fused
    in_proj converter (open_clip_encoder.py:1-163);
  - "imagebind" — imagebind_huge vision trunk, CLS dropped
    (imagebind.py:1-73).

  - "eva" — EVA-CLIP ViT (eva_clip/eva_vit.py; the reference's builder
    comments EVA out at builder.py:21-24, but ships 13 model configs —
    rebuilt with the EVA-CLIP-8B geometry as the default, torch-parity
    tested in tests/test_eva_clip.py).
"""

from __future__ import annotations

import json
import os
from typing import Callable

from ..config import SigLIPConfig


def build_vision_tower(name: str, **kw) -> tuple[object, Callable]:
    """Returns (cfg, forward_fn(params, cfg, pixel_values, **kw))."""
    lname = name.lower()
    if lname.startswith("hf:") or lname.startswith("hf-"):
        return hf_vision_tower(name[3:], **kw)
    if "siglip" in lname:
        from . import siglip

        cfg = kw.pop("cfg", None) or SigLIPConfig()
        return cfg, siglip.forward
    if "mlcd" in lname:
        from . import mlcd

        cfg = kw.pop("cfg", None) or mlcd.mlcd_vit_l_config()
        return cfg, mlcd.forward
    if "open_clip" in lname:
        from . import open_clip

        cfg = kw.pop("cfg", None) or open_clip.open_clip_vit_h14_378_config()
        return cfg, open_clip.forward
    if "imagebind" in lname:
        from . import open_clip

        cfg = kw.pop("cfg", None) or open_clip.imagebind_huge_vision_config()
        return cfg, open_clip.imagebind_forward
    if "eva" in lname:
        from . import eva_clip

        cfg = kw.pop("cfg", None) or eva_clip.eva_clip_8b_config()
        return cfg, eva_clip.forward
    if "clip" in lname:
        from . import clip

        cfg = kw.pop("cfg", None) or clip.clip_vit_l_config()
        if kw.pop("s2", False) or "s2" in lname:
            return cfg, clip.s2_forward
        return cfg, clip.forward
    raise ValueError(f"Unknown vision tower: {name}")


_HF_MODEL_TYPES = {
    "clip_vision_model": "clip",
    "clip": "clip",
    "siglip_vision_model": "siglip",
    "siglip": "siglip",
    "mlcd_vision_model": "mlcd",
}


def hf_vision_tower(path_or_type: str, **kw) -> tuple[object, Callable]:
    """Generic HF-checkpoint tower (reference hf_vision.py:1-111): read the
    checkpoint's config.json, map model_type onto a supported family, and
    build a geometry-matching config.  The torch reference wraps an
    arbitrary AutoModel; this counterpart supports the families
    this framework implements and fails loudly otherwise."""
    model_type = path_or_type
    hf_cfg: dict = {}
    if os.path.isdir(path_or_type):
        with open(os.path.join(path_or_type, "config.json")) as f:
            hf_cfg = json.load(f)
        if "vision_config" in hf_cfg:
            hf_cfg = hf_cfg["vision_config"]
        model_type = hf_cfg.get("model_type", "")
    family = _HF_MODEL_TYPES.get(model_type)
    if family is None:
        raise NotImplementedError(
            f"hf vision tower model_type {model_type!r} not supported "
            f"(supported: {sorted(set(_HF_MODEL_TYPES))})"
        )
    geo = {
        k: hf_cfg[k]
        for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                  "num_attention_heads", "image_size", "patch_size",
                  "layer_norm_eps", "hidden_act")
        if k in hf_cfg
    }
    if family == "siglip":
        from . import siglip  # noqa: F401

        return SigLIPConfig(**geo), __import__(
            "lavida_mod.models.siglip", fromlist=["forward"]
        ).forward
    if family == "mlcd":
        from . import mlcd

        return mlcd.mlcd_vit_l_config(**geo), mlcd.forward
    from . import clip

    return clip.clip_vit_l_config(**geo), clip.forward
