"""CLIP vision tower (+ S2 multi-scale).

Capability parity with reference llava/model/multimodal_encoder/
clip_encoder.py (which wraps HF CLIPVisionModel): CLIP ViT-L-style encoder
with CLS token, pre-layernorm, quick-GELU MLPs, layer/feature selection
("patch" drops the CLS, "cls_patch" keeps it, select_layer=-2 default), and
the S2 multi-scale wrapper (s2wrapper semantics: run the backbone at each
scale — larger scales processed as a chessboard of base-size crops — and
concatenate features channel-wise, interpolated to the base grid).

Built on the same scanned-layer machinery as SigLIP; HF weight converter
included.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SigLIPConfig
from ..ops.attention import attention
from ..ops.norms import layer_norm
from ..ops.pooling import _bilinear_no_antialias
from .siglip import patchify

Params = dict


def clip_vit_l_config(**kw) -> SigLIPConfig:
    """openai/clip-vit-large-patch14-336 geometry (the LLaVA default)."""
    base = dict(
        hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
        num_attention_heads=16, image_size=336, patch_size=14,
        layer_norm_eps=1e-5, hidden_act="quick_gelu",
        image_mean=(0.48145466, 0.4578275, 0.40821073),
        image_std=(0.26862954, 0.26130258, 0.27577711),
        drop_last_layer=False,
    )
    base.update(kw)
    return SigLIPConfig(**base)


def init_params(cfg: SigLIPConfig, key: jax.Array, dtype=jnp.float32) -> Params:
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    P, C = cfg.patch_size, cfg.num_channels
    keys = iter(jax.random.split(key, 12))

    def dense(k, shape, std=0.02):
        return (jax.random.normal(k, shape) * std).astype(dtype)

    def lin(k, i, o, L=None):
        w = (L, i, o) if L else (i, o)
        b = (L, o) if L else (o,)
        return {"kernel": dense(k, w), "bias": jnp.zeros(b, dtype)}

    def ln(shape):
        return {"weight": jnp.ones(shape, dtype), "bias": jnp.zeros(shape, dtype)}

    return {
        "class_embed": dense(next(keys), (D,)),
        "patch_embed": {"kernel": dense(next(keys), (P * P * C, D))},
        "pos_embed": dense(next(keys), (cfg.num_patches + 1, D)),
        "pre_ln": ln((D,)),
        "layers": {
            "ln1": ln((L, D)), "ln2": ln((L, D)),
            "q_proj": lin(next(keys), D, D, L),
            "k_proj": lin(next(keys), D, D, L),
            "v_proj": lin(next(keys), D, D, L),
            "out_proj": lin(next(keys), D, D, L),
            "fc1": lin(next(keys), D, I, L),
            "fc2": lin(next(keys), I, D, L),
        },
    }


def _quick_gelu(x):
    return x * jax.nn.sigmoid(1.702 * x)


def forward(
    params: Params,
    cfg: SigLIPConfig,
    pixel_values: jax.Array,
    *,
    select_layer: int = -2,
    select_feature: str = "patch",
) -> jax.Array:
    """[N, C, H, W] -> features at hidden_states[select_layer]; "patch"
    drops CLS (clip_encoder.py:47-74)."""
    N = pixel_values.shape[0]
    # cast pixels to the tower dtype (llava_arch.py:700 images.to(dtype));
    # f32 processor output x bf16 weights would promote the whole tower
    # forward to f32
    x = patchify(pixel_values, cfg.patch_size).astype(
        params["patch_embed"]["kernel"].dtype)
    x = x @ params["patch_embed"]["kernel"]  # CLIP patch conv has no bias
    cls = jnp.broadcast_to(
        params["class_embed"][None, None], (N, 1, cfg.hidden_size)
    ).astype(x.dtype)
    x = jnp.concatenate([cls, x], axis=1)
    x = x + params["pos_embed"][None]
    if params.get("pre_ln") is not None:  # imagebind's trunk has no ln_pre
        x = layer_norm(x, params["pre_ln"]["weight"],
                       params["pre_ln"]["bias"], cfg.layer_norm_eps)

    L = cfg.num_hidden_layers
    n_run = L + select_layer + 1 if select_layer < 0 else select_layer
    eps = cfg.layer_norm_eps
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    act = _quick_gelu if cfg.hidden_act == "quick_gelu" else (
        lambda z: jax.nn.gelu(z, approximate=True)
    )

    layers = jax.tree.map(lambda a: a[:n_run], params["layers"])

    def layer_fn(h, p_l):
        r = h
        z = layer_norm(h, p_l["ln1"]["weight"], p_l["ln1"]["bias"], eps)
        T = z.shape[1]
        q = (z @ p_l["q_proj"]["kernel"] + p_l["q_proj"]["bias"]).reshape(N, T, nh, hd)
        k = (z @ p_l["k_proj"]["kernel"] + p_l["k_proj"]["bias"]).reshape(N, T, nh, hd)
        v = (z @ p_l["v_proj"]["kernel"] + p_l["v_proj"]["bias"]).reshape(N, T, nh, hd)
        att = attention(q, k, v).reshape(N, T, -1)
        h = r + (att @ p_l["out_proj"]["kernel"] + p_l["out_proj"]["bias"])
        r = h
        z = layer_norm(h, p_l["ln2"]["weight"], p_l["ln2"]["bias"], eps)
        z = act(z @ p_l["fc1"]["kernel"] + p_l["fc1"]["bias"])
        return r + (z @ p_l["fc2"]["kernel"] + p_l["fc2"]["bias"]), None

    x, _ = jax.lax.scan(layer_fn, x, layers)
    if select_feature == "patch":
        return x[:, 1:]
    if select_feature == "cls_patch":
        return x
    raise ValueError(select_feature)


# ---------------------------------------------------------------------------
# S2 multi-scale (s2wrapper semantics)
# ---------------------------------------------------------------------------

def s2_forward(
    params: Params,
    cfg: SigLIPConfig,
    pixel_values: jax.Array,           # [N, C, S_max, S_max]
    scales: Sequence[int] = (336, 672, 1008),
    **kw,
) -> jax.Array:
    """Run the tower at each scale (larger scales split into a chessboard of
    base-size crops), interpolate every scale's grid back to the base grid,
    concat channel-wise -> [N, base_tokens, D * len(scales)]."""
    base = min(scales)
    g_base = base // cfg.patch_size
    N, C = pixel_values.shape[:2]
    outs = []
    for s in scales:
        k = s // base
        img = _resize_images(pixel_values, s)
        if k == 1:
            feats = forward(params, cfg, img, **kw)
        else:
            # chessboard split into k*k crops of the base size
            crops = img.reshape(N, C, k, base, k, base)
            crops = crops.transpose(0, 2, 4, 1, 3, 5).reshape(
                N * k * k, C, base, base
            )
            f = forward(params, cfg, crops, **kw)           # [N k k, g g, D]
            D = f.shape[-1]
            f = f.reshape(N, k, k, g_base, g_base, D)
            f = f.transpose(0, 1, 3, 2, 4, 5).reshape(
                N, k * g_base, k * g_base, D
            )
            f = _bilinear_no_antialias(f, g_base)           # back to base grid
            feats = f.reshape(N, g_base * g_base, D)
        outs.append(feats)
    return jnp.concatenate(outs, axis=-1)


def _resize_images(x: jax.Array, size: int) -> jax.Array:
    N, C, H, W = x.shape
    if H == size:
        return x
    grid = x.transpose(0, 2, 3, 1)
    grid = jax.image.resize(grid, (N, size, size, C), method="bilinear")
    return grid.transpose(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# HF weight conversion (CLIPVisionModel naming)
# ---------------------------------------------------------------------------

def convert_clip_state_dict(
    state: dict[str, np.ndarray], cfg: SigLIPConfig, dtype=jnp.bfloat16,
    prefix: str = "vision_model.",
) -> Params:
    def get(name):
        for cand in (prefix + name, name):
            if cand in state:
                return np.asarray(state[cand])
        raise KeyError(f"missing clip weight: {prefix + name}")

    L = cfg.num_hidden_layers
    D = cfg.hidden_size
    conv_w = get("embeddings.patch_embedding.weight")

    def stack(tmpl, transpose=False, bias=True):
        ws = [get(tmpl.format(i) + ".weight") for i in range(L)]
        ws = [w.T if transpose else w for w in ws]
        out = {"kernel" if transpose else "weight":
               jnp.asarray(np.stack(ws), dtype)}
        if bias:
            bs = [get(tmpl.format(i) + ".bias") for i in range(L)]
            out["bias"] = jnp.asarray(np.stack(bs), dtype)
        return out

    lt = "encoder.layers.{}."
    return {
        "class_embed": jnp.asarray(get("embeddings.class_embedding"), dtype),
        "patch_embed": {
            "kernel": jnp.asarray(conv_w.reshape(D, -1).T, dtype)
        },
        "pos_embed": jnp.asarray(
            get("embeddings.position_embedding.weight"), dtype
        ),
        "pre_ln": {
            "weight": jnp.asarray(get("pre_layrnorm.weight"), dtype),
            "bias": jnp.asarray(get("pre_layrnorm.bias"), dtype),
        },
        "layers": {
            "ln1": stack(lt + "layer_norm1"),
            "ln2": stack(lt + "layer_norm2"),
            "q_proj": stack(lt + "self_attn.q_proj", transpose=True),
            "k_proj": stack(lt + "self_attn.k_proj", transpose=True),
            "v_proj": stack(lt + "self_attn.v_proj", transpose=True),
            "out_proj": stack(lt + "self_attn.out_proj", transpose=True),
            "fc1": stack(lt + "mlp.fc1", transpose=True),
            "fc2": stack(lt + "mlp.fc2", transpose=True),
        },
    }
