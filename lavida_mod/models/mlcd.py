"""MLCD vision tower: CLIP-style ViT with 2D rotary position embeddings.

Parity target: reference llava/model/multimodal_encoder/mlcd_encoder.py
(:1-179) + mlcd/vit_rope2d_hf.py (:1-451).  Structure is the CLIP ViT
(CLS token, pre-layernorm, LN1/attn/LN2/MLP residual blocks) with the
absolute position table replaced by rotary embeddings on q/k:

  - per-patch 2D positions (row, col) index a shared frequency table of
    dim head_dim/4 per axis; the (h-freqs | w-freqs) concat gives the
    head_dim/2 rotary phase per token (vit_rope2d_hf.py:290-307);
  - the CLS token carries a LEARNED phase vector (`class_pos_emb`,
    vit_rope2d_hf.py:286, 310-313);
  - rotation is half-split (rotate_half) with the phase duplicated across
    both halves (vit_rope2d_hf.py:19-29).

The rope table depends only on the (static) patch grid, so it is
precomputed host-side per forward shape — nothing dynamic inside jit.
Feature selection matches mlcd_encoder.py:51-71 ("patch" drops CLS,
select_layer counts hidden_states like HF).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..config import SigLIPConfig
from ..ops.attention import attention
from ..ops.norms import layer_norm
from .siglip import patchify

Params = dict


def mlcd_vit_l_config(**kw) -> SigLIPConfig:
    """DeepGlint-AI/mlcd-vit-large-patch14-336 geometry."""
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
    from .clip import init_params as clip_init

    p = clip_init(cfg, key, dtype)
    del p["pos_embed"]  # RoPE instead of the absolute table
    d4 = cfg.head_dim // 4
    p["class_pos_emb"] = (
        jax.random.normal(jax.random.PRNGKey(7), (1, 2 * d4)) * 0.02
    ).astype(dtype)
    return p


def rope_phase_table(cfg: SigLIPConfig, grid_h: int, grid_w: int,
                     theta: float = 10000.0) -> np.ndarray:
    """Host-side [grid_h*grid_w, head_dim/2] phase table: (h|w) frequency
    halves per patch (vit_rope2d_hf.py:31-41, 290-307)."""
    d4 = cfg.head_dim // 4
    inv_freq = 1.0 / (theta ** (np.arange(0, d4, dtype=np.float64) * 2 / (2 * d4)))
    rows = np.repeat(np.arange(grid_h), grid_w).astype(np.float64)
    cols = np.tile(np.arange(grid_w), grid_h).astype(np.float64)
    return np.concatenate(
        [rows[:, None] * inv_freq[None], cols[:, None] * inv_freq[None]],
        axis=1,
    ).astype(np.float32)


def _apply_rope(x: jax.Array, phase: jax.Array) -> jax.Array:
    """x: [N, T, H, hd]; phase: [T, hd/2] f32.  Half-split rotation with
    the phase duplicated over both halves (vit_rope2d_hf.py:19-29)."""
    xf = x.astype(jnp.float32)
    cos = jnp.cos(phase)[None, :, None, :]
    sin = jnp.sin(phase)[None, :, None, :]
    cos = jnp.concatenate([cos, cos], axis=-1)
    sin = jnp.concatenate([sin, sin], axis=-1)
    half = x.shape[-1] // 2
    rot = jnp.concatenate([-xf[..., half:], xf[..., :half]], axis=-1)
    return (xf * cos + rot * sin).astype(x.dtype)


def forward(
    params: Params,
    cfg: SigLIPConfig,
    pixel_values: jax.Array,
    *,
    select_layer: int = -2,
    select_feature: str = "patch",
) -> jax.Array:
    """[N, C, H, W] -> hidden_states[select_layer] features."""
    N, _, H, W = pixel_values.shape
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    # pixels -> tower dtype (llava_arch.py:700 images.to(dtype))
    x = patchify(pixel_values, cfg.patch_size).astype(
        params["patch_embed"]["kernel"].dtype)
    x = x @ params["patch_embed"]["kernel"]
    cls = jnp.broadcast_to(
        params["class_embed"][None, None], (N, 1, cfg.hidden_size)
    ).astype(x.dtype)
    x = jnp.concatenate([cls, x], axis=1)
    x = layer_norm(x, params["pre_ln"]["weight"], params["pre_ln"]["bias"],
                   cfg.layer_norm_eps)

    patch_phase = jnp.asarray(rope_phase_table(cfg, gh, gw))
    phase = jnp.concatenate(
        [params["class_pos_emb"].astype(jnp.float32), patch_phase], axis=0
    )

    L = cfg.num_hidden_layers
    n_run = L + select_layer + 1 if select_layer < 0 else select_layer
    eps = cfg.layer_norm_eps
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    from .clip import _quick_gelu

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
        q = _apply_rope(q, phase)
        k = _apply_rope(k, phase)
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


def convert_mlcd_state_dict(
    state: dict[str, np.ndarray], cfg: SigLIPConfig, dtype=jnp.bfloat16,
    prefix: str = "vision_model.",
) -> Params:
    """HF MLCDVisionModel state dict -> our params (same layer naming as
    CLIP plus class_pos_emb; no position_embedding)."""
    from .clip import convert_clip_state_dict

    # reuse the CLIP converter by faking the missing pos table, then swap
    pos_key = prefix + "embeddings.position_embedding.weight"
    state = dict(state)
    state.setdefault(
        pos_key, np.zeros((cfg.num_patches + 1, cfg.hidden_size), np.float32)
    )
    p = convert_clip_state_dict(state, cfg, dtype, prefix)
    del p["pos_embed"]
    for cand in (prefix + "class_pos_emb", "class_pos_emb"):
        if cand in state:
            p["class_pos_emb"] = jnp.asarray(state[cand], dtype)
            break
    else:
        raise KeyError("missing mlcd weight: class_pos_emb")
    return p
