"""EVA-CLIP vision tower (the last reference tower family without a
rebuild — eva_clip/eva_vit.py:501-856, builder commented out at
builder.py:21-24 but shipped with 13 model configs).

Functional JAX re-expression of EVAVisionTransformer's inference path:

  - conv patch embed as a GEMM over patchified pixels (same trick as
    siglip.py), CLS token prepended, learned absolute pos embed;
  - blocks: fused qkv (optional q/v bias, eva_vit.py:260-266 — K has NO
    bias) or subln-style separate q/k/v; pre- or post-norm residuals
    with optional layer-scale gammas (:428-446);
  - optional 2D interleaved rotary embedding on patch tokens, CLS row
    skipped (:330-339, VisionRotaryEmbeddingFast with the broadcat
    height/width frequency layout :37-86);
  - FFN: timm Mlp (GELU) or "naiveswiglu" (silu(w1) * w2 -> optional
    subln ffn_ln -> w3, :217-240);
  - inference output = return_all_features=True semantics: the LAST
    block is SKIPPED inside the loop (:747-749), no final norm, and the
    wrapper drops the CLS row (:846-848).

Dropout / drop-path / patch-dropout are train-time-only in the
reference and omitted (inference tower).  Parity vs the torch
EVAVisionTransformer on tiny configs: tests/test_eva_clip.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.attention import attention


@dataclasses.dataclass(frozen=True)
class EVAConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 4096
    layers: int = 32
    head_width: int = 128
    mlp_ratio: float = 5.0
    qkv_bias: bool = False
    subln: bool = False
    naiveswiglu: bool = False
    rope: bool = False
    postnorm: bool = False
    ls_init_value: Optional[float] = None
    layer_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    pt_hw_seq_len: int = 16

    @property
    def n_heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)


# EVA-CLIP-8B.json (the flagship config shipped with the reference)
def eva_clip_8b_config() -> EVAConfig:
    return EVAConfig(image_size=224, patch_size=14, width=4096, layers=32,
                     head_width=128, mlp_ratio=5.0, qkv_bias=False)


def tiny_eva_config(**kw) -> EVAConfig:
    base = dict(image_size=56, patch_size=14, width=64, layers=3,
                head_width=16, mlp_ratio=2.0, qkv_bias=True)
    base.update(kw)
    return EVAConfig(**base)


# ---------------------------------------------------------------------------
# 2D vision rope (VisionRotaryEmbeddingFast, eva_vit.py:37-86): per-axis
# frequencies over half the head dim, broadcast-concatenated over the
# (h, w) grid, INTERLEAVED rotate_half (pairs (-x2, x1), :30-35).
# ---------------------------------------------------------------------------

def _vision_rope_tables(cfg: EVAConfig) -> tuple[np.ndarray, np.ndarray]:
    dim = cfg.head_width // 2          # per-axis rope dim
    ft = cfg.grid
    freqs = 1.0 / (cfg.rope_theta ** (
        np.arange(0, dim, 2)[: dim // 2] / dim))
    t = np.arange(ft) / ft * cfg.pt_hw_seq_len
    f = np.einsum("i,j->ij", t, freqs)                     # [ft, dim/2]
    f = np.repeat(f, 2, axis=-1)                           # [ft, dim]
    # broadcat over (h, w): rows get the h-frequencies in the first half
    # and the w-frequencies in the second
    fh = np.broadcast_to(f[:, None, :], (ft, ft, dim))
    fw = np.broadcast_to(f[None, :, :], (ft, ft, dim))
    full = np.concatenate([fh, fw], axis=-1).reshape(ft * ft, dim * 2)
    return np.cos(full), np.sin(full)


def _rotate_half_interleaved(x: jax.Array) -> jax.Array:
    x2 = x.reshape(x.shape[:-1] + (-1, 2))
    rot = jnp.stack([-x2[..., 1], x2[..., 0]], axis=-1)
    return rot.reshape(x.shape)


def _apply_vision_rope(x: jax.Array, cos: jax.Array, sin: jax.Array):
    """x: [B, H, N, hd] patch rows only."""
    return x * cos + _rotate_half_interleaved(x) * sin


# ---------------------------------------------------------------------------
# init / forward
# ---------------------------------------------------------------------------

def init_params(cfg: EVAConfig, key: jax.Array, dtype=jnp.float32) -> dict:
    D, H = cfg.width, cfg.mlp_hidden
    n_tok = cfg.grid * cfg.grid + 1
    ks = iter(jax.random.split(key, 8 + cfg.layers))

    def dense(k, shape, std=0.02):
        return jax.random.normal(k, shape, dtype) * std

    def layer(k):
        kk = iter(jax.random.split(k, 12))
        p = {
            "norm1": {"weight": jnp.ones((D,), dtype),
                      "bias": jnp.zeros((D,), dtype)},
            "norm2": {"weight": jnp.ones((D,), dtype),
                      "bias": jnp.zeros((D,), dtype)},
            "proj": {"kernel": dense(next(kk), (D, D)),
                     "bias": jnp.zeros((D,), dtype)},
        }
        if cfg.subln:
            p["q_proj"] = {"kernel": dense(next(kk), (D, D))}
            p["k_proj"] = {"kernel": dense(next(kk), (D, D))}
            p["v_proj"] = {"kernel": dense(next(kk), (D, D))}
            p["inner_ln"] = {"weight": jnp.ones((D,), dtype),
                             "bias": jnp.zeros((D,), dtype)}
        else:
            p["qkv"] = {"kernel": dense(next(kk), (D, 3 * D))}
        if cfg.qkv_bias:
            p["q_bias"] = jnp.zeros((D,), dtype)
            p["v_bias"] = jnp.zeros((D,), dtype)
        if cfg.naiveswiglu:
            p["w1"] = {"kernel": dense(next(kk), (D, H)),
                       "bias": jnp.zeros((H,), dtype)}
            p["w2"] = {"kernel": dense(next(kk), (D, H)),
                       "bias": jnp.zeros((H,), dtype)}
            p["w3"] = {"kernel": dense(next(kk), (H, D)),
                       "bias": jnp.zeros((D,), dtype)}
            if cfg.subln:
                p["ffn_ln"] = {"weight": jnp.ones((H,), dtype),
                               "bias": jnp.zeros((H,), dtype)}
        else:
            p["fc1"] = {"kernel": dense(next(kk), (D, H)),
                        "bias": jnp.zeros((H,), dtype)}
            p["fc2"] = {"kernel": dense(next(kk), (H, D)),
                        "bias": jnp.zeros((D,), dtype)}
        if cfg.ls_init_value:
            p["gamma_1"] = jnp.full((D,), cfg.ls_init_value, dtype)
            p["gamma_2"] = jnp.full((D,), cfg.ls_init_value, dtype)
        return p

    return {
        "patch_embed": {
            "kernel": dense(next(ks), (3 * cfg.patch_size ** 2, D)),
            "bias": jnp.zeros((D,), dtype),
        },
        "cls_token": dense(next(ks), (D,)),
        "pos_embed": dense(next(ks), (n_tok, D)),
        "layers": [layer(next(ks)) for _ in range(cfg.layers)],
    }


def _ln(x, p, eps):
    xf = x.astype(jnp.float32)
    mu = xf.mean(-1, keepdims=True)
    var = ((xf - mu) ** 2).mean(-1, keepdims=True)
    y = (xf - mu) * jax.lax.rsqrt(var + eps)
    return (y * p["weight"].astype(jnp.float32)
            + p["bias"].astype(jnp.float32)).astype(x.dtype)


def _patchify(pix: jax.Array, p: int) -> jax.Array:
    N, C, Hh, W = pix.shape
    gh, gw = Hh // p, W // p
    x = pix.reshape(N, C, gh, p, gw, p)
    x = x.transpose(0, 2, 4, 1, 3, 5)          # [N, gh, gw, C, p, p]
    return x.reshape(N, gh * gw, C * p * p)


def forward(params: dict, cfg: EVAConfig, pixel_values: jax.Array,
            *, n_layers: Optional[int] = None) -> jax.Array:
    """[N, C, S, S] -> [N, grid*grid, width] — the EVAEncoderWrapper
    contract (return_all_features, last block skipped, CLS dropped,
    eva_vit.py:747-749 + :846-848)."""
    eps = cfg.layer_norm_eps
    nh, hd = cfg.n_heads, cfg.head_width
    # pixels -> tower dtype (llava_arch.py:700 images.to(dtype))
    x = _patchify(pixel_values, cfg.patch_size).astype(
        params["patch_embed"]["kernel"].dtype)
    x = x @ params["patch_embed"]["kernel"] + params["patch_embed"]["bias"]
    N, n_patch, D = x.shape
    cls = jnp.broadcast_to(params["cls_token"][None, None, :], (N, 1, D))
    x = jnp.concatenate([cls.astype(x.dtype), x], axis=1)
    x = x + params["pos_embed"][None].astype(x.dtype)
    T = x.shape[1]

    rope_cos = rope_sin = None
    if cfg.rope:
        c, s = _vision_rope_tables(cfg)
        rope_cos = jnp.asarray(c, x.dtype)[None, None]
        rope_sin = jnp.asarray(s, x.dtype)[None, None]

    # return_all_features skips the LAST block (eva_vit.py:747-749)
    n_run = (cfg.layers - 1) if n_layers is None else n_layers
    for p in params["layers"][:n_run]:
        r = x
        h = x if cfg.postnorm else _ln(x, p["norm1"], eps)
        if cfg.subln:
            q = h @ p["q_proj"]["kernel"]
            k = h @ p["k_proj"]["kernel"]
            v = h @ p["v_proj"]["kernel"]
        else:
            qkv = h @ p["qkv"]["kernel"]
            q, k, v = jnp.split(qkv, 3, axis=-1)
        if cfg.qkv_bias:
            q = q + p["q_bias"]
            v = v + p["v_bias"]
        q = q.reshape(N, T, nh, hd)
        k = k.reshape(N, T, nh, hd)
        v = v.reshape(N, T, nh, hd)
        if cfg.rope:
            qh = q.transpose(0, 2, 1, 3)
            kh = k.transpose(0, 2, 1, 3)
            q = jnp.concatenate(
                [qh[:, :, :1], _apply_vision_rope(qh[:, :, 1:], rope_cos,
                                                  rope_sin)], axis=2
            ).transpose(0, 2, 1, 3).astype(v.dtype)
            k = jnp.concatenate(
                [kh[:, :, :1], _apply_vision_rope(kh[:, :, 1:], rope_cos,
                                                  rope_sin)], axis=2
            ).transpose(0, 2, 1, 3).astype(v.dtype)
        att = attention(q, k, v).reshape(N, T, D)
        if cfg.subln:
            att = _ln(att, p["inner_ln"], eps)
        att = att @ p["proj"]["kernel"] + p["proj"]["bias"]
        # postnorm order (eva_vit.py:430-446): norm FIRST, then the
        # layer-scale gamma
        if cfg.postnorm:
            att = _ln(att, p["norm1"], eps)
        if cfg.ls_init_value:
            att = att * p["gamma_1"]
        x = r + att

        r = x
        h = x if cfg.postnorm else _ln(x, p["norm2"], eps)
        if cfg.naiveswiglu:
            hid = jax.nn.silu(h @ p["w1"]["kernel"] + p["w1"]["bias"]) * (
                h @ p["w2"]["kernel"] + p["w2"]["bias"])
            if cfg.subln:
                hid = _ln(hid, p["ffn_ln"], eps)
            ff = hid @ p["w3"]["kernel"] + p["w3"]["bias"]
        else:
            hid = jax.nn.gelu(h @ p["fc1"]["kernel"] + p["fc1"]["bias"],
                              approximate=False)
            ff = hid @ p["fc2"]["kernel"] + p["fc2"]["bias"]
        if cfg.postnorm:
            ff = _ln(ff, p["norm2"], eps)
        if cfg.ls_init_value:
            ff = ff * p["gamma_2"]
        x = r + ff

    return x[:, 1:]                     # drop CLS (wrapper :846-848)


# ---------------------------------------------------------------------------
# checkpoint conversion (torch EVAVisionTransformer state dict)
# ---------------------------------------------------------------------------

def convert_eva_state_dict(state: dict, cfg: EVAConfig,
                           dtype=jnp.float32, prefix: str = "") -> dict:
    def get(name, required=True):
        for cand in (prefix + name, name):
            if cand in state:
                return np.asarray(state[cand])
        if required:
            raise KeyError(f"missing EVA weight: {prefix + name}")
        return None

    def lin(name):
        w = get(f"{name}.weight").T
        out = {"kernel": jnp.asarray(w, dtype)}
        b = get(f"{name}.bias", required=False)
        if b is not None:
            out["bias"] = jnp.asarray(b, dtype)
        return out

    def norm(name):
        return {"weight": jnp.asarray(get(f"{name}.weight"), dtype),
                "bias": jnp.asarray(get(f"{name}.bias"), dtype)}

    conv = get("patch_embed.proj.weight")          # [D, C, p, p]
    layers = []
    for i in range(cfg.layers):
        b = f"blocks.{i}"
        p = {"norm1": norm(f"{b}.norm1"), "norm2": norm(f"{b}.norm2"),
             "proj": lin(f"{b}.attn.proj")}
        if cfg.subln:
            p["q_proj"] = {"kernel": jnp.asarray(
                get(f"{b}.attn.q_proj.weight").T, dtype)}
            p["k_proj"] = {"kernel": jnp.asarray(
                get(f"{b}.attn.k_proj.weight").T, dtype)}
            p["v_proj"] = {"kernel": jnp.asarray(
                get(f"{b}.attn.v_proj.weight").T, dtype)}
            p["inner_ln"] = norm(f"{b}.attn.inner_attn_ln")
        else:
            p["qkv"] = {"kernel": jnp.asarray(
                get(f"{b}.attn.qkv.weight").T, dtype)}
        if cfg.qkv_bias:
            p["q_bias"] = jnp.asarray(get(f"{b}.attn.q_bias"), dtype)
            p["v_bias"] = jnp.asarray(get(f"{b}.attn.v_bias"), dtype)
        if cfg.naiveswiglu:
            p["w1"] = lin(f"{b}.mlp.w1")
            p["w2"] = lin(f"{b}.mlp.w2")
            p["w3"] = lin(f"{b}.mlp.w3")
            if cfg.subln:
                p["ffn_ln"] = norm(f"{b}.mlp.ffn_ln")
        else:
            p["fc1"] = lin(f"{b}.mlp.fc1")
            p["fc2"] = lin(f"{b}.mlp.fc2")
        g = get(f"{b}.gamma_1", required=False)
        if g is not None:
            p["gamma_1"] = jnp.asarray(g, dtype)
            p["gamma_2"] = jnp.asarray(get(f"{b}.gamma_2"), dtype)
        layers.append(p)

    return {
        "patch_embed": {
            "kernel": jnp.asarray(
                conv.reshape(conv.shape[0], -1).T, dtype),
            "bias": jnp.asarray(get("patch_embed.proj.bias"), dtype),
        },
        "cls_token": jnp.asarray(get("cls_token").reshape(-1), dtype),
        "pos_embed": jnp.asarray(get("pos_embed")[0], dtype),
        "layers": layers,
    }
