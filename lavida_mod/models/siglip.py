"""SigLIP ViT encoder.

Functional re-design of the reference from-scratch SigLIP
(llava/model/multimodal_encoder/siglip_base.py:110-627):

  - patch embedding: conv(kernel=stride=14) is exactly a block reshape +
    one matmul — expressed that way so it lands on the matrix units as one GEMM
    instead of an im2col conv;
  - learned position embeddings (729 slots, NO CLS token, siglip_base.py:74-106)
    with bicubic interpolation for non-384 resolutions (siglip_base.py:193-264)
    computed once per grid size outside jit;
  - pre-LN encoder layers (LN → MHA → res, LN → GELU-tanh MLP → res,
    siglip_base.py:370-500) run as one lax.scan over stacked layer params;
  - the LaViDa tower deletes the final encoder layer and reads the raw
    hidden state with NO post-layernorm (siglip_encoder.py:240, :564) — so
    `forward` runs `cfg.n_layers_used` layers and returns the raw features.

Weights convert from the HF/torch checkpoint via `convert_siglip_state_dict`.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SigLIPConfig
from ..ops.attention import attention
from ..ops.norms import layer_norm
from ..ops.quant import linear

Params = dict


def init_params(cfg: SigLIPConfig, key: jax.Array, dtype=jnp.float32) -> Params:
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.n_layers_used
    P, C = cfg.patch_size, cfg.num_channels
    keys = iter(jax.random.split(key, 12))

    def dense(k, shape, std=0.02):
        return jax.random.normal(k, shape, dtype) * jnp.asarray(std, dtype)

    def lin(k, i, o, L=None):
        shape_w = (L, i, o) if L else (i, o)
        shape_b = (L, o) if L else (o,)
        return {"kernel": dense(k, shape_w), "bias": jnp.zeros(shape_b, dtype)}

    def ln(shape):
        return {"weight": jnp.ones(shape, dtype), "bias": jnp.zeros(shape, dtype)}

    return {
        "patch_embed": lin(next(keys), P * P * C, D),
        "pos_embed": dense(next(keys), (cfg.num_patches, D)),
        "layers": {
            "ln1": ln((L, D)),
            "ln2": ln((L, D)),
            "q_proj": lin(next(keys), D, D, L),
            "k_proj": lin(next(keys), D, D, L),
            "v_proj": lin(next(keys), D, D, L),
            "out_proj": lin(next(keys), D, D, L),
            "fc1": lin(next(keys), D, I, L),
            "fc2": lin(next(keys), I, D, L),
        },
    }


def quantize_tower(params: Params) -> Params:
    """Per-channel int8 on the per-layer linears (q/k/v/out/fc1/fc2 —
    stacked [L, i, o] kernels get per-(L, out) scales); patch embed,
    pos embed, and norms stay in the float dtype.  Pair with
    `forward(act_int8=True)` for s8xs8 serving; quality-gate per
    checkpoint (scripts/verify_checkpoint.py) like int4."""
    from ..ops.quant import quantize_linear

    layers = {
        k: (quantize_linear(v) if "kernel" in v else v)
        for k, v in params["layers"].items()
    }
    return {**params, "layers": layers}


def _interp_pos_embed(pos_embed: jax.Array, target_grid: int) -> jax.Array:
    """Bicubic pos-embed interpolation for non-384 inputs
    (siglip_base.py:193-264). Called outside jit, cached by grid size."""
    g = int(round(float(np.sqrt(pos_embed.shape[0]))))
    D = pos_embed.shape[-1]
    grid = pos_embed.reshape(g, g, D).astype(jnp.float32)
    out = jax.image.resize(grid, (target_grid, target_grid, D), method="bicubic")
    return out.reshape(target_grid * target_grid, D).astype(pos_embed.dtype)


def patchify(pixel_values: jax.Array, patch: int) -> jax.Array:
    """[N, C, H, W] -> [N, (H//p)*(W//p), p*p*C] with (c, ph, pw) minor
    order, matching the torch Conv2d weight layout [D, C, ph, pw].  Like the
    valid-padding conv, trailing pixels beyond a whole patch are dropped
    (384 = 27*14 + 6: SigLIP uses 27x27 patches and ignores the last 6 rows
    /cols)."""
    N, C, H, W = pixel_values.shape
    gh, gw = H // patch, W // patch
    x = pixel_values[:, :, : gh * patch, : gw * patch]
    x = x.reshape(N, C, gh, patch, gw, patch)
    x = x.transpose(0, 2, 4, 1, 3, 5)  # [N, gh, gw, C, ph, pw]
    return x.reshape(N, gh * gw, C * patch * patch)


def forward(
    params: Params,
    cfg: SigLIPConfig,
    pixel_values: jax.Array,
    *,
    n_layers: Optional[int] = None,
    remat: bool = False,
    act_int8: bool = False,
) -> jax.Array:
    """pixel_values: [N, C, H, W] (preprocessed). Returns raw features
    [N, tokens, hidden] after `n_layers` (default cfg.n_layers_used) layers,
    no post-layernorm (matching hidden_states[-1] of the truncated tower)."""
    # Cast pixels to the tower's compute dtype (the reference's
    # images.to(dtype=self.dtype), llava_arch.py:700): the image
    # processor emits f32 numpy, and f32 x bf16 promotes to f32 — which
    # silently ran the whole serving prefill AND the KV cache in f32
    # (caught on chip: the B=8 worker graph carried f32[8,1184,32,128]
    # caches, 2x the bf16 memory).
    # patch_embed stays float under every quantized layout, so its
    # kernel dtype IS the compute dtype.
    wdt = params["patch_embed"]["kernel"].dtype
    if pixel_values.dtype != wdt:
        pixel_values = pixel_values.astype(wdt)
    N, C, H, W = pixel_values.shape
    p = cfg.patch_size
    x = patchify(pixel_values, p)
    x = x @ params["patch_embed"]["kernel"] + params["patch_embed"]["bias"]

    n_tokens = x.shape[1]
    pos = params["pos_embed"]
    if n_tokens != pos.shape[0]:
        pos = _interp_pos_embed(pos, int(round(float(np.sqrt(n_tokens)))))
    x = x + pos[None]

    eps = cfg.layer_norm_eps
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    # serving option: per-token int8 activations on int8-quantized tower
    # weights -> s8xs8 dots (the tower is compute-bound at 5-view
    # anyres).  Falls back to plain linear on bf16 weights.
    # Quality-gate per checkpoint like int4 (scripts/verify_checkpoint.py).
    from ..ops.quant import linear_act_int8
    lin = linear_act_int8 if act_int8 else linear

    def layer_fn(h, p_l):
        # linears go through ops.quant.linear so attached LoRA factors
        # (SHIRG Extra-LoRA targets early-SigLIP q/k/v, train/lora.py)
        # actually contribute — a raw `@ kernel` would silently skip them
        r = h
        z = layer_norm(h, p_l["ln1"]["weight"], p_l["ln1"]["bias"], eps)
        q = lin(z, p_l["q_proj"])
        k = lin(z, p_l["k_proj"])
        v = lin(z, p_l["v_proj"])
        T = z.shape[1]
        att = attention(
            q.reshape(N, T, nh, hd), k.reshape(N, T, nh, hd),
            v.reshape(N, T, nh, hd),
        ).reshape(N, T, -1)
        h = r + lin(att, p_l["out_proj"])
        r = h
        z = layer_norm(h, p_l["ln2"]["weight"], p_l["ln2"]["bias"], eps)
        z = jax.nn.gelu(lin(z, p_l["fc1"]), approximate=True)
        h = r + lin(z, p_l["fc2"])
        return h, None

    if remat:
        layer_fn = jax.checkpoint(layer_fn, prevent_cse=False)

    layers = params["layers"]
    if n_layers is not None and n_layers != jax.tree.leaves(layers)[0].shape[0]:
        layers = jax.tree.map(lambda a: a[:n_layers], layers)
    x, _ = jax.lax.scan(layer_fn, x, layers)
    return x


# ---------------------------------------------------------------------------
# Checkpoint conversion
# ---------------------------------------------------------------------------

def convert_siglip_state_dict(
    state: dict[str, np.ndarray],
    cfg: SigLIPConfig,
    dtype=jnp.bfloat16,
    prefix: str = "vision_model.",
) -> Params:
    """torch SigLipVisionModel state_dict -> params pytree.

    Reference names (siglip_base.py:576-627):
      vision_model.embeddings.patch_embedding.{weight[D,C,p,p], bias[D]}
      vision_model.embeddings.position_embedding.weight [729, D]
      vision_model.encoder.layers.<i>.{layer_norm1,layer_norm2}.{weight,bias}
      vision_model.encoder.layers.<i>.self_attn.{q,k,v,out}_proj.{weight,bias}
      vision_model.encoder.layers.<i>.mlp.{fc1,fc2}.{weight,bias}
    Only the first cfg.n_layers_used layers are converted (the tower deletes
    the final layer, siglip_encoder.py:240).
    """
    def get(name):
        for cand in (prefix + name, name):
            if cand in state:
                return np.asarray(state[cand])
        raise KeyError(f"missing weight: {prefix + name}")

    L = cfg.n_layers_used
    D = cfg.hidden_size

    conv_w = get("embeddings.patch_embedding.weight")  # [D, C, p, p]
    patch_kernel = conv_w.reshape(D, -1).T             # [(C p p), D]

    def stack_lin(tmpl):
        ws = [get(tmpl.format(i) + ".weight").T for i in range(L)]
        bs = [get(tmpl.format(i) + ".bias") for i in range(L)]
        return {
            "kernel": jnp.asarray(np.stack(ws), dtype),
            "bias": jnp.asarray(np.stack(bs), dtype),
        }

    def stack_ln(tmpl):
        ws = [get(tmpl.format(i) + ".weight") for i in range(L)]
        bs = [get(tmpl.format(i) + ".bias") for i in range(L)]
        return {
            "weight": jnp.asarray(np.stack(ws), dtype),
            "bias": jnp.asarray(np.stack(bs), dtype),
        }

    lt = "encoder.layers.{}."
    return {
        "patch_embed": {
            "kernel": jnp.asarray(patch_kernel, dtype),
            "bias": jnp.asarray(get("embeddings.patch_embedding.bias"), dtype),
        },
        "pos_embed": jnp.asarray(
            get("embeddings.position_embedding.weight"), dtype
        ),
        "layers": {
            "ln1": stack_ln(lt + "layer_norm1"),
            "ln2": stack_ln(lt + "layer_norm2"),
            "q_proj": stack_lin(lt + "self_attn.q_proj"),
            "k_proj": stack_lin(lt + "self_attn.k_proj"),
            "v_proj": stack_lin(lt + "self_attn.v_proj"),
            "out_proj": stack_lin(lt + "self_attn.out_proj"),
            "fc1": stack_lin(lt + "mlp.fc1"),
            "fc2": stack_lin(lt + "mlp.fc2"),
        },
    }
