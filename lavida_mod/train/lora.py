"""LoRA adapters (reference peft paths: train.py:1928-1961 LoRA training,
builder.py:62-123 lora merge-load, shirg/shirg_lora_config.py rank-64
projector+early-SigLIP targeting).

Functional design: LoRA factors live INSIDE each linear's param dict
("lora_a" [in, r], "lora_b" [r, out], "lora_scale"); ops/quant.linear adds
the low-rank term automatically, so every model path (LLaDA, Dream, SigLIP,
projector) is LoRA-capable without model changes.  b starts at zero so the
adapted model is exactly the base model at init.
"""

from __future__ import annotations

import re
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax


def _iter_linears(tree, path=""):
    if isinstance(tree, dict):
        if "kernel" in tree or "kernel_q" in tree:
            yield path, tree
        else:
            for k, v in tree.items():
                yield from _iter_linears(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_linears(v, f"{path}/{i}")


def add_lora(
    params: dict,
    key: jax.Array,
    rank: int = 64,
    alpha: float = 128.0,
    target_re: str = r"(projector|q_proj|k_proj|v_proj|attn_out)",
    dtype=jnp.float32,
) -> dict:
    """Return a copy of params with LoRA factors attached to every linear
    whose path matches target_re."""
    params = jax.tree.map(lambda x: x, params)  # shallow-ish copy
    n = 0
    for path, p in _iter_linears(params):
        if not re.search(target_re, path):
            continue
        k = p.get("kernel", p.get("kernel_q"))
        din, dout = k.shape[-2], k.shape[-1]
        lead = k.shape[:-2]
        key, sub = jax.random.split(key)
        p["lora_a"] = (
            jax.random.normal(sub, lead + (din, rank)) * (1.0 / rank)
        ).astype(dtype)
        p["lora_b"] = jnp.zeros(lead + (rank, dout), dtype)
        # scale carries the stacked-layer lead dims so lax.scan can slice it
        p["lora_scale"] = jnp.full(lead, alpha / rank, dtype)
        n += 1
    assert n > 0, f"no linear matched {target_re!r}"
    return params


def merge_lora(params: dict) -> dict:
    """Fold LoRA factors into the base kernels (builder.py lora-merge)."""
    params = jax.tree.map(lambda x: x, params)
    for _, p in _iter_linears(params):
        if "lora_a" not in p:
            continue
        delta = jnp.einsum(
            "...ir,...ro->...io", p["lora_a"].astype(jnp.float32),
            p["lora_b"].astype(jnp.float32),
        ) * p["lora_scale"][..., None, None]
        assert "kernel" in p, "merge into int8 weights not supported"
        p["kernel"] = (p["kernel"].astype(jnp.float32) + delta).astype(
            p["kernel"].dtype
        )
        del p["lora_a"], p["lora_b"], p["lora_scale"]
    return params


def split_lora_state(params: dict) -> dict:
    """Extract only the LoRA factors (adapter-only checkpointing — the
    non_lora_trainables.bin split of train.py:2171-2180)."""
    out = {}
    for path, p in _iter_linears(params):
        if "lora_a" in p:
            out[path] = {"lora_a": p["lora_a"], "lora_b": p["lora_b"],
                         "lora_scale": p["lora_scale"]}
    return out


def load_lora_state(params: dict, lora_state: dict) -> dict:
    params = jax.tree.map(lambda x: x, params)
    linears = dict(_iter_linears(params))
    for path, factors in lora_state.items():
        linears[path].update(factors)
    return params


def make_lora_optimizer(
    lr: float = 1e-4, weight_decay: float = 0.0, grad_clip: float = 1.0,
    warmup_steps: int = 0, total_steps: int = 10000,
) -> optax.GradientTransformation:
    """Train ONLY lora_a / lora_b; everything else frozen."""
    from .step import _adamw_builder

    adamw = _adamw_builder(
        weight_decay=weight_decay, grad_clip=grad_clip,
        warmup_steps=warmup_steps, total_steps=total_steps,
    )

    def label(params):
        def lab(path, _):
            last = path[-1]
            name = str(last.key) if hasattr(last, "key") else str(last)
            return "lora" if name in ("lora_a", "lora_b") else "frozen"

        return jax.tree_util.tree_map_with_path(lab, params)

    return optax.multi_transform(
        {"lora": adamw(lr), "frozen": optax.set_to_zero()}, label
    )


# SHIRG LoRA recipe (shirg/shirg_lora_config.py:17-140)
SHIRG_LORA_RANK = 64
SHIRG_LORA_ALPHA = 128.0
SHIRG_LORA_TARGETS = (
    r"(projector|siglip/layers/(q_proj|k_proj|v_proj|out_proj))"
)


def add_shirg_lora(
    params: dict,
    key: jax.Array,
    rank: int = SHIRG_LORA_RANK,
    alpha: float = SHIRG_LORA_ALPHA,
    dtype=jnp.float32,
) -> dict:
    """Attach the SHIRG Extra-LoRA footprint
    (shirg/shirg_lora_config.py:82-112): both projector linears, SigLIP
    blocks 0-3 q/k/v, blocks 4-5 q/k only.

    The SigLIP params are stacked [L, ...]; per-layer targeting is
    expressed through the per-layer `lora_scale` vector — non-target
    layers get scale 0, which makes their factors inert (zero forward
    delta AND zero gradient, so they never move)."""
    params = add_lora(
        params, key, rank=rank, alpha=alpha,
        target_re=r"(projector|siglip/layers/(q_proj|k_proj|v_proj))",
        dtype=dtype,
    )
    sl = params["siglip"]["layers"]
    L = sl["q_proj"]["lora_scale"].shape[0]
    qk_mask = (np.arange(L) < 6).astype(np.float32)   # blocks 0-5: q, k
    v_mask = (np.arange(L) < 4).astype(np.float32)    # blocks 0-3: + v
    for name, m in (("q_proj", qk_mask), ("k_proj", qk_mask),
                    ("v_proj", v_mask)):
        sl[name]["lora_scale"] = (
            sl[name]["lora_scale"] * jnp.asarray(m, dtype))
    return params


def make_shirg_lora_train_step(
    cfg,
    optimizer,
    *,
    prefix_lm: bool = True,
    shirg_method: str = "full",
    remat: bool = True,
):
    """Train step over the SHIRG 2-view data path
    (shirg/train_shirg_lora.py:86-1145 re-expressed functionally):
    each sample is (2-view 448px stack -> shirg_encode 980 tokens) ++
    text embeddings, then the standard complementary-masking diffusion
    loss.  Gradients flow into the LoRA factors only (the optimizer from
    make_lora_optimizer zeroes everything else).

    batch: {"pixel_values" [B, 2, C, S, S], "text_ids" [B, Ttxt],
    "labels" [B, 980 + Ttxt]} — labels carry -100 over the image+prompt
    region exactly like the reference collator."""
    from ..models import llada as llada_model
    from ..models.shirg import shirg_encode
    from .loss import diffusion_loss

    def encode_one(params, views, key):
        return shirg_encode(params, cfg, views, method=shirg_method,
                            key=key)

    def loss_fn(params, batch, key):
        B = batch["pixel_values"].shape[0]
        kimg, kloss = jax.random.split(key)
        img_tokens = jax.vmap(
            lambda v, k: encode_one(params, v, k),
            in_axes=(0, 0),
        )(batch["pixel_values"], jax.random.split(kimg, B))
        text_emb = llada_model.embed_tokens(
            params["llada"], batch["text_ids"])
        embeds = jnp.concatenate(
            [img_tokens.astype(text_emb.dtype), text_emb], axis=1)
        return diffusion_loss(
            params["llada"], cfg.llada, embeds, batch["labels"], kloss,
            prefix_lm=prefix_lm, remat=remat,
        )

    def train_step(params, opt_state, batch, key):
        (loss, metrics), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, batch, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        metrics["grad_norm"] = optax.global_norm(grads)
        return params, opt_state, metrics

    return train_step
