"""Mixture-of-Experts feed-forward block (AR baselines llava_mixtral /
llava_qwen_moe, SURVEY.md §2.1).

Mixtral-style top-k routing re-expressed for XLA: instead of the
reference's per-expert token scatter (dynamic shapes), every token computes
through all experts' GEMMs batched along an expert axis and the router's
top-k weights combine them — dense-dispatch MoE.  For the expert counts of
these baselines (8 experts, top-2) this trades 4x FLOPs for perfectly
static shapes and batched GEMMs, which is the right trade below ~16
experts; a capacity-based sparse dispatch is the later path for
larger expert counts.

Integrates with the shared core via `moe_ff`: a drop-in replacement for the
dense SwiGLU when params carry an "experts" entry.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

Params = dict


def init_moe_params(
    d_model: int,
    hidden: int,
    n_experts: int,
    key: jax.Array,
    dtype=jnp.float32,
) -> Params:
    kg, k1, k2, k3 = jax.random.split(key, 4)

    def dense(k, shape, std=0.02):
        return (jax.random.normal(k, shape) * std).astype(dtype)

    return {
        "router": {"kernel": dense(kg, (d_model, n_experts))},
        "experts": {
            # [E, in, out] stacked expert weights (SwiGLU triple)
            "ff_proj": {"kernel": dense(k1, (n_experts, d_model, hidden))},
            "up_proj": {"kernel": dense(k2, (n_experts, d_model, hidden))},
            "ff_out": {"kernel": dense(k3, (n_experts, hidden, d_model))},
        },
    }


def moe_ff(
    x: jax.Array,            # [B, T, D]
    p: Params,
    top_k: int = 2,
    router_jitter: Optional[jax.Array] = None,
) -> tuple[jax.Array, jax.Array]:
    """Top-k softmax routing over dense-dispatched experts.

    Returns (output [B, T, D], aux_load [E] mean router prob per expert —
    the load-balancing signal mixtral trains with).
    """
    B, T, D = x.shape
    logits = x @ p["router"]["kernel"]                       # [B, T, E]
    if router_jitter is not None:
        logits = logits + router_jitter
    E = logits.shape[-1]
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    top_vals, top_idx = jax.lax.top_k(probs, top_k)          # [B, T, k]
    # mixtral renormalizes the selected weights
    top_vals = top_vals / jnp.maximum(
        top_vals.sum(axis=-1, keepdims=True), 1e-9
    )
    # dense dispatch: all experts compute, gate selects
    ex = p["experts"]
    h = jnp.einsum("btd,edh->beth", x, ex["ff_proj"]["kernel"])
    u = jnp.einsum("btd,edh->beth", x, ex["up_proj"]["kernel"])
    y = jnp.einsum("beth,ehd->betd", jax.nn.silu(h) * u,
                   ex["ff_out"]["kernel"])                    # [B, E, T, D]
    # combine: weight[b,t,e] = sum over selected slots
    onehot = jax.nn.one_hot(top_idx, E, dtype=jnp.float32)    # [B, T, k, E]
    gate = (onehot * top_vals[..., None]).sum(axis=2)         # [B, T, E]
    out = jnp.einsum("betd,bte->btd", y, gate.astype(y.dtype))
    return out.astype(x.dtype), probs.mean(axis=(0, 1))


def load_balancing_loss(router_probs_mean: jax.Array,
                        top_fraction: jax.Array | None = None) -> jax.Array:
    """Switch-style aux loss: E * sum(f_e * p_e); with dense stats we use
    the mean-prob proxy E * sum(p_e^2) when expert fractions are absent."""
    E = router_probs_mean.shape[0]
    if top_fraction is None:
        return E * jnp.sum(router_probs_mean * router_probs_mean)
    return E * jnp.sum(top_fraction * router_probs_mean)
