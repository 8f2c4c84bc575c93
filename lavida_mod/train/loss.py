"""Masked-diffusion training loss with complementary masking.

Behavior parity with the reference training forward
(llava/model/language_model/llava_llada.py:105-258 and the loss in
llada/modeling_llada.py:1519-1549):

  1. sample t per row (uniform / logit_normal / mode, llava_llada.py:42-54),
     p_mask = (1-eps)·t + eps;
  2. mask positions where rand <= max(p_mask, row-min rand) — the row-min
     term guarantees >=1 masked position (llava_llada.py:57-71);
  3. COMPLEMENTARY MASKING: the batch is doubled with the inverse mask
     (llava_llada.py:173-189) so every target token is supervised exactly
     once per sample;
  4. masked positions' embeddings are replaced by wte([MASK]);
  5. prefix-LM prompt_len = argmax(labels_mask) per row enables the
     prefix block mask (llava_llada.py:154-156);
  6. loss = mean CE over supervised (non -100) positions; FIM marker
     labels are killed (llava_llada.py:185-187); NO 1/p_mask weighting
     (matching the fork, not the LLaDA paper objective);
  7. eos-padding trick happens in the collator (labels revert to eos at
     padding so the model learns to emit eos after the answer,
     llava_llada.py:129-133) — see data/collator.py.

Everything here is fixed-shape and jit/pjit-safe; randomness comes from an
explicit PRNG key.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import LLaDAConfig
from ..models import llada as llada_model


def sample_t(
    key: jax.Array, b: int, policy: str = "uniform",
    policy_args: Optional[dict] = None,
) -> jax.Array:
    if policy == "uniform":
        return jax.random.uniform(key, (b,))
    if policy == "logit_normal":
        a = policy_args or {"logit_mean": 0.0, "logit_std": 1.0}
        u = a["logit_mean"] + a["logit_std"] * jax.random.normal(key, (b,))
        return jax.nn.sigmoid(u)
    if policy == "mode":
        a = policy_args or {"mode_scale": 1.0}
        u = jax.random.uniform(key, (b,))
        return 1.0 - u - a["mode_scale"] * (
            jnp.cos(jnp.pi * u / 2.0) ** 2 - 1.0 + u
        )
    raise NotImplementedError(policy)


def forward_process(
    key: jax.Array, b: int, l: int, eps: float = 1e-3,
    policy: str = "uniform", policy_args: Optional[dict] = None,
):
    """Returns (masked_indices [b, l] bool, p_mask [b, 1] f32)."""
    kt, km = jax.random.split(key)
    t = sample_t(kt, b, policy, policy_args)
    p_mask = ((1.0 - eps) * t + eps)[:, None]
    r = jax.random.uniform(km, (b, l))
    cutoff = jnp.maximum(p_mask, r.min(axis=-1, keepdims=True))
    return r <= cutoff, p_mask


def diffusion_loss(
    params,
    cfg: LLaDAConfig,
    inputs_embeds: jax.Array,     # [B, L, D] spliced multimodal embeddings
    labels: jax.Array,            # [B, L] int, -100 = not supervised
    key: jax.Array,
    *,
    prefix_lm: bool = True,
    policy: str = "uniform",
    policy_args: Optional[dict] = None,
    masked_indices: Optional[jax.Array] = None,   # test injection
    fim_id: Optional[int] = None,
    pos_skip_range: int = 0,
    remat: bool = True,
    attention_impl: str = "dense",
    batch_constraint=None,
    ce_chunk: Optional[int] = None,
):
    """Returns (loss, metrics dict). Batch is doubled internally.

    ce_chunk: memory-efficient LM head — compute the cross-entropy in
    checkpointed chunks of `ce_chunk` sequence positions so the full f32
    [2B, L, V] logits never materialize (at the 8B stage-2 shapes that
    buffer alone is ~8.3 GB/chip, the B=16 blocker after nested remat —
    AOT-verified).  Loss/grad math is identical (per-position softmax);
    only the reduction order changes.

    batch_constraint: optional fn(x) -> x applying a GSPMD sharding
    constraint that pins dim 0 (batch) to the data axes.  Without it, XLA's
    backward sharding propagation through the mask `where`s can pick a
    conflicting layout for the pre-concat selects and fall back to
    "involuntary full rematerialization" (replicate + repartition) inside
    the train step — a real multi-chip perf bug observed on the 8-device
    dryrun.  make_train_step wires this automatically when given a mesh.
    """
    B, L, D = inputs_embeds.shape
    labels_mask = labels != -100
    fim_pos = (labels == fim_id) if fim_id is not None else jnp.zeros_like(labels_mask)

    if masked_indices is None:
        masked_indices, _ = forward_process(key, B, L, policy=policy,
                                            policy_args=policy_args)

    final_masked = masked_indices & labels_mask & ~fim_pos
    final_masked_inv = ~masked_indices & labels_mask & ~fim_pos

    mask_embed = llada_model.embed_tokens(
        params, jnp.array([cfg.mask_token_id])
    ).reshape(1, 1, D).astype(inputs_embeds.dtype)

    def apply_mask(sel):
        return jnp.where(sel[..., None], mask_embed, inputs_embeds)

    if batch_constraint is None:
        batch_constraint = lambda x: x
    embeds2 = batch_constraint(jnp.concatenate(
        [batch_constraint(apply_mask(final_masked)),
         batch_constraint(apply_mask(final_masked_inv))], axis=0
    ))
    lab = jnp.where(final_masked, labels, -100)
    lab_inv = jnp.where(final_masked_inv, labels, -100)
    labels2 = batch_constraint(jnp.concatenate([lab, lab_inv], axis=0))
    if fim_id is not None:
        labels2 = jnp.where(labels2 == fim_id, -100, labels2)

    prefix_lengths = None
    if prefix_lm:
        pl = jnp.argmax(labels_mask.astype(jnp.int32), axis=1)
        prefix_lengths = jnp.concatenate([pl, pl], axis=0)

    positions = None
    if pos_skip_range > 0:
        # use_pos_skipping (llava_arch.py:894-900): shift all positions by
        # a random offset so long-context RoPE ranges get exercised
        key, kp = jax.random.split(key)
        offset = jax.random.randint(kp, (), 0, pos_skip_range)
        positions = offset + jnp.arange(L, dtype=jnp.int32)
    sup = labels2 != -100
    tgt = jnp.where(sup, labels2, 0)
    denom = jnp.maximum(sup.sum(), 1)
    fwd_kwargs = dict(
        positions=positions,
        prefix_lengths=prefix_lengths,
        remat=remat,
        # "dense": one masked attention call (cuDNN's fused kernel on the
        # GPU); "blockwise": online softmax over key blocks for lengths
        # where the [T, S] mask no longer fits (ops/attention.py)
        attention_impl=attention_impl,
    )

    if ce_chunk:
        # ln_f-normalized hidden states instead of logits
        hidden, _ = llada_model.forward(
            params, cfg, embeds2, return_logits=False, **fwd_kwargs)
        if "ff_out" in params:
            W = params["ff_out"]["kernel"]          # [D, V]
        else:  # weight tying (modeling_llada.py:1419)
            W = params["wte"].T
        c = int(ce_chunk)
        Lp = -(-L // c) * c
        if Lp != L:
            hidden = jnp.pad(hidden, ((0, 0), (0, Lp - L), (0, 0)))
            tgt_p = jnp.pad(tgt, ((0, 0), (0, Lp - L)))
            sup_p = jnp.pad(sup, ((0, 0), (0, Lp - L)))
        else:
            tgt_p, sup_p = tgt, sup

        def head_chunk(args):
            h_c, t_c, s_c = args                    # [2B, c, ...]
            lg = jax.lax.dot_general(
                h_c, W.astype(h_c.dtype), (((2,), (0,)), ((), ())),
            ).astype(jnp.float32)                   # [2B, c, V]
            lp = jax.nn.log_softmax(lg, axis=-1)
            nll_c = -jnp.take_along_axis(lp, t_c[..., None], axis=-1)[..., 0]
            hit_c = (jnp.argmax(lg, axis=-1) == t_c) & s_c
            return (jnp.where(s_c, nll_c, 0.0).sum(), hit_c.sum())

        nc = Lp // c
        # chunk along the SEQUENCE axis (batch stays sharded on dim 0)
        chunks = (
            hidden.reshape(2 * B, nc, c, D).transpose(1, 0, 2, 3),
            tgt_p.reshape(2 * B, nc, c).transpose(1, 0, 2),
            sup_p.reshape(2 * B, nc, c).transpose(1, 0, 2),
        )
        nll_sum, hits = jax.lax.map(
            jax.checkpoint(head_chunk, prevent_cse=False), chunks)
        loss = nll_sum.sum() / denom
        acc = hits.sum() / denom
        return loss, {"loss": loss, "acc_mask": acc,
                      "num_supervised": sup.sum()}

    logits, _ = llada_model.forward(params, cfg, embeds2, **fwd_kwargs)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
    loss = jnp.where(sup, nll, 0.0).sum() / denom

    pred = jnp.argmax(logits, axis=-1)
    acc = jnp.where(sup, (pred == tgt), False).sum() / denom
    return loss, {"loss": loss, "acc_mask": acc, "num_supervised": sup.sum()}
