"""Monte-Carlo log-likelihood for multiple-choice evaluation.

Parity with reference llada/log_likelyhood.py:7-96 + the multimodal entry
llava_llada.py:300-325:

  - stratified mask-count sampling: one k ~ U{1..T}, then the batch rows get
    round(linspace(k, k+(b-1)·T/b, b)) wrapped to [1, T] masked positions
    (log_likelyhood.py:10-16) — a variance-reduction trick over iid
    sampling;
  - each row masks a random subset of exactly x_i answer positions
    (permutation comparison, :18-21);
  - loss = Σ CE(masked)/p_mask / batch_size, averaged over mc_num/batch
    rounds, negated (:88-96);
  - the multimodal prompt enters as precomputed prefix embeddings
    (llava_llada.py:300-325; answer truncated to 300 tokens there — the
    caller's responsibility here).

The per-round computation is one jitted function; rounds loop on host
(mc_num/batch_size iterations, each independent)."""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LLaDAConfig
from ..models import llada as llada_model


@functools.partial(jax.jit, static_argnames=(
    "cfg", "batch_size", "act_int8", "forward_chunk"))
def _mc_round(
    params,
    cfg: LLaDAConfig,
    prefix_embeds: jax.Array,   # [1, P, D]
    answer: jax.Array,          # [Ta]
    key: jax.Array,
    batch_size: int,
    act_int8: bool = False,
    forward_chunk: int = 8,
):
    P = prefix_embeds.shape[1]
    Ta = answer.shape[0]
    b = batch_size
    kk, kp = jax.random.split(key)

    # stratified mask counts (log_likelyhood.py:10-16)
    k = jax.random.randint(kk, (), 1, Ta + 1)
    x = jnp.round(
        jnp.linspace(k.astype(jnp.float32),
                     k.astype(jnp.float32) + (b - 1) * (Ta / b), b)
    ).astype(jnp.int32)
    x = ((x - 1) % Ta) + 1

    # per-row random subset of exactly x_i positions
    perm_keys = jax.random.split(kp, b)
    ranks = jax.vmap(lambda pk: jax.random.permutation(pk, Ta))(perm_keys)
    is_mask = ranks < x[:, None]                      # [b, Ta]

    ans = jnp.broadcast_to(answer[None], (b, Ta))
    mask_embed = llada_model.embed_tokens(
        params, jnp.array([cfg.mask_token_id])
    )[0]
    ans_embeds = llada_model.embed_tokens(params, ans)
    ans_embeds = jnp.where(is_mask[..., None], mask_embed, ans_embeds)
    embeds = jnp.concatenate(
        [jnp.broadcast_to(prefix_embeds, (b, P, prefix_embeds.shape[-1])),
         ans_embeds.astype(prefix_embeds.dtype)],
        axis=1,
    )
    # hidden states only: the full-sequence f32 logits are
    # [b, P+Ta, V] = 10.3G at MMMU geometry (b=16, P=1061, Ta=300,
    # V=126k).  Only answer positions need the
    # head, and the head runs in sequence chunks so no [b, Ta, V] f32
    # ever materializes (same trick as the training ce_chunk head,
    # train/loss.py).  log_softmax is per-position, so chunking is exact.
    def fwd(e):
        hidden, _ = llada_model.forward(
            params, cfg, e, return_logits=False, act_int8=act_int8,
        )
        return hidden[:, P:]                          # answer positions

    # forward in row chunks: rows are independent (attention is within-
    # row), so chunking is EXACT — it only bounds the live activation
    # set (M = 8*1361 rows per chunk still fill a large matmul).
    fb = forward_chunk if b % forward_chunk == 0 else b
    if fb < b:
        h = jax.lax.map(fwd, embeds.reshape(b // fb, fb, *embeds.shape[1:]))
        h = h.reshape(b, Ta, -1)
    else:
        h = fwd(embeds)                               # [b, Ta, D]
    c = min(64, Ta)
    Tp = -(-Ta // c) * c
    ans_p = ans
    if Tp != Ta:
        h = jnp.pad(h, ((0, 0), (0, Tp - Ta), (0, 0)))
        ans_p = jnp.pad(ans, ((0, 0), (0, Tp - Ta)))
    nc = Tp // c

    from ..ops.quant import linear as _qlinear

    def head_chunk(args):
        h_c, t_c = args                               # [b, c, D], [b, c]
        if cfg.weight_tying:
            lg = jnp.einsum("bcd,vd->bcv", h_c, params["wte"],
                            preferred_element_type=jnp.float32)
        else:
            lg = _qlinear(h_c, params["ff_out"], preferred=jnp.float32)
        if cfg.scale_logits:
            lg = lg * (1.0 / math.sqrt(cfg.d_model))
        lp = jax.nn.log_softmax(lg, axis=-1)
        return -jnp.take_along_axis(lp, t_c[..., None], axis=-1)[..., 0]

    chunks = (
        h.reshape(b, nc, c, h.shape[-1]).transpose(1, 0, 2, 3),
        ans_p.reshape(b, nc, c).transpose(1, 0, 2),
    )
    nll = jax.lax.map(head_chunk, chunks)             # [nc, b, c]
    nll = nll.transpose(1, 0, 2).reshape(b, Tp)[:, :Ta]
    p_mask = (x.astype(jnp.float32) / Ta)[:, None]
    loss = jnp.where(is_mask, nll / p_mask, 0.0).sum() / b
    return loss


def get_log_likelihood(
    params,
    cfg: LLaDAConfig,
    prefix_embeds: jax.Array,
    answer: jax.Array | np.ndarray,
    mc_num: int = 128,
    batch_size: int = 16,
    key: Optional[jax.Array] = None,
    act_int8: bool = False,
    forward_chunk: int = 8,
) -> float:
    """log p(answer | prefix) MC estimate (negative expected weighted CE).

    act_int8=True runs the W8A8 linears (the mixed-serving prefill path)
    — opt-in only: the estimator SCORES answers, and the ~0.2-0.5%
    activation-quant logit error can flip close multiple-choice
    rankings, so the default stays weight-only."""
    if key is None:
        key = jax.random.PRNGKey(0)
    answer = jnp.asarray(answer)
    rounds = max(mc_num // batch_size, 1)
    total = 0.0
    for i in range(rounds):
        total += float(
            _mc_round(params, cfg, prefix_embeds, answer,
                      jax.random.fold_in(key, i), batch_size,
                      act_int8=act_int8, forward_chunk=forward_chunk)
        )
    return -total / rounds
