"""Dream diffusion sampler.

Behavior parity with reference dream/generation_utils.py:298-527 (`_sample`)
re-designed as one fused jitted executable:

  - prefill over the prefix embeddings builds the KV cache AND supplies the
    first generated token from the last prefill logit's argmax
    (generation_utils.py:424-428);
  - every step's logits are shifted one position right
    `cat([logits[:,:1], logits[:,:-1]])` (:470-473) — Dream keeps the
    AR-style head where position i-1 predicts token i;
  - confidence algs: origin (per-token Bernoulli transfer), maskgit_plus
    (sampled-prob confidence), topk_margin (top1-top2), entropy
    (negative entropy) (:478-505 + sample_tokens :58-93);
  - transfer counts: scheduled via the shared llada schedule table (:457),
    or the vanilla `int(m_i * (1 - s/t))` cascade — which is deterministic
    given the initial mask count, so it's precomputed host-side;
  - optional alg_temp: transfer set sampled from softmax(conf/alg_temp)
    without replacement (:508-511) — implemented as Gumbel top-k;
  - the reference flattens masked positions (batch-1 only, :476); the
    fixed-shape equivalent scores all positions and clamps unmasked ones to
    -inf, which is identical for every batch size.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DreamGenerationConfig, LLaDAConfig
from ..models import llada as llada_model
from ..ops.sampling import NEG_INF, topk_transfer_mask
from ..ops.schedules import num_transfer_tokens_scheduled


def _filter_logits(logits, top_p, top_k):
    """top-p / top-k logit filtering (generation_utils.py:31-56)."""
    if top_k is not None:
        kth = jax.lax.top_k(logits, top_k)[0][..., -1:]
        logits = jnp.where(logits < kth, NEG_INF, logits)
    if top_p is not None and top_p < 1:
        sorted_logits = jnp.sort(logits, axis=-1)[..., ::-1]
        probs = jax.nn.softmax(sorted_logits, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        # keep the first token above threshold (shifted mask)
        remove_sorted = cum - probs > top_p
        kth_keep = jnp.sum(~remove_sorted, axis=-1, keepdims=True)  # count kept
        thresh = jnp.take_along_axis(
            sorted_logits, jnp.maximum(kth_keep - 1, 0), axis=-1
        )
        logits = jnp.where(logits < thresh, NEG_INF, logits)
    return logits


def sample_tokens(
    logits: jax.Array,
    key: Optional[jax.Array],
    temperature: float = 0.0,
    top_p: Optional[float] = None,
    top_k: Optional[int] = None,
    margin_confidence: bool = False,
    neg_entropy: bool = False,
):
    """Returns (confidence, x0) over the full [..., V] logits
    (generation_utils.py:58-93)."""
    logits = logits.astype(jnp.float32)
    if temperature > 0:
        logits = logits / temperature
    logits = _filter_logits(logits, top_p, top_k)
    probs = jax.nn.softmax(logits, axis=-1)
    if temperature > 0:
        assert key is not None
        x0 = jax.random.categorical(key, logits, axis=-1)
        confidence = jnp.take_along_axis(probs, x0[..., None], axis=-1)[..., 0]
    else:
        x0 = jnp.argmax(logits, axis=-1)
        confidence = jnp.max(probs, axis=-1)
    if margin_confidence:
        # top-2 margin without lax.top_k: a k=2 top_k over Dream's 152k
        # vocab lowers to an expensive sort per step; two O(V) max passes
        # (mask exactly ONE argmax instance, like torch.topk) are
        # equivalent and cheaper
        i1 = jnp.argmax(probs, axis=-1)
        m1 = jnp.take_along_axis(probs, i1[..., None], axis=-1)[..., 0]
        masked = probs - jax.nn.one_hot(
            i1, probs.shape[-1], dtype=probs.dtype) * 2.0
        m2 = jnp.max(masked, axis=-1)
        confidence = m1 - m2
    if neg_entropy:
        confidence = jnp.sum(probs * jnp.log(probs + 1e-10), axis=-1)
    return confidence, x0


def build_dream_schedule(
    gen: DreamGenerationConfig, gen_length: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side control tables: (timesteps [S0+1], k_counts [S] (or zeros
    for 'origin'), steps).  Mask count starts at gen_length-1 (the first
    token comes from prefill)."""
    steps0 = min(gen.steps, gen.max_new_tokens)
    timesteps = np.linspace(1.0, gen.eps, steps0 + 1)
    steps = (
        int(gen.max_new_tokens * gen.step_ratio)
        if gen.step_ratio is not None else steps0
    )
    # step_ratio shortens the loop over the SAME steps0 timestep grid
    # (generation_utils.py:448-453 computes the linspace before applying
    # step_ratio); clamp to steps0 — beyond it the reference itself would
    # index timesteps past its end, and our t/s slices would shape-mismatch.
    steps = max(1, min(steps, steps0))
    m0 = gen_length - 1 if gen.prefix_lm else gen_length
    if gen.alg == "origin":
        return timesteps, np.zeros((steps,), np.int64), steps
    if gen.schedule is not None:
        sch = num_transfer_tokens_scheduled(
            np.array([m0]), steps, gen.schedule, shift=gen.schedule_shift
        )[0]
        if sch.shape[0] < steps:
            sch = np.concatenate(
                [sch, np.zeros((steps - sch.shape[0],), np.int64)]
            )
        return timesteps, sch, steps
    # vanilla cascade (generation_utils.py:500-503), deterministic
    ks = []
    m = m0
    for i in range(steps):
        t, s = timesteps[i], timesteps[i + 1]
        n = int(m * (1 - s / t)) if i < steps - 1 else m
        ks.append(n)
        m -= n
    return timesteps, np.asarray(ks, np.int64), steps


def _commit_step(x, logits, mask_index, k_i, p_i, ks, kt,
                 alg, alg_temp, temperature, top_p, top_k):
    """One denoise commit (generation_utils.py:476-515), shared between
    the fused scan body and the hooked host loop so they stay
    token-identical by construction."""
    B = x.shape[0]
    if alg == "origin":
        _, x0 = sample_tokens(logits, ks, temperature, top_p, top_k)
        u = jax.random.uniform(kt, x.shape)
        transfer = mask_index & (u < p_i)
        return jnp.where(transfer, x0.astype(jnp.int32), x)
    conf, x0 = sample_tokens(
        logits, ks, temperature, top_p, top_k,
        margin_confidence=(alg == "topk_margin"),
        neg_entropy=(alg == "entropy"),
    )
    conf = jnp.where(mask_index, conf, NEG_INF)
    if alg_temp is not None and alg_temp > 0:
        # multinomial without replacement == Gumbel top-k
        logp = jax.nn.log_softmax(
            jnp.where(mask_index, conf / alg_temp, NEG_INF), axis=-1
        )
        g = -jnp.log(-jnp.log(
            jax.random.uniform(kt, conf.shape, minval=1e-20)
        ))
        conf = jnp.where(mask_index, logp + g, NEG_INF)
    k_row = jnp.full((B,), k_i, jnp.int32)
    transfer = topk_transfer_mask(conf, k_row) & mask_index
    return jnp.where(transfer, x0.astype(jnp.int32), x)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "gen_length", "alg", "alg_temp", "temperature",
                     "top_p", "top_k", "act_int8_prefill"),
)
def _dream_fused(
    params,
    cfg: LLaDAConfig,
    prefix_embeds: jax.Array,      # [B, P, D]
    k_table: jax.Array,            # [S]
    p_transfer: jax.Array,         # [S] f32 (origin alg; else unused zeros)
    key: jax.Array,
    gen_length: int,
    alg: str,
    alg_temp: Optional[float],
    temperature: float,
    top_p: Optional[float],
    top_k: Optional[int],
    prefill_params=None,
    act_int8_prefill: bool = False,
):
    B, P, D = prefix_embeds.shape
    G = gen_length
    mask_id = cfg.mask_token_id
    # mixed-precision serving (same split as diffusion's fused body):
    # int8 weights + A8 for the compute-bound prefill, `params` (int4
    # layout) for the bandwidth-bound decode scan + embeddings
    pre_p = prefill_params if prefill_params is not None else params

    # WRITE-INDEX decode (serving, unrolled list-of-layers params): the
    # [B, P+G] per-layer cache buffers are PREALLOCATED and the prefill
    # writes its rows in place (kv_write_index=0), so the decode scan
    # starts with zero re-stack/pad copies (a pad-after-prefill
    # re-copies the whole prefix cache once); prefill attention masks
    # the G unwritten rows via the
    # filled-rows mask kv_write_index installs.  Per-step K/V writes
    # land at [P, P+G) — the concat path re-copied the whole P-row
    # prefix per layer per step.  Token parity is exact (every gen
    # position is rewritten each step); same machinery as
    # diffusion._generate_cached_fused_body.
    unrolled = (isinstance(params["blocks"], (list, tuple))
                and (prefill_params is None
                     or isinstance(pre_p["blocks"], (list, tuple))))
    if unrolled:
        Hkv, hd = cfg.effective_n_kv_heads, cfg.head_dim
        z = jnp.zeros((B, P + G, Hkv, hd), prefix_embeds.dtype)
        cache = [(z, z) for _ in params["blocks"]]
        logits_last, cache = llada_model.forward(
            pre_p, cfg, prefix_embeds, kv_cache=cache,
            kv_write_index=jnp.asarray(0, jnp.int32), use_cache=True,
            last_logits_only=True,
            act_int8=act_int8_prefill,
        )
    else:
        logits_last, cache = llada_model.forward(
            pre_p, cfg, prefix_embeds, use_cache=True,
            last_logits_only=True,
            act_int8=act_int8_prefill,
        )
    first = jnp.argmax(logits_last[:, -1], axis=-1).astype(jnp.int32)  # [B]
    x = jnp.full((B, G), mask_id, jnp.int32)
    x = x.at[:, 0].set(first)
    positions = jnp.arange(P, P + G, dtype=jnp.int32)

    def step(carry, ctl):
        x, cache, key = carry
        k_i, p_i = ctl
        key, ks, kt = jax.random.split(key, 3)
        mask_index = x == mask_id
        embeds = llada_model.embed_tokens(params, x)
        if unrolled:
            logits, cache = llada_model.forward(
                params, cfg, embeds, positions=positions, kv_cache=cache,
                kv_write_index=P, use_cache=True,
            )
        else:
            logits, _ = llada_model.forward(
                params, cfg, embeds, positions=positions, kv_cache=cache,
            )
        # AR shift (generation_utils.py:470-473)
        logits = jnp.concatenate([logits[:, :1], logits[:, :-1]], axis=1)
        x = _commit_step(x, logits, mask_index, k_i, p_i, ks, kt,
                         alg, alg_temp, temperature, top_p, top_k)
        return (x, cache, key), None

    (x, _, _), _ = jax.lax.scan(step, (x, cache, key), (k_table, p_transfer))
    return x


def _dream_hooked(
    params, cfg, prefix_embeds, k_table, p_transfer, key, G,
    gen: DreamGenerationConfig,
    tokens_hook, logits_hook, verbose,
):
    """Host-side step loop applying the reference's generation hooks:
    `generation_tokens_hook_func` / `generation_logits_hook_func`
    (generation_utils.py:308-309; applied at :451 before the loop, :473
    on the shifted logits, :516 after each commit).  Hooks are arbitrary
    python callables, so this path steps OUTSIDE jit between denoise
    steps — the fused scan (`_dream_fused`) is a single traced
    executable and cannot call back into python; use it (hooks=None)
    for serving.  Token-identical to the fused path under identity
    hooks (same key-split order, shared `_commit_step`)."""
    tokens_hook = tokens_hook or (lambda step, x, logits: x)
    logits_hook = logits_hook or (lambda step, x, logits: logits)
    B, P, _ = prefix_embeds.shape
    mask_id = cfg.mask_token_id
    logits_last, cache = llada_model.forward(
        params, cfg, prefix_embeds, use_cache=True,
        last_logits_only=True,
    )
    first = jnp.argmax(logits_last[:, -1], axis=-1).astype(jnp.int32)
    x = jnp.full((B, G), mask_id, jnp.int32).at[:, 0].set(first)
    # pre-loop token control (generation_utils.py:451)
    x = jnp.asarray(tokens_hook(None, x, None), jnp.int32)
    positions = jnp.arange(P, P + G, dtype=jnp.int32)
    history = []
    for i in range(int(k_table.shape[0])):
        key, ks, kt = jax.random.split(key, 3)
        mask_index = x == mask_id
        embeds = llada_model.embed_tokens(params, x)
        logits, _ = llada_model.forward(
            params, cfg, embeds, positions=positions, kv_cache=cache,
        )
        logits = jnp.concatenate([logits[:, :1], logits[:, :-1]], axis=1)
        logits = logits_hook(i, x, logits)
        x = _commit_step(
            x, logits, mask_index, k_table[i], p_transfer[i], ks, kt,
            gen.alg, gen.alg_temp, gen.temperature, gen.top_p, gen.top_k,
        )
        x = jnp.asarray(tokens_hook(i, x, logits), jnp.int32)
        if verbose:
            history.append(np.asarray(x))
    return (x, history) if verbose else x


def dream_generate(
    params,
    cfg: LLaDAConfig,
    prefix_embeds: jax.Array,
    gen: DreamGenerationConfig,
    *,
    key: Optional[jax.Array] = None,
    tokens_hook=None,
    logits_hook=None,
    verbose: bool = False,
    prefill_params=None,
    act_int8_prefill: bool = False,
):
    """Generate via the Dream sampler. Returns [B, max_new_tokens] ids
    (or (ids, history) when verbose).

    tokens_hook(step, x, logits) / logits_hook(step, x, logits): the
    reference's public sampler extension surface
    (generation_utils.py:308-309).  Passing either (or verbose) routes
    through the host-side step loop — the fused single-executable scan
    cannot call back into python mid-trace.

    prefill_params / act_int8_prefill: mixed-precision serving (int8
    weights + A8 prefill, `params` for the bandwidth-bound decode)
    — same split as the LLaDA fused body (diffusion.py)."""
    assert gen.prefix_lm, "Dream non-cached path: use prefix_lm=True (the "\
        "reference eval configs always do; run_dream.sh:13)"
    if key is None:
        key = jax.random.PRNGKey(0)
    G = gen.max_new_tokens
    timesteps, ks, steps = build_dream_schedule(gen, G)
    t = timesteps[:steps]
    s = timesteps[1 : steps + 1]
    p_transfer = (1.0 - s / t).astype(np.float32)
    if steps > 0:
        p_transfer[-1] = 1.0  # final step commits everything (origin)
    if tokens_hook is not None or logits_hook is not None or verbose:
        if prefill_params is not None or act_int8_prefill:
            raise NotImplementedError(
                "mixed-precision prefill is only wired on the fused "
                "Dream path — drop hooks/verbose or the mixed flags")
        return _dream_hooked(
            params, cfg, prefix_embeds,
            jnp.asarray(ks, jnp.int32), jnp.asarray(p_transfer), key, G,
            gen,
            tokens_hook, logits_hook, verbose,
        )
    return _dream_fused(
        params, cfg, prefix_embeds,
        jnp.asarray(ks, jnp.int32), jnp.asarray(p_transfer), key, G,
        alg=gen.alg, alg_temp=gen.alg_temp, temperature=gen.temperature,
        top_p=gen.top_p, top_k=gen.top_k,
        prefill_params=prefill_params, act_int8_prefill=act_int8_prefill,
    )
