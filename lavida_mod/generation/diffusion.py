"""Masked-diffusion generation: the jitted denoise loop.

Re-designs the reference sampler (llava/model/language_model/llada/generate.py:
117-346) around XLA's compilation model instead of translating it:

  - The per-step transfer counts depend only on the *initial* mask layout of
    each block (drafts included), so the whole `[total_steps]` control table —
    per-step k, block end, active-block flag — is precomputed on the host
    (ops/schedules.py) and fed to one jitted `lax.scan` over all
    blocks × steps.  No host↔device sync anywhere in the loop; the reference
    syncs every step for its python `torch.topk` loop and `continue` check.
  - The prefix KV cache (generate.py:174-181) is built by one prefill forward
    and carried in HBM as a `[L, B, P, Hkv, hd]` pytree with *rotated* keys
    (see models/llada.py) — no per-step re-rotation of the prefix.
  - The reference's early `continue` when a block is already filled
    (generate.py:226-227) becomes k=0 no-op steps — identical state
    trajectory, fixed shape.
  - Remasking confidences / gumbel / top-k transfer are the fixed-shape ops
    in ops/sampling.py (f32 instead of the reference's f64 — accelerators
    have no fast f64; at temperature 0, every published benchmark config,
    the sampling path is exact argmax either way).

Two modes, matching generate.py:
  prefix_lm=True  — prompt+image encoded once into the cache; x is the
                    gen-length buffer only (generate.py:174-181).
  prefix_lm=False — every step forwards [prefix_embeds, wte(x_gen)]
                    concatenated (generate.py:258-272); logits sliced to the
                    gen region.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GenerationConfig, LLaDAConfig
from ..models import llada as llada_model
from ..ops import sampling
from ..ops.schedules import num_transfer_tokens_scheduled, resolve_steps


def prefill(
    params,
    cfg: LLaDAConfig,
    prefix_embeds: jax.Array,
    prefix_valid: Optional[jax.Array] = None,
    act_int8: bool = False,
):
    """Encode the multimodal prefix once, returning the rotated-key KV cache
    (reference generate.py:176: `model(..., use_cache=True).attn_key_values`).
    """
    _, cache = llada_model.forward(
        params, cfg, prefix_embeds,
        self_valid=prefix_valid,
        use_cache=True, return_logits=False, act_int8=act_int8,
    )
    return cache


def build_control_table(
    x0_host: np.ndarray,
    prompt_len: int,
    gen_length: int,
    gen: GenerationConfig,
    mask_id: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Precompute the per-step control arrays for the whole generation.

    x0_host: [B, prompt_len + gen_length] (or [B, gen_length] when
    prompt_len == 0) initial token buffer *after* draft injection.
    Returns (k_table [total_steps, B] int32, block_end [total_steps] int32)
    where block_end is absolute in x coordinates (prompt included).
    """
    x0_host = np.asarray(x0_host)
    B = x0_host.shape[0]
    num_blocks, steps = resolve_steps(
        gen_length, gen.block_length, gen.steps, gen.step_per_block,
        gen.step_ratio,
    )
    k_cols: list[np.ndarray] = []
    end_cols: list[int] = []
    for b in range(num_blocks):
        lo = prompt_len + b * gen.block_length
        hi = prompt_len + (b + 1) * gen.block_length
        counts = (x0_host[:, lo:hi] == mask_id).sum(axis=1)
        if counts.max() == 0:
            continue  # fully drafted block: reference continues every step
        table = num_transfer_tokens_scheduled(
            counts, steps, gen.schedule, shift=gen.schedule_shift
        )  # [B, steps']
        if table.shape[1] < steps:  # pad with no-op steps (ref early-continue)
            pad = np.zeros((B, steps - table.shape[1]), np.int64)
            table = np.concatenate([table, pad], axis=1)
        for i in range(steps):
            k_cols.append(table[:, i])
            end_cols.append(hi)
    if not k_cols:  # everything drafted
        return np.zeros((0, B), np.int32), np.zeros((0,), np.int32)
    return (
        np.stack(k_cols).astype(np.int32),
        np.asarray(end_cols, np.int32),
    )


def _generate_cached_fused_body(
    params,
    cfg: LLaDAConfig,
    x: jax.Array,
    prefix_embeds: jax.Array,
    k_table: jax.Array,
    block_end: jax.Array,
    prefix_valid: Optional[jax.Array],
    key: jax.Array,
    temperature: float,
    remasking: str,
    act_int8_prefill: bool = False,
    decode_params=None,
    kv8: bool = False,
):
    """Prefill + full denoise loop as ONE executable: a single dispatch per
    image, no intermediate host round-trips (the reference pays a python
    step loop with per-step topk syncs; we pay one dispatch).

    decode_params: optional separate weight tree for the denoise scan —
    the mixed-precision serving layout (int8 prefill; int4 decode for
    half the bandwidth-bound weight reads)."""
    dec_p = decode_params if decode_params is not None else params
    B, P, _ = prefix_embeds.shape
    G = x.shape[1]
    positions = jnp.arange(P, P + G, dtype=jnp.int32)
    if (isinstance(params["blocks"], (list, tuple))
            and isinstance(dec_p["blocks"], (list, tuple))):
        # PREALLOCATED padded cache: prefill writes its K/V rows directly
        # into [B, P+G] buffers (kv_write_index=0), so the decode scan
        # starts with zero re-stack/pad copies (otherwise the whole
        # ~550 MB 8B prefix cache is copied once to pad it).
        # Prefill attention sees the G unwritten rows masked via the
        # filled-rows mask that kv_write_index installs.
        S = P + G
        Hkv, hd = cfg.effective_n_kv_heads, cfg.head_dim
        z = jnp.zeros((B, S, Hkv, hd), prefix_embeds.dtype)
        cache_l = [(z, z) for _ in params["blocks"]]
        kvv = None
        if prefix_valid is not None:
            kvv = jnp.concatenate(
                [prefix_valid, jnp.ones((B, G), bool)], axis=1)
        _, cache_l = llada_model.forward(
            params, cfg, prefix_embeds, kv_cache=cache_l,
            kv_write_index=jnp.asarray(0, jnp.int32), kv_valid=kvv,
            self_valid=prefix_valid,
            use_cache=True, return_logits=False,
            act_int8=act_int8_prefill,
        )
        return _denoise_scan_cached_body(
            dec_p, cfg, x, cache_l, k_table, block_end, positions,
            prefix_valid, key, temperature, remasking, kv8=kv8,
        )
    _, cache = llada_model.forward(
        params, cfg, prefix_embeds,
        self_valid=prefix_valid,
        use_cache=True, return_logits=False,
        act_int8=act_int8_prefill,
    )
    return _denoise_scan_cached_body(
        dec_p,
        cfg, x, cache, k_table, block_end, positions,
        prefix_valid, key, temperature, remasking, kv8=kv8,
    )


_generate_cached_fused = jax.jit(
    _generate_cached_fused_body,
    static_argnames=("cfg", "temperature", "remasking",
                     "act_int8_prefill", "kv8"),
)


def _denoise_scan_cached_body(
    params,
    cfg: LLaDAConfig,
    x: jax.Array,               # [B, G] token buffer (gen region only)
    cache,                      # prefix KV cache
    k_table: jax.Array,         # [S, B]
    block_end: jax.Array,       # [S] absolute end (prompt coords; here ==gen)
    positions: jax.Array,       # [G] absolute positions of gen tokens
    prefix_valid: Optional[jax.Array],
    key: jax.Array,
    temperature: float,
    remasking: str,
    kv8: bool = False,
    return_cache: bool = False,
):
    # return_cache=True: also return the final scan-carry cache so a
    # DONATED input cache has an output to alias — without an aliasable
    # output XLA rejects the donation ("donated buffers were not usable")
    # and the while-loop carry double-buffers the merged [B, P+G] cache
    # (+4.96G at B=8/8B).  Only meaningful on the bf16 prealloc-list
    # path; kv8 re-quantizes into differently-shaped buffers nothing can
    # alias.
    mask_id = cfg.mask_token_id
    B, G = x.shape

    if isinstance(params["blocks"], (list, tuple)):
        # WRITE-INDEX decode: the cache is (or becomes) a per-layer list
        # of [B, P+G] buffers and the gen K/V are written in place every
        # step — the concat path copies the whole 1056-row prefix per
        # layer per step (~1.3GB/step of pure memcpy at 8B scale).
        if isinstance(cache, (list, tuple)):
            # PREALLOCATED [B, P+G] buffers from the fused prefill
            # (_generate_cached_fused_body / _chunk_prefill_prealloc):
            # no stack/pad copies needed.  kv8 quantizes HERE, at decode
            # entry (see generate_chunked_prefill)
            P = cache[0][0].shape[1] - G
            if kv8:
                from ..ops.kv8_attention import quantize_kv

                bits = 4 if kv8 == 4 else 8
                cache_l = []
                for kf, vf in cache:
                    k8, ks = quantize_kv(kf, bits)
                    v8, vs = quantize_kv(vf, bits)
                    cache_l.append((k8, ks, v8, vs))
            else:
                cache_l = list(cache)
        elif kv8:
            # int8 KV cache (serving): per-(head, position) symmetric
            # quantization — halves the ~570 MB/step of cache reads
            # (ops/kv8_attention)
            P = cache["k"].shape[2]
            from ..ops.kv8_attention import quantize_kv

            bits = 4 if kv8 == 4 else 8

            def q8pad(a):
                q, s = quantize_kv(a, bits)
                return (jnp.pad(q, ((0, 0), (0, 0), (0, G), (0, 0))),
                        jnp.pad(s, ((0, 0), (0, 0), (0, 0), (0, G)),
                                constant_values=1.0))
            cache_l = []
            for li in range(cache["k"].shape[0]):
                k8, ks = q8pad(cache["k"][li])
                v8, vs = q8pad(cache["v"][li])
                cache_l.append((k8, ks, v8, vs))
        else:
            P = cache["k"].shape[2]
            cache_l = [
                (
                    jnp.pad(cache["k"][li],
                            ((0, 0), (0, G), (0, 0), (0, 0))),
                    jnp.pad(cache["v"][li],
                            ((0, 0), (0, G), (0, 0), (0, 0))),
                )
                for li in range(cache["k"].shape[0])
            ]
        kv_valid = None
        if prefix_valid is not None:
            kv_valid = jnp.concatenate(
                [prefix_valid, jnp.ones((B, G), bool)], axis=1
            )

        def step_w(carry, ctl):
            x, cache_l, key = carry
            k_row, b_end = ctl
            key, sk = jax.random.split(key)
            embeds = llada_model.embed_tokens(params, x)
            logits, cache_l = llada_model.forward(
                params, cfg, embeds,
                positions=positions, kv_cache=cache_l, kv_valid=kv_valid,
                kv_write_index=P, use_cache=True,
            )
            x = sampling.denoise_commit(
                x, logits, x == mask_id, k_row, b_end,
                temperature=temperature, remasking=remasking, key=sk,
            )
            return (x, cache_l, key), None

        (x, cache_f, _), _ = jax.lax.scan(
            step_w, (x, cache_l, key), (k_table, block_end)
        )
        return (x, cache_f) if return_cache else x

    def step(carry, ctl):
        x, key = carry
        k_row, b_end = ctl
        key, sk = jax.random.split(key)
        embeds = llada_model.embed_tokens(params, x)
        logits, _ = llada_model.forward(
            params, cfg, embeds,
            positions=positions, kv_cache=cache, kv_valid=prefix_valid,
        )
        x = sampling.denoise_commit(
            x, logits, x == mask_id, k_row, b_end,
            temperature=temperature, remasking=remasking, key=sk,
        )
        return (x, key), None

    (x, _), _ = jax.lax.scan(step, (x, key), (k_table, block_end))
    # read-only cache here: returning it unchanged gives the donated
    # input an identity-aliased output
    return (x, cache) if return_cache else x


_denoise_scan_cached = jax.jit(
    _denoise_scan_cached_body,
    static_argnames=("cfg", "temperature", "remasking",
                     "kv8", "return_cache"),
)

# Donated-cache variant for the chunked-prefill batched path: the merged
# [B, P+G] cache is a scan CARRY (gen K/V written in place every step),
# and without donation XLA must preserve the non-donated input buffer —
# a second full cache copy (4.96G bf16 at B=8/8B adapter geometry,
# S=1184).  NOT for _generate_verbose, which reuses the same cache
# across step calls.
_denoise_scan_cached_donated = jax.jit(
    _denoise_scan_cached_body,
    static_argnames=("cfg", "temperature", "remasking",
                     "kv8", "return_cache"),
    donate_argnums=(3,),
)


@functools.partial(jax.jit, static_argnames=("cfg", "act_int8"),
                   donate_argnums=(0,))
def _prefill_into(buf, params, cfg, embeds, valid, lo, act_int8=False):
    """Prefill one chunk and write its cache into the merged buffer at
    batch offset `lo` (traced: one compile serves every chunk)."""
    part = prefill(params, cfg, embeds, valid, act_int8)
    return jax.tree.map(
        lambda b, p: jax.lax.dynamic_update_slice_in_dim(
            b, p.astype(b.dtype), lo, axis=1),
        buf, part)

# NOTE on memory at large B: the denoise scan pads the cache to [P+G],
# which cannot alias the input buffer (shape grows), so donation is a
# no-op there; the OOM headroom comes from _prefill_into writing chunk
# caches into ONE merged buffer in place (donated, same-shape).


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _alloc_kv_buffers(nL, B, S, Hkv, hd, dt):
    """nL (k, v) zero buffers of [B, S, Hkv, hd] in ONE dispatch.
    Module-level jit so repeat calls at the same geometry hit the jit
    cache (a fresh lambda per call re-traces every request)."""
    return [(jnp.zeros((B, S, Hkv, hd), dt),
             jnp.zeros((B, S, Hkv, hd), dt)) for _ in range(nL)]


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "act_int8"),
    donate_argnums=(0,),
)
def _chunk_prefill_prealloc(buf, params, cfg, embeds, valid, lo,
                            act_int8=False):
    """Prefill one chunk into fresh [chunk, P+G] buffers
    (kv_write_index=0; the G gen rows stay zero and masked) and write
    them into the DONATED merged [B, P+G] buffers at batch offset `lo`.
    The merged tree is already decode-shaped, so _denoise_scan_cached
    starts with zero pad copies — at B=8/8B the [B,P]->[B,P+G] pad was a
    second ~4.6G cache that spilled (see generate_chunked_prefill)."""
    C, P = embeds.shape[0], embeds.shape[1]
    S = buf[0][0].shape[1]
    Hkv, hd = cfg.effective_n_kv_heads, cfg.head_dim
    zc = jnp.zeros((C, S, Hkv, hd), embeds.dtype)
    chunk_cache = [(zc, zc) for _ in buf]
    kvv = None
    if valid is not None:
        kvv = jnp.concatenate(
            [valid, jnp.ones((C, S - P), bool)], axis=1)
    _, chunk_cache = llada_model.forward(
        params, cfg, embeds, kv_cache=chunk_cache,
        kv_write_index=jnp.asarray(0, jnp.int32), kv_valid=kvv,
        self_valid=valid, use_cache=True, return_logits=False,
        act_int8=act_int8,
    )
    return jax.tree.map(
        lambda b, p: jax.lax.dynamic_update_slice_in_dim(
            b, p.astype(b.dtype), lo, axis=0),
        buf, chunk_cache)


def generate_chunked_prefill(
    params,
    cfg: LLaDAConfig,
    prefix_embeds: jax.Array,   # [B, P, D]
    gen: GenerationConfig,
    *,
    chunk: int = 4,
    prefix_valid: Optional[jax.Array] = None,
    key: Optional[jax.Array] = None,
    kv8: bool = False,
    prefill_params=None,
    act_int8_prefill: bool = False,
):
    """Large-batch serving: prefill in fixed `chunk`-size slices (ONE
    compile, reused, and peak activation memory bounded by the chunk),
    then run the denoise scan over the MERGED batch.
    Decode is weight-read-bound, so only the batched denoise amortizes —
    chunking the compute-bound prefill costs nothing.  The reference has
    no batched serving path at all (its eval adapter loops batch=1,
    llava_llada.py:556-650).

    prefill_params / act_int8_prefill: mixed-precision split — the int8
    tree runs the chunked prefills, `params` the merged denoise scan."""
    pre_p = prefill_params if prefill_params is not None else params
    B, P, _ = prefix_embeds.shape
    chunk = min(chunk, B)
    # Non-divisible batches (B=5,7,...) run the LAST chunk as an
    # overlapping window ending at B: prefill is deterministic, so
    # rewriting a few already-filled rows reproduces identical cache
    # values, and the cost is ONE extra chunk call instead of falling
    # back to chunk=1.
    starts = list(range(0, B - chunk + 1, chunk))
    if starts[-1] + chunk < B:
        starts.append(B - chunk)
    G = gen.max_new_tokens
    mask_id = cfg.mask_token_id
    if key is None:
        key = jax.random.PRNGKey(0)

    # prefill each chunk and write it into the merged buffer in place
    # (buffer donated per call): peak extra memory is ONE chunk cache,
    # not the full per-chunk list + concat copy (at 8B/B=8 the merged
    # cache is ~5GB)
    if (isinstance(params["blocks"], (list, tuple))
            and isinstance(pre_p["blocks"], (list, tuple))):
        # PREALLOCATED [B, P+G] merged buffers (the serve-path prealloc,
        # _generate_cached_fused_body): each chunk prefills into its own
        # [chunk, P+G] buffers (kv_write_index=0), which land in the
        # merged tree at batch offset lo.  Without this the decode scan
        # pads [B,P]->[B,P+G] — a second full-size cache copy (~4.6G
        # bf16 at B=8/8B).
        S = P + G
        Hkv, hd = cfg.effective_n_kv_heads, cfg.head_dim
        nL = len(params["blocks"])
        dt = prefix_embeds.dtype
        # DISTINCT buffers per layer/slot, allocated in ONE dispatch: a
        # single zeros() aliased 2L times trips "donate the same buffer
        # twice" in _chunk_prefill_prealloc.
        # kv8 quantizes at DECODE entry (inside _denoise_scan_cached),
        # not at chunk-write time, so the merged buffers keep one
        # layout across dispatches.  Cost: the bf16 merged cache stays
        # pinned as an argument beside its quantized copy.
        cache = _alloc_kv_buffers(nL, B, S, Hkv, hd, dt)
        for lo in starts:
            cache = _chunk_prefill_prealloc(
                cache, pre_p, cfg, prefix_embeds[lo:lo + chunk],
                prefix_valid[lo:lo + chunk] if prefix_valid is not None
                else None,
                jnp.int32(lo), act_int8=act_int8_prefill)
    else:
        shapes = jax.eval_shape(
            lambda p, e, v: prefill(p, cfg, e, v,
                                    act_int8=act_int8_prefill),
            pre_p, prefix_embeds[:chunk],
            prefix_valid[:chunk] if prefix_valid is not None else None)
        cache = jax.tree.map(
            lambda s: jnp.zeros(s.shape[:1] + (B,) + s.shape[2:], s.dtype),
            shapes)
        for lo in starts:
            cache = _prefill_into(
                cache, pre_p, cfg, prefix_embeds[lo:lo + chunk],
                prefix_valid[lo:lo + chunk] if prefix_valid is not None
                else None,
                jnp.int32(lo), act_int8=act_int8_prefill)

    x = jnp.full((B, G), mask_id, jnp.int32)
    k_table, block_end = build_control_table(
        np.asarray(x), 0, G, gen, mask_id)
    if k_table.shape[0] == 0:
        return x
    positions = jnp.arange(P, P + G, dtype=jnp.int32)
    # Donate + return the cache only when the carry keeps the donated
    # buffers' shapes (bf16 prealloc path): under kv8 the carry is
    # re-quantized into differently-shaped buffers, so there is nothing
    # to alias — donation would just warn and the extra output would
    # materialize a copy instead of saving one
    if kv8:
        return _denoise_scan_cached(
            params, cfg, x, cache,
            jnp.asarray(k_table), jnp.asarray(block_end), positions,
            prefix_valid, key,
            temperature=gen.temperature, remasking=gen.remasking,
            kv8=kv8,
        )
    x, _ = _denoise_scan_cached_donated(
        params, cfg, x, cache,
        jnp.asarray(k_table), jnp.asarray(block_end), positions,
        prefix_valid, key,
        temperature=gen.temperature, remasking=gen.remasking,
        kv8=False, return_cache=True,
    )
    return x


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "temperature", "remasking"),
)
def _denoise_scan_full(
    params,
    cfg: LLaDAConfig,
    x: jax.Array,               # [B, G]
    prefix_embeds: jax.Array,   # [B, P, D] (re-spliced every step, ref :268)
    k_table: jax.Array,
    block_end: jax.Array,       # [S] absolute end including prompt length
    prefix_valid: Optional[jax.Array],
    key: jax.Array,
    temperature: float,
    remasking: str,
):
    mask_id = cfg.mask_token_id
    B, G = x.shape
    P = prefix_embeds.shape[1]

    def step(carry, ctl):
        x, key = carry
        k_row, b_end = ctl
        key, sk = jax.random.split(key)
        gen_embeds = llada_model.embed_tokens(params, x)
        embeds = jnp.concatenate([prefix_embeds, gen_embeds], axis=1)
        sv = None
        if prefix_valid is not None:
            sv = jnp.concatenate(
                [prefix_valid, jnp.ones((B, G), bool)], axis=1
            )
        logits, _ = llada_model.forward(
            params, cfg, embeds, self_valid=sv,
        )
        logits = logits[:, P:]
        x = sampling.denoise_commit(
            x, logits, x == mask_id, k_row, b_end - P,
            temperature=temperature, remasking=remasking, key=sk,
        )
        return (x, key), None

    (x, _), _ = jax.lax.scan(step, (x, key), (k_table, block_end))
    return x


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "recompute", "temperature", "remasking"),
)
def _generate_dllm_fused(
    params,
    cfg: LLaDAConfig,
    x: jax.Array,               # [1, G]
    prefix_embeds: jax.Array,   # [1, P, D]
    k_table: jax.Array,         # [S, 1]
    block_end: jax.Array,       # [S]
    prefix_valid,
    key: jax.Array,
    recompute: int,
    temperature: float,
    remasking: str,
):
    """dLLM-Cache-style denoising (PAPERS.md; reference hot loop
    llada/generate.py:221-311 recomputes every gen token every step):

    Per-layer K/V and final logits are carried across steps; each step
    re-forwards only `recompute` tokens — tokens committed last step (their
    embedding changed, so their cached K/V is stale by construction) plus
    the stalest still-masked tokens — scattering fresh K/V and logits into
    the caches.  Untouched tokens keep cached features/logits, bounding
    divergence by the refresh pressure (recompute >= G reproduces the
    exact scan, tested).  Pays off once the step is compute-bound
    (G >~ 128): per-step FLOPs drop by G/recompute while weight reads stay
    constant.  B=1 (the serving latency path)."""
    B, G = x.shape
    assert B == 1, "dLLM cache path is the B=1 serving latency path"
    P = prefix_embeds.shape[1]
    mask_id = cfg.mask_token_id
    r = min(recompute, G)

    _, cache = llada_model.forward(
        params, cfg, prefix_embeds,
        self_valid=prefix_valid,
        use_cache=True, return_logits=False,
    )
    # pad the prefix cache to P+G in whichever layout the block params use
    # (list of per-layer tuples for unrolled serving params, stacked dict
    # for scanned params)
    if isinstance(cache, list):
        cache_l = [
            (jnp.pad(k, ((0, 0), (0, G), (0, 0), (0, 0))),
             jnp.pad(v, ((0, 0), (0, G), (0, 0), (0, 0))))
            for k, v in cache
        ]
    else:
        cache_l = {
            "k": jnp.pad(cache["k"], ((0, 0), (0, 0), (0, G), (0, 0), (0, 0))),
            "v": jnp.pad(cache["v"], ((0, 0), (0, 0), (0, G), (0, 0), (0, 0))),
        }
    kv_valid = None
    if prefix_valid is not None:
        kv_valid = jnp.concatenate(
            [prefix_valid, jnp.ones((B, G), bool)], axis=1
        )
    positions_all = jnp.arange(P, P + G, dtype=jnp.int32)

    # init pass: full forward over G (write-index), seeding caches + logits
    logits_c, cache_l = llada_model.forward(
        params, cfg, llada_model.embed_tokens(params, x),
        positions=positions_all, kv_cache=cache_l, kv_valid=kv_valid,
        kv_write_index=P, use_cache=True,
    )
    logits_c = logits_c.astype(jnp.bfloat16)

    def step(carry, ctl):
        x, cache_l, logits_c, changed_prev, stale, key = carry
        k_row, b_end = ctl
        key, sk = jax.random.split(key)
        masked = x[0] == mask_id
        prio = (changed_prev[0].astype(jnp.float32) * 1e6
                + jnp.where(masked, stale, -1e6))
        _, pos = jax.lax.top_k(prio, r)
        embeds = llada_model.embed_tokens(params, x[:, pos])
        logits_r, cache_l = llada_model.forward(
            params, cfg, embeds,
            positions=P + pos, kv_cache=cache_l, kv_valid=kv_valid,
            kv_scatter_idx=P + pos, use_cache=True,
        )
        logits_c = logits_c.at[:, pos].set(logits_r.astype(logits_c.dtype))
        x_new = sampling.denoise_commit(
            x, logits_c.astype(jnp.float32), x == mask_id, k_row, b_end,
            temperature=temperature, remasking=remasking, key=sk,
        )
        changed = x_new != x
        fresh = jnp.zeros((G,), bool).at[pos].set(True)
        stale = jnp.where(fresh, 0.0, stale + 1.0)
        return (x_new, cache_l, logits_c, changed, stale, key), None

    stale0 = jnp.zeros((G,), jnp.float32)
    changed0 = jnp.zeros((B, G), bool)
    (x, *_), _ = jax.lax.scan(
        step, (x, cache_l, logits_c, changed0, stale0, key),
        (k_table, block_end),
    )
    return x


def generate(
    params,
    cfg: LLaDAConfig,
    prefix_embeds: jax.Array,
    gen: GenerationConfig,
    *,
    draft_tokens: Optional[jax.Array] = None,
    prefix_valid: Optional[jax.Array] = None,
    key: Optional[jax.Array] = None,
    act_int8_prefill: bool = False,
    dllm_cache: Optional[int] = None,
    verbose: bool = False,
    kv8: bool = False,
    decode_params=None,
):
    """Generate `gen.max_new_tokens` tokens after the given prefix embeddings.

    prefix_embeds: [B, P, D] — already-spliced multimodal prompt embeddings
    (the analogue of generate.py's `inputs_embeds`).
    draft_tokens: [B, Td] FIM skeleton written into the head of the gen
    buffer (generate.py:189-191); `mask_id` holes get denoised.
    decode_params: mixed-precision serving — `params` (int8 + A8) runs the
    compute-bound prefill, `decode_params` (int4 fused layout) the
    bandwidth-bound denoise scan (fused non-verbose path only).
    Returns x: [B, gen_length] tokens (prompt never included, matching the
    prefix_lm return shape; the non-cache path slices it off).
    When verbose, returns (x, history list of [B, gen_length] snapshots).
    """
    B, P, _ = prefix_embeds.shape
    G = gen.max_new_tokens
    mask_id = cfg.mask_token_id
    if key is None:
        key = jax.random.PRNGKey(0)

    x = jnp.full((B, G), mask_id, jnp.int32)
    if draft_tokens is not None:
        Td = draft_tokens.shape[1]
        assert Td <= G
        x = x.at[:, :Td].set(draft_tokens.astype(jnp.int32))

    if gen.prefix_lm:
        prompt_len = 0  # x holds only the gen region (generate.py:178-181)
        k_table, block_end = build_control_table(
            np.asarray(x), prompt_len, G, gen, mask_id
        )
        if k_table.shape[0] == 0:
            return (x, []) if verbose else x
        if dllm_cache is not None:
            # loud, not silent: these combinations have no implementation —
            # falling through would silently drop the flag and misreport
            # what was measured (flags checked BEFORE the verbose branch)
            if kv8 or act_int8_prefill or decode_params is not None:
                raise NotImplementedError(
                    "kv8 / act_int8_prefill / mixed decode_params are not "
                    "implemented for the dLLM partial-recompute path; "
                    "drop --kv8/--mixed or --dllm")
            if verbose:
                raise NotImplementedError(
                    "verbose history is not implemented for the dLLM "
                    "partial-recompute path; drop --dllm or verbose")
            return _generate_dllm_fused(
                params, cfg, x, prefix_embeds,
                jnp.asarray(k_table), jnp.asarray(block_end),
                prefix_valid, key,
                recompute=int(dllm_cache),
                temperature=gen.temperature, remasking=gen.remasking,
            )
        if not verbose:
            return _generate_cached_fused(
                params, cfg, x, prefix_embeds,
                jnp.asarray(k_table), jnp.asarray(block_end),
                prefix_valid, key,
                temperature=gen.temperature, remasking=gen.remasking,
                act_int8_prefill=act_int8_prefill, kv8=kv8,
                decode_params=decode_params,
            )
        if kv8 or act_int8_prefill or decode_params is not None:
            raise NotImplementedError(
                "kv8 / act_int8_prefill / mixed decode_params are only "
                "wired on the fused non-verbose path; drop --kv8/--mixed "
                "or verbose")
        cache = prefill(params, cfg, prefix_embeds, prefix_valid)
        positions = jnp.arange(P, P + G, dtype=jnp.int32)
        args = (
            params, cfg, x, cache,
            jnp.asarray(k_table), jnp.asarray(block_end), positions,
            prefix_valid, key,
        )
        return _generate_verbose(args, gen, cached=True)
    else:
        if decode_params is not None:
            raise NotImplementedError(
                "mixed decode_params needs the prefix-cache mode "
                "(prefix_lm=True) — the no-cache path has no "
                "prefill/decode split")
        prompt_len = P
        # Control table is computed in absolute coordinates: a virtual
        # [B, P+G] buffer whose prefix is never masked.
        x_abs = np.concatenate(
            [np.zeros((B, P), np.int32), np.asarray(x)], axis=1
        )
        k_table, block_end = build_control_table(
            x_abs, prompt_len, G, gen, mask_id
        )
        if k_table.shape[0] == 0:
            return (x, []) if verbose else x
        args = (
            params, cfg, x, prefix_embeds,
            jnp.asarray(k_table), jnp.asarray(block_end),
            prefix_valid, key,
        )
        if not verbose:
            return _denoise_scan_full(
                *args, temperature=gen.temperature, remasking=gen.remasking,
            )
        return _generate_verbose(args, gen, cached=False)


def _generate_verbose(args, gen: GenerationConfig, cached: bool):
    """Non-scan debug path: python step loop capturing x after every step
    (reference `verbose=True` history, generate.py:211-213, 334-341)."""
    if cached:
        (params, cfg, x, cache, k_table, block_end, positions,
         prefix_valid, key) = args
    else:
        (params, cfg, x, prefix_embeds, k_table, block_end,
         prefix_valid, key) = args
    history = []
    for i in range(k_table.shape[0]):
        kt = k_table[i : i + 1]
        be = block_end[i : i + 1]
        if cached:
            x = _denoise_scan_cached(
                params, cfg, x, cache, kt, be, positions, prefix_valid, key,
                temperature=gen.temperature, remasking=gen.remasking,
            )
        else:
            x = _denoise_scan_full(
                params, cfg, x, prefix_embeds, kt, be, prefix_valid, key,
                temperature=gen.temperature, remasking=gen.remasking,
            )
        key, _ = jax.random.split(key)
        history.append(np.asarray(x))
    return x, history
