"""LLaDA: bidirectional (non-causal) diffusion-LM transformer.

A functional re-design of the reference's OLMo-style model
(llava/model/language_model/llada/modeling_llada.py) — not a port:

  - parameters are a plain pytree with every per-layer tensor stacked along a
    leading `n_layers` axis, and the layer stack runs as one `lax.scan` —
    single trace/compile regardless of depth, remat-friendly, and the natural
    layout for GSPMD sharding;
  - the KV cache stores *rotated* keys.  The reference caches un-rotated keys
    and re-applies RoPE to the full concatenated K every denoising step
    (modeling_llada.py:738-749); positions are absolute, so rotating once at
    cache-write time is mathematically identical and removes a per-step
    O(P·d) recompute (verified by tests/test_llada_parity.py);
  - attention is non-causal (modeling_llada.py:677-684), GQA without
    materializing repeated K/V, with an optional prefix-LM block mask
    (modeling_llada.py:1358-1364) expressed as a boolean mask.

Block layouts supported (modeling_llada.py:809-999):
  - "llama":      separate q/k/v projections; SwiGLU as silu(ff_proj)·up_proj
  - "sequential": fused att_proj; activation chunks its input (SwiGLU)
"""

from __future__ import annotations

import math
from typing import Any, Optional

import jax
import jax.numpy as jnp

from ..config import LLaDAConfig
from ..ops.attention import attention, blockwise_attention, make_mask
from ..ops.norms import apply_norm
from ..ops.quant import linear, linear_act_int8, quantize_linear
from ..ops.rope import apply_rope, rope_tables

Params = dict


# ---------------------------------------------------------------------------
# Initialization (for tests / training-from-scratch; real weights come from
# the checkpoint converter in llada_loader.py)
# ---------------------------------------------------------------------------

def init_params(cfg: LLaDAConfig, key: jax.Array, dtype=jnp.float32) -> Params:
    E, D, L = cfg.num_embeddings, cfg.d_model, cfg.n_layers
    H = cfg.hidden_size
    kvD = cfg.effective_n_kv_heads * cfg.head_dim
    keys = iter(jax.random.split(key, 16))

    def dense(k, shape, std=0.02):
        # sample directly in the target dtype — f32 temporaries for the
        # stacked 8B tensors would transiently double HBM use
        return jax.random.normal(k, shape, dtype) * jnp.asarray(std, dtype)

    def norm_p(shape):
        p = {"weight": jnp.ones(shape, dtype)}
        return p

    blocks: dict[str, Any] = {
        "attn_norm": norm_p((L, D)),
        "ff_norm": norm_p((L, D)),
        "attn_out": {"kernel": dense(next(keys), (L, D, D))},
    }
    if cfg.block_type == "llama":
        blocks.update(
            q_proj={"kernel": dense(next(keys), (L, D, D))},
            k_proj={"kernel": dense(next(keys), (L, D, kvD))},
            v_proj={"kernel": dense(next(keys), (L, D, kvD))},
            ff_proj={"kernel": dense(next(keys), (L, D, H))},
            up_proj={"kernel": dense(next(keys), (L, D, H))},
            ff_out={"kernel": dense(next(keys), (L, H, D))},
        )
        if cfg.include_qkv_bias:
            # Qwen2-family attention bias (zero-init; the HF converter
            # fills real values)
            for nm, od in (("q_proj", D), ("k_proj", kvD),
                           ("v_proj", kvD)):
                blocks[nm]["bias"] = jnp.zeros((L, od), dtype)
    elif cfg.block_type == "sequential":
        ff_out_in = H // 2 if cfg.activation == "swiglu" else H
        blocks.update(
            att_proj={"kernel": dense(next(keys), (L, D, D + 2 * kvD))},
            ff_proj={"kernel": dense(next(keys), (L, D, H))},
            ff_out={"kernel": dense(next(keys), (L, ff_out_in, D))},
        )
        if cfg.include_qkv_bias:
            blocks["att_proj"]["bias"] = jnp.zeros((L, D + 2 * kvD),
                                                   dtype)
    else:
        raise NotImplementedError(cfg.block_type)
    if cfg.attention_layer_norm:
        blocks["q_norm"] = norm_p((L, D))
        blocks["k_norm"] = norm_p((L, kvD))

    params: Params = {
        "wte": dense(next(keys), (E, D)),
        "ln_f": norm_p((D,)),
        "blocks": blocks,
    }
    if not cfg.weight_tying:
        params["ff_out"] = {"kernel": dense(next(keys), (D, E))}
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _act(cfg: LLaDAConfig, x: jax.Array) -> jax.Array:
    a = cfg.activation
    if a == "silu":
        return jax.nn.silu(x)
    if a == "gelu":
        return jax.nn.gelu(x, approximate=False)
    if a == "relu":
        return jax.nn.relu(x)
    if a == "swiglu":
        # reference SwiGLU chunks (x, gate) and returns silu(gate) * x
        # (modeling_llada.py:499-506)
        xx, gate = jnp.split(x, 2, axis=-1)
        return jax.nn.silu(gate) * xx
    raise NotImplementedError(a)


def _block(
    cfg: LLaDAConfig,
    x: jax.Array,
    p: Params,
    *,
    sin: jax.Array,
    cos: jax.Array,
    positions: jax.Array,
    mask: Optional[jax.Array],
    layer_past: Optional[tuple[jax.Array, jax.Array]],
    kv_write_index: Optional[jax.Array] = None,
    kv_scatter_idx: Optional[jax.Array] = None,
    act_int8: bool = False,
    blockwise_args: Optional[dict] = None,
    kv8_valid: Optional[jax.Array] = None,
):
    """One transformer block. x: [B, T, D]. Returns (x, (k_rot, v))."""
    B, T, D = x.shape
    Hq, Hkv, hd = cfg.n_heads, cfg.effective_n_kv_heads, cfg.head_dim
    nt = cfg.layer_norm_type
    lin = linear_act_int8 if act_int8 else linear

    if cfg.block_type == "llama":
        h = apply_norm(x, p["attn_norm"], nt, rms_eps=cfg.rms_norm_eps,
                       ln_eps=cfg.layer_norm_eps)
        q = lin(h, p["q_proj"])
        k = lin(h, p["k_proj"])
        v = lin(h, p["v_proj"])
    else:
        h = apply_norm(x, p["attn_norm"], nt, rms_eps=cfg.rms_norm_eps,
                       ln_eps=cfg.layer_norm_eps)
        qkv = lin(h, p["att_proj"])
        q, k, v = jnp.split(qkv, [D, D + Hkv * hd], axis=-1)

    # optional q/k layernorm on the flattened projections (modeling_llada.py:726-728)
    if cfg.attention_layer_norm:
        q = apply_norm(q, p["q_norm"], nt, rms_eps=cfg.rms_norm_eps,
                       ln_eps=cfg.layer_norm_eps).astype(x.dtype)
        k = apply_norm(k, p["k_norm"], nt, rms_eps=cfg.rms_norm_eps,
                       ln_eps=cfg.layer_norm_eps).astype(x.dtype)

    q = q.reshape(B, T, Hq, hd)
    k = k.reshape(B, T, Hkv, hd)
    v = v.reshape(B, T, Hkv, hd)

    if cfg.rope:
        q = apply_rope(q, positions, sin, cos, cfg.rope_full_precision)
        k = apply_rope(k, positions, sin, cos, cfg.rope_full_precision)

    present = (k, v)
    kv8 = layer_past is not None and len(layer_past) == 4
    if kv8:
        # int8 KV decode (serving): cache = (k8, ks, v8, vs) in the
        # head-major layout of ops/kv8_attention.py.  Quantize this
        # step's rows in place, then attend over the quantized cache —
        # half the per-step KV reads of the bf16 cache.
        from ..ops.kv8_attention import kv8_decode_attention, write_rows

        assert kv_write_index is not None
        present = write_rows(*layer_past, k, v, kv_write_index)
        att = kv8_decode_attention(q, *present, kv_valid=kv8_valid)
    elif layer_past is not None:
        pk, pv = layer_past
        if kv_scatter_idx is not None:
            # non-contiguous in-place cache update (dLLM-style partial
            # recompute): this call's T tokens live at arbitrary cache
            # positions kv_scatter_idx [T]
            k = pk.at[:, kv_scatter_idx].set(k.astype(pk.dtype))
            v = pv.at[:, kv_scatter_idx].set(v.astype(pv.dtype))
            present = (k, v)
        elif kv_write_index is not None:
            # fixed-size cache buffers: write in place (AR decode path)
            k = jax.lax.dynamic_update_slice(
                pk, k.astype(pk.dtype), (0, kv_write_index, 0, 0)
            )
            v = jax.lax.dynamic_update_slice(
                pv, v.astype(pv.dtype), (0, kv_write_index, 0, 0)
            )
            present = (k, v)
        else:
            k = jnp.concatenate([pk, k], axis=1)
            v = jnp.concatenate([pv, v], axis=1)

    if kv8:
        pass  # att computed above
    elif blockwise_args is not None:
        att = blockwise_attention(q, k, v, **blockwise_args)
    else:
        att = attention(q, k, v, mask)
    att = att.reshape(B, T, D)
    x = x + lin(att, p["attn_out"])

    h2 = apply_norm(x, p["ff_norm"], nt, rms_eps=cfg.rms_norm_eps,
                    ln_eps=cfg.layer_norm_eps)
    if "moe" in p:
        # mixture-of-experts FF (mixtral / qwen_moe AR baselines)
        from .moe import moe_ff

        ff, _ = moe_ff(h2, p["moe"])
        x = x + ff
        return x, present
    if cfg.block_type == "llama":
        ff = _act(cfg, lin(h2, p["ff_proj"])) * lin(h2, p["up_proj"])
    else:
        ff = _act(cfg, lin(h2, p["ff_proj"]))
    x = x + lin(ff, p["ff_out"])
    return x, present


_REMAT_POLICIES = ("dots_nobatch", "dots")


def _remat_group(remat) -> int:
    """Map an activation-checkpointing strategy to the remat group size.

    Reference strategies (modeling_llada.py:189-203): whole_layer (save
    each layer boundary, recompute inside the layer) and one_in_{2,3,4}
    (remat every Nth layer, keep the other N-1 layers' activations).

    Accepted values: False / True / "whole_layer" / policy names -> 1;
    "one_in_N" or int N -> N.

    NOTE (compiled memory analysis): the literal one_in_N translation is a
    torch-idiomatic knob that backfires under lax.scan — slicing per-group
    weight stacks makes layout copies that can exceed the activation
    saving.  The scan-friendly way to hit intermediate memory/compute points
    is a rematerialization POLICY on the scanned layer ("dots_nobatch",
    "dots"): measured temp bytes on the tiny-8L config form a clean ladder
    whole_layer 9.4M < dots_nobatch 19.3M < dots 28.7M < none 58.2M with
    no weight copies.  one_in_N remains available for strict parity.
    """
    if remat in (False, True, None, "whole_layer", "nested") \
            or remat in _REMAT_POLICIES:
        return 1
    if isinstance(remat, str) and remat.startswith("one_in_"):
        return int(remat.split("_")[-1])
    if isinstance(remat, int):
        return remat
    raise ValueError(f"unknown activation-checkpointing strategy: {remat!r}")


def _remat_policy(remat):
    """Checkpoint policy for the scanned layer body (see _remat_group)."""
    pol = jax.checkpoint_policies
    if remat == "dots_nobatch":
        return pol.dots_with_no_batch_dims_saveable
    if remat == "dots":
        return pol.dots_saveable
    return pol.nothing_saveable


def forward(
    params: Params,
    cfg: LLaDAConfig,
    embeds: jax.Array,
    *,
    positions: Optional[jax.Array] = None,
    kv_cache: Optional[dict] = None,
    kv_valid: Optional[jax.Array] = None,
    self_valid: Optional[jax.Array] = None,
    prefix_lengths: Optional[jax.Array] = None,
    use_cache: bool = False,
    return_logits: bool = True,
    last_logits_only: bool = False,
    causal: bool = False,
    kv_write_index: Optional[jax.Array] = None,
    kv_scatter_idx: Optional[jax.Array] = None,
    act_int8: bool = False,
    attention_impl: str = "dense",
    kv_block: int = 1024,
    remat: "bool | str | int" = False,
):
    """Run the transformer on input embeddings.

    embeds: [B, T, D] (the caller embeds tokens / splices vision features).
    positions: [T] absolute positions for RoPE (default arange(T) + past_len
      where past_len is taken from kv_cache).
    kv_cache: {"k","v"}: [L, B, P, Hkv, hd] rotated-key cache, or None.
    kv_valid: [B, P] bool mask over cached positions (padding-aware decode).
    self_valid: [B, T] bool mask over current tokens.
    prefix_lengths: [B] enables the prefix-LM block mask for training
      (modeling_llada.py:1351-1368).
    use_cache: return this call's (k, v) per layer (stacked) as a new cache.
    causal: standard causal masking — the legacy AR-LLaVA baseline path
      (llava_llama/llava_qwen, SURVEY.md §2.1); LaViDa itself is non-causal.
    kv_write_index: AR decode — kv_cache holds FIXED-size buffers
      [L, B, Smax, Hkv, hd]; this call's k/v are written at
      [write, write+T) in place and attention masks positions >= write+T.
    attention_impl: "dense" — one masked attention call per layer
      (ops/attention.attention picks the kernel for the backend);
      "blockwise" — online softmax over `kv_block`-key blocks, which never
      builds a [T, S] mask (long training sequences).

    Returns (logits [B,T,V] or hidden [B,T,D], new_cache or None).
    """
    B, T, D = embeds.shape
    cache_is_list = isinstance(kv_cache, (list, tuple))
    cache_is_kv8 = cache_is_list and len(kv_cache[0]) == 4
    if kv_cache is None:
        past_len = 0
    elif cache_is_kv8:
        past_len = kv_cache[0][0].shape[2]   # k8 [B, H, S, hd]
    elif cache_is_list:
        past_len = kv_cache[0][0].shape[1]
    else:
        past_len = kv_cache["k"].shape[2]
    if kv_scatter_idx is not None:
        assert kv_cache is not None and positions is not None, (
            "scattered cache updates need explicit RoPE positions"
        )
        S = past_len
    elif kv_write_index is not None:
        assert kv_cache is not None
        S = past_len            # buffer size; this call writes inside it
        if positions is None:
            positions = kv_write_index + jnp.arange(T, dtype=jnp.int32)
    else:
        S = past_len + T
        if positions is None:
            positions = jnp.arange(past_len, past_len + T, dtype=jnp.int32)
    sin, cos = rope_tables(
        cfg.head_dim, max(cfg.max_sequence_length, S), cfg.rope_theta
    )

    x = embeds
    if cfg.input_emb_norm:
        x = x * math.sqrt(cfg.d_model)

    # boolean mask from padding + prefix-LM / causal structure
    kv_pos = jnp.arange(S, dtype=jnp.int32)
    valid = None
    if kv_scatter_idx is not None:
        valid = kv_valid  # caller owns the mask in scattered mode
    elif kv_write_index is not None:
        filled = (kv_pos < kv_write_index + T)[None]
        valid = jnp.broadcast_to(filled, (B, S))
        if kv_valid is not None:
            valid = valid & kv_valid
    elif kv_valid is not None or self_valid is not None:
        pv = kv_valid if kv_valid is not None else jnp.ones((B, past_len), bool)
        sv = self_valid if self_valid is not None else jnp.ones((B, T), bool)
        valid = jnp.concatenate([pv, sv], axis=1) if past_len else sv
    # the prefix-LM / causal masks are about SEQUENCE structure, so they
    # use sequence indices — NOT the RoPE `positions`, which training may
    # shift (use_pos_skipping) without changing who attends to whom
    if kv_scatter_idx is not None:
        mask_q_pos = kv_scatter_idx
    elif kv_write_index is not None:
        mask_q_pos = kv_write_index + jnp.arange(T, dtype=jnp.int32)
    else:
        mask_q_pos = jnp.arange(past_len, past_len + T, dtype=jnp.int32)
    blockwise_args = None
    mask = None
    if attention_impl == "blockwise":
        assert not causal
        blockwise_args = dict(
            kv_valid=valid, prefix_lengths=prefix_lengths,
            q_positions=mask_q_pos, kv_block=kv_block,
        )
    else:
        assert attention_impl == "dense", attention_impl
        mask = make_mask(
            kv_valid=valid,
            prefix_lengths=prefix_lengths,
            q_positions=mask_q_pos if prefix_lengths is not None else None,
            kv_positions=kv_pos if prefix_lengths is not None else None,
        )
    if causal:
        cmask = (mask_q_pos.reshape(1, 1, -1, 1)
                 >= kv_pos.reshape(1, 1, 1, -1))
        mask = cmask if mask is None else mask & cmask

    block_params = params["blocks"]

    if isinstance(block_params, (list, tuple)):
        # Unrolled per-layer path (inference/serving): each layer's
        # weights and cache are their own buffers, so the decode step
        # updates every layer's cache in place and no stacked weight is
        # sliced.
        presents_list = []
        for li, layer_p in enumerate(block_params):
            lp = None
            if kv_cache is not None:
                lp = (kv_cache[li] if cache_is_list
                      else (kv_cache["k"][li], kv_cache["v"][li]))
            x, present = _block(
                cfg, x, layer_p,
                sin=sin, cos=cos, positions=positions, mask=mask,
                layer_past=lp,
                kv_write_index=kv_write_index,
                kv_scatter_idx=kv_scatter_idx, act_int8=act_int8,
                blockwise_args=blockwise_args,
                kv8_valid=valid if cache_is_kv8 else None,
            )
            if use_cache:
                presents_list.append(present)
        if not use_cache:
            presents = None
        elif cache_is_list or kv_write_index is not None \
                or kv_scatter_idx is not None:
            # per-layer list layout: lets XLA update each layer's buffer
            # in place instead of restacking (decode hot path)
            presents = presents_list
        else:
            presents = (jnp.stack([p[0] for p in presents_list]),
                        jnp.stack([p[1] for p in presents_list]))
    else:
        def layer_fn(carry, scanned):
            h = carry
            layer_p, layer_past = scanned
            h, present = _block(
                cfg, h, layer_p,
                sin=sin, cos=cos, positions=positions, mask=mask,
                layer_past=layer_past,
                kv_write_index=kv_write_index,
                kv_scatter_idx=kv_scatter_idx, act_int8=act_int8,
                blockwise_args=blockwise_args,
            )
            return h, present if use_cache else None

        scanned = (block_params, None if kv_cache is None
                   else (kv_cache["k"], kv_cache["v"]))
        if remat == "nested":
            # sqrt-checkpointing: outer scan over G CHECKPOINTED groups
            # whose body is an inner scan of CHECKPOINTED layers.  Both
            # levels must be rematted: with only the group checkpointed,
            # the bwd recompute of one group differentiates a plain inner
            # scan, which stacks every inner layer's residuals (incl. the
            # f32 [H, T, S] dense-attention scores) simultaneously — AOT
            # shows a single 34 GB f32[L/G, .., T, S] buffer at the 8B
            # stage-2 shapes.  Double-level remat keeps only ~G + L/G
            # boundary activations + ONE layer's internals (12+1 instead
            # of 32+1 at 8B), for ~one more forward of recompute than
            # whole_layer.
            L = jax.tree.leaves(block_params)[0].shape[0]
            G = next(g for g in (8, 4, 2, 1)
                     if L % g == 0 and L // g >= g) if L >= 4 else 1
            grouped = jax.tree.map(
                lambda a: a.reshape((G, L // G) + a.shape[1:]), scanned)

            ckpt_layer = jax.checkpoint(layer_fn, prevent_cse=False)

            def group_fn(h, g):
                return jax.lax.scan(ckpt_layer, h, g)

            x, presents = jax.lax.scan(
                jax.checkpoint(group_fn, prevent_cse=False), x, grouped)
            if use_cache:
                presents = jax.tree.map(
                    lambda a: a.reshape((L,) + a.shape[2:]), presents)
        elif _remat_group(remat) > 1:
            group = _remat_group(remat)
            # one_in_N checkpointing (modeling_llada.py:189-203): remat
            # only every Nth layer — the other N-1 layers keep their
            # activations (less recompute than whole_layer, more memory).
            # Expressed as an outer scan over L/N groups whose body runs
            # one rematted layer followed by a plain inner scan.
            L = jax.tree.leaves(block_params)[0].shape[0]
            assert L % group == 0, (
                f"activation_checkpointing one_in_{group} needs n_layers "
                f"({L}) divisible by {group}"
            )
            ckpt_layer = jax.checkpoint(layer_fn, prevent_cse=False)
            group_presents = []
            for gi in range(L // group):
                first = jax.tree.map(lambda a: a[gi * group], scanned)
                rest = jax.tree.map(
                    lambda a: a[gi * group + 1:(gi + 1) * group], scanned
                )
                x, p0 = ckpt_layer(x, first)
                x, ps = jax.lax.scan(layer_fn, x, rest)
                if use_cache:
                    group_presents.append(jax.tree.map(
                        lambda a, b: jnp.concatenate([a[None], b], axis=0),
                        p0, ps,
                    ))
            presents = None
            if use_cache:
                presents = jax.tree.map(
                    lambda *gs: jnp.concatenate(gs, axis=0), *group_presents
                )
        else:
            if remat:
                layer_fn = jax.checkpoint(
                    layer_fn, policy=_remat_policy(remat), prevent_cse=False
                )
            x, presents = jax.lax.scan(layer_fn, x, scanned)

    new_cache = None
    if use_cache:
        new_cache = (presents if isinstance(presents, list)
                     else {"k": presents[0], "v": presents[1]})

    if not return_logits:
        x = apply_norm(x, params["ln_f"], cfg.layer_norm_type,
                       rms_eps=cfg.rms_norm_eps, ln_eps=cfg.layer_norm_eps)
        return x, new_cache

    if last_logits_only:
        x = x[:, -1:]  # modeling_llada.py:1426 last_logits_only

    x = apply_norm(x, params["ln_f"], cfg.layer_norm_type,
                   rms_eps=cfg.rms_norm_eps, ln_eps=cfg.layer_norm_eps)
    if cfg.weight_tying:
        logits = jnp.einsum("btd,vd->btv", x, params["wte"],
                            preferred_element_type=jnp.float32)
    else:
        logits = linear(x, params["ff_out"], preferred=jnp.float32)
    if cfg.scale_logits:
        logits = logits * (1.0 / math.sqrt(cfg.d_model))
    return logits, new_cache


def embed_tokens(params: Params, ids: jax.Array) -> jax.Array:
    """wte lookup (modeling_llada.py:1283)."""
    return params["wte"][ids]


def to_fused_layout(params: Params, cfg: LLaDAConfig) -> tuple[Params, LLaDAConfig]:
    """Convert llama-layout blocks (separate q/k/v + gate/up) into the
    fused "sequential" layout the core already executes: att_proj =
    [q|k|v], ff_proj = [up|gate] consumed by the swiglu chunking
    (silu(gate) * up == llama's silu(ff_proj) * up_proj).  Halves the
    matmul count per block (7 -> 4) — bigger contiguous weight reads for
    the bandwidth-bound decode.  Exact logits equivalence is tested."""
    assert cfg.block_type == "llama"
    blocks = params["blocks"]
    is_list = isinstance(blocks, (list, tuple))
    layers = blocks if is_list else [blocks]

    def fuse_layer(b):
        nb = {k: v for k, v in b.items()
              if k in ("attn_norm", "ff_norm", "q_norm", "k_norm",
                       "attn_out", "ff_out", "moe")}
        assert "kernel" in b["q_proj"], "fuse before quantization"
        nb["att_proj"] = {"kernel": jnp.concatenate(
            [b["q_proj"]["kernel"], b["k_proj"]["kernel"],
             b["v_proj"]["kernel"]], axis=-1)}
        if "bias" in b["q_proj"]:
            nb["att_proj"]["bias"] = jnp.concatenate(
                [b["q_proj"]["bias"], b["k_proj"]["bias"],
                 b["v_proj"]["bias"]], axis=-1)
        nb["ff_proj"] = {"kernel": jnp.concatenate(
            [b["up_proj"]["kernel"], b["ff_proj"]["kernel"]], axis=-1)}
        return nb

    new_blocks = [fuse_layer(b) for b in layers] if is_list else fuse_layer(blocks)
    new_cfg = cfg.replace(
        block_type="sequential", activation="swiglu",
        mlp_hidden_size=2 * cfg.hidden_size,
    )
    return {**params, "blocks": new_blocks}, new_cfg


def serving_block_layout(params: Params, cfg: LLaDAConfig,
                         bits: Optional[int]) -> tuple[Params, LLaDAConfig]:
    """The one block-layout rule of every serving entry point: a tree
    about to be quantized to int4 takes the fused layout (to_fused_layout,
    token-exact; 4 matmuls per block instead of 7); int8 and bf16 trees
    keep the llama layout.  Call before quantize_params."""
    if bits == 4 and cfg.block_type == "llama":
        return to_fused_layout(params, cfg)
    return params, cfg


def resize_token_embeddings(
    params: Params, new_size: int, init: str = "mean"
) -> Params:
    """Grow (or shrink) the embedding table and untied head, initializing
    new rows to the mean of existing embeddings — the reference's
    initialize_vision_tokenizer behavior when special tokens are added
    (llava_arch.py:912-952; predict.py:36-39 resize+tie after load)."""
    out = dict(params)
    wte = params["wte"]
    old = wte.shape[0]
    if new_size <= old:
        out["wte"] = wte[:new_size]
    else:
        if init == "mean":
            fill = jnp.broadcast_to(
                wte.astype(jnp.float32).mean(axis=0, keepdims=True),
                (new_size - old, wte.shape[1]),
            ).astype(wte.dtype)
        else:
            fill = jnp.zeros((new_size - old, wte.shape[1]), wte.dtype)
        out["wte"] = jnp.concatenate([wte, fill], axis=0)
    if "ff_out" in params and "kernel" in params["ff_out"]:
        head = params["ff_out"]["kernel"]          # [D, V]
        if new_size <= head.shape[1]:
            out["ff_out"] = {**params["ff_out"],
                             "kernel": head[:, :new_size]}
        else:
            if init == "mean":
                hfill = jnp.broadcast_to(
                    head.astype(jnp.float32).mean(axis=1, keepdims=True),
                    (head.shape[0], new_size - head.shape[1]),
                ).astype(head.dtype)
            else:
                hfill = jnp.zeros(
                    (head.shape[0], new_size - head.shape[1]), head.dtype
                )
            out["ff_out"] = {**params["ff_out"],
                             "kernel": jnp.concatenate([head, hfill], axis=1)}
    return out


def unstack_blocks(params: Params) -> Params:
    """Stacked [L, ...] blocks dict -> list of per-layer dicts (the
    inference layout: python-unrolled layers, no scan layout copies)."""
    blocks = params["blocks"]
    if isinstance(blocks, (list, tuple)):
        return params
    L = jax.tree.leaves(blocks)[0].shape[0]
    out = [jax.tree.map(lambda a: a[i], blocks) for i in range(L)]
    return {**params, "blocks": out}


def quantize_params(params: Params, bits: int = 8,
                    group: int = 128, consume: bool = False,
                    progress=None) -> Params:
    """Quantize every linear kernel (ops/quant.py); norms, embeddings and
    biases stay bf16.  bits=8: per-channel int8 (near-lossless).  bits=4:
    grouped int4 weights (a quarter of the bf16 weight bytes); ~1% logit
    rel-err, gate per checkpoint with scripts/verify_checkpoint.py.  int4
    requires unstacked blocks; kernels whose in-dim breaks the scale
    grouping fall back to int8.  Plain jnp, so jax.eval_shape traces it."""
    from ..ops.quant import quantize_linear4

    # consume=True: clear each source linear dict once quantized so the
    # full-precision kernels free incrementally — holding the bf16 tree
    # alive across the whole quantize doubles peak memory at 8B
    def quant_one(d):
        if bits == 8 or d["kernel"].shape[-2] % group != 0:
            q = quantize_linear(d)
        else:
            q = quantize_linear4(d, group)
        if consume and q is not d:
            d.clear()
        return q

    def quant_tree(d):
        if isinstance(d, (list, tuple)):
            return type(d)(quant_tree(x) for x in d)
        if isinstance(d, dict):
            if "kernel" in d:
                return quant_one(d)
            return {k: quant_tree(v) for k, v in d.items()}
        return d

    if bits == 4:
        assert isinstance(params["blocks"], (list, tuple)), (
            "int4 needs unstacked blocks: quantize_params("
            "unstack_blocks(p), bits=4)"
        )
    out = dict(params)
    if progress is not None and isinstance(params["blocks"], (list, tuple)):
        # per-block walk so `progress(i, n, quantized_block)` can log and
        # e.g. block_until_ready to bound in-flight host->device copies
        qb = []
        n = len(params["blocks"])
        for i, b in enumerate(params["blocks"]):
            qb.append(quant_tree(b))
            progress(i, n, qb[-1])
        out["blocks"] = type(params["blocks"])(qb)
    else:
        out["blocks"] = quant_tree(params["blocks"])
    if "ff_out" in params:
        out["ff_out"] = quant_one(params["ff_out"])
    return out
