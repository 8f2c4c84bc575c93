#!/usr/bin/env python
"""Benchmark: LaViDa-LLaDA s/image on one GPU.

Reproduces the reference's headline latency protocol (README.md:62-68,
BASELINE.md): single image, HD anyres prompt (5 SigLIP views -> ~1000-token
prefix), generation length 32, 16 denoising steps, prefix KV cache on.
Wall-clock covers everything model.generate covers in the reference:
vision encode + projection + pooling + prefill + the 16-step denoise loop
(eval adapter llava_llada.py:646-649 measures the same span).

Weights are zeros at the exact 8B/so400m geometry — latency is
weight-value independent.  Each timed call ends in block_until_ready after
a warm-up call that compiles.  Fails without a GPU.  Prints the device,
then ONE json line; vs_baseline is (reference 1.32 s on an A100) / (ours),
so > 1.0 means faster than the reference's published number.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np

BASELINE_S = 1.32        # A100 LaViDa-LLaDA s/image, len 32, 16 steps
BASELINE_DREAM_S = 1.13  # A100 LaViDa-Dream (README.md:62-68)
# cache-off protocol rows (README.md:87-93): 50% NFE 3.57s, 100% 6.65s
BASELINE_NOCACHE = {0.5: 3.57, 1.0: 6.65}
BASELINE_AR_S = 1.67    # LLaVA-1.6-7B AR COCO row (README.md:93)
REPEATS = 10            # timed calls after the warm-up call (median)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1,
                    help="throughput mode: decode N images per dispatch "
                         "(decode is weight-bandwidth-bound, so batching "
                         "amortizes the weight reads)")
    ap.add_argument("--layout", choices=["bf16", "int8", "int4"],
                    default="int4",
                    help="LM weight layout: bf16, per-channel int8, or "
                         "grouped int4 (ops/quant.py); gate quantized "
                         "layouts per checkpoint with "
                         "scripts/verify_checkpoint.py")
    fam = ap.add_mutually_exclusive_group()
    fam.add_argument("--dream", action="store_true",
                     help="LaViDa-Dream family (7B Qwen2 geometry, "
                          "topk_margin sampler per run_dream.sh) instead "
                          "of LaViDa-LLaDA; reference baseline 1.13 s/image")
    fam.add_argument("--ar", action="store_true",
                     help="autoregressive LLaVA-1.6-7B-geometry baseline "
                          "(vicuna-7b causal LM, 32-token cached decode) — "
                          "the reference's AR comparison row (COCO table: "
                          "1.67 s/image, README.md:93)")
    ap.add_argument("--gen-len", type=int, default=32,
                    help="generation length (headline protocol: 32)")
    ap.add_argument("--steps", type=int, default=16,
                    help="denoising steps (headline protocol: 16)")
    ap.add_argument("--no-cache", action="store_true",
                    help="prefix KV cache OFF (full-sequence recompute "
                         "per denoise step) — the reference's cache-off "
                         "protocol rows (BASELINE.md: 6.65s at 100%% NFE, "
                         "3.57s at 50%%)")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-precision serving: per-channel int8 LM "
                         "weights + int8 activations for the compute-"
                         "bound prefill, the --layout tree for the "
                         "bandwidth-bound decode")
    ap.add_argument("--vision-int8", action="store_true",
                    help="int8 SigLIP tower weights + per-token int8 "
                         "activations; gate per checkpoint")
    ap.add_argument("--kv4", action="store_true",
                    help="int4 KV cache (a quarter of the bf16 cache "
                         "reads, ~3%% row rms err; quality-gate per "
                         "checkpoint with verify_checkpoint --kv4-check)")
    ap.add_argument("--kv8", action="store_true",
                    help="int8 KV cache (ops/kv8_attention.py): half the "
                         "per-step cache reads; quality-gate per checkpoint")
    ap.add_argument("--shirg", action="store_true",
                    help="SHIRG 2-view serving: global 448^2 pooled to "
                         "256 + foveal top-724 (980 vision tokens vs "
                         "anyres ~3.6k) — the reference's high-res token "
                         "selection path (models/shirg.py; reference "
                         "shirg/siglip_shirg.py:46-215)")
    ap.add_argument("--dllm", type=int, default=None,
                    help="dLLM-cache partial recompute size (tokens "
                         "re-forwarded per step; cached K/V + logits for "
                         "the rest); pays once gen-len is compute-bound")
    args = ap.parse_args()
    if args.kv4:
        if args.kv8:
            ap.error("--kv4 and --kv8 are exclusive")
        args.kv8 = 4          # kv-quant width rides the kv8 plumbing
    if args.dllm is not None and (args.kv8 or args.mixed):
        ap.error("--dllm has no kv8/mixed variant (the partial-recompute "
                 "path has no quantized scattered cache writes)")
    if args.shirg and (args.dream or args.ar or args.batch != 1
                       or args.no_cache or args.dllm is not None
                       or args.vision_int8):
        ap.error("--shirg rides the B=1 LLaDA fused serve path only "
                 "(and shirg_encode has no int8-tower activation "
                 "plumbing) — loud, not silently ignored")
    if (args.dream or args.ar) and args.kv8:
        ap.error("--kv8/--kv4 are only plumbed on the LLaDA denoise scan "
                 "(ops/kv8_attention.py) — loud, not silently ignored")
    if args.mixed and (args.ar or args.no_cache or args.dllm is not None):
        ap.error("--mixed needs the cached prefill/decode split (no AR, "
                 "--no-cache or --dllm variant) — loud, not silently "
                 "ignored")
    if args.no_cache:
        nfe = args.steps / args.gen_len
        if nfe not in BASELINE_NOCACHE:
            import sys
            print(f"warning: --no-cache NFE ratio {nfe:.2f} has no "
                  f"reference baseline row (rows: 0.5 -> 3.57 s, "
                  f"1.0 -> 6.65 s); vs_baseline will use the 50% row",
                  file=sys.stderr)

    from lavida_mod.utils import device
    from lavida_mod.utils.compile_cache import enable as enable_cache

    dev = device.require_gpu()
    enable_cache()
    import jax
    import jax.numpy as jnp

    from lavida_mod.config import GenerationConfig, LaViDaConfig
    from lavida_mod.generation import diffusion
    from lavida_mod.models import llada as llada_model
    from lavida_mod.models import multimodal
    from lavida_mod.models import siglip as siglip_model

    cfg = LaViDaConfig()
    if args.ar:
        from lavida_mod.config import LLaDAConfig
        from lavida_mod.generation.ar_sampler import ar_generate_fused

        # vicuna-7b geometry (the LLaVA-1.6-7B backbone)
        vicuna = LLaDAConfig(
            vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=32, mlp_hidden_size=11008, block_type="llama",
            activation="silu", max_sequence_length=4096,
        )
        cfg = LaViDaConfig(llada=vicuna)
    if args.dream:
        from lavida_mod.config import DreamGenerationConfig
        from lavida_mod.generation.dream_sampler import dream_generate
        from lavida_mod.models.dream import dream_7b_config

        cfg = LaViDaConfig(llada=dream_7b_config())

    bits = {"bf16": None, "int8": 8, "int4": 4}[args.layout]
    lm_cfg = cfg.llada

    def build(k):
        # the serving layout from shapes: every quantizer is plain jnp,
        # so jax.eval_shape traces it without materializing a weight
        nonlocal lm_cfg
        p = multimodal.init_params(cfg, k, jnp.bfloat16)
        lm = llada_model.unstack_blocks(p["llada"])
        lm, lm_cfg = llada_model.serving_block_layout(lm, cfg.llada, bits)
        pre = llada_model.quantize_params(lm, bits=8) if args.mixed else {}
        if bits:
            lm = llada_model.quantize_params(lm, bits=bits)
        p["llada"] = lm
        if args.vision_int8:
            p["siglip"] = siglip_model.quantize_tower(p["siglip"])
        return p, pre

    shapes = jax.eval_shape(build, jax.random.PRNGKey(0))
    params, prefill_llada = jax.jit(lambda: jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), shapes))()
    if not args.mixed:
        prefill_llada = None

    # HD anyres input: base + 4 tiles (the square (768,768) pinpoint)
    image_size = (640, 640)
    text_len = 48  # typical caption-prompt length
    rng = np.random.default_rng(0)
    text_ids = rng.integers(3, 30000, size=text_len)
    ids = np.concatenate([text_ids[:8], [-200], text_ids[8:]])

    gen = GenerationConfig(
        max_new_tokens=args.gen_len, block_length=args.gen_len,
        steps=None, step_per_block=args.steps,
        prefix_lm=not args.no_cache, remasking="low_confidence",
    )
    mask_id = lm_cfg.mask_token_id
    B = args.batch

    if B == 1 and args.dllm is None and not args.no_cache and not args.ar:
        # single-image path: ONE dispatch for the whole
        # vision->merge->splice->prefill->denoise chain
        gather_idx, text_ids_p, valid, _ = multimodal.build_gather_plan(
            cfg, [ids], [[5]], [[image_size]])
        gather_idx = jnp.asarray(gather_idx)
        text_ids_p = jnp.asarray(text_ids_p)
        x0 = np.full((1, args.gen_len), mask_id, np.int32)
        k_table, block_end = diffusion.build_control_table(
            x0, 0, args.gen_len, gen, mask_id)
        k_table = jnp.asarray(k_table)
        block_end = jnp.asarray(block_end)

        def decode(params, prefill_llada, prefix, key):
            if args.dream:
                dgen = DreamGenerationConfig(
                    max_new_tokens=args.gen_len, steps=args.steps,
                    alg="topk_margin", prefix_lm=True,  # run_dream.sh:13
                )
                return dream_generate(
                    params["llada"], lm_cfg, prefix, dgen, key=key,
                    prefill_params=prefill_llada,
                    act_int8_prefill=args.mixed)
            x = jnp.full((1, args.gen_len), mask_id, jnp.int32)
            if args.mixed:
                # int8 prefill weights + A8, --layout tree for decode
                return diffusion._generate_cached_fused_body(
                    prefill_llada, lm_cfg, x, prefix, k_table, block_end,
                    None, key, temperature=gen.temperature,
                    remasking=gen.remasking, act_int8_prefill=True,
                    decode_params=params["llada"], kv8=args.kv8)
            return diffusion._generate_cached_fused_body(
                params["llada"], lm_cfg, x, prefix, k_table, block_end,
                None, key, temperature=gen.temperature,
                remasking=gen.remasking, kv8=args.kv8)

        if args.shirg:
            from lavida_mod.models import shirg as shirg_model

            # prefill_llada MUST be an argument: closing over the int8
            # tree bakes it into the lowering as constants
            @jax.jit
            def serve(params, prefill_llada, views, key):
                block = shirg_model.shirg_encode(params, cfg, views)
                prefix, _ = multimodal.splice_embeddings(
                    params, cfg, ids, [block.astype(jnp.bfloat16)])
                return decode(params, prefill_llada, prefix[None], key)

            def one_batch(i):
                views = jnp.full((2, 3, 448, 448), 0.001 * i, jnp.bfloat16)
                return serve(params, prefill_llada, views,
                             jax.random.PRNGKey(i))
        else:
            @jax.jit
            def serve(params, prefill_llada, views, key):
                prefix = multimodal.multimodal_embeds(
                    params, cfg, views, text_ids_p, gather_idx,
                    vision_act_int8=args.vision_int8)
                return decode(params, prefill_llada, prefix, key)

            def one_batch(i):
                views = jnp.full((5, 3, 384, 384), 0.001 * i, jnp.bfloat16)
                return serve(params, prefill_llada, views,
                             jax.random.PRNGKey(i))
    else:
        def one_batch(i):
            views = jnp.full((5 * B, 3, 384, 384), 0.001 * i, jnp.bfloat16)
            feats = multimodal._encode_views_jit(
                params, cfg, views, False, True, args.vision_int8)
            D = feats.shape[-1]
            if B == 1:
                block = multimodal.merge_anyres(
                    feats, image_size, cfg.vision, params["image_newline"]
                )
                prefix, _ = multimodal.splice_embeddings(
                    params, cfg, ids, [block]
                )
                prefix = prefix[None]
            else:
                # identical merge geometry per image -> batched layout
                prefix = jnp.concatenate(
                    [feats.reshape(B, 5 * feats.shape[1], D),
                     jnp.zeros((B, len(ids), D), jnp.bfloat16)], axis=1
                )
            if args.ar:
                return ar_generate_fused(
                    params["llada"], lm_cfg, prefix,
                    jax.random.PRNGKey(i), max_new_tokens=args.gen_len)
            if args.dream:
                dgen = DreamGenerationConfig(
                    max_new_tokens=args.gen_len, steps=args.steps,
                    alg="topk_margin", prefix_lm=True,  # run_dream.sh:13
                )
                return dream_generate(
                    params["llada"], lm_cfg, prefix, dgen,
                    prefill_params=prefill_llada,
                    act_int8_prefill=args.mixed)
            if B > 4 and args.dllm is None and gen.prefix_lm:
                # prefill in 4-row chunks (one compile, overlapping last
                # chunk for non-divisible B), decode the merged batch
                return diffusion.generate_chunked_prefill(
                    params["llada"], lm_cfg, prefix, gen, chunk=4,
                    kv8=args.kv8, prefill_params=prefill_llada,
                    act_int8_prefill=args.mixed,
                )
            if args.mixed:
                # batched mixed split: int8+A8 prefill, --layout decode
                return diffusion.generate(
                    prefill_llada, lm_cfg, prefix, gen,
                    dllm_cache=args.dllm, kv8=args.kv8,
                    act_int8_prefill=True,
                    decode_params=params["llada"],
                )
            return diffusion.generate(
                params["llada"], lm_cfg, prefix, gen,
                dllm_cache=args.dllm, kv8=args.kv8,
            )

    # warm-up: compiles every executable the timed calls use
    t0 = time.perf_counter()
    jax.block_until_ready(one_batch(0))
    compile_s = time.perf_counter() - t0

    # inputs vary per call (views seeded with i)
    walls = []
    for i in range(1, REPEATS + 1):
        t0 = time.perf_counter()
        jax.block_until_ready(one_batch(i))
        walls.append(time.perf_counter() - t0)
    s_per_image = statistics.median(walls) / B

    tag = f"len{args.gen_len}_steps{args.steps}"
    print(f"device: {dev['platform']} {dev['kind']} x{dev['count']}; "
          f"card: {device.card_name_and_power_limit()}", flush=True)
    print(json.dumps({
        "metric": (
            (f"s_per_image_{tag}_hd" if B == 1
             else f"s_per_image_{tag}_hd_batch{B}")
            + f"_{args.layout}"
            + ("_mixed" if args.mixed else "")
            + ("_v8" if args.vision_int8 else "")
            + ("_kv4" if args.kv8 == 4 else "_kv8" if args.kv8 else "")
            + ("_shirg" if args.shirg else "")
            + ("_nocache" if args.no_cache else "")
            + ("_dream" if args.dream else "")
            + ("_ar" if args.ar else "")
            + (f"_dllm{args.dllm}" if args.dllm else "")
        ),
        "value": s_per_image,
        "unit": "s",
        "vs_baseline": (
            (BASELINE_NOCACHE.get(args.steps / args.gen_len, 3.57)
             if args.no_cache
             else BASELINE_AR_S if args.ar
             else BASELINE_DREAM_S if args.dream else BASELINE_S)
            / s_per_image),
        "walls_s": walls,
        "compile_s": compile_s,
        "device": dev,
    }))


if __name__ == "__main__":
    main()
