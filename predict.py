#!/usr/bin/env python
"""Single-image prediction CLI — the analogue of reference predict.py.

Usage:
  python predict.py --model-path /path/to/lavida-llada-hf \\
      --image images/demo.jpg --prompt "Describe the image." \\
      [--max-new-tokens 32] [--steps 16] [--no-prefix-cache] \\
      [--schedule shift --schedule-shift 0.33] [--step-ratio 0.5] \\
      [--aspect anyres|square] [--warmup]

Without --model-path: --tiny runs a random-initialized toy model; the full
8B geometry runs zero-initialized in the int8 serving layout — useful for
smoke/latency runs when no checkpoint is present.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--image", default=None)
    ap.add_argument("--prompt", default="Describe the image in detail.")
    ap.add_argument("--conv-template", default="llada")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--step-per-block", type=int, default=None)
    ap.add_argument("--step-ratio", type=float, default=None)
    ap.add_argument("--block-length", type=int, default=None)
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--schedule-shift", type=float, default=3.0)
    ap.add_argument("--remasking", default="low_confidence")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--aspect", default=None,
                    help="anyres|square; default: the checkpoint's "
                         "image_aspect_ratio (anyres without one)")
    ap.add_argument("--shirg", action="store_true",
                    help="SHIRG-Fovea 2-view token selection instead of anyres")
    ap.add_argument("--shirg-method", default="base")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--int4", action="store_true",
                    help="grouped-int4 LM weights (bench.py default): a "
                         "quarter of the bf16 weight bytes, ~1%% logit "
                         "rel-err — gate quality per checkpoint with "
                         "scripts/verify_checkpoint.py")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-precision serving (implies --int4): keep "
                         "an int8 LM tree + int8 activations for the "
                         "compute-bound prefill next to the int4 decode "
                         "tree; costs ~+7.5G device memory for the 8B "
                         "int8 tree")
    ap.add_argument("--kv4", action="store_true",
                    help="int4 KV cache (memory-headroom lever; gate with "
                         "scripts/verify_checkpoint.py --kv4-check)")
    ap.add_argument("--kv8", action="store_true",
                    help="int8 KV cache + decode attention over it (bench "
                         "--kv8; quality-gate per checkpoint with "
                         "scripts/verify_checkpoint.py --kv8-check)")
    ap.add_argument("--no-quant", action="store_true",
                    help="keep bf16 LM weights")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel bf16 serving over N devices "
                         "(implies --no-quant: zero quantization error; "
                         "col/row-paired GSPMD sharding, "
                         "parallel/sharding.py)")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--warmup", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-compile-cache", action="store_true",
                    help="disable the persistent XLA compilation cache "
                         "(JAX_COMPILATION_CACHE_DIR, else .jax_cache/ "
                         "in the checkout — 8B serve graphs take minutes "
                         "to compile cold)")
    args = ap.parse_args()

    if not args.no_compile_cache:
        from lavida_mod.utils.compile_cache import enable as _cc

        _cc()

    import jax.numpy as jnp

    from lavida_mod.config import (
        GenerationConfig, LaViDaConfig, VisionConfig,
        tiny_llada_config, tiny_siglip_config,
    )
    from lavida_mod.data import SigLIPImageProcessor, process_images
    from lavida_mod.data.conversation import get_conv_template
    from lavida_mod.data.prompts import tokenizer_image_token
    from lavida_mod.models.lavida import LaViDa

    dtype = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[args.dtype]

    if args.tiny:
        cfg = LaViDaConfig(
            llada=tiny_llada_config(),
            vision=VisionConfig(
                siglip=tiny_siglip_config(), mm_hidden_size=32,
                grid_pinpoints=((56, 112), (112, 56), (112, 112)),
                image_aspect_ratio=args.aspect or "anyres",
            ),
        )
    else:
        # geometry comes from the checkpoint's config.json when loading
        # (LaViDa.load sniffs it — builder.py:128-146); this default only
        # serves the no-checkpoint zero-init smoke path
        cfg = LaViDaConfig(
            vision=VisionConfig(image_aspect_ratio=args.aspect or "anyres")
        )

    if args.tp > 1:
        if args.int4 or args.mixed:
            raise SystemExit(
                "--tp is bf16 serving (quantized layouts have custom leaf "
                "structures the sharding rules don't cover); drop "
                "--int4/--mixed")
        if args.kv8 or args.kv4:
            # sharded generate with kv8/kv4 has no parity test — reject
            # rather than silently replicate the cache
            raise SystemExit("--tp is bf16 serving; drop --kv8/--kv4")
        args.no_quant = True

    if args.model_path:
        # host_staging: convert on CPU so the bf16 8B never occupies
        # device memory beside its quantized copy; .to_device() below
        # ships the final serving layout.  tp>1 also
        # stages: shard() then moves only 1/tp per device.
        model = LaViDa.load(
            args.model_path, cfg if args.tiny else None, dtype,
            host_staging=not args.tiny and (not args.no_quant
                                            or args.tp > 1))
        if args.aspect:  # explicit CLI override beats the checkpoint's
            model.cfg = model.cfg.replace(vision=model.cfg.vision.replace(
                image_aspect_ratio=args.aspect))
        from lavida_mod.data.tokenizer import load_hf_or_offline

        tokenizer = load_hf_or_offline(args.model_path)
    else:
        tokenizer = None
        if args.tiny:
            print("[predict] no --model-path: random-init tiny weights")
            model = LaViDa.random_init(cfg, args.seed, dtype)
        else:
            print("[predict] no --model-path: zero weights (latency smoke)")
            model = LaViDa.zero_init(cfg, dtype,
                                     quantized=not args.no_quant)

    if args.tp > 1:
        model.shard(tp=args.tp)

    if args.model_path and not args.tiny and not args.no_quant:
        if args.mixed:
            args.int4 = True  # the mixed split rides the int4 decode tree
        model.to_serving_layout(
            quant=("mixed" if args.mixed else
                   "int4" if args.int4 else "int8"))

    conv = get_conv_template(args.conv_template)
    if tokenizer is not None:
        conv.tokenizer = tokenizer

    # image
    images, image_sizes = [], []
    shirg_blocks = None
    if args.image:
        from PIL import Image

        img = Image.open(args.image)
        size = model.cfg.vision.siglip.image_size
        proc = SigLIPImageProcessor(size=size)
        if args.shirg:
            import jax.numpy as _jnp

            from lavida_mod.models.shirg import (
                process_shirg_2view, shirg_encode,
            )

            views = process_shirg_2view(img, proc)
            shirg_blocks = [shirg_encode(
                model.params, model.cfg, _jnp.asarray(views),
                method=args.shirg_method,
            )]
        else:
            views = process_images([img], proc, model.cfg.vision)[0]
            images, image_sizes = [views], [img.size]
        user_msg = "<image>\n" + args.prompt
    else:
        user_msg = args.prompt

    conv.append_message(conv.roles[0], user_msg)
    prompt = conv.get_prompt()

    if tokenizer is not None:
        input_ids = tokenizer_image_token(prompt, tokenizer)
    else:
        # no tokenizer: synthetic ids with the image marker
        rng = np.random.default_rng(args.seed)
        vocab = model.cfg.llada.vocab_size
        ids = rng.integers(3, min(vocab, 30000), size=24).tolist()
        input_ids = np.asarray(
            ids[:4] + ([-200] if args.image else []) + ids[4:], np.int64
        )

    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        block_length=(
            args.block_length
            if args.block_length
            else min(128, args.max_new_tokens)
        ),
        steps=args.steps,
        step_per_block=args.step_per_block,
        step_ratio=args.step_ratio,
        schedule=args.schedule,
        schedule_shift=args.schedule_shift,
        remasking=args.remasking,
        prefix_lm=not args.no_prefix_cache,
    )

    gen_kw = dict(image_features=shirg_blocks) if shirg_blocks else {}
    if args.kv4:
        gen_kw["kv8"] = 4
    elif args.kv8:
        gen_kw["kv8"] = True
    if args.warmup:
        model.generate(input_ids, images, image_sizes, gen, **gen_kw)

    t0 = time.time()
    out = model.generate(input_ids, images, image_sizes, gen, **gen_kw)
    dt = time.time() - t0

    if tokenizer is not None:
        print(model.decode_output(out, tokenizer))
    else:
        print("[predict] output ids:", out.tolist())
    print(f"[predict] latency: {dt:.3f}s "
          f"(len={args.max_new_tokens}, prefix_cache={gen.prefix_lm})")


if __name__ == "__main__":
    main()
