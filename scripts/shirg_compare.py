#!/usr/bin/env python
"""SHIRG vs baseline side-by-side latency/accuracy harness.

The analogue of the reference's shirg/real_ocr_vqa_* runners producing
shirg_simplified_results_*.json (SURVEY.md §2.8): for each image+question
pair, run the baseline anyres path and the SHIRG 2-view path, record
per-sample latency, token counts, selection latency, and (when answers are
given) exact-match accuracy.

Usage:
  python scripts/shirg_compare.py --model-path CKPT \\
      --data samples.jsonl --shirg-method base --output shirg_results.json
  python scripts/shirg_compare.py --tiny --synthetic 4     # smoke
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--data", default=None, help="jsonl: {image, text, target?}")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--shirg-method", default="base")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--output", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from PIL import Image

    from lavida_mod.config import (
        GenerationConfig, LaViDaConfig, VisionConfig,
        tiny_llada_config, tiny_siglip_config,
    )
    from lavida_mod.data import SigLIPImageProcessor, process_images
    from lavida_mod.models.lavida import LaViDa
    from lavida_mod.models.shirg import process_shirg_2view, shirg_encode

    if args.tiny or not args.model_path:
        cfg = LaViDaConfig(
            llada=tiny_llada_config(),
            vision=VisionConfig(
                siglip=tiny_siglip_config(), mm_hidden_size=32,
                grid_pinpoints=((56, 112), (112, 56), (112, 112)),
            ),
        )
        model = LaViDa.random_init(cfg, 0, jnp.float32)
        tokenizer = None
    else:
        cfg = LaViDaConfig()
        model = LaViDa.load(args.model_path, cfg)
        from lavida_mod.data.tokenizer import load_hf_or_offline

        tokenizer = load_hf_or_offline(args.model_path)

    proc = SigLIPImageProcessor(size=cfg.vision.siglip.image_size)
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        block_length=min(128, args.max_new_tokens), prefix_lm=True,
    )

    samples = []
    if args.data:
        base = os.path.dirname(args.data)
        with open(args.data) as f:
            for line in f:
                d = json.loads(line)
                d["pil"] = Image.open(
                    os.path.join(base, d["image"])
                ).convert("RGB")
                samples.append(d)
    else:
        rng = np.random.default_rng(0)
        for i in range(max(args.synthetic, 2)):
            samples.append({
                "text": f"what is item {i}?",
                "pil": Image.fromarray(rng.integers(
                    0, 255, (300, 400, 3), dtype=np.uint8
                )),
            })

    def ids_for(text):
        if tokenizer is not None:
            from lavida_mod.data.conversation import get_conv_template
            from lavida_mod.data.prompts import tokenizer_image_token

            conv = get_conv_template("llada")
            conv.tokenizer = tokenizer
            conv.append_message(conv.roles[0], "<image>\n" + text)
            return tokenizer_image_token(conv.get_prompt(), tokenizer)
        rng = np.random.default_rng(abs(hash(text)) % 2**31)
        ids = rng.integers(3, 400, size=12)
        return np.concatenate([ids[:4], [-200], ids[4:]]).astype(np.int64)

    rows = []
    for s in samples:
        ids = ids_for(s["text"])
        # baseline anyres
        views = process_images([s["pil"]], proc, cfg.vision)[0]
        t0 = time.perf_counter()
        out_b = model.generate(ids, [views], [s["pil"].size], gen)
        t_base = time.perf_counter() - t0
        # shirg 2-view
        t0 = time.perf_counter()
        sv = process_shirg_2view(s["pil"], proc)
        t_sel0 = time.perf_counter()
        block = shirg_encode(
            model.params, cfg, jnp.asarray(sv), method=args.shirg_method
        )
        jax.block_until_ready(block)
        sel_ms = (time.perf_counter() - t_sel0) * 1e3
        out_s = model.generate(ids, gen=gen, image_features=[block])
        t_shirg = time.perf_counter() - t0
        row = {
            "question": s["text"],
            "baseline_latency_s": round(t_base, 4),
            "shirg_latency_s": round(t_shirg, 4),
            "shirg_selection_ms": round(sel_ms, 2),
            "shirg_tokens": int(block.shape[0]),
        }
        if tokenizer is not None:
            row["baseline_answer"] = model.decode_output(out_b, tokenizer)
            row["shirg_answer"] = model.decode_output(out_s, tokenizer)
            if "target" in s:
                from lavida_mod.eval.metrics import exact_match

                row["baseline_acc"] = exact_match(
                    row["baseline_answer"], s["target"]
                )
                row["shirg_acc"] = exact_match(
                    row["shirg_answer"], s["target"]
                )
        rows.append(row)
        print(json.dumps(row))

    summary = {
        "method": args.shirg_method,
        "n": len(rows),
        "avg_baseline_latency_s": round(
            float(np.mean([r["baseline_latency_s"] for r in rows])), 4
        ),
        "avg_shirg_latency_s": round(
            float(np.mean([r["shirg_latency_s"] for r in rows])), 4
        ),
        "avg_selection_ms": round(
            float(np.mean([r["shirg_selection_ms"] for r in rows])), 2
        ),
        "results": rows,
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "results"}))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
