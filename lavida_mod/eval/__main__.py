"""Eval CLI — the analogue of `python -m lmms_eval` (eval/lmms_eval/__main__.py).

Example (mirrors eval/run_coco.sh):
  python -m lavida_mod.eval --model-path /ckpts/lavida-llada \\
      --tasks coco2017_cap_val_lite \\
      --gen-kwargs prefix_lm=True,step_ratio=0.5,schedule=shift,schedule__shift=0.33 \\
      --limit 64 --output results.json
"""

from __future__ import annotations

import argparse
import json


def parse_kv(s: str) -> dict:
    out = {}
    if not s:
        return out
    for item in s.split(","):
        k, _, v = item.partition("=")
        v = v.strip()
        if v.lower() in ("true", "false"):
            out[k.strip()] = v.lower() == "true"
        else:
            try:
                out[k.strip()] = int(v)
            except ValueError:
                try:
                    out[k.strip()] = float(v)
                except ValueError:
                    out[k.strip()] = v
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="random-init tiny model + whitespace tokenizer "
                         "(pipeline smoke runs without a checkpoint)")
    ap.add_argument("--lm-family", default=None, choices=["llada", "dream"],
                    help="default: sniffed from the checkpoint's "
                         "config.json model_type (llada without one)")
    ap.add_argument("--conv-template", default=None)
    ap.add_argument("--tasks", required=True, help="comma-separated")
    ap.add_argument("--data-path", default=None,
                    help="task=path overrides, comma-separated")
    ap.add_argument("--gen-kwargs", default="")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--mc-num", type=int, default=16)
    ap.add_argument("--loglik-act-int8", action="store_true",
                    help="W8A8 linears for the MC loglikelihood forwards "
                         "— opt-in: ~0.2-0.5%% "
                         "activation-quant logit error can flip close "
                         "multiple-choice rankings")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel bf16 serving over N devices "
                         "(requires --quant none; LaViDa.shard)")
    ap.add_argument("--quant", choices=["none", "int8", "int4", "mixed"],
                    default="int8",
                    help="LM serving layout for real checkpoints: int8 "
                         "(default; near-lossless), int4 (grouped int4 "
                         "weights + fused layout; gate per checkpoint with "
                         "scripts/verify_checkpoint.py --quant-check), "
                         "mixed (int8 prefill tree + int4 decode tree; "
                         "+~7.5G device memory), or none (bf16)")
    ap.add_argument("--kv8", action="store_true",
                    help="int8 KV cache + decode attention over it "
                         "(GQA-native; bench --kv8 serving configuration)")
    ap.add_argument("--log-samples", action="store_true")
    ap.add_argument("--output", default=None)
    ap.add_argument("--output-dir", default=None,
                    help="EvaluationTracker dir: date-stamped results + "
                         "per-sample jsonl per task")
    args = ap.parse_args()

    from ..utils.compile_cache import enable as _cc

    _cc()  # 8B serve graphs take minutes to compile cold; cache them

    from ..config import LaViDaConfig
    from ..models.lavida import LaViDa
    from .adapter import LavidaEvalModel
    from .evaluator import simple_evaluate

    if args.model_path:
        # geometry + lm family sniff from the checkpoint's config.json
        # (builder.py:128-146); host_staging when quantizing keeps the
        # bf16 tree off the device; .to_device() ships the layout
        if args.tp > 1 and args.quant != "none":
            raise SystemExit("--tp is bf16 serving; use --quant none")
        if args.tp > 1 and args.kv8:
            # sharded generate over a quantized KV cache has no parity
            # test — reject the combination
            raise SystemExit("--tp is bf16 serving; drop --kv8")
        model = LaViDa.load(args.model_path, lm_family=args.lm_family,
                            host_staging=args.quant != "none"
                            or args.tp > 1)
        if args.tp > 1:
            # multi-device bf16 eval: shard instead of quantize
            # (LaViDa.shard)
            model.shard(tp=args.tp)
        else:
            model.to_serving_layout(quant=args.quant)
        from lavida_mod.data.tokenizer import load_hf_or_offline

        tokenizer = load_hf_or_offline(args.model_path)
    elif args.tiny:
        import jax.numpy as jnp

        from ..config import (
            VisionConfig, tiny_llada_config, tiny_siglip_config,
        )

        cfg = LaViDaConfig(
            llada=tiny_llada_config(),
            vision=VisionConfig(
                siglip=tiny_siglip_config(), mm_hidden_size=32,
                grid_pinpoints=((56, 112), (112, 56), (112, 112)),
            ),
        )
        model = LaViDa.random_init(cfg, 0, jnp.float32)
        model.lm_family = args.lm_family or "llada"

        class _ToyTokenizer:
            bos_token_id = 1
            eos_token_id = 2
            chat_template = None

            def __call__(self, text):
                class R:
                    input_ids = [1] + [10 + (ord(c) % 80) for c in text[:32]]

                return R()

            def decode(self, ids, skip_special_tokens=True):
                return " ".join(str(int(i)) for i in ids)

        tokenizer = _ToyTokenizer()
    else:
        raise SystemExit("--model-path is required (no checkpoint = no eval)")

    adapter = LavidaEvalModel(
        model, tokenizer,
        conv_template=args.conv_template or model.lm_family,
        mc_num=args.mc_num, kv8=args.kv8,
        loglik_act_int8=args.loglik_act_int8,
    )
    data_paths = {}
    if args.data_path:
        for item in args.data_path.split(","):
            k, _, v = item.partition("=")
            data_paths[k] = v
    tracker = None
    if args.output_dir:
        from .tracker import EvaluationTracker

        tracker = EvaluationTracker(
            args.output_dir,
            model_name=args.model_path or "tiny",
        )
    results = simple_evaluate(
        adapter, args.tasks.split(","), data_paths,
        limit=args.limit, gen_kwargs=parse_kv(args.gen_kwargs),
        log_samples=args.log_samples or bool(tracker),
        output_path=args.output, tracker=tracker,
    )
    print(json.dumps(
        {t: r["results"] for t, r in results.items()}, indent=2, default=str
    ))


if __name__ == "__main__":
    main()
