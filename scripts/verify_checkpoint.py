#!/usr/bin/env python
"""Real-weights gate: one-command logit parity vs the torch reference.

All round-1/2 parity evidence is on tiny random-init models through the
converters; the published 8B weights have never been in this sandbox.  The
first time a real checkpoint directory is available, run:

    python scripts/verify_checkpoint.py /path/to/lavida-llada-ckpt
    python scripts/verify_checkpoint.py /path/to/ckpt --lm-family dream
    python scripts/verify_checkpoint.py /path/to/ckpt --layers 1   # layer-0 only

It loads the checkpoint through `convert_lavida_state_dict` (JAX side) and
through the reference torch modeling code (`/root/reference/llava/model/
language_model/llada/modeling_llada.py`), runs both on the same token
prompt, and reports max |logit delta| per position plus layer-0 hidden
parity.  Exit code 0 iff deltas are within the bf16 tolerance band.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.environ.get("LAVIDA_REFERENCE", "/root/reference")
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", help="checkpoint dir (safetensors / torch bins)")
    ap.add_argument("--lm-family", default="llada",
                    choices=["llada", "dream"])
    ap.add_argument("--layers", type=int, default=None,
                    help="truncate both models to the first N layers "
                         "(fast first-contact check; default: all)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--atol", type=float, default=0.15,
                    help="max |logit delta| tolerance (bf16 8B band)")
    ap.add_argument("--quant-check", action="store_true",
                    help="also gate the int4 serving layout: quantize the "
                         "loaded weights to grouped int4 and compare "
                         "logits + greedy tokens vs the f32 forward")
    ap.add_argument("--quant-rtol", type=float, default=0.03,
                    help="max relative logit error for the int4 gate")
    ap.add_argument("--quant-agree", type=float, default=0.95,
                    help="min greedy-token agreement for the int4 gate")
    ap.add_argument("--kv8-check", action="store_true",
                    help="also gate the int8-KV-cache decode (bench "
                         "--kv8 / worker --kv8): run a short cached "
                         "generation with and without kv8 on the int8 "
                         "serving layout and compare tokens")
    ap.add_argument("--kv8-agree", type=float, default=0.9,
                    help="min token agreement for the kv8 gate")
    ap.add_argument("--kv4-check", action="store_true",
                    help="gate the int4 KV cache (serving --kv4): same "
                         "protocol as --kv8-check at 4-bit width")
    ap.add_argument("--kv4-agree", type=float, default=0.85,
                    help="min token agreement for the kv4 gate")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from lavida_mod.config import LaViDaConfig
    from lavida_mod.models import llada as jl
    from lavida_mod.models.lavida import (
        convert_lavida_state_dict, load_state_shards,
    )

    # --- JAX side -----------------------------------------------------
    cfg = LaViDaConfig()
    lcfg = cfg.llada
    if args.layers:
        lcfg = lcfg.replace(n_layers=args.layers)
        cfg = cfg.replace(llada=lcfg)
    state = load_state_shards(args.ckpt)
    params = convert_lavida_state_dict(
        state, cfg, jnp.float32, lm_family=args.lm_family
    )["llada"] if any(k.startswith("model.vision_tower") for k in state) \
        else (convert_lavida_state_dict(
            {f"model.{k}" if not k.startswith("model.") else k: v
             for k, v in state.items()},
            cfg, jnp.float32, lm_family=args.lm_family)["llada"])

    rng = np.random.default_rng(0)
    ids = rng.integers(10, 1000, size=(1, args.prompt_len))
    logits, _ = jl.forward(params, lcfg, jl.embed_tokens(params, jnp.asarray(ids)))
    logits = np.asarray(logits, np.float32)

    # --- torch side ---------------------------------------------------
    import torch

    sys.path.insert(0, os.path.join(REFERENCE, "llava", "model",
                                    "language_model"))
    if args.lm_family == "llada":
        from llada.modeling_llada import LLaDAModelLM  # noqa: E402
        from transformers import AutoConfig

        tcfg = AutoConfig.from_pretrained(
            args.ckpt, trust_remote_code=True
        ) if os.path.exists(os.path.join(args.ckpt, "config.json")) else None
        model = LLaDAModelLM.from_pretrained(
            args.ckpt, torch_dtype=torch.float32, config=tcfg,
        )
    else:
        from dream.modeling_dream import DreamModel  # noqa: E402

        model = DreamModel.from_pretrained(args.ckpt,
                                           torch_dtype=torch.float32)
    model.eval()
    if args.layers:
        try:  # truncate the torch block list for a layer-0-only check
            blocks = model.model.transformer.blocks
            del blocks[args.layers:]
        except Exception:
            print("[verify] warning: could not truncate torch layers; "
                  "running full depth")
    with torch.no_grad():
        tlogits = model(torch.from_numpy(ids)).logits.float().numpy()

    # --- compare ------------------------------------------------------
    delta = np.abs(logits - tlogits)
    top_ours = logits.argmax(-1)
    top_ref = tlogits.argmax(-1)
    agree = (top_ours == top_ref).mean()
    print(f"[verify] max|Δlogit| = {delta.max():.4f}   "
          f"mean|Δ| = {delta.mean():.6f}   argmax agreement = {agree:.3f}")
    ok = delta.max() <= args.atol and agree == 1.0
    print("[verify] PASS" if ok else "[verify] FAIL")

    if args.quant_check and ok:
        # int4 serving-layout quality gate on the REAL weights: logit
        # error + greedy-token agreement vs the f32 reference forward
        # (this is the per-checkpoint gate the bench default's ~1%
        # rel-err claim defers to)
        qparams = jl.quantize_params(jl.unstack_blocks(params), bits=4)
        qlogits, _ = jl.forward(
            qparams, lcfg, jl.embed_tokens(qparams, jnp.asarray(ids)))
        qlogits = np.asarray(qlogits, np.float32)
        rel = np.abs(qlogits - logits).max() / (np.abs(logits).max() + 1e-9)
        qagree = (qlogits.argmax(-1) == top_ours).mean()
        print(f"[verify:int4] rel|Δlogit| = {rel:.4f}   "
              f"greedy-token agreement = {qagree:.3f}")
        q_ok = rel <= args.quant_rtol and qagree >= args.quant_agree
        print("[verify:int4] PASS" if q_ok else
              "[verify:int4] FAIL — serve with --int8 for this checkpoint")
        ok = ok and q_ok

    if (args.kv8_check or args.kv4_check) and ok:
        # int8-KV decode gate, isolated on the weight-only int8 layout
        # (kv8 and int4 are independent quality knobs)
        from lavida_mod.config import GenerationConfig
        from lavida_mod.generation import diffusion

        p8 = jl.quantize_params(jl.unstack_blocks(params), bits=8)
        gen = GenerationConfig(max_new_tokens=16, block_length=16,
                               step_per_block=8, prefix_lm=True)
        emb = jl.embed_tokens(p8, jnp.asarray(ids))
        base = np.asarray(diffusion.generate(p8, lcfg, emb, gen))
        if args.kv8_check:
            k8 = np.asarray(diffusion.generate(p8, lcfg, emb, gen,
                                               kv8=True))
            kagree = (base == k8).mean()
            print(f"[verify:kv8] token agreement vs bf16 cache = "
                  f"{kagree:.3f}")
            k_ok = kagree >= args.kv8_agree
            print("[verify:kv8] PASS" if k_ok else
                  "[verify:kv8] FAIL — serve without --kv8 for this "
                  "checkpoint")
            ok = ok and k_ok
        if args.kv4_check:
            k4 = np.asarray(diffusion.generate(p8, lcfg, emb, gen, kv8=4))
            k4agree = (base == k4).mean()
            print(f"[verify:kv4] token agreement vs bf16 cache = "
                  f"{k4agree:.3f}")
            k4_ok = k4agree >= args.kv4_agree
            print("[verify:kv4] PASS" if k4_ok else
                  "[verify:kv4] FAIL — serve without --kv4 for this "
                  "checkpoint")
            ok = ok and k4_ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
