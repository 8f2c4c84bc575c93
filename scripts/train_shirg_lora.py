#!/usr/bin/env python
"""SHIRG Extra-LoRA end-to-end training harness — the JAX rebuild of
shirg/train_shirg_lora.py:86-1145 + shirg_lora_config.py:17-140:

  - LoRA rank 64 / alpha 128 on BOTH projector linears, SigLIP blocks
    0-3 q/k/v, blocks 4-5 q/k (add_shirg_lora's per-layer scale gating);
  - lr 1.8e-5, 500 warmup, cosine, grad-clip 1.0 (ShirgLoraConfig);
  - the 2-view 448px SHIRG data path (process_shirg_2view -> 980-token
    shirg_encode) through the diffusion loss;
  - cadenced in-training validation (--eval-every, eval_hook tasks) and
    adapter-only saves (split_lora_state — the non_lora_trainables.bin
    analogue).

Smoke-tested on the tiny config by tests/test_shirg_lora_train.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-path", required=True,
                    help="llava-style json (conversations + image)")
    ap.add_argument("--image-folder", default="")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--lr", type=float, default=1.8e-5)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=128.0)
    ap.add_argument("--warmup-steps", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--text-bucket", type=int, default=64)
    ap.add_argument("--shirg-method", default="full")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--eval-tasks", default=None)
    ap.add_argument("--eval-limit", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from lavida_mod.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config,
                                   tiny_siglip_config)
    from lavida_mod.data.image_processor import SigLIPImageProcessor
    from lavida_mod.models import multimodal as mm
    from lavida_mod.models.lavida import LaViDa
    from lavida_mod.models.shirg import process_shirg_2view
    from lavida_mod.train.lora import (add_shirg_lora,
                                       make_lora_optimizer,
                                       make_shirg_lora_train_step,
                                       split_lora_state)
    from lavida_mod.utils import rank0_print
    from lavida_mod.utils.checkpoint import save_checkpoint

    if args.tiny:
        cfg = LaViDaConfig(
            llada=tiny_llada_config(),
            vision=VisionConfig(siglip=tiny_siglip_config(),
                                mm_hidden_size=32),
        )
        view_size = cfg.vision.siglip.image_size
    else:
        cfg = LaViDaConfig()
        view_size = 448

    if args.model_path:
        params = LaViDa.load(args.model_path, cfg, jnp.float32).params
    else:
        params = mm.init_params(cfg, jax.random.PRNGKey(args.seed),
                                jnp.float32)

    params = add_shirg_lora(params, jax.random.PRNGKey(args.seed + 1),
                            rank=args.rank, alpha=args.alpha)
    n_lora = sum(
        int(np.prod(v.shape)) for p, v in
        jax.tree_util.tree_leaves_with_path(params)
        if any(getattr(k, "key", None) in ("lora_a", "lora_b")
               for k in p))
    rank0_print(f"[shirg-lora] trainable LoRA params: {n_lora/1e6:.2f}M")

    opt = make_lora_optimizer(
        lr=args.lr, weight_decay=0.01, grad_clip=1.0,
        warmup_steps=args.warmup_steps, total_steps=args.steps)
    opt_state = opt.init(params)
    step_fn = jax.jit(make_shirg_lora_train_step(
        cfg, opt, shirg_method=args.shirg_method),
        donate_argnums=(0, 1))

    with open(args.data_path) as f:
        records = json.load(f)
    proc = SigLIPImageProcessor(size=view_size)
    rng = np.random.default_rng(args.seed)

    from PIL import Image

    def encode_text(s: str) -> list[int]:
        return [2 + (b % 250) for b in s.encode()][: args.text_bucket]

    def make_batch():
        idx = rng.choice(len(records), size=args.batch_size,
                         replace=len(records) < args.batch_size)
        pix, text_ids, labels = [], [], []
        n_img = 980 if not args.tiny else None
        for i in idx:
            r = records[int(i)]
            img = Image.open(os.path.join(
                args.image_folder, r["image"])).convert("RGB")
            if args.tiny:
                # tiny SigLIP: keep the 2-view layout at the tiny size
                views = np.stack([proc(img.resize((view_size,) * 2)),
                                  proc(img)], axis=0)
            else:
                views = process_shirg_2view(img, proc)
            pix.append(views)
            prompt = r["conversations"][0]["value"].replace("<image>", "")
            answer = r["conversations"][1]["value"]
            p_ids = encode_text(prompt)
            a_ids = encode_text(answer)
            ids = (p_ids + a_ids)[: args.text_bucket]
            ids = ids + [cfg.llada.pad_token_id] * (args.text_bucket - len(ids))
            lab = [-100] * len(p_ids) + ids[len(p_ids):]
            lab = lab[: args.text_bucket]
            lab += [-100] * (args.text_bucket - len(lab))
            text_ids.append(ids)
            labels.append(lab)
        pix = np.stack(pix)  # [B, 2, C, S, S]
        # image-token count from one traced encode (tiny) or 980 (full)
        if n_img is None:
            from lavida_mod.models.shirg import shirg_encode
            n_img = jax.eval_shape(
                lambda p, v: shirg_encode(p, cfg, v),
                jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                             params),
                jax.ShapeDtypeStruct(pix[0].shape, jnp.float32)).shape[0]
        lab_full = np.concatenate(
            [np.full((len(idx), n_img), -100, np.int64),
             np.asarray(labels, np.int64)], axis=1)
        return {
            "pixel_values": jnp.asarray(pix, jnp.float32),
            "text_ids": jnp.asarray(np.asarray(text_ids, np.int32)),
            "labels": jnp.asarray(lab_full),
        }

    rank0_print(f"[shirg-lora] {len(records)} samples, "
                f"{args.steps} steps, lr {args.lr}")
    t0 = time.time()
    for step in range(args.steps):
        batch = make_batch()
        params, opt_state, metrics = step_fn(
            params, opt_state, batch, jax.random.PRNGKey(step))
        if (step + 1) % 10 == 0 or step + 1 == args.steps:
            rank0_print(
                f"[shirg-lora] step {step+1}: "
                f"loss={float(metrics['loss']):.4f} "
                f"({10/(time.time()-t0):.2f} it/s)")
            t0 = time.time()
        if args.eval_every and (step + 1) % args.eval_every == 0 \
                and args.eval_tasks:
            from lavida_mod.train.eval_hook import run_in_training_eval

            scores = run_in_training_eval(
                cfg, params, None, args.eval_tasks.split(","),
                None, limit=args.eval_limit)
            rank0_print(f"[shirg-lora] eval @ {step+1}: {scores}")
        if (step + 1) % args.save_every == 0 or step + 1 == args.steps:
            adapters = split_lora_state(params)
            path = save_checkpoint(
                args.output_dir, step + 1,
                {"lora": adapters},
                extra={"rank": args.rank, "alpha": args.alpha})
            rank0_print(f"[shirg-lora] saved adapters -> {path}")
    print("[shirg-lora] done")


if __name__ == "__main__":
    main()
