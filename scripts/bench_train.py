#!/usr/bin/env python
"""Training-step throughput on one GPU.

The inference headline (bench.py) covers serving; this measures the
TRAINING path — the real `train/step.py` step (diffusion loss with
complementary masking, prefix-LM masked attention, whole-layer remat,
adamw) at a reduced model size.

Reference counterpart: the HF-Trainer loop of train.py (SURVEY.md §2.5);
the reference publishes no tokens/s, so this row is self-baselined — it
reports model FLOP/s utilization against the card's published bf16 peak
(utils/device.PEAKS) and guards against regressions.

Protocol: donated params/opt_state chain the steps on device; wall over N
steps after a 2-step warm-up, ended by block_until_ready.  Fails without
a GPU.  Prints ONE json line like bench.py.

Usage: python scripts/bench_train.py [--steps 16] [--batch 4] [--seq 1024]
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--mlp", type=int, default=6144)
    ap.add_argument("--remat", default="whole_layer",
                    help="activation-checkpointing strategy: whole_layer "
                         "/ dots_nobatch / dots / none (models/llada.py "
                         "remat ladder)")
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "dense", "blockwise"],
                    help="auto = dense masked attention up to "
                         "ops/attention.BLOCKWISE_ABOVE tokens, blockwise "
                         "above (same rule as train.py)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="MultiSteps accumulation: each bench step is one "
                         "microbatch; overhead = the accumulator "
                         "read-modify-write per step + the update every "
                         "k-th (train.py --grad-accum)")
    ap.add_argument("--ce-chunk", type=int, default=None,
                    help="chunked CE head (train/loss.py ce_chunk)")
    ap.add_argument("--multimodal", action="store_true",
                    help="bench make_multimodal_train_step: pixels -> "
                         "SigLIP so400m tower -> projector -> pool -> "
                         "gather-splice -> diffusion loss (one 384px "
                         "square view per sample; the reference's "
                         "stage-2 step shape, train.py:1880-2184)")
    args = ap.parse_args()

    from lavida_mod.utils import device
    from lavida_mod.utils.compile_cache import enable as enable_cache

    dev = device.require_gpu()
    peak = device.peaks(dev["kind"])["bf16_flops"]
    enable_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lavida_mod.config import LaViDaConfig, LLaDAConfig
    from lavida_mod.models import llada as L
    from lavida_mod.train.step import jit_train_step, make_train_step

    lm = LLaDAConfig(
        vocab_size=32000, d_model=args.d_model, n_layers=args.layers,
        n_heads=args.d_model // 128, n_kv_heads=args.d_model // 128,
        mlp_hidden_size=args.mlp, block_type="llama", activation="silu",
        max_sequence_length=max(4096, args.seq), weight_tying=True,
    )
    cfg = LaViDaConfig(llada=lm)

    import optax

    from lavida_mod.ops.attention import training_attention_impl

    remat = False if args.remat == "none" else args.remat
    impl = args.attn_impl
    if impl == "auto":
        impl = training_attention_impl(args.seq)

    B, S, D = args.batch, args.seq, args.d_model
    rng = np.random.default_rng(0)
    opt = optax.adamw(1e-4)
    if args.grad_accum > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=args.grad_accum)
    key = jax.random.PRNGKey(1)
    n_vis_tokens = 0
    n_vis_params = 0

    if args.multimodal:
        from lavida_mod.config import VisionConfig
        from lavida_mod.models import multimodal as mm
        from lavida_mod.train.step import make_multimodal_train_step

        # one square 384px view per sample (stage-1 geometry); the LM sees
        # [196 pooled vision tokens + newline + text] per row, padded to S
        vis = VisionConfig(image_aspect_ratio="square")
        cfg = LaViDaConfig(llada=lm, vision=vis)
        params = mm.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
        n_params = sum(x.size for x in jax.tree.leaves(params["llada"]))
        n_vis_params = sum(
            x.size for k in ("siglip", "projector")
            for x in jax.tree.leaves(params[k]))
        sp = cfg.vision.siglip
        g = -(-sp.num_patches_per_side // cfg.vision.spatial_pool_stride)
        t_text = S - (g * g + 1)
        assert t_text > 8, "seq too short for the vision block"
        ids_list, labs_list = [], []
        for b in range(B):
            row = rng.integers(3, 31000, t_text).astype(np.int64)
            row[1] = -200  # IMAGE_TOKEN_INDEX
            lab = row.copy()
            lab[: t_text // 4] = -100
            ids_list.append(row)
            labs_list.append(lab)
        gather_idx, text_ids, _valid, labels = mm.build_gather_plan(
            cfg, ids_list, [[1]] * B, [[(384, 384)]] * B, labs_list,
            pad_to=S,
        )
        n_vis_tokens = B * (sp.image_size // sp.patch_size) ** 2
        batch = {
            "pixel_values": jnp.asarray(
                rng.standard_normal((B, 3, sp.image_size, sp.image_size)),
                jnp.bfloat16),
            "text_ids": jnp.asarray(text_ids),
            "gather_idx": jnp.asarray(gather_idx),
            "labels": jnp.asarray(labels),
        }
        opt_state = opt.init(params)
        step = jit_train_step(make_multimodal_train_step(
            cfg, opt, prefix_lm=True, remat=remat, attention_impl=impl,
            ce_chunk=args.ce_chunk,
        ))
    else:
        params = L.init_params(lm, jax.random.PRNGKey(0), jnp.bfloat16)
        n_params = sum(x.size for x in jax.tree.leaves(params))
        opt_state = opt.init(params)
        step = jit_train_step(make_train_step(
            cfg, opt, prefix_lm=True, remat=remat, attention_impl=impl,
            ce_chunk=args.ce_chunk,
        ))
        ids = jnp.asarray(rng.integers(3, 31000, (B, S)), jnp.int32)
        labels = np.asarray(ids).copy()
        labels[:, : S // 4] = -100  # prompt region (prefix-LM mask)
        batch = {
            "inputs_embeds": L.embed_tokens(params, ids),
            "labels": jnp.asarray(labels),
        }

    # warmup / compile (donation: params/opt_state must be re-threaded)
    for i in range(2):
        key, k = jax.random.split(key)
        params, opt_state, metrics = step(params, opt_state, batch, k)
    jax.block_until_ready(metrics)

    t0 = time.perf_counter()
    for i in range(args.steps):
        key, k = jax.random.split(key)
        params, opt_state, metrics = step(params, opt_state, batch, k)
    jax.block_until_ready((params, metrics))
    wall = time.perf_counter() - t0
    loss = float(metrics["loss"])

    s_per_step = wall / args.steps
    # complementary masking doubles the forwarded batch (train/loss.py);
    # tokens/s counts the DATA tokens (B*S), FLOPs count the compute (2x).
    # The vision stack runs ONCE per row (before the doubling).
    tok_s = B * S / s_per_step
    flops = 6 * n_params * (2 * B * S) + 6 * n_vis_params * n_vis_tokens
    # attention matmul term (PaLM MFU convention; bidirectional prefix-LM
    # -> no causal halving): QK^T + AV = 4*S^2*D flops/layer fwd, x3 bwd
    attn_flops = 3 * 4 * (2 * B) * S * S * args.d_model * args.layers
    mfu = flops / s_per_step / peak      # params-only term
    mfu_attn = (flops + attn_flops) / s_per_step / peak
    # whole_layer remat re-executes the fwd inside the bwd: the chip runs
    # ~8/6 of the model FLOPs — this is the remat-adjusted hw utilization
    hw_util = mfu_attn * (8 / 6 if remat else 1.0)
    print(json.dumps({
        "metric": f"train{'_mm' if args.multimodal else ''}_tokens_per_s"
                  f"_{args.layers}L_d{args.d_model}_b{B}x{S}_{impl}"
                  + (f"_ga{args.grad_accum}" if args.grad_accum > 1
                     else ""),
        "value": tok_s,
        "unit": "tokens/s",
        "device": dev,
        "card": device.card_name_and_power_limit(),
        "detail": {
            "s_per_step": s_per_step,
            "params_m": n_params / 1e6,
            "vis_params_m": n_vis_params / 1e6,
            "loss": loss,
            "mfu_bf16_peak": mfu,
            "mfu_with_attn": mfu_attn,
            "hw_util_remat_adj": hw_util,
        },
    }))


if __name__ == "__main__":
    main()
