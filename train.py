#!/usr/bin/env python
"""Training CLI — the analogue of reference llava/train/train.py + trainer.

Example (stage-2-style finetune on a yaml mixture, 8-chip dp x fsdp mesh):
  python train.py --data-path mix.yaml --image-folder /data/images \\
      --output-dir runs/s2 --tunable mm_mlp_adapter,mm_vision_tower,mm_language_model \\
      --lr 2e-5 --vision-tower-lr 2e-6 --batch-size 4 --steps 1000 \\
      --dp 1 --fsdp 8 --tp 1

Shapes are bucketed (seq to 128s, view count to 8s) so XLA compiles a small
number of executables instead of one per batch shape.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def pad_to_bucket(n: int, bucket: int) -> int:
    return max(((n + bucket - 1) // bucket) * bucket, bucket)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--image-folder", default="")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--model-path", default=None,
                    help="initial checkpoint (HF layout) or orbax dir")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--geometry", default=None,
                    choices=["tiny", "457m", "913m", "8b"],
                    help="model geometry when training from scratch: "
                         "'913m' = the single-card bench geometry "
                         "(scripts/bench_train.py: 12L d2048, llama "
                         "block, square so400m tower) for driving the "
                         "full CLI on one card; '457m' = its 6-layer "
                         "half; default '8b' (or 'tiny' with --tiny)")
    ap.add_argument("--style", default="llada", choices=["llada", "dream"])
    ap.add_argument("--tunable",
                    default="mm_mlp_adapter,mm_vision_tower,mm_language_model")
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--projector-lr", type=float, default=None)
    ap.add_argument("--vision-tower-lr", type=float, default=None)
    ap.add_argument("--warmup-ratio", type=float, default=0.03)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="gradient accumulation microsteps per optimizer "
                         "step (reference --gradient_accumulation_steps 4 "
                         "in every cluster script); --steps counts "
                         "OPTIMIZER steps, so the loop runs "
                         "steps*grad_accum microbatches — stage-2's "
                         "effective global batch 128 is e.g. "
                         "--batch-size 16 --grad-accum 8")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seq-bucket", type=int, default=128)
    ap.add_argument("--view-bucket", type=int, default=8)
    ap.add_argument("--t-policy", default="uniform",
                    choices=["uniform", "logit_normal", "mode"])
    ap.add_argument("--no-prefix-lm", action="store_true")
    ap.add_argument("--fim", action="store_true",
                    help="stage-3 FIM corruption of assistant turns")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--fsdp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--decode-workers", type=int, default=4,
                    help="threads for the rng-free image decode inside "
                         "make_batch (0 = sequential); rng stream and "
                         "batch contents are bit-identical either way "
                         "(dataset.get_batch). Reference "
                         "dataloader_num_workers=4 analogue.")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="input-pipeline prefetch depth (0 disables): a "
                         "producer thread overlaps PIL decode + anyres + "
                         "gather-plan + H2D with the device step (the "
                         "reference's dataloader_num_workers analogue)")
    ap.add_argument("--prefetch-workers", type=int, default=1,
                    help="producer threads feeding the prefetch queue. "
                         "1 (default) keeps the single-rng batch stream "
                         "bit-deterministic; >1 gives each producer its "
                         "own seeded rng stream — batch CONTENTS stay "
                         "seed-deterministic per worker but arrival "
                         "ORDER does not.")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--adapter-only-save", action="store_true")
    ap.add_argument("--eval-tasks", default=None,
                    help="comma-separated lite tasks run every --eval-every "
                         "steps against live params (LLaVAEvalTrainer "
                         "analogue); needs --tokenizer-path + task data")
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--eval-limit", type=int, default=32)
    ap.add_argument("--eval-data-path", default=None,
                    help="task=path jsonl overrides, comma-separated")
    ap.add_argument("--wandb", action="store_true")
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--remat", default="whole_layer",
                    choices=["whole_layer", "nested", "dots",
                             "dots_nobatch", "none"],
                    help="activation checkpointing: whole_layer saves L "
                         "boundaries; nested (sqrt-checkpointing) saves "
                         "~2*sqrt(L)")
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "dense", "blockwise"],
                    help="training attention: 'dense' = one masked "
                         "attention call per layer (cuDNN's fused kernel "
                         "on the GPU); 'blockwise' = online softmax over "
                         "key blocks, never building the [T, S] mask; "
                         "'auto' = dense up to "
                         "ops/attention.BLOCKWISE_ABOVE tokens")
    ap.add_argument("--ce-chunk", type=int, default=None,
                    help="chunked cross-entropy head: compute the loss in "
                         "checkpointed chunks of N positions so the f32 "
                         "[2B, L, V] logits never materialize (~8.3 GB "
                         "at the 8B stage-2 shapes).  512 is a good "
                         "default at 8B")
    ap.add_argument("--precision", default="mixed",
                    choices=["mixed", "bf16"],
                    help="'mixed' (default, reference-faithful): f32 master "
                         "weights + f32 Adam moments + f32 grad "
                         "accumulation, bf16 forward/backward — DeepSpeed's "
                         "bf16 engine semantics (scripts/zero3.json:10-12; "
                         "bf16 updates at lr 2e-5 on O(1e-2) weights round "
                         "to zero below ~0.4%% relative, the failure f32 "
                         "masters exist to prevent).  'bf16' = everything "
                         "bf16 (half the optimizer HBM; grad accumulation "
                         "still runs f32 via multi_steps_f32)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of steps 2-4 "
                         "(post-compile) to DIR — inspect with "
                         "TensorBoard/xprof (utils/profiling.py)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    # persistent compile cache: restarts and auto-resumes should pay a
    # disk read, not a recompile of the train step
    from lavida_mod.utils.compile_cache import enable as _cc

    _cc()

    import jax.numpy as jnp

    from lavida_mod.config import (
        LaViDaConfig, VisionConfig, tiny_llada_config, tiny_siglip_config,
    )
    from lavida_mod.constants import LLADA_EOS_ID, LLADA_FIM_ID
    from lavida_mod.data.dataset import SupervisedDataset, collate_batch
    from lavida_mod.models import multimodal as mm
    from lavida_mod.models.lavida import LaViDa
    from lavida_mod.parallel import make_mesh, shard_params
    from lavida_mod.train.step import (
        jit_train_step, make_freeze_optimizer, make_multimodal_train_step,
    )
    from lavida_mod.utils import (
        MetricsLogger, latest_checkpoint, rank0_print, restore_checkpoint,
        save_adapter_only, save_checkpoint,
    )

    geometry = args.geometry or ("tiny" if args.tiny else "8b")
    if geometry == "tiny":
        cfg = LaViDaConfig(
            llada=tiny_llada_config(),
            vision=VisionConfig(
                siglip=tiny_siglip_config(), mm_hidden_size=32,
                grid_pinpoints=((56, 112), (112, 56), (112, 112)),
            ),
        )
        args.tiny = True
    elif geometry in ("457m", "913m"):
        # the scripts/bench_train.py single-chip geometry: one square
        # 384px so400m view per sample, llama-block LM
        from lavida_mod.config import LLaDAConfig

        cfg = LaViDaConfig(
            llada=LLaDAConfig(
                vocab_size=32000, d_model=2048,
                n_layers=12 if geometry == "913m" else 6,
                n_heads=16, n_kv_heads=16, mlp_hidden_size=6144,
                block_type="llama", activation="silu",
                max_sequence_length=4096, weight_tying=True,
            ),
            vision=VisionConfig(image_aspect_ratio="square"),
        )
    else:
        cfg = LaViDaConfig()

    if args.tokenizer_path:
        from lavida_mod.data.tokenizer import load_hf_or_offline

        tokenizer = load_hf_or_offline(args.tokenizer_path)
    else:
        class ByteTokenizer:
            bos_token_id = 1
            chat_template = None

            def __call__(self, text):
                class R:
                    input_ids = [2 + (b % 250) for b in text.encode()]

                return R()

            def decode(self, ids, skip_special_tokens=True):
                return bytes(
                    (int(i) - 2) % 250 for i in ids
                ).decode("latin-1")

        tokenizer = ByteTokenizer()
        rank0_print("[train] no tokenizer path: byte-level fallback")

    ds = SupervisedDataset(
        args.data_path, tokenizer, cfg.vision,
        image_folder=args.image_folder, style=args.style,
        is_infill_model=args.fim, seed=args.seed,
    )
    rank0_print(f"[train] dataset: {len(ds)} samples")

    from lavida_mod.parallel.mesh import maybe_init_distributed

    maybe_init_distributed()
    mesh = make_mesh(dp=args.dp, fsdp=args.fsdp, tp=args.tp)
    rank0_print(f"[train] mesh: {mesh.shape}")

    if args.model_path and os.path.isdir(args.model_path) and any(
        f.endswith((".safetensors", ".bin"))
        for f in os.listdir(args.model_path)
    ):
        model = LaViDa.load(args.model_path, cfg, jnp.bfloat16)
        params = model.params
    else:
        params = mm.init_params(cfg, jax.random.PRNGKey(args.seed))
    params = shard_params(params, mesh)
    # pin the param dtype to the policy: 'mixed' holds f32 master weights
    # (DeepSpeed bf16-engine parity; the step casts to bf16 for compute —
    # bf16->f32 is exact so a bf16 checkpoint round-trips), 'bf16' holds
    # bf16 weights (random init is f32 by default and WOULD otherwise
    # ship f32 params+Adam states — 16G at the 913m+tower geometry)
    from lavida_mod.train.step import cast_floating

    target_dtype = (jnp.float32 if args.precision == "mixed"
                    else jnp.bfloat16)
    params = jax.jit(
        lambda p: cast_floating(p, target_dtype), donate_argnums=0
    )(params)

    opt = make_freeze_optimizer(
        args.tunable, lr=args.lr, projector_lr=args.projector_lr,
        vision_tower_lr=args.vision_tower_lr,
        warmup_steps=int(args.warmup_ratio * args.steps),
        total_steps=args.steps,
        grad_accum=args.grad_accum,
        # bf16 mode still accumulates f32 (multi_steps_f32) — MultiSteps
        # would inherit bf16 and diverge from DeepSpeed's f32 flat buffers
        accum_dtype=jnp.float32 if args.precision == "bf16" else None,
    )
    opt_state = opt.init(params)

    start_step = 0
    resume = latest_checkpoint(args.output_dir)
    if resume and not resume.endswith("mm_projector"):
        rank0_print(f"[train] resuming from {resume}")
        t_r = time.time()
        payload = restore_checkpoint(
            resume, {"params": params, "opt_state": opt_state, "step": 0}
        )
        params, opt_state = payload["params"], payload["opt_state"]
        start_step = int(payload["step"])
        rank0_print(f"[train] restore wall: {time.time() - t_r:.1f}s")

    attn_impl = args.attn_impl
    if attn_impl == "auto":
        # the same rule as scripts/bench_train.py, at the longest row the
        # tokenizer lets through
        from lavida_mod.ops.attention import training_attention_impl

        attn_impl = training_attention_impl(
            cfg.tokenizer_model_max_length or cfg.llada.max_sequence_length)
    rank0_print(f"[train] attention_impl: {attn_impl}")
    step_fn = jit_train_step(make_multimodal_train_step(
        cfg, opt, prefix_lm=not args.no_prefix_lm, policy=args.t_policy,
        fim_id=LLADA_FIM_ID if args.fim else None,
        remat=(False if args.remat == "none" else args.remat), mesh=mesh,
        attention_impl=attn_impl, ce_chunk=args.ce_chunk,
        compute_dtype=jnp.bfloat16 if args.precision == "mixed" else None,
    ))

    logger = MetricsLogger(args.output_dir, use_wandb=args.wandb)
    rng = np.random.default_rng(args.seed)
    eos_id = cfg.llada.eos_token_id

    decode_pool = None
    if args.decode_workers > 0:
        from concurrent.futures import ThreadPoolExecutor

        decode_pool = ThreadPoolExecutor(max_workers=args.decode_workers)

    def make_batch(rng=rng):
        idx = rng.choice(len(ds), size=args.batch_size, replace=False)
        items = ds.get_batch(idx, pool=decode_pool)
        b = collate_batch(
            items, pad_token_id=cfg.llada.pad_token_id, eos_token_id=eos_id,
            model_max_length=cfg.tokenizer_model_max_length, rng=rng,
        )
        n_views = [[v.shape[0] for v in item["images"]] for item in items]
        pix = [v for item in items for v in item["images"]]
        ids_list = [row[m] for row, m in
                    zip(b["input_ids"], b["attention_mask"])]
        labs_list = [row[m] for row, m in
                     zip(b["labels"], b["attention_mask"])]
        gather_idx, text_ids, valid, labels = mm.build_gather_plan(
            cfg, ids_list, n_views, b["image_sizes"], labs_list,
        )
        T = pad_to_bucket(gather_idx.shape[1], args.seq_bucket)
        if T > gather_idx.shape[1]:
            gather_idx, text_ids, valid, labels = mm.build_gather_plan(
                cfg, ids_list, n_views, b["image_sizes"], labs_list, pad_to=T,
            )
        if pix:
            pixel_values = np.concatenate(pix, axis=0)
        else:
            S = cfg.vision.siglip.image_size
            pixel_values = np.zeros((0, 3, S, S), np.float32)
        NV = pad_to_bucket(pixel_values.shape[0], args.view_bucket)
        if NV > pixel_values.shape[0]:
            padv = np.zeros(
                (NV - pixel_values.shape[0],) + pixel_values.shape[1:],
                pixel_values.dtype,
            )
            pixel_values = np.concatenate([pixel_values, padv], axis=0)
        return {
            "pixel_values": jnp.asarray(pixel_values, jnp.bfloat16),
            "text_ids": jnp.asarray(text_ids),
            "gather_idx": jnp.asarray(gather_idx),
            "labels": jnp.asarray(labels),
        }

    ga = max(1, args.grad_accum)
    total_iters = args.steps * ga
    rank0_print(f"[train] starting at microstep {start_step}/{total_iters}"
                + (f" (grad_accum={ga}, {args.steps} optimizer steps)"
                   if ga > 1 else ""))

    if args.prefetch > 0:
        # overlap the host input pipeline (PIL decode + anyres + gather
        # plan + H2D) with the device step — the torch-DataLoader-workers
        # analogue (reference dataloader_num_workers=4,
        # llada-hd-llada-s2.sh).  Measured on the real chip at the 913m
        # geometry: 3436 -> ~6.5k tok/s (the step was waiting ~0.6s/batch
        # on make_batch).  One producer thread: make_batch owns the rng.
        import queue as _queue
        import threading as _threading

        nw = max(1, args.prefetch_workers)
        _q = _queue.Queue(maxsize=max(args.prefetch, nw))

        def _producer(wrng):
            while True:
                try:
                    b = make_batch(rng=wrng)
                except BaseException as e:  # noqa: BLE001
                    # a dead producer must not leave the consumer
                    # blocked on _q.get forever (observed: a dataset
                    # path error hung the whole run until timeout)
                    _q.put(e)
                    return
                _q.put(b)

        # worker 0 keeps the base seed so --prefetch-workers 1 is
        # bit-identical to the historical single-producer stream
        for w in range(nw):
            wrng = rng if w == 0 else np.random.default_rng(
                [args.seed, w])
            _threading.Thread(
                target=_producer, args=(wrng,), daemon=True).start()

        def next_batch():
            b = _q.get()
            if isinstance(b, BaseException):
                raise b
            return b
    else:
        next_batch = make_batch
    profiler_ctx = None
    t0 = time.time()
    window_metrics = []  # microbatch metrics across the accum window
    tokens_since_log = 0  # data tokens (B*T), bench_train convention
    for step in range(start_step, total_iters):
        if args.profile and step == start_step + 1:
            # skip the compile step; trace 3 steady-state steps
            from lavida_mod.utils.profiling import trace

            profiler_ctx = trace(args.profile)
            profiler_ctx.__enter__()
            rank0_print(f"[train] profiler tracing -> {args.profile}")
        batch = next_batch()
        tokens_since_log += int(np.prod(batch["labels"].shape))
        params, opt_state, metrics = step_fn(
            params, opt_state, batch, jax.random.PRNGKey(args.seed * 131 + step)
        )
        if profiler_ctx is not None and step == start_step + 3:
            jax.block_until_ready(jax.tree.leaves(metrics))
            profiler_ctx.__exit__(None, None, None)
            profiler_ctx = None
            rank0_print(f"[train] profiler trace saved: {args.profile}")
        # log/eval/save cadence counts OPTIMIZER steps (the reference
        # Trainer's max_steps convention); params only move on the
        # grad_accum boundary, so gates fire there
        on_update = (step + 1) % ga == 0
        opt_step = (step + 1) // ga
        window_metrics.append(metrics)
        if on_update and opt_step % args.log_every == 0:
            # average across the accumulation window so logged curves
            # match the reference Trainer's window-averaged loss (the
            # last microbatch alone is noisier and its grad_norm is the
            # raw microbatch gradient, not what the optimizer applied)
            m = {
                k: float(np.mean([float(w[k]) for w in window_metrics]))
                for k in metrics
            }
            dt = time.time() - t0
            m["steps_per_s"] = args.log_every / dt
            m["tokens_per_s"] = tokens_since_log / dt
            tokens_since_log = 0
            t0 = time.time()
            logger.log(opt_step, m)
            rank0_print(f"[train] step {opt_step}: loss={m['loss']:.4f} "
                        f"acc_mask={m['acc_mask']:.3f} "
                        f"({m['steps_per_s']:.2f} it/s, "
                        f"{m['tokens_per_s']:.0f} tok/s)")
        if on_update:
            window_metrics = []
        if args.eval_tasks and on_update and opt_step % args.eval_every == 0:
            from lavida_mod.train.eval_hook import run_in_training_eval

            data_paths = {}
            if args.eval_data_path:
                for item in args.eval_data_path.split(","):
                    k, _, v = item.partition("=")
                    data_paths[k] = v
            # generation runs bf16 (serving numerics) even when training
            # holds f32 masters — the cast is what inference would load
            eval_params = params
            if args.precision == "mixed":
                from lavida_mod.train.step import cast_floating

                eval_params = cast_floating(params, jnp.bfloat16)
            scores = run_in_training_eval(
                cfg, eval_params, tokenizer, args.eval_tasks.split(","),
                data_paths or None, limit=args.eval_limit,
                conv_template=args.style, lm_family=args.style,
            )
            logger.log(opt_step, scores)
            rank0_print(f"[train] eval @ {opt_step}: {scores}")
        if (on_update and args.save_every > 0
                and opt_step % args.save_every == 0) \
                or step + 1 == total_iters:
            # payload step is the MICROSTEP index so resume replays the
            # exact microbatch position (checkpoints land on update
            # boundaries, where MultiSteps' mini_step is 0)
            t_s = time.time()
            if args.adapter_only_save:
                p = save_adapter_only(args.output_dir, step + 1, params)
            else:
                # async: the chips stall only for the host staging copy;
                # serialization overlaps the next training steps (orbax
                # commits atomically, so a kill mid-write can't leave a
                # resumable half checkpoint)
                p = save_checkpoint(
                    args.output_dir, step + 1, params, opt_state,
                    async_save=True,
                )
            rank0_print(f"[train] saved {p} "
                        f"(staged in {time.time() - t_s:.1f}s)")
    if profiler_ctx is not None:  # fewer than 3 steps after compile
        profiler_ctx.__exit__(None, None, None)
    from lavida_mod.utils import wait_for_saves

    t_w = time.time()
    wait_for_saves()  # commit in-flight async saves before exit
    if time.time() - t_w > 0.1:
        rank0_print(f"[train] final save commit: {time.time() - t_w:.1f}s")
    logger.close()


if __name__ == "__main__":
    main()
