#!/usr/bin/env python
"""8B-scale on-disk serving rehearsal: synthesize a reference-layout HF
checkpoint at the REAL LaViDa-8B geometry (~16 GB sharded safetensors,
model.transformer.* / vision_tower / mm_projector keys + tokenizer), then
drive the full serving load path on it:

    load_state_shards -> convert_lavida_state_dict -> unstack_blocks
    -> to_fused_layout -> quantize_params(int4) -> generate on the chip

recording per-stage wall time and peak host RSS.  The tiny round-trips
(tests/test_checkpoint_loading.py) prove key NAMING; only a real-size run
proves the MEMORY path — load-time dtype blowups, stacking copies, and
host<->HBM transfer behavior live at 16 GB, not 16 MB.  Reference load
modes: /root/reference/llava/model/builder.py:62-123.

Usage:
  python scripts/rehearse_8b_load.py [--path /tmp/lavida8b_ckpt]
      [--synthesize-only] [--keep] [--skip-generate]

The synthesized checkpoint is deleted afterwards unless --keep (16 GB).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np


def _rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)


class _Filler:
    """Fast pseudo-random tensor filler: one 64K random block tiled out
    (np.random at GB scale costs minutes).  Values
    are repetitive but non-degenerate (quantization scales stay finite);
    this rehearses MEMORY and LAYOUT, not quality."""

    def __init__(self, seed=0, scale=0.02):
        rng = np.random.default_rng(seed)
        self.buf = (rng.standard_normal(1 << 16) * scale).astype(np.float32)

    def __call__(self, *shape):
        import ml_dtypes

        n = int(np.prod(shape))
        reps = -(-n // self.buf.size)
        out = np.tile(self.buf, reps)[:n].reshape(shape)
        return out.astype(ml_dtypes.bfloat16)  # HF checkpoints ship bf16


def synthesize(path: str, cfg) -> float:
    """Write the sharded-safetensors checkpoint; returns GiB on disk."""
    from safetensors.numpy import save_file

    os.makedirs(path, exist_ok=True)
    fill = _Filler()
    lm, vis = cfg.llada, cfg.vision.siglip
    D, M, E, L = (lm.d_model, lm.mlp_hidden_size, lm.vocab_size,
                  lm.n_layers)

    def lm_tensors():
        # names per llada_loader.py docstring (modeling_llada.py:1125-1159)
        yield "model.transformer.wte.weight", (E, D)
        yield "model.transformer.ln_f.weight", (D,)
        if not lm.weight_tying:
            yield "model.transformer.ff_out.weight", (E, D)
        for i in range(L):
            b = f"model.transformer.blocks.{i}."
            yield b + "attn_norm.weight", (D,)
            yield b + "ff_norm.weight", (D,)
            for ln, sh in (("q_proj", (D, D)), ("k_proj", (D, D)),
                           ("v_proj", (D, D)), ("attn_out", (D, D)),
                           ("ff_proj", (M, D)), ("up_proj", (M, D)),
                           ("ff_out", (D, M))):
                yield b + ln + ".weight", sh

    def vision_tensors():
        vD, vI = vis.hidden_size, vis.intermediate_size
        p = "model.vision_tower.vision_tower.vision_model."
        np_side = vis.num_patches_per_side
        yield (p + "embeddings.patch_embedding.weight",
               (vD, vis.num_channels, vis.patch_size, vis.patch_size))
        yield p + "embeddings.patch_embedding.bias", (vD,)
        yield (p + "embeddings.position_embedding.weight",
               (np_side * np_side, vD))
        # a real checkpoint ships all 27 layers; the converter drops the
        # last (siglip_encoder.py:240) — extra keys must be tolerated
        for i in range(vis.num_hidden_layers):
            b = p + f"encoder.layers.{i}."
            for ln in ("layer_norm1", "layer_norm2"):
                yield b + ln + ".weight", (vD,)
                yield b + ln + ".bias", (vD,)
            for ln, sh in (("self_attn.q_proj", (vD, vD)),
                           ("self_attn.k_proj", (vD, vD)),
                           ("self_attn.v_proj", (vD, vD)),
                           ("self_attn.out_proj", (vD, vD)),
                           ("mlp.fc1", (vI, vD)), ("mlp.fc2", (vD, vI))):
                yield b + ln + ".weight", sh
                yield b + ln + ".bias", (sh[0],)

    def projector_tensors():
        h = cfg.vision.mm_hidden_size
        yield "model.mm_projector.0.weight", (D, h)
        yield "model.mm_projector.0.bias", (D,)
        yield "model.mm_projector.2.weight", (D, D)
        yield "model.mm_projector.2.bias", (D,)
        yield "model.image_newline", (D,)

    # shard at ~4 GiB boundaries like HF does (model-0000x-of-0000N)
    all_items = (list(lm_tensors()) + list(vision_tensors())
                 + list(projector_tensors()))
    shards, cur, cur_bytes = [], {}, 0
    for name, shape in all_items:
        nbytes = int(np.prod(shape)) * 2
        if cur and cur_bytes + nbytes > 4 << 30:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[name] = shape
        cur_bytes += nbytes
    shards.append(cur)
    total = 0
    for i, shard in enumerate(shards):
        f = os.path.join(
            path, f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors")
        arrs = {k: fill(*sh) for k, sh in shard.items()}
        save_file(arrs, f)
        total += sum(a.nbytes for a in arrs.values())
        del arrs
        print(f"[synth] wrote {f} ({_rss_gb():.1f}G peak rss)")

    # minimal real tokenizer so predict.py's load path works end-to-end
    try:
        from tokenizers import (Tokenizer, decoders, models,
                                pre_tokenizers, trainers)

        tok = Tokenizer(models.BPE())
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(
            add_prefix_space=False, use_regex=True)
        tok.decoder = decoders.ByteLevel()
        tr = trainers.BpeTrainer(
            vocab_size=400,
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
        tok.train_from_iterator(
            ["describe the image in detail please"] * 50, tr)
        tok.save(os.path.join(path, "tokenizer.json"))
    except Exception as e:  # tokenizers lib absent: ids fall back
        print(f"[synth] no tokenizer.json ({e})")
    # full flat HF form (configuration_llada.py serialization) so
    # config_from_checkpoint sniffs the real geometry — what the serving
    # CLIs (worker/eval/predict) rely on when given only a path
    lm = cfg.llada
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "model_type": "llava_llada", "d_model": lm.d_model,
            "n_heads": lm.n_heads, "n_kv_heads": lm.n_kv_heads,
            "n_layers": lm.n_layers,
            "mlp_hidden_size": lm.mlp_hidden_size,
            "block_type": lm.block_type, "activation_type": lm.activation,
            "rope": lm.rope, "rope_theta": lm.rope_theta,
            "layer_norm_type": lm.layer_norm_type,
            "rms_norm_eps": lm.rms_norm_eps,
            "include_qkv_bias": lm.include_qkv_bias,
            "vocab_size": lm.vocab_size,
            "embedding_size": lm.embedding_size,
            "weight_tying": lm.weight_tying,
            "max_sequence_length": lm.max_sequence_length,
            "mask_token_id": lm.mask_token_id,
            "eos_token_id": lm.eos_token_id,
            "pad_token_id": lm.pad_token_id,
            "mm_hidden_size": cfg.vision.mm_hidden_size,
            "mm_projector_type": cfg.vision.projector_type,
            "image_aspect_ratio": cfg.vision.image_aspect_ratio,
            "image_grid_pinpoints": [list(p) for p in
                                     cfg.vision.grid_pinpoints],
            "mm_patch_merge_type": cfg.vision.mm_patch_merge_type,
        }, f)
    return total / (1 << 30)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default="/tmp/lavida8b_ckpt")
    ap.add_argument("--synthesize-only", action="store_true")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--skip-generate", action="store_true",
                    help="stop after quantize (no chip needed)")
    ap.add_argument("--gen-len", type=int, default=32)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lavida_mod.config import LaViDaConfig

    cfg = LaViDaConfig()
    stages = {}

    import glob

    if not glob.glob(os.path.join(args.path, "*.safetensors")):
        t0 = time.perf_counter()
        gib = synthesize(args.path, cfg)
        stages["synthesize_s"] = round(time.perf_counter() - t0, 1)
        stages["disk_gib"] = round(gib, 2)
    if args.synthesize_only:
        print(json.dumps(stages))
        return

    from lavida_mod.models import llada as llada_model
    from lavida_mod.models.lavida import LaViDa

    import gc

    def _stage(name):
        print(f"[stage] {name} rss={_rss_gb():.1f}G "
              f"t={time.perf_counter() - t_start:.0f}s", flush=True)

    t_start = time.perf_counter()
    # host_staging: the bf16 8B is converted on the host and only the
    # quantized layout is shipped to the device
    t0 = time.perf_counter()
    model = LaViDa.load(args.path, cfg, jnp.bfloat16, host_staging=True)
    stages["load_convert_s"] = round(time.perf_counter() - t0, 1)
    stages["rss_after_load_gb"] = round(_rss_gb(), 1)
    _stage("load+convert done")

    t0 = time.perf_counter()
    lp = llada_model.unstack_blocks(model.params["llada"])
    lp, lcfg = llada_model.to_fused_layout(lp, model.cfg.llada)
    model.cfg = model.cfg.replace(llada=lcfg)
    _stage("fused layout built")
    # drop the pre-fuse bf16 tree, and consume the fused one as it
    # quantizes: holding both across the quantize host-OOM'd at 125G
    model.params["llada"] = None
    gc.collect()
    _stage("pre-fuse tree dropped")

    def _progress(i, n, qblock):
        # flush the async host->device transfers every block — unflushed
        # staging buffers are a host-RSS leak at this scale
        jax.block_until_ready(jax.tree.leaves(qblock))
        if i % 4 == 0 or i == n - 1:
            print(f"[quant] block {i + 1}/{n} rss={_rss_gb():.1f}G",
                  flush=True)

    model.params["llada"] = llada_model.quantize_params(
        lp, bits=4, consume=True, progress=_progress)
    del lp
    gc.collect()
    _stage("quantize done")
    stages["fuse_quantize_s"] = round(time.perf_counter() - t0, 1)
    stages["rss_after_quant_gb"] = round(_rss_gb(), 1)

    t0 = time.perf_counter()
    model.to_device()
    stages["to_device_s"] = round(time.perf_counter() - t0, 1)
    hbm_bytes = sum(
        x.nbytes for x in jax.tree.leaves(model.params))
    stages["param_bytes_on_device_gb"] = round(hbm_bytes / (1 << 30), 2)

    if not args.skip_generate:
        from PIL import Image

        from lavida_mod.config import GenerationConfig
        from lavida_mod.data import SigLIPImageProcessor, process_images

        rng = np.random.default_rng(0)
        img = Image.fromarray(
            rng.integers(0, 255, (480, 640, 3), dtype=np.uint8))
        views = process_images(
            [img], SigLIPImageProcessor(size=cfg.vision.siglip.image_size),
            cfg.vision)[0]
        ids = rng.integers(3, 30000, size=24).tolist()
        input_ids = np.asarray(ids[:4] + [-200] + ids[4:], np.int64)
        gen = GenerationConfig(max_new_tokens=args.gen_len,
                               block_length=min(128, args.gen_len))
        t0 = time.perf_counter()
        out = model.generate(input_ids, [views], [img.size], gen)
        stages["first_generate_s"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        out = model.generate(input_ids, [views], [img.size], gen)
        stages["warm_generate_s"] = round(time.perf_counter() - t0, 3)
        stages["out_ids_head"] = [int(x) for x in out[:4]]

    stages["peak_rss_gb"] = round(_rss_gb(), 1)
    print(json.dumps(stages))

    if not args.keep:
        shutil.rmtree(args.path, ignore_errors=True)
        print(f"[rehearse] removed {args.path}")


if __name__ == "__main__":
    main()
