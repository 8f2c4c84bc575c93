#!/usr/bin/env bash
# Stage 2 — full-model HD finetune
# (reference llada-hd-llada-s2.sh: anyres pinpoints, lr 2e-5 with vision
#  tower at 2e-6, ZeRO-3 bf16 engine -> fsdp mesh + mixed-precision policy,
#  cosine_with_min_lr, in-training lite evals.  Effective global batch
#  matches the reference's 128 = 8 GPUs x 4/device x accum 4.)
#
# Precision: --precision mixed = DeepSpeed bf16-engine parity (f32 masters
# + f32 Adam + f32 accumulation, bf16 compute).  The batch that fits a
# given card count is not measured yet: chip_smoke.py --four runs two
# full-depth 8B steps at fsdp=4 and prints per-card peak memory; size
# BATCH from that.  Effective global batch = BATCH x ACCUM (reference 128).
NGPUS=${NGPUS:-4}
PREC=${PREC:-mixed}
FSDP=$NGPUS
BATCH=${BATCH:-16}
ACCUM=${ACCUM:-8}
python train.py \
  --data-path "${DATA:-scripts/stage2.yaml}" \
  --model-path runs/stage1/checkpoint-2200 \
  --tokenizer-path "${BASE:-ckpts/llada-8b-instruct}" \
  --output-dir runs/stage2 \
  --tunable mm_mlp_adapter,mm_vision_tower,mm_language_model \
  --lr 2e-5 --vision-tower-lr 2e-6 --warmup-ratio 0.03 \
  --precision "$PREC" \
  --batch-size "$BATCH" --grad-accum "$ACCUM" --steps 10000 \
  --dp 1 --fsdp "$FSDP" --tp 1 \
  --remat nested --ce-chunk 512 \
  --eval-tasks chartqa --eval-every 1000 --eval-limit 64
