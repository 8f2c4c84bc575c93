#!/usr/bin/env bash
# Main-table evaluation sweep (reference eval/run.sh; note the reference's
# `refix_lm` typo meant its main table ran WITHOUT the prefix cache — we
# run both for comparison)
CKPT="${CKPT:-runs/stage2/checkpoint-10000}"
python -m lavida_mod.eval --model-path "$CKPT" \
  --tasks mme,mmmu_val,mmbench_en_dev,chartqa,docvqa_val,textvqa_val,ai2d,scienceqa_img \
  --gen-kwargs prefix_lm=True --output results_main.json
