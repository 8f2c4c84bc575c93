#!/usr/bin/env bash
# COCO speed/quality run (reference eval/run_coco.sh:18:
#  prefix_lm=True, step_ratio=0.5, schedule=shift, shift=0.33)
CKPT="${CKPT:-runs/stage2/checkpoint-10000}"
python -m lavida_mod.eval --model-path "$CKPT" \
  --tasks coco2017_cap_val_lite \
  --gen-kwargs prefix_lm=True,step_ratio=0.5,schedule=shift,schedule__shift=0.33,max_new_tokens=32 \
  --output results_coco.json
