#!/usr/bin/env bash
# Dream-backbone evaluation (reference eval/run_dream.sh:13:
#  alg=topk_margin, prefix_lm=True)
CKPT="${CKPT:-ckpts/lavida-dream}"
python -m lavida_mod.eval --model-path "$CKPT" --lm-family dream \
  --tasks mme,mmmu_val \
  --gen-kwargs prefix_lm=True,alg=topk_margin --output results_dream.json
