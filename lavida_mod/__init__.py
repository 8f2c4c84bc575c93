"""lavida_mod — a JAX (XLA/GSPMD) multimodal masked-diffusion
language-model framework with the capabilities of LaViDa (rkawamura0483/LaViDa_mod).

Layer map (mirrors SURVEY.md §1):

  ops/         pure compute: schedules, sampling, attention (one entry point
               that picks cuDNN or XLA per backend / blockwise online-softmax),
               rope, norms, pooling, int8/int4 quantized linears, kv-cache
               quantization
  models/      functional model cores (params pytrees): LLaDA, Dream, AR
               baselines, SigLIP, CLIP(+S2), projectors, resamplers, SHIRG,
               and the composed LaViDa multimodal model
  generation/  samplers: masked-diffusion denoise scans with prefix KV cache,
               Dream sampler, AR decode, MC log-likelihood, FIM drafts
  data/        host-side data & prompt layer: anyres geometry, image/video
               preprocessing (+native C++ extension), conversation templates,
               training datasets/mixtures/collator, FIM corruption
  parallel/    mesh construction + GSPMD sharding rules (replaces DeepSpeed ZeRO)
  train/       diffusion loss (complementary masking), multimodal pjit train
               step, LoRA, DPO, in-training eval hook
  eval/        evaluator + adapter + metrics + task registry (lmms-eval analogue)
  serve/       controller / worker / web UI / terminal chat
  utils/       checkpointing (orbax), logging, profiling, compile cache,
               the device check and peak table
  tools/       weight delta/consolidation utilities
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401,E402
    DreamGenerationConfig,
    GenerationConfig,
    LaViDaConfig,
    LLaDAConfig,
    SigLIPConfig,
    VisionConfig,
)
