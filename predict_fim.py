#!/usr/bin/env python
"""FIM (fill-in-the-middle) inference CLI — analogue of reference
predict_fim.py: a draft answer skeleton containing `<|mdm_mask|>` holes and
`<|reserved_token_1|>` infill markers is written into the generation buffer
(generate.py:189-191); only the holes are denoised, the rest of the draft is
kept verbatim.

Usage:
  python predict_fim.py --model-path CKPT --image img.png \\
      --prompt "Write a poem about the image." \\
      --draft $'A line<|mdm_mask|><|mdm_mask|>{FIM}\\nNext<|mdm_mask|>{FIM}' \\
      [--max-new-tokens 256] [--schedule shift --schedule-shift 0.3333]

Without --model-path a tiny random model runs with synthetic ids (the holes
are ids == mask; useful for smoke/latency checks).
"""

from __future__ import annotations

import argparse

import numpy as np

FIM_TOKEN = "<|reserved_token_1|>"
MASK_TOKEN = "<|mdm_mask|>"

DEFAULT_DRAFT = (
    "\nSure, here is a poem about the image:\n"
    + ("A" + MASK_TOKEN * 11 + FIM_TOKEN + "\n")
    + ("Be" + MASK_TOKEN * 11 + FIM_TOKEN + "\n")
    + ("Ca" + MASK_TOKEN * 11 + FIM_TOKEN + "\n")
    + ("De" + MASK_TOKEN * 11 + FIM_TOKEN + "\n")
    + "<|eot_id|>"
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--image", default=None)
    ap.add_argument("--prompt", default="Write a poem about the image.")
    ap.add_argument("--draft", default=DEFAULT_DRAFT)
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--step-ratio", type=float, default=1.0)
    ap.add_argument("--schedule", default="shift")
    ap.add_argument("--schedule-shift", type=float, default=1 / 3)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from lavida_mod.utils.compile_cache import enable as _cc

    _cc()  # 8B serve graphs take minutes to compile cold; cache them

    import jax.numpy as jnp

    from lavida_mod.config import (
        GenerationConfig, LaViDaConfig, VisionConfig,
        tiny_llada_config, tiny_siglip_config,
    )
    from lavida_mod.data import SigLIPImageProcessor, process_images
    from lavida_mod.data.conversation import get_conv_template
    from lavida_mod.data.prompts import tokenizer_image_token
    from lavida_mod.models.lavida import LaViDa

    if args.tiny or not args.model_path:
        cfg = LaViDaConfig(
            llada=tiny_llada_config(),
            vision=VisionConfig(
                siglip=tiny_siglip_config(), mm_hidden_size=32,
                grid_pinpoints=((56, 112), (112, 56), (112, 112)),
            ),
        )
        model = LaViDa.random_init(cfg, args.seed, jnp.float32)
        tokenizer = None
        print("[predict_fim] random-init tiny model")
    else:
        # geometry sniffed from the checkpoint's config.json
        # (config_from_checkpoint); serving layout (predict.py:111-119):
        # host_staging keeps the bf16 copy off the device until
        # quantized
        model = LaViDa.load(args.model_path, host_staging=True)
        model.to_serving_layout(quant="int8")
        from lavida_mod.data.tokenizer import load_hf_or_offline

        tokenizer = load_hf_or_offline(args.model_path)
    cfg = model.cfg

    images, sizes = [], []
    if args.image:
        from PIL import Image

        img = Image.open(args.image)
        proc = SigLIPImageProcessor(size=cfg.vision.siglip.image_size)
        images = [process_images([img], proc, cfg.vision)[0]]
        sizes = [img.size]
        user_msg = "<image>\n" + args.prompt
    else:
        user_msg = args.prompt

    conv = get_conv_template("llada")
    if tokenizer is not None:
        conv.tokenizer = tokenizer
    conv.append_message(conv.roles[0], user_msg)
    prompt = conv.get_prompt()

    mask_id = cfg.llada.mask_token_id
    if tokenizer is not None:
        input_ids = tokenizer_image_token(prompt, tokenizer)
        draft_tokens = np.asarray(tokenizer(args.draft).input_ids)
    else:
        rng = np.random.default_rng(args.seed)
        input_ids = np.concatenate(
            [rng.integers(3, 400, size=6),
             [-200] if args.image else [],
             rng.integers(3, 400, size=8)]
        ).astype(np.int64)
        draft_tokens = rng.integers(3, 400, size=24)
        draft_tokens[rng.random(24) < 0.5] = mask_id

    G = max(args.max_new_tokens, len(draft_tokens))
    G = ((G + 31) // 32) * 32  # block alignment
    gen = GenerationConfig(
        max_new_tokens=G, block_length=G,
        step_ratio=args.step_ratio, schedule=args.schedule,
        schedule_shift=args.schedule_shift, prefix_lm=True,
    )
    out = model.generate(
        input_ids, images, sizes, gen, draft_tokens=draft_tokens,
    )
    # drafted (non-hole) positions survive
    keep = draft_tokens != mask_id
    assert (out[: len(draft_tokens)][keep] == draft_tokens[keep]).all()
    if tokenizer is not None:
        text = tokenizer.decode(out, skip_special_tokens=False)
        print(text.replace("<|endoftext|>", ""))
    else:
        print("[predict_fim] output ids:", out.tolist())
        print("[predict_fim] holes filled:",
              int((np.asarray(out) != mask_id).sum()), "/", len(out))


if __name__ == "__main__":
    main()
