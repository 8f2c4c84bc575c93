"""Terminal chat CLI (reference llava/serve/cli.py analogue): interactive
multi-turn conversation with one image, local model, no server needed."""

from __future__ import annotations

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--image", default=None)
    ap.add_argument("--conv-template", default="llada")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel bf16 serving over N devices "
                         "(requires --quant none; LaViDa.shard)")
    ap.add_argument("--quant", choices=["none", "int8", "int4", "mixed"],
                    default="int8",
                    help="LM serving layout (int8 default; int4 = "
                         "grouped int4 weights, fused layout; mixed = "
                         "int8 prefill + int4 decode; none = bf16)")
    args = ap.parse_args()

    from ..utils.compile_cache import enable as _cc

    _cc()  # 8B serve graphs take minutes to compile cold; cache them

    import numpy as np
    import jax.numpy as jnp

    from ..config import (
        GenerationConfig, LaViDaConfig, VisionConfig,
        tiny_llada_config, tiny_siglip_config,
    )
    from ..data import SigLIPImageProcessor, process_images
    from ..data.conversation import get_conv_template
    from ..data.prompts import tokenizer_image_token
    from ..models.lavida import LaViDa

    if args.tiny or not args.model_path:
        cfg = LaViDaConfig(
            llada=tiny_llada_config(),
            vision=VisionConfig(
                siglip=tiny_siglip_config(), mm_hidden_size=32,
                grid_pinpoints=((56, 112), (112, 56), (112, 112)),
            ),
        )
        model = LaViDa.random_init(cfg, 0, jnp.float32)
        tokenizer = None
        print("[cli] tiny random model (no checkpoint)")
    else:
        # geometry sniffed from the checkpoint's config.json; host
        # staging + quantized serving layout — a bf16 8B straight into
        # HBM OOMs next to its KV cache (rehearse_8b_load, README)
        if args.tp > 1 and args.quant != "none":
            raise SystemExit("--tp is bf16 serving; use --quant none")
        model = LaViDa.load(args.model_path,
                            host_staging=args.quant != "none"
                            or args.tp > 1)
        if args.tp > 1:
            model.shard(tp=args.tp)
        else:
            model.to_serving_layout(quant=args.quant)
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

    conv = get_conv_template(args.conv_template)
    if tokenizer is not None:
        conv.tokenizer = tokenizer
    first = True
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        block_length=min(128, args.max_new_tokens),
    )
    while True:
        try:
            user = input("USER: ").strip()
        except EOFError:
            break
        if not user or user in ("exit", "quit"):
            break
        msg = ("<image>\n" + user) if (first and images) else user
        first = False
        conv.append_message(conv.roles[0], msg)
        prompt = conv.get_prompt()
        if tokenizer is not None:
            ids = tokenizer_image_token(prompt, tokenizer)
        else:
            rng = np.random.default_rng(len(prompt))
            ids = np.concatenate([
                rng.integers(3, 400, size=6),
                [-200] if images else [],
                rng.integers(3, 400, size=6),
            ]).astype(np.int64)
        out = model.generate(ids, images, sizes, gen)
        reply = (model.decode_output(out, tokenizer) if tokenizer is not None
                 else " ".join(map(str, out[:16])))
        conv.append_message(conv.roles[1], reply)
        print("ASSISTANT:", reply)


if __name__ == "__main__":
    main()
