"""Generate a synthetic LLaVA-layout finetune dataset (images + json).

For driving `train.py` end-to-end without HF datasets (the full CLI —
dataset -> collator -> step -> logger -> orbax -> resume).  Schema matches the reference's
LLaVA json ("image" + "conversations" with <image> in the first human
turn; /root/reference/llava/train/train.py:418-520 record handling).

Usage:
  python scripts/make_synthetic_data.py OUT_DIR [--n 64] [--size 384]
  -> OUT_DIR/data.json + OUT_DIR/images/*.png
"""

import argparse
import json
import os

import numpy as np

CAPTIONS = [
    "A colorful gradient test pattern with a bright diagonal stripe.",
    "A dark noisy field with a small light square in one corner.",
    "Horizontal bands of alternating warm and cool colors.",
    "A radial burst of color centered slightly off the middle.",
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--size", type=int, default=384)
    args = ap.parse_args()

    from PIL import Image

    img_dir = os.path.join(args.out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    records = []
    for i in range(args.n):
        name = f"img_{i:04d}.png"
        arr = (rng.random((args.size, args.size, 3)) * 255).astype("uint8")
        # give each image some structure so captions aren't pure noise
        arr[:, : args.size // 4, i % 3] = 255
        Image.fromarray(arr).save(os.path.join(img_dir, name))
        records.append({
            "id": f"syn-{i}",
            "image": name,
            "conversations": [
                {"from": "human", "value": "<image>\nDescribe this image."},
                {"from": "gpt", "value": CAPTIONS[i % len(CAPTIONS)]},
            ],
        })
    path = os.path.join(args.out_dir, "data.json")
    with open(path, "w") as f:
        json.dump(records, f)
    print(f"wrote {len(records)} records -> {path} (images in {img_dir})")


if __name__ == "__main__":
    main()
