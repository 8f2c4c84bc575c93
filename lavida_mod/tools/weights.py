"""Weight tools (reference llava/model/apply_delta.py, make_delta.py,
consolidate.py — the LLaMA-license-era delta machinery + shard
consolidation), operating on state-dict-level numpy arrays so they work on
both torch shards and our converted checkpoints.

CLI:
  python -m lavida_mod.tools.weights apply-delta  --base B --delta D --target T
  python -m lavida_mod.tools.weights make-delta   --base B --target T --delta D
  python -m lavida_mod.tools.weights consolidate  --src S --dst D
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_state(path: str) -> dict[str, np.ndarray]:
    from ..models.lavida import load_state_shards

    return load_state_shards(path)


def save_state(state: dict[str, np.ndarray], path: str):
    os.makedirs(path, exist_ok=True)
    from safetensors.numpy import save_file

    save_file(
        {k: np.ascontiguousarray(v) for k, v in state.items()},
        os.path.join(path, "model.safetensors"),
    )


def apply_delta(base: dict, delta: dict) -> dict:
    """target = base + delta; keys only in delta pass through
    (apply_delta.py:20-40 semantics incl. embed_tokens row padding)."""
    out = {}
    for k, d in delta.items():
        if k not in base:
            out[k] = d
            continue
        b = base[k]
        if b.shape != d.shape:  # vocab-extended rows: add over the overlap
            out[k] = d.copy()
            sl = tuple(slice(0, min(bs, ds)) for bs, ds in
                       zip(b.shape, d.shape))
            out[k][sl] = out[k][sl] + b[sl]
        else:
            out[k] = b + d
    return out


def make_delta(base: dict, target: dict) -> dict:
    out = {}
    for k, t in target.items():
        if k not in base:
            out[k] = t
            continue
        b = base[k]
        if b.shape != t.shape:
            out[k] = t.copy()
            sl = tuple(slice(0, min(bs, ts)) for bs, ts in
                       zip(b.shape, t.shape))
            out[k][sl] = out[k][sl] - b[sl]
        else:
            out[k] = t - b
    return out


def consolidate(src: str, dst: str):
    """Merge sharded checkpoint files into one safetensors file
    (consolidate.py semantics)."""
    save_state(load_state(src), dst)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("command",
                    choices=["apply-delta", "make-delta", "consolidate"])
    ap.add_argument("--base")
    ap.add_argument("--delta")
    ap.add_argument("--target")
    ap.add_argument("--src")
    ap.add_argument("--dst")
    args = ap.parse_args()
    if args.command == "apply-delta":
        save_state(
            apply_delta(load_state(args.base), load_state(args.delta)),
            args.target,
        )
    elif args.command == "make-delta":
        save_state(
            make_delta(load_state(args.base), load_state(args.target)),
            args.delta,
        )
    else:
        consolidate(args.src, args.dst)


if __name__ == "__main__":
    main()
