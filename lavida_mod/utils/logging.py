"""Logging / observability.

rank0_print mirrors llava/utils.py:73-86; MetricsLogger replaces the
reference's wandb reporting (llava_trainer.py:506-553) with a local JSONL
metrics stream plus optional wandb when available — including the
masked-token accuracy signal the reference logs as train/acc_mask.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import jax


def rank0_print(*args, **kwargs):
    if jax.process_index() == 0:
        print(*args, **kwargs, flush=True)


class MetricsLogger:
    def __init__(self, output_dir: str, use_wandb: bool = False,
                 project: str = "lavida_mod", run_name: Optional[str] = None):
        self.path = os.path.join(output_dir, "metrics.jsonl")
        os.makedirs(output_dir, exist_ok=True)
        self._f = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=project, name=run_name)
            except Exception as e:  # noqa: BLE001
                rank0_print(f"[logging] wandb unavailable: {e}")

    def log(self, step: int, metrics: dict):
        row = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._wandb:
            self._wandb.log(row, step=step)

    def close(self):
        self._f.close()
        if self._wandb:
            self._wandb.finish()
