"""Device mesh construction.

Replaces the reference's NCCL/DeepSpeed process topology (SURVEY.md §2.9):
one `jax.sharding.Mesh` with axes

  dp    pure data parallel (gradient all-reduce)
  fsdp  parameter/optimizer sharding — the GSPMD equivalent of ZeRO-2/3
        (scripts/zero{2,3}.json): params sharded at rest, all-gathered
        per layer by XLA as the scan consumes them
  tp    megatron-style tensor parallel over attention heads / MLP hidden

The mesh is a plain reshape of the device list: the cards of one host are
joined all to all (NVLink), so no axis order is closer than another.
Several processes: `maybe_init_distributed` before building the mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import os

import jax
import numpy as np
from jax.sharding import Mesh


AXES = ("dp", "fsdp", "tp")


def maybe_init_distributed() -> None:
    """Start jax.distributed when a coordinator is configured:
    JAX_COORDINATOR_ADDRESS (host:port) with JAX_NUM_PROCESSES and
    JAX_PROCESS_ID.  A single process with no coordinator, or one already
    initialised, is left as it is.  A configured coordinator that fails to
    start raises."""
    if jax.distributed.is_initialized():
        return
    address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not address:
        return
    jax.distributed.initialize(
        coordinator_address=address,
        num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
        process_id=int(os.environ["JAX_PROCESS_ID"]))


def make_mesh(
    dp: int = 1,
    fsdp: Optional[int] = None,
    tp: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (dp, fsdp, tp) mesh.  fsdp=None absorbs all remaining
    devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if fsdp is None:
        assert n % (dp * tp) == 0, (n, dp, tp)
        fsdp = n // (dp * tp)
    assert dp * fsdp * tp == n, (dp, fsdp, tp, n)
    return Mesh(np.asarray(devices).reshape(dp, fsdp, tp), AXES)
