"""The card a measurement runs on: a check that there is one, its
description, and its published peak rates.

Every timing this repo prints names its device, and a path that measures
fails when JAX finds no GPU instead of timing the CPU backend.
"""

from __future__ import annotations

import os
import subprocess

# Dense peak rates (no sparsity) from NVIDIA's H100 data sheet, keyed by
# jax `device_kind`.  A device missing here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {        # H100 SXM5
        "bf16_flops": 989e12,
        "int8_ops": 1979e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
    "NVIDIA H100 PCIe": {
        "bf16_flops": 756e12,
        "int8_ops": 1513e12,
        "tf32_flops": 378e12,
        "f32_flops": 51e12,
        "hbm_bytes_per_s": 2.0e12,
    },
}


def peaks(device_kind: str) -> dict:
    """Published peaks of `device_kind`; raises for an unknown card."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peaks recorded for device {device_kind!r}; "
            f"add its data-sheet rates to utils/device.PEAKS")
    return PEAKS[device_kind]


def require_gpu() -> dict:
    """Describe the accelerator JAX runs on; exit non-zero without a GPU.

    Returns {"platform", "kind", "count"} as JAX reports them."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"no accelerator: JAX could not start ({e})")
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX runs on {d.platform!r} ({d.device_kind}); this "
            f"measures the card and does not run on the CPU backend")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def card_name_and_power_limit() -> str:
    """`name, power.limit` per card as nvidia-smi reports them, read by a
    child process that stays off JAX (one line per card)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip()


def describe() -> dict:
    """What a result line records about the run's device and setup."""
    import jax

    info = require_gpu()
    return {
        **info,
        "jax": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "compile_cache": (jax.config.jax_compilation_cache_dir
                          or os.environ.get("JAX_COMPILATION_CACHE_DIR")),
        "card": card_name_and_power_limit(),
    }
