"""2D spatial token pooling (reference llava_arch.py:198-233 get_2dPool).

Operates on projected vision tokens [N, g*g, D].  Torch semantics preserved:
  - "average"/"max": kernel=stride (F.avg_pool2d(x, stride)) -> floor(g/s)
  - "bilinear": F.interpolate to ceil(g/s) with align_corners=False, which is
    jax.image.resize's half-pixel convention.
LaViDa's default is bilinear stride 2: 27x27=729 -> 14x14=196 per view.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def _interp_matrix(g: int, go: int) -> np.ndarray:
    """Host-side [go, g] 2-tap bilinear weight matrix (half-pixel centers,
    no antialias — torch F.interpolate align_corners=False semantics)."""
    scale = g / go
    src = np.maximum((np.arange(go, dtype=np.float64) + 0.5) * scale - 0.5,
                     0.0).astype(np.float32)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, g - 1)
    w1 = src - i0.astype(np.float32)
    W = np.zeros((go, g), np.float32)
    np.add.at(W, (np.arange(go), i0), 1.0 - w1)
    np.add.at(W, (np.arange(go), i1), w1)  # i0==i1 rows sum to 1 exactly
    return W


def _bilinear_no_antialias(grid: jax.Array, go: int) -> jax.Array:
    """Torch F.interpolate(mode='bilinear', align_corners=False,
    antialias=False) semantics — jax.image.resize antialiases on downscale,
    torch does not.  Expressed as two small matmuls against a static 2-tap
    weight matrix instead of index gathers (dots are the form every
    backend runs fast), and the matrix rows contain the SAME two taps
    plus exact zeros, so the f32 result is unchanged."""
    N, g, _, D = grid.shape
    grid = grid.astype(jnp.float32)
    W = jnp.asarray(_interp_matrix(g, go))
    rows = jax.lax.dot_general(
        W, grid, (((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )  # [go, N, g, D]
    out = jax.lax.dot_general(
        W, rows, (((1,), (2,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )  # out[col, row, N, D]: second contraction ran over the column axis
    return out.transpose(2, 1, 0, 3)


def pool_2d(x: jax.Array, mode: str = "bilinear", stride: int = 2) -> jax.Array:
    """x: [N, T, D] with T a perfect square. Returns [N, T', D]."""
    N, T, D = x.shape
    g = int(round(float(np.sqrt(T))))
    assert g * g == T, (g, T)
    grid = x.reshape(N, g, g, D)
    if mode == "average":
        go = g // stride
        t = grid[:, : go * stride, : go * stride].reshape(
            N, go, stride, go, stride, D
        )
        out = t.mean(axis=(2, 4))
    elif mode == "max":
        go = g // stride
        t = grid[:, : go * stride, : go * stride].reshape(
            N, go, stride, go, stride, D
        )
        out = t.max(axis=(2, 4))
    elif mode == "bilinear":
        go = math.ceil(g / stride)
        out = _bilinear_no_antialias(grid, go).astype(x.dtype)
    else:
        raise ValueError(f"Unexpected pool mode: {mode}")
    return out.reshape(N, -1, D)
