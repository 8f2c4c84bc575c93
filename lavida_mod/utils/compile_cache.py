"""Persistent XLA compilation cache for the CLIs.

Cold-start compiles of the fused serve graphs take minutes at the 8B
geometry (one executable for vision->prefill->denoise); the persistent
cache turns every later process start into a disk read.

Where the cache lives:
  - JAX_COMPILATION_CACHE_DIR, when set: jax reads it natively, and this
    module sets nothing at all;
  - otherwise one fixed directory inside the checkout (`.jax_cache/`,
    listed in .gitignore).  The path is part of what makes a cache hit,
    so it never moves.
"""

from __future__ import annotations

import logging
import os
import pathlib

DEFAULT_DIR = str(pathlib.Path(__file__).resolve().parents[2] / ".jax_cache")


def enable(min_compile_secs: float = 5.0) -> str | None:
    """Turn on jax's persistent compilation cache; returns its directory.

    With JAX_COMPILATION_CACHE_DIR set, returns it and changes nothing.
    Otherwise points the cache at DEFAULT_DIR (created if missing) and
    persists only entries that took at least `min_compile_secs` to
    compile.  An unwritable directory runs uncached and returns None:
    the cache is an optimization, never a startup-crash path."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    try:
        os.makedirs(DEFAULT_DIR, exist_ok=True)
    except OSError as e:
        logging.getLogger(__name__).warning(
            "compile cache disabled (%s unwritable: %s)", DEFAULT_DIR, e)
        return None
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return DEFAULT_DIR
