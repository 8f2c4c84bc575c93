"""Persistent-compilation-cache helper (utils/compile_cache.py): the CLIs
enable it so 8B cold-start compiles happen once per checkout, not once
per process.  Path rules: JAX_COMPILATION_CACHE_DIR wins and nothing
else is set; otherwise one fixed directory inside the checkout."""

import os
import pathlib

import jax
import pytest

from lavida_mod.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _restore_jax_cache_config():
    """Tests mutate global jax config; leaking a tmp_path cache dir into
    the rest of the suite would persist every >3s CPU-mesh compile."""
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", before[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      before[1])


def test_default_dir_is_fixed_inside_checkout():
    d = pathlib.Path(compile_cache.DEFAULT_DIR)
    assert d == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def test_enable_sets_config(tmp_path, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = str(tmp_path / "xla")
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", d)
    got = compile_cache.enable(min_compile_secs=3.0)
    assert got == d and os.path.isdir(d)
    assert jax.config.jax_compilation_cache_dir == d
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 3.0


def test_unwritable_dir_degrades_to_uncached(tmp_path, monkeypatch):
    """A read-only checkout must not crash CLI startup — enable() returns
    None and leaves jax config untouched."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    blocked = tmp_path / "blocked"
    blocked.write_text("a file, not a dir")  # makedirs -> OSError
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", str(blocked / "xla"))
    assert compile_cache.enable() is None
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("min_secs", [None, 0.0, 3.0])
def test_user_env_wins(tmp_path, monkeypatch, min_secs):
    """An explicit JAX_COMPILATION_CACHE_DIR is the user's configuration:
    enable() returns it and sets no jax option at all."""
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR",
                        str(tmp_path / "unused"))
    got = (compile_cache.enable() if min_secs is None
           else compile_cache.enable(min_compile_secs=min_secs))
    assert got == str(tmp_path)
    assert not (tmp_path / "unused").exists()
    assert (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs) == before
