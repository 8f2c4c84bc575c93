"""Async orbax checkpointing (SURVEY §5: async save of sharded pytrees).

save_checkpoint(async_save=True) must return after staging, commit on a
background thread (atomically — no resumable half checkpoint), serialize
back-to-back saves, and round-trip bit-exactly after wait_for_saves().
Reference cadence: /root/reference/llava/train/train.py:2163-2166.
"""

import numpy as np

import jax
import jax.numpy as jnp

from lavida_mod.utils import (
    latest_checkpoint, restore_checkpoint, save_checkpoint, wait_for_saves,
)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "w": jnp.asarray(rng.standard_normal((64, 64)) * scale, jnp.float32),
        "b": jnp.asarray(rng.standard_normal(64) * scale, jnp.bfloat16),
    }


def test_async_save_roundtrip(tmp_path):
    params = _tree(0)
    path = save_checkpoint(str(tmp_path), 1, params, async_save=True)
    wait_for_saves()
    restored = restore_checkpoint(path, {"params": params, "step": 0})
    assert int(restored["step"]) == 1
    for a, b in zip(jax.tree.leaves(restored["params"]),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_async_saves_serialize_and_latest_wins(tmp_path):
    """Back-to-back async saves (orbax queues the second behind the first's
    commit) both land; latest_checkpoint picks the newest; contents match
    the step they were staged at (mutating the source AFTER save must not
    corrupt the staged copy)."""
    p1 = _tree(1, scale=1.0)
    save_checkpoint(str(tmp_path), 1, p1, async_save=True)
    p2 = jax.tree.map(lambda x: x * 2, p1)
    save_checkpoint(str(tmp_path), 2, p2, async_save=True)
    wait_for_saves()
    assert latest_checkpoint(str(tmp_path)).endswith("checkpoint-2")
    r1 = restore_checkpoint(str(tmp_path / "checkpoint-1"),
                            {"params": p1, "step": 0})
    r2 = restore_checkpoint(str(tmp_path / "checkpoint-2"),
                            {"params": p2, "step": 0})
    np.testing.assert_array_equal(np.asarray(r1["params"]["w"]),
                                  np.asarray(p1["w"]))
    np.testing.assert_array_equal(np.asarray(r2["params"]["w"]),
                                  np.asarray(p2["w"]))


def test_async_with_opt_state_matches_sync(tmp_path):
    """The async payload layout must be identical to the sync one (a sync
    restore template reads an async-written checkpoint)."""
    import optax

    params = _tree(3)
    opt = optax.adamw(1e-3)
    st = opt.init(params)
    sync_p = save_checkpoint(str(tmp_path / "s"), 5, params, st)
    async_p = save_checkpoint(str(tmp_path / "a"), 5, params, st,
                              async_save=True)
    wait_for_saves()
    tmpl = {"params": params, "opt_state": jax.tree.map(np.asarray, st),
            "step": 0}
    rs = restore_checkpoint(sync_p, tmpl)
    ra = restore_checkpoint(async_p, tmpl)
    for a, b in zip(jax.tree.leaves(rs), jax.tree.leaves(ra)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
