"""Worker for tests/test_multiprocess.py: one of two jax.distributed
processes, each with 4 virtual CPU devices (8 global).  Exercises the
real multi-process paths the 8-device single-process suite cannot:
cross-process mesh construction, dp-sharded train steps whose gradient
all-reduce crosses the process boundary, distributed eval gather, and a
sharded orbax save/restore round-trip.  Not a pytest file — launched as
a subprocess (argv: coordinator_port process_id tmpdir)."""

import os
import sys

port, pid, tmpdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2,
    process_id=pid)

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lavida_mod.config import LaViDaConfig, tiny_llada_config
from lavida_mod.models import llada as jl
from lavida_mod.parallel.mesh import make_mesh, maybe_init_distributed
from lavida_mod.parallel.sharding import shard_params
from lavida_mod.train.step import (jit_train_step, make_optimizer,
                                   make_train_step)

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
assert len(jax.local_devices()) == 4
maybe_init_distributed()  # must be a no-op when already initialized
assert jax.process_count() == 2

# --- mesh spanning both processes; dp axis crosses the process boundary ---
mesh = make_mesh(dp=2, fsdp=2, tp=2)

cfg = LaViDaConfig(llada=tiny_llada_config())
params = jl.init_params(cfg.llada, jax.random.PRNGKey(0))  # same seed both
params = shard_params(params, mesh)

opt = make_optimizer(lr=1e-2, total_steps=10)
opt_state = opt.init(params)
step = jit_train_step(make_train_step(cfg, opt, prefix_lm=True, remat=True))

rng = np.random.default_rng(0)  # identical data on both processes
B, L = 8, 16
ids_all = rng.integers(3, 400, size=(B, L))
labels_all = np.full((B, L), -100, np.int64)
labels_all[:, 8:] = ids_all[:, 8:]

# dp-shard the batch across processes: each provides its local half
lo, hi = pid * (B // 2), (pid + 1) * (B // 2)
emb_sh = NamedSharding(mesh, P(("dp",), None, None))
lab_sh = NamedSharding(mesh, P(("dp",), None))


def global_batch(params):
    emb_local = np.asarray(
        jl.embed_tokens(jax.device_get(params), jnp.asarray(ids_all))
    )[lo:hi]
    return {
        "inputs_embeds": jax.make_array_from_process_local_data(
            emb_sh, emb_local),
        "labels": jax.make_array_from_process_local_data(
            lab_sh, labels_all[lo:hi]),
    }


losses = []
for i in range(3):
    params, opt_state, metrics = step(
        params, opt_state, global_batch(params), jax.random.PRNGKey(i))
    losses.append(float(metrics["loss"]))
    assert np.isfinite(losses[-1])
assert losses[-1] < losses[0], losses

# --- distributed eval: shard_docs + allgather_rows ---
from lavida_mod.eval.evaluator import allgather_rows, shard_docs

docs = [{"id": i} for i in range(10)]
mine = shard_docs(docs)
assert len(mine) == 5 and all(d["id"] % 2 == pid for d in mine)
rows = [{"id": d["id"], "score": float(d["id"])} for d in mine]
merged = allgather_rows(rows)
assert sorted(r["id"] for r in merged) == list(range(10)), merged

# --- sharded orbax save / restore round-trip ---
from lavida_mod.utils.checkpoint import restore_checkpoint, save_checkpoint

path = save_checkpoint(tmpdir, step=3, params=params)
restored = restore_checkpoint(path, template={"params": params, "step": 3})
for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(restored["params"])):
    np.testing.assert_array_equal(np.asarray(jax.device_get(a)),
                                  np.asarray(jax.device_get(b)))

print(f"WORKER_OK pid={pid} losses={losses}")
