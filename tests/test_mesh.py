"""parallel/mesh.py: the mesh is a plain reshape of the device list, and
jax.distributed starts only when a coordinator is configured — a broken
configuration raises instead of being swallowed."""

import numpy as np
import pytest

import jax

from lavida_mod.parallel.mesh import make_mesh, maybe_init_distributed


@pytest.mark.parametrize("shape", [(1, 4, 2), (2, 2, 2), (1, 2, 4)])
def test_make_mesh_is_plain_reshape(shape):
    mesh = make_mesh(*shape)
    assert mesh.axis_names == ("dp", "fsdp", "tp")
    np.testing.assert_array_equal(
        np.vectorize(lambda d: d.id)(mesh.devices),
        np.asarray([d.id for d in jax.devices()]).reshape(shape))


def test_no_coordinator_is_a_noop(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    maybe_init_distributed()
    assert not jax.distributed.is_initialized()


def test_incomplete_coordinator_config_raises(monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    with pytest.raises(KeyError, match="JAX_NUM_PROCESSES"):
        maybe_init_distributed()
    assert not jax.distributed.is_initialized()
