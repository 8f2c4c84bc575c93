import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding logic
# is exercised without accelerator hardware (SURVEY.md §4).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = pathlib.Path("/root/reference")

sys.path.insert(0, str(REPO))


def has_reference() -> bool:
    return (REFERENCE / "llava").is_dir()


def install_reference_stub():
    """Register 'llava' / 'llava.model' as namespace-style packages pointing
    at the read-only reference, WITHOUT executing their __init__.py (which
    imports the whole torch model zoo and breaks on transformers drift).
    Lets tests import leaf modules (llava.mm_utils, ...siglip_base) as golden
    oracles."""
    import types

    if "llava" in sys.modules:
        return
    for name, path in [
        ("llava", REFERENCE / "llava"),
        ("llava.model", REFERENCE / "llava" / "model"),
    ]:
        pkg = types.ModuleType(name)
        pkg.__path__ = [str(path)]
        sys.modules[name] = pkg


@pytest.fixture(scope="session")
def reference_llava():
    if not has_reference():
        pytest.skip("reference repo not available")
    install_reference_stub()
    return REFERENCE


@pytest.fixture(scope="session")
def reference_llada():
    """Import the reference torch LLaDA implementation (read-only, used as a
    golden model for parity tests; skipped when unavailable)."""
    if not has_reference():
        pytest.skip("reference repo not available")
    sys.path.insert(0, str(REFERENCE / "llava" / "model" / "language_model"))
    import llada.modeling_llada as m

    return m


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU.  Decided when the test runs, never
    at import: the suite itself is pinned to the CPU above, so these run
    only where a process already holds the card (chip_smoke.py)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card by chip_smoke.py)")
