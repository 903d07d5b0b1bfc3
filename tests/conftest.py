"""Test configuration: JAX runs on the CPU unless ``JAX_PLATFORMS`` is
already set, with 8 virtual CPU devices so the sharding tests exercise a
multi-device mesh. Tests marked ``gpu`` need a GPU; they skip elsewhere
(the ``gpu`` fixture decides at run time) and run on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu -p no:xdist tests/``."""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    import jax
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda -m gpu)")
    return devs[0]
