"""Test configuration: run on a virtual 8-device CPU backend.

Multi-device sharding logic is validated on a host-platform device mesh
(SURVEY §4: the fake-backend trick). JAX_PLATFORMS defaults to cpu here;
tests that need the card carry the `gpu` marker and skip without one. On a
machine with a GPU they run with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q

and chip_smoke.py runs them in its own process (JAX already imported, so
the default below does not apply).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

from take_tpu.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running end-to-end tests")
    config.addinivalue_line("markers", "gpu: needs a CUDA GPU; skips without")


@pytest.fixture
def rng_np():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first device when it is a GPU; skips the test otherwise. Decided
    here, at run time, never while test modules are imported."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
