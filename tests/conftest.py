"""Test configuration: run JAX on a virtual 8-device CPU mesh with float64.

Multi-device sharding is validated without accelerator hardware by forcing
the host platform to expose 8 virtual devices.  float64 is enabled so solver
convergence checks match the reference's double-precision numerics; the
accelerator fast path uses float32/bfloat16.  The CPU platform is pinned
through ``jax.config`` as well as ``JAX_PLATFORMS`` so no test opens a GPU.

Tests of what only runs compiled on a GPU carry the ``gpu`` marker and take
the ``gpu_device`` fixture, which skips them here; ``chip_smoke.py`` runs
the same checks on the card.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_addoption(parser):
    parser.addoption(
        "--update-goldens", action="store_true", default=False,
        help="regenerate checked-in golden convergence curves",
    )


@pytest.fixture
def gpu_device():
    """The first JAX device, or a skip when it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (chip_smoke.py runs this check on the card)")
    return dev
