"""Test configuration: CPU backend with a virtual 8-device mesh, float64 on.

The suite runs on the host CPU; kernels run in the Pallas interpreter, and
sharding paths run on virtual devices.  Tests that need the card carry the
`gpu` marker and skip elsewhere (decided inside a fixture, when the test
runs).  They run on the card with

    QCT_TEST_PLATFORM=gpu python -m pytest -m gpu tests/

which leaves JAX on its default (GPU) backend in float32.
"""

import os

ON_GPU = os.environ.get("QCT_TEST_PLATFORM") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

# The suite builds hundreds of solver instances, each with its own jit cache
# entries (solvers are identity-hashed jit statics); on small-RAM runners the
# accumulated XLA CPU executables eventually segfault the process.  Drop
# compiled caches between test modules — fresh problems recompile anyway,
# so this costs little.
import gc

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips on other backends"
    )


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()
    gc.collect()
