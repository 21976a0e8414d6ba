"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; sharding tests use
xla_force_host_platform_device_count (SURVEY.md section 4).

The suite runs on the CPU unless JAX_PLATFORMS says otherwise. Tests
marked `gpu` need a card: run them with
`JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`; elsewhere the
`gpu_device` fixture skips them.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU JAX can see; skips the test when there is none.
    Decided here, when the test runs, never at import: every xdist
    worker must collect the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on a "
                    "machine with a card)")
    return gpus[0]


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_executables():
    """Release compiled XLA CPU executables between test modules.

    A full-suite run accumulates hundreds of live CPU executables; at
    ~the 73rd test the NEXT backend_compile segfaults inside XLA:CPU
    (reproduced twice at the same spot, never in isolation or in short
    runs). Dropping caches per module keeps the live-executable set
    bounded; within-module compile reuse - where almost all sharing
    happens - is unaffected."""
    yield
    jax.clear_caches()
