"""Test configuration: run all tests on a virtual 8-device CPU backend.

Multi-device sharding logic is validated with
``--xla_force_host_platform_device_count=8``; bench.py and chip_smoke.py do
NOT import this and run on the GPU.

Tests that need the GPU carry the ``gpu`` marker and skip here (the
``gpu_device`` fixture decides, at run time).  On a GPU machine run them
with ``SPARTA_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu``.
"""
import os

ON_GPU = os.environ.get("SPARTA_TESTS_ON_GPU") == "1"
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

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on the CPU test backend")


@pytest.fixture
def gpu_device():
    """The GPU, or a skip when JAX's device is something else."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's device is {dev.platform!r}")
    return dev
