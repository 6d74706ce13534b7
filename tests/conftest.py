"""Test env: force CPU JAX with 8 fake devices (standard JAX trick for
testing pmap/shard_map logic without a multi-device host — SURVEY.md §4).

Set through jax.config before any backend is initialized, so it holds even
where jax was imported before this file runs.

Tests that only the GPU can run carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them unless a GPU is the default
device. On the card: ``LLIE_TEST_ON_GPU=1 python -m pytest -m gpu tests/``
(the variable keeps the CPU override below off); ``chip_smoke.py`` covers
the same paths."""

import os

import jax
import pytest

if os.environ.get("LLIE_TEST_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu_device():
    """The GPU the test runs on; skips the test where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU, default device is {dev.platform}")
    return dev
