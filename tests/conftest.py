"""Test environment: CPU backend with 8 virtual devices.

Sharding tests exercise the multi-device path on a fake 8-device CPU mesh
(``--xla_force_host_platform_device_count``). x64 is enabled so parity tests
can match the float64 NumPy oracle bit-tightly.

Tests marked ``gpu`` need the card and skip elsewhere (``gpu`` fixture).
They run on a GPU machine with ``MPPI_TEST_GPU=1 python -m pytest tests/ -m
gpu``, which leaves JAX on its default (GPU) backend.
"""

import os

import pytest

if os.environ.get("MPPI_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if os.environ.get("MPPI_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at test time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU "
                    "lowering; run with MPPI_TEST_GPU=1 on the card")
    return jax.devices()[0]
