"""Test configuration.

Tests run on the CPU, on a virtual 8-device mesh (XLA's host-platform
device-count override) so the sharding logic runs without several cards.
Tests marked ``gpu`` need an NVIDIA card and skip here.  On a machine
with one, ``python -m pytest -m gpu tests/`` runs them: with exactly that
marker expression the run is not pinned to the CPU, and the
``gpu_device`` fixture checks at run time that JAX found a card.
"""
import os

import pytest

import jax

from photon_tpu.utils.compile_cache import enable_compile_cache


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX finds none")
    if config.getoption("markexpr", "").strip() != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    enable_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when JAX finds none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu "
                    "tests/ on a machine with one)")
    return devices[0]
