"""The accelerator a measurement runs on.

A measurement that finds no GPU fails; it does not fall back to the CPU.
The card's name and power limit come from ``nvidia-smi`` in a child
process that does not import JAX, so it takes no device memory.
"""
from __future__ import annotations

import subprocess


def nvidia_smi_cards() -> str:
    """``name, power.limit`` of each card, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=120)
    return out.stdout.strip()


def require_gpu(count: int = 1):
    """The first ``count`` JAX devices; exits non-zero unless they are
    GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        raise SystemExit(
            f"needs {count} NVIDIA GPU(s); JAX found {len(devices)} "
            f"{devices[0].platform} device(s)")
    return devices[:count]


def device_record(devices) -> dict:
    """Platform, kind and count of the devices, as JAX reports them."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}
