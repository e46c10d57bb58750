"""Timers, rays/s accounting and profiler hooks.

The reference's observability is wall-clock printfs around the kernel
loop (ref: parallel_ray_tracing.cu:3498-3684, batch_run_simulation.py:53).
Equivalent: lightweight phase timers with rays/s, an optional
``jax.profiler`` trace context for per-op analysis, and ray-survival
statistics (the reference's NaN-culled rays, countable instead of
printf'd).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class PhaseTimer:
    """Accumulating phase timer with optional ray throughput."""

    phases: Dict[str, float] = field(default_factory=dict)
    rays: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, num_rays: Optional[int] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if num_rays:
                self.rays[name] = self.rays.get(name, 0) + int(num_rays)

    def report(self) -> str:
        lines = []
        for name, dt in self.phases.items():
            extra = ""
            if name in self.rays and dt > 0:
                extra = f"  {self.rays[name] / dt / 1e6:.2f}M rays/s"
            lines.append(f"{name}: {dt:.3f}s{extra}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context (view with xprof/tensorboard)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def ray_statistics(rays) -> Dict[str, float]:
    """Survival accounting for a traced RayBundle.

    The reference's failure convention poisons culled rays with NaN
    (SURVEY.md §5); this counts them so renders can report pitch/TIR/
    sensor cull fractions instead of silently losing energy.
    """
    pos = np.asarray(rays.pos)
    valid = np.isfinite(pos).all(axis=-1)
    n = pos.shape[0]
    return {
        "total_rays": float(n),
        "surviving": float(valid.sum()),
        "survival_fraction": float(valid.mean()) if n else 0.0,
    }
