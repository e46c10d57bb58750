"""Multi-device execution: particle sharding over a device mesh.

The reference is single-GPU/single-process (SURVEY.md §2 parallelism
table); its only concurrency is the CUDA grid and host-side KMAX particle
chunking.  The scaling model here:

* a 1-D ``jax.sharding.Mesh`` over the devices (``make_mesh``); every
  card of a host reaches every other at the same NVLink rate, so the
  mesh follows the algorithm alone;
* the particle batch sharded along the mesh axis — rays are
  embarrassingly parallel (``pad_to_multiple`` + NamedSharding, consumed
  by ``models.render_fast.render_image_fast(mesh=...)``, the production
  entry point);
* the density volume and optical parameters replicated per device
  (64^3 - 512^3 float4 volumes fit in device memory);
* each shard scatter-adds into a local image, reduced with one ``psum``
  over the mesh — see render_fast._get_sharded_render;
* gradients w.r.t. the replicated density field are all-reduced by the
  same ``psum`` transpose in the backward pass.

``python -m photon_tpu.parallel.shard`` runs the scaling harness: weak-
scaling sweeps of the sharded renderer (forward AND forward+backward)
over the visible devices, plus a reduced-vs-unreduced isolation of the
image psum's share of wall time (see ``scaling_report``).
"""
from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed for several processes (no-op for one).

    Call once per process before building meshes, with the coordinator's
    ``host:port``, the process count and this process's id.  After it
    returns, ``jax.devices()`` spans every process's devices and
    ``make_mesh()`` builds the global mesh.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "particles"
              ) -> Mesh:
    """A 1-D mesh over (up to) all visible devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def pad_to_multiple(arrays, multiple: int, fills=None):
    """Pad each array's leading dim to a multiple of the mesh size.

    ``fills[i]`` is the pad value for array i (default 0 — for the
    renderer's source arrays, zero radiance means padded particles
    contribute nothing; pass 1.0 for z so divisors stay finite).
    Returns (padded_arrays, original_length).
    """
    n = int(arrays[0].shape[0])
    pad = (-n) % multiple
    if pad == 0:
        return tuple(np.asarray(a) for a in arrays), n
    if fills is None:
        fills = [0.0] * len(arrays)
    out = []
    for a, fill in zip(arrays, fills):
        a = np.asarray(a)
        out.append(np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)]))
    return tuple(out), n


# ---------------------------------------------------------------------------
# Scaling harness (virtual CPU mesh or real devices)
# ---------------------------------------------------------------------------


def scaling_report(device_counts=(1, 2, 4, 8), dots_per_device: int = 128,
                   rays_per_dot: int = 64, sensor: int = 256,
                   reps: int = 5) -> dict:
    """Weak-scaling sweep of the sharded fast renderer (fwd and fwd+bwd).

    For each N in ``device_counts``: N * dots_per_device dots sharded
    over an N-device mesh, timed per render (median of ``reps``).
    Reports:

    * ``weak.*.weak_scaling_efficiency``: T(1) / T(N) at fixed per-device
      work — the textbook number.  On a virtual CPU mesh this is bounded
      by the *physical core count*, not the sharding design: all virtual
      devices share the host's cores, so compute serializes beyond
      n_cores (the caveat field records this).  On real devices this
      is the interconnect-limited number.
    * ``grad.*``: the same sweep for a full forward+backward step
      (gradient of mean(img^2) w.r.t. the REPLICATED density field) —
      this times the psum-transpose all-reduce of the field gradient
      that the backward pass inserts, the collective pattern of
      multi-chip BOS inversion.
    * ``collective.*.psum_fraction``: at each N, the SAME sharded
      forward is run twice — once psum-reduced, once returning per-shard
      images unreduced — and the fraction of wall time attributable to
      the reduce is (T_reduced - T_unreduced) / T_reduced.  Unlike the
      round-3 ``overhead_efficiency`` (whose unsharded baseline was
      confounded by XLA's different intra-op threading at N=1, reading
      >1), both runs here use identical compute and differ only in the
      collective, so the number isolates what it claims on any backend
      (on the virtual CPU mesh the host emulates the all-reduce through
      shared memory).
    """
    import os

    from photon_tpu.config import default_config
    from photon_tpu.models.optics import camera_setup
    from photon_tpu.models.render_fast import render_image_fast
    from photon_tpu.models.scenes import bos_source
    from photon_tpu.utils.rng import lens_samples
    from photon_tpu.volume import build_density_volume

    import jax.numpy as jnp

    def scene(n_dots):
        cfg = default_config("bos")
        cfg.camera_design.x_pixel_number = sensor
        cfg.camera_design.y_pixel_number = sensor
        cfg.bos_pattern.grid_point_number = n_dots
        # overlapping placement: every REQUESTED dot is placed (uniform
        # draws, no rejection).  The round-4 harness used the default
        # dart-throwing placement, which silently saturates at ~479 dots
        # in this fixed-FOV domain — n=4/8 then reran n=2's ray count
        # while the report still divided T(1)/T(N), making the recorded
        # efficiencies artifacts.  scaling_report now also *asserts*
        # constant per-device work below.
        cfg.bos_pattern.dot_overlap = True
        cfg.bos_pattern.particle_number_per_grid_point = 8
        cfg.bos_pattern.lightray_number_per_particle = rays_per_dot
        m = cfg.lens_design.focal_length / (
            cfg.lens_design.object_distance - cfg.lens_design.focal_length)
        half = 0.8 * sensor * cfg.camera_design.pixel_pitch / 2.0 / m
        cfg.bos_pattern.X_Min, cfg.bos_pattern.X_Max = -half, half
        cfg.bos_pattern.Y_Min, cfg.bos_pattern.Y_Max = -half, half
        setup = camera_setup(cfg)
        src, *_ = bos_source(cfg, setup, np.random.default_rng(1105))
        r1, r2 = lens_samples(jax.random.key(1105), rays_per_dot)
        n = 16
        x = np.linspace(-1.5e5, 1.5e5, n)
        z = np.linspace(setup.object_distance - 5e5,
                        setup.object_distance - 1e2, n)
        rho = 1.225 + 5.0 * (x[:, None, None] - x.min()) \
            / (x.max() - x.min()) * np.ones((1, n, n))
        vol = build_density_volume(
            rho, [x[1] - x[0], x[1] - x[0], z[1] - z[0]], [x[0], x[0], z[0]])
        return cfg, setup, src, np.asarray(r1), np.asarray(r2), vol

    n_avail = len(jax.devices())
    counts = [n for n in device_counts if n <= n_avail]
    report = {"devices_available": n_avail,
              "platform": jax.default_backend(),
              "physical_cores": os.cpu_count(),
              "device_counts": counts, "weak": {}, "grad": {},
              "collective": {}}

    def timed(fn):
        fn()                                  # compile
        ts = []
        for _ in range(reps):
            t0 = time.time()
            fn()
            ts.append(time.time() - t0)
        return sorted(ts)[len(ts) // 2]       # median

    t1 = g1 = rays1 = None
    for n in counts:
        args = scene(n * dots_per_device)
        cfg, setup, src, r1, r2, vol = args
        # weak scaling is only meaningful at constant per-device work:
        # refuse to report efficiencies from a saturated scene generator
        if rays1 is None:
            rays1 = src.num_rays / counts[0]
        if src.num_rays != n * rays1:
            raise AssertionError(
                f"weak-scaling invariant violated: n={n} runs "
                f"{src.num_rays} rays, expected {n} * {rays1:.0f} — the "
                "scene generator did not place the requested dots")
        mesh = make_mesh(n)

        def fwd(reduce=True):
            img = render_image_fast(cfg, setup, src, r1, r2, vol=vol,
                                    mesh=mesh, _mesh_reduce=reduce)
            img.block_until_ready()

        def loss(field):
            img = render_image_fast(cfg, setup, src, r1, r2,
                                    vol=vol._replace(field=field),
                                    mesh=mesh)
            return jnp.mean(img * img)

        grad_fn = jax.grad(loss)

        def grad_step():
            grad_fn(vol.field).block_until_ready()

        t_mesh = timed(fwd)
        t_nored = timed(lambda: fwd(reduce=False))
        t_grad = timed(grad_step)
        rays = src.num_rays
        report["weak"][n] = {"time_s": t_mesh, "rays": rays,
                             "rays_per_s": rays / t_mesh}
        report["grad"][n] = {"time_s": t_grad, "rays": rays,
                             "rays_per_s": rays / t_grad}
        report["collective"][n] = {
            "time_reduced_s": t_mesh, "time_unreduced_s": t_nored,
            "psum_fraction": max(0.0, (t_mesh - t_nored) / t_mesh)}
        if n == counts[0]:
            t1, g1 = t_mesh, t_grad
    for n in counts:
        report["weak"][n]["weak_scaling_efficiency"] = \
            min(t1 / report["weak"][n]["time_s"], 1.0)
        report["grad"][n]["weak_scaling_efficiency"] = \
            min(g1 / report["grad"][n]["time_s"], 1.0)
    report["caveat"] = (
        "virtual CPU mesh: all devices share the host's physical cores, so "
        "weak-scaling efficiency is compute-bound by cores/devices, not by "
        "the sharding design (efficiencies are clamped at 1.0 because more "
        "virtual devices also means more host threads). collective."
        "psum_fraction compares identical sharded programs with/without "
        "the image all-reduce, isolating the collective's share of wall "
        "time; grad.* times the full fwd+bwd step whose backward psum-"
        "transposes the replicated field gradient."
        if jax.default_backend() == "cpu"
        else "real accelerator mesh")
    return report


if __name__ == "__main__":
    rep = scaling_report()
    print(json.dumps(rep, indent=2, default=float))
