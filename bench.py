"""Benchmark: BOS curved-ray rendering throughput (rays/s/chip).

Measures the flagship workload — the reference's BOS sample scene
(1024x1024 sensor, ~1000 dots x ~100 source points x 500 rays, RK4 march
through a 64^3 density volume, erf-diffraction sensor) — on one NVIDIA
GPU (it exits non-zero when JAX finds none, and when any phase fails),
prints the card's name and power limit to stderr, and prints ONE JSON
line:

    {"metric": "...", "value": N, "unit": "rays/s/chip", "vs_baseline": N}

Baseline note: the reference publishes no numbers (BASELINE.md) and its
shipped CUDA binary is a debug build (-O0 -G, sm_30).  ``BASELINE_RAYS_S``
below is a *generous* estimate of an optimized single-GPU CUDA build of
the reference on this workload (~5M rays/s); the shipped debug build would
be far slower.  vs_baseline = measured / BASELINE_RAYS_S.

Timing methodology: every metric is total_rays / MEDIAN of >= 3 timed
reps (default 10 for the headline), with {median, min, max, spread} and
the raw rep times recorded in the JSON under *_stats — the artifact
carries its own uncertainty, and docs must quote the recorded medians.

Env overrides for quick runs: PHOTON_BENCH_DOTS, PHOTON_BENCH_RAYS,
PHOTON_BENCH_REPS, PHOTON_BENCH_SENSOR.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

BASELINE_RAYS_S = 5.0e6


def time_reps(run, reps: int):
    """Median-based timing: run ``run()`` ``reps`` times, return stats.

    The headline number is total/median; min and spread are recorded so
    the artifact carries the measurement uncertainty.
    """
    ts = []
    for _ in range(reps):
        t0 = time.time()
        run()
        ts.append(time.time() - t0)
    ts_sorted = sorted(ts)
    median = ts_sorted[len(ts) // 2] if len(ts) % 2 else 0.5 * (
        ts_sorted[len(ts) // 2 - 1] + ts_sorted[len(ts) // 2])
    return {"median_s": median, "min_s": ts_sorted[0],
            "max_s": ts_sorted[-1],
            "spread_s": ts_sorted[-1] - ts_sorted[0], "times_s": ts}


def build_scene(n_dots: int, rays_per_dot: int, sensor: int):
    from photon_tpu.config import default_config
    from photon_tpu.models.optics import camera_setup
    from photon_tpu.models.scenes import bos_source
    from photon_tpu.utils.rng import lens_samples
    from photon_tpu.volume import build_density_volume

    cfg = default_config("bos")
    cfg.camera_design.x_pixel_number = sensor
    cfg.camera_design.y_pixel_number = sensor
    cfg.bos_pattern.grid_point_number = n_dots
    cfg.bos_pattern.particle_number_per_grid_point = 100
    cfg.bos_pattern.lightray_number_per_particle = rays_per_dot
    cfg.density_gradients.simulate_density_gradients = True
    # keep the dot field inside the (possibly reduced) sensor's field of view
    m = cfg.lens_design.focal_length / (
        cfg.lens_design.object_distance - cfg.lens_design.focal_length)
    half = 0.8 * sensor * cfg.camera_design.pixel_pitch / 2.0 / m
    cfg.bos_pattern.X_Min, cfg.bos_pattern.X_Max = -half, half
    cfg.bos_pattern.Y_Min, cfg.bos_pattern.Y_Max = -half, half
    setup = camera_setup(cfg)
    source, _, _ = bos_source(cfg, setup, np.random.default_rng(1105))
    r1, r2 = lens_samples(jax.random.key(1105), rays_per_dot)

    # synthetic 64^3 density volume matching the sample-data scene scale
    # (NRRD-frame z: dot plane at z = object_distance)
    n = 64
    x = np.linspace(-1.5e5, 1.5e5, n)
    z = np.linspace(setup.object_distance - 5e5,
                    setup.object_distance - 1e2, n)
    rho = 1.225 + 5.0 * (x[:, None, None] - x.min()) / (x.max() - x.min()) \
        * np.ones((1, n, n))
    vol = build_density_volume(
        rho, [x[1] - x[0], x[1] - x[0], z[1] - z[0]], [x[0], x[0], z[0]])
    return cfg, setup, source, np.asarray(r1), np.asarray(r2), vol


def build_piv_scene(n_particles: int = 50_000, rays_per: int = 10_000):
    """The reference's sample PIV scene — 5e4 particles x 1e4
    rays/particle, Mie scattering with 128 angles and 27 log-normal
    diameters, 1024^2 sensor (create_sample_simulation_parameters.py:70-71)."""
    from photon_tpu.config import default_config
    from photon_tpu.models.optics import camera_setup
    from photon_tpu.models.scenes import piv_source
    from photon_tpu.ops.mie import create_mie_scattering_data
    from photon_tpu.utils.rng import lens_samples

    cfg = default_config("piv")
    cfg.particle_field.particle_number = n_particles
    cfg.particle_field.lightray_number_per_particle = rays_per
    rng = np.random.default_rng(1105)
    setup = camera_setup(cfg)
    scattering = create_mie_scattering_data(cfg, rng)
    source = piv_source(
        cfg, setup, 1,
        diameter_index_distribution=scattering[
            "particle_diameter_index_distribution"], rng=rng)
    r1, r2 = lens_samples(jax.random.key(1105), rays_per)
    return cfg, setup, source, np.asarray(r1), np.asarray(r2), scattering


def bench_piv_mie(reps: int) -> float:
    """PIV+Mie flagship throughput (rays/s) on :func:`build_piv_scene`."""
    from photon_tpu.models.render_fast import render_image_fast

    rays_per = int(os.environ.get("PHOTON_BENCH_PIV_RAYS", 10_000))
    cfg, setup, source, r1, r2, scattering = build_piv_scene(
        int(os.environ.get("PHOTON_BENCH_PIV_PARTICLES", 50_000)), rays_per)

    # bound the in-flight (P, R) fan: ~2e7 rays per chunk
    ppc = max(1, 20_000_000 // rays_per)

    def run():
        img = render_image_fast(cfg, setup, source, r1, r2,
                                scattering=scattering,
                                particles_per_chunk=ppc)
        img.block_until_ready()
        return img

    t0 = time.time()
    img = run()
    print(f"# piv compile+first: {time.time() - t0:.1f}s, image sum "
          f"{float(img.sum()):.4g}, rays {source.num_rays}", file=sys.stderr)
    st = time_reps(run, reps)
    print(f"# piv times: {[f'{t:.3f}' for t in st['times_s']]}",
          file=sys.stderr)
    # dispatch-amortized cross-check: 4 renders back-to-back, one sync
    def run4():
        imgs = [render_image_fast(cfg, setup, source, r1, r2,
                                  scattering=scattering,
                                  particles_per_chunk=ppc)
                for _ in range(4)]
        imgs[-1].block_until_ready()
    st4 = time_reps(run4, max(reps // 2, 3))
    st["amortized_per_render_s"] = st4["median_s"] / 4
    print(f"# piv amortized/render: {st4['median_s'] / 4:.3f}s",
          file=sys.stderr)
    # headline = the dispatch-amortized figure; wall medians stay in
    # piv_stats
    st["wall_median_rays_per_s"] = source.num_rays / st["median_s"]
    return source.num_rays / st["amortized_per_render_s"], st


def build_vol512(setup, n: int = 512):
    """A 512^3 device-built volume with a STRUCTURED (separable
    Gaussian) density profile.

    The field (2.1 GB at 512^3) is constructed ON DEVICE from three
    1-D factors (no multi-GB host->device transfer); the gradient
    channels are the analytic separable derivatives.  The Gaussian makes
    every sample position-dependent, so a march that reads the wrong
    voxels changes the image.
    """
    import jax.numpy as jnp

    from photon_tpu.volume import DensityVolume, Z_ORIGIN_SHIFT

    x = np.linspace(-1.5e5, 1.5e5, n)
    z = np.linspace(setup.object_distance - 5e5,
                    setup.object_distance - 1e2, n)
    K = 0.225e-3
    amp = 2.0
    sig_l = 0.35 * (x.max() - x.min())
    sig_z = 0.35 * (z.max() - z.min())
    zc = 0.5 * (z.min() + z.max())
    gx = jnp.asarray(np.exp(-(x / sig_l) ** 2 / 2.0), jnp.float32)
    gz = jnp.asarray(np.exp(-((z - zc) / sig_z) ** 2 / 2.0), jnp.float32)
    dgx = jnp.asarray(-(x / sig_l ** 2), jnp.float32)   # d/dx factor
    dgz = jnp.asarray(-((z - zc) / sig_z ** 2), jnp.float32)
    # field[z, y, x, c]; c = [K drho/dx, K drho/dy, K drho/dz, K rho]
    g3 = gz[:, None, None] * gx[None, :, None] * gx[None, None, :]
    rho = 1.225 + amp * g3
    field = jnp.stack([
        jnp.float32(K * amp) * g3 * dgx[None, None, :],
        jnp.float32(K * amp) * g3 * dgx[None, :, None],
        jnp.float32(K * amp) * g3 * dgz[:, None, None],
        jnp.float32(K) * rho], axis=-1)
    spac = np.array([x[1] - x[0], x[1] - x[0], z[1] - z[0]])
    origin = np.array([x[0], x[0], z[0] - Z_ORIGIN_SHIFT])
    return DensityVolume(
        field=field,
        min_bound=jnp.asarray(origin, jnp.float32),
        max_bound=jnp.asarray(origin + (n - 1.0) * spac, jnp.float32),
        grid_spacing=jnp.asarray(spac, jnp.float32),
        data_min=float(K * 1.225),
        step_size=float(spac.min()), max_step_size=float(spac.max()))


def bench_vol512(cfg, setup, source, r1, r2, reps: int):
    """Large-volume flagship: the same BOS scene marched through a
    structured 512^3 volume (slabs beyond the dense cap, so the chief
    rays take the tube march).  Also times the 512^3 forward+backward
    (gradient w.r.t. the full 2 GB field)."""
    from photon_tpu.models.render_fast import render_image_fast

    vol = build_vol512(setup)

    def run():
        img = render_image_fast(cfg, setup, source, r1, r2, vol=vol)
        img.block_until_ready()
        return img

    t0 = time.time()
    img = run()
    print(f"# vol512 compile+first: {time.time() - t0:.1f}s, image sum "
          f"{float(img.sum()):.4g}", file=sys.stderr)
    st = time_reps(run, reps)
    print(f"# vol512 times: {[f'{t:.3f}' for t in st['times_s']]}",
          file=sys.stderr)

    field0 = vol.field

    def loss(field):
        v = vol._replace(field=field)
        img = render_image_fast(cfg, setup, source, r1, r2, vol=v)
        return jnp.mean(img * img)

    vg = jax.jit(jax.value_and_grad(loss))

    def run_bwd():
        _, g = vg(field0)
        g.block_until_ready()

    t0 = time.time()
    _, g = vg(field0)
    g.block_until_ready()
    gsum = float(jnp.abs(g).sum())
    del g     # a live 2.1 GB gradient would crowd the timed reps
    print(f"# vol512 fwd+bwd compile+1st: {time.time() - t0:.1f}s "
          f"grad |sum| {gsum:.3g}", file=sys.stderr)
    st_bwd = time_reps(run_bwd, max(reps - 1, 3))
    rate_bwd = source.num_rays / st_bwd["median_s"]
    print(f"# vol512 fwd+bwd times: "
          f"{[f'{t:.3f}' for t in st_bwd['times_s']]}", file=sys.stderr)
    return source.num_rays / st["median_s"], st, rate_bwd, st_bwd


def main() -> int:
    from photon_tpu.models.render_fast import render_image_fast
    from photon_tpu.utils.compile_cache import enable_compile_cache
    from photon_tpu.utils.device import (device_record, nvidia_smi_cards,
                                         require_gpu)

    enable_compile_cache()
    require_gpu()
    device = device_record(jax.devices())
    print(f"# device: {device}", file=sys.stderr)
    print(f"# card: {nvidia_smi_cards()}", file=sys.stderr)

    n_dots = int(os.environ.get("PHOTON_BENCH_DOTS", 1000))
    rays_per_dot = int(os.environ.get("PHOTON_BENCH_RAYS", 500))
    sensor = int(os.environ.get("PHOTON_BENCH_SENSOR", 1024))
    reps = int(os.environ.get("PHOTON_BENCH_REPS", 10))

    cfg, setup, source, r1, r2, vol = build_scene(n_dots, rays_per_dot,
                                                  sensor)
    total_rays = source.num_rays

    def run():
        img = render_image_fast(cfg, setup, source, r1, r2, vol=vol)
        img.block_until_ready()
        return img

    t0 = time.time()
    img = run()
    compile_s = time.time() - t0
    print(f"# compile+first run: {compile_s:.1f}s, image sum "
          f"{float(img.sum()):.4g}, rays {total_rays}", file=sys.stderr)

    fwd_stats = time_reps(run, reps)
    print(f"# times: {[f'{t:.3f}' for t in fwd_stats['times_s']]}",
          file=sys.stderr)
    # headline = dispatch-amortized time (4 renders back-to-back, one
    # sync), like the PIV metric; wall reps stay recorded in fwd_stats

    def run4():
        imgs = [render_image_fast(cfg, setup, source, r1, r2, vol=vol)
                for _ in range(4)]
        imgs[-1].block_until_ready()
    st4 = time_reps(run4, max(reps // 2, 3))
    fwd_stats["amortized_per_render_s"] = st4["median_s"] / 4
    fwd_stats["wall_median_rays_per_s"] = (
        total_rays / fwd_stats["median_s"])
    rays_per_s = total_rays / fwd_stats["amortized_per_render_s"]
    print(f"# fwd amortized/render: {st4['median_s'] / 4:.3f}s",
          file=sys.stderr)

    # secondary: forward+backward (gradient w.r.t. the density field)
    fwd_bwd_rays_per_s = None
    bwd_stats = None
    if os.environ.get("PHOTON_BENCH_BWD", "1") == "1":
        field0 = vol.field

        def loss(field):
            v = vol._replace(field=field)
            img = render_image_fast(cfg, setup, source, r1, r2, vol=v)
            return jnp.mean(img * img)

        vg = jax.jit(jax.value_and_grad(loss))

        def run_bwd():
            _, g = vg(field0)
            g.block_until_ready()

        t0 = time.time()
        l, g = vg(field0)
        g.block_until_ready()
        print(f"# fwd+bwd compile+1st: {time.time() - t0:.1f}s "
              f"grad norm {float(jnp.abs(g).sum()):.3g}",
              file=sys.stderr)
        bwd_stats = time_reps(run_bwd, max(reps - 2, 3))
        fwd_bwd_rays_per_s = total_rays / bwd_stats["median_s"]
        print(f"# fwd+bwd times: "
              f"{[f'{t:.3f}' for t in bwd_stats['times_s']]}",
              file=sys.stderr)

    record = {
        "metric": "bos_rk4_forward_rays_per_s",
        "value": rays_per_s,
        "unit": "rays/s/chip",
        "vs_baseline": rays_per_s / BASELINE_RAYS_S,
        "timing": "median-based; see *_stats for min/spread",
        "device": device,
        "fwd_stats": fwd_stats,
    }
    if fwd_bwd_rays_per_s is not None:
        record["fwd_bwd_rays_per_s"] = fwd_bwd_rays_per_s
        record["fwd_bwd_stats"] = bwd_stats

    # second flagship: the reference's PIV sample workload — 5e4 Mie
    # particles x 1e4 rays (create_sample_simulation_parameters.py:70-71),
    # nang=128, 27 diameters, Gaussian sheet, no density gradients
    if os.environ.get("PHOTON_BENCH_PIV", "1") == "1":
        piv_rate, piv_stats = bench_piv_mie(reps)
        record["piv_mie_forward_rays_per_s"] = piv_rate
        record["piv_stats"] = piv_stats

    # large-volume flagship: 512^3 (tube march)
    if os.environ.get("PHOTON_BENCH_512", "1") == "1":
        rate512, st512, rate512b, st512b = bench_vol512(
            cfg, setup, source, r1, r2, max(reps // 2, 3))
        record["vol512_rays_per_s"] = rate512
        record["vol512_stats"] = st512
        record["vol512_fwd_bwd_rays_per_s"] = rate512b
        record["vol512_fwd_bwd_stats"] = st512b

    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
