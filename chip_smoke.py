"""Smoke run of the renderer on NVIDIA GPUs, through the user entry points.

    python chip_smoke.py                # one card, every phase below
    python chip_smoke.py --four-cards   # the sharded path on four cards

Phases on one card, at the reference's widths with random (seeded) data:

* ``bos``: the reference's BOS sample workload (1,000 dots x 100 points x
  500 rays ~ 5e7 rays, 1024^2 sensor, RK4, trilinear) through a seeded
  synthetic 64^3 field written to NRRD, rendered by
  ``pipeline.run_simulation`` (im1 without, im2 with the field).
* ``bos_grad``: ``jax.value_and_grad`` of the same render w.r.t. the
  64^3 field, and three steps of ``inverse.invert_bos``.
* ``piv``: PIV + Mie, 5e4 particles x 1e4 rays, through ``run_simulation``.
* ``vol512``: the BOS scene through a device-built 512^3 field (the tube
  march), forward and value-and-grad.
* ``parity``: the golden images, the fast path against the exact path
  (image and field gradient), and the tube march against the dense march.

Each timed step prints its compile time, the median of 3 steady runs,
``compiled.memory_analysis()`` and the process's peak device memory so
far.  These are smoke timings of a cold process, not benchmark metrics.

It exits non-zero, and prints no result line, when JAX finds no GPU or
when any phase fails.  Its last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.abspath(__file__))


class Sizes(NamedTuple):
    bos_dots: int
    bos_points: int       # source points per dot
    bos_rays: int         # rays per source point
    sensor: int
    field_n: int          # side of the synthetic BOS field
    piv_particles: int
    piv_rays: int
    big_n: int            # side of the large (tube-march) field
    exact_dots: int       # reduced scene of the fast-vs-exact parity
    exact_rays: int


FULL = Sizes(bos_dots=1000, bos_points=100, bos_rays=500, sensor=1024,
             field_n=64, piv_particles=50_000, piv_rays=10_000, big_n=512,
             exact_dots=24, exact_rays=64)

# tolerances of the parity checks (PERF.md says why each is what it is)
GOLDEN_RTOL = 2e-3            # per pixel, as tests/test_golden.py
GOLDEN_L1 = 1e-3              # golden image relative L1
GOLDEN_OUTSIDE = 5e-3         # share of pixels outside the per-pixel tol
FAST_EXACT_L1 = 0.01          # README fast-vs-exact image budget
GRAD_COS_MIN = 0.97           # fast vs exact field gradient: cosine
GRAD_NORM_RTOL = 0.10         # ... and relative norm difference
TUBE_DENSE_ATOL = 1e-3        # tube vs dense deflection, x max deflection
SHARD_L1 = 2e-3               # sharded vs one-card image, relative L1
SHARD_GRAD_RTOL = 1e-2        # sharded vs one-card gradient, relative L2


def log(msg: str) -> None:
    print(msg, flush=True)


def _peak_bytes() -> str:
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "n/a" if peak is None else f"{peak / 2**30:.3f} GiB"


def measure(name: str, fn, *args, reps: int = 3):
    """Compile ``fn`` under jit, run it once plus ``reps`` timed times
    (each ending in block_until_ready) and print the smoke timings."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    mem = compiled.memory_analysis()
    mem_s = "n/a" if mem is None else (
        f"args {mem.argument_size_in_bytes / 2**20:.1f} MiB, "
        f"out {mem.output_size_in_bytes / 2**20:.1f} MiB, "
        f"temp {mem.temp_size_in_bytes / 2**20:.1f} MiB, "
        f"code {mem.generated_code_size_in_bytes / 2**20:.1f} MiB")
    log(f"[smoke] {name}: compile {compile_s:.2f} s; steady median "
        f"{float(np.median(times)):.4f} s of {reps} "
        f"({', '.join(f'{t:.4f}' for t in times)}); memory_analysis: "
        f"{mem_s}; peak_bytes_in_use so far {_peak_bytes()} "
        "(smoke timing, not a benchmark metric)")
    return out


class Checks:
    """Parity and sanity results; any failure fails the run at the end."""

    def __init__(self):
        self.failed = []

    def value(self, name: str, err: float, tol: float, *,
              at_least: bool = False) -> None:
        ok = bool(np.isfinite(err)) and (err >= tol if at_least
                                         else err <= tol)
        rel = ">=" if at_least else "<="
        log(f"[check] {name}: {err:.4e} (tolerance {rel} {tol:.1e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(name)

    def true(self, name: str, ok: bool, detail: str = "") -> None:
        log(f"[check] {name}: {detail} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(name)


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------


def synthetic_rho(n: int, seed: int) -> np.ndarray:
    """(n, n, n) density [x, y, z]: bench.py's linear ramp in x plus
    seeded Gaussian blobs, so the field varies in every direction."""
    rng = np.random.default_rng(seed)
    u = np.linspace(-1.0, 1.0, n)
    X, Y, Z = np.meshgrid(u, u, u, indexing="ij")
    rho = 1.225 + 2.5 * (X + 1.0)
    for _ in range(4):
        c = rng.uniform(-0.6, 0.6, 3)
        s = rng.uniform(0.15, 0.35)
        a = rng.uniform(-1.0, 1.0)
        rho += a * np.exp(-((X - c[0]) ** 2 + (Y - c[1]) ** 2
                            + (Z - c[2]) ** 2) / (2 * s * s))
    return rho.astype(np.float32)


def bos_config(sz: Sizes, nrrd_path: str, out_dir: str):
    """bench.build_scene's BOS configuration, reading its field from NRRD."""
    from photon_tpu.config import default_config

    cfg = default_config("bos")
    cfg.camera_design.x_pixel_number = sz.sensor
    cfg.camera_design.y_pixel_number = sz.sensor
    cfg.bos_pattern.grid_point_number = sz.bos_dots
    cfg.bos_pattern.particle_number_per_grid_point = sz.bos_points
    cfg.bos_pattern.lightray_number_per_particle = sz.bos_rays
    m = cfg.lens_design.focal_length / (
        cfg.lens_design.object_distance - cfg.lens_design.focal_length)
    half = 0.8 * sz.sensor * cfg.camera_design.pixel_pitch / 2.0 / m
    cfg.bos_pattern.X_Min, cfg.bos_pattern.X_Max = -half, half
    cfg.bos_pattern.Y_Min, cfg.bos_pattern.Y_Max = -half, half
    cfg.density_gradients.simulate_density_gradients = True
    cfg.density_gradients.density_gradient_filename = nrrd_path
    cfg.output_data.image_directory = out_dir
    return cfg


def write_bos_field(cfg, n: int, path: str) -> None:
    """The synthetic field between the dots and the lens (NRRD frame: the
    dot plane sits at z = object_distance), as bench.build_scene places
    it."""
    from photon_tpu.models.optics import camera_setup
    from photon_tpu.utils.nrrd_io import write_nrrd

    setup = camera_setup(cfg)
    x = np.linspace(-1.5e5, 1.5e5, n)
    z = np.linspace(setup.object_distance - 5e5,
                    setup.object_distance - 1e2, n)
    write_nrrd(path, synthetic_rho(n, cfg.seed),
               [x[1] - x[0], x[1] - x[0], z[1] - z[0]], [x[0], x[0], z[0]])


class BosScene(NamedTuple):
    cfg: object
    setup: object
    source: object
    r1: np.ndarray
    r2: np.ndarray
    vol: object


def bos_scene(cfg) -> BosScene:
    """The scene run_bos renders for ``cfg``, rebuilt with its seeding."""
    from photon_tpu.models.optics import camera_setup
    from photon_tpu.models.scenes import bos_source
    from photon_tpu.pipeline import _lens_sample_pair
    from photon_tpu.volume import load_density_volume

    setup = camera_setup(cfg)
    source, _, _ = bos_source(cfg, setup, np.random.default_rng(cfg.seed))
    r1, r2 = _lens_sample_pair(cfg, source.lightray_number_per_particle)
    vol = load_density_volume(cfg.density_gradients.density_gradient_filename,
                              gladstone_dale=cfg.density_gradients
                              .gladstone_dale)
    return BosScene(cfg, setup, source, np.asarray(r1), np.asarray(r2), vol)


def _render_fn(sc: BosScene):
    """field -> raw image through render_image_fast."""
    from photon_tpu.models.render_fast import render_image_fast

    def render(field):
        return render_image_fast(sc.cfg, sc.setup, sc.source, sc.r1, sc.r2,
                                 vol=sc.vol._replace(field=field))
    return render


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_bos(sz: Sizes, work: str, checks: Checks):
    """run_simulation on the BOS pair, then a timed direct render;
    returns the scene and that render."""
    from photon_tpu.pipeline import run_simulation, save_result

    nrrd = os.path.join(work, "bos_field.nrrd")
    out_dir = os.path.join(work, "bos_out")
    cfg = bos_config(sz, nrrd, out_dir)
    write_bos_field(cfg, sz.field_n, nrrd)
    t0 = time.perf_counter()
    result = run_simulation(cfg)
    written = save_result(cfg, result, out_dir)
    log(f"[smoke] bos run_simulation (compile + im1 + im2): "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{result.sources['bos'].num_rays} rays per image")
    im1 = result.raw_images["bos_pattern_image_1"]
    im2 = result.raw_images["bos_pattern_image_2"]
    for name in ("bos_pattern_image_1", "bos_pattern_image_2"):
        path = os.path.join(out_dir, "tif", name + ".tif")
        checks.true(f"bos {name}.tif written", path in written
                    and os.path.getsize(path) > 0, path)
    checks.value("bos im1 sum", float(im1.sum()), 0.0, at_least=True)
    checks.value("bos im2 sum", float(im2.sum()), 0.0, at_least=True)
    checks.value("bos |im2 - im1| / im1 (the field deflects)",
                 float(np.abs(im2 - im1).sum() / max(im1.sum(), 1e-30)),
                 1e-6, at_least=True)

    sc = bos_scene(cfg)
    img = measure("bos forward (render_image_fast, 64^3)", _render_fn(sc),
                  sc.vol.field)
    img = np.asarray(img)
    checks.true("bos forward finite", bool(np.isfinite(img).all()))
    return sc, img


def phase_bos_grad(sc: BosScene, observed, checks: Checks,
                   steps: int = 3) -> None:
    """value_and_grad w.r.t. the field, then ``steps`` invert_bos steps
    towards ``observed`` from a uniform start."""
    from photon_tpu.inverse import invert_bos

    render = _render_fn(sc)

    def loss(field):
        img = render(field)
        return jnp.mean(img * img)

    val, g = measure("bos value_and_grad (64^3 field)",
                     jax.value_and_grad(loss), sc.vol.field)
    g = np.asarray(g)
    checks.true("bos grad finite", bool(np.isfinite(float(val))
                                        and np.isfinite(g).all()))
    checks.value("bos |grad| sum", float(np.abs(g).sum()), 0.0,
                  at_least=True)

    t0 = time.perf_counter()
    res = invert_bos(sc.cfg, sc.setup, sc.source, sc.r1, sc.r2, observed,
                     sc.vol, steps=steps, learning_rate=0.05)
    log(f"[smoke] bos invert_bos {steps} steps (compile included): "
        f"{time.perf_counter() - t0:.2f} s, losses "
        f"{[f'{x:.4e}' for x in res.losses]}")
    rho0 = sc.cfg.density_gradients.rho_0
    checks.true("invert_bos losses finite and > 0",
                bool(np.all(np.isfinite(res.losses))
                     and min(res.losses) > 0))
    checks.value("invert_bos max |rho - rho0|",
                 float(np.abs(res.rho - rho0).max()), 0.0, at_least=True)


def phase_piv(sz: Sizes, work: str, checks: Checks) -> None:
    """The PIV + Mie sample scene through run_simulation."""
    from bench import build_piv_scene
    from photon_tpu.models.render_fast import render_image_fast
    from photon_tpu.pipeline import run_simulation

    cfg, setup, source, r1, r2, scattering = build_piv_scene(
        sz.piv_particles, sz.piv_rays)
    cfg.output_data.image_directory = os.path.join(work, "piv_out")
    t0 = time.perf_counter()
    result = run_simulation(cfg)
    log(f"[smoke] piv run_simulation (compile + {len(result.images)} "
        f"frames): {time.perf_counter() - t0:.2f} s")
    for name, raw in result.raw_images.items():
        checks.value(f"piv {name} sum", float(raw.sum()), 0.0,
                     at_least=True)
    ppc = max(1, int(cfg.particle_field.lightray_process_number)
              // sz.piv_rays)

    def render():
        return render_image_fast(cfg, setup, source, r1, r2,
                                 scattering=scattering,
                                 particles_per_chunk=ppc)

    img = np.asarray(measure("piv+mie forward (render_image_fast)", render))
    checks.true("piv forward finite, sum > 0",
                bool(np.isfinite(img).all() and img.sum() > 0))


def phase_vol512(sc: BosScene, n: int, checks: Checks) -> None:
    """Forward and value-and-grad through an n^3 field (tube march)."""
    from bench import build_vol512
    from photon_tpu.ops.march_dense import dense_march_supported

    vol = build_vol512(sc.setup, n=n)
    checks.true(f"{n}^3 routes to the tube march",
                not dense_march_supported(vol))
    big = sc._replace(vol=vol)
    render = _render_fn(big)
    img = np.asarray(measure(f"vol{n} forward", render, vol.field))
    checks.true(f"vol{n} forward finite, sum > 0",
                bool(np.isfinite(img).all() and img.sum() > 0))
    del img

    def loss(field):
        im = render(field)
        return jnp.mean(im * im)

    val, g = measure(f"vol{n} value_and_grad", jax.value_and_grad(loss),
                     vol.field)
    gabs = float(jnp.abs(g).sum())
    checks.true(f"vol{n} grad finite", bool(np.isfinite(float(val))
                                            and np.isfinite(gabs)))
    checks.value(f"vol{n} |grad| sum", gabs, 0.0, at_least=True)


def parity_goldens(checks: Checks, names=None) -> None:
    """The committed golden images (rendered on the CPU), rendered here.

    Per pixel the CPU test's tolerance (atol + rtol |golden|) holds for
    all but a few pixels on a GPU, whose float32 rounding differs (see
    PERF.md): the check is the image's relative L1 and the share of
    pixels outside that per-pixel tolerance."""
    sys.path.insert(0, REPO)
    from tests import test_golden as tg

    cases = {"golden_bos_64": (tg._render_legacy, tg.LEGACY_GOLDEN, 1e-6)}
    for name, fn in tg.CASES.items():
        cases[name] = (fn, os.path.join(tg.GOLDEN_DIR, name + ".npy"), None)
    for name in sorted(cases) if names is None else names:
        fn, path, atol = cases[name]
        golden = np.load(path).astype(np.float64)
        if atol is None:
            atol = 1e-6 * max(float(golden.max()), 1.0)
        err = np.abs(np.asarray(fn(), np.float64) - golden)
        outside = err > atol + GOLDEN_RTOL * np.abs(golden)
        checks.value(f"golden {name} relative L1",
                     float(err.sum() / np.abs(golden).sum()), GOLDEN_L1)
        checks.value(f"golden {name} share of pixels outside the CPU "
                     f"test's per-pixel tolerance ({int(outside.sum())} "
                     f"of {golden.size})", float(outside.mean()),
                     GOLDEN_OUTSIDE)


def _exact_scene(sz: Sizes, lens_model: str = "general"):
    """A reduced BOS scene with a volume, as tests/test_fast.py builds it."""
    sys.path.insert(0, REPO)
    from tests.test_bos_pipeline import bos_case, gradient_volume_between
    from photon_tpu.models.optics import camera_setup
    from photon_tpu.models.scenes import bos_source
    from photon_tpu.utils.rng import lens_samples

    cfg = bos_case(lens_model, n_dots=sz.exact_dots, rays=sz.exact_rays)
    setup = camera_setup(cfg)
    src, *_ = bos_source(cfg, setup, np.random.default_rng(11))
    r1, r2 = lens_samples(jax.random.key(5), sz.exact_rays)
    vol, *_ = gradient_volume_between(setup, n=16)
    return cfg, setup, src, np.asarray(r1), np.asarray(r2), vol


def parity_fast_exact(sz: Sizes, checks: Checks) -> None:
    """Fast vs exact path: image L1 and the field gradient."""
    from photon_tpu.models.render import render_image
    from photon_tpu.models.render_fast import render_image_fast
    from photon_tpu.ops.march import march_rays

    cfg, setup, src, r1, r2, vol = _exact_scene(sz)

    def fast(field):
        return render_image_fast(cfg, setup, src, r1, r2,
                                 vol=vol._replace(field=field))

    def exact(field):
        flat = field.reshape(-1, 4)
        return render_image(cfg, setup, src, r1, r2, march_fn=lambda rays:
                            march_rays(vol, rays, algorithm=2,
                                       differentiable=True,
                                       field_flat=flat))

    img_f = np.asarray(jax.jit(fast)(vol.field))
    img_e = np.asarray(jax.jit(exact)(vol.field))
    checks.value("fast vs exact image L1 / sum",
                 float(np.abs(img_f - img_e).sum() / img_e.sum()),
                 FAST_EXACT_L1)

    weight = jnp.asarray(np.random.default_rng(7).random(img_e.shape),
                         jnp.float32)
    g_f = np.asarray(jax.jit(jax.grad(
        lambda f: jnp.sum(fast(f) * weight)))(vol.field)).ravel()
    g_e = np.asarray(jax.jit(jax.grad(
        lambda f: jnp.sum(exact(f) * weight)))(vol.field)).ravel()
    cos = float(g_f @ g_e / (np.linalg.norm(g_f) * np.linalg.norm(g_e)))
    checks.value("fast vs exact field gradient cosine", cos, GRAD_COS_MIN,
                 at_least=True)
    checks.value("fast vs exact field gradient |norm ratio - 1|",
                 float(abs(np.linalg.norm(g_f) / np.linalg.norm(g_e) - 1)),
                 GRAD_NORM_RTOL)


def parity_tube_dense(sc: BosScene, checks: Checks) -> None:
    """Tube march vs dense march on the BOS scene's chief rays through its
    <= 128^2-slab field: exit deflections agree."""
    from photon_tpu.models.render import RenderParams
    from photon_tpu.models.render_fast import _chief_geometry
    from photon_tpu.ops.march_dense import (dense_march_supported,
                                            march_chief_dense)
    from photon_tpu.ops.march_fast import march_chief_tubes

    assert dense_march_supported(sc.vol)
    params = RenderParams.from_setup(sc.cfg, sc.setup, sc.source)
    _, chief = _chief_geometry(
        sc.vol, jnp.asarray(sc.source.x, jnp.float32),
        jnp.asarray(sc.source.y, jnp.float32),
        jnp.asarray(sc.source.z, jnp.float32),
        jnp.asarray(sc.setup.inverse_rotation_matrix, jnp.float32),
        params.z_offset, params.image_distance)
    dense = jax.jit(march_chief_dense)(sc.vol, *chief)
    tube = jax.jit(march_chief_tubes)(sc.vol, *chief)
    d_dense = np.stack([np.asarray(dense[i]) - np.asarray(chief[i])
                        for i in (3, 4, 5)])
    d_tube = np.stack([np.asarray(tube[i]) - np.asarray(chief[i])
                       for i in (3, 4, 5)])
    scale = max(float(np.abs(d_dense).max()), 1e-30)
    checks.value("tube vs dense chief deflection, max err / max deflection",
                 float(np.abs(d_tube - d_dense).max()) / scale,
                 TUBE_DENSE_ATOL)


def phase_four_cards(sz: Sizes, work: str, checks: Checks,
                     n_cards: int = 4) -> None:
    """Sharded BOS forward and 64^3 field gradient against one card, and
    one sharded value-and-grad step through the big field."""
    from jax.sharding import Mesh

    from bench import build_vol512
    from photon_tpu.models.render_fast import render_image_fast

    mesh = Mesh(np.asarray(jax.devices()[:n_cards]), ("particles",))
    nrrd = os.path.join(work, "bos_field.nrrd")
    cfg = bos_config(sz, nrrd, os.path.join(work, "bos_out"))
    write_bos_field(cfg, sz.field_n, nrrd)
    sc = bos_scene(cfg)

    def render(field, mesh=None, vol=sc.vol):
        return render_image_fast(cfg, sc.setup, sc.source, sc.r1, sc.r2,
                                 vol=vol._replace(field=field), mesh=mesh)

    one = np.asarray(measure("bos forward, one card", render, sc.vol.field))
    many = np.asarray(measure(f"bos forward, {n_cards} cards",
                              lambda f: render(f, mesh), sc.vol.field))
    checks.value(f"{n_cards}-card vs one-card image L1 / sum",
                 float(np.abs(many - one).sum() / one.sum()), SHARD_L1)

    def loss(field, mesh=None, vol=sc.vol):
        im = render(field, mesh, vol)
        return jnp.mean(im * im)

    _, g1 = measure("bos value_and_grad, one card",
                    jax.value_and_grad(loss), sc.vol.field)
    _, gn = measure(f"bos value_and_grad, {n_cards} cards",
                    jax.value_and_grad(lambda f: loss(f, mesh)),
                    sc.vol.field)
    g1, gn = np.asarray(g1), np.asarray(gn)
    checks.value(f"{n_cards}-card vs one-card field gradient, relative L2",
                 float(np.linalg.norm(gn - g1) / np.linalg.norm(g1)),
                 SHARD_GRAD_RTOL)

    big = build_vol512(sc.setup, n=sz.big_n)
    val, g = measure(f"vol{sz.big_n} value_and_grad, {n_cards} cards",
                     jax.value_and_grad(lambda f: loss(f, mesh, big)),
                     big.field, reps=1)
    gabs = float(jnp.abs(g).sum())
    checks.true(f"vol{sz.big_n} sharded grad finite",
                bool(np.isfinite(float(val)) and np.isfinite(gabs)))
    checks.value(f"vol{sz.big_n} sharded |grad| sum", gabs, 0.0,
                 at_least=True)


# ---------------------------------------------------------------------------


def run_one_card(sz: Sizes, work: str, checks: Checks) -> None:
    sc, img = phase_bos(sz, work, checks)
    phase_bos_grad(sc, img, checks)
    parity_tube_dense(sc, checks)
    phase_piv(sz, work, checks)
    phase_vol512(sc, sz.big_n, checks)
    parity_goldens(checks)
    parity_fast_exact(sz, checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards and "
                    "what it is compared with")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from photon_tpu.utils.compile_cache import enable_compile_cache
    from photon_tpu.utils.device import (device_record, nvidia_smi_cards,
                                         require_gpu)

    n_cards = 4 if args.four_cards else 1
    devices = require_gpu(n_cards)
    log(f"[device] {devices[0].device_kind}, {len(jax.devices())} visible; "
        f"compile cache {enable_compile_cache()}")
    card = nvidia_smi_cards()
    log(f"[card] {card}")

    checks = Checks()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        if args.four_cards:
            phase_four_cards(FULL, work, checks, n_cards)
        else:
            run_one_card(FULL, work, checks)
    log(f"[smoke] total {time.perf_counter() - t0:.1f} s")
    if checks.failed:
        raise SystemExit(f"failed checks: {checks.failed}")
    log(f"[card] {card}")
    print(json.dumps({"ok": True, "device": device_record(jax.devices())}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
