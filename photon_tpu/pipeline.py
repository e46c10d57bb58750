"""Simulation drivers: end-to-end PIV / BOS / calibration image generation.

Replacement for the reference's orchestration layer
(``run_simulation_02.run_simulation_02``, ref: run_simulation_02.py:1725-2106):
builds the optical system, generates the scene, renders (reference +
density-gradient image pair for BOS), post-processes and writes TIFF/raw
artifacts plus the parameter/position sidecars.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

import jax

from photon_tpu.config import SimulationConfig
from photon_tpu.models.optics import CameraSetup, camera_setup
from photon_tpu.models.render import render_image
from photon_tpu.models.scenes import (LightfieldSource, bos_source,
                                      calibration_source, piv_source)
from photon_tpu.postprocess import postprocess
from photon_tpu.utils.rng import lens_samples
from photon_tpu.utils.tiff_io import write_tiff16


@dataclass
class SimulationResult:
    """Artifacts of one run: quantized + raw images and scene metadata."""

    images: Dict[str, np.ndarray]          # name -> uint16 image
    raw_images: Dict[str, np.ndarray]      # name -> float32 image
    setup: CameraSetup
    sources: Dict[str, LightfieldSource]
    dot_positions: Optional[Dict[str, np.ndarray]] = None


def _lens_sample_pair(cfg: SimulationConfig, n_rays: int):
    """Per-ray lens-aperture samples, shared by all source points.

    (analogue of generate_random_numbers_for_lightrays,
    ref: run_simulation_02.py:1699-1722; with ``reference_lens_rng`` the
    exact glibc srand(10) stream of the CUDA host is reproduced)
    """
    if cfg.reference_lens_rng:
        from photon_tpu.utils.rng import reference_lens_samples
        return reference_lens_samples(int(n_rays))
    key = jax.random.key(cfg.seed)
    return lens_samples(key, n_rays)


def can_use_fast_renderer(cfg: SimulationConfig, setup: CameraSetup,
                          vol=None) -> bool:
    """Whether the speed-of-light (P, R) pipeline covers this config.

    The single source of truth for fast/exact routing (render_image_fast
    itself only re-raises on a non-axis-aligned train).  Covered: the
    axis-aligned single-lens train ('apparent'/'thin-lens'/'general'
    without dispersion or absorbance), camera rotation, Mie or diffuse
    scattering (the per-particle Mie collapse is valid for every table),
    erf-diffraction or bilinear sensor deposits, per-ray sensor position
    noise, and the full density-march menu — all four integrators x
    trilinear/tricubic at any volume size (dense march for slabs up to
    128x128, voxel-tube march beyond).
    Routed to the exact path: tilted/multi-element trains,
    gradient-index noise, Abbe/Cauchy dispersion, nonzero absorbance.
    """
    from photon_tpu.models.render_fast import _axis_aligned

    dg = cfg.density_gradients
    if not _axis_aligned(setup) or dg.add_ngrad_noise:
        return False
    if vol is not None and \
            float(np.asarray(setup.inverse_rotation_matrix)[2, 2]) <= 0.0:
        # camera rotated >= 90 deg: world-frame rays travel upward (+z)
        # through the volume, which the fast z-scan march's top-down entry
        # does not model (march_fast.march_tubes requires dcz < 0); the
        # exact marcher is direction-agnostic (ops.march.aabb_entry).
        # Exercised by the reference's own sample-images scene
        # (y_camera_angle = 5*pi/6, tests/test_sample_scene.py).
        return False
    if setup.lens_model == "general":
        st = setup.elements
        # fast thick lens has no dispersion/absorbance terms
        if np.isfinite(float(st.abbe_number[0])) \
                or float(st.absorbance_rate[0]) != 0.0:
            return False
    return True


def _ray_budget(cfg: SimulationConfig) -> int:
    """The config's lightray_process_number for the active scene section.

    The reference carries this "rays to simultaneously process" knob in
    every scene section but its own front-end comments out the only read
    (ref: perform_ray_tracing_03.py:2009) — the CUDA host bounds memory
    purely by particle chunks.  Here it is honored as the in-flight ray
    budget that sizes both chunkers.
    """
    section = {"bos": cfg.bos_pattern, "piv": cfg.particle_field,
               "cal": cfg.calibration_grid}.get(cfg.simulation_type)
    if section is None:
        return 2_000_000
    return int(section.lightray_process_number)


def _render(cfg: SimulationConfig, setup: CameraSetup, source, r1, r2,
            march_fn=None, vol=None, scattering=None,
            rays_per_chunk: Optional[int] = None, noise_seed=None):
    """Dispatch to the fast SoA renderer when the config allows it."""
    if rays_per_chunk is None:
        rays_per_chunk = _ray_budget(cfg)
    if vol is not None or march_fn is None:
        if can_use_fast_renderer(cfg, setup, vol=vol):
            from photon_tpu.models.render_fast import render_image_fast
            R = int(source.lightray_number_per_particle)
            P = source.num_particles
            ppc = max(1, rays_per_chunk // max(R, 1))
            return render_image_fast(
                cfg, setup, source, r1, r2, vol=vol,
                algorithm=int(cfg.density_gradients.ray_tracing_algorithm),
                interpolation_scheme=int(
                    cfg.density_gradients.interpolation_scheme),
                particles_per_chunk=ppc if ppc < P else None,
                scattering=scattering, noise_seed=noise_seed)
    from photon_tpu.models.render import render_image
    return render_image(cfg, setup, source, r1, r2, march_fn=march_fn,
                        scattering=scattering, rays_per_chunk=rays_per_chunk,
                        noise_seed=noise_seed)


def _z_shift_kw(cfg: SimulationConfig) -> dict:
    """NRRD z-origin shift override (see DensityGradients.nrrd_z_origin_shift)."""
    s = cfg.density_gradients.nrrd_z_origin_shift
    return {} if s is None else {"z_origin_shift": float(s)}


def _march_fn_for(cfg: SimulationConfig, enable: bool):
    """Build the density-gradient marching stage, or None."""
    if not enable:
        return None
    from photon_tpu.volume import load_density_volume
    from photon_tpu.ops.march import make_march_fn

    vol = load_density_volume(
        cfg.density_gradients.density_gradient_filename,
        gladstone_dale=cfg.density_gradients.gladstone_dale,
        **_z_shift_kw(cfg))
    return make_march_fn(
        vol,
        algorithm=int(cfg.density_gradients.ray_tracing_algorithm),
        interpolation_scheme=int(cfg.density_gradients.interpolation_scheme),
        add_ngrad_noise=cfg.density_gradients.add_ngrad_noise,
        ngrad_noise_std=cfg.density_gradients.ngrad_noise_std,
        seed=cfg.seed)


def run_bos(cfg: SimulationConfig,
            rng: Optional[np.random.Generator] = None,
            rays_per_chunk: Optional[int] = None,
            verbose: bool = False) -> SimulationResult:
    """Render the BOS image pair: im1 (no gradients) + im2 (with gradients).

    (ref: run_simulation_02.py:1976-2106)
    """
    from photon_tpu.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    if rng is None:
        rng = np.random.default_rng(cfg.seed)
    with timer.phase("scene"):
        setup = camera_setup(cfg)
        source, dot_x, dot_y = bos_source(cfg, setup, rng)
        r1, r2 = _lens_sample_pair(cfg, source.lightray_number_per_particle)

    vol = None
    if bool(cfg.density_gradients.density_gradient_filename):
        from photon_tpu.volume import load_density_volume
        with timer.phase("volume"):
            vol = load_density_volume(
                cfg.density_gradients.density_gradient_filename,
                gladstone_dale=cfg.density_gradients.gladstone_dale,
                **_z_shift_kw(cfg))
    fast_ok = can_use_fast_renderer(cfg, setup, vol=vol)

    images, raws = {}, {}
    key = jax.random.key(cfg.seed + 7)
    for im_idx, (name, gradients) in enumerate(
            (("bos_pattern_image_1", False),
             ("bos_pattern_image_2", True))):
        # im1 always renders without gradients, im2 with them — regardless
        # of the config flag (ref: run_simulation_02.py:2034, 2064)
        use_vol = vol if gradients else None
        with timer.phase(f"render:{name}", num_rays=source.num_rays):
            if fast_ok:
                raw = _render(cfg, setup, source, r1, r2, vol=use_vol,
                              rays_per_chunk=rays_per_chunk,
                              noise_seed=cfg.seed + im_idx)
            else:
                march_fn = _march_fn_for(cfg, gradients and vol is not None)
                raw = render_image(cfg, setup, source, r1, r2,
                                   march_fn=march_fn,
                                   rays_per_chunk=rays_per_chunk
                                   or _ray_budget(cfg),
                                   noise_seed=cfg.seed + im_idx)
            raw.block_until_ready()
        key, sub = jax.random.split(key)
        with timer.phase("postprocess"):
            I, I_raw = postprocess(cfg, raw, key=sub)
        images[name], raws[name] = I, I_raw

        if cfg.output_data.save_lightrays:
            with timer.phase("save_lightrays"):
                _save_lightrays(cfg, setup, source, r1, r2,
                                vol if gradients else None,
                                "im2" if gradients else "im1")

    if verbose:
        print(timer.report())
    return SimulationResult(images=images, raw_images=raws, setup=setup,
                            sources={"bos": source},
                            dot_positions={"x": dot_x, "y": dot_y})


def _save_lightrays(cfg: SimulationConfig, setup: CameraSetup, source,
                    r1, r2, vol, tag: str) -> None:
    """Write final ray pos/dir dumps like the reference's per-chunk bins.

    (ref: parallel_ray_tracing.cu:3561-3670; consumed by
    photon_tpu.analysis.light_rays)
    """
    import os

    from photon_tpu.models.render import render_rays
    from photon_tpu.ops.march import make_march_fn

    march_fn = None
    if vol is not None:
        march_fn = make_march_fn(
            vol, algorithm=int(cfg.density_gradients.ray_tracing_algorithm),
            interpolation_scheme=int(
                cfg.density_gradients.interpolation_scheme))
    rays = render_rays(cfg, setup, source, r1, r2, march_fn=march_fn)
    base = cfg.output_data.image_directory or "."
    pos_dir = cfg.output_data.lightray_positions_filepath \
        or os.path.join(base, "light-ray-positions", tag)
    dir_dir = cfg.output_data.lightray_directions_filepath \
        or os.path.join(base, "light-ray-directions", tag)
    os.makedirs(pos_dir, exist_ok=True)
    os.makedirs(dir_dir, exist_ok=True)
    n_save = int(cfg.output_data.num_lightrays_save) or rays.pos.shape[0]
    # the reference writes pos and dir bins to separate directories, ONE
    # FILE PER PARTICLE CHUNK (pos_%04d.bin for each KMAX-particle batch,
    # ref: parallel_ray_tracing.cu:3561-3670); mirror that layout using
    # the same ray-budget chunking the renderer applies, so consumers
    # that glob the numbered series see the reference's artifact shape
    # (analysis.light_rays.load_ray_data concatenates the series).
    R = max(1, int(source.lightray_number_per_particle))
    ppc = max(1, _ray_budget(cfg) // R)
    chunk_rays = ppc * R
    pos = np.asarray(rays.pos)[:n_save].astype(np.float32)
    dirs = np.asarray(rays.dir)[:n_save].astype(np.float32)
    n_chunks = max(1, -(-pos.shape[0] // chunk_rays))
    for c in range(n_chunks):
        sl = slice(c * chunk_rays, (c + 1) * chunk_rays)
        pos[sl].tofile(os.path.join(pos_dir, f"pos_{c:04d}.bin"))
        dirs[sl].tofile(os.path.join(dir_dir, f"dir_{c:04d}.bin"))

    if cfg.output_data.save_intermediate_ray_data and vol is not None:
        _save_intermediate_rays(cfg, setup, source, r1, r2, vol,
                                pos_dir, dir_dir, n_save)


def _save_intermediate_rays(cfg: SimulationConfig, setup: CameraSetup,
                            source, r1, r2, vol, pos_dir: str, dir_dir: str,
                            n_save: int) -> None:
    """Per-step trajectory dumps of the first rays through the marcher.

    Writes intermediate_pos_0000.bin / intermediate_dir_0000.bin —
    (num_lightrays_save, num_intermediate_positions_save, 3) float32 in
    the reference's ray-major layout, recorded in the world/marcher frame
    exactly where the reference's kernel records them
    (ref: trace_rays_through_density_gradients.h:784-790, dumps at
    parallel_ray_tracing.cu:3613-3670).
    """
    import os

    import jax.numpy as jnp

    from photon_tpu.models.render import RenderParams, generate_rays
    from photon_tpu.ops.lens import RayBundle
    from photon_tpu.ops.march import march_rays

    params = RenderParams.from_setup(cfg, setup, source)
    rays = generate_rays(
        jnp.asarray(source.x), jnp.asarray(source.y), jnp.asarray(source.z),
        jnp.asarray(source.radiance, jnp.float32),
        jnp.asarray(source.diameter_index),
        jnp.asarray(r1, jnp.float32), jnp.asarray(r2, jnp.float32), params)
    # camera -> marcher/world frame (ref: parallel_ray_tracing.cu:2036-2082)
    shift = jnp.asarray([0.0, 0.0, params.z_offset + 750e3],
                        dtype=rays.pos.dtype)
    inv_rot = jnp.asarray(setup.inverse_rotation_matrix, rays.pos.dtype)
    hi = jax.lax.Precision.HIGHEST
    rays_w = RayBundle(jnp.matmul(rays.pos - shift, inv_rot.T, precision=hi),
                       jnp.matmul(rays.dir, inv_rot.T, precision=hi),
                       rays.wavelength, rays.radiance)
    n_steps = int(cfg.output_data.num_intermediate_positions_save)
    _, (ipos, idir) = march_rays(
        vol, rays_w,
        algorithm=int(cfg.density_gradients.ray_tracing_algorithm),
        interpolation_scheme=int(cfg.density_gradients.interpolation_scheme),
        record_steps=n_steps, record_rays=n_save)
    np.asarray(ipos).astype(np.float32).tofile(
        os.path.join(pos_dir, "intermediate_pos_0000.bin"))
    np.asarray(idir).astype(np.float32).tofile(
        os.path.join(dir_dir, "intermediate_dir_0000.bin"))


def run_piv(cfg: SimulationConfig,
            rng: Optional[np.random.Generator] = None,
            rays_per_chunk: Optional[int] = None) -> SimulationResult:
    """Render the PIV frame sequence (ref: run_simulation_02.py:1773-1879)."""
    if rng is None:
        rng = np.random.default_rng(cfg.seed)
    setup = camera_setup(cfg)
    pf = cfg.particle_field

    scattering = None
    diameter_idx = None
    if pf.perform_mie_scattering:
        from photon_tpu.ops.mie import create_mie_scattering_data
        scattering = create_mie_scattering_data(cfg, rng)
        diameter_idx = scattering["particle_diameter_index_distribution"]

    r1, r2 = _lens_sample_pair(cfg, pf.lightray_number_per_particle)

    gradients = cfg.density_gradients.simulate_density_gradients
    vol = None
    if gradients:
        from photon_tpu.volume import load_density_volume
        vol = load_density_volume(
            cfg.density_gradients.density_gradient_filename,
            gladstone_dale=cfg.density_gradients.gladstone_dale,
            **_z_shift_kw(cfg))

    images, raws, sources = {}, {}, {}
    key = jax.random.key(cfg.seed + 7)
    for frame_index in pf.frame_vector:
        source = piv_source(cfg, setup, frame_index,
                            diameter_index_distribution=diameter_idx, rng=rng)
        if can_use_fast_renderer(cfg, setup, vol=vol):
            raw = _render(cfg, setup, source, r1, r2, vol=vol,
                          scattering=scattering,
                          rays_per_chunk=rays_per_chunk,
                          noise_seed=cfg.seed + int(frame_index))
        else:
            march_fn = _march_fn_for(cfg, gradients)
            raw = render_image(cfg, setup, source, r1, r2,
                               march_fn=march_fn, scattering=scattering,
                               rays_per_chunk=rays_per_chunk
                               or _ray_budget(cfg),
                               noise_seed=cfg.seed + int(frame_index))
        key, sub = jax.random.split(key)
        name = f"particle_image_frame_{frame_index:04d}"
        images[name], raws[name] = postprocess(cfg, raw, key=sub)
        sources[name] = source

    return SimulationResult(images=images, raw_images=raws, setup=setup,
                            sources=sources)


def run_cal(cfg: SimulationConfig,
            rng: Optional[np.random.Generator] = None,
            rays_per_chunk: Optional[int] = None) -> SimulationResult:
    """Render one image per calibration plane (ref: run_simulation_02.py:1881-1974)."""
    if rng is None:
        rng = np.random.default_rng(cfg.seed)
    setup = camera_setup(cfg)
    cg = cfg.calibration_grid
    r1, r2 = _lens_sample_pair(cfg, cg.lightray_number_per_particle)

    images, raws, sources = {}, {}, {}
    key = jax.random.key(cfg.seed + 7)
    for plane in range(int(cg.calibration_plane_number)):
        source = calibration_source(cfg, setup, plane, rng)
        if can_use_fast_renderer(cfg, setup):
            raw = _render(cfg, setup, source, r1, r2,
                          rays_per_chunk=rays_per_chunk)
        else:
            raw = render_image(cfg, setup, source, r1, r2,
                               rays_per_chunk=rays_per_chunk
                               or _ray_budget(cfg))
        key, sub = jax.random.split(key)
        name = f"calibration_image_plane_{plane + 1:04d}"
        images[name], raws[name] = postprocess(cfg, raw, key=sub)
        sources[name] = source

    return SimulationResult(images=images, raw_images=raws, setup=setup,
                            sources=sources)


def run_simulation(cfg: SimulationConfig, **kw) -> SimulationResult:
    """Dispatch on simulation_type (ref: run_simulation_02.py:1773, 1881, 1976)."""
    if cfg.simulation_type == "bos":
        return run_bos(cfg, **kw)
    if cfg.simulation_type == "piv":
        return run_piv(cfg, **kw)
    if cfg.simulation_type == "cal":
        return run_cal(cfg, **kw)
    raise ValueError(f"unknown simulation_type {cfg.simulation_type!r}")


def save_result(cfg: SimulationConfig, result: SimulationResult,
                out_dir: Optional[str] = None) -> List[str]:
    """Write TIFF + raw artifacts and parameter sidecars.

    Directory layout mirrors the reference: ``tif/`` and ``raw/``
    subdirectories plus ``parameters``/``positions`` metadata
    (ref: run_simulation_02.py:1764-1771, 2048-2106).  Parameters and
    positions are written BOTH as JSON and as reference-format ``.mat``
    sidecars (``parameters.mat``/``positions.mat``), so the reference's
    analysis tooling (light_ray_processing.py:539-551 starts by loading
    ``parameters.mat``) can consume a photon_tpu output directory.
    """
    import scipy.io as sio
    out_dir = out_dir or cfg.output_data.image_directory or "."
    tif_dir = os.path.join(out_dir, "tif")
    raw_dir = os.path.join(out_dir, "raw")
    os.makedirs(tif_dir, exist_ok=True)
    os.makedirs(raw_dir, exist_ok=True)
    written = []
    for name, img in result.images.items():
        p = os.path.join(tif_dir, name + ".tif")
        write_tiff16(p, img)
        written.append(p)
    for name, raw in result.raw_images.items():
        p = os.path.join(raw_dir, name + ".bin")
        raw.astype(np.float32).tofile(p)
        written.append(p)
    p = os.path.join(out_dir, "parameters.json")
    cfg.to_json(p)
    written.append(p)
    p = os.path.join(out_dir, "parameters.mat")
    cfg.to_mat(p)
    written.append(p)
    if result.dot_positions is not None:
        p = os.path.join(out_dir, "positions.json")
        with open(p, "w") as f:
            json.dump({k: np.asarray(v).tolist()
                       for k, v in result.dot_positions.items()}, f)
        written.append(p)
        # reference layout: positions.mat holds the dot grid as (N, 1)
        # column vectors under x/y (ref sample-data bos/positions.mat)
        p = os.path.join(out_dir, "positions.mat")
        sio.savemat(p, {k: np.asarray(v, np.float64).reshape(-1, 1)
                        for k, v in result.dot_positions.items()})
        written.append(p)
    return written
