"""Fused forward renderer: source -> rays -> (density march) -> lens -> sensor.

Replacement for the reference's CUDA kernel + host runtime
(C11/C12 in SURVEY.md, ``parallel_ray_tracing.cu``):

* ray generation — ref: generate_lightfield_angular_data (:71-237)
* camera<->world rotation around the density volume and the z-offset shift —
  ref: kernel body (:2036-2129)
* apparent-image (pinhole + magnification) lens model —
  ref: create_apparent_image (:1545-1733)
* thin/thick-lens + aperture path — see photon_tpu.ops.lens
* sensor integration — see photon_tpu.ops.sensor

Execution model: where the reference launches one CUDA thread per ray in
KMAX sequential 10k-particle chunks, we build the full (P*R)-ray batch as
static-shape arrays and let XLA tile it; oversized batches are processed
in fixed-size chunks via ``lax.map`` (see ``render_image``'s
``rays_per_chunk``), which bounds device memory exactly like the reference's
particle chunking (ref: parallel_ray_tracing.cu:3506-3515).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from photon_tpu.config import SimulationConfig
from photon_tpu.models.optics import CameraSetup
from photon_tpu.models.scenes import LightfieldSource
from photon_tpu.ops.lens import RayBundle, propagate_system
from photon_tpu.ops.sensor import bilinear_splat, diffraction_splat

# full-f32 products: ray positions are ~1e6 um and Mie angles need more
# than TF32's 10 mantissa bits
_HI = jax.lax.Precision.HIGHEST


@dataclass(frozen=True)
class RenderParams:
    """Static (trace-time) parameters of the forward pass."""

    nx: int
    ny: int
    pixel_pitch: float
    z_sensor: float
    lens_pitch: float
    image_distance: float
    aperture_f_number: float
    ray_cone_pitch_ratio: float
    lens_model: str                  # 'general' | 'thin-lens' | 'apparent'
    implement_diffraction: bool
    diffraction_diameter: float
    beam_wavelength: float
    z_offset: float
    object_distance: float
    thin_lens_focal_length: float
    add_pos_noise: bool = False
    pos_noise_std: float = 0.0       # fraction of a pixel

    @classmethod
    def from_setup(cls, cfg: SimulationConfig, setup: CameraSetup,
                   source: LightfieldSource) -> "RenderParams":
        cd = cfg.camera_design
        if cfg.simulation_type == "piv":
            beam_wavelength = cfg.particle_field.beam_wavelength
        else:
            beam_wavelength = 0.0
        return cls(
            nx=int(cd.x_pixel_number), ny=int(cd.y_pixel_number),
            pixel_pitch=float(cd.pixel_pitch),
            z_sensor=float(setup.z_sensor),
            lens_pitch=float(setup.lens_pitch),
            image_distance=float(setup.image_distance),
            aperture_f_number=float(setup.aperture_f_number),
            ray_cone_pitch_ratio=float(cfg.lens_design.ray_cone_pitch_ratio),
            lens_model=str(setup.lens_model),
            implement_diffraction=bool(cd.implement_diffraction),
            diffraction_diameter=float(cd.diffraction_diameter),
            beam_wavelength=float(beam_wavelength),
            z_offset=float(source.z_offset),
            object_distance=float(source.object_distance),
            thin_lens_focal_length=float(
                setup.elements.thin_lens_focal_length[0]),
            add_pos_noise=bool(cfg.density_gradients.add_pos_noise),
            pos_noise_std=float(cfg.density_gradients.pos_noise_std),
        )


# ---------------------------------------------------------------------------
# Ray generation
# ---------------------------------------------------------------------------


def generate_rays(source_x, source_y, source_z, source_radiance,
                  diameter_index, r1, r2, params: RenderParams,
                  scattering=None, inverse_rotation_matrix=None,
                  beam_propagation_vector=None):
    """Spawn the (P, R) ray fan from each source point toward the lens cone.

    ``r1``/``r2`` are the per-ray uniform samples shared by every source
    point (ref: parallel_ray_tracing.cu:104-130 — note the cone radius is
    ``ray_cone_pitch_ratio * lens_pitch * r1`` with *no* sqrt, i.e. the
    samples cluster toward the cone axis exactly as the reference's do).

    With ``scattering`` (a (A, D) Mie irradiance table plus its angle grid)
    the per-ray radiance follows the scattering angle between the
    world-frame ray and the beam direction (ref: :144-210); otherwise the
    source radiance is used directly (diffuse).

    Returns a flat RayBundle of P*R rays.
    """
    P = source_x.shape[0]
    R = r1.shape[0]
    f32 = jnp.float32

    x_lens = (params.ray_cone_pitch_ratio * params.lens_pitch * r1
              * jnp.cos(2.0 * jnp.pi * r2)).astype(f32)     # (R,)
    y_lens = (params.ray_cone_pitch_ratio * params.lens_pitch * r1
              * jnp.sin(2.0 * jnp.pi * r2)).astype(f32)
    if R == 1:
        x_lens = jnp.zeros_like(x_lens)   # chief ray only (ref: :111-116)
        y_lens = jnp.zeros_like(y_lens)

    denom = (params.image_distance - source_z)[:, None]      # (P, 1)
    tan_theta = -(x_lens[None, :] - source_x[:, None]) / denom
    tan_phi = -(y_lens[None, :] - source_y[:, None]) / denom

    d = jnp.stack([tan_theta, tan_phi, -jnp.ones_like(tan_theta)], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)        # (P, R, 3)

    pos = jnp.broadcast_to(
        jnp.stack([source_x, source_y, source_z], axis=-1)[:, None, :],
        (P, R, 3))

    if scattering is not None:
        angles, table = scattering                            # (A,), (A, D)
        inv_rot = jnp.asarray(inverse_rotation_matrix, dtype=f32)
        beam = jnp.asarray(beam_propagation_vector, dtype=f32)
        world_dir = jnp.einsum("ij,prj->pri", inv_rot, d, precision=_HI)
        world_dir = world_dir / jnp.linalg.norm(world_dir, axis=-1,
                                                keepdims=True)
        cosang = jnp.clip(jnp.einsum("j,prj->pr", beam, world_dir,
                                     precision=_HI), -1.0, 1.0)
        scatter_angle = jnp.arccos(cosang)
        # linear interpolation on the uniform angle grid (ref: :186-201)
        del_angle = angles[1] - angles[0]
        a = (scatter_angle - angles[0]) / del_angle
        a0 = jnp.clip(jnp.floor(a).astype(jnp.int32), 0, table.shape[0] - 2)
        frac = a - a0.astype(a.dtype)
        tbl = table.T[diameter_index]                         # (P, A)
        irr_l = jnp.take_along_axis(tbl, a0, axis=1)          # (P, R)
        irr_u = jnp.take_along_axis(tbl, a0 + 1, axis=1)
        irradiance = (irr_l + frac * (irr_u - irr_l)) \
            * source_radiance[:, None]
    else:
        irradiance = jnp.broadcast_to(source_radiance[:, None], (P, R))

    radiance = irradiance / (params.aperture_f_number ** 2)

    wavelength = jnp.full((P * R,), params.beam_wavelength, dtype=f32)
    return RayBundle(pos.reshape(P * R, 3).astype(f32),
                     d.reshape(P * R, 3).astype(f32),
                     wavelength,
                     radiance.reshape(P * R).astype(f32))


# ---------------------------------------------------------------------------
# Lens-model stages
# ---------------------------------------------------------------------------


def apparent_image_rays(rays: RayBundle, params: RenderParams) -> RayBundle:
    """Pinhole 'apparent image' model: no lens tracing, pure magnification.

    Reverses the ray, intersects the object plane, and scales by the
    thin-lens magnification with inversion; the returned positions are the
    image-plane coordinates fed to the splat.  (ref: parallel_ray_tracing.cu
    create_apparent_image:1545-1648)
    """
    z_object = params.object_distance + params.z_offset
    direction = -rays.dir
    # plane -z + z_object = 0
    t_hit = -(-rays.pos[:, 2] + z_object) / (-direction[:, 2])
    hit = rays.pos + direction * t_hit[:, None]

    f = params.thin_lens_focal_length
    magnification = f / (z_object - params.z_offset - f)
    x_img = -hit[:, 0] * magnification
    y_img = -hit[:, 1] * magnification
    pos = jnp.stack([x_img, y_img, jnp.zeros_like(x_img)], axis=-1)
    return RayBundle(pos, direction, rays.wavelength, rays.radiance)


def _apply_position_noise(rays: RayBundle, params: RenderParams,
                          noise_key) -> RayBundle:
    """Gaussian sensor-position noise: N(0, 1) * std * pixel_pitch added to
    the final intersection point before pixel mapping (all three sensor
    paths in the reference do this identically; ref:
    parallel_ray_tracing.cu:1424-1434, :1607-1615, :1773-1781)."""
    if not params.add_pos_noise:
        return rays
    noise = jax.random.normal(noise_key, (rays.pos.shape[0], 2),
                              dtype=rays.pos.dtype)
    scale = jnp.float32(params.pos_noise_std * params.pixel_pitch)
    pos = rays.pos.at[:, :2].add(noise * scale)
    return RayBundle(pos, rays.dir, rays.wavelength, rays.radiance)


def apparent_image_splat(rays: RayBundle, params: RenderParams, image,
                         noise_key=None):
    """Apparent-image model + full-circle erf splat (render_fraction = 1.0).

    (ref: create_apparent_image:1545-1733)
    """
    img_rays = apparent_image_rays(rays, params)
    img_rays = _apply_position_noise(img_rays, params, noise_key)
    return image + diffraction_splat(
        img_rays.pos, img_rays.dir, img_rays.radiance, img_rays.valid,
        nx=params.nx, ny=params.ny, pixel_pitch=params.pixel_pitch,
        diameter=params.diffraction_diameter, render_fraction=1.0,
        mirror_x=True)


def sensor_plane_rays(rays: RayBundle, params: RenderParams) -> RayBundle:
    """Advance rays to the sensor plane (ref: :1404-1438)."""
    t_hit = -(rays.pos[:, 2] - params.z_sensor) / rays.dir[:, 2]
    hit = rays.pos + rays.dir * t_hit[:, None]
    return RayBundle(hit, rays.dir, rays.wavelength, rays.radiance)


def sensor_splat(rays: RayBundle, params: RenderParams, image,
                 noise_key=None):
    """Intersect the sensor plane and deposit radiance.

    (ref: intersect_sensor_02 / intersect_sensor dispatch at
    parallel_ray_tracing.cu:2178-2241)
    """
    on_sensor = sensor_plane_rays(rays, params)
    on_sensor = _apply_position_noise(on_sensor, params, noise_key)
    if params.implement_diffraction:
        return image + diffraction_splat(
            on_sensor.pos, on_sensor.dir, on_sensor.radiance, on_sensor.valid,
            nx=params.nx, ny=params.ny, pixel_pitch=params.pixel_pitch,
            diameter=params.diffraction_diameter, render_fraction=0.75,
            mirror_x=True)
    return image + bilinear_splat(
        on_sensor.pos, on_sensor.dir, on_sensor.radiance, on_sensor.valid,
        nx=params.nx, ny=params.ny, pixel_pitch=params.pixel_pitch)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def _generate_and_march(chunk, params: RenderParams, march_fn,
                        rotation_matrix, inverse_rotation_matrix,
                        scattering_static) -> RayBundle:
    """Ray generation + (optional) density-gradient stage."""
    x, y, z, radiance, diam, r1, r2 = chunk
    rays = generate_rays(
        x, y, z, radiance, diam, r1, r2, params,
        scattering=scattering_static.get("table"),
        inverse_rotation_matrix=scattering_static.get("inv_rot"),
        beam_propagation_vector=scattering_static.get("beam"))

    if march_fn is not None:
        # camera -> world: undo the z_object shift and camera rotation
        # (ref: parallel_ray_tracing.cu:2036-2082)
        shift = jnp.asarray([0.0, 0.0, params.z_offset + 750e3],
                            dtype=rays.pos.dtype)
        inv_rot = jnp.asarray(inverse_rotation_matrix, dtype=rays.pos.dtype)
        rot = jnp.asarray(rotation_matrix, dtype=rays.pos.dtype)
        pos_w = jnp.matmul(rays.pos - shift, inv_rot.T, precision=_HI)
        dir_w = jnp.matmul(rays.dir, inv_rot.T, precision=_HI)
        rays_w = RayBundle(pos_w, dir_w, rays.wavelength, rays.radiance)
        rays_w = march_fn(rays_w)
        pos_c = jnp.matmul(rays_w.pos, rot.T, precision=_HI) + shift
        dir_c = jnp.matmul(rays_w.dir, rot.T, precision=_HI)
        dir_c = dir_c / jnp.linalg.norm(dir_c, axis=-1, keepdims=True)
        rays = RayBundle(pos_c, dir_c, rays.wavelength, rays_w.radiance)
    return rays


def trace_chunk(chunk, params: RenderParams, stack, march_fn,
                rotation_matrix, inverse_rotation_matrix,
                scattering_static, noise_key=None):
    """Render one particle chunk into a partial image.

    ``chunk`` is (x, y, z, radiance, diameter_index, r1, r2).
    ``march_fn`` is None or rays->rays (the density-gradient stage).
    """
    rays = _generate_and_march(chunk, params, march_fn, rotation_matrix,
                               inverse_rotation_matrix, scattering_static)
    image = jnp.zeros((params.ny, params.nx), dtype=jnp.float32)
    if params.lens_model == "apparent":
        return apparent_image_splat(rays, params, image, noise_key=noise_key)
    rays = propagate_system(rays, stack, params.lens_model)
    return sensor_splat(rays, params, image, noise_key=noise_key)


def trace_final_rays(chunk, params: RenderParams, stack, march_fn,
                     rotation_matrix, inverse_rotation_matrix,
                     scattering_static, noise_key=None) -> RayBundle:
    """Run the full pipeline but return the final per-ray state instead of
    splatting — the analogue of the reference's saved pos/dir dumps
    (ref: parallel_ray_tracing.cu:3561-3670), consumed by
    photon_tpu.analysis for deflection extraction."""
    rays = _generate_and_march(chunk, params, march_fn, rotation_matrix,
                               inverse_rotation_matrix, scattering_static)
    if params.lens_model == "apparent":
        rays = apparent_image_rays(rays, params)
    else:
        rays = propagate_system(rays, stack, params.lens_model)
        rays = sensor_plane_rays(rays, params)
    if params.add_pos_noise:
        # the reference's dumps record the post-noise intersection
        # (noise lands in ray_source_coordinates before the save)
        if noise_key is None:
            noise_key = jax.random.key(0)
        rays = _apply_position_noise(rays, params, noise_key)
    return rays


def render_rays(cfg: SimulationConfig, setup: CameraSetup,
                source: LightfieldSource, r1, r2,
                march_fn=None, scattering=None) -> RayBundle:
    """Trace all rays and return their final positions/directions.

    Ray ordering is particle-major (particle p's rays occupy
    [p*R, (p+1)*R)), matching the reference's dump layout so the analysis
    stage can average per dot.  Intended for analysis-scale ray budgets;
    use render_image for full renders.
    """
    params = RenderParams.from_setup(cfg, setup, source)
    scattering_static = _scattering_static(scattering)
    chunk = (jnp.asarray(source.x), jnp.asarray(source.y),
             jnp.asarray(source.z),
             jnp.asarray(source.radiance, jnp.float32),
             jnp.asarray(source.diameter_index),
             jnp.asarray(r1, jnp.float32), jnp.asarray(r2, jnp.float32))
    return trace_final_rays(chunk, params, setup.elements, march_fn,
                            setup.rotation_matrix,
                            setup.inverse_rotation_matrix, scattering_static)


def _scattering_static(scattering):
    if scattering is None:
        return {}
    return {
        "table": (jnp.asarray(scattering["scattering_angle"],
                              dtype=jnp.float32),
                  jnp.asarray(scattering["scattering_irradiance"],
                              dtype=jnp.float32)),
        "inv_rot": np.asarray(scattering["inverse_rotation_matrix"],
                              dtype=np.float32),
        "beam": np.asarray(scattering["beam_propogation_vector"],
                           dtype=np.float32),
    }


def render_image(cfg: SimulationConfig, setup: CameraSetup,
                 source: LightfieldSource, r1, r2,
                 march_fn=None, scattering=None,
                 rays_per_chunk: int = 2_000_000,
                 noise_seed: Optional[int] = None) -> jnp.ndarray:
    """Render the full raw image for a light-field source.

    Chunks particles so at most ~rays_per_chunk rays are in flight
    (the analogue of the reference's KMAX relaunch loop,
    ref: parallel_ray_tracing.cu:3506-3515), accumulating into one image.
    """
    params = RenderParams.from_setup(cfg, setup, source)
    R = int(source.lightray_number_per_particle)
    P = source.num_particles
    chunk_p = max(1, min(P, rays_per_chunk // max(R, 1)))
    n_chunks = math.ceil(P / chunk_p)
    pad = n_chunks * chunk_p - P

    def pad_to(a, fill=0.0):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill,
                                          dtype=a.dtype)]) if pad else a

    xs = pad_to(source.x).reshape(n_chunks, chunk_p)
    ys = pad_to(source.y).reshape(n_chunks, chunk_p)
    zs = pad_to(source.z, fill=1.0).reshape(n_chunks, chunk_p)
    # padded particles get zero radiance -> contribute nothing
    rad = pad_to(source.radiance.astype(np.float32)).reshape(n_chunks, chunk_p)
    diam = pad_to(source.diameter_index).reshape(n_chunks, chunk_p)

    scattering_static = _scattering_static(scattering)

    r1 = jnp.asarray(r1, dtype=jnp.float32)
    r2 = jnp.asarray(r2, dtype=jnp.float32)

    noise_keys = jax.random.split(
        jax.random.key(cfg.seed if noise_seed is None else noise_seed),
        n_chunks)

    @jax.jit
    def run(xs, ys, zs, rad, diam, r1, r2, noise_keys):
        def body(image, chunk):
            x, y, z, rd, di, nk = chunk
            img = trace_chunk((x, y, z, rd, di, r1, r2), params,
                              setup.elements, march_fn,
                              setup.rotation_matrix,
                              setup.inverse_rotation_matrix,
                              scattering_static, noise_key=nk)
            return image + img, None

        init = jnp.zeros((params.ny, params.nx), dtype=jnp.float32)
        image, _ = jax.lax.scan(body, init,
                                (xs, ys, zs, rad, diam, noise_keys))
        return image

    return run(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(zs),
               jnp.asarray(rad), jnp.asarray(diam), r1, r2, noise_keys)
