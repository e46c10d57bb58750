"""Vectorized lens/aperture propagation physics.

Replacement for the reference's per-ray device functions
(C12 lens paths in SURVEY.md):

* sphere intersection — ref: parallel_ray_tracing.cu ray_sphere_intersection
  (:239-343) and the NumPy twin perform_ray_tracing_03.py:472-582
* optical-axis distance — ref: measure_distance_to_optical_axis (:345-380)
* thin-lens ('t'), thick spherical lens ('l') and aperture propagation —
  ref: propagate_rays_through_single_element (:383-1011)
* sequential system traversal — ref: propagate_rays_through_optical_system
  (:1274-1381)

Everything operates on ray bundles of static shape (N, 3)/(N,), with the
reference's NaN-poisoning convention: rays that miss the pitch, suffer
total internal reflection, or miss the sensor carry NaN coordinates and are
dropped by the sensor stage's finite-mask.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class RayBundle(NamedTuple):
    """A batch of light rays (positions in microns, unit directions)."""

    pos: jnp.ndarray        # (N, 3)
    dir: jnp.ndarray        # (N, 3)
    wavelength: jnp.ndarray  # (N,)
    radiance: jnp.ndarray   # (N,)

    @property
    def valid(self):
        return jnp.isfinite(self.pos).all(axis=-1) \
            & jnp.isfinite(self.dir).all(axis=-1)


def _normalize(v):
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def _poison(rays: RayBundle, bad) -> RayBundle:
    """Set rays where ``bad`` is True to NaN (the reference's failure path).

    A select, not a multiply by NaN: the backward pass then sends a zero
    cotangent to poisoned rays instead of NaN * 0 = NaN."""
    bad3 = bad[:, None]
    return RayBundle(jnp.where(bad3, jnp.nan, rays.pos),
                     jnp.where(bad3, jnp.nan, rays.dir),
                     jnp.where(bad, jnp.nan, rays.wavelength),
                     jnp.where(bad, jnp.nan, rays.radiance))


def ray_sphere_intersection(center, radius, direction, origin, surface: str):
    """First intersection of rays with a spherical surface.

    ``surface`` is 'front' or 'back'; combined with the sign of ``radius``
    it selects which quadratic root is the physically-entered surface
    (ref: parallel_ray_tracing.cu:239-343 — note the back-surface root
    choice is deliberately the same as front for matching curvature signs;
    see the in-source comment about curvature sign flips).
    Rays that miss return NaN positions.
    """
    omc = origin - center
    alpha = jnp.sum(direction * direction, axis=-1)
    beta = 2.0 * jnp.sum(direction * omc, axis=-1)
    gamma = jnp.sum(omc * omc, axis=-1) - radius * radius
    disc = beta * beta - 4.0 * alpha * gamma
    miss = disc < 0.0
    sq = jnp.sqrt(jnp.where(miss, 0.0, disc))
    t1 = (-beta + sq) / (2.0 * alpha)
    t2 = (-beta - sq) / (2.0 * alpha)
    lo = jnp.minimum(t1, t2)
    hi = jnp.maximum(t1, t2)
    if surface == "front":
        t = jnp.where(radius > 0, lo, hi)
    else:
        t = jnp.where(radius > 0, lo, hi)  # same branch; see docstring
    # NaN only after the product: a NaN t would turn the zero cotangent
    # of a missed ray into NaN in the backward pass
    hit = origin + direction * jnp.where(miss, 0.0, t)[:, None]
    return jnp.where(miss[:, None], jnp.nan, hit)


def distance_to_optical_axis(pos, axis_point, plane_normal):
    """Distance from points to the line through axis_point along plane_normal.

    (ref: parallel_ray_tracing.cu:345-380)
    """
    n = jnp.asarray(plane_normal)
    t_min = jnp.sum(n * (pos - axis_point), axis=-1) / jnp.sum(n * n)
    foot = axis_point + n * t_min[:, None]
    return jnp.linalg.norm(pos - foot, axis=-1)


def _refractive_index_ratio(n_element, abbe, wavelength, entering: bool):
    """Snell ratio with optional Abbe/Cauchy dispersion.

    ``entering=True`` gives 1/n_lambda (air -> glass); False gives n_lambda
    (glass -> air).  (ref: parallel_ray_tracing.cu:618-643, :767-788)
    """
    lambda_d, lambda_f, lambda_c = 589.3, 486.1, 656.3
    dispersion = (1.0 / (wavelength * wavelength) - 1.0 / lambda_d ** 2) * (
        (n_element - 1.0) / (abbe * (1.0 / lambda_f ** 2 - 1.0 / lambda_c ** 2)))
    n_lambda = jnp.where(jnp.isnan(abbe), n_element, n_element + dispersion)
    return jnp.where(entering, 1.0 / n_lambda, n_lambda)


def _refract(direction, normal, ratio):
    """Snell refraction of unit rays about unit surface normals.

    Returns (new_direction, tir_mask).  (ref: :645-687)
    """
    cos_i = -jnp.sum(direction * normal, axis=-1)
    radicand = 1.0 - ratio * ratio * (1.0 - cos_i * cos_i)
    tir = radicand < 0.0
    k = ratio * cos_i - jnp.sqrt(jnp.where(tir, 0.0, radicand))
    out = direction * ratio[:, None] + k[:, None] * normal
    return _normalize(out), tir


def _dot(a, b):
    """Full-f32 product: positions are ~1e6 um, so a TF32 product would
    misplace the plane hits by hundreds of um."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


def propagate_thin_lens(rays: RayBundle, center, plane, pitch,
                        focal_length) -> RayBundle:
    """Ideal thin-lens deflection at the lens plane (ref: :416-503)."""
    n = plane[:3]
    t_hit = -(_dot(rays.pos, n) + plane[3]) / _dot(rays.dir, n)
    hit = rays.pos + rays.dir * t_hit[:, None]
    r = distance_to_optical_axis(hit, center, n)
    rays = RayBundle(hit, rays.dir, rays.wavelength, rays.radiance)
    rays = _poison(rays, r > pitch / 2.0)
    new_dir = _normalize(-(rays.pos - center) / focal_length + rays.dir)
    return RayBundle(rays.pos, new_dir, rays.wavelength, rays.radiance)


def propagate_thick_lens(rays: RayBundle, center, plane, pitch,
                         vertex_distance, front_radius, back_radius,
                         refractive_index, abbe_number,
                         transmission_ratio, absorbance_rate) -> RayBundle:
    """Two-surface spherical lens with Snell refraction (ref: :507-864)."""
    n_hat = plane[:3] / jnp.linalg.norm(plane[:3])

    # ---- front surface -------------------------------------------------
    ds = vertex_distance / 2.0 - front_radius
    front_center = center + n_hat * ds
    hit = ray_sphere_intersection(front_center, front_radius,
                                  rays.dir, rays.pos, "front")
    r = distance_to_optical_axis(hit, center, n_hat)
    rays = _poison(RayBundle(hit, rays.dir, rays.wavelength, rays.radiance),
                   ~(r <= pitch / 2.0))
    normal = _normalize(rays.pos - front_center)
    ratio = _refractive_index_ratio(refractive_index, abbe_number,
                                    rays.wavelength, entering=True)
    new_dir, tir = _refract(rays.dir, normal, ratio)
    rays = _poison(RayBundle(rays.pos, new_dir, rays.wavelength,
                             rays.radiance), tir)

    # ---- back surface --------------------------------------------------
    ds = -vertex_distance / 2.0 - back_radius
    back_center = center + n_hat * ds
    entry_pos = rays.pos
    hit = ray_sphere_intersection(back_center, back_radius,
                                  rays.dir, rays.pos, "back")
    r = distance_to_optical_axis(hit, center, n_hat)
    rays = _poison(RayBundle(hit, rays.dir, rays.wavelength, rays.radiance),
                   ~(r <= pitch / 2.0))
    normal = -_normalize(rays.pos - back_center)
    ratio = _refractive_index_ratio(refractive_index, abbe_number,
                                    rays.wavelength, entering=False)
    new_dir, tir = _refract(rays.dir, normal, ratio)

    # radiance: absorbance over the glass path, else transmission scaling
    # (ref: :838-853 — note the reference multiplies, rather than
    # exponentiates, the absorbance path length; reproduced as-is)
    # (absorbance_rate is a static float: a traced select would send the
    # unused branch a zero cotangent through |path|, NaN where path = 0)
    if absorbance_rate != 0.0:
        path = jnp.linalg.norm(rays.pos - entry_pos, axis=-1)
        radiance = (1.0 - absorbance_rate) * rays.radiance * path
    else:
        radiance = transmission_ratio * rays.radiance
    rays = _poison(RayBundle(rays.pos, new_dir, rays.wavelength, radiance),
                   tir)
    return rays


def propagate_aperture(rays: RayBundle, center, plane, pitch,
                       vertex_distance) -> RayBundle:
    """Aperture stop: two planar pitch culls (ref: :868-992)."""
    n = plane[:3]
    norm_mag = jnp.linalg.norm(n)
    for ds in (-vertex_distance / 2.0, +vertex_distance / 2.0):
        d_plane = plane[3] - ds * norm_mag
        t_hit = -(_dot(rays.pos, n) + d_plane) / _dot(rays.dir, n)
        hit = rays.pos + rays.dir * t_hit[:, None]
        r = distance_to_optical_axis(hit, center, n)
        rays = _poison(RayBundle(hit, rays.dir, rays.wavelength,
                                 rays.radiance), ~(r <= pitch / 2.0))
    return rays


def propagate_system(rays: RayBundle, stack, lens_model: str) -> RayBundle:
    """Propagate rays through the flattened optical train in light order.

    The train is defined sensor-outward, so traversal reverses the system
    index (ref: propagate_rays_through_optical_system:1419-1485).  Elements
    are few and static, so this unrolls as a Python loop at trace time.
    ``lens_model`` 'thin-lens' forces every lens element through the ideal
    thin-lens path, matching the reference's element-type override
    (ref: perform_ray_tracing_03.py:1803-1808).
    """
    order = np.argsort(-np.asarray(stack.system_index), kind="stable")
    for e in order:
        center = jnp.asarray(stack.center[e], dtype=rays.pos.dtype)
        plane = jnp.asarray(stack.plane_parameters[e], dtype=rays.pos.dtype)
        etype = int(stack.element_type[e])
        if etype == 0 and lens_model == "thin-lens":
            rays = propagate_thin_lens(
                rays, center, plane, float(stack.pitch[e]),
                float(stack.thin_lens_focal_length[e]))
        elif etype == 0:
            rays = propagate_thick_lens(
                rays, center, plane, float(stack.pitch[e]),
                float(stack.vertex_distance[e]),
                float(stack.front_surface_radius[e]),
                float(stack.back_surface_radius[e]),
                float(stack.refractive_index[e]),
                float(stack.abbe_number[e]),
                float(stack.transmission_ratio[e]),
                float(stack.absorbance_rate[e]))
        elif etype == 1:
            rays = propagate_aperture(
                rays, center, plane, float(stack.pitch[e]),
                float(stack.vertex_distance[e]))
        else:
            raise NotImplementedError("mirror elements are not supported")
    return rays
