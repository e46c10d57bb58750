"""Synthetic density fields and the paraxial BOS oracle.

Replacement for the reference's field-authoring utilities
(C17 in SURVEY.md, ``python_codes/synthetic_fields.py`` and
``createNRRD.py``): analytic sine/Gaussian scalar fields with closed-form
gradients, NRRD export, and the theoretical-deflection calculators used to
validate rendered BOS displacements.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

GLADSTONE_DALE = 0.225e-3  # m^3/kg (ref: create_simulation_parameters.py:234)


def create_coordinate_grid(n=101, x_range=(-0.5, 0.5), y_range=(-0.5, 0.5)):
    x = np.linspace(x_range[0], x_range[1], n)
    y = np.linspace(y_range[0], y_range[1], n)
    return np.meshgrid(x, y, indexing="xy")


def create_sine_field(n=101, peak=1.0, wavelength=10.0,
                      x_range=(-0.5, 0.5), y_range=(-0.5, 0.5)):
    """cos*cos standing-wave field + analytic gradient
    (ref: synthetic_fields.create_sine_field:51-84)."""
    X, Y = create_coordinate_grid(n, x_range, y_range)
    k = 2.0 * np.pi / wavelength
    f = peak * np.cos(k * X) * np.cos(k * Y)
    f_x = -peak * k * np.sin(k * X) * np.cos(k * Y)
    f_y = -peak * k * np.cos(k * X) * np.sin(k * Y)
    return X, Y, f, f_x, f_y


def create_sine_field_3d(n=101, peak=1.0, wavelength=10.0,
                         x_range=(-0.5, 0.5), y_range=(-0.5, 0.5),
                         z_range=(-0.5, 0.5)):
    """(ref: synthetic_fields.create_sine_field_3d:87-124)"""
    x = np.linspace(*x_range, num=n)
    y = np.linspace(*y_range, num=n)
    z = np.linspace(*z_range, num=n)
    X, Y, Z = np.meshgrid(x, y, z, indexing="xy")
    x0, y0, z0 = np.mean(x_range), np.mean(y_range), np.mean(z_range)
    k = 2.0 * np.pi / wavelength
    f = peak * np.cos(k * X) * np.cos(k * Y) * np.cos(k * Z)
    f_x = -peak * k * np.sin(k * (X - x0)) * np.cos(k * (Y - y0)) \
        * np.cos(k * (Z - z0))
    f_y = -peak * k * np.cos(k * (X - x0)) * np.sin(k * (Y - y0)) \
        * np.cos(k * (Z - z0))
    f_z = -peak * k * np.cos(k * (X - x0)) * np.cos(k * (Y - y0)) \
        * np.sin(k * (Z - z0))
    return X, Y, Z, f, f_x, f_y, f_z


def create_gaussian_field(n=101, peak=1.0, peak_loc=(0.0, 0.0), std=0.1,
                          x_range=(-0.5, 0.5), y_range=(-0.5, 0.5)):
    """(ref: synthetic_fields.create_gaussian_field:127-154)"""
    X, Y = create_coordinate_grid(n, x_range, y_range)
    r2 = (X - peak_loc[0]) ** 2 + (Y - peak_loc[1]) ** 2
    f = peak * np.exp(-r2 / (2.0 * std ** 2))
    f_x = -peak * (X - peak_loc[0]) / std ** 2 * np.exp(-r2 / (2 * std ** 2))
    f_y = -peak * (Y - peak_loc[1]) / std ** 2 * np.exp(-r2 / (2 * std ** 2))
    return X, Y, f, f_x, f_y


def theoretical_deflection(rho_grad: float, magnification: float,
                           Z_D: float, del_z: float, rho_0: float,
                           pixel_pitch: float) -> Tuple[float, float]:
    """Paraxial BOS oracle: deflection angle + sensor displacement.

    ``epsilon = (1/n0) K grad(rho) dz``; displacement (pixels) =
    ``M Z_D epsilon / pixel_pitch``
    (ref: synthetic_fields.calculate_theoretical_deflection:193-215).
    All lengths in consistent units (the reference mixes: rho in kg/m^3,
    grad in kg/m^4, distances in m).
    """
    n_0 = GLADSTONE_DALE * rho_0 + 1.0
    n_grad = GLADSTONE_DALE * rho_grad
    epsilon = n_grad * del_z / n_0
    displacement = magnification * Z_D * epsilon / pixel_pitch
    return epsilon, displacement


def density_gradient_for_displacement(disp: float, magnification: float,
                                      Z_D: float, del_z: float,
                                      rho_0: float,
                                      pixel_pitch: float) -> float:
    """Inverse oracle: required grad(rho) for a target pixel displacement.

    (ref: synthetic_fields.calculate_density_gradient:218-241)
    """
    n_0 = GLADSTONE_DALE * rho_0 + 1.0
    epsilon = disp * pixel_pitch / (Z_D * magnification)
    n_grad = epsilon * n_0 / del_z
    return n_grad / GLADSTONE_DALE


def density_noise_for_displacement_noise(displacement_noise_std: float,
                                         magnification: float, Z_D: float,
                                         delta_x: float, delta_z: float,
                                         rho_0: float,
                                         pixel_pitch: float) -> float:
    """Noise-propagation calculator (ref: synthetic_fields:244-277)."""
    n_0 = GLADSTONE_DALE * rho_0 + 1.0
    return (2.0 * displacement_noise_std * pixel_pitch * delta_x
            / (magnification * Z_D * GLADSTONE_DALE / n_0
               * np.sqrt(2.0) * delta_z))


def paraxial_displacement_oracle(cfg, setup, vol, src, samples: int = 256):
    """Paraxial-oracle prediction of each dot's image displacement (px).

    eps = (1/n0) * integral of grad(n)_perp ds along the straight chief
    ray through the ACTUAL volume (midpoint rule over the AABB span),
    mapped to the sensor: apparent object shift = eps * Z_D (volume
    center -> dot plane), image shift = M * shift / pixel_pitch, x
    mirrored by the sensor's pixel mapping
    (parallel_ray_tracing.cu:1441-1447).  This is the per-dot
    generalization of :func:`theoretical_deflection` — the reference's
    own acceptance criterion for rendered BOS displacements
    (createNRRD.py:108-116, light_ray_processing.py:532-638).

    Args:
      cfg: SimulationConfig (pixel pitch).
      setup: CameraSetup (rotation, distances, magnification).
      vol: DensityVolume (gradients sampled trilinearly along the ray).
      src: LightfieldSource of the dots.
    Returns:
      (pred_px (P, 2), hit (P,) bool) — predicted displacement and
      whether the chief ray intersects the volume AABB.
    """
    import jax.numpy as jnp

    from photon_tpu.ops.interp import sample_trilinear, texture_lookup

    inv_rot = np.asarray(setup.inverse_rotation_matrix, np.float64)
    rot = np.asarray(setup.rotation_matrix, np.float64)
    shift = setup.z_offset + 750e3
    xs = np.asarray(src.x, np.float64)
    ys = np.asarray(src.y, np.float64)
    zs = np.asarray(src.z, np.float64)
    dden = setup.image_distance - zs
    tx, ty = xs / dden, ys / dden
    cinv = 1.0 / np.sqrt(tx ** 2 + ty ** 2 + 1.0)
    dir_cam = np.stack([tx * cinv, ty * cinv, -cinv], -1)
    pos_cam = np.stack([xs, ys, zs - shift], -1)
    dw = dir_cam @ inv_rot.T
    pw = pos_cam @ inv_rot.T

    mn = np.asarray(vol.min_bound, np.float64)
    mx = np.asarray(vol.max_bound, np.float64)
    t1 = (mn - pw) / dw
    t2 = (mx - pw) / dw
    tn = np.minimum(t1, t2).max(1)
    tf = np.maximum(t1, t2).min(1)
    hit = tf > tn

    S = int(samples)
    P = xs.size
    ts = tn[:, None] + (tf - tn)[:, None] * (np.arange(S)[None] + 0.5) / S
    pts = pw[:, None, :] + dw[:, None, :] * ts[..., None]
    field_flat = jnp.asarray(vol.field).reshape(-1, 4)
    lk = texture_lookup(jnp.asarray(pts.reshape(-1, 3), jnp.float32),
                        vol.min_bound, vol.max_bound, vol.sizes)
    sm = np.asarray(sample_trilinear(field_flat, vol.sizes, lk)
                    ).reshape(P, S, 4)
    grad_int = sm[..., :3].sum(1) * ((tf - tn) / S)[:, None]
    grad_int -= (grad_int * dw).sum(1, keepdims=True) * dw  # perp part
    ddir_cam = grad_int @ rot.T                              # n0 ~ 1

    volc_cam = ((mn + mx) / 2) @ rot.T
    Z_D = zs - (volc_cam[2] + shift)
    pred_px = (ddir_cam[:, :2] * Z_D[:, None] * setup.magnification
               / cfg.camera_design.pixel_pitch)
    pred_px[:, 0] *= -1.0  # sensor x mirror
    return pred_px, hit


def save_density_nrrd(path: str, rho: np.ndarray, x, y, z) -> None:
    """Write a density grid to NRRD with the reference's header layout
    (ref: synthetic_fields.save_nrrd:157-190)."""
    from photon_tpu.utils.nrrd_io import write_nrrd

    x, y, z = (np.asarray(a).ravel() for a in (x, y, z))
    write_nrrd(path, np.asarray(rho, np.float32),
               spacings=[x[1] - x[0], y[1] - y[0], z[1] - z[0]],
               space_origin=[x.min(), y.min(), z.min()])
