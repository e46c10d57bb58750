"""Refractive-index volume ingest and gradient precompute.

Replacement for the reference's density-volume setup (C13 setup
in SURVEY.md, ``trace_rays_through_density_gradients.h``):

* NRRD load + Gladstone-Dale conversion rho -> (n - 1) = K rho —
  ref: loadNRRD (:1663-1817), including the fixed -750e3 shift applied to
  the z space origin (:1704)
* central / one-sided finite-difference grad(n) precompute into a packed
  (grad_n, n-1) field — ref: setData (:1820-2002)
* bounds/spacing/step-size bookkeeping — ref: readDatafromFile (:2004-2105)

The packed field is stored as a (D, H, W, 4) float32 array indexed
``field[z, y, x] = (dn/dx, dn/dy, dn/dz, n-1)`` — the layout the marcher's
gather kernels consume.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

import jax.numpy as jnp

# the reference shifts the volume's z origin by this fixed amount so that
# world-z (measured from the sensor) lines up with the volume
# (ref: trace_rays_through_density_gradients.h:1704 and the matching shift
# in the kernel, parallel_ray_tracing.cu:2045)
Z_ORIGIN_SHIFT = 750e3


class DensityVolume(NamedTuple):
    """Packed refractive-index field + geometry (device-ready)."""

    field: jnp.ndarray      # (D, H, W, 4): (dn/dx, dn/dy, dn/dz, n-1)
    min_bound: jnp.ndarray  # (3,) microns
    max_bound: jnp.ndarray  # (3,)
    grid_spacing: jnp.ndarray  # (3,)
    data_min: float         # min of (n-1) over the volume
    step_size: float        # min grid spacing (the marcher's base step)
    max_step_size: float    # max grid spacing

    @property
    def sizes(self):
        d, h, w, _ = self.field.shape
        return w, h, d


def gradient_field(n_minus_1: np.ndarray, spacing) -> np.ndarray:
    """Finite-difference gradient of (n-1) on the grid, packed with values.

    Central differences in the interior, 2nd-order one-sided at the faces —
    identical stencils to the reference's ``setData``
    (ref: trace_rays_through_density_gradients.h:1856-1995).

    Args:
      n_minus_1: (W, H, D) array indexed [x, y, z] (NRRD axis order).
      spacing: (3,) grid spacings (dx, dy, dz).

    Returns:
      (D, H, W, 4) float32 packed (dn/dx, dn/dy, dn/dz, n-1), [z, y, x].
    """
    f = np.asarray(n_minus_1, dtype=np.float64)
    dx, dy, dz = (float(s) for s in np.asarray(spacing).ravel())

    def axis_gradient(arr, axis, h):
        g = np.empty_like(arr)
        # interior: central difference
        sl = [slice(None)] * 3
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        sl[axis], lo[axis], hi[axis] = slice(1, -1), slice(0, -2), slice(2, None)
        g[tuple(sl)] = (arr[tuple(hi)] - arr[tuple(lo)]) / (2.0 * h)
        # faces: 2nd-order one-sided
        first = [slice(None)] * 3
        first[axis] = 0
        s1, s2, s3 = list(first), list(first), list(first)
        s2[axis], s3[axis] = 1, 2
        g[tuple(s1)] = (-1.5 * arr[tuple(s1)] + 2.0 * arr[tuple(s2)]
                        - 0.5 * arr[tuple(s3)]) / h
        last = [slice(None)] * 3
        last[axis] = arr.shape[axis] - 1
        e1, e2, e3 = list(last), list(last), list(last)
        e2[axis], e3[axis] = arr.shape[axis] - 2, arr.shape[axis] - 3
        g[tuple(e1)] = (1.5 * arr[tuple(e1)] - 2.0 * arr[tuple(e2)]
                        + 0.5 * arr[tuple(e3)]) / h
        return g

    gx = axis_gradient(f, 0, dx)
    gy = axis_gradient(f, 1, dy)
    gz = axis_gradient(f, 2, dz)
    packed = np.stack([gx, gy, gz, f], axis=-1)       # (W, H, D, 4)
    return np.ascontiguousarray(
        packed.transpose(2, 1, 0, 3)).astype(np.float32)  # (D, H, W, 4)


def build_density_volume(rho: np.ndarray, spacings, space_origin,
                         gladstone_dale: float = 0.225e-3,
                         z_origin_shift: float = Z_ORIGIN_SHIFT
                         ) -> DensityVolume:
    """Pack a density grid (kg/m^3) into a marcher-ready volume.

    Args:
      rho: (W, H, D) density indexed [x, y, z].
      spacings: (dx, dy, dz) in microns.
      space_origin: (x0, y0, z0) in microns; z0 gets the reference's fixed
        -750e3 shift (ref: loadNRRD:1704).
    """
    rho = np.asarray(rho)
    spacings = np.asarray(spacings, dtype=np.float64).ravel()
    origin = np.asarray(space_origin, dtype=np.float64).ravel().copy()
    origin[2] -= z_origin_shift

    n_minus_1 = (gladstone_dale * rho).astype(np.float64)
    field = None
    try:  # prefer the C++ gradient precompute when built
        from photon_tpu import native
        field = native.gradient_field(n_minus_1.astype(np.float32), spacings)
    except Exception:
        field = None
    if field is None:
        field = gradient_field(n_minus_1, spacings)

    sizes = np.array(rho.shape, dtype=np.float64)     # (W, H, D)
    min_bound = origin
    max_bound = origin + (sizes - 1.0) * spacings

    return DensityVolume(
        field=jnp.asarray(field),
        min_bound=jnp.asarray(min_bound, dtype=jnp.float32),
        max_bound=jnp.asarray(max_bound, dtype=jnp.float32),
        grid_spacing=jnp.asarray(spacings, dtype=jnp.float32),
        data_min=float(n_minus_1.min()),
        step_size=float(spacings.min()),
        max_step_size=float(spacings.max()),
    )


def load_density_volume(path: str, gladstone_dale: float = 0.225e-3,
                        z_origin_shift: float = Z_ORIGIN_SHIFT
                        ) -> DensityVolume:
    """Load an NRRD density file into a marcher-ready volume.

    (ref: readDatafromFile:2004-2105 + loadNRRD:1663-1817)
    """
    from photon_tpu.utils.nrrd_io import read_nrrd

    data, hdr = read_nrrd(path)
    return build_density_volume(
        data, hdr["spacings"], hdr["space origin"],
        gladstone_dale=gladstone_dale, z_origin_shift=z_origin_shift)
