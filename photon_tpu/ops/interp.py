"""Volume sampling: trilinear (CUDA-texture semantics) and tricubic B-spline.

Replacement for the reference's texture-unit interpolation
(C14 in SURVEY.md):

* hardware trilinear ``tex3D`` fetches of the packed (grad n, n-1) field —
  ref: trace_rays_through_density_gradients.h:77-81, 830, 1052
* texture-coordinate mapping ``lookup = 1 + frac * (N - 2)`` —
  ref: calculate_lookup_index (:195-215)
* in-volume predicates — ref: ray_inside_box (:217-251),
  access_refractive_index (:253-277)
* cubic B-spline prefilter + tricubic sampling — ref: vendored
  CubicInterpolationCUDA (D. Ruijters), invoked via Host_Init (:1648-1660)
  and cubicTex3D (:912, 1216).

Trilinear sampling is expressed as an 8-corner gather + blend over a flat (D*H*W, 4) buffer (one XLA gather per
stage), replicating CUDA's convention that an unnormalized texture
coordinate ``x`` samples voxel centers at ``x - 0.5`` with clamped
addressing.  The tricubic path interpolates prefiltered B-spline
coefficients over the 4x4x4 neighborhood with separable cubic weights —
mathematically identical to the reference's 8-trilinear-fetch trick, which
only pays off when trilinear fetches are a hardware primitive.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Coordinate mapping + predicates (reference conventions)
# ---------------------------------------------------------------------------


def texture_lookup(pos, min_bound, max_bound, sizes):
    """World position -> texture coordinate per axis.

    ``lookup = 1 + (pos - min)/(max - min) * (N - 2)``
    (ref: calculate_lookup_index:195-215 — the reference's chosen variant
    among several commented alternatives; sampling therefore spans voxel
    centers 0.5 .. N-1.5 rather than the full grid).
    """
    w, h, d = sizes
    n = jnp.asarray([w, h, d], dtype=pos.dtype)
    frac = (pos - min_bound) / (max_bound - min_bound)
    return 1.0 + frac * (n - 2.0)


def inside_box(pos, lookup, min_bound, max_bound, sizes):
    """The reference's ray-in-volume predicate (ref: ray_inside_box:217-251)."""
    w, h, d = sizes
    n = jnp.asarray([w, h, d], dtype=lookup.dtype)
    pos_ok = jnp.all((pos >= min_bound) & (pos < max_bound), axis=-1)
    look_ok = jnp.all((lookup >= 0) & (lookup < n), axis=-1)
    return pos_ok & look_ok


def can_access(lookup, sizes):
    """Lookup-range-only predicate (ref: access_refractive_index:253-277)."""
    w, h, d = sizes
    n = jnp.asarray([w, h, d], dtype=lookup.dtype)
    return jnp.all((lookup >= 0) & (lookup < n), axis=-1)


# ---------------------------------------------------------------------------
# Trilinear sampling (tex3D semantics)
# ---------------------------------------------------------------------------


def sample_trilinear(field_flat, sizes, lookup):
    """Trilinear fetch replicating ``tex3D`` with clamped addressing.

    Args:
      field_flat: (D*H*W, C) flattened field, index z*H*W + y*W + x.
      sizes: (W, H, D) static ints.
      lookup: (N, 3) texture coordinates (x, y, z).

    Returns: (N, C) interpolated samples.
    """
    w, h, d = sizes
    u = lookup - 0.5                       # voxel-center space
    i0 = jnp.floor(u)
    t = (u - i0)                           # (N, 3) blend fractions
    i0 = i0.astype(jnp.int32)

    nmax = jnp.asarray([w - 1, h - 1, d - 1], dtype=jnp.int32)
    c0 = jnp.clip(i0, 0, nmax)
    c1 = jnp.clip(i0 + 1, 0, nmax)

    def flat(ix, iy, iz):
        return (iz * (h * w) + iy * w + ix)

    # gather the 8 corners in one indexed fetch: (N, 8)
    idx = jnp.stack([
        flat(c0[:, 0], c0[:, 1], c0[:, 2]),
        flat(c1[:, 0], c0[:, 1], c0[:, 2]),
        flat(c0[:, 0], c1[:, 1], c0[:, 2]),
        flat(c1[:, 0], c1[:, 1], c0[:, 2]),
        flat(c0[:, 0], c0[:, 1], c1[:, 2]),
        flat(c1[:, 0], c0[:, 1], c1[:, 2]),
        flat(c0[:, 0], c1[:, 1], c1[:, 2]),
        flat(c1[:, 0], c1[:, 1], c1[:, 2]),
    ], axis=-1)
    corners = field_flat[idx]              # (N, 8, C)

    tx = t[:, 0:1]
    ty = t[:, 1:2]
    tz = t[:, 2:3]
    wx = jnp.concatenate([1 - tx, tx], axis=-1)        # (N, 2)
    wy = jnp.concatenate([1 - ty, ty], axis=-1)
    wz = jnp.concatenate([1 - tz, tz], axis=-1)
    wgt = (wz[:, :, None, None] * wy[:, None, :, None]
           * wx[:, None, None, :]).reshape(lookup.shape[0], 8)  # z,y,x order
    return jnp.einsum("nk,nkc->nc", wgt, corners,
                      precision=jax.lax.Precision.HIGHEST)



# ---------------------------------------------------------------------------
# Cubic B-spline prefilter + tricubic sampling
# ---------------------------------------------------------------------------

_POLE = float(np.sqrt(3.0) - 2.0)   # pole of the cubic B-spline filter


def _prefilter_axis(data: np.ndarray, axis: int) -> np.ndarray:
    """Causal+anticausal recursive filter converting samples to B-spline
    coefficients along one axis (standard Unser/Ruijters formulation,
    equivalent to the reference's CubicBSplinePrefilter3D kernels)."""
    z = _POLE
    lam = (1.0 - z) * (1.0 - 1.0 / z)   # gain = 6
    x = np.moveaxis(np.asarray(data, dtype=np.float64), axis, 0)
    n = x.shape[0]
    c = np.empty_like(x)

    # causal initialization: truncated geometric sum of the signal
    horizon = min(n, max(12, int(np.ceil(np.log(1e-7) / np.log(abs(z))))))
    zk = z ** np.arange(horizon)
    c0 = np.tensordot(zk, x[:horizon], axes=(0, 0))
    c[0] = lam * c0
    for i in range(1, n):
        c[i] = lam * x[i] + z * c[i - 1]

    # anticausal initialization: c-[n-1] = z/(z^2-1) * (z*c+[n-2] + c+[n-1])
    if n >= 2:
        c[n - 1] = (z / (z * z - 1.0)) * (z * c[n - 2] + c[n - 1])
    for i in range(n - 2, -1, -1):
        c[i] = z * (c[i + 1] - c[i])

    return np.moveaxis(c, 0, axis)


def bspline_prefilter(field: np.ndarray) -> np.ndarray:
    """Separable 3-D prefilter: per-channel, per-axis recursive filtering.

    Input/output shape (D, H, W, C) float32.  Host-side (runs once per
    volume); the device only sees the finished coefficient grid.
    """
    out = np.asarray(field, dtype=np.float64).copy()
    for axis in (0, 1, 2):
        out = _prefilter_axis(out, axis)
    return out.astype(np.float32)


def _bspline_weights(t):
    """The four cubic B-spline basis weights for fraction t in [0,1)."""
    one = 1.0 - t
    w0 = (one * one * one) / 6.0
    w1 = (3.0 * t * t * t - 6.0 * t * t + 4.0) / 6.0
    w2 = (-3.0 * t * t * t + 3.0 * t * t + 3.0 * t + 1.0) / 6.0
    w3 = (t * t * t) / 6.0
    return w0, w1, w2, w3


def sample_tricubic(coeff_flat, sizes, lookup):
    """Tricubic B-spline interpolation of prefiltered coefficients.

    Same coordinate convention as :func:`sample_trilinear`: the texture
    coordinate ``lookup`` samples around ``lookup - 0.5`` in voxel space
    with clamped addressing over the 4x4x4 support.

    Args:
      coeff_flat: (D*H*W, C) flattened prefiltered coefficients.
      sizes: (W, H, D) static ints.
      lookup: (N, 3).
    """
    w, h, d = sizes
    u = lookup - 0.5
    i0 = jnp.floor(u)
    t = u - i0
    base = i0.astype(jnp.int32) - 1        # neighborhood start, per axis

    wx = jnp.stack(_bspline_weights(t[:, 0]), axis=-1)   # (N, 4)
    wy = jnp.stack(_bspline_weights(t[:, 1]), axis=-1)
    wz = jnp.stack(_bspline_weights(t[:, 2]), axis=-1)

    offs = jnp.arange(4, dtype=jnp.int32)
    ix = jnp.clip(base[:, 0:1] + offs[None, :], 0, w - 1)   # (N, 4)
    iy = jnp.clip(base[:, 1:2] + offs[None, :], 0, h - 1)
    iz = jnp.clip(base[:, 2:3] + offs[None, :], 0, d - 1)

    flat = (iz[:, :, None, None] * (h * w)
            + iy[:, None, :, None] * w
            + ix[:, None, None, :])                         # (N, 4, 4, 4)
    n = lookup.shape[0]
    vals = coeff_flat[flat.reshape(n, 64)]                  # (N, 64, C)
    wgt = (wz[:, :, None, None] * wy[:, None, :, None]
           * wx[:, None, None, :]).reshape(n, 64)
    return jnp.einsum("nk,nkc->nc", wgt, vals,
                      precision=jax.lax.Precision.HIGHEST)
