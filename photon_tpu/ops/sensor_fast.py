"""Patch splat: sensor integration for particle ray fans.

All rays of one source point land within ~a pixel of the point's
predicted image, so each particle accumulates a local K x K *patch* of
erf (or bilinear hat) weights — a batched (K, R) @ (R, K) product — and
only P small patches are scatter-added into the frame, instead of the
reference's per-ray, per-pixel atomic adds.

Deviation from the reference splat (documented): :func:`patch_splat`
drops the circular ``render_radius <= rf * D`` mask
(parallel_ray_tracing.cu:1514-1519) — the erf tail it truncates is
< 1e-3 of the peak — which makes the weights separable.
:func:`particle_splat` applies the mask.  Use photon_tpu.ops.sensor for
bit-level parity.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.special import erf


def _erf_pair(f, diameter):
    """erf(sqrt8 (f - .5)/D) - erf(sqrt8 (f + .5)/D) (ref: :1529-1533)."""
    sqrt8 = jnp.float32(math.sqrt(8.0))
    return erf(sqrt8 * (f - 0.5) / diameter) \
        - erf(sqrt8 * (f + 0.5) / diameter)


@partial(jax.jit, static_argnames=("nx", "ny", "patch", "diameter"))
def patch_splat(X, Y, amp, pred_col, pred_row, *, nx: int, ny: int,
                diameter: float, patch: int = 12):
    """Accumulate per-particle erf spots into the image.

    Args:
      X, Y: (P, R) splat centers in pixel coordinates (the reference's
        ``d_x - 0.5`` / ``d_y - 0.5``; X already mirrored).
      amp: (P, R) per-ray amplitude = radiance * cos^4(alpha) * 8/pi,
        zeroed for invalid rays.
      pred_col, pred_row: (P,) predicted integer image position of each
        particle (patch anchor).
      patch: patch side K; rays farther than ~K/2 - D pixels from the
        anchor lose their tail (choose K >= spot + spread).

    Returns: (ny, nx) float32 image.
    """
    P, R = X.shape
    K = patch
    col0 = jnp.clip(pred_col - K // 2, -K, nx - 1)   # (P,)
    row0 = jnp.clip(pred_row - K // 2, -K, ny - 1)

    safe = jnp.isfinite(X) & jnp.isfinite(Y) & (amp > 0)
    Xs = jnp.where(safe, X, -1e6)
    Ys = jnp.where(safe, Y, -1e6)
    amp = jnp.where(safe, amp, 0.0)

    # separable erf weights per patch column/row: lists of (P, R)
    wx = [_erf_pair((col0[:, None] + j) - Xs, diameter) for j in range(K)]
    wy = [_erf_pair((row0[:, None] + i) - Ys, diameter) for i in range(K)]
    # fold amplitude (and the pi/32 normalization) into the row weights
    scale = jnp.float32(math.pi / 32.0)
    wy = [w * (amp * scale) for w in wy]

    A = jnp.stack(wy)          # (K, P, R)
    B = jnp.stack(wx)          # (K, P, R)
    patches = jnp.einsum("ipr,jpr->pij", A, B,
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)  # (P, K, K)

    return _scatter_patches(patches, col0, row0, nx, ny)


def _scatter_patches(patches, col0, row0, nx, ny):
    K = patches.shape[-1]
    cols = col0[:, None, None] + jnp.arange(K, dtype=jnp.int32)[None, None, :]
    rows = row0[:, None, None] + jnp.arange(K, dtype=jnp.int32)[:, None][None]
    in_bounds = (cols >= 0) & (cols < nx) & (rows >= 0) & (rows < ny)
    flat = jnp.where(in_bounds, rows * nx + cols, nx * ny)
    image = jnp.zeros((ny * nx,), jnp.float32)
    image = image.at[flat.reshape(-1)].add(
        patches.reshape(-1), mode="drop")
    return image.reshape(ny, nx)


@partial(jax.jit, static_argnames=("nx", "ny", "patch"))
def bilinear_patch_splat(X, Y, amp, pred_col, pred_row, *, nx: int, ny: int,
                         patch: int = 12):
    """Per-ray 4-pixel bilinear splat, patch-accumulated (no diffraction).

    Twin of ops.sensor.bilinear_splat for the (P, R) fast pipeline: the
    bilinear deposit is exactly a 2-tap hat kernel centered at
    ``d_x - 0.5`` / ``d_y - 0.5`` (unmirrored x), so the same separable
    patch einsum applies with hat instead of erf weights.  The
    reference's legacy ``(ii-1)*nx + (jj-1)`` accumulation shift
    (parallel_ray_tracing.cu:2228) is reproduced by scattering the
    patches one row/column up-left; weight masking uses the *unshifted*
    pixel bounds, matching intersect_sensor (:1735-1895).

    Args:
      X, Y: (P, R) = d_x - 0.5 / d_y - 0.5, x NOT mirrored.
      amp: (P, R) radiance * cos^4(alpha) (no 8/pi factor here).
    """
    K = patch
    col0 = jnp.clip(pred_col - K // 2, -K, nx - 1)   # (P,)
    row0 = jnp.clip(pred_row - K // 2, -K, ny - 1)

    safe = jnp.isfinite(X) & jnp.isfinite(Y) & (amp > 0)
    Xs = jnp.where(safe, X, -1e6)
    Ys = jnp.where(safe, Y, -1e6)
    amp = jnp.where(safe, amp, 0.0)

    def hat(f):
        return jnp.maximum(0.0, 1.0 - jnp.abs(f))

    cols = [col0[:, None] + j for j in range(K)]     # list of (P, 1)
    rows = [row0[:, None] + i for i in range(K)]
    wx = [jnp.where((c >= 0) & (c <= nx - 1), hat(c - Xs), 0.0)
          for c in cols]
    wy = [jnp.where((r >= 0) & (r <= ny - 1), hat(r - Ys), 0.0) * amp
          for r in rows]

    A = jnp.stack(wy)          # (K, P, R)
    B = jnp.stack(wx)          # (K, P, R)
    patches = jnp.einsum("ipr,jpr->pij", A, B,
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)  # (P, K, K)
    return _scatter_patches(patches, col0 - 1, row0 - 1, nx, ny)


def _particle_splat_xla(Xs, Ys, A, col0, row0, static):
    """(P, K, K) erf patches under the circular render mask, then one
    scatter-add into the frame."""
    nx, ny, diameter, K, render_fraction = static
    fc = (col0[:, None] + jnp.arange(K, dtype=jnp.int32)[None]) \
        .astype(Xs.dtype) - Xs[:, None]                 # (P, K)
    fr = (row0[:, None] + jnp.arange(K, dtype=jnp.int32)[None]) \
        .astype(Ys.dtype) - Ys[:, None]
    wx = _erf_pair(fc, diameter)                        # (P, K)
    wy = _erf_pair(fr, diameter) * A[:, None]
    patches = wy[:, :, None] * wx[:, None, :]           # (P, K, K) [row,col]
    rf_d = jnp.float32(render_fraction * diameter)
    in_circle = (fc[:, None, :] ** 2 + fr[:, :, None] ** 2) <= rf_d * rf_d
    patches = jnp.where(in_circle, patches, 0.0)
    return _scatter_patches(patches, col0, row0, nx, ny)


@partial(jax.jit, static_argnames=("nx", "ny", "patch", "diameter",
                                   "render_fraction"))
def particle_splat(Xbar, Ybar, A, pred_col, pred_row, *, nx: int, ny: int,
                   diameter: float, patch: int = 12,
                   render_fraction: float = 0.75):
    """One erf spot per *particle* at its amplitude-weighted ray centroid.

    Valid whenever a particle's rays land within a small fraction of a
    pixel of each other (always true for the reference's ray-cone and
    diffraction defaults; per-ray position noise must use
    :func:`patch_splat`).  Work drops from O(rays * K^2) to
    O(particles * K): the erf profile is evaluated once per particle per
    patch row/column and outer-multiplied; the reference's circular
    render mask (pixels beyond render_fraction * diameter of the center
    deposit nothing, parallel_ray_tracing.cu:1514-1519 — it truncates
    ~2% of the spot flux, measured) applies per particle on the
    materialized patch.

    The anchor window is clamped fully inside the frame: erf weights
    depend only on ``pixel - center``, so the clamp never changes a
    visible pixel (the circular mask bounds the support) — it just makes
    every deposit bounds-free.

    Args:
      Xbar, Ybar: (P,) amplitude-weighted splat centers (pixel coords).
      A: (P,) summed ray amplitude (radiance * cos^4 * 8/pi), zero for
        particles with no surviving rays.
    """
    K = patch
    # the bounds-free clamp above is only sound when the circular render
    # mask fits the patch; render_image_fast's auto patch guarantees it,
    # a caller passing a small explicit patch with a large diameter must
    # fail loudly rather than silently changing edge-particle deposits
    if render_fraction * diameter > (K - 1) / 2:
        raise ValueError(
            f"patch={K} cannot contain the circular render mask "
            f"(render_fraction * diameter = {render_fraction * diameter}"
            f" > (patch-1)/2); enlarge patch")
    col0 = jnp.clip(pred_col - K // 2, 0, max(nx - K, 0))
    row0 = jnp.clip(pred_row - K // 2, 0, max(ny - K, 0))
    safe = jnp.isfinite(Xbar) & jnp.isfinite(Ybar) & (A > 0)
    Xs = jnp.where(safe, Xbar, -1e6)
    Ys = jnp.where(safe, Ybar, -1e6)
    A = jnp.where(safe, A, 0.0) * jnp.float32(math.pi / 32.0)

    static = (nx, ny, float(diameter), K, float(render_fraction))
    return _particle_splat_xla(Xs, Ys, A, col0, row0, static)
