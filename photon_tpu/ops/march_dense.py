"""Dense-weight chief-ray march for volumes with small slabs.

The production BOS/PIV fast path marches one *chief ray per particle*
(ops.march_fast.march_chief_deltas explains why that is exact to the
lens-cone width).  This module samples the field without a gather:

For a z-slab scan, interpolating P rays inside one (H, W) slab is a
*bilinear form*  s[p] = sum_ij wy[p,j] wx[p,i] slab[j,i]  whose x/y
weight vectors are dense (P, W) / (P, H) matrices with 2 (trilinear) or
4 (cubic B-spline) nonzeros per row.  Evaluated densely, the x
contraction is one matrix product (P, W) @ (W, 2*H*C) per integrator
stage and the y/z contraction is one fused elementwise-reduce pass over
the (P, 2*H*C) product.  That costs O(W) multiply-adds per sample and a
(P, 2*H*C) intermediate per stage, so it is used up to 128x128 slabs;
larger volumes take the gather-based tube march (ops.march_fast).

The integrator is the same exact (non-paraxial) eikonal ODE in the z
parametrization as ops.march_fast (Sharma's T = n * dr/ds):

    d(x, y)/dz = (T_x / T_z, T_y / T_z)
    dT/dz      = (n / T_z) * grad(n)

with per-slab steps.  Supported integrators (matching the reference's
menu, trace_rays_through_density_gradients.h:1455-1544):
  1 = Euler, 2 = RK4, 3 = RK4 with 2 substeps/slab (the fixed-grid
  stand-in for the reference's adaptive RK45 at tol 1e-3; ref :304-718),
  4 = Adams-Bashforth-4 with per-ray RK4 bootstrap (ref :1293-1453).
Interpolation schemes: 1 = trilinear, 2 = tricubic B-spline over
prefiltered coefficients (ref CubicInterpolationCUDA; the prefilter here
is a differentiable lax.scan IIR, see :func:`bspline_prefilter_jax`).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from photon_tpu.volume import DensityVolume

# matmul precision for the interpolation contraction: the field values
# (grad n ~ 1e-9/um, n-1 ~ 1e-4) and hat weights both need more than
# bf16's 8 (or TF32's 10) mantissa bits for micro-radian deflection
# accuracy
_PRECISION = jax.lax.Precision.HIGHEST

# dense weights span the full slab axes and the sampler materializes a
# (P, 2*H*4) intermediate per stage, so the cost per sample grows with
# the slab; past this cap the tube march (O(TW^2) per sample) takes over
DENSE_MAX_SLAB = 128 * 128


def dense_march_supported(vol: DensityVolume) -> bool:
    w, h, _ = vol.sizes
    return int(w) * int(h) <= DENSE_MAX_SLAB


# ---------------------------------------------------------------------------
# Differentiable cubic B-spline prefilter (JAX twin of interp.bspline_prefilter)
# ---------------------------------------------------------------------------

_POLE = float(np.sqrt(3.0) - 2.0)


def _prefilter_axis_jax(x, axis: int):
    """Causal+anticausal IIR along one axis as a pair of lax.scans."""
    z = jnp.float32(_POLE)
    lam = jnp.float32((1.0 - _POLE) * (1.0 - 1.0 / _POLE))
    x = jnp.moveaxis(x, axis, 0)
    n = x.shape[0]
    horizon = min(n, max(12, int(math.ceil(math.log(1e-7)
                                           / math.log(abs(_POLE))))))
    zk = (_POLE ** np.arange(horizon)).astype(np.float32)
    c0 = lam * jnp.tensordot(jnp.asarray(zk), x[:horizon], axes=(0, 0),
                             precision=_PRECISION)

    def fwd(c_prev, xi):
        c = lam * xi + z * c_prev
        return c, c

    _, cs = jax.lax.scan(fwd, c0, x[1:])
    c = jnp.concatenate([c0[None], cs], axis=0)

    c_last = (z / (z * z - 1.0)) * (z * c[n - 2] + c[n - 1])

    def bwd(c_next, ci):
        c_i = z * (c_next - ci)
        return c_i, c_i

    _, cs2 = jax.lax.scan(bwd, c_last, c[:-1], reverse=True)
    c = jnp.concatenate([cs2, c_last[None]], axis=0)
    return jnp.moveaxis(c, 0, axis)


def bspline_prefilter_jax(field):
    """(D, H, W, C) samples -> B-spline coefficients, differentiable.

    Same recurrences as interp.bspline_prefilter (host/float64 twin used
    by the exact path); f32 here so density-field gradients can flow
    through tricubic renders.
    """
    out = field
    for axis in (0, 1, 2):
        out = _prefilter_axis_jax(out, axis)
    return out


# ---------------------------------------------------------------------------
# Dense interpolation weights
# ---------------------------------------------------------------------------


def _tri_weights(u, n: int):
    """Dense trilinear hat weights, clamped addressing: (P, n).

    Weight of voxel i for voxel-space coordinate u is
    max(0, 1 - |clip(u, 0, n-1) - i|) — identical to the 2-tap clamped
    texture fetch (interp.sample_trilinear) evaluated densely.
    """
    uc = jnp.clip(u, 0.0, n - 1.0)
    iota = jnp.arange(n, dtype=u.dtype)
    return jnp.maximum(0.0, 1.0 - jnp.abs(uc[:, None] - iota[None, :]))


def _b3(x):
    """Cubic B-spline kernel B3(x), support |x| < 2."""
    ax = jnp.abs(x)
    inner = (4.0 - 6.0 * ax * ax + 3.0 * ax * ax * ax) / 6.0
    outer = (2.0 - ax) ** 3 / 6.0
    return jnp.where(ax < 1.0, inner, jnp.where(ax < 2.0, outer, 0.0))


def _cubic_weights(u, n: int):
    """Dense cubic B-spline weights with clamped-tap edge folding: (P, n).

    Exactly reproduces the 4-tap clamped gather (interp.sample_tricubic):
    every tap's index clips to the border voxel, so weight of voxel i is
    the sum of B3(u - j) over all taps j that clip onto i.  Clamping u
    into [-2, n+1] is lossless — beyond that range every tap already
    clips to the same border and the weights have saturated (B3 taps are
    a partition of unity, so a far-outside coordinate samples the pure
    border value).  Up to three taps can fold onto each border voxel
    (e.g. u = -2: taps -3, -2, -1 all clip to 0).
    """
    uc = jnp.clip(u, -2.0, n + 1.0)
    iota = jnp.arange(n, dtype=u.dtype)
    w = _b3(uc[:, None] - iota[None, :])
    # fold the (at most three) out-of-range taps onto each border
    left = _b3(uc + 1.0) + _b3(uc + 2.0) + _b3(uc + 3.0)
    right = _b3(uc - n) + _b3(uc - (n + 1.0)) + _b3(uc - (n + 2.0))
    w = w.at[:, 0].add(left).at[:, n - 1].add(right)
    return w


# ---------------------------------------------------------------------------
# The march
# ---------------------------------------------------------------------------


def _slab_sample(pair_T, wx, wy0, wy1, h: int):
    """One matrix product + fused reduce: samples of both slabs.

    pair_T: (W, 2*H*4) — slab pair (lo, hi) transposed for the x
    contraction.  wy0/wy1 already include the z blend factors
    (wy0 = wy * (1-tz), wy1 = wy * tz), so the reduce over (2, H)
    directly yields the trilinear/tricubic-in-xy, linear-in-z sample.
    Returns 4 (P,) channel arrays (gx, gy, gz, n-1).
    """
    t = jnp.dot(wx, pair_T, precision=_PRECISION)      # (P, 2*H*4)
    P = t.shape[0]
    t = t.reshape(P, 2, h, 4)
    s = (t[:, 0] * wy0[:, :, None] + t[:, 1] * wy1[:, :, None]).sum(axis=1)
    return s[:, 0], s[:, 1], s[:, 2], s[:, 3]


def march_chief_dense(vol: DensityVolume, xs, ys, zs, dcx, dcy, dcz, *,
                      algorithm: int = 2, interpolation_scheme: int = 1,
                      field=None, substeps: Optional[int] = None):
    """March (P,) chief rays through the volume; dense-weight sampling.

    Same contract as ops.march_fast.march_tubes with (P,) states: rays
    that do not intersect the volume's z range pass through unchanged;
    returns (x, y, z, dirx, diry, dirz) after traversal.

    ``field`` overrides ``vol.field`` (a (D, H, W, 4) array) so density
    gradients can flow in inverse problems.  For
    ``interpolation_scheme=2`` the B-spline prefilter runs here (in JAX,
    differentiable) — pass raw samples, not coefficients.
    """
    w, h, d = (int(s) for s in vol.sizes)
    if w * h > DENSE_MAX_SLAB:
        raise ValueError(
            f"slab {w}x{h} exceeds the dense-march limit (the sampler "
            "materializes (P, 2*H*4) per stage) — route large volumes "
            "through the tube march (render_image_fast does this "
            "automatically)")
    if field is None:
        field = vol.field
    if interpolation_scheme == 2:
        field = bspline_prefilter_jax(field)
        weights = _cubic_weights
    else:
        weights = _tri_weights

    sx = (vol.max_bound[0] - vol.min_bound[0]) / (w - 2.0)
    sy = (vol.max_bound[1] - vol.min_bound[1]) / (h - 2.0)
    z_max = vol.max_bound[2]
    z_min = vol.min_bound[2]
    dz_slab = (z_max - z_min) / (d - 2.0)
    min_x = vol.min_bound[0]
    min_y = vol.min_bound[1]

    # entry advance to the volume top (identical to march_fast.march_tubes)
    t_entry = (z_max - zs) / dcz
    above = zs >= z_max
    adv = jnp.where(above, jnp.maximum(t_entry, 0.0), 0.0)
    x = xs + dcx * adv
    y = ys + dcy * adv
    z = jnp.where(above, jnp.full_like(zs, 1.0) * z_max, zs + dcz * adv)
    inside = (z <= z_max) & (z >= z_min) & (dcz < 0)

    n0 = 1.0 + vol.data_min
    Tx = n0 * dcx
    Ty = n0 * dcy
    Tz = n0 * dcz

    # scanned inputs: slab pairs transposed for the x contraction,
    # ordered top-down (landing planes k = d-2 .. 0)
    field_T = jnp.transpose(field, (0, 2, 1, 3))       # (D, W, H, 4)
    pairs = jnp.stack([field_T[:-1], field_T[1:]], axis=2)
    pairs = jnp.flip(pairs, axis=0).reshape(d - 1, w, 2 * h * 4)
    ks = jnp.arange(d - 2, -1, -1, dtype=jnp.float32)
    # landing planes are voxel-center z's, except the last: the march
    # domain is the reference's inside_box range [z_min, z_max], so the
    # final step lands on z_min (voxel-center plane k=0 sits half a
    # voxel *below* the volume; marching down to it integrated an extra
    # 0.5 dz of clamped border field — a measured +0.5/(d-2) systematic
    # deflection bias vs the exact marcher before this clamp)
    z_planes = jnp.maximum(z_min + (ks - 0.5) * dz_slab, z_min)

    # sub-slab integration knob: error budget control for configs that
    # demand a finer z discretization than one RK4 step per voxel plane
    # (the RK45 stand-in defaults to 2 substeps, matching the adaptive
    # reference's typical accepted step of ~half a voxel)
    if substeps is None:
        substeps = 2 if algorithm == 3 else 1
    substeps = max(1, int(substeps))
    ab4 = algorithm == 4

    def rhs(pair_T, z_plane, px, py, tx, ty, tz, z_at):
        uz = jnp.clip((z_at - z_plane) / dz_slab, 0.0, 1.0)
        ux = 0.5 + (px - min_x) / sx
        uy = 0.5 + (py - min_y) / sy
        wx = weights(ux, w)
        wy = weights(uy, h)
        gx, gy, gz, nm1 = _slab_sample(pair_T, wx, wy * (1.0 - uz)[:, None],
                                       wy * uz[:, None], h)
        inv_tz = 1.0 / tz
        g = (1.0 + nm1) * inv_tz
        return (tx * inv_tz, ty * inv_tz, g * gx, g * gy, g * gz)

    def rk4_sub(pair_T, z_plane, st, hstep, z0):
        px, py, tx, ty, tz = st
        k1 = rhs(pair_T, z_plane, px, py, tx, ty, tz, z0)
        h2 = hstep / 2.0
        k2 = rhs(pair_T, z_plane, px + h2 * k1[0], py + h2 * k1[1],
                 tx + h2 * k1[2], ty + h2 * k1[3], tz + h2 * k1[4], z0 + h2)
        k3 = rhs(pair_T, z_plane, px + h2 * k2[0], py + h2 * k2[1],
                 tx + h2 * k2[2], ty + h2 * k2[3], tz + h2 * k2[4], z0 + h2)
        k4 = rhs(pair_T, z_plane, px + hstep * k3[0], py + hstep * k3[1],
                 tx + hstep * k3[2], ty + hstep * k3[3],
                 tz + hstep * k3[4], z0 + hstep)
        s6 = hstep / 6.0
        return tuple(v + s6 * (a + 2 * b + 2 * c + dd)
                     for v, a, b, c, dd in zip(st, k1, k2, k3, k4))

    def step(carry, xs_slab):
        pair_T, z_plane = xs_slab
        if ab4:
            x, y, z, Tx, Ty, Tz, nstep, hist = carry
        else:
            x, y, z, Tx, Ty, Tz = carry
        in_band = inside & (z > z_plane)
        hstep = -(z - z_plane)

        st = (x, y, Tx, Ty, Tz)
        if algorithm == 1:
            k1 = rhs(pair_T, z_plane, x, y, Tx, Ty, Tz, z)
            new = tuple(v + hstep * k for v, k in zip(st, k1))
        elif substeps == 1 and not ab4:
            new = rk4_sub(pair_T, z_plane, st, hstep, z)
        elif ab4:
            # RK4 bootstrap (first 3 committed steps of each ray), then
            # AB4 over the stored derivative history (newest last)
            rk = rk4_sub(pair_T, z_plane, st, hstep, z)
            f_now = rhs(pair_T, z_plane, x, y, Tx, Ty, Tz, z)
            adams = tuple(
                v + hstep / 24.0 * (55.0 * fn - 59.0 * hist[2][i]
                                    + 37.0 * hist[1][i] - 9.0 * hist[0][i])
                for i, (v, fn) in enumerate(zip(st, f_now)))
            boot = nstep < 3
            new = tuple(jnp.where(boot, r, a) for r, a in zip(rk, adams))
            hist_new = (hist[1], hist[2], f_now)
        else:
            hs = hstep / substeps
            new = st
            for si in range(substeps):
                new = rk4_sub(pair_T, z_plane, new, hs, z + si * hs)

        x_n, y_n, Tx_n, Ty_n, Tz_n = new
        z_n = jnp.full_like(z, 1.0) * z_plane
        x = jnp.where(in_band, x_n, x)
        y = jnp.where(in_band, y_n, y)
        z = jnp.where(in_band, z_n, z)
        Tx = jnp.where(in_band, Tx_n, Tx)
        Ty = jnp.where(in_band, Ty_n, Ty)
        Tz = jnp.where(in_band, Tz_n, Tz)
        if ab4:
            nstep = nstep + in_band.astype(jnp.int32)
            hist = tuple(
                tuple(jnp.where(in_band, fn, fo)
                      for fn, fo in zip(h_new, h_old))
                for h_new, h_old in zip(hist_new, hist))
            return (x, y, z, Tx, Ty, Tz, nstep, hist), None
        return (x, y, z, Tx, Ty, Tz), None

    if ab4:
        zero5 = tuple(jnp.zeros_like(x) for _ in range(5))
        carry = (x, y, z, Tx, Ty, Tz,
                 jnp.zeros_like(x, dtype=jnp.int32), (zero5, zero5, zero5))
    else:
        carry = (x, y, z, Tx, Ty, Tz)
    carry, _ = jax.lax.scan(jax.checkpoint(step), carry,
                            (pairs, z_planes))
    x, y, z, Tx, Ty, Tz = carry[:6]

    Tn = jnp.sqrt(Tx * Tx + Ty * Ty + Tz * Tz)
    dirx_f = jnp.where(inside, Tx / Tn, dcx)
    diry_f = jnp.where(inside, Ty / Tn, dcy)
    dirz_f = jnp.where(inside, Tz / Tn, dcz)
    return x, y, z, dirx_f, diry_f, dirz_f


def choose_substeps(vol: DensityVolume, xs, ys, zs, dcx, dcy, dcz, *,
                    interpolation_scheme: int = 1, budget: float = 0.01,
                    max_substeps: int = 16, sample: int = 1024) -> int:
    """Error-controlled substep count for algorithm 3 (the RK45 stand-in).

    The reference's algorithm 3 is tolerance-adaptive per ray
    (trace_rays_through_density_gradients.h:304-718, tol 1e-3 with
    accept/reject); the dense march uses FIXED RK4 substeps per slab.
    This picks the count from the data: march a 1024-chief subsample at
    2 and 4 substeps, Richardson-estimate the 4-substep deflection
    error (RK4 is O(h^4): err(4) ~ |d4 - d2| / 15), and scale to the
    budget (relative to the largest deflection, the reference's
    acceptance currency).  Runs two tiny device marches, compiled once
    per volume shape; called host-side where ``substeps`` must become a
    static kernel parameter.
    """
    import numpy as np

    P = np.asarray(xs).shape[0]
    if P > sample:
        idx = np.linspace(0, P - 1, sample).astype(np.int64)
    else:
        idx = np.arange(P)
    sub = [jnp.asarray(np.asarray(a, np.float32)[idx])
           for a in (xs, ys, zs, dcx, dcy, dcz)]

    if dense_march_supported(vol):
        def marcher(substeps):
            return march_chief_dense(
                vol, *sub, algorithm=3,
                interpolation_scheme=interpolation_scheme,
                substeps=substeps)
    else:
        # beyond the dense cap: probe through the tube march (same
        # integrator semantics)
        from photon_tpu.ops.march_fast import march_chief_tubes

        def marcher(substeps):
            return march_chief_tubes(
                vol, *sub, algorithm=3,
                interpolation_scheme=interpolation_scheme,
                substeps=substeps)

    def exit_dirs(substeps):
        r = marcher(substeps)
        return np.stack([np.asarray(r[3]), np.asarray(r[4]),
                         np.asarray(r[5])], -1)

    d2 = exit_dirs(2)
    d4 = exit_dirs(4)
    defl = np.linalg.norm(
        d4 - np.stack([np.asarray(s) for s in sub[3:6]], -1), axis=1)
    scale = max(float(defl.max()), 1e-12)
    err4 = float(np.linalg.norm(d4 - d2, axis=1).max()) / 15.0 / scale
    if err4 <= budget:
        return 2 if err4 * (4.0 / 2.0) ** 4 <= budget else 4
    # err(n) ~ err4 * (4/n)^4  ->  n >= 4 * (err4/budget)^(1/4)
    n = int(np.ceil(4.0 * (err4 / budget) ** 0.25))
    return int(min(max(n, 4), max_substeps))


def chief_deltas_dense(vol: DensityVolume, xs, ys, zs, dcx, dcy, dcz, *,
                       algorithm: int = 2, interpolation_scheme: int = 1,
                       field=None, substeps: Optional[int] = None):
    """Dense-march twin of ops.march_fast.march_chief_deltas.

    Returns ``(z_exit, dpos_x, dpos_y, ddir_x, ddir_y, ddir_z)``, each
    (P,): the chief ray's exit plane and its curvature deltas relative
    to the straight-line continuation.
    """
    x1, y1, z1, dx1, dy1, dz1 = march_chief_dense(
        vol, xs, ys, zs, dcx, dcy, dcz, algorithm=algorithm,
        interpolation_scheme=interpolation_scheme, field=field,
        substeps=substeps)
    t = (z1 - zs) / dcz
    return (z1, x1 - (xs + dcx * t), y1 - (ys + dcy * t),
            dx1 - dcx, dy1 - dcy, dz1 - dcz)
