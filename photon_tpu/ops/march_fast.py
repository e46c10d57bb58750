"""Gather-based eikonal marching: per-particle tubes + z-slab scan.

The reference marches each ray independently with per-step 3-D texture
fetches (trace_rays_through_density_gradients.h).  This module exploits
the scene's physical coherence to fetch each voxel once per particle:

* All rays emitted by one source point (particle/dot) stay within a
  fraction of a voxel of each other: the lens-aperture cone is
  ``ray_cone_pitch_ratio * lens_pitch`` wide (~1 um for the BOS defaults)
  and BOS/PIV deflections are micro-radians, while voxels are mm-scale.
  So each particle needs only a narrow **tube** of voxel columns —
  a (D, TW, TW) window around its chief ray — extracted once per render
  (the only gather, O(P * D * TW^2), amortized over all R rays and steps).

* The camera looks down -z, so the march is re-parametrized from arc
  length to z and becomes a ``lax.scan`` over z-slabs.  Per step the
  active slab pair is a *scanned input* (streamed, not gathered), and
  trilinear interpolation inside the (TW x TW) tube cross-section is an
  unrolled weighted sum of (P, R) arrays with the large axis minor.

Its cost does not grow with the slab area, so it is the fast march for
volumes whose slabs exceed the dense march's cap (ops.march_dense).

The integrator solves the exact (non-paraxial) eikonal ODE in z:
with T = n * dr/ds (Sharma's optical ray vector) and g = ds/dz = n/T_z,

    d(x, y)/dz = (T_x / T_z, T_y / T_z)
    dT/dz      = g * grad(n)

stepped with classic RK4 at dz = one slab spacing.  This is a different
discretization than the reference's arc-length RK4 (:952-1291) but
converges to the same continuum solution; tests check both against the
paraxial BOS oracle and against the exact-replica marcher.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from photon_tpu.volume import DensityVolume

TUBE_WIDTH = 4  # voxel columns per side of a particle's tube


class TubeBundle(NamedTuple):
    """Per-particle voxel tubes, laid out for slab streaming.

    ``slabs`` has shape (D, C=4, TW*TW, P): scan axis leading, channels
    (dn/dx, dn/dy, dn/dz, n-1), flattened tube cross-section (row-major,
    q = j * TW + i), particles minor, so each per-slab operation reads
    contiguous (P,) rows.
    ``x0``/``y0`` are (D, P): the world coordinates of tube column
    (j=0, i=0) at each slab — per-slab because slanted tubes re-center
    their window on the chief line slab by slab.
    """

    slabs: jnp.ndarray      # (D, 4, TW*TW, P)
    x0: jnp.ndarray         # (D, P)
    y0: jnp.ndarray         # (D, P)


def _tube_width(tubes: TubeBundle) -> int:
    return int(round(math.isqrt(int(tubes.slabs.shape[2]))))


def extract_tubes(vol: DensityVolume, particle_x, particle_y,
                  tube_width: int = TUBE_WIDTH,
                  slope_x=None, slope_y=None) -> TubeBundle:
    """Cut a (D, TW, TW) voxel tube around each particle's chief ray.

    With ``slope_x``/``slope_y`` (= dx/dz, dy/dz of the chief ray, per
    particle) the window follows the slanted chief line slab by slab —
    needed for tilted cameras or wide fields of view; without them the
    tube is a vertical column at (particle_x, particle_y), which must
    then be the chief's entry point at the volume top.

    The cut is one flat gather per channel with the particle axis minor
    (see TubeBundle): this single O(D * TW^2 * P) gather — amortized over all R rays and RK4 stages —
    replaces the reference's per-step tex3D fetches
    (trace_rays_through_density_gradients.h:830,912).

    Interpolation uses the same clamped-texture convention as the
    reference path (``lookup = 1 + frac (N-2)``, ops.interp).
    """
    w, h, d = vol.sizes
    tw = tube_width
    p = particle_x.shape[0]
    field = vol.field                      # (D, H, W, 4)
    sx = (vol.max_bound[0] - vol.min_bound[0]) / (w - 2.0)
    sy = (vol.max_bound[1] - vol.min_bound[1]) / (h - 2.0)

    if slope_x is None:
        cx = jnp.broadcast_to(jnp.asarray(particle_x)[None, :], (d, p))
        cy = jnp.broadcast_to(jnp.asarray(particle_y)[None, :], (d, p))
    else:
        # slanted tubes: chief position at each voxel plane's world z
        dz_slab = (vol.max_bound[2] - vol.min_bound[2]) / (d - 2.0)
        z_planes = vol.min_bound[2] \
            + (jnp.arange(d, dtype=jnp.float32) - 0.5) * dz_slab   # (D,)
        z_top = vol.max_bound[2]
        # particle_x/y are the chief entry coordinates at z_top
        cx = particle_x[None, :] \
            + slope_x[None, :] * (z_planes[:, None] - z_top)
        cy = particle_y[None, :] \
            + slope_y[None, :] * (z_planes[:, None] - z_top)

    ux = 0.5 + (cx - vol.min_bound[0]) / sx
    uy = 0.5 + (cy - vol.min_bound[1]) / sy
    ix0 = jnp.clip(jnp.floor(ux).astype(jnp.int32) - (tw // 2 - 1),
                   0, w - tw)                             # (D, P)
    iy0 = jnp.clip(jnp.floor(uy).astype(jnp.int32) - (tw // 2 - 1),
                   0, h - tw)

    # flat window indices (D, TW, TW, P): (iy0 + j) * W + ix0 + i
    off = jnp.arange(tw, dtype=jnp.int32)
    idx = ((iy0[:, None, None, :] + off[:, None, None]) * w
           + (ix0[:, None, None, :] + off[None, :, None]))
    idx = idx.reshape(d, tw * tw * p)
    field_t = jnp.transpose(field, (3, 0, 1, 2)).reshape(4, d, h * w)
    chans = [jnp.take_along_axis(field_t[c], idx, axis=1) for c in range(4)]
    slabs = jnp.stack(chans, axis=1).reshape(d, 4, tw * tw, p)
    x0 = vol.min_bound[0] + (ix0.astype(jnp.float32) - 0.5) * sx   # (D, P)
    y0 = vol.min_bound[1] + (iy0.astype(jnp.float32) - 0.5) * sy
    return TubeBundle(slabs=slabs, x0=x0, y0=y0)


def _tube_scales(vol: DensityVolume):
    w, h, d = vol.sizes
    sx = (vol.max_bound[0] - vol.min_bound[0]) / (w - 2.0)
    sy = (vol.max_bound[1] - vol.min_bound[1]) / (h - 2.0)
    return sx, sy


def _cross_section(slab, wx, wy):
    """Weighted (TW x TW) reduction of one slab for all rays.

    slab: (4, TW*TW, P); wx/wy: lists of TW weight arrays, either
    (P, R) (per-ray march) or (P,) (chief-ray march).  Returns 4 channel
    arrays shaped like the weights: (gx, gy, gz, n-1).  All operations
    are elementwise with the large axis minor — no gathers.
    """
    tw = len(wx)
    per_ray = wx[0].ndim == 2
    outs = []
    for c in range(4):
        acc = None
        for j in range(tw):
            inner = None
            for i in range(tw):
                col = slab[c, j * tw + i]          # (P,)
                if per_ray:
                    col = col[:, None]             # (P, 1) -> bcast (P, R)
                term = wx[i] * col
                inner = term if inner is None else inner + term
            term = wy[j] * inner
            acc = term if acc is None else acc + term
        outs.append(acc)
    return outs


def _hat_weights(u, tw: int):
    """Linear-interpolation hat weights over the tube's integer grid.

    For fractional coordinate ``u`` in tube-local voxel units, weight of
    column i is max(0, 1 - |u - i|) — exactly the trilinear kernel, with
    clamping to the tube edges (mirrors the reference's clamped texture
    addressing for rays near the tube border).
    """
    uc = jnp.clip(u, 0.0, tw - 1.0)
    return [jnp.maximum(0.0, 1.0 - jnp.abs(uc - i)) for i in range(tw)]


def _b3(x):
    """Cubic B-spline kernel B3(x), support |x| < 2."""
    ax = jnp.abs(x)
    inner = (4.0 - 6.0 * ax * ax + 3.0 * ax * ax * ax) / 6.0
    outer = (2.0 - ax) ** 3 / 6.0
    return jnp.where(ax < 1.0, inner, jnp.where(ax < 2.0, outer, 0.0))


def _cubic_tube_weights(u, tw: int):
    """Cubic B-spline weights over the tube's integer grid, edge-folded.

    Taps that fall outside the tube window fold onto its border column.
    The window is chief-centered and clipped to the volume (extract_tubes),
    so an out-of-window tap can only occur at the volume border, where the
    border column IS the volume's border voxel — the fold (same formula as
    march_dense._cubic_weights, which see for the derivation) therefore
    reproduces the reference's clamped texture addressing
    (ref: CubicInterpolationCUDA cubicTex3D.cu with cudaAddressModeClamp).
    Requires tw >= 6 so interior rays keep their full 4-tap support.
    """
    uc = jnp.clip(u, -2.0, tw + 1.0)
    w = [_b3(uc - i) for i in range(tw)]
    w[0] = w[0] + _b3(uc + 1.0) + _b3(uc + 2.0) + _b3(uc + 3.0)
    w[-1] = (w[-1] + _b3(uc - tw) + _b3(uc - (tw + 1.0))
             + _b3(uc - (tw + 2.0)))
    return w


def march_tubes(vol: DensityVolume, tubes: TubeBundle,
                x, y, z, dirx, diry, dirz,
                algorithm: int = 2, interpolation_scheme: int = 1,
                substeps: Optional[int] = None) -> Tuple:
    """March (P, R) ray fans through their tubes with a z-slab scan.

    Args:
      x, y, z: (P, R) world positions (marcher frame).
      dirx..dirz: (P, R) unit directions (dirz < 0: toward the sensor).
      algorithm: matches the reference's integrator menu
        (trace_rays_through_density_gradients.h:1455-1544): 1 = Euler,
        2 = RK4, 3 = RK4 with 2 substeps/slab (fixed-grid stand-in for
        the adaptive RK45, ref :304-718), 4 = Adams-Bashforth-4 with
        per-ray RK4 bootstrap (ref :1293-1453).
      interpolation_scheme: 1 = trilinear, 2 = tricubic B-spline — the
        tubes must then hold *prefiltered coefficients* (cut after
        march_dense.bspline_prefilter_jax) and be >= 6 columns wide.
      substeps: RK4 substeps per slab (default 2 for algorithm 3, else
        1; ignored by Euler and AB4), as in march_dense.

    Returns:
      (x, y, z, dirx, diry, dirz) after traversal.  Rays that do not
      intersect the volume's z range pass through unchanged (the
      reference's miss semantics); lateral tube clamping mirrors the
      clamped texture addressing.
    """
    w, h, d = vol.sizes
    tw = _tube_width(tubes)
    sx, sy = _tube_scales(vol)
    z_max = vol.max_bound[2]
    z_min = vol.min_bound[2]
    dz_slab = (z_max - z_min) / (d - 2.0)   # z per texture voxel
    # slab k spans lookup z in [k, k+1]; world z of slab plane k:
    # z = min + (k - 0.5) dz  (inverse of the lookup map)

    # advance rays to the volume's entry plane (z = z_max) if above it
    # (rays march toward -z; rays already below the volume never enter)
    t_entry = (z_max - z) / dirz
    above = z >= z_max
    adv = jnp.where(above, jnp.maximum(t_entry, 0.0), 0.0)
    x = x + dirx * adv
    y = y + diry * adv
    # snap advanced rays exactly onto the entry plane: computing
    # z + dirz * t_entry can round an ulp past z_max under fused
    # compilation, which would flip the inside test for every ray that
    # starts above the volume
    z = jnp.where(above, jnp.full_like(z, 1.0) * z_max, z + dirz * adv)
    inside = (z <= z_max) & (z >= z_min) & (dirz < 0)

    # Sharma variables: T = n * dir; n at entry ~ interpolated later, use
    # 1 + field mean as a start (first slab sample corrects immediately)
    n0 = 1.0 + vol.data_min
    Tx = n0 * dirx
    Ty = n0 * diry
    Tz = n0 * dirz

    per_ray = x.ndim == 2
    weights = (_cubic_tube_weights if interpolation_scheme == 2
               else _hat_weights)

    def expand(origin):
        return origin[:, None] if per_ray else origin

    def sample(slab_lo, slab_hi, origins, px, py, tz):
        """Lateral-weighted sample between two slabs at per-ray (px, py, tz).

        ``origins`` = (x0_lo, y0_lo, x0_hi, y0_hi): slanted tubes cut
        each slab's window at a different place, so lo/hi weights use
        their own window origins.
        """
        x0l, y0l, x0h, y0h = origins
        wx_l = weights((px - x0l) / sx, tw)
        wy_l = weights((py - y0l) / sy, tw)
        lo = _cross_section(slab_lo, wx_l, wy_l)
        wx_h = weights((px - x0h) / sx, tw)
        wy_h = weights((py - y0h) / sy, tw)
        hi = _cross_section(slab_hi, wx_h, wy_h)
        tzc = jnp.clip(tz, 0.0, 1.0)
        return [l + tzc * (h_ - l) for l, h_ in zip(lo, hi)]

    def deriv(slab_lo, slab_hi, origins, state, z_plane, dz_off):
        """ODE right-hand side at z = z_plane + dz_off."""
        px, py, Tx, Ty, Tz = state
        tz = dz_off / dz_slab
        gx, gy, gz, nm1 = sample(slab_lo, slab_hi, origins, px, py, tz)
        n = 1.0 + nm1
        inv_Tz = 1.0 / Tz
        g = n * inv_Tz                      # ds/dz (negative: T_z < 0)
        return (Tx * inv_Tz, Ty * inv_Tz,
                g * gx, g * gy, g * gz)

    if substeps is None:
        substeps = 2 if algorithm == 3 else 1
    substeps = max(1, int(substeps))
    ab4 = algorithm == 4

    def step(carry, slabs_pair):
        if ab4:
            x, y, z, Tx, Ty, Tz, active, nstep, hist = carry
        else:
            x, y, z, Tx, Ty, Tz, active = carry
        slab_lo, slab_hi, z_plane, x0l, y0l, x0h, y0h = slabs_pair
        origins = (expand(x0l), expand(y0l), expand(x0h), expand(y0h))
        # rays march -z, landing exactly on each voxel plane; a ray steps
        # whenever it is still above the current plane (float32-safe: the
        # step length comes from the actual z, so accumulated rounding is
        # self-correcting).  All AABB-advanced rays enter at z_max, so
        # active rays step at every scan iteration after their entry.
        in_band = active & (z > z_plane)
        hstep = -(z - z_plane)              # negative z displacement

        def rhs(px, py, tx, ty, tzc, z_at):
            return deriv(slab_lo, slab_hi, origins, (px, py, tx, ty, tzc),
                         z_plane, z_at - z_plane)

        def rk4_sub(st, h_sub, z0):
            px, py, tx, ty, tzc = st
            k1 = rhs(px, py, tx, ty, tzc, z0)
            h2 = h_sub / 2.0
            k2 = rhs(px + h2 * k1[0], py + h2 * k1[1], tx + h2 * k1[2],
                     ty + h2 * k1[3], tzc + h2 * k1[4], z0 + h2)
            k3 = rhs(px + h2 * k2[0], py + h2 * k2[1], tx + h2 * k2[2],
                     ty + h2 * k2[3], tzc + h2 * k2[4], z0 + h2)
            k4 = rhs(px + h_sub * k3[0], py + h_sub * k3[1],
                     tx + h_sub * k3[2], ty + h_sub * k3[3],
                     tzc + h_sub * k3[4], z0 + h_sub)
            s6 = h_sub / 6.0
            return tuple(v + s6 * (a + 2 * b + 2 * c + dd)
                         for v, a, b, c, dd in zip(st, k1, k2, k3, k4))

        st = (x, y, Tx, Ty, Tz)
        if algorithm == 1:
            k1 = rhs(x, y, Tx, Ty, Tz, z)
            new = tuple(v + hstep * k for v, k in zip(st, k1))
        elif substeps == 1 and not ab4:
            new = rk4_sub(st, hstep, z)
        elif ab4:
            # RK4 bootstrap (first 3 committed steps of each ray), then
            # AB4 over the stored derivative history (newest last)
            rk = rk4_sub(st, hstep, z)
            f_now = rhs(x, y, Tx, Ty, Tz, z)
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
                new = rk4_sub(new, hs, z + si * hs)

        x_n, y_n, Tx_n, Ty_n, Tz_n = new
        z_n = jnp.full_like(z, 1.0) * z_plane

        sel = in_band
        x = jnp.where(sel, x_n, x)
        y = jnp.where(sel, y_n, y)
        z = jnp.where(sel, z_n, z)
        Tx = jnp.where(sel, Tx_n, Tx)
        Ty = jnp.where(sel, Ty_n, Ty)
        Tz = jnp.where(sel, Tz_n, Tz)
        if ab4:
            nstep = nstep + in_band.astype(jnp.int32)
            hist = tuple(
                tuple(jnp.where(in_band, fn, fo)
                      for fn, fo in zip(h_new, h_old))
                for h_new, h_old in zip(hist_new, hist))
            return (x, y, z, Tx, Ty, Tz, active, nstep, hist), None
        return (x, y, z, Tx, Ty, Tz, active), None

    # scan from the top slab pair down: landing plane k goes d-2 .. 0 in
    # voxel space; world z of voxel plane k is min + (k - 0.5) dz.  Rays
    # land exactly on plane k each step, so the final state sits half a
    # voxel past z_min with clamped boundary values — the same half-step
    # boundary fuzz the reference's arc-length marcher exhibits.
    ks = jnp.arange(d - 2, -1, -1, dtype=jnp.int32)
    # final landing plane clamps to z_min: the march domain is the
    # reference's [z_min, z_max], not the half-voxel-wider center grid
    # (see march_dense for the measured bias this fixes)
    z_planes = jnp.maximum(
        z_min + (ks.astype(jnp.float32) - 0.5) * dz_slab, z_min)
    # reverse-ordered slab pairs as scanned inputs (flip, not gather)
    slab_lo = jnp.flip(tubes.slabs[:-1], axis=0)   # (S, 4, TW*TW, P)
    slab_hi = jnp.flip(tubes.slabs[1:], axis=0)
    x0_lo = jnp.flip(tubes.x0[:-1], axis=0)
    y0_lo = jnp.flip(tubes.y0[:-1], axis=0)
    x0_hi = jnp.flip(tubes.x0[1:], axis=0)
    y0_hi = jnp.flip(tubes.y0[1:], axis=0)

    if ab4:
        zero5 = tuple(jnp.zeros_like(x) for _ in range(5))
        carry = (x, y, z, Tx, Ty, Tz, inside,
                 jnp.zeros_like(x, dtype=jnp.int32), (zero5, zero5, zero5))
    else:
        carry = (x, y, z, Tx, Ty, Tz, inside)
    carry, _ = jax.lax.scan(
        step, carry, (slab_lo, slab_hi, z_planes, x0_lo, y0_lo,
                      x0_hi, y0_hi))
    x, y, z, Tx, Ty, Tz = carry[:6]

    # back to unit directions
    Tn = jnp.sqrt(Tx * Tx + Ty * Ty + Tz * Tz)
    dirx_f = jnp.where(inside, Tx / Tn, dirx)
    diry_f = jnp.where(inside, Ty / Tn, diry)
    dirz_f = jnp.where(inside, Tz / Tn, dirz)
    return x, y, z, dirx_f, diry_f, dirz_f


def march_chief_deltas(vol: DensityVolume, tubes: TubeBundle,
                       xs, ys, zs, dcx, dcy, dcz,
                       algorithm: int = 2, interpolation_scheme: int = 1,
                       substeps: Optional[int] = None):
    """March one chief ray per particle; return its exit plane and the
    curvature deltas to impose on the particle's whole ray fan.

    All R rays of a source point differ by at most the lens-cone width
    (~1 um for the BOS defaults) — orders of magnitude below the voxel
    scale — so their trajectories through the volume are identical to
    float precision.  Marching P chief rays and broadcasting the
    (position, direction) deltas replaces the reference's redundant
    march of every thread through the same texels.

    Args: (P,) chief positions/directions.  Returns
    ``(z_exit, dpos_x, dpos_y, ddir_x, ddir_y, ddir_z)``, each (P,),
    where dpos is the displacement relative to the straight-line
    continuation at the exit plane.
    """
    x1, y1, z1, dx1, dy1, dz1 = march_tubes(
        vol, tubes, xs, ys, zs, dcx, dcy, dcz, algorithm=algorithm,
        interpolation_scheme=interpolation_scheme, substeps=substeps)
    t = (z1 - zs) / dcz
    dpos_x = x1 - (xs + dcx * t)
    dpos_y = y1 - (ys + dcy * t)
    return z1, dpos_x, dpos_y, dx1 - dcx, dy1 - dcy, dz1 - dcz


def chief_deltas_chunked(vol: DensityVolume, entry_x, entry_y,
                         slope_x, slope_y, xs, ys, zs, dcx, dcy, dcz,
                         algorithm: int = 2,
                         tube_width: int = TUBE_WIDTH,
                         particles_per_chunk: Optional[int] = 16384,
                         interpolation_scheme: int = 1,
                         substeps: Optional[int] = None):
    """Tube extraction + chief march over bounded particle chunks.

    The tubes for P particles occupy D * 4 * TW^2 * P floats (1.6 GB for
    the 1024^2 BOS bench scene at P=1e5; 13 GB through a 512^3 volume)
    — transient, but large enough to crowd device memory next to the
    (P, R) ray fan.  ``lax.map`` over chunks of ``particles_per_chunk``
    keeps the live tube footprint to one chunk (the analogue of the
    reference's KMAX particle batching, parallel_ray_tracing.cu:3506-3515).
    Returns the same ``(z_exit, dpos_x, dpos_y, ddir_x, ddir_y, ddir_z)``
    as :func:`march_chief_deltas`, each (P,).

    ``interpolation_scheme=2`` prefilters the whole volume to B-spline
    coefficients once (differentiable), then cuts tricubic-ready tubes.
    """
    p = xs.shape[0]
    if interpolation_scheme == 2:
        if tube_width < 6:
            tube_width = 6
        from photon_tpu.ops.march_dense import bspline_prefilter_jax
        vol = vol._replace(field=bspline_prefilter_jax(vol.field))

    def one(args):
        ex, ey, sx_, sy_, cx_, cy_, cz_, dx_, dy_, dz_ = args
        tubes = extract_tubes(vol, ex, ey, tube_width=tube_width,
                              slope_x=sx_, slope_y=sy_)
        return march_chief_deltas(vol, tubes, cx_, cy_, cz_, dx_, dy_, dz_,
                                  algorithm=algorithm,
                                  interpolation_scheme=interpolation_scheme,
                                  substeps=substeps)

    args = tuple(jnp.asarray(a) for a in
                 (entry_x, entry_y, slope_x, slope_y,
                  xs, ys, zs, dcx, dcy, dcz))
    if particles_per_chunk is None or p <= particles_per_chunk:
        return one(args)
    pc = particles_per_chunk
    n_chunks = -(-p // pc)
    pad = n_chunks * pc - p

    def prep(a):
        if pad:
            # fill 1.0: keeps every divisor nonzero; dcz > 0 marks the
            # pad rays as outside the volume, so they pass through
            a = jnp.concatenate([a, jnp.full((pad,), 1.0, a.dtype)])
        return a.reshape(n_chunks, pc)

    # remat: without it, reverse-mode through lax.map stores every
    # chunk's tube gather + march residuals at once (OOMs the fwd+bwd
    # bench at 18 GB); recomputing a chunk in backward costs one extra
    # extraction+march but caps live residuals at a single chunk
    outs = jax.lax.map(jax.checkpoint(one), tuple(prep(a) for a in args))
    return tuple(o.reshape(n_chunks * pc)[:p] for o in outs)


def march_chief_tubes(vol: DensityVolume, xs, ys, zs, dcx, dcy, dcz, *,
                      algorithm: int = 2, interpolation_scheme: int = 1,
                      substeps: Optional[int] = None,
                      particles_per_chunk: Optional[int] = 16384):
    """Tube-march twin of ops.march_dense.march_chief_dense.

    Same contract: (P,) chief rays in, their (x, y, z, dirx, diry, dirz)
    after the volume out.  The slanted tubes follow each chief's
    straight track from its entry at the volume top.
    """
    t_ent = (vol.max_bound[2] - zs) / dcz
    sx_, sy_ = dcx / dcz, dcy / dcz
    z_exit, dpx, dpy, ddx, ddy, ddz = chief_deltas_chunked(
        vol, xs + dcx * t_ent, ys + dcy * t_ent, sx_, sy_,
        xs, ys, zs, dcx, dcy, dcz, algorithm=algorithm,
        particles_per_chunk=particles_per_chunk,
        interpolation_scheme=interpolation_scheme, substeps=substeps)
    t = (z_exit - zs) / dcz
    return (xs + dcx * t + dpx, ys + dcy * t + dpy, z_exit,
            dcx + ddx, dcy + ddy, dcz + ddz)


def apply_chief_deltas(deltas, px, py, pz, dx, dy, dz):
    """Advance a (P, R) ray fan through the volume using chief deltas."""
    z_exit, dpos_x, dpos_y, ddx, ddy, ddz = deltas
    t = (z_exit[:, None] - pz) / dz
    px = px + dx * t + dpos_x[:, None]
    py = py + dy * t + dpos_y[:, None]
    pz = jnp.broadcast_to(z_exit[:, None], pz.shape)
    ox = dx + ddx[:, None]
    oy = dy + ddy[:, None]
    oz = dz + ddz[:, None]
    inv = 1.0 / jnp.sqrt(ox * ox + oy * oy + oz * oz)
    return px, py, pz, ox * inv, oy * inv, oz * inv
