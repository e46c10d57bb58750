"""Curved-ray (eikonal) marching through a refractive-index volume.

Replacement for the reference's density-gradient ray marcher
(C13 in SURVEY.md, ``trace_rays_through_density_gradients.h``):

* AABB entry — ref: IntersectWithVolume (:100-186), including the
  z-slab ``t1 >= 0`` quirk (:168)
* Euler integrator — ref: euler (:743-950)
* RK4 (Sharma 1982 R/T formulation) — ref: rk4 (:952-1291)
* RK45 (adaptive Fehlberg) — ref: rk45 (:304-718)
* Adams-Bashforth 4 with RK4 bootstrap — ref: adams_bashforth (:1293-1453)
* dispatch — ref: trace_rays_through_density_gradients (:1455-1544)

Execution model: the reference runs a divergent per-thread while loop with
texture fetches; here every ray in the batch advances in lock-step through
a ``lax.while_loop`` with an active mask (finished rays freeze), and each
step's field access is one batched gather (see photon_tpu.ops.interp).
For reverse-mode differentiation the same step body runs under a
fixed-trip-count ``lax.scan`` with per-step rematerialization
(``differentiable=True``), since while loops cannot be transposed.

Deliberate deviations from the reference, both documented bugs there:
* rk45 — the reference reassigns ``refractive_index = val.w`` (i.e. n-1)
  after each accepted step (:683), collapsing the step size; we keep
  n = 1 + val.w.
* adams_bashforth — the reference uses ``val.w`` (n-1) as the refractive
  index throughout (:1354 etc.); we use n = 1 + val.w.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from photon_tpu.ops.interp import (bspline_prefilter, can_access, inside_box,
                                   sample_tricubic, sample_trilinear,
                                   texture_lookup)
from photon_tpu.ops.lens import RayBundle
from photon_tpu.volume import DensityVolume


# ---------------------------------------------------------------------------
# AABB entry
# ---------------------------------------------------------------------------


def aabb_entry(pos, direction, min_bound, max_bound):
    """Advance rays starting outside the volume to its surface.

    Vectorized slab test replicating the reference's IntersectWithVolume
    (ref: :100-186), including the quirk that the z slab only advances
    ``tnear`` for non-negative ``t1``.

    Returns (new_pos, hit_mask).
    """
    big = jnp.float32(3.4e38)
    tnear = jnp.full(pos.shape[:-1], -big, dtype=pos.dtype)
    tfar = jnp.full(pos.shape[:-1], big, dtype=pos.dtype)
    miss = jnp.zeros(pos.shape[:-1], dtype=bool)

    for axis in range(3):
        t1 = (min_bound[axis] - pos[..., axis]) / direction[..., axis]
        t2 = (max_bound[axis] - pos[..., axis]) / direction[..., axis]
        lo = jnp.minimum(t1, t2)
        hi = jnp.maximum(t1, t2)
        if axis == 2:
            # z-slab quirk (ref: :168): tnear only advances if lo >= 0
            tnear = jnp.where((lo >= 0) & (lo > tnear), lo, tnear)
        else:
            tnear = jnp.maximum(tnear, lo)
        tfar = jnp.minimum(tfar, hi)
        miss = miss | (tnear > tfar) | (tfar < 0.0)

    t = jnp.where(tnear < 0.0, tfar, tnear)
    new_pos = pos + direction * t[..., None]
    return jnp.where(miss[..., None], pos, new_pos), ~miss


# ---------------------------------------------------------------------------
# Step bodies
# ---------------------------------------------------------------------------


class _MarchState(NamedTuple):
    pos: jnp.ndarray        # (N, 3)
    dir: jnp.ndarray        # (N, 3)
    val_prev: jnp.ndarray   # (N, 4) last committed field sample (w = n-1)
    refr: jnp.ndarray       # (N,) running refractive index (euler only)
    active: jnp.ndarray     # (N,) bool
    steps: jnp.ndarray      # (N,) int32 committed step count
    key: jnp.ndarray        # PRNG key for gradient noise


class _Geom(NamedTuple):
    """Static + small-array geometry closed over by the step bodies."""
    sizes: tuple            # (W, H, D) python ints
    min_bound: jnp.ndarray
    max_bound: jnp.ndarray
    data_min: float
    step_size: float
    interpolation_scheme: int
    add_ngrad_noise: bool
    ngrad_noise_std: float


def _make_sampler(geom: _Geom, field_flat):
    if geom.interpolation_scheme == 2:
        return lambda lookup: sample_tricubic(field_flat, geom.sizes, lookup)
    return lambda lookup: sample_trilinear(field_flat, geom.sizes, lookup)


def _apply_fallback(val, val_prev, refr, sample, lookup, data_min):
    """The reference's stale-sample fallback when the fetched (n-1) dips
    below the volume minimum (ref: euler :834-845 / rk4 :1056-1065):
    reuse the previous sample, or on the first step refetch one z-slab
    back and substitute the running refractive index."""
    need = val[:, 3] < data_min
    first = need & (val_prev[:, 3] == 0.0)
    shifted = sample(lookup - jnp.asarray([0.0, 0.0, 1.0], lookup.dtype))
    fb_first = jnp.concatenate([shifted[:, :3], (refr - 1.0)[:, None]],
                               axis=-1)
    out = jnp.where(first[:, None], fb_first,
                    jnp.where(need[:, None], val_prev, val))
    return out


def _euler_step(state: _MarchState, geom: _Geom, sample):
    """One iteration of the reference's Euler while-loop (ref: :772-893)."""
    pos, direction = state.pos, state.dir
    lookup = texture_lookup(pos, geom.min_bound, geom.max_bound, geom.sizes)
    inb = inside_box(pos, lookup, geom.min_bound, geom.max_bound, geom.sizes)
    exit_now = state.active & ~inb & (state.steps != 0)
    active = state.active & ~exit_now

    acc = can_access(lookup, geom.sizes)
    branch_a = active & ~acc          # advance without field access
    branch_b = active & acc

    val = sample(lookup)
    val = _apply_fallback(val, state.val_prev, state.refr, sample, lookup,
                          geom.data_min)
    cur_n = 1.0 + val[:, 3]

    grad = val[:, :3]
    key = state.key
    if geom.add_ngrad_noise:
        key, sub = jax.random.split(key)
        noise = jax.random.normal(sub, (pos.shape[0], 2), dtype=pos.dtype) \
            * geom.ngrad_noise_std
        grad = grad.at[:, 0].add(noise[:, 0]).at[:, 1].add(noise[:, 1])

    step = jnp.float32(geom.step_size)
    new_dir = direction + step * grad
    new_pos_b = pos + (step / cur_n)[:, None] * new_dir
    new_pos_a = pos + (step / (1.0 + geom.data_min)) * direction

    sel_b = branch_b[:, None]
    sel_a = branch_a[:, None]
    pos_next = jnp.where(sel_b, new_pos_b, jnp.where(sel_a, new_pos_a, pos))
    dir_next = jnp.where(sel_b, new_dir, direction)
    refr_next = jnp.where(branch_b, cur_n, state.refr)
    val_prev_next = jnp.where(sel_b, val, state.val_prev)
    steps_next = state.steps + branch_b.astype(jnp.int32)
    return _MarchState(pos_next, dir_next, val_prev_next, refr_next,
                       active, steps_next, key)


def _rk4_step(state: _MarchState, geom: _Geom, sample):
    """One iteration of the reference's RK4 while-loop (ref: :997-1180).

    Sharma's R/T formulation: R = position, T = n * dir; three field
    fetches per step with boundary checks that freeze the ray mid-step
    without committing.
    """
    pos, direction = state.pos, state.dir
    step = jnp.float32(geom.step_size)

    lookup1 = texture_lookup(pos, geom.min_bound, geom.max_bound, geom.sizes)
    inb1 = inside_box(pos, lookup1, geom.min_bound, geom.max_bound,
                      geom.sizes)
    exit_now = state.active & ~inb1 & (state.steps != 0)
    active = state.active & ~exit_now

    acc = can_access(lookup1, geom.sizes)
    branch_a = active & ~acc
    branch_b = active & acc

    val1 = sample(lookup1)
    val1 = _apply_fallback(val1, state.val_prev, state.refr, sample, lookup1,
                           geom.data_min)
    n1 = 1.0 + val1[:, 3]

    grad1 = val1[:, :3]
    key = state.key
    if geom.add_ngrad_noise:
        key, sub = jax.random.split(key)
        noise = jax.random.normal(sub, (pos.shape[0], 2), dtype=pos.dtype) \
            * geom.ngrad_noise_std
        grad1 = grad1.at[:, 0].add(noise[:, 0]).at[:, 1].add(noise[:, 1])

    R = pos
    delta = (step / n1)[:, None]
    T = n1[:, None] * direction
    D1 = n1[:, None] * grad1
    A = delta * D1

    pos2 = R + delta / 2.0 * T + delta * A / 8.0
    lookup2 = texture_lookup(pos2, geom.min_bound, geom.max_bound, geom.sizes)
    inb2 = inside_box(pos2, lookup2, geom.min_bound, geom.max_bound,
                      geom.sizes)
    die2 = branch_b & ~inb2

    val_prev2 = val1
    val2 = sample(lookup2)
    val2 = _apply_fallback(val2, val_prev2, state.refr, sample, lookup2,
                           geom.data_min)
    n2 = 1.0 + val2[:, 3]
    D2 = n2[:, None] * val2[:, :3]
    B = delta * D2

    pos3 = R + delta * T + delta * B / 2.0
    lookup3 = texture_lookup(pos3, geom.min_bound, geom.max_bound, geom.sizes)
    inb3 = inside_box(pos3, lookup3, geom.min_bound, geom.max_bound,
                      geom.sizes)
    die3 = branch_b & inb2 & ~inb3

    val3 = sample(lookup3)
    val3 = _apply_fallback(val3, val2, state.refr, sample, lookup3,
                           geom.data_min)
    n3 = 1.0 + val3[:, 3]
    D3 = n3[:, None] * val3[:, :3]
    C = delta * D3

    R_new = R + delta * (T + (A + 2.0 * B) / 6.0)
    T_new = T + (A + 4.0 * B + C) / 6.0
    dir_new = T_new / n1[:, None]
    dir_new = dir_new / jnp.linalg.norm(dir_new, axis=-1, keepdims=True)

    commit = branch_b & inb2 & inb3
    new_pos_a = pos + (step / (1.0 + geom.data_min)) * direction

    pos_next = jnp.where(commit[:, None], R_new,
                         jnp.where(branch_a[:, None], new_pos_a, pos))
    dir_next = jnp.where(commit[:, None], dir_new, direction)
    val_prev_next = jnp.where(commit[:, None], val3, state.val_prev)
    steps_next = state.steps + commit.astype(jnp.int32)
    active_next = active & ~die2 & ~die3
    return _MarchState(pos_next, dir_next, val_prev_next, state.refr,
                       active_next, steps_next, key)


def _ab4_step(carry, geom: _Geom, sample):
    """One Adams-Bashforth-4 main-loop iteration (physically corrected;
    see module docstring).  carry = (state, T_hist, D_hist) where the
    histories are (3, N, 3) newest-last."""
    state, T_hist, D_hist, T_n = carry
    pos, direction = state.pos, state.dir
    step = jnp.float32(geom.step_size)

    lookup = texture_lookup(pos, geom.min_bound, geom.max_bound, geom.sizes)
    inb = inside_box(pos, lookup, geom.min_bound, geom.max_bound, geom.sizes)
    exit_now = state.active & ~inb & (state.steps != 0)
    active = state.active & ~exit_now

    acc = can_access(lookup, geom.sizes)
    branch_a = active & ~acc
    branch_b = active & acc

    val = sample(lookup)
    n = 1.0 + val[:, 3]
    delta = (step / n)[:, None]
    D = n[:, None] * val[:, :3]

    R_new = pos + delta / 24.0 * (55.0 * T_n - 59.0 * T_hist[2]
                                  + 37.0 * T_hist[1] - 9.0 * T_hist[0])
    T_new = T_n + delta / 24.0 * (55.0 * D - 59.0 * D_hist[2]
                                  + 37.0 * D_hist[1] - 9.0 * D_hist[0])
    dir_new = T_new / n[:, None]
    dir_new = dir_new / jnp.linalg.norm(dir_new, axis=-1, keepdims=True)

    new_pos_a = pos + (step / (1.0 + geom.data_min)) * direction
    sel_b = branch_b[:, None]
    pos_next = jnp.where(sel_b, R_new,
                         jnp.where(branch_a[:, None], new_pos_a, pos))
    dir_next = jnp.where(sel_b, dir_new, direction)

    T_hist_next = jnp.where(sel_b[None], jnp.stack(
        [T_hist[1], T_hist[2], T_n]), T_hist)
    D_hist_next = jnp.where(sel_b[None], jnp.stack(
        [D_hist[1], D_hist[2], D]), D_hist)
    T_next = jnp.where(sel_b, T_new, T_n)
    steps_next = state.steps + branch_b.astype(jnp.int32)
    new_state = _MarchState(pos_next, dir_next, state.val_prev, state.refr,
                            active, steps_next, state.key)
    return (new_state, T_hist_next, D_hist_next, T_next)


class _Recorder:
    """Bounded per-step trajectory recording for the march loops.

    Buffers are (S, n_rec, 3), written at the top of each loop iteration
    for iterations < S; frozen rays record NaN (the reference's prefill
    convention).  ``finalize`` returns the reference's ray-major layout
    (n_rec, S, 3) matching the intermediate_pos/dir dump ordering
    ``thread_id * num_save + loop_ctr``
    (ref: trace_rays_through_density_gradients.h:787-789).
    """

    def __init__(self, steps: int, rays: int):
        self.steps = steps
        self.rays = rays

    def init(self):
        nan = jnp.full((self.steps, self.rays, 3), jnp.nan, jnp.float32)
        return (nan, nan)

    def record(self, rec, it, pos, direction, active):
        bufp, bufd = rec
        idx = jnp.minimum(it, self.steps - 1)
        ok = it < self.steps
        act = active[: self.rays, None]
        p = jnp.where(act, pos[: self.rays], jnp.nan)
        d = jnp.where(act, direction[: self.rays], jnp.nan)
        bufp = bufp.at[idx].set(jnp.where(ok, p, bufp[idx]))
        bufd = bufd.at[idx].set(jnp.where(ok, d, bufd[idx]))
        return bufp, bufd

    def finalize(self, rec):
        bufp, bufd = rec
        return (jnp.transpose(bufp, (1, 0, 2)),
                jnp.transpose(bufd, (1, 0, 2)))


# ---------------------------------------------------------------------------
# RK45 (adaptive Fehlberg)
# ---------------------------------------------------------------------------


def _rk45_march(rays_pos, rays_dir, geom: _Geom, sample, max_iters: int,
                recorder: Optional[_Recorder] = None,
                differentiable: bool = False,
                num_steps: Optional[int] = None):
    """Vectorized adaptive RK45 (ref: :304-718, with the refractive-index
    bug corrected — see module docstring).

    Per-ray adaptive step h; a stage leaving the volume retries with
    h/10 until h < 0.1 * base step, then the ray freezes.

    ``differentiable=True`` replaces the while_loop with a fixed
    ``num_steps``-trip rematerialized ``lax.scan`` of the SAME body
    (per-step accept/reject masks carry the adaptivity), enabling
    reverse-mode AD through the adaptive integrator — "adaptive" and
    "differentiable" are no longer mutually exclusive.  Finished rays
    idle under their masks; ``num_steps`` must cover the scene's
    iteration demand (the default matches the while_loop's cap).
    """
    tol = jnp.float32(1e-3)
    n0 = jnp.float32(1.000277)
    step = jnp.float32(geom.step_size)

    N = rays_pos.shape[0]
    h0 = jnp.full((N,), geom.step_size / 1.000277, dtype=rays_pos.dtype)
    refr0 = jnp.full((N,), n0, dtype=rays_pos.dtype)

    def fetch(p):
        lookup = texture_lookup(p, geom.min_bound, geom.max_bound, geom.sizes)
        inb = inside_box(p, lookup, geom.min_bound, geom.max_bound,
                         geom.sizes)
        val = sample(lookup)
        return val, inb

    ck = [None, 1.0 / 4.0, 3.0 / 8.0, 12.0 / 13.0, 1.0, 0.5]
    a = {
        2: (1.0 / 4.0,),
        3: (3.0 / 32.0, 9.0 / 32.0),
        4: (1932.0 / 2197.0, -7200.0 / 2197.0, 7296.0 / 2197.0),
        5: (439.0 / 216.0, -8.0, 3680.0 / 513.0, -845.0 / 4104.0),
        6: (-8.0 / 27.0, 2.0, -3544.0 / 2565.0, 1859.0 / 4104.0, -11.0 / 40.0),
    }
    del ck

    def body(carry):
        pos, direction, h, refr, active, it, rec = carry
        if recorder is not None:
            rec = recorder.record(rec, it, pos, direction, active)
        R0 = pos
        T0 = refr[:, None] * direction

        ks, ls = [], []
        stage_ok = active
        coeffs = [(), a[2], a[3], a[4], a[5], a[6]]
        for s in range(6):
            dR = sum(c * k for c, k in zip(coeffs[s], ks)) if s else 0.0
            dT = sum(c * l for c, l in zip(coeffs[s], ls)) if s else 0.0
            Rs = R0 + dR
            Ts = T0 + dT
            k_s = h[:, None] * Ts
            val, inb = fetch(Rs)
            stage_ok = stage_ok & inb
            n_s = 1.0 + val[:, 3]
            l_s = h[:, None] * (n_s[:, None] * val[:, :3])
            ks.append(k_s)
            ls.append(l_s)

        y4 = R0 + (25/216)*ks[0] + (1408/2565)*ks[2] + (2197/4104)*ks[3] \
            - (1/5)*ks[4]
        y5 = R0 + (16/135)*ks[0] + (6656/12825)*ks[2] + (28561/56430)*ks[3] \
            - (9/50)*ks[4] + (2/55)*ks[5]
        z4 = T0 + (25/216)*ls[0] + (1408/2565)*ls[2] + (2197/4104)*ls[3] \
            - (1/5)*ls[4]
        z5 = T0 + (16/135)*ls[0] + (6656/12825)*ls[2] + (28561/56430)*ls[3] \
            - (9/50)*ls[4] + (2/55)*ls[5]

        Rmax = jnp.maximum(
            jnp.max(jnp.abs(y4 - y5), axis=-1),
            jnp.max(jnp.abs(z4 - z5), axis=-1)) / h
        # the fractional power and the step-size chain are control
        # quantities: detach them so reverse-mode AD neither pays their
        # O(x^-0.75) curvature nor propagates h-adaptation cotangents
        # (the adaptive schedule is treated as data-independent at the
        # linearization point — standard for differentiable adaptive
        # integrators)
        s_fac = 0.84 * (tol / jax.lax.stop_gradient(
            jnp.maximum(Rmax, 1e-30))) ** 0.25

        # a stage left the volume: retry with h/10 (freeze if h too small)
        retry = active & ~stage_ok
        h_retry = h / 10.0
        freeze_retry = retry & (h_retry < 0.1 * step)

        accept = active & stage_ok & (Rmax <= tol)
        reject = active & stage_ok & ~accept

        new_pos = jnp.where(accept[:, None], y4, pos)
        new_dir_raw = z4 / refr[:, None]
        nrm = jnp.sqrt(jnp.maximum(
            jnp.sum(new_dir_raw * new_dir_raw, axis=-1, keepdims=True),
            1e-30))
        new_dir = new_dir_raw / nrm
        new_dir = jnp.where(accept[:, None], new_dir, direction)

        # refresh n at the accepted position; freeze rays that exit
        val_new, inb_new = fetch(new_pos)
        exited = accept & ~inb_new
        new_refr = jnp.where(accept & inb_new, 1.0 + val_new[:, 3], refr)

        s_acc = jnp.minimum(s_fac, 5.0)
        s_rej = jnp.maximum(s_fac, 0.1)
        new_h = jax.lax.stop_gradient(
            jnp.where(accept, h * s_acc,
                      jnp.where(reject, h * s_rej,
                                jnp.where(retry, h_retry, h))))
        new_active = active & ~freeze_retry & ~exited
        return (new_pos, new_dir, new_h, new_refr, new_active, it + 1, rec)

    def cond(carry):
        _, _, _, _, active, it, _ = carry
        return jnp.any(active) & (it < max_iters)

    init = (rays_pos, rays_dir, h0, refr0,
            jnp.ones((N,), dtype=bool), jnp.int32(0),
            recorder.init() if recorder is not None else ())
    if differentiable:
        if recorder is not None:
            raise ValueError("intermediate recording is not supported on "
                             "the differentiable RK45 scan path")
        if num_steps is None:
            num_steps = max_iters
        ckpt_body = jax.checkpoint(lambda c, _: (body(c), None))
        carry, _ = jax.lax.scan(ckpt_body, init, None,
                                length=int(num_steps))
        pos, direction = carry[0], carry[1]
        return pos, direction, None
    pos, direction, _, _, _, _, rec = jax.lax.while_loop(cond, body, init)
    return pos, direction, (recorder.finalize(rec)
                            if recorder is not None else None)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def march_rays(vol: DensityVolume, rays: RayBundle, *,
               algorithm: int = 2, interpolation_scheme: int = 1,
               add_ngrad_noise: bool = False, ngrad_noise_std: float = 0.0,
               seed: int = 0, max_iters: Optional[int] = None,
               differentiable: bool = False,
               num_steps: Optional[int] = None,
               field_flat=None,
               record_steps: Optional[int] = None,
               record_rays: int = 100):
    """March a ray bundle through the refractive-index volume.

    Rays outside the volume are first advanced to its surface
    (ref: trace_rays_through_density_gradients:1476-1506); rays that miss
    entirely pass through unchanged.  ``field_flat`` overrides the volume's
    packed field (a (D*H*W, 4) array) so gradients can flow to the density
    field in inverse problems.

    ``differentiable=True`` switches the Euler/RK4 loop — and the
    adaptive RK45 (algorithm 3) — to a fixed ``num_steps``-trip
    ``lax.scan`` with per-step rematerialization, enabling reverse-mode
    AD at O(sqrt-ish) memory; default num_steps is the volume diagonal
    over the step size plus margin (3x for RK45: accepts plus
    rejects/retries).

    ``record_steps``: record the first ``record_steps`` march positions
    and directions of the first ``record_rays`` rays — the reference's
    intermediate ray-data dump (each thread records the top of its first
    num_intermediate_positions_save loop iterations,
    ref: trace_rays_through_density_gradients.h:784-790).  Returns
    ``(bundle, (inter_pos, inter_dir))`` with (n_rec, S, 3) arrays;
    entries for frozen/finished rays are NaN (matching the reference's
    NaN prefill, parallel_ray_tracing.cu:3541).  Not supported together
    with ``differentiable=True``.
    """
    w, h, d = vol.sizes
    geom = _Geom(sizes=(w, h, d), min_bound=vol.min_bound,
                 max_bound=vol.max_bound, data_min=float(vol.data_min),
                 step_size=float(vol.step_size),
                 interpolation_scheme=int(interpolation_scheme),
                 add_ngrad_noise=bool(add_ngrad_noise),
                 ngrad_noise_std=float(ngrad_noise_std))

    if field_flat is None:
        field = vol.field
        if interpolation_scheme == 2:
            field = jnp.asarray(bspline_prefilter(np.asarray(field)))
        field_flat = field.reshape(-1, 4)
    sample = _make_sampler(geom, field_flat)

    pos0, dir0 = rays.pos, rays.dir
    # entry: advance outside-the-box rays to the surface
    outside = jnp.any((pos0 <= vol.min_bound) | (pos0 >= vol.max_bound),
                      axis=-1)
    entered, hit = aabb_entry(pos0, dir0, vol.min_bound, vol.max_bound)
    pos0 = jnp.where(outside[:, None], entered, pos0)
    skip = outside & ~hit     # missed the volume entirely: pass through

    diag = float(np.linalg.norm(np.asarray(vol.max_bound)
                                - np.asarray(vol.min_bound)))
    if max_iters is None:
        max_iters = int(min(4.0 * diag / vol.step_size + 64, 100000))

    recorder = None
    if record_steps is not None:
        if differentiable:
            raise ValueError("intermediate recording is not supported on "
                             "the differentiable scan path")
        recorder = _Recorder(int(record_steps),
                             min(int(record_rays), pos0.shape[0]))

    if algorithm == 3:
        # the adaptive marcher has no first-step boundary grace (each
        # stage checks inside_box, which is exclusive at max_bound), so
        # a ray snapped exactly onto the entry face would retry h/10
        # until frozen.  The reference escapes this only through float
        # rounding of its entry advance (IntersectWithVolume); we nudge
        # advanced entries strictly inside by 1e-6 of the extent
        # (sub-micron for metric scenes).
        eps_b = 1e-6 * (vol.max_bound - vol.min_bound)
        pos0 = jnp.where(
            (outside & hit)[:, None],
            jnp.clip(pos0, vol.min_bound + eps_b, vol.max_bound - eps_b),
            pos0)
        if differentiable and num_steps is None:
            num_steps = int(min(3.0 * diag / vol.step_size + 64, 8192))
        pos_f, dir_f, rec = _rk45_march(pos0, dir0, geom, sample, max_iters,
                                        recorder=recorder,
                                        differentiable=differentiable,
                                        num_steps=num_steps)
        pos_f = jnp.where(skip[:, None], rays.pos, pos_f)
        dir_f = jnp.where(skip[:, None], rays.dir, dir_f)
        bundle = RayBundle(pos_f, dir_f, rays.wavelength, rays.radiance)
        return (bundle, rec) if recorder is not None else bundle

    key = jax.random.key(seed)
    # derive every carry array from the (possibly sharded) ray inputs so
    # the loop carry has consistent device-varying types under shard_map
    zeros_like_ray = jnp.zeros_like(pos0[:, 0])
    state0 = _MarchState(
        pos=pos0, dir=dir0,
        val_prev=jnp.zeros_like(pos0[:, :1]) * jnp.ones((1, 4), pos0.dtype),
        refr=zeros_like_ray + 1.000277,
        active=~skip,
        steps=zeros_like_ray.astype(jnp.int32), key=key)

    if algorithm == 1:
        step_fn = partial(_euler_step, geom=geom, sample=sample)
    elif algorithm == 2:
        step_fn = partial(_rk4_step, geom=geom, sample=sample)
    elif algorithm == 4:
        return _ab4_full(state0, geom, sample, rays, skip, max_iters,
                         recorder=recorder)
    else:
        raise ValueError(f"unknown ray_tracing_algorithm {algorithm}")

    if differentiable:
        if num_steps is None:
            num_steps = int(min(2.0 * diag / vol.step_size + 16, 8192))
        ckpt_step = jax.checkpoint(lambda s, _: (step_fn(s), None))
        state_f, _ = jax.lax.scan(ckpt_step, state0, None, length=num_steps)
        rec_f = None
    elif recorder is not None:
        def cond(carry):
            state, it, _ = carry
            return jnp.any(state.active) & (it < max_iters)

        def body(carry):
            state, it, rec = carry
            rec = recorder.record(rec, it, state.pos, state.dir,
                                  state.active)
            return step_fn(state), it + 1, rec

        state_f, _, rec_f = jax.lax.while_loop(
            cond, body, (state0, jnp.int32(0), recorder.init()))
    else:
        def cond(carry):
            state, it = carry
            return jnp.any(state.active) & (it < max_iters)

        def body(carry):
            state, it = carry
            return step_fn(state), it + 1

        state_f, _ = jax.lax.while_loop(cond, body, (state0, jnp.int32(0)))
        rec_f = None

    pos_f = jnp.where(skip[:, None], rays.pos, state_f.pos)
    dir_f = jnp.where(skip[:, None], rays.dir, state_f.dir)
    bundle = RayBundle(pos_f, dir_f, rays.wavelength, rays.radiance)
    if recorder is not None:
        return bundle, recorder.finalize(rec_f)
    return bundle


def _ab4_full(state0: _MarchState, geom: _Geom, sample, rays, skip,
              max_iters: int, recorder: Optional[_Recorder] = None):
    """RK4 bootstrap (3 steps) + AB4 main loop (ref: :1293-1453)."""
    # bootstrap with three RK4 steps, recording T and D histories
    state = state0
    rec = recorder.init() if recorder is not None else ()
    T_hist = jnp.zeros((3,) + state.pos.shape, dtype=state.pos.dtype)
    D_hist = jnp.zeros((3,) + state.pos.shape, dtype=state.pos.dtype)
    for i in range(3):
        lookup = texture_lookup(state.pos, geom.min_bound, geom.max_bound,
                                geom.sizes)
        val = sample(lookup)
        n = 1.0 + val[:, 3]
        T_hist = T_hist.at[i].set(n[:, None] * state.dir)
        D_hist = D_hist.at[i].set(n[:, None] * val[:, :3])
        if recorder is not None:
            rec = recorder.record(rec, jnp.int32(i), state.pos, state.dir,
                                  state.active)
        state = _rk4_step(state, geom, sample)
    lookup = texture_lookup(state.pos, geom.min_bound, geom.max_bound,
                            geom.sizes)
    val = sample(lookup)
    T_n = (1.0 + val[:, 3])[:, None] * state.dir

    def cond(carry):
        (state, *_), it = carry[0], carry[1]
        return jnp.any(state.active) & (it < max_iters)

    def body(carry):
        inner, it, rec = carry
        if recorder is not None:
            rec = recorder.record(rec, it + 3, inner[0].pos, inner[0].dir,
                                  inner[0].active)
        return _ab4_step(inner, geom, sample), it + 1, rec

    (state_f, *_), _, rec = jax.lax.while_loop(
        cond, body, ((state, T_hist, D_hist, T_n), jnp.int32(0), rec))

    pos_f = jnp.where(skip[:, None], rays.pos, state_f.pos)
    dir_f = jnp.where(skip[:, None], rays.dir, state_f.dir)
    bundle = RayBundle(pos_f, dir_f, rays.wavelength, rays.radiance)
    if recorder is not None:
        return bundle, recorder.finalize(rec)
    return bundle


def make_march_fn(vol: DensityVolume, *, algorithm: int = 2,
                  interpolation_scheme: int = 1,
                  add_ngrad_noise: bool = False,
                  ngrad_noise_std: float = 0.0, seed: int = 0,
                  differentiable: bool = False,
                  num_steps: Optional[int] = None):
    """Bind a volume into a rays->rays marching stage for the renderer."""
    field = vol.field
    if interpolation_scheme == 2:
        field = jnp.asarray(bspline_prefilter(np.asarray(field)))
    field_flat = field.reshape(-1, 4)

    def march(rays: RayBundle, field_override=None) -> RayBundle:
        return march_rays(
            vol, rays, algorithm=algorithm,
            interpolation_scheme=interpolation_scheme,
            add_ngrad_noise=add_ngrad_noise,
            ngrad_noise_std=ngrad_noise_std, seed=seed,
            differentiable=differentiable, num_steps=num_steps,
            field_flat=(field_override if field_override is not None
                        else field_flat))

    return march
