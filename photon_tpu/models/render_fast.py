"""Fast forward renderer: (P, R) structure-of-arrays pipeline.

The reference dedicates one CUDA thread per ray (generation -> 3-D
texture march -> lens -> atomicAdd splat).  This renderer keeps the
*particle* structure of the problem explicit — every array is
(P particles, R rays) with the big ray axis minor — and shares work
that the reference repeats per ray:

* ray generation: broadcast arithmetic (no change in math;
  ref: parallel_ray_tracing.cu generate_lightfield_angular_data :71-237)
* density march: one chief ray per particle, marched by the dense
  sampler (ops.march_dense, slabs up to 128x128) or through voxel tubes
  (ops.march_fast, larger slabs); its deflection is applied to the fan
* lens propagation: the same Snell/thin-lens math as photon_tpu.ops.lens,
  written componentwise (SoA twin)
* sensor: one erf spot per particle at its ray centroid, or per-ray
  patches (photon_tpu.ops.sensor_fast), scatter-added into the frame

The slow-but-exact reference path (photon_tpu.models.render) remains the
semantics oracle; tests drive both and compare images.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from photon_tpu.config import SimulationConfig
from photon_tpu.models.optics import CameraSetup
from photon_tpu.models.render import RenderParams
from photon_tpu.models.scenes import LightfieldSource
from photon_tpu.ops.march_dense import (chief_deltas_dense,
                                        dense_march_supported)
from photon_tpu.ops.march_fast import (apply_chief_deltas,
                                       chief_deltas_chunked,
                                       extract_tubes, march_tubes)
from photon_tpu.ops.sensor_fast import (bilinear_patch_splat, particle_splat,
                                        patch_splat)
from photon_tpu.volume import DensityVolume


# ---------------------------------------------------------------------------
# SoA lens stages ((P, R) component arrays)
# ---------------------------------------------------------------------------


def _refract_soa(dx, dy, dz, nx_, ny_, nz_, ratio):
    """Snell refraction, componentwise (twin of ops.lens._refract)."""
    cos_i = -(dx * nx_ + dy * ny_ + dz * nz_)
    radicand = 1.0 - ratio * ratio * (1.0 - cos_i * cos_i)
    tir = radicand < 0.0
    k = ratio * cos_i - jnp.sqrt(jnp.maximum(radicand, 0.0))
    ox = dx * ratio + k * nx_
    oy = dy * ratio + k * ny_
    oz = dz * ratio + k * nz_
    inv = 1.0 / jnp.sqrt(ox * ox + oy * oy + oz * oz)
    return ox * inv, oy * inv, oz * inv, tir


def _sphere_hit_soa(cx, cy, cz, radius, dx, dy, dz, px, py, pz):
    """First sphere intersection, componentwise (twin of
    ops.lens.ray_sphere_intersection; root choice per :293-337)."""
    ox, oy, oz = px - cx, py - cy, pz - cz
    beta = 2.0 * (dx * ox + dy * oy + dz * oz)
    gamma = ox * ox + oy * oy + oz * oz - radius * radius
    disc = beta * beta - 4.0 * gamma          # alpha == 1 for unit dirs
    miss = disc < 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-beta + sq) / 2.0
    t2 = (-beta - sq) / 2.0
    lo, hi = jnp.minimum(t1, t2), jnp.maximum(t1, t2)
    t = jnp.where(radius > 0, lo, hi)
    return px + dx * t, py + dy * t, pz + dz * t, miss


def propagate_thick_lens_soa(px, py, pz, dx, dy, dz, valid, params_el):
    """Biconvex thick lens on the z axis (plane normal +z), SoA.

    Assumes the axis-aligned single-lens train produced by
    create_camera_optical_system (plane (0,0,1), center on axis at
    z_lens) — the general tilted-element path falls back to
    photon_tpu.ops.lens.  (math: parallel_ray_tracing.cu :507-864)
    """
    (z_lens, pitch, vertex, r_front, r_back, n_lens, transmission) = params_el
    half_pitch = pitch / 2.0

    # front surface
    czf = z_lens + vertex / 2.0 - r_front
    hx, hy, hz, miss = _sphere_hit_soa(0.0, 0.0, czf, r_front,
                                       dx, dy, dz, px, py, pz)
    r2 = hx * hx + hy * hy
    valid = valid & ~miss & (r2 <= half_pitch * half_pitch)
    nx_, ny_, nz_ = hx, hy, hz - czf
    inv = 1.0 / jnp.sqrt(nx_ * nx_ + ny_ * ny_ + nz_ * nz_)
    nx_, ny_, nz_ = nx_ * inv, ny_ * inv, nz_ * inv
    dx, dy, dz, tir = _refract_soa(dx, dy, dz, nx_, ny_, nz_, 1.0 / n_lens)
    valid = valid & ~tir
    px, py, pz = hx, hy, hz

    # back surface
    czb = z_lens - vertex / 2.0 - r_back
    hx, hy, hz, miss = _sphere_hit_soa(0.0, 0.0, czb, r_back,
                                       dx, dy, dz, px, py, pz)
    r2 = hx * hx + hy * hy
    valid = valid & ~miss & (r2 <= half_pitch * half_pitch)
    nx_, ny_, nz_ = -(hx), -(hy), -(hz - czb)
    inv = 1.0 / jnp.sqrt(nx_ * nx_ + ny_ * ny_ + nz_ * nz_)
    nx_, ny_, nz_ = nx_ * inv, ny_ * inv, nz_ * inv
    dx, dy, dz, tir = _refract_soa(dx, dy, dz, nx_, ny_, nz_, n_lens)
    valid = valid & ~tir
    return hx, hy, hz, dx, dy, dz, valid, transmission


def propagate_thin_lens_soa(px, py, pz, dx, dy, dz, valid,
                            z_lens, pitch, focal_length):
    """Ideal thin lens at z_lens, SoA (ref: :416-503)."""
    t = (z_lens - pz) / dz
    hx, hy = px + dx * t, py + dy * t
    r2 = hx * hx + hy * hy
    valid = valid & (r2 <= (pitch / 2.0) ** 2)
    ox = -hx / focal_length + dx
    oy = -hy / focal_length + dy
    oz = dz
    inv = 1.0 / jnp.sqrt(ox * ox + oy * oy + oz * oz)
    return hx, hy, jnp.full_like(hx, 1.0) * z_lens, \
        ox * inv, oy * inv, oz * inv, valid


# ---------------------------------------------------------------------------
# Full fast forward
# ---------------------------------------------------------------------------


def _axis_aligned(setup: CameraSetup) -> bool:
    """The fast lens path needs the untilted single-element train."""
    st = setup.elements
    return (st.num_elements == 1
            and np.allclose(st.plane_parameters[0][:3], [0, 0, 1])
            and np.allclose(st.center[0][:2], [0, 0]))



# ---------------------------------------------------------------------------
# Device-side render body (traced once per scene shape; see the jitted
# wrappers at the bottom — the whole array->image path compiles to ONE
# XLA program, so a render costs one dispatch)
# ---------------------------------------------------------------------------


def _chief_geometry(vol, xs, ys, zs, inv_rot, z_offset, image_distance):
    """Per-particle chief ray (toward the lens center), world frame.

    Its straight-line track through the volume places each slab's tube
    window (slanted tubes) — chief slopes reach ~0.1, several voxels of
    lateral drift over the volume depth, so vertical columns would miss
    at the field edges.  Returns ``entry`` (entry_x, entry_y, slope_x,
    slope_y) at the volume top and ``chief`` (pos3, dir3).
    """
    shift = jnp.float32(z_offset + 750e3)
    dden = image_distance - zs
    ctx = xs / dden
    cty = ys / dden
    cinv = 1.0 / jnp.sqrt(ctx * ctx + cty * cty + 1.0)
    cdir_cam = jnp.stack([ctx * cinv, cty * cinv, -cinv])   # (3, P)
    cpos_cam = jnp.stack([xs, ys, zs - shift])
    # positions are ~1e6 um: a TF32 product (10-bit mantissa) would move
    # them by hundreds of um
    hi = jax.lax.Precision.HIGHEST
    cdir_w = jnp.matmul(inv_rot, cdir_cam, precision=hi)
    cpos_w = jnp.matmul(inv_rot, cpos_cam, precision=hi)
    z_top = vol.max_bound[2]
    t_ent = (z_top - cpos_w[2]) / cdir_w[2]
    entry = (cpos_w[0] + cdir_w[0] * t_ent,
             cpos_w[1] + cdir_w[1] * t_ent,
             cdir_w[0] / cdir_w[2], cdir_w[1] / cdir_w[2])
    chief = (cpos_w[0], cpos_w[1], cpos_w[2],
             cdir_w[0], cdir_w[1], cdir_w[2])
    return entry, chief


def _device_render(vol, xs, ys, zs, rad, r1, r2, rot, inv_rot,
                   noise_key=None, *,
                   params: RenderParams, lens_params, rotated: bool,
                   algorithm: int, patch: int,
                   particles_per_chunk, march_particles_per_chunk,
                   chief_march: bool, per_ray_splat: bool,
                   interpolation_scheme: int = 1,
                   dense_march: bool = True, march_substeps=None):
    """arrays -> raw image; all keyword args are trace-time static."""
    P = xs.shape[0]
    R = r1.shape[0]

    # ---- density march: per-particle chief deltas, computed once ------
    # (marching P chief rays instead of P*R fan rays is exact to the
    # ~1 um lens-cone width; the deltas then chunk/shard like any other
    # per-particle array.  ``dense_march`` is chosen from the slab size:
    # the dense sampler up to 128^2 slabs, the tube march beyond.)
    deltas6 = None
    tubes = None
    if vol is not None:
        entry, chief = _chief_geometry(vol, xs, ys, zs, inv_rot,
                                       params.z_offset,
                                       params.image_distance)
        if chief_march and dense_march:
            deltas6 = chief_deltas_dense(
                vol, *chief, algorithm=algorithm,
                interpolation_scheme=interpolation_scheme,
                substeps=march_substeps)
        elif chief_march:
            deltas6 = chief_deltas_chunked(
                vol, *entry, *chief, algorithm=algorithm,
                particles_per_chunk=march_particles_per_chunk,
                interpolation_scheme=interpolation_scheme,
                substeps=march_substeps)
        else:
            # validation path (march every fan ray): needs the full tubes
            tubes = extract_tubes(vol, entry[0], entry[1],
                                  slope_x=entry[2], slope_y=entry[3])
    has_march = deltas6 is not None
    per_ray_march = vol is not None and not chief_march
    shift_f = jnp.float32(params.z_offset + 750e3)

    def to_world(px, py, pz, dx, dy, dz):
        """Camera frame -> marcher/world frame (componentwise rotation)."""
        pzs = pz - shift_f
        if not rotated:
            return px, py, pzs, dx, dy, dz
        i = inv_rot
        wx = i[0, 0] * px + i[0, 1] * py + i[0, 2] * pzs
        wy = i[1, 0] * px + i[1, 1] * py + i[1, 2] * pzs
        wz = i[2, 0] * px + i[2, 1] * py + i[2, 2] * pzs
        wdx = i[0, 0] * dx + i[0, 1] * dy + i[0, 2] * dz
        wdy = i[1, 0] * dx + i[1, 1] * dy + i[1, 2] * dz
        wdz = i[2, 0] * dx + i[2, 1] * dy + i[2, 2] * dz
        return wx, wy, wz, wdx, wdy, wdz

    def to_camera(wx, wy, wz, wdx, wdy, wdz):
        if not rotated:
            return wx, wy, wz + shift_f, wdx, wdy, wdz
        r = rot
        px = r[0, 0] * wx + r[0, 1] * wy + r[0, 2] * wz
        py = r[1, 0] * wx + r[1, 1] * wy + r[1, 2] * wz
        pz = r[2, 0] * wx + r[2, 1] * wy + r[2, 2] * wz + shift_f
        dx = r[0, 0] * wdx + r[0, 1] * wdy + r[0, 2] * wdz
        dy = r[1, 0] * wdx + r[1, 1] * wdy + r[1, 2] * wdz
        dz = r[2, 0] * wdx + r[2, 1] * wdy + r[2, 2] * wdz
        inv = 1.0 / jnp.sqrt(dx * dx + dy * dy + dz * dz)
        return px, py, pz, dx * inv, dy * inv, dz * inv

    st = lens_params

    # ---- per-chunk renderer (all (Pc, R) SoA) -------------------------
    def render_chunk(xs, ys, zs, rad, dz_exit, dpx, dpy, ddx, ddy, ddz,
                     nkey=None):
        # ray generation (ref: :104-130)
        cone = params.ray_cone_pitch_ratio * params.lens_pitch
        x_lens = cone * r1 * jnp.cos(2.0 * jnp.pi * r2)    # (R,)
        y_lens = cone * r1 * jnp.sin(2.0 * jnp.pi * r2)
        if R == 1:
            x_lens = jnp.zeros_like(x_lens)
            y_lens = jnp.zeros_like(y_lens)
        denom = params.image_distance - zs[:, None]        # (P, 1)
        tx = -(x_lens[None, :] - xs[:, None]) / denom      # (P, R)
        ty = -(y_lens[None, :] - ys[:, None]) / denom
        inv = 1.0 / jnp.sqrt(tx * tx + ty * ty + 1.0)
        dx, dy, dz = tx * inv, ty * inv, -inv
        px = jnp.broadcast_to(xs[:, None], tx.shape)
        py = jnp.broadcast_to(ys[:, None], tx.shape)
        pz = jnp.broadcast_to(zs[:, None], tx.shape)
        amp0 = jnp.broadcast_to(
            (rad / params.aperture_f_number ** 2)[:, None], tx.shape)
        valid = jnp.ones(tx.shape, dtype=bool)

        # density-gradient stage: apply the chief-ray curvature deltas in
        # the marcher frame (ref kernel :2036-2129 for the frame shifts)
        if has_march:
            wx, wy, wz, wdx, wdy, wdz = to_world(px, py, pz, dx, dy, dz)
            wx, wy, wz, wdx, wdy, wdz = apply_chief_deltas(
                (dz_exit, dpx, dpy, ddx, ddy, ddz),
                wx, wy, wz, wdx, wdy, wdz)
            px, py, pz, dx, dy, dz = to_camera(wx, wy, wz, wdx, wdy, wdz)
        elif per_ray_march:
            # validation path: march every fan ray through its tube
            # (tubes enter via closure; intended for small scenes)
            wx, wy, wz, wdx, wdy, wdz = to_world(px, py, pz, dx, dy, dz)
            wx, wy, wz, wdx, wdy, wdz = march_tubes(
                vol, tubes, wx, wy, wz, wdx, wdy, wdz, algorithm=algorithm)
            px, py, pz, dx, dy, dz = to_camera(wx, wy, wz, wdx, wdy, wdz)

        # lens model
        if params.lens_model == "apparent":
            # reverse + object-plane intersection + magnification
            # (ref: create_apparent_image :1545-1648)
            z_object = params.object_distance + params.z_offset
            rdx, rdy, rdz = -dx, -dy, -dz
            t = (z_object - pz) / rdz
            hx = px + rdx * t
            hy = py + rdy * t
            f = params.thin_lens_focal_length
            magnification = f / (z_object - params.z_offset - f)
            ix = -hx * magnification
            iy = -hy * magnification
            fdx, fdy, fdz = rdx, rdy, rdz
        else:
            if params.lens_model == "thin-lens":
                px, py, pz, dx, dy, dz, valid = propagate_thin_lens_soa(
                    px, py, pz, dx, dy, dz, valid, st[0], st[1],
                    params.thin_lens_focal_length)
            else:
                px, py, pz, dx, dy, dz, valid, trans = \
                    propagate_thick_lens_soa(px, py, pz, dx, dy, dz,
                                             valid, st)
                amp0 = amp0 * trans
            # sensor plane
            t = (params.z_sensor - pz) / dz
            ix = px + dx * t
            iy = py + dy * t
            fdx, fdy, fdz = dx, dy, dz

        # per-ray sensor position noise: N(0,1) * std * pixel_pitch on the
        # intersection point before pixel mapping (ref: :1424-1434)
        if params.add_pos_noise:
            n2 = jax.random.normal(nkey, (2,) + ix.shape, dtype=ix.dtype)
            scale = jnp.float32(params.pos_noise_std * params.pixel_pitch)
            ix = ix + n2[0] * scale
            iy = iy + n2[1] * scale

        # pixel coordinates (diffraction path mirrors x, ref: :1441-1447;
        # the bilinear path does not, ref: :1814)
        nx, ny = params.nx, params.ny
        pitch = params.pixel_pitch
        pixel_1_x = -pitch * (nx - 1) / 2.0
        pixel_1_y = -pitch * (ny - 1) / 2.0
        if params.implement_diffraction:
            d_x = (nx - 1) - (ix - pixel_1_x) / pitch
        else:
            d_x = (ix - pixel_1_x) / pitch
        d_y = (iy - pixel_1_y) / pitch
        on_sensor = (d_x >= 0) & (d_x < nx) & (d_y >= 0) & (d_y < ny)
        valid = valid & on_sensor

        X = d_x - 0.5
        Y = d_y - 0.5
        cos2 = (fdz * fdz) / (fdx * fdx + fdy * fdy + fdz * fdz)
        amp = amp0 * cos2 * cos2
        if params.implement_diffraction:
            amp = amp * (8.0 / jnp.pi)
        amp = jnp.where(valid, amp, 0.0)

        # per-particle amplitude-weighted ray centroid: doubles as the
        # patch anchor (robust to defocus, where the fixed-magnification
        # prediction would drift by several pixels)
        A = amp.sum(axis=1)                                # (P,)
        denom_a = jnp.maximum(A, 1e-30)
        Xbar = (amp * X).sum(axis=1) / denom_a
        Ybar = (amp * Y).sum(axis=1) / denom_a
        ok_p = A > 0
        pred_col = jnp.round(jnp.where(ok_p, Xbar, -1e6)).astype(jnp.int32)
        pred_row = jnp.round(jnp.where(ok_p, Ybar, -1e6)).astype(jnp.int32)

        if not params.implement_diffraction:
            # per-ray 4-pixel bilinear deposit (cannot collapse to the
            # particle centroid: a fan's summed hat != the centroid's hat)
            return bilinear_patch_splat(X, Y, amp, pred_col, pred_row,
                                        nx=nx, ny=ny, patch=patch)
        if per_ray_splat:
            return patch_splat(X, Y, amp, pred_col, pred_row,
                               nx=nx, ny=ny,
                               diameter=params.diffraction_diameter,
                               patch=patch)
        return particle_splat(Xbar, Ybar, A, pred_col, pred_row,
                              nx=nx, ny=ny,
                              diameter=params.diffraction_diameter,
                              patch=patch,
                              # the apparent-image splat renders the full
                              # circle, the sensor splat 0.75 of it
                              # (ref: :1673 vs :1490)
                              render_fraction=(
                                  1.0 if params.lens_model == "apparent"
                                  else 0.75))

    zero_p = jnp.zeros_like(xs)
    d6 = deltas6 if has_march else (zero_p,) * 6
    if params.add_pos_noise and noise_key is None:
        noise_key = jax.random.key(0)

    # ---- chunking over particles --------------------------------------
    if particles_per_chunk is None or particles_per_chunk >= P:
        return render_chunk(xs, ys, zs, rad, *d6, noise_key)

    n_chunks = math.ceil(P / particles_per_chunk)
    pc = particles_per_chunk
    pad = n_chunks * pc - P

    def padp(a, fill=0.0):
        if pad == 0:
            return a
        return jnp.concatenate([a, jnp.full((pad,) + a.shape[1:], fill,
                                            a.dtype)])

    chunked = tuple(
        [padp(xs).reshape(n_chunks, pc),
         padp(ys).reshape(n_chunks, pc),
         padp(zs, 1.0).reshape(n_chunks, pc),
         padp(rad).reshape(n_chunks, pc)]
        + [padp(a).reshape(n_chunks, pc) for a in d6])
    if params.add_pos_noise:
        chunked = chunked + (jax.random.split(noise_key, n_chunks),)

    def body(img, c):
        return img + render_chunk(*c), None
    init = jnp.zeros((params.ny, params.nx), jnp.float32)
    img, _ = jax.lax.scan(body, init, chunked)
    return img


_STATIC_NAMES = ("params", "lens_params", "rotated", "algorithm", "patch",
                 "particles_per_chunk", "march_particles_per_chunk",
                 "chief_march", "per_ray_splat",
                 "interpolation_scheme", "dense_march", "march_substeps")

_render_fast_jit = jax.jit(_device_render, static_argnames=_STATIC_NAMES)

_sharded_cache = {}
_substeps_cache = {}


def _scene_fingerprint(vol, setup, params, xs, ys, zs):
    """Hash of everything the substep probe consumes."""
    return hash((
        tuple(np.asarray(vol.sizes).tolist()),
        np.asarray(vol.min_bound).tobytes(),
        np.asarray(vol.max_bound).tobytes(),
        np.asarray(setup.inverse_rotation_matrix).tobytes(),
        float(params.z_offset), float(params.image_distance),
        xs.tobytes(), ys.tobytes(), zs.tobytes()))


def _get_sharded_render(mesh, statics: dict, reduce: bool = True):
    """One compiled sharded renderer per (mesh, static config).

    Particles shard over the mesh's first axis; the volume, the shared
    lens samples and the rotation matrices are replicated; each shard
    marches its own chief rays and renders a full image, reduced with a
    single psum.  ``reduce=False`` returns the per-shard images
    unreduced (stacked on the mesh axis) — identical compute without the
    collective, used by the scaling harness to isolate the psum's cost.
    """
    key = (mesh, tuple(sorted(statics.items())), reduce)
    fn = _sharded_cache.get(key)
    if fn is not None:
        return fn
    from jax import shard_map
    from jax.sharding import PartitionSpec as Pspec

    axis = mesh.axis_names[0]
    part = Pspec(axis)
    repl = Pspec()

    def run(vol, xs, ys, zs, rad, r1, r2, rot, inv_rot, noise_key):
        # decorrelate per-ray noise across shards
        nk = jax.random.fold_in(noise_key, jax.lax.axis_index(axis))
        img = _device_render(vol, xs, ys, zs, rad, r1, r2, rot, inv_rot,
                             nk, **statics)
        if not reduce:
            return img[None]
        return jax.lax.psum(img, axis)

    in_specs = (repl, part, part, part, part, repl, repl, repl, repl,
                repl)
    fn = jax.jit(shard_map(run, mesh=mesh, in_specs=in_specs,
                           out_specs=repl if reduce else part))
    _sharded_cache[key] = fn
    return fn


def render_image_fast(cfg: SimulationConfig, setup: CameraSetup,
                      source: LightfieldSource, r1, r2,
                      vol: Optional[DensityVolume] = None,
                      algorithm: int = 2,
                      patch: Optional[int] = None,
                      particles_per_chunk: Optional[int] = None,
                      march_particles_per_chunk: Optional[int] = 16384,
                      chief_march: bool = True,
                      per_ray_splat: bool = False,
                      scattering=None,
                      mesh=None,
                      interpolation_scheme: int = 1,
                      noise_seed: Optional[int] = None,
                      march_substeps: Optional[int] = None,
                      _mesh_reduce: bool = True,
                      ) -> jnp.ndarray:
    """Render the raw image with the (P, R) SoA pipeline.

    Supports the axis-aligned single-lens train with 'apparent',
    'thin-lens' or 'general' lens models, camera rotation, diffuse or
    Mie scattering, erf-diffraction or bilinear sensor deposits, and
    per-ray sensor position noise; other configurations fall back to
    photon_tpu.models.render.render_image.

    ``chief_march``: march one chief ray per particle and broadcast its
    deflection to the fan (exact to the ~1 um lens-cone width; set False
    to march every ray through its tube).  ``per_ray_splat``: deposit
    every ray's own erf spot instead of one spot per particle at the
    amplitude-weighted centroid (forced on by position noise).
    ``interpolation_scheme``: 1 trilinear, 2 tricubic B-spline — both
    supported at any volume size, as is the full integrator menu
    (Euler/RK4/RK45-substep with error-controlled substeps/AB4).  The
    chief march is chosen from the slab size: the dense sampler
    (ops.march_dense) up to 128x128 slabs, the voxel-tube march
    (ops.march_fast) beyond.

    Host-side work is scene prep only (Mie table lookup, static
    parameter packing); the whole array->image path runs as one jitted
    XLA program (cached across calls on the static config).
    """
    params = RenderParams.from_setup(cfg, setup, source)
    if not _axis_aligned(setup):
        raise NotImplementedError("fast path requires the axis-aligned "
                                  "single-lens train")
    dense_march = vol is not None and dense_march_supported(vol)
    per_ray_splat = per_ray_splat or params.add_pos_noise
    if patch is None:
        if params.implement_diffraction and not per_ray_splat:
            # one erf spot per particle at its ray centroid: the circular
            # render mask (radius rf * D px, ref parallel_ray_tracing.cu
            # :1514-1519) zeroes everything farther out, and the patch
            # anchor rounds the centroid to <= 0.5 px, so a side of
            # 2 * rf * D + 3 px provably contains every nonzero pixel —
            # the scatter-add is the non-march cost of the forward, and
            # it scales with K^2 (12 -> 8 at the default D = 3 px)
            rf = 1.0 if params.lens_model == "apparent" else 0.75
            patch = max(6, math.ceil(2.0 * rf * params.diffraction_diameter
                                     + 3.0))
        else:
            # per-ray deposits (bilinear or noise-displaced erf spots):
            # ray spread around the particle anchor is scene-dependent
            # (defocus, position noise), keep the conservative default
            patch = 12
    noise_key = None
    if params.add_pos_noise:
        noise_key = jax.random.key(cfg.seed if noise_seed is None
                                   else noise_seed)
    rotated = not np.allclose(setup.rotation_matrix, np.eye(3))
    rot = np.asarray(setup.rotation_matrix, np.float32)
    inv_rot = np.asarray(setup.inverse_rotation_matrix, np.float32)

    P = source.num_particles

    xs = np.asarray(source.x, np.float32)
    ys = np.asarray(source.y, np.float32)
    zs = np.asarray(source.z, np.float32)
    rad = np.asarray(source.radiance, np.float32)
    r1 = np.asarray(r1, np.float32)
    r2 = np.asarray(r2, np.float32)

    st = setup.elements
    lens_params = (float(setup.z_lens), float(st.pitch[0]),
                   float(st.vertex_distance[0]),
                   float(st.front_surface_radius[0]),
                   float(st.back_surface_radius[0]),
                   float(st.refractive_index[0]),
                   float(st.transmission_ratio[0]))

    # Mie scattering: the per-ray scattering angles within a particle's
    # 1-um lens cone are identical to ~1e-6 rad, so the irradiance lookup
    # collapses to one table interpolation per particle
    # (ref per-ray version: parallel_ray_tracing.cu:144-210)
    if scattering is not None:
        angles = np.asarray(scattering["scattering_angle"])
        table = np.asarray(scattering["scattering_irradiance"],
                           dtype=np.float32)              # (A, D)
        beam = np.asarray(scattering["beam_propogation_vector"],
                          dtype=np.float64)
        diam_idx = np.asarray(source.diameter_index, np.int32)
        dden = params.image_distance - np.asarray(source.z, np.float64)
        ctx = np.asarray(source.x, np.float64) / dden
        cty = np.asarray(source.y, np.float64) / dden
        cinv = 1.0 / np.sqrt(ctx * ctx + cty * cty + 1.0)
        # world frame == camera frame on this (zero-angle) path
        cosang = np.clip(beam[0] * ctx * cinv + beam[1] * cty * cinv
                         + beam[2] * (-cinv), -1.0, 1.0)
        ang = np.arccos(cosang)
        a = (ang - angles[0]) / (angles[1] - angles[0])
        a0 = np.clip(np.floor(a).astype(np.int32), 0, table.shape[0] - 2)
        frac = (a - a0).astype(np.float32)
        rows = table[:, :].T[diam_idx]                    # (P, A)
        irr_l = rows[np.arange(len(a0)), a0]
        irr_u = rows[np.arange(len(a0)), a0 + 1]
        mie_irr = irr_l + frac * (irr_u - irr_l)
        rad = rad * mie_irr      # fold per-particle irradiance into radiance

    def chief_host():
        """Host (numpy, f64) twin of _chief_geometry's world-frame chief
        states, for the substep control that must be static at trace
        time."""
        shift = float(params.z_offset) + 750e3
        dden = params.image_distance - zs.astype(np.float64)
        ctx = xs / dden
        cty = ys / dden
        cinv = 1.0 / np.sqrt(ctx * ctx + cty * cty + 1.0)
        dir_cam = np.stack([ctx * cinv, cty * cinv, -cinv])
        pos_cam = np.stack([xs.astype(np.float64), ys.astype(np.float64),
                            zs.astype(np.float64) - shift])
        inv_rot64 = np.asarray(setup.inverse_rotation_matrix, np.float64)
        return inv_rot64 @ pos_cam, inv_rot64 @ dir_cam

    # algorithm 3 (the reference's adaptive RK45): pick the fixed
    # substep count from the data instead of hardcoding 2 — a
    # Richardson error estimate on a 1024-chief subsample
    # (ops.march_dense.choose_substeps); static per compile, cached
    # across renders of the same scene
    if vol is not None and chief_march and algorithm == 3 \
            and march_substeps is None:
        from photon_tpu.ops.march_dense import choose_substeps
        skey = (int(interpolation_scheme),
                _scene_fingerprint(vol, setup, params, xs, ys, zs))
        march_substeps = _substeps_cache.get(skey)
        if march_substeps is None:
            pw, dw = chief_host()
            march_substeps = choose_substeps(
                vol, pw[0], pw[1], pw[2], dw[0], dw[1], dw[2],
                interpolation_scheme=int(interpolation_scheme))
            if len(_substeps_cache) > 8:
                _substeps_cache.clear()
            _substeps_cache[skey] = march_substeps

    statics = dict(params=params, lens_params=lens_params, rotated=rotated,
                   algorithm=algorithm, patch=patch,
                   particles_per_chunk=particles_per_chunk,
                   march_particles_per_chunk=march_particles_per_chunk,
                   chief_march=chief_march, per_ray_splat=per_ray_splat,
                   interpolation_scheme=int(interpolation_scheme),
                   dense_march=dense_march, march_substeps=march_substeps)

    if vol is not None:
        # array-ify the float leaves so the volume shards/jits uniformly
        vol = vol._replace(data_min=jnp.float32(vol.data_min),
                           step_size=jnp.float32(vol.step_size),
                           max_step_size=jnp.float32(vol.max_step_size))

    # ---- multi-chip: particles sharded over the mesh, image psum'd ----
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as Pspec

        from photon_tpu.parallel.shard import pad_to_multiple

        n_dev = mesh.devices.size
        axis = mesh.axis_names[0]
        mesh_padded, _ = pad_to_multiple((xs, ys, zs, rad), n_dev,
                                         fills=(0.0, 0.0, 1.0, 0.0))
        ray_shard = NamedSharding(mesh, Pspec(axis))
        sharded = [jax.device_put(a, ray_shard) for a in mesh_padded]
        fn = _get_sharded_render(mesh, statics, reduce=_mesh_reduce)
        return fn(vol, *sharded, r1, r2, rot, inv_rot,
                  noise_key if noise_key is not None else jax.random.key(0))

    return _render_fast_jit(vol, xs, ys, zs, rad, r1, r2, rot, inv_rot,
                            noise_key, **statics)
