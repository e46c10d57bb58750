"""Tests for the speed-of-light (P, R) SoA pipeline against the exact
reference-semantics renderer and the analytic BOS oracle."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.test_bos_pipeline import bos_case, gradient_volume_between
from photon_tpu.models.optics import camera_setup
from photon_tpu.models.render import render_image
from photon_tpu.models.render_fast import render_image_fast
from photon_tpu.models.scenes import bos_source
from photon_tpu.ops.march import make_march_fn, march_rays
from photon_tpu.ops.march_fast import extract_tubes, march_tubes
from photon_tpu.ops.lens import RayBundle
from photon_tpu.utils.rng import lens_samples


def _scene(lens_model="general", rays=32):
    cfg = bos_case(lens_model, n_dots=6, rays=rays)
    setup = camera_setup(cfg)
    src, dot_x, dot_y = bos_source(cfg, setup, np.random.default_rng(11))
    r1, r2 = lens_samples(jax.random.key(5), rays)
    return cfg, setup, src, dot_x, dot_y, r1, r2


@pytest.mark.parametrize("lens_model", ["apparent", "thin-lens", "general"])
def test_fast_matches_reference_no_gradients(lens_model):
    cfg, setup, src, *_ , r1, r2 = _scene(lens_model)
    img_ref = np.asarray(render_image(cfg, setup, src, r1, r2))
    img_fast = np.asarray(render_image_fast(cfg, setup, src, r1, r2))
    assert img_ref.sum() > 0
    # round 3: the fast splat applies the reference's circular render
    # mask, so the paths now agree to ~1e-4 L1; 1e-3 catches regressions
    l1 = np.abs(img_ref - img_fast).sum() / img_ref.sum()
    assert l1 < 1e-3, l1
    # peak positions coincide
    assert np.unravel_index(img_ref.argmax(), img_ref.shape) \
        == np.unravel_index(img_fast.argmax(), img_fast.shape)


@pytest.mark.parametrize("lens_model", ["apparent", "thin-lens", "general"])
def test_fast_matches_reference_with_gradients(lens_model):
    cfg, setup, src, *_ , r1, r2 = _scene(lens_model)
    vol, eps, Z_D = gradient_volume_between(setup)
    march_fn = make_march_fn(vol, algorithm=2)
    img_ref = np.asarray(render_image(cfg, setup, src, r1, r2,
                                      march_fn=march_fn))
    img_fast = np.asarray(render_image_fast(cfg, setup, src, r1, r2,
                                            vol=vol))
    l1 = np.abs(img_ref - img_fast).sum() / img_ref.sum()
    # round 3 (was 10%): z-domain clamp + circular mask -> ~0.13%
    assert l1 < 0.01, l1


def test_fast_bos_displacement_oracle():
    cfg, setup, src, dot_x, dot_y, r1, r2 = _scene("general")
    vol, eps, Z_D = gradient_volume_between(setup)
    img0 = np.asarray(render_image_fast(cfg, setup, src, r1, r2))
    img1 = np.asarray(render_image_fast(cfg, setup, src, r1, r2, vol=vol))
    m = setup.magnification
    pitch = cfg.camera_design.pixel_pitch
    nx = cfg.camera_design.x_pixel_number

    def centroid_x(im, cx, cy, rad=8):
        r0, c0 = int(round(cy)), int(round(cx))
        sl = im[max(r0 - rad, 0): r0 + rad, max(c0 - rad, 0): c0 + rad]
        xs = np.arange(sl.shape[1])
        return (sl * xs[None, :]).sum() / sl.sum()

    expected = m * Z_D * eps / pitch
    shifts = []
    for dx_, dy_ in zip(dot_x, dot_y):
        pc = (nx - 1) - ((-dx_ * m) + pitch * (nx - 1) / 2) / pitch
        pr = ((-dy_ * m) + pitch * (nx - 1) / 2) / pitch
        shifts.append(centroid_x(img1, pc, pr) - centroid_x(img0, pc, pr))
    shifts = np.asarray(shifts)
    # mirrored x: +x deflection shows as -column shift
    np.testing.assert_allclose(-shifts, expected, rtol=0.08)


def test_tube_march_matches_reference_march():
    cfg, setup, *_ = _scene()
    vol, eps, Z_D = gradient_volume_between(setup)
    P, R = 5, 3
    xs = np.linspace(-4e4, 4e4, P).astype(np.float32)
    x = jnp.asarray(np.repeat(xs[:, None], R, 1))
    y = jnp.zeros((P, R), jnp.float32)
    z = jnp.full((P, R), -50000.0, jnp.float32)
    zero = jnp.zeros((P, R), jnp.float32)
    dirz = jnp.full((P, R), -1.0, jnp.float32)
    tubes = extract_tubes(vol, jnp.asarray(xs), np.zeros(P, np.float32))
    xo, yo, zo, dxo, dyo, dzo = march_tubes(vol, tubes, x, y, z,
                                            zero, zero, dirz, algorithm=2)

    rays = RayBundle(
        jnp.stack([x.ravel(), y.ravel(), z.ravel()], -1),
        jnp.stack([zero.ravel(), zero.ravel(), dirz.ravel()], -1),
        jnp.zeros(P * R), jnp.ones(P * R))
    ref = march_rays(vol, rays, algorithm=2)
    ref_dx = np.asarray(ref.dir)[::R, 0]
    np.testing.assert_allclose(np.asarray(dxo)[:, 0], ref_dx, rtol=0.03)


def test_fast_renders_are_deterministic():
    cfg, setup, src, *_ , r1, r2 = _scene("apparent", rays=16)
    a = np.asarray(render_image_fast(cfg, setup, src, r1, r2))
    b = np.asarray(render_image_fast(cfg, setup, src, r1, r2))
    np.testing.assert_array_equal(a, b)


def test_slanted_tubes_track_offaxis_chiefs():
    """Off-axis chief rays drift several voxels laterally; the slanted
    tube windows must follow them.  Uses an x-dependent gradient
    (rho ~ x^2, so dn/dx varies linearly in x) that a stale vertical
    window would sample at the wrong place."""
    import jax.numpy as jnp
    from photon_tpu.volume import build_density_volume
    from photon_tpu.ops.march import march_rays

    cfg = bos_case("general")
    setup = camera_setup(cfg)
    n, extent = 24, 4e5
    x = np.linspace(-extent / 2, extent / 2, n)
    z_dots = setup.object_distance
    z = np.linspace(z_dots - 0.8 * z_dots, z_dots - 0.1 * z_dots, n)
    X = x[:, None, None] * np.ones((1, n, n))
    rho = 1.225 + 6.0 * (X / (extent / 2)) ** 2    # dn/dx linear in x
    vol = build_density_volume(
        rho, [x[1] - x[0], x[1] - x[0], z[1] - z[0]], [x[0], x[0], z[0]])

    # dots far off-axis: chief slope ~ x / (image_distance - z) ~ 0.1
    P = 6
    xs = np.linspace(-9e4, 9e4, P).astype(np.float32)
    src_z = np.full(P, setup.z_object, np.float32)
    from photon_tpu.models.scenes import LightfieldSource
    src = LightfieldSource(
        x=xs, y=np.zeros(P, np.float32), z=src_z,
        radiance=np.ones(P), diameter_index=np.zeros(P, np.int32),
        z_offset=float(setup.z_offset),
        object_distance=float(setup.object_distance),
        lightray_number_per_particle=4)

    # exact reference march on the actual chief rays
    shift = setup.z_offset + 750e3
    dden = float(setup.image_distance) - src_z.astype(np.float64)
    ctx = xs / dden
    cinv = 1.0 / np.sqrt(ctx * ctx + 1.0)
    pos = np.stack([xs, np.zeros(P), src_z - shift], -1).astype(np.float32)
    dirs = np.stack([ctx * cinv, np.zeros(P), -cinv], -1).astype(np.float32)
    from photon_tpu.ops.lens import RayBundle
    ref = march_rays(vol, RayBundle(jnp.asarray(pos), jnp.asarray(dirs),
                                    jnp.zeros(P), jnp.ones(P)), algorithm=2)
    ref_eps = np.asarray(ref.dir)[:, 0] / np.asarray(ref.dir)[:, 2] \
        - dirs[:, 0] / dirs[:, 2]

    # fast chief march through slanted tubes (as the renderer builds them)
    from photon_tpu.ops.march_fast import (extract_tubes,
                                           march_chief_deltas)
    z_top = float(vol.max_bound[2])
    t_ent = (z_top - pos[:, 2]) / dirs[:, 2]
    entry_x = pos[:, 0] + dirs[:, 0] * t_ent
    slope_x = dirs[:, 0] / dirs[:, 2]
    tubes = extract_tubes(vol, jnp.asarray(entry_x),
                          jnp.zeros(P, jnp.float32),
                          slope_x=jnp.asarray(slope_x),
                          slope_y=jnp.zeros(P, jnp.float32))
    deltas = march_chief_deltas(
        vol, tubes, jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1]),
        jnp.asarray(pos[:, 2]), jnp.asarray(dirs[:, 0]),
        jnp.asarray(dirs[:, 1]), jnp.asarray(dirs[:, 2]), algorithm=2)
    # d(dx/dz) ~ ddir_x / dir_z (dir_z < 0)
    fast_eps = np.asarray(deltas[3]) / np.asarray(dirs[:, 2])

    # the deflections vary strongly across the field; fast must track ref
    assert np.abs(ref_eps).max() > 3 * np.abs(ref_eps).min()
    np.testing.assert_allclose(fast_eps, ref_eps, rtol=0.12,
                               atol=0.03 * np.abs(ref_eps).max())


def test_fast_rotated_camera_matches_reference():
    """Camera angles route through the rotation-aware fast path."""
    cfg, setup0, src, *_ , r1, r2 = _scene("general", rays=16)
    cfg.camera_design.x_camera_angle = np.deg2rad(1.5)
    cfg.camera_design.y_camera_angle = np.deg2rad(-1.0)
    setup = camera_setup(cfg)
    src2, *_ = bos_source(cfg, setup, np.random.default_rng(11))
    vol, *_ = gradient_volume_between(setup, n=16)
    march_fn = make_march_fn(vol, algorithm=2)
    img_ref = np.asarray(render_image(cfg, setup, src2, r1, r2,
                                      march_fn=march_fn))
    img_fast = np.asarray(render_image_fast(cfg, setup, src2, r1, r2,
                                            vol=vol))
    assert img_ref.sum() > 0 and img_fast.sum() > 0
    l1 = np.abs(img_ref - img_fast).sum() / img_ref.sum()
    # round 3 (was 12%): z-domain clamp + circular mask
    assert l1 < 0.01, l1


def test_auto_patch_matches_wide_patch():
    """The auto-sized splat patch (from the circular render mask bound)
    produces the identical image to a conservatively wide patch."""
    cfg, setup, src, *_, r1, r2 = _scene("general")
    img_auto = np.asarray(render_image_fast(cfg, setup, src, r1, r2))
    img_wide = np.asarray(render_image_fast(cfg, setup, src, r1, r2,
                                            patch=14))
    assert img_auto.sum() > 0
    np.testing.assert_allclose(img_auto, img_wide, rtol=0, atol=1e-6)
