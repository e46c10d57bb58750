"""Tests for the differentiable sensor splats against loop-based oracles."""
import math

import numpy as np
import pytest
from scipy.special import erf as nperf

import jax
import jax.numpy as jnp

from photon_tpu.ops.sensor import bilinear_splat, diffraction_splat


def oracle_diffraction(pos, direction, radiance, nx, ny, pitch, D, rf,
                       mirror_x=True):
    """Loop-based reimplementation of the reference's erf splat
    (formulas from parallel_ray_tracing.cu:1441-1540)."""
    image = np.zeros((ny, nx), dtype=np.float64)
    sqrt8 = math.sqrt(8.0)
    for p, d, rad in zip(pos, direction, radiance):
        pixel_1_x = -pitch * (nx - 1) / 2.0
        pixel_1_y = -pitch * (ny - 1) / 2.0
        d_x = (p[0] - pixel_1_x) / pitch
        if mirror_x:
            d_x = nx - 1 - d_x
        d_y = (p[1] - pixel_1_y) / pitch
        if not (0 <= d_x < nx and 0 <= d_y < ny):
            continue
        X, Y = d_x - 0.5, d_y - 0.5
        alpha = math.atan(math.sqrt((d[0]/d[2])**2 + (d[1]/d[2])**2))
        amp = rad * math.cos(alpha)**4 * 8.0 / math.pi
        for col in range(int(np.floor(X - rf*D)), int(np.ceil(X + rf*D)) + 1):
            for row in range(int(np.floor(Y - rf*D)),
                             int(np.ceil(Y + rf*D)) + 1):
                rr = math.sqrt((col - X)**2 + (row - Y)**2)
                if not (0 <= col <= nx-1 and 0 <= row <= ny-1
                        and rr <= rf*D):
                    continue
                inc = amp * math.pi / 32.0 \
                    * (nperf(sqrt8*(col - X - 0.5)/D)
                       - nperf(sqrt8*(col - X + 0.5)/D)) \
                    * (nperf(sqrt8*(row - Y - 0.5)/D)
                       - nperf(sqrt8*(row - Y + 0.5)/D))
                image[row, col] += inc
    return image


def test_diffraction_splat_matches_oracle():
    rng = np.random.default_rng(3)
    n, nx, ny, pitch = 64, 32, 24, 17.0
    pos = np.zeros((n, 3), dtype=np.float32)
    pos[:, 0] = rng.uniform(-pitch*nx/2, pitch*nx/2, n)
    pos[:, 1] = rng.uniform(-pitch*ny/2, pitch*ny/2, n)
    direction = np.tile(np.array([[0.05, -0.02, -1.0]], np.float32), (n, 1))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    radiance = rng.uniform(0.5, 2.0, n).astype(np.float32)

    ours = diffraction_splat(
        jnp.asarray(pos), jnp.asarray(direction), jnp.asarray(radiance),
        jnp.ones(n, bool), nx=nx, ny=ny, pixel_pitch=pitch,
        diameter=3.0, render_fraction=0.75)
    ref = oracle_diffraction(pos, direction, radiance, nx, ny, pitch,
                             3.0, 0.75)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=2e-4, atol=1e-5)
    assert float(np.asarray(ours).sum()) > 0


def test_diffraction_splat_render_fraction_one():
    rng = np.random.default_rng(4)
    n, nx, ny, pitch = 16, 20, 20, 10.0
    pos = np.zeros((n, 3), dtype=np.float32)
    pos[:, 0] = rng.uniform(-60, 60, n)
    pos[:, 1] = rng.uniform(-60, 60, n)
    direction = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    radiance = np.ones(n, np.float32)
    ours = diffraction_splat(
        jnp.asarray(pos), jnp.asarray(direction), jnp.asarray(radiance),
        jnp.ones(n, bool), nx=nx, ny=ny, pixel_pitch=pitch,
        diameter=3.0, render_fraction=1.0)
    ref = oracle_diffraction(pos, direction, radiance, nx, ny, pitch,
                             3.0, 1.0)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=2e-4, atol=1e-5)


def test_diffraction_energy_conservation_center():
    # a normal ray far from the edges deposits nearly its full erf-integral
    # energy: sum over the full spot of the separable erf products equals
    # amp * pi/32 * (sum_x wx)(sum_y wy) ~ radiance (up to spot truncation)
    pos = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    direction = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    ours = diffraction_splat(pos, direction, jnp.ones(1, jnp.float32),
                             jnp.ones(1, bool), nx=64, ny=64,
                             pixel_pitch=17.0, diameter=3.0,
                             render_fraction=0.75)
    total = float(jnp.sum(ours))
    # 8/pi * pi/32 = 1/4; each erf-difference pair sums to ~2 over the
    # (truncated) spot -> total ~ 1/4 * 2 * 2 = ~1 x radiance
    assert 0.85 < total < 1.05


def test_invalid_and_offsensor_rays_drop():
    pos = jnp.asarray([[1e7, 0, 0], [0, 0, 0]], jnp.float32)
    direction = jnp.tile(jnp.asarray([[0., 0., -1.]], jnp.float32), (2, 1))
    rad = jnp.ones(2, jnp.float32)
    img_all = diffraction_splat(pos, direction, rad, jnp.ones(2, bool),
                                nx=16, ny=16, pixel_pitch=17.0, diameter=3.0)
    img_none = diffraction_splat(pos, direction, rad,
                                 jnp.zeros(2, bool),
                                 nx=16, ny=16, pixel_pitch=17.0, diameter=3.0)
    assert float(jnp.sum(img_none)) == 0.0
    # only the on-sensor ray contributes
    assert float(jnp.sum(img_all)) == pytest.approx(
        float(jnp.sum(diffraction_splat(pos[1:], direction[1:], rad[1:],
                                        jnp.ones(1, bool), nx=16, ny=16,
                                        pixel_pitch=17.0, diameter=3.0))))


def oracle_bilinear(pos, direction, radiance, nx, ny, pitch):
    """Loop-based bilinear splat with the reference's (ii-1, jj-1) shift
    (formulas from parallel_ray_tracing.cu:1735-1895, 2216-2234)."""
    image = np.zeros((ny, nx))
    for p, d, rad in zip(pos, direction, radiance):
        pixel_1_x = -pitch * (nx - 1) / 2.0
        pixel_1_y = -pitch * (ny - 1) / 2.0
        d_x = (p[0] - pixel_1_x) / pitch
        d_y = (p[1] - pixel_1_y) / pitch
        if not (0 <= d_x < nx and 0 <= d_y < ny):
            continue
        alpha = math.atan(math.sqrt((d[0]/d[2])**2 + (d[1]/d[2])**2))
        c4 = math.cos(alpha)**4
        dxl, dyl = d_x - 0.5, d_y - 0.5
        dii = math.ceil(dyl) - dyl
        djj = math.ceil(dxl) - dxl
        iiu = int(math.ceil(dyl) - 1)
        jjl = int(math.ceil(dxl) - 1)
        quads = [(iiu, jjl, dii*djj), (iiu, jjl+1, dii*(1-djj)),
                 (iiu+1, jjl, (1-dii)*djj), (iiu+1, jjl+1, (1-dii)*(1-djj))]
        for ii, jj, w in quads:
            if ii < 0 or ii >= ny or jj < 0 or jj >= nx:
                continue
            r, c = ii - 1, jj - 1
            if r < 0 or c < 0:
                continue
            image[r, c] += w * rad * c4
    return image


def test_bilinear_splat_matches_oracle():
    rng = np.random.default_rng(7)
    n, nx, ny, pitch = 128, 24, 24, 17.0
    pos = np.zeros((n, 3), dtype=np.float32)
    pos[:, 0] = rng.uniform(-pitch*nx/2, pitch*nx/2, n)
    pos[:, 1] = rng.uniform(-pitch*ny/2, pitch*ny/2, n)
    direction = np.tile(np.array([[0.1, 0.1, -1.0]], np.float32), (n, 1))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    radiance = rng.uniform(0.1, 1.0, n).astype(np.float32)
    ours = bilinear_splat(jnp.asarray(pos), jnp.asarray(direction),
                          jnp.asarray(radiance), jnp.ones(n, bool),
                          nx=nx, ny=ny, pixel_pitch=pitch)
    ref = oracle_bilinear(pos, direction, radiance, nx, ny, pitch)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-4, atol=1e-6)


def test_splat_is_differentiable():
    def loss(shift):
        pos = jnp.asarray([[0.0, 0.0, 0.0]]) + shift * jnp.asarray([[1., 0., 0.]])
        img = diffraction_splat(pos, jnp.asarray([[0., 0., -1.]]),
                                jnp.ones(1), jnp.ones(1, bool),
                                nx=16, ny=16, pixel_pitch=17.0, diameter=3.0)
        # weighted centroid responds smoothly to sub-pixel shifts
        cols = jnp.arange(16, dtype=jnp.float32)
        return jnp.sum(img * cols[None, :]) / (jnp.sum(img) + 1e-9)

    g = jax.grad(loss)(jnp.float32(0.0))
    assert np.isfinite(float(g))
    assert abs(float(g)) > 1e-4  # moving the ray moves the centroid


# ---------------------------------------------------------------------------
# The fast path's per-particle splat (ops.sensor_fast.particle_splat)
# against the per-ray erf splat above
# ---------------------------------------------------------------------------


def _spots_as_rays(X, Y, nx, ny, pitch):
    """Sensor-plane rays (straight down, so cos^4 = 1) whose mirrored
    pixel coordinates minus 0.5 are (X, Y)."""
    x = -pitch * (nx - 1) / 2.0 + (nx - 1 - (X + 0.5)) * pitch
    y = -pitch * (ny - 1) / 2.0 + (Y + 0.5) * pitch
    pos = jnp.stack([x, y, jnp.zeros_like(x)], -1)
    direction = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), pos.shape)
    return pos, direction


def _both_splats(X, Y, radiance, nx, ny, D, rf, pitch=17.0):
    from photon_tpu.ops.sensor_fast import particle_splat

    patch = max(6, math.ceil(2.0 * rf * D + 3.0))
    A = radiance * (8.0 / math.pi)
    fast = particle_splat(X, Y, A, jnp.round(X).astype(jnp.int32),
                          jnp.round(Y).astype(jnp.int32), nx=nx, ny=ny,
                          diameter=D, patch=patch, render_fraction=rf)
    pos, direction = _spots_as_rays(X, Y, nx, ny, pitch)
    ref = diffraction_splat(pos, direction, radiance,
                            jnp.ones(X.shape, bool), nx=nx, ny=ny,
                            pixel_pitch=pitch, diameter=D,
                            render_fraction=rf)
    return fast, ref


@pytest.mark.parametrize("D,rf", [(2.5, 0.75), (3.0, 0.75), (4.2, 1.0)])
def test_particle_splat_matches_ray_splat_interior(D, rf):
    rng = np.random.default_rng(int(D * 10))
    nx = ny = 48
    X = jnp.asarray(rng.uniform(8, nx - 9, 20), jnp.float32)
    Y = jnp.asarray(rng.uniform(8, ny - 9, 20), jnp.float32)
    rad = jnp.asarray(rng.uniform(0.5, 2.0, 20), jnp.float32)
    fast, ref = _both_splats(X, Y, rad, nx, ny, D, rf)
    assert float(ref.sum()) > 0
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref),
                               rtol=1e-4, atol=1e-6 * float(ref.max()))


def test_particle_splat_matches_ray_splat_at_borders():
    """Spots whose circle crosses the frame edge: the fast splat clamps
    its patch inside the frame, the ray splat drops out-of-frame pixels;
    both keep exactly the in-frame part.  (Centres stay on the sensor:
    the fast path drops off-sensor rays before it sums a particle's
    amplitude.)"""
    nx, ny = 40, 32
    X = jnp.asarray([0.2, 1.6, nx - 1.3, nx - 0.6, 20.0, 3.0],
                    jnp.float32)
    Y = jnp.asarray([15.0, 0.4, ny - 1.1, 2.0, ny - 0.7, ny - 2.5],
                    jnp.float32)
    rad = jnp.ones(6, jnp.float32)
    fast, ref = _both_splats(X, Y, rad, nx, ny, 3.0, 0.75)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref),
                               rtol=1e-4, atol=1e-6 * float(ref.max()))


def test_particle_splat_gradient_matches_ray_splat():
    """d(weighted image)/d(spot centre, amplitude) agree."""
    from photon_tpu.ops.sensor_fast import particle_splat

    nx = ny = 40
    rng = np.random.default_rng(5)
    X0 = jnp.asarray(rng.uniform(6, nx - 7, 8), jnp.float32)
    Y0 = jnp.asarray(rng.uniform(6, ny - 7, 8), jnp.float32)
    rad0 = jnp.asarray(rng.uniform(0.5, 2.0, 8), jnp.float32)
    w = jnp.asarray(rng.random((ny, nx)), jnp.float32)
    col = jnp.round(X0).astype(jnp.int32)
    row = jnp.round(Y0).astype(jnp.int32)

    def fast(X, Y, rad):
        return jnp.sum(w * particle_splat(
            X, Y, rad * (8.0 / math.pi), col, row, nx=nx, ny=ny,
            diameter=3.0, patch=8, render_fraction=0.75))

    def ref(X, Y, rad):
        pos, direction = _spots_as_rays(X, Y, nx, ny, 17.0)
        return jnp.sum(w * diffraction_splat(
            pos, direction, rad, jnp.ones(X.shape, bool), nx=nx, ny=ny,
            pixel_pitch=17.0, diameter=3.0, render_fraction=0.75))

    g_f = jax.grad(fast, argnums=(0, 1, 2))(X0, Y0, rad0)
    g_r = jax.grad(ref, argnums=(0, 1, 2))(X0, Y0, rad0)
    for a, b in zip(g_f, g_r):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, rtol=2e-3,
                                   atol=2e-4 * np.abs(b).max())
