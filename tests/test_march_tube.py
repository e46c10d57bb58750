"""The gather-based tube march (ops.march_fast): against the dense march
where both apply (slabs up to 128x128), and against the exact marcher
past the dense cap."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.test_bos_pipeline import bos_case
from tests.test_march_dense import MENU
from photon_tpu.models.optics import camera_setup
from photon_tpu.ops.lens import RayBundle
from photon_tpu.ops.march import march_rays
from photon_tpu.ops.march_dense import (choose_substeps,
                                        dense_march_supported,
                                        march_chief_dense)
from photon_tpu.ops.march_fast import march_chief_tubes
from photon_tpu.volume import build_density_volume


def blob_volume(setup, n_x=16, n_y=None, n_z=12, extent=4e5):
    """A field that varies in x, y and z (ramp plus an off-center
    Gaussian blob) between the dot plane and the lens."""
    n_y = n_x if n_y is None else n_y
    x = np.linspace(-extent / 2, extent / 2, n_x)
    y = np.linspace(-extent / 2, extent / 2, n_y) * (n_y / n_x)
    z_dots = setup.object_distance
    z = np.linspace(z_dots - 0.6 * z_dots, z_dots - 0.1 * z_dots, n_z)
    X, Y, Z = np.meshgrid(x / (extent / 2), y / (extent / 2),
                          (z - z.mean()) / (z.max() - z.min()),
                          indexing="ij")
    rho = 1.225 + 2.0 * (X + 1.0) \
        + 1.5 * np.exp(-((X - 0.1) ** 2 + (Y + 0.15) ** 2 + Z ** 2) / 0.08)
    return build_density_volume(
        rho, [x[1] - x[0], y[1] - y[0], z[1] - z[0]], [x[0], y[0], z[0]])


def chiefs(P=7, span=1.2e5, slope=0.03, y_frac=0.3):
    """Downward chief rays across the field with small lateral slopes."""
    xs = np.linspace(-span / 2, span / 2, P).astype(np.float32)
    ys = (y_frac * xs[::-1]).astype(np.float32)
    d = np.stack([slope * xs / xs.max(), -0.5 * slope * np.ones(P),
                  -np.ones(P)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pos = np.stack([xs, ys, np.full(P, -5e4)], -1).astype(np.float32)
    return pos, d


def state_args(pos, d):
    return tuple(jnp.asarray(a) for a in (pos[:, 0], pos[:, 1], pos[:, 2],
                                          d[:, 0], d[:, 1], d[:, 2]))


def exact_slopes(vol, pos, d, algorithm, scheme):
    ref = march_rays(vol, RayBundle(jnp.asarray(pos), jnp.asarray(d),
                                    jnp.zeros(len(pos)), jnp.ones(len(pos))),
                     algorithm=algorithm, interpolation_scheme=scheme)
    return np.asarray(ref.dir)[:, 0] / np.asarray(ref.dir)[:, 2]


@pytest.fixture(scope="module")
def setup():
    return camera_setup(bos_case("general"))


@pytest.mark.parametrize("algorithm,scheme", MENU)
def test_tube_matches_dense(setup, algorithm, scheme):
    """Both implement the same z-slab integrator: where the dense march
    applies, their exit states agree to float rounding."""
    vol = blob_volume(setup)
    assert dense_march_supported(vol)
    pos, d = chiefs()
    args = state_args(pos, d)
    dense = march_chief_dense(vol, *args, algorithm=algorithm,
                              interpolation_scheme=scheme)
    tube = march_chief_tubes(vol, *args, algorithm=algorithm,
                             interpolation_scheme=scheme)
    for i in (3, 4):                  # deflection of the exit direction
        defl_d = np.asarray(dense[i]) - d[:, i - 3]
        defl_t = np.asarray(tube[i]) - d[:, i - 3]
        np.testing.assert_allclose(defl_t, defl_d,
                                   atol=1e-3 * np.abs(defl_d).max())
    np.testing.assert_allclose(np.asarray(tube[0]), np.asarray(dense[0]),
                               rtol=0, atol=1.0)        # microns


@pytest.mark.parametrize("algorithm,scheme", [(1, 1), (2, 1), (2, 2),
                                              (4, 1)])
def test_tube_field_gradient_matches_dense(setup, algorithm, scheme):
    vol = blob_volume(setup)
    pos, d = chiefs(P=5)
    args = state_args(pos, d)
    w = jnp.asarray(np.linspace(0.5, 1.5, len(pos)), jnp.float32)

    def loss(march, field):
        out = march(vol._replace(field=field), *args, algorithm=algorithm,
                    interpolation_scheme=scheme)
        return jnp.sum(w * out[3] / out[5]) + jnp.sum(w * out[4] / out[5])

    g_d = np.asarray(jax.grad(lambda f: loss(march_chief_dense, f))(
        vol.field))
    g_t = np.asarray(jax.grad(lambda f: loss(march_chief_tubes, f))(
        vol.field))
    assert np.abs(g_d).max() > 0
    np.testing.assert_allclose(g_t, g_d, atol=2e-3 * np.abs(g_d).max())


def test_tube_state_gradients_match_dense(setup):
    """Gradients w.r.t. the chief rays' entry state (positions and
    directions) agree between the two marches."""
    vol = blob_volume(setup)
    pos, d = chiefs(P=5)
    args = state_args(pos, d)

    def loss(march, *a):
        out = march(vol, *a, algorithm=2)
        return jnp.sum(out[3] / out[5] + out[0] * 1e-6)

    g_d = jax.grad(lambda *a: loss(march_chief_dense, *a),
                   argnums=(0, 1, 3, 4))(*args)
    g_t = jax.grad(lambda *a: loss(march_chief_tubes, *a),
                   argnums=(0, 1, 3, 4))(*args)
    for a, b in zip(g_t, g_d):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-3 * np.abs(b).max())


def test_tube_miss_rays_pass_through(setup):
    """Rays below the volume or travelling upward leave unchanged."""
    vol = blob_volume(setup, n_x=140, n_z=8)
    assert not dense_march_supported(vol)
    pos, d = chiefs(P=4)
    pos[0, 2] = float(vol.min_bound[2]) - 1e4      # starts below
    d[1] = -d[1]                                  # travels upward
    out = march_chief_tubes(vol, *state_args(pos, d))
    for k in (0, 1):
        np.testing.assert_array_equal(np.asarray(out[3])[k], d[k, 0])
        np.testing.assert_array_equal(np.asarray(out[5])[k], d[k, 2])
    # the two rays that do cross the volume are deflected
    assert np.all(np.abs(np.asarray(out[3])[2:] - d[2:, 0]) > 1e-7)


@pytest.mark.parametrize("shape", [(137, 131, 9), (420, 48, 10)],
                         ids=["unaligned", "wide"])
def test_tube_past_dense_cap_matches_exact(setup, shape):
    """Volumes whose sides are not multiples of anything, and a wide
    slab (W >> H), march through tubes like the exact marcher."""
    n_x, n_y, n_z = shape
    vol = blob_volume(setup, n_x=n_x, n_y=n_y, n_z=n_z)
    assert not dense_march_supported(vol)
    # rays stay inside the volume laterally: the exact marcher stops a
    # ray at a side face, the z-scan marches clamp to the border voxel
    pos, d = chiefs(P=6, span=3.0e5 if n_x > 200 else 1.2e5, y_frac=0.0)
    out = march_chief_tubes(vol, *state_args(pos, d), algorithm=2)
    slope = np.asarray(out[3]) / np.asarray(out[5])
    ref = exact_slopes(vol, pos, d, 2, 1)
    defl_ref = ref - d[:, 0] / d[:, 2]
    np.testing.assert_allclose(slope - d[:, 0] / d[:, 2], defl_ref,
                               rtol=0.03, atol=0.03 * np.abs(defl_ref).max())


def test_tube_substeps_match_dense(setup):
    """The tube march honours ``substeps`` like the dense march."""
    vol = blob_volume(setup)
    pos, d = chiefs(P=5)
    args = state_args(pos, d)
    out = {}
    for s in (1, 4):
        out[s] = (march_chief_dense(vol, *args, algorithm=2, substeps=s),
                  march_chief_tubes(vol, *args, algorithm=2, substeps=s))
    for s in (1, 4):
        dd, tt = (np.asarray(o[3]) for o in out[s])
        np.testing.assert_allclose(tt, dd, atol=1e-3 * np.abs(dd).max())
    assert not np.array_equal(np.asarray(out[1][1][0]),
                              np.asarray(out[4][1][0]))


def test_choose_substeps_beyond_dense_cap(setup):
    """Algorithm 3's substep control probes through the tube march when
    the slabs exceed the dense cap."""
    vol = blob_volume(setup, n_x=132, n_z=10)
    assert not dense_march_supported(vol)
    pos, d = chiefs(P=9)
    n = choose_substeps(vol, *[np.asarray(a) for a in state_args(pos, d)])
    assert isinstance(n, int) and 2 <= n <= 16
    forced = choose_substeps(vol, *[np.asarray(a)
                                    for a in state_args(pos, d)],
                             budget=1e-12, max_substeps=8)
    assert forced == 8
