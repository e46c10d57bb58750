"""Which chief march render_image_fast takes, chosen from the slab size
alone: the dense march up to 128x128 slabs, the tube march beyond; and
the XLA fan chain (generation -> march deltas -> lens -> splat) against
the exact render, image and field gradient."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.test_bos_pipeline import bos_case, gradient_volume_between
from tests.test_march_dense import assert_projected_gradients_close
from tests.test_march_tube import blob_volume
from tests.test_march_tube_fullmenu import big_volume
import photon_tpu.models.render_fast as rf
from photon_tpu.models.optics import camera_setup
from photon_tpu.models.render import render_image
from photon_tpu.models.render_fast import render_image_fast
from photon_tpu.models.scenes import bos_source
from photon_tpu.ops.march import make_march_fn, march_rays
from photon_tpu.ops.march_dense import dense_march_supported
from photon_tpu.utils.rng import lens_samples


def _scene(lens_model="general", rays=16, n_dots=6):
    cfg = bos_case(lens_model, n_dots=n_dots, rays=rays)
    setup = camera_setup(cfg)
    src, *_ = bos_source(cfg, setup, np.random.default_rng(11))
    r1, r2 = lens_samples(jax.random.key(5), rays)
    return cfg, setup, src, np.asarray(r1), np.asarray(r2)


def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(rf, name)

    def counted(*a, **k):
        calls.append(name)
        return real(*a, **k)
    monkeypatch.setattr(rf, name, counted)
    return calls


@pytest.mark.parametrize("algorithm", [1, 2, 3, 4])
def test_large_volume_routes_through_tube_march(monkeypatch, algorithm):
    """A volume past the dense cap renders through the tube march (never
    the dense one) and matches the exact-path image, for every
    integrator.  Each case has its own ray count, so its trace is new
    and the routing is observed."""
    cfg, setup, src, r1, r2 = _scene(rays=9 + algorithm)
    vol = big_volume(setup, n_xy=132, n_z=32)
    assert not dense_march_supported(vol)
    tube = _count_calls(monkeypatch, "chief_deltas_chunked")
    dense = _count_calls(monkeypatch, "chief_deltas_dense")
    img = np.asarray(render_image_fast(cfg, setup, src, r1, r2, vol=vol,
                                       algorithm=algorithm))
    assert tube and not dense
    # the exact path's algorithm 3 is tolerance-adaptive RK45; the fast
    # path's is RK4 with error-controlled substeps, so compare to RK4
    exact_alg = {1: 1, 2: 2, 3: 2, 4: 4}[algorithm]
    ref = np.asarray(render_image(
        cfg, setup, src, r1, r2,
        march_fn=make_march_fn(vol, algorithm=exact_alg)))
    assert ref.sum() > 0
    l1 = np.abs(img - ref).sum() / ref.sum()
    # measured 1.05% (RK4, AB4, RK4 substeps) and 2.3% (Euler) on this
    # 132 x 132 x 32 grid; the dense march on a 120 x 120 x 12 grid of the
    # same field reads 0.33%, and there the tube and dense deltas agree
    # exactly, so the gap is the z-slab vs arc-length discretization
    assert l1 < 0.03, l1


def test_small_volume_routes_through_dense_march(monkeypatch):
    cfg, setup, src, r1, r2 = _scene(rays=15)
    vol = blob_volume(setup, n_x=20, n_z=8)
    assert dense_march_supported(vol)
    tube = _count_calls(monkeypatch, "chief_deltas_chunked")
    dense = _count_calls(monkeypatch, "chief_deltas_dense")
    img = np.asarray(render_image_fast(cfg, setup, src, r1, r2, vol=vol))
    assert dense and not tube
    assert img.sum() > 0


@pytest.mark.parametrize("lens_model", ["apparent", "thin-lens", "general"])
def test_fan_chain_field_gradient_matches_exact(lens_model):
    """d(weighted image)/d(field) through the fast path (chief march ->
    fan deltas -> lens -> particle splat) agrees with the exact per-ray
    render along smooth field perturbations."""
    cfg, setup, src, r1, r2 = _scene(lens_model, rays=16)
    vol, *_ = gradient_volume_between(setup, n=12)
    w = jnp.asarray(np.random.default_rng(7).random((256, 256)),
                    jnp.float32)

    def fast(field):
        return jnp.sum(w * render_image_fast(
            cfg, setup, src, r1, r2, vol=vol._replace(field=field)))

    def exact(field):
        flat = field.reshape(-1, 4)
        return jnp.sum(w * render_image(
            cfg, setup, src, r1, r2, march_fn=lambda rays: march_rays(
                vol, rays, algorithm=2, differentiable=True,
                field_flat=flat)))

    assert_projected_gradients_close(jax.jit(jax.grad(fast))(vol.field),
                                     jax.jit(jax.grad(exact))(vol.field),
                                     vol.field.shape, rtol=0.07)
