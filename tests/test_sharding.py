"""Multi-device tests on the virtual 8-device CPU mesh."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from tests.test_bos_pipeline import bos_case, gradient_volume_between
from photon_tpu.models.optics import camera_setup
from photon_tpu.models.render_fast import render_image_fast
from photon_tpu.models.scenes import bos_source
from photon_tpu.utils.rng import lens_samples

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@needs_mesh
def test_sharded_fast_render_matches_single_device():
    cfg = bos_case("general", n_dots=6, rays=16)
    setup = camera_setup(cfg)
    src, *_ = bos_source(cfg, setup, np.random.default_rng(11))
    r1, r2 = lens_samples(jax.random.key(5), 16)
    vol, *_ = gradient_volume_between(setup, n=16)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("particles",))

    img1 = np.asarray(render_image_fast(cfg, setup, src, r1, r2, vol=vol))
    img8 = np.asarray(render_image_fast(cfg, setup, src, r1, r2, vol=vol,
                                        mesh=mesh))
    assert img1.sum() > 0
    np.testing.assert_allclose(img8.sum(), img1.sum(), rtol=1e-4)
    l1 = np.abs(img1 - img8).sum() / img1.sum()
    assert l1 < 1e-4, l1


@needs_mesh
def test_graft_dryrun_multichip():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_shard_helpers():
    """The canonical sharding API (parallel.shard) used by production:
    multihost_init no-ops single-process, make_mesh spans devices,
    pad_to_multiple pads with the requested fills."""
    from photon_tpu.parallel.shard import (make_mesh, multihost_init,
                                           pad_to_multiple)

    multihost_init()                          # single-host: must no-op
    multihost_init(num_processes=1)
    mesh = make_mesh(2)
    assert mesh.devices.size == 2
    assert mesh.axis_names == ("particles",)

    a = np.arange(5, dtype=np.float32)
    (pa, pz), n = pad_to_multiple((a, a), 4, fills=(0.0, 1.0))
    assert n == 5 and pa.shape == (8,)
    assert pa[5:].sum() == 0.0 and (pz[5:] == 1.0).all()
    (same,), n2 = pad_to_multiple((a,), 5)
    assert n2 == 5 and same.shape == (5,)


@needs_mesh
def test_scaling_report_smoke():
    """The weak-scaling harness runs on the virtual mesh and reports
    sane sharding-overhead efficiencies (full sweep is run by
    `python -m photon_tpu.parallel.shard`; recorded in SCALING.md)."""
    from photon_tpu.parallel.shard import scaling_report

    rep = scaling_report(device_counts=(1, 2), dots_per_device=8,
                         rays_per_dot=8, sensor=64, reps=1)
    assert rep["device_counts"] == [1, 2]
    assert rep["weak"][2]["rays_per_s"] > 0
    # fwd+bwd sweep (the psum-transpose of the replicated field) ran
    assert rep["grad"][2]["rays_per_s"] > 0
    assert rep["grad"][2]["weak_scaling_efficiency"] <= 1.0
    # the collective isolation is a fraction of wall time in [0, 1)
    assert 0.0 <= rep["collective"][2]["psum_fraction"] < 1.0
    assert "caveat" in rep


@needs_mesh
def test_sharded_windowed_march_matches_single_device():
    """A volume beyond the dense-march cap renders through the tube march
    under a mesh (each shard marches its own chiefs) and matches the
    single-device image."""
    from photon_tpu.config import default_config
    from photon_tpu.ops.march_dense import dense_march_supported
    from photon_tpu.volume import build_density_volume

    cfg = default_config("bos")
    cfg.camera_design.x_pixel_number = 128
    cfg.camera_design.y_pixel_number = 128
    cfg.bos_pattern.grid_point_number = 200
    cfg.bos_pattern.particle_number_per_grid_point = 4
    cfg.bos_pattern.lightray_number_per_particle = 8
    m = cfg.lens_design.focal_length / (
        cfg.lens_design.object_distance - cfg.lens_design.focal_length)
    half = 0.7 * 128 * cfg.camera_design.pixel_pitch / 2.0 / m
    cfg.bos_pattern.X_Min, cfg.bos_pattern.X_Max = -half, half
    cfg.bos_pattern.Y_Min, cfg.bos_pattern.Y_Max = -half, half
    setup = camera_setup(cfg)
    src, *_ = bos_source(cfg, setup, np.random.default_rng(3))
    r1, r2 = lens_samples(jax.random.key(7), 8)

    n, d = 144, 6
    x = np.linspace(-2e5, 2e5, n)
    z = np.linspace(setup.object_distance - 0.6 * setup.object_distance,
                    setup.object_distance - 0.1 * setup.object_distance, d)
    gx = np.linspace(0, 1, n)
    rho = 1.225 + 2.0 * gx[:, None, None] ** 2 * np.ones((1, n, d))
    vol = build_density_volume(
        rho, [x[1] - x[0], x[1] - x[0], z[1] - z[0]], [x[0], x[0], z[0]])
    assert not dense_march_supported(vol)

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("particles",))
    img1 = np.asarray(render_image_fast(cfg, setup, src, r1, r2, vol=vol))
    img8 = np.asarray(render_image_fast(cfg, setup, src, r1, r2, vol=vol,
                                        mesh=mesh))
    img0 = np.asarray(render_image_fast(cfg, setup, src, r1, r2))
    assert img1.sum() > 0
    assert np.abs(img1 - img0).sum() > 1e-3 * img1.sum()   # it deflects
    l1 = np.abs(img1 - img8).sum() / img1.sum()
    assert l1 < 1e-4, l1


@needs_mesh
def test_dense_march_under_shard_map():
    """The dense chief march runs per shard under shard_map (chiefs
    sharded, field replicated); its deltas and its field gradient, summed
    across shards, match the unsharded march."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as Pspec

    from photon_tpu.ops.march_dense import chief_deltas_dense

    cfg = bos_case("general")
    setup = camera_setup(cfg)
    vol, *_ = gradient_volume_between(setup, n=12)
    P = 16
    xs = np.linspace(-6e4, 6e4, P).astype(np.float32)
    args = tuple(jnp.asarray(a) for a in (
        xs, 0.2 * xs, np.full(P, -5e4, np.float32),
        np.full(P, 0.01, np.float32), np.zeros(P, np.float32),
        np.full(P, -np.sqrt(1 - 1e-4), np.float32)))
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("particles",))
    part, repl = Pspec("particles"), Pspec()

    def loss(field, *a):
        d = chief_deltas_dense(vol._replace(field=field), *a, algorithm=2)
        return jnp.sum(d[3] ** 2 + d[1] * 1e-9)

    # the field enters replicated, so its per-shard cotangents are
    # psum'd by the transpose of the implicit broadcast to the shards
    g_sharded = jax.jit(shard_map(
        jax.grad(loss), mesh=mesh, in_specs=(repl,) + (part,) * 6,
        out_specs=repl))(vol.field, *args)
    g_one = jax.grad(loss)(vol.field, *args)
    d_sharded = jax.jit(shard_map(
        lambda *a: chief_deltas_dense(vol, *a, algorithm=2), mesh=mesh,
        in_specs=(part,) * 6, out_specs=(part,) * 6))(*args)
    d_one = chief_deltas_dense(vol, *args, algorithm=2)
    # dpos is a difference of ~1e5 um coordinates: f32 resolves ~1e-2 um
    for a, b in zip(d_sharded, d_one):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4 * float(
                                       np.abs(np.asarray(b)).max()))
    g_one = np.asarray(g_one)
    assert np.abs(g_one).max() > 0
    np.testing.assert_allclose(np.asarray(g_sharded), g_one, rtol=1e-3,
                               atol=1e-4 * np.abs(g_one).max())
