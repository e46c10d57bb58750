"""Every matrix product of the renders asks for full float32 precision.

On an NVIDIA GPU XLA may run a default-precision float32 product in TF32
(10 mantissa bits), which would move ~1e6 um ray positions by hundreds of
microns and blur micro-radian deflections.  Lowering needs no GPU: the
requested precision is part of each dot_general in the StableHLO.
"""
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.test_bos_pipeline import bos_case, gradient_volume_between
from photon_tpu.models.optics import camera_setup
from photon_tpu.models.render import render_image
from photon_tpu.models.render_fast import render_image_fast
from photon_tpu.models.scenes import bos_source
from photon_tpu.ops.march import march_rays
from photon_tpu.ops.march_dense import bspline_prefilter_jax
from photon_tpu.utils.rng import lens_samples


def _bos(rotated=False):
    cfg = bos_case("general", n_dots=2, rays=4)
    if rotated:
        cfg.camera_design.x_camera_angle = 0.02
    setup = camera_setup(cfg)
    src, *_ = bos_source(cfg, setup, np.random.default_rng(1))
    r1, r2 = lens_samples(jax.random.key(1), 4)
    vol, *_ = gradient_volume_between(setup, n=8)
    return cfg, setup, src, np.asarray(r1), np.asarray(r2), vol


def _fast(scheme=1, rotated=False):
    cfg, setup, src, r1, r2, vol = _bos(rotated=rotated)

    def render(field):
        return jnp.sum(render_image_fast(
            cfg, setup, src, r1, r2, vol=vol._replace(field=field),
            interpolation_scheme=scheme))
    return render, vol.field


def _exact(scheme=1, rotated=False):
    cfg, setup, src, r1, r2, vol = _bos(rotated=rotated)

    def render(field):
        coeff = bspline_prefilter_jax(field) if scheme == 2 else field
        flat = coeff.reshape(-1, 4)
        return jnp.sum(render_image(
            cfg, setup, src, r1, r2, march_fn=lambda rays: march_rays(
                vol, rays, algorithm=2, interpolation_scheme=scheme,
                differentiable=True, field_flat=flat)))
    return render, vol.field


def _piv_exact():
    from photon_tpu.config import default_config
    from photon_tpu.models.scenes import piv_source
    from photon_tpu.ops.mie import create_mie_scattering_data

    cfg = default_config("piv")
    cfg.camera_design.x_pixel_number = 32
    cfg.camera_design.y_pixel_number = 32
    cfg.particle_field.particle_number = 4
    cfg.particle_field.lightray_number_per_particle = 4
    cfg.particle_field.mie_scattering_angle_number = 8
    cfg.particle_field.particle_diameter_number = 3
    rng = np.random.default_rng(2)
    setup = camera_setup(cfg)
    sc = create_mie_scattering_data(cfg, rng)
    src = piv_source(cfg, setup, 1, diameter_index_distribution=sc[
        "particle_diameter_index_distribution"], rng=rng)
    r1, r2 = lens_samples(jax.random.key(2), 4)

    def render(radiance_scale):
        return jnp.sum(render_image(cfg, setup, src, r1, r2,
                                    scattering=sc) * radiance_scale)
    return render, jnp.float32(1.0)


CASES = {
    "fast": lambda: _fast(),
    "fast_tricubic": lambda: _fast(scheme=2),
    "fast_rotated": lambda: _fast(rotated=True),
    "exact": lambda: _exact(),
    "exact_tricubic": lambda: _exact(scheme=2),
    "exact_rotated": lambda: _exact(rotated=True),
    "exact_piv_mie": _piv_exact,
}


def _dot_precisions(fn, arg):
    text = jax.jit(fn).lower(arg).as_text()
    dots = [line for line in text.splitlines()
            if "stablehlo.dot_general" in line]
    return dots, [re.findall(r"precision = \[(\w+), (\w+)\]", d)
                  for d in dots]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("mode", ["forward", "gradient"])
def test_every_dot_general_is_highest(name, mode):
    fn, arg = CASES[name]()
    if mode == "gradient":
        fn = jax.grad(fn)
    dots, precisions = _dot_precisions(fn, arg)
    assert dots, "expected matrix products in the lowered render"
    for d, p in zip(dots, precisions):
        assert p == [("HIGHEST", "HIGHEST")], d.strip()[:300]
