"""photon_tpu — a differentiable PIV/BOS synthetic image renderer in JAX.

A from-scratch JAX reimplementation of the capabilities of the
``photon`` CUDA + Python renderer (reference: lalitkrajendran/photon):
synthetic particle-image-velocimetry (PIV) and background-oriented-schlieren
(BOS) image generation through a single-lens camera model, with optional
curved-ray propagation through a variable-density refractive-index volume.

Design notes
------------
Everything on the compute path is functional JAX: static shapes, masked rays
instead of divergent control flow, ``lax``-based loops, and scatter-add sensor
integration — so the whole forward pipeline `jit`s, `vmap`s, `grad`s and
shards over a `jax.sharding.Mesh`.

Reference-layer map (see SURVEY.md for the full inventory):
  config.py           <- python_codes/create_simulation_parameters.py (C16)
  models/optics.py    <- run_simulation_02.create_camera_optical_system (C3)
                         + perform_ray_tracing_03.create_element_coordinate_arrays (C9)
  models/scenes.py    <- run_simulation_02 light-field sources (C5, C7)
  ops/mie.py          <- bhmie.py + create_mie_scattering_data (C6)
  volume.py           <- trace_rays_through_density_gradients.h loadNRRD/setData (C13 setup)
  ops/interp.py       <- CubicInterpolationCUDA + tex3D semantics (C14)
  ops/march.py        <- trace_rays_through_density_gradients.h integrators (C13)
  ops/sensor.py       <- parallel_ray_tracing.cu intersect_sensor{,_02} (C12 sensor)
  models/render.py    <- parallel_ray_tracing.cu kernel + host runtime (C11, C12)
  parallel/           <- multi-device sharding (mesh/psum; ref is single-GPU)
  pipeline.py         <- run_simulation_02.run_simulation_02 (C2)
  cli.py              <- batch_run_simulation.py (C1)
  analysis/           <- light_ray_processing.py, synthetic_fields.py (C17, C18)
"""

__version__ = "0.1.0"

from photon_tpu.config import (  # noqa: F401
    SimulationConfig,
    LensDesign,
    CameraDesign,
    ParticleField,
    CalibrationGrid,
    BosPattern,
    DensityGradients,
    OutputData,
    default_config,
)
