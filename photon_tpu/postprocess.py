"""Image post-processing: noise, gain, quantization, cropping.

Replacement for the reference's post-render stage
(ref: perform_ray_tracing_03.py:2193-2259): additive Gaussian noise scaled
by ``image_noise * 100`` counts, clipping at zero, pixel gain
``10^(dB/20)``, normalization to ``2^bit_depth - 1`` by the image maximum,
integer rounding, and re-expansion to the full 16-bit range.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from photon_tpu.config import SimulationConfig


def add_image_noise(image, noise_fraction: float, key) -> jnp.ndarray:
    """Additive Gaussian noise with std = noise_fraction * 100 counts.

    (ref: perform_ray_tracing_03.py:2197-2209)
    """
    if noise_fraction <= 0.0:
        return image
    noise = jax.random.normal(key, image.shape, dtype=image.dtype) \
        * (noise_fraction * 100.0)
    return image + noise


def quantize(image, pixel_gain_db: float, pixel_bit_depth: int,
             intensity_rescaling: bool = True) -> jnp.ndarray:
    """Gain + bit-depth quantization to uint16 counts.

    (ref: perform_ray_tracing_03.py:2211-2247)
    """
    image = jnp.where(image < 0.0, 0.0, image)
    if not intensity_rescaling:
        return image.astype(jnp.uint16)
    image = jnp.where(jnp.isfinite(image), image, 0.0)
    image = image * 10.0 ** (pixel_gain_db / 20.0)
    maxval = jnp.max(image)
    levels = 2.0 ** pixel_bit_depth - 1.0
    image = jnp.where(maxval > 0.0, levels * image / maxval, image)
    image = jnp.round(image)
    image = image * (2.0 ** 16 - 1.0) / levels
    return image.astype(jnp.uint16)


def crop(image: np.ndarray, r_crop: int, c_crop: int) -> np.ndarray:
    """Center crop (ref: perform_ray_tracing_03.py:2250-2259)."""
    nr, nc = image.shape
    return image[nr // 2 - r_crop // 2: nr // 2 + r_crop // 2 - 1,
                 nc // 2 - c_crop // 2: nc // 2 + c_crop // 2 - 1]


def postprocess(cfg: SimulationConfig, raw_image,
                key: Optional[jax.Array] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Full post-processing chain -> (quantized uint16, raw float32).

    Returns the same (I, I_raw) pair as the reference's
    ``perform_ray_tracing_03`` tail (:2189-2291).
    """
    cd = cfg.camera_design
    raw = jnp.asarray(raw_image, dtype=jnp.float32)
    if cd.image_noise > 0.0:
        if key is None:
            key = jax.random.key(cfg.seed)
        raw = add_image_noise(raw, cd.image_noise, key)
    quantized = quantize(raw, cd.pixel_gain, cd.pixel_bit_depth,
                         cd.intensity_rescaling)
    I = np.asarray(quantized)
    I_raw = np.asarray(raw, dtype=np.float32)
    if cfg.output_data.crop_image:
        I = crop(I, cfg.output_data.r_crop, cfg.output_data.c_crop)
        I_raw = crop(I_raw, cfg.output_data.r_crop, cfg.output_data.c_crop)
    return I, I_raw
