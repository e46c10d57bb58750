"""Light-ray data analysis: per-dot averaging and BOS deflection extraction.

Replacement for the reference's ray-data validation pipeline
(C18 in SURVEY.md, ``python_codes/light_ray_processing.py``):

* ray pos/dir binary IO — ref: load_light_ray_data (:143-210) and the
  CUDA-side dumps (parallel_ray_tracing.cu:3561-3670)
* sensor-origin pixel conversion — ref: convert_pos_to_pixels (:277-330)
* per-dot averaging over lightray_number_per_particle rays — ref: (:243-275)
* im1/im2 deflections — ref: calculate_lightray_deflections (:211-242)
* end-to-end folder processing — ref: process_lightray_data (:532-638)

This is the de-facto acceptance test of BOS physics: render the image pair
with and without density gradients, average each dot's surviving rays, and
compare the dot displacement against the paraxial oracle.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


def save_ray_data(path: str, pos: np.ndarray, direction: np.ndarray,
                  chunk_index: int = 0) -> Tuple[str, str]:
    """Write pos_%04d.bin / dir_%04d.bin float32 dumps.

    Layout matches the reference's CUDA dumps: flattened float32 xyz
    triplets (ref: parallel_ray_tracing.cu:3561-3670).  ``path`` holds two
    sibling directories or receives both files directly.
    """
    os.makedirs(path, exist_ok=True)
    ppath = os.path.join(path, f"pos_{chunk_index:04d}.bin")
    dpath = os.path.join(path, f"dir_{chunk_index:04d}.bin")
    np.asarray(pos, np.float32).tofile(ppath)
    np.asarray(direction, np.float32).tofile(dpath)
    return ppath, dpath


def load_ray_data(directory: str, prefix: str = "pos") -> np.ndarray:
    """Concatenate all {prefix}_*.bin dumps in a directory into (N, 3)."""
    import glob

    files = sorted(glob.glob(os.path.join(directory, prefix + "_*.bin")))
    if prefix in ("pos", "dir"):
        # don't sweep up the intermediate_* dumps living alongside
        files = [f for f in files
                 if os.path.basename(f).startswith(prefix + "_")]
    parts = [np.fromfile(f, dtype=np.float32).reshape(-1, 3) for f in files]
    if not parts:
        raise FileNotFoundError(f"no {prefix}_*.bin in {directory}")
    return np.concatenate(parts)


def load_intermediate_ray_data(directory: str, num_positions_save: int,
                               prefix: str = "intermediate_pos") -> np.ndarray:
    """Load per-step trajectory dumps into (n_rays, num_positions_save, 3).

    Inverse of the renderer's intermediate dump (the reference's layout
    ``thread_id * num_intermediate_positions_save + loop_ctr``,
    ref: parallel_ray_tracing.cu:3613-3670); untouched entries are NaN.
    """
    import glob

    files = sorted(glob.glob(os.path.join(directory, prefix + "_*.bin")))
    if not files:
        raise FileNotFoundError(f"no {prefix}_*.bin in {directory}")
    parts = [np.fromfile(f, dtype=np.float32)
             .reshape(-1, num_positions_save, 3) for f in files]
    return np.concatenate(parts)


def positions_to_pixels(pos: np.ndarray, pixel_pitch: float,
                        nx: int, ny: int,
                        mirror_x: bool = True) -> np.ndarray:
    """Sensor-plane microns -> fractional pixel coordinates.

    Same mapping as the sensor stage (ref: light_ray_processing.py:277-330
    and parallel_ray_tracing.cu:1441-1447).
    """
    out = np.array(pos[:, :2], dtype=np.float64)
    pixel_1_x = -pixel_pitch * (nx - 1) / 2.0
    pixel_1_y = -pixel_pitch * (ny - 1) / 2.0
    d_x = (pos[:, 0] - pixel_1_x) / pixel_pitch
    if mirror_x:
        d_x = nx - 1 - d_x
    d_y = (pos[:, 1] - pixel_1_y) / pixel_pitch
    out[:, 0] = d_x
    out[:, 1] = d_y
    return out


def dot_averaged_positions(pos: np.ndarray, rays_per_dot: int,
                           num_dots: Optional[int] = None) -> np.ndarray:
    """NaN-aware mean position of each dot's ray group.

    Rays are ordered dot-major (every dot contributes ``rays_per_dot``
    consecutive rays); culled rays are NaN and excluded from the mean
    (ref: light_ray_processing.py:243-275).
    """
    pos = np.asarray(pos)
    if num_dots is None:
        num_dots = pos.shape[0] // rays_per_dot
    grouped = pos[: num_dots * rays_per_dot].reshape(num_dots, rays_per_dot,
                                                     -1)
    with np.errstate(invalid="ignore"):
        return np.nanmean(grouped, axis=1)


def ray_deflections(pos1: np.ndarray, pos2: np.ndarray,
                    dir1: Optional[np.ndarray] = None,
                    dir2: Optional[np.ndarray] = None) -> Dict:
    """Displacements (and optional direction changes) im2 - im1.

    (ref: light_ray_processing.calculate_lightray_deflections:211-242)
    """
    out = {"delta_pos": np.asarray(pos2) - np.asarray(pos1)}
    if dir1 is not None and dir2 is not None:
        out["delta_dir"] = np.asarray(dir2) - np.asarray(dir1)
    return out


def remove_edge_dots(dot_pos: np.ndarray, values: np.ndarray,
                     nx: int, ny: int, margin: float = 5.0):
    """Drop dots within ``margin`` pixels of the sensor border.

    (ref: light_ray_processing's edge-dot filtering before gridding)
    Returns filtered (dot_pos, values).
    """
    ok = ((dot_pos[:, 0] > margin) & (dot_pos[:, 0] < nx - 1 - margin)
          & (dot_pos[:, 1] > margin) & (dot_pos[:, 1] < ny - 1 - margin)
          & np.isfinite(dot_pos).all(axis=1))
    return dot_pos[ok], values[ok]


def interpolate_to_grid(dot_pos: np.ndarray, values: np.ndarray,
                        grid_x: np.ndarray, grid_y: np.ndarray,
                        method: str = "linear") -> np.ndarray:
    """Scatter -> regular-grid interpolation of per-dot quantities.

    (ref: light_ray_processing's griddata step for displacement maps)
    """
    from scipy.interpolate import griddata

    gx, gy = np.meshgrid(grid_x, grid_y, indexing="xy")
    out = griddata(dot_pos[:, :2], values, (gx, gy), method=method)
    return out


def process_lightray_data(pos_im1: np.ndarray, pos_im2: np.ndarray,
                          rays_per_dot: int, pixel_pitch: float,
                          nx: int, ny: int,
                          num_dots: Optional[int] = None,
                          mirror_x: bool = True) -> Dict:
    """Per-dot BOS displacement extraction from two ray batches.

    The in-memory equivalent of the reference's folder pipeline
    (ref: light_ray_processing.process_lightray_data:532-638): convert ray
    positions to pixels, average each dot's surviving rays, difference the
    two images.

    Returns dict with 'dot_pos_1', 'dot_pos_2' (pixels) and
    'displacement' (pixels, im2 - im1).
    """
    px1 = positions_to_pixels(pos_im1, pixel_pitch, nx, ny, mirror_x)
    px2 = positions_to_pixels(pos_im2, pixel_pitch, nx, ny, mirror_x)
    d1 = dot_averaged_positions(px1, rays_per_dot, num_dots)
    d2 = dot_averaged_positions(px2, rays_per_dot, num_dots)
    return {"dot_pos_1": d1, "dot_pos_2": d2, "displacement": d2 - d1}
