"""Light-field source generation: PIV particle clouds, BOS dot patterns,
calibration grids.

Replacement for the reference's scene layer (C5/C7 in SURVEY.md):

* PIV particles + Gaussian-sheet radiance —
  ref: run_simulation_02.load_lightfield_data (:774-996)
* sunflower dot fill — ref: calculate_sunflower_coordinates (:999-1054)
* calibration grids — ref: generate_calibration_lightfield_data (:1057-1248)
* BOS dot patterns (random non-overlapping / regular / overlapping) —
  ref: create_non_overlapping_dot_coordinates (:1251-1325),
  generate_bos_lightfield_data (:1328-1551)

Scene synthesis is host-side numpy (it runs once per image and feeds
static-shape device arrays); all physics downstream is JAX.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np

from photon_tpu.config import SimulationConfig
from photon_tpu.models.optics import CameraSetup, rotate_coordinates


@dataclass
class LightfieldSource:
    """A batch of point light sources feeding the renderer."""

    x: np.ndarray                   # (P,) world/camera coords, microns
    y: np.ndarray                   # (P,)
    z: np.ndarray                   # (P,)  (already shifted to z_object frame)
    radiance: np.ndarray            # (P,)
    diameter_index: np.ndarray      # (P,) int — indexes the Mie irradiance table
    z_offset: float                 # z_object - object_distance
    object_distance: float
    lightray_number_per_particle: int
    source_point_number: int = 10000  # particle chunk size per device dispatch

    @property
    def num_particles(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_rays(self) -> int:
        return self.num_particles * int(self.lightray_number_per_particle)


# ---------------------------------------------------------------------------
# Dot fills
# ---------------------------------------------------------------------------


def sunflower_coordinates(grid_point_diameter: float,
                          lightray_number_per_grid_point: float,
                          rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Fill a circle with ~n points on concentric rings + the center point.

    (ref: run_simulation_02.calculate_sunflower_coordinates:999-1054 —
    ring spacing equals the mean nearest-neighbor distance; each ring gets a
    random angular phase.)
    """
    area = np.pi * (grid_point_diameter / 2.0) ** 2
    spacing = np.sqrt(area / lightray_number_per_grid_point)
    n_rings = int(np.round((grid_point_diameter / 2.0) / spacing))
    radii = np.linspace(spacing, grid_point_diameter / 2.0, n_rings)
    rho = 1.0 / spacing

    xs, ys = [], []
    for r in radii:
        count = np.round(rho * (2.0 * np.pi * r))
        if count < 1:
            continue
        theta = (2.0 * np.pi / count) * np.arange(0.0, count - 1) \
            + 2.0 * np.pi * rng.random()
        xs.append(r * np.cos(theta))
        ys.append(r * np.sin(theta))
    xs.append(np.array([0.0]))
    ys.append(np.array([0.0]))
    return np.concatenate(xs), np.concatenate(ys)


def non_overlapping_dot_coordinates(cfg: SimulationConfig,
                                    rng: np.random.Generator) -> np.ndarray:
    """Dart-throwing placement of non-overlapping dot centers.

    (ref: run_simulation_02.create_non_overlapping_dot_coordinates:1251-1325
    — minimum center spacing is 1.5x the diffraction-broadened dot diameter;
    generation stops after max_iter candidate draws.)
    """
    bp = cfg.bos_pattern
    xmin, xmax, ymin, ymax = bp.X_Min, bp.X_Max, bp.Y_Min, bp.Y_Max
    num_dots = int(bp.grid_point_number)
    max_iter = int(5e4)

    d_g = bp.grid_point_diameter
    d_diff = (cfg.camera_design.diffraction_diameter
              if cfg.camera_design.implement_diffraction else 0.0)
    M = cfg.lens_design.focal_length / (
        cfg.lens_design.object_distance - cfg.lens_design.focal_length)
    d_diff_microns = d_diff * cfg.camera_design.pixel_pitch / M
    dot_diameter = np.sqrt(d_g ** 2 + d_diff_microns ** 2)
    threshold = dot_diameter * 1.5

    placed = np.empty((num_dots, 2))
    count = 0
    # draw candidates in vectorized batches; accept greedily in order
    for _ in range(max_iter // 512 + 1):
        if count >= num_dots:
            break
        cand = rng.random((512, 2))
        cx = xmin + dot_diameter / 2 + (xmax - xmin - dot_diameter) * cand[:, 0]
        cy = ymin + dot_diameter / 2 + (ymax - ymin - dot_diameter) * cand[:, 1]
        for j in range(cand.shape[0]):
            if count >= num_dots:
                break
            if count == 0:
                placed[0] = (cx[j], cy[j])
                count = 1
                continue
            d2 = (placed[:count, 0] - cx[j]) ** 2 + (placed[:count, 1] - cy[j]) ** 2
            if d2.min() > threshold * threshold:
                placed[count] = (cx[j], cy[j])
                count += 1
    return placed[:count]


def regular_dot_coordinates(cfg: SimulationConfig) -> np.ndarray:
    """Regular grid of dots with the configured pixel spacing.

    (ref: run_simulation_02.py:1437-1454)
    """
    bp = cfg.bos_pattern
    M = cfg.lens_design.focal_length / (
        cfg.lens_design.object_distance - cfg.lens_design.focal_length)
    spacing = bp.dot_spacing * cfg.camera_design.pixel_pitch / M
    nx = int((bp.X_Max - bp.X_Min) / spacing)
    ny = int((bp.Y_Max - bp.Y_Min) / spacing)
    xv = np.linspace(bp.X_Min, bp.X_Max, nx, endpoint=False)
    yv = np.linspace(bp.Y_Min, bp.Y_Max, ny, endpoint=False)
    X, Y = np.meshgrid(xv, yv, indexing="xy")
    return np.stack([X.ravel(), Y.ravel()], axis=1)


# ---------------------------------------------------------------------------
# BOS scene
# ---------------------------------------------------------------------------


def bos_source(cfg: SimulationConfig, setup: CameraSetup,
               rng: Optional[np.random.Generator] = None
               ) -> Tuple[LightfieldSource, np.ndarray, np.ndarray]:
    """Build the BOS dot-pattern light-field source.

    Returns ``(source, dot_x, dot_y)`` with the dot-center coordinates kept
    for the downstream deflection analysis (the reference saves them to
    positions.mat, ref: run_simulation_02.py:2101-2106).

    (ref: run_simulation_02.generate_bos_lightfield_data:1328-1551)
    """
    if rng is None:
        rng = np.random.default_rng(cfg.seed)
    bp = cfg.bos_pattern
    grid_point_number = int(bp.grid_point_number)
    M = setup.magnification

    if grid_point_number == 1:
        half_px = cfg.camera_design.pixel_pitch / M / 2.0
        dot_x = np.array([bp.X_Min + (bp.X_Max - bp.X_Min) / 2.0 + half_px])
        dot_y = np.array([bp.Y_Min + (bp.Y_Max - bp.Y_Min) / 2.0 + half_px])
    elif bp.dot_overlap:
        u = rng.random(2 * grid_point_number)
        dot_x = bp.X_Min + (bp.X_Max - bp.X_Min) * u[:grid_point_number]
        dot_y = bp.Y_Min + (bp.Y_Max - bp.Y_Min) * u[grid_point_number:]
    elif bp.dot_distribution == "regular":
        coords = regular_dot_coordinates(cfg)
        dot_x, dot_y = coords[:, 0], coords[:, 1]
    else:
        coords = non_overlapping_dot_coordinates(cfg, rng)
        dot_x, dot_y = coords[:, 0], coords[:, 1]

    if bp.grid_point_diameter > 0.0 and bp.particle_number_per_grid_point > 1:
        fx, fy = sunflower_coordinates(bp.grid_point_diameter,
                                       bp.particle_number_per_grid_point, rng)
    else:
        fx, fy = np.array([0.0]), np.array([0.0])

    # every dot center gets the same fill pattern
    x = (dot_x[:, None] + fx[None, :]).ravel()
    y = (dot_y[:, None] + fy[None, :]).ravel()

    z = np.zeros_like(x) + setup.z_object
    if cfg.lens_design.object_distance_buffer is not None:
        z = z + cfg.lens_design.object_distance_buffer

    radiance_value = 10.0 if bp.lightray_radiance is None else bp.lightray_radiance
    radiance = np.full_like(x, radiance_value)

    src = LightfieldSource(
        x=x.astype(np.float32), y=y.astype(np.float32), z=z.astype(np.float32),
        radiance=radiance.astype(np.float64),
        diameter_index=np.zeros(x.shape, dtype=np.int32),
        z_offset=float(setup.z_offset),
        object_distance=float(setup.object_distance),
        lightray_number_per_particle=int(bp.lightray_number_per_particle),
    )
    return src, dot_x, dot_y


# ---------------------------------------------------------------------------
# Calibration scene
# ---------------------------------------------------------------------------


def calibration_source(cfg: SimulationConfig, setup: CameraSetup,
                       plane_index: int,
                       rng: Optional[np.random.Generator] = None
                       ) -> LightfieldSource:
    """Calibration-grid source for one plane.

    (ref: run_simulation_02.generate_calibration_lightfield_data:1057-1248 —
    a grid of sunflower-filled dots plus two quarter-size origin markers at
    (-dx/2, 0) and (0, +dy/2).)
    """
    if rng is None:
        rng = np.random.default_rng(cfg.seed)
    cg = cfg.calibration_grid
    n_planes = int(cg.calibration_plane_number)
    plane_z = cg.calibration_plane_spacing * np.linspace(
        -(n_planes - 1) / 2.0, (n_planes - 1) / 2.0, n_planes)
    z_world = plane_z[plane_index]

    xv = cg.x_grid_point_spacing * np.linspace(
        -(cg.x_grid_point_number - 1) / 2.0, (cg.x_grid_point_number - 1) / 2.0,
        cg.x_grid_point_number)
    yv = cg.y_grid_point_spacing * np.linspace(
        -(cg.y_grid_point_number - 1) / 2.0, (cg.y_grid_point_number - 1) / 2.0,
        cg.y_grid_point_number)

    fx, fy = sunflower_coordinates(cg.grid_point_diameter,
                                   cg.particle_number_per_grid_point, rng)
    X, Y = np.meshgrid(xv, yv, indexing="ij")
    x = (X.ravel()[:, None] + fx[None, :]).ravel()
    y = (Y.ravel()[:, None] + fy[None, :]).ravel()

    # origin markers, quarter diameter / 1/16 the point count
    mx, my = sunflower_coordinates(cg.grid_point_diameter / 4.0,
                                   cg.particle_number_per_grid_point / 16.0, rng)
    x = np.concatenate([x, mx - cg.x_grid_point_spacing / 2.0, mx])
    y = np.concatenate([y, my, my + cg.y_grid_point_spacing / 2.0])

    z = np.full_like(x, z_world)
    x, y, z = rotate_coordinates(x, y, z,
                                 cfg.camera_design.x_camera_angle,
                                 cfg.camera_design.y_camera_angle, 0.0)
    z = z + setup.z_object

    return LightfieldSource(
        x=np.asarray(x, np.float32).ravel(),
        y=np.asarray(y, np.float32).ravel(),
        z=np.asarray(z, np.float32).ravel(),
        radiance=np.ones(x.size, dtype=np.float64),
        diameter_index=np.zeros(x.size, dtype=np.int32),
        z_offset=float(setup.z_offset),
        object_distance=float(setup.object_distance),
        lightray_number_per_particle=int(cg.lightray_number_per_particle),
    )


# ---------------------------------------------------------------------------
# PIV scene
# ---------------------------------------------------------------------------


def piv_source(cfg: SimulationConfig, setup: CameraSetup,
               frame_index: int = 1,
               diameter_index_distribution: Optional[np.ndarray] = None,
               rng: Optional[np.random.Generator] = None,
               particle_xyz: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
               ) -> LightfieldSource:
    """PIV particle-cloud source with Gaussian laser-sheet radiance.

    (ref: run_simulation_02.load_lightfield_data:774-996 — particles are
    loaded from .mat files or drawn uniformly in the configured extent, lit
    by ``R = C / (sigma sqrt(2 pi)) exp(-Z^2 / 2 sigma^2)``, rotated by the
    camera angles and shifted to the object plane.)
    """
    if rng is None:
        rng = np.random.default_rng(cfg.seed + frame_index)
    pf = cfg.particle_field
    n = int(pf.particle_number)

    if particle_xyz is not None:
        X, Y, Z = (np.asarray(a, dtype=np.float64)[:n] for a in particle_xyz)
    elif pf.load_particle_data:
        X, Y, Z = _load_particle_frame(pf, frame_index, n)
    elif n == 1:
        M = setup.magnification
        half_px = cfg.camera_design.pixel_pitch / M / 2.0
        X = np.array([pf.X_Min + (pf.X_Max - pf.X_Min) / 2.0 + half_px])
        Y = np.array([pf.Y_Min + (pf.Y_Max - pf.Y_Min) / 2.0 + half_px])
        Z = np.array([pf.particle_depth if pf.particle_depth is not None else 0.0])
    else:
        X = pf.X_Min + (pf.X_Max - pf.X_Min) * rng.random(n)
        Y = pf.Y_Min + (pf.Y_Max - pf.Y_Min) * rng.random(n)
        Z = pf.Z_Min + (pf.Z_Max - pf.Z_Min) * rng.random(n)

    if pf.perform_mie_scattering:
        irradiance_constant = 500.0
        if diameter_index_distribution is None:
            raise ValueError("Mie scattering requested but no diameter "
                             "index distribution supplied (see ops.mie)")
        diam_idx = np.asarray(diameter_index_distribution[:X.size], np.int32)
    else:
        irradiance_constant = 1e4
        diam_idx = np.zeros(X.size, dtype=np.int32)
    if pf.lightray_radiance is not None:
        irradiance_constant = pf.lightray_radiance

    sigma = pf.gaussian_beam_fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    R = irradiance_constant / (sigma * np.sqrt(2.0 * np.pi)) \
        * np.exp(-(Z ** 2) / (2.0 * sigma ** 2))

    X, Y, Z = rotate_coordinates(X, Y, Z,
                                 cfg.camera_design.x_camera_angle,
                                 cfg.camera_design.y_camera_angle, 0.0)
    Z = Z + setup.z_object

    return LightfieldSource(
        x=np.asarray(X, np.float32).ravel(),
        y=np.asarray(Y, np.float32).ravel(),
        z=np.asarray(Z, np.float32).ravel(),
        radiance=np.asarray(R, np.float64).ravel(),
        diameter_index=diam_idx.ravel(),
        z_offset=float(setup.z_offset),
        object_distance=float(setup.object_distance),
        lightray_number_per_particle=int(pf.lightray_number_per_particle),
    )


def _load_particle_frame(pf, frame_index: int, n: int):
    """Load particle X/Y/Z from the frame_index'th .mat file in the data dir.

    (ref: run_simulation_02.py:881-910)
    """
    import glob
    import os
    import scipy.io as sio

    files = sorted(glob.glob(os.path.join(pf.data_directory,
                                          pf.data_filename_prefix + "*.mat")))
    path = files[frame_index - 1]
    d = sio.loadmat(path, squeeze_me=True)
    return (np.asarray(d["X"]).ravel()[:n], np.asarray(d["Y"]).ravel()[:n],
            np.asarray(d["Z"]).ravel()[:n])


def bos_image_source(cfg: SimulationConfig, setup: CameraSetup,
                     image,
                     x_range: Optional[Tuple[float, float]] = None,
                     y_range: Optional[Tuple[float, float]] = None,
                     ) -> LightfieldSource:
    """Image-driven BOS target: every nonzero pixel emits a source point.

    (ref: run_simulation_02.generate_bos_image_lightfield_data:1554-1696 —
    the reference reads a grayscale PNG via matplotlib and keeps channel
    0; here ``image`` may be a 2-D grayscale array or a path to a .png
    (utils.png_io, matching the reference's input) or .tif file.
    Coordinate conventions match: columns are mirrored into x, rows
    descend from Y_Max, pixel intensity becomes radiance.)
    """
    bp = cfg.bos_pattern
    x_min, x_max = x_range or (bp.X_Min, bp.X_Max)
    y_min, y_max = y_range or (bp.Y_Min, bp.Y_Max)
    if isinstance(image, (str, bytes)):
        path = str(image)
        if path.lower().endswith(".png"):
            from photon_tpu.utils.png_io import read_png
            image = read_png(path)
        else:
            from photon_tpu.utils.tiff_io import read_tiff16
            image = read_tiff16(path)
    img = np.asarray(image)
    height, width = img.shape
    pixel_width = (x_max - x_min) / width

    rows, cols = np.nonzero(img > 0)
    x = x_min + (width - cols) * pixel_width + pixel_width / 2.0
    y = y_max - (rows * pixel_width + pixel_width / 2.0)
    radiance = img[rows, cols].astype(np.float64)

    z = np.zeros_like(x)
    x, y, z = rotate_coordinates(x, y, z,
                                 cfg.camera_design.x_camera_angle,
                                 cfg.camera_design.y_camera_angle, 0.0)
    z = np.asarray(z).ravel() + setup.z_object

    return LightfieldSource(
        x=np.asarray(x, np.float32).ravel(),
        y=np.asarray(y, np.float32).ravel(),
        z=z.astype(np.float32),
        radiance=radiance,
        diameter_index=np.zeros(x.size, dtype=np.int32),
        z_offset=float(setup.z_offset),
        object_distance=float(setup.object_distance),
        lightray_number_per_particle=int(bp.lightray_number_per_particle),
        source_point_number=min(10000, int(x.size)),
    )


def displace_source(src: LightfieldSource, dx: float = 0.0, dy: float = 0.0,
                    dz: float = 0.0) -> LightfieldSource:
    """Uniformly displace a source (frame-pair generation for PIV/BOS)."""
    return replace(src, x=src.x + np.float32(dx), y=src.y + np.float32(dy),
                   z=src.z + np.float32(dz))
