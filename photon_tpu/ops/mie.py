"""Mie scattering: Bohren-Huffman series, particle-size statistics, and the
per-diameter irradiance table.

Replacement for the reference's Mie layer (C5/C6 in SURVEY.md):

* ``bhmie`` — ref: python_codes/bhmie.py:3-173 (itself a port of the
  Bohren & Huffman book code).  Reimplemented here as a vectorized
  clean-room version of the standard B&H recurrences, computing all
  size parameters in one batch.
* log-normal particle-diameter statistics — ref: run_simulation_02.py
  log_normal_pdf (:446-468) through calculate_particle_diameter_indices
  (:597-638)
* scattering-table assembly — ref: calculate_mie_scattering_intensity
  (:641-696), create_mie_scattering_data (:699-771)

This is per-simulation setup (a (2*nang-1, n_diameters) table), so it runs
host-side in float64 numpy; the renderer consumes the finished table on
device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.special import erf as _erf

from photon_tpu.config import SimulationConfig
from photon_tpu.models.optics import rotation_matrix


# ---------------------------------------------------------------------------
# Bohren–Huffman Mie series
# ---------------------------------------------------------------------------


def bhmie(x: float, refrel: complex, nang: int):
    """Mie scattering amplitudes and efficiencies for one size parameter.

    Standard Bohren & Huffman formulation: logarithmic-derivative downward
    recurrence for D_n, upward Riccati-Bessel recurrence for psi/chi, and
    the angular functions pi_n/tau_n accumulated over ``nstop`` terms.

    Args:
      x: size parameter 2*pi*r*n_medium/lambda.
      refrel: relative refractive index (particle/medium).
      nang: number of angles in [0, pi/2]; S1/S2 are returned on the
        mirrored grid of 2*nang-1 angles in [0, pi].

    Returns:
      (s1, s2, qext, qsca, qback, gsca) with s1/s2 complex arrays of
      length 2*nang-1.
    """
    nang = max(int(nang), 2)
    y = x * refrel
    nstop = int(x + 4.0 * x ** (1.0 / 3.0) + 2.0)
    nmx = int(max(nstop, abs(y)) + 15.0)

    # logarithmic derivative by downward recurrence
    d = np.zeros(nmx + 1, dtype=np.complex128)
    for n in range(nmx, 0, -1):
        en = float(n)
        d[n - 1] = (en / y) - 1.0 / (d[n] + en / y)

    amu = np.cos(0.5 * np.pi / (nang - 1) * np.arange(nang))

    pi0 = np.zeros(nang)
    pi1 = np.ones(nang)
    s1_fwd = np.zeros(nang, dtype=np.complex128)   # angles 0..90
    s1_bwd = np.zeros(nang, dtype=np.complex128)   # mirrored 90..180
    s2_fwd = np.zeros(nang, dtype=np.complex128)
    s2_bwd = np.zeros(nang, dtype=np.complex128)

    psi0, psi1 = np.cos(x), np.sin(x)
    chi0, chi1 = -np.sin(x), np.cos(x)
    xi1 = psi1 - 1j * chi1
    qsca = 0.0
    gsca = 0.0
    p = -1.0
    an_prev = bn_prev = 0.0 + 0.0j

    for n in range(1, nstop + 1):
        en = float(n)
        fn = (2.0 * en + 1.0) / (en * (en + 1.0))
        psi = (2.0 * en - 1.0) * psi1 / x - psi0
        chi = (2.0 * en - 1.0) * chi1 / x - chi0
        xi = psi - 1j * chi

        an = ((d[n] / refrel + en / x) * psi - psi1) \
            / ((d[n] / refrel + en / x) * xi - xi1)
        bn = ((refrel * d[n] + en / x) * psi - psi1) \
            / ((refrel * d[n] + en / x) * xi - xi1)

        qsca += (2.0 * en + 1.0) * (abs(an) ** 2 + abs(bn) ** 2)
        gsca += fn * (an.real * bn.real + an.imag * bn.imag)
        if n > 1:
            gsca += ((en - 1.0) * (en + 1.0) / en) * (
                an_prev.real * an.real + an_prev.imag * an.imag
                + bn_prev.real * bn.real + bn_prev.imag * bn.imag)

        pi_n = pi1.copy()
        tau = en * amu * pi_n - (en + 1.0) * pi0
        s1_fwd += fn * (an * pi_n + bn * tau)
        s2_fwd += fn * (an * tau + bn * pi_n)
        p = -p
        s1_bwd += fn * p * (an * pi_n - bn * tau)
        s2_bwd += fn * p * (bn * pi_n - an * tau)

        psi0, psi1 = psi1, psi
        chi0, chi1 = chi1, chi
        xi1 = psi1 - 1j * chi1
        an_prev, bn_prev = an, bn

        pi1 = ((2.0 * en + 1.0) * amu * pi_n - (en + 1.0) * pi0) / en
        pi0 = pi_n

    s1 = np.concatenate([s1_fwd, s1_bwd[-2::-1]])
    s2 = np.concatenate([s2_fwd, s2_bwd[-2::-1]])
    gsca = 2.0 * gsca / qsca
    qsca = (2.0 / (x * x)) * qsca
    qext = (4.0 / (x * x)) * s1[0].real
    qback = 4.0 * (abs(s1[-1]) / x) ** 2
    return s1, s2, qext, qsca, qback, gsca


# ---------------------------------------------------------------------------
# Log-normal particle-size statistics
# ---------------------------------------------------------------------------


def log_normal_pdf(x, mu, sigma):
    """(ref: run_simulation_02.log_normal_pdf:446-468)"""
    x = np.asarray(x, dtype=np.float64)
    return (1.0 / (x * sigma * np.sqrt(2.0 * np.pi))
            * np.exp(-(np.log(x) - mu) ** 2 / (2.0 * sigma ** 2)))


def log_normal_cdf(x, mu, sigma):
    """(ref: run_simulation_02.log_normal_cdf:486-493)"""
    return (1.0 + _erf((np.log(x) - mu) / (sigma * np.sqrt(2.0)))) / 2.0


def _inverse_log_normal_pdf(y, mu, sigma):
    """The two x with pdf(x) = y (ref: :471-483)."""
    root = sigma * np.sqrt(sigma ** 2 - 2.0 * mu
                           - 2.0 * np.log(y * sigma * np.sqrt(2.0 * np.pi)))
    return (np.exp(mu - sigma ** 2 - root), np.exp(mu - sigma ** 2 + root))


def log_normal_pdf_extrema(mu: float, sigma: float, t: float,
                           max_iter: int = 200) -> Tuple[float, float]:
    """Solve for (x_min, x_max) with equal pdf and tail mass t outside.

    Newton iteration identical in structure to the reference
    (ref: calculate_log_normal_pdf_extrema:496-538).
    """
    x_max = np.exp(mu + sigma)
    for _ in range(max_iter):
        y = log_normal_pdf(x_max, mu, sigma)
        x_min, x_max = _inverse_log_normal_pdf(y, mu, sigma)
        f = 1.0 - (log_normal_cdf(x_max, mu, sigma)
                   - log_normal_cdf(x_min, mu, sigma)) - t
        dxmin_dxmax = -np.exp(2.0 * mu - 2.0 * sigma ** 2) / x_max ** 2
        fprime = log_normal_pdf(x_min, mu, sigma) * dxmin_dxmax \
            - log_normal_pdf(x_max, mu, sigma)
        dx = f / fprime
        if abs(dx) < np.finfo(float).eps * 1e2:
            break
        x_max = x_max - dx
    return float(x_min), float(x_max)


def particle_diameter_distribution(cfg: SimulationConfig):
    """Discrete diameter grid + normalized pdf weights.

    (ref: calculate_particle_diameter_distribution:541-594)
    """
    pf = cfg.particle_field
    mean, std = pf.particle_diameter_mean, pf.particle_diameter_std
    mu = np.log(mean) - 0.5 * np.log(1.0 + (std / mean) ** 2)
    sigma = np.sqrt(np.log(1.0 + (std / mean) ** 2))
    dmin, dmax = log_normal_pdf_extrema(mu, sigma,
                                        pf.particle_diameter_cdf_threshhold)
    n = int(pf.particle_diameter_number)
    spacing = (dmax - dmin) / n
    diameters = dmin + spacing * (np.arange(n) + 0.5)
    pdf = log_normal_pdf(diameters, mu, sigma)
    return diameters, pdf / pdf.sum()


def particle_diameter_indices(cfg: SimulationConfig, pdf: np.ndarray,
                              rng: np.random.Generator) -> np.ndarray:
    """Sample a diameter index per particle from the discrete pdf.

    (ref: calculate_particle_diameter_indices:597-638 — inverse-CDF
    bucketing of uniforms; note the reference leaves particles falling in
    the final CDF bucket at the previous index, reproduced by clipping.)
    """
    n_particles = int(cfg.particle_field.particle_number)
    cdf = np.concatenate([[0.0], np.cumsum(pdf)])
    u = rng.random(n_particles)
    idx = np.searchsorted(cdf, u, side="right") - 1
    return np.clip(idx, 0, len(pdf) - 2).astype(np.int32)


# ---------------------------------------------------------------------------
# Scattering-table assembly
# ---------------------------------------------------------------------------


def mie_scattering_irradiance(cfg: SimulationConfig,
                              diameters: np.ndarray):
    """s11 irradiance table over (2*nang-1 angles, n_diameters).

    Follows the reference's quirk of passing the particle *diameter* as the
    radius in the size parameter (ref: calculate_mie_scattering_intensity
    :670-688 — ``current_particle_radius`` is assigned the diameter).

    Returns (scattering_angle, scattering_irradiance).
    """
    pf = cfg.particle_field
    nang = int(pf.mie_scattering_angle_number)
    refrel = pf.particle_refractive_index / pf.medium_refractive_index
    n_rows = 2 * nang - 1
    table = np.zeros((n_rows, len(diameters)))
    for j, diameter in enumerate(diameters):
        x = 2.0 * np.pi * diameter * pf.medium_refractive_index \
            / pf.beam_wavelength
        s1, s2, *_ = bhmie(x, refrel, nang)
        table[:, j] = 0.5 * (np.abs(s1) ** 2 + np.abs(s2) ** 2)
    dang = 0.5 * np.pi / (nang - 1)
    angles = np.arange(n_rows) * dang
    return angles, table


def create_mie_scattering_data(cfg: SimulationConfig,
                               rng: np.random.Generator) -> Dict:
    """Full Mie setup bundle for the PIV renderer.

    (ref: create_mie_scattering_data:699-771)
    """
    diameters, pdf = particle_diameter_distribution(cfg)
    diameter_idx = particle_diameter_indices(cfg, pdf, rng)
    angles, table = mie_scattering_irradiance(cfg, diameters)
    rot = rotation_matrix(cfg.camera_design.x_camera_angle,
                          cfg.camera_design.y_camera_angle, 0.0)
    beam = np.asarray(cfg.particle_field.beam_propogation_vector, float)
    beam = beam / np.linalg.norm(beam)
    return {
        "particle_diameter_vector": diameters,
        "particle_diameter_pdf": pdf,
        "particle_diameter_index_distribution": diameter_idx,
        "scattering_angle": angles,
        "scattering_irradiance": table,
        "inverse_rotation_matrix": rot.T,
        "beam_propogation_vector": beam,
    }
