"""CIE colourimetry: XYZ matching functions and blackbody radiance.

Port of wave_tracer_tpu/spectrum/cie.py. The CMFs are the multi-lobe
Gaussian analytic fit of Wyman, Sloan & Shirley 2013; `xyz_cmf` takes an
explicit array namespace ``xp``: numpy for host scene-build code, torch
for device code.
"""

from __future__ import annotations

import numpy as np

LAMBDA_MIN_NM = 360.0
LAMBDA_MAX_NM = 830.0


def xyz_cmf(lambda_nm, xp=np):
    """CIE 1931 2-degree colour matching functions (x̄, ȳ, z̄) at λ [nm]."""
    lam = lambda_nm

    def g(mu, s1, s2):
        sig = xp.where(lam < mu, s1, s2)
        return xp.exp(-0.5 * ((lam - mu) / sig) ** 2)

    x = 1.056 * g(599.8, 37.9, 31.0) + 0.362 * g(442.0, 16.0, 26.7) \
        - 0.065 * g(501.1, 20.4, 26.2)
    y = 0.821 * g(568.8, 46.9, 40.5) + 0.286 * g(530.9, 16.3, 31.1)
    z = 1.217 * g(437.0, 11.8, 36.0) + 0.681 * g(459.0, 26.0, 13.8)
    return x, y, z


HBAR = 1.054571817e-34
C_LIGHT = 299792458.0
KBOLTZ = 1.380649e-23


def planck_spectral_radiance_wavenumber(k, T):
    """Blackbody spectral radiance per unit wavenumber B_k(k, T) (host,
    float64): k in rad/m, T in Kelvin, W / (sr · m² · (rad/m))."""
    u = np.minimum(HBAR * C_LIGHT / KBOLTZ * k / T, 700.0)
    expm = np.expm1(u)
    return (HBAR * C_LIGHT ** 2 / (4.0 * np.pi ** 3)) * k ** 3 \
        / np.maximum(expm, 1e-300)
