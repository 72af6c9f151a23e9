"""CIE colourimetry: XYZ matching functions, RGB colourspaces, blackbodies.

Port of wave_tracer_tpu/spectrum/cie.py. The CMFs are the multi-lobe
Gaussian analytic fit of Wyman, Sloan & Shirley 2013; `xyz_cmf` takes an
explicit array namespace ``xp``: numpy for host scene-build code, torch
for device code. The RGB colourspaces (primaries and whitepoints) give the
XYZ→RGB matrix that develops an RGB sensor's XYZ film.
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


# xy chromaticities of standard whitepoints.
WHITEPOINTS = {
    "A": (0.44758, 0.40745),
    "B": (0.34842, 0.35161),
    "C": (0.31006, 0.31616),
    "D50": (0.34567, 0.35850),
    "D55": (0.33243, 0.34744),
    "D65": (0.31272, 0.32903),
    "D75": (0.29903, 0.31488),
    "E": (1.0 / 3.0, 1.0 / 3.0),
}

# RGB primaries (xy) per colourspace.
PRIMARIES = {
    "CIE": ((0.7347, 0.2653), (0.2738, 0.7174), (0.1666, 0.0089)),
    "sRGB": ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06)),
    "AdobeRGB": ((0.64, 0.33), (0.21, 0.71), (0.15, 0.06)),
}


def _xy_to_XYZ(xy):
    x, y = xy
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


def xyz_to_rgb_matrix(colourspace: str = "sRGB",
                      white_point: str = "D65") -> np.ndarray:
    """3x3 matrix M with RGB = M @ XYZ for the given primaries/whitepoint."""
    rx, gx, bx = PRIMARIES[colourspace]
    P = np.stack([_xy_to_XYZ(rx), _xy_to_XYZ(gx), _xy_to_XYZ(bx)], axis=1)
    W = _xy_to_XYZ(WHITEPOINTS[white_point])
    S = np.linalg.solve(P, W)
    return np.linalg.inv(P * S[None, :])


def rgb_to_xyz_matrix(colourspace: str = "sRGB",
                      white_point: str = "D65") -> np.ndarray:
    return np.linalg.inv(xyz_to_rgb_matrix(colourspace, white_point))


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


def planckian_locus_xyz(T: float) -> np.ndarray:
    """XYZ colour of a blackbody radiator at temperature T (normalized Y=1)."""
    lam = np.linspace(380.0, 780.0, 401)
    k = 2.0 * np.pi / (lam * 1e-9)
    B = planck_spectral_radiance_wavenumber(k, T)
    x, y, z = xyz_cmf(lam)
    # integrate over wavelength; dk ∝ dλ/λ² (proportionality suffices)
    w = B * k / lam
    X = np.trapezoid(w * x, lam)
    Y = np.trapezoid(w * y, lam)
    Z = np.trapezoid(w * z, lam)
    return np.array([X, Y, Z]) / max(Y, 1e-300)
