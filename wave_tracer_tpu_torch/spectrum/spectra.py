"""Host-side spectrum models (numpy, scene-build time).

Port of wave_tracer_tpu/spectrum/spectra.py for the spectra the ported
scenes use: uniform, blackbody, RGB (Smits-basis uplift) and discrete
(weighted Dirac combs), and the complex spectra of refractive indices
(uniform and tabulated; spectrum/ior.py adds the ITU-R P.2040 materials).
The spectral variable is the wavenumber k = 2π/λ in rad/m; real spectra
are densities over k whose integral is the total power.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from wave_tracer_tpu_torch.spectrum import cie

TWO_PI = 2.0 * math.pi

K_VISIBLE_MIN = TWO_PI / (830e-9)   # rad/m  (λ = 830 nm)
K_VISIBLE_MAX = TWO_PI / (360e-9)   # rad/m  (λ = 360 nm)


class Spectrum:
    """Base: a real spectral density over wavenumber k [rad/m]."""
    is_discrete: bool = False

    def eval(self, k: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def krange(self) -> tuple[float, float]:
        raise NotImplementedError

    def power(self) -> float:
        lo, hi = self.krange()
        if not np.isfinite(lo) or not np.isfinite(hi) or hi <= lo:
            return 0.0
        k = _sample_grid(lo, hi)
        return float(np.trapezoid(self.eval(k), k))


def _sample_grid(lo: float, hi: float, n: int = 2048) -> np.ndarray:
    """Log-spaced k grid (spectra can span radio..optical decades)."""
    lo = max(lo, 1e-12)
    if hi / lo < 4.0:
        return np.linspace(lo, hi, n)
    return np.geomspace(lo, hi, n)


@dataclass
class UniformSpectrum(Spectrum):
    """Constant density over a wavenumber range."""
    value: float
    kmin: float = K_VISIBLE_MIN
    kmax: float = K_VISIBLE_MAX

    def eval(self, k):
        k = np.asarray(k)
        return np.where((k >= self.kmin) & (k <= self.kmax), self.value, 0.0)

    def krange(self):
        return (self.kmin, self.kmax)

    def power(self):
        return self.value * (self.kmax - self.kmin)


@dataclass
class BlackbodySpectrum(Spectrum):
    """Planck radiator at temperature T [K] with a scale factor."""
    T: float
    scale: float = 1.0
    kmin: float = K_VISIBLE_MIN
    kmax: float = K_VISIBLE_MAX

    def eval(self, k):
        k = np.asarray(k, np.float64)
        v = cie.planck_spectral_radiance_wavenumber(k, self.T)
        return self.scale * np.where((k >= self.kmin) & (k <= self.kmax),
                                     v, 0.0)

    def krange(self):
        return (self.kmin, self.kmax)


# Smits' basis over 380..720 nm, 10 bins.
_SMITS_LAM = (380.0, 720.0)
_SMITS = {
    "white":   [1.0000, 1.0000, 0.9999, 0.9993, 0.9992, 0.9998, 1.0000,
                1.0000, 1.0000, 1.0000],
    "cyan":    [0.9710, 0.9426, 1.0007, 1.0007, 1.0007, 1.0007, 0.1564,
                0.0000, 0.0000, 0.0000],
    "magenta": [1.0000, 1.0000, 0.9685, 0.2229, 0.0000, 0.0458, 0.8369,
                1.0000, 1.0000, 0.9959],
    "yellow":  [0.0001, 0.0000, 0.1088, 0.6651, 1.0000, 1.0000, 0.9996,
                0.9586, 0.9685, 0.9840],
    "red":     [0.1012, 0.0515, 0.0000, 0.0000, 0.0000, 0.0000, 0.8325,
                1.0149, 1.0149, 1.0149],
    "green":   [0.0000, 0.0000, 0.0273, 0.7937, 1.0000, 0.9418, 0.1719,
                0.0000, 0.0000, 0.0025],
    "blue":    [1.0000, 1.0000, 0.8916, 0.3323, 0.0000, 0.0000, 0.0003,
                0.0369, 0.0483, 0.0496],
}


def smits_uplift(rgb: Sequence[float], lambda_nm: np.ndarray) -> np.ndarray:
    """Smits-basis RGB→spectral reflectance at λ [nm] (vectorized)."""
    lo, hi = _SMITS_LAM
    lam = np.asarray(lambda_nm, np.float64)
    b = np.clip(((lam - lo) / (hi - lo) * 10).astype(np.int64), 0, 9)
    inside = (lam >= lo) & (lam <= hi)
    S = {n: np.asarray(v)[b] for n, v in _SMITS.items()}
    r, g, bl = float(rgb[0]), float(rgb[1]), float(rgb[2])
    if r <= g and r <= bl:
        out = S["white"] * r
        if g <= bl:
            out = out + S["cyan"] * (g - r) + S["blue"] * (bl - g)
        else:
            out = out + S["cyan"] * (bl - r) + S["green"] * (g - bl)
    elif g <= r and g <= bl:
        out = S["white"] * g
        if r <= bl:
            out = out + S["magenta"] * (r - g) + S["blue"] * (bl - r)
        else:
            out = out + S["magenta"] * (bl - g) + S["red"] * (r - bl)
    else:
        out = S["white"] * bl
        if r <= g:
            out = out + S["yellow"] * (r - bl) + S["green"] * (g - r)
        else:
            out = out + S["yellow"] * (g - bl) + S["red"] * (r - g)
    return np.where(inside, out, 0.0)


@dataclass
class RGBSpectrum(Spectrum):
    """Reflectance/emission given as an RGB triplet, uplifted to spectral."""
    rgb: tuple

    def eval(self, k):
        lam_nm = TWO_PI / np.asarray(k) * 1e9
        return smits_uplift(self.rgb, lam_nm)

    def krange(self):
        return (TWO_PI / (_SMITS_LAM[1] * 1e-9),
                TWO_PI / (_SMITS_LAM[0] * 1e-9))


@dataclass
class DiscreteSpectrum(Spectrum):
    """Weighted Dirac comb: lines at k_i with per-line power w_i."""
    k_lines: np.ndarray
    weights: np.ndarray
    is_discrete = True

    def __post_init__(self):
        self.k_lines = np.atleast_1d(np.asarray(self.k_lines, np.float64))
        self.weights = np.atleast_1d(np.asarray(self.weights, np.float64))

    def eval(self, k):
        return np.zeros_like(np.asarray(k, np.float64))

    def lines(self):
        return self.k_lines, self.weights

    def krange(self):
        return (float(self.k_lines.min()), float(self.k_lines.max()))

    def power(self):
        return float(self.weights.sum())

    def mean_wavenumber(self):
        return float(np.sum(self.k_lines * self.weights)
                     / max(self.weights.sum(), 1e-300))


# ---------------------------------------------------------------------------
# complex spectra (refractive indices)
# ---------------------------------------------------------------------------

class ComplexSpectrum:
    """A complex-valued function of wavenumber (IOR η = n + iκ)."""

    def eval(self, k: np.ndarray) -> np.ndarray:  # complex128
        raise NotImplementedError


@dataclass
class ComplexUniformSpectrum(ComplexSpectrum):
    """Constant complex IOR."""
    value: complex

    def eval(self, k):
        return np.full(np.shape(np.asarray(k)), self.value, np.complex128)


@dataclass
class ComplexTabulatedSpectrum(ComplexSpectrum):
    """Tabulated n, κ against wavenumber, linearly interpolated."""
    k_nodes: np.ndarray    # sorted ascending
    n: np.ndarray
    kappa: np.ndarray

    def __post_init__(self):
        order = np.argsort(self.k_nodes)
        self.k_nodes = np.asarray(self.k_nodes, np.float64)[order]
        self.n = np.asarray(self.n, np.float64)[order]
        self.kappa = np.asarray(self.kappa, np.float64)[order]

    def eval(self, k):
        k = np.asarray(k, np.float64)
        n = np.interp(k, self.k_nodes, self.n)
        kap = np.interp(k, self.k_nodes, self.kappa)
        return n + 1j * kap
