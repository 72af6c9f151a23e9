"""Host-side spectrum models (numpy, scene-build time).

Port of wave_tracer_tpu/spectrum/spectra.py: uniform, piecewise-linear,
binned, blackbody, Gaussian, analytic (an expression of k, λ or f),
RGB (Smits-basis uplift), discrete (weighted Dirac combs), scaled and
composite (wavenumber-binned) spectra, and the complex spectra of
refractive indices (uniform and tabulated; spectrum/ior.py adds the
ITU-R P.2040 materials).
The spectral variable is the wavenumber k = 2π/λ in rad/m; real spectra
are densities over k whose integral is the total power.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from wave_tracer_tpu_torch.core.expr import evaluate
from wave_tracer_tpu_torch.spectrum import cie

TWO_PI = 2.0 * math.pi

K_VISIBLE_MIN = TWO_PI / (830e-9)   # rad/m  (λ = 830 nm)
K_VISIBLE_MAX = TWO_PI / (360e-9)   # rad/m  (λ = 360 nm)


def wavelength_to_wavenumber(lam_m):
    return TWO_PI / np.asarray(lam_m)


def wavenumber_to_wavelength(k):
    return TWO_PI / np.asarray(k)


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

    def mean_wavenumber(self) -> float:
        lo, hi = self.krange()
        k = _sample_grid(lo, hi)
        f = self.eval(k)
        tot = np.trapezoid(f, k)
        if tot <= 0:
            return 0.5 * (lo + hi)
        return float(np.trapezoid(f * k, k) / tot)

    def scaled(self, s: float) -> "Spectrum":
        if s == 1.0:
            return self
        return ScaledSpectrum(self, s)


def _sample_grid(lo: float, hi: float, n: int = 2048) -> np.ndarray:
    """Log-spaced k grid (spectra can span radio..optical decades)."""
    lo = max(lo, 1e-12)
    if hi / lo < 4.0:
        return np.linspace(lo, hi, n)
    return np.geomspace(lo, hi, n)


@dataclass
class ScaledSpectrum(Spectrum):
    base: Spectrum
    scale: float

    @property
    def is_discrete(self):
        return self.base.is_discrete

    def eval(self, k):
        return self.scale * self.base.eval(k)

    def krange(self):
        return self.base.krange()

    def lines(self):
        k, w = self.base.lines()
        return k, self.scale * w


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
class PiecewiseLinearSpectrum(Spectrum):
    """Nodes (k, value), linearly interpolated, zero outside."""
    k_nodes: np.ndarray
    values: np.ndarray

    def __post_init__(self):
        order = np.argsort(self.k_nodes)
        self.k_nodes = np.asarray(self.k_nodes, np.float64)[order]
        self.values = np.asarray(self.values, np.float64)[order]

    def eval(self, k):
        return np.interp(np.asarray(k), self.k_nodes, self.values,
                         left=0.0, right=0.0)

    def krange(self):
        return (float(self.k_nodes[0]), float(self.k_nodes[-1]))

    def power(self):
        return float(np.trapezoid(self.values, self.k_nodes))


@dataclass
class BinnedSpectrum(Spectrum):
    """Piecewise-constant over wavenumber bin edges."""
    k_edges: np.ndarray   # (B+1,) sorted
    values: np.ndarray    # (B,)

    def __post_init__(self):
        self.k_edges = np.asarray(self.k_edges, np.float64)
        self.values = np.asarray(self.values, np.float64)

    def eval(self, k):
        k = np.asarray(k)
        i = np.clip(np.searchsorted(self.k_edges, k, side="right") - 1,
                    0, len(self.values) - 1)
        inside = (k >= self.k_edges[0]) & (k <= self.k_edges[-1])
        return np.where(inside, self.values[i], 0.0)

    def krange(self):
        return (float(self.k_edges[0]), float(self.k_edges[-1]))

    def power(self):
        return float(np.sum(self.values * np.diff(self.k_edges)))


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


@dataclass
class GaussianSpectrum(Spectrum):
    """Gaussian line centred at k0 with std-dev sigma_k (both rad/m) and
    peak value val0 = eval(k0)."""
    k0: float
    sigma_k: float
    val0: float = 1.0

    def eval(self, k):
        k = np.asarray(k)
        return self.val0 * np.exp(-0.5 * ((k - self.k0) / self.sigma_k) ** 2)

    def krange(self):
        return (max(self.k0 - 5 * self.sigma_k, 1e-9),
                self.k0 + 5 * self.sigma_k)

    def power(self):
        return self.val0 * self.sigma_k * math.sqrt(2 * math.pi)


@dataclass
class AnalyticSpectrum(Spectrum):
    """Expression-defined spectrum over [kmin, kmax]; variables: k
    [rad/m], lambda/lam [m], lambda_nm, f [Hz]."""
    expr: str
    kmin: float = K_VISIBLE_MIN
    kmax: float = K_VISIBLE_MAX

    def eval(self, k):
        k = np.atleast_1d(np.asarray(k, np.float64))
        out = np.zeros_like(k)
        for i, kk in enumerate(k.ravel()):
            lam = TWO_PI / kk
            out.ravel()[i] = evaluate(self.expr, {
                "k": kk, "lambda": lam, "lam": lam,
                "lambda_nm": lam * 1e9,
                "f": cie.C_LIGHT / lam})
        inside = (k >= self.kmin) & (k <= self.kmax)
        return np.where(inside, out, 0.0)

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


@dataclass
class CompositeSpectrum(Spectrum):
    """Switch between child spectra by wavenumber bin [kmin, kmax)."""
    bins: list = field(default_factory=list)  # [(kmin, kmax, Spectrum)]

    @property
    def is_discrete(self):
        return all(s.is_discrete for _, _, s in self.bins) and bool(self.bins)

    def eval(self, k):
        k = np.asarray(k, np.float64)
        out = np.zeros_like(k, np.float64)
        for kmin, kmax, s in self.bins:
            m = (k >= kmin) & (k < kmax)
            if m.any():
                out = np.where(m, s.eval(k), out)
        return out

    def lines(self):
        ks, ws = [], []
        for kmin, kmax, s in self.bins:
            if s.is_discrete:
                k, w = s.lines()
                sel = (k >= kmin) & (k < kmax)
                ks.append(k[sel])
                ws.append(w[sel])
        return (np.concatenate(ks) if ks else np.zeros(0),
                np.concatenate(ws) if ws else np.zeros(0))

    def krange(self):
        lo = min(max(kmin, s.krange()[0]) for kmin, kmax, s in self.bins)
        hi = max(min(kmax, s.krange()[1]) for kmin, kmax, s in self.bins)
        return (lo, hi)


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
