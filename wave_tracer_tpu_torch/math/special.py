"""Special functions for wave optics: the Faddeeva function and the UTD
transition function.

Port of wave_tracer_tpu/math/special.py (`faddeeva`, `faddeeva_any`,
`erfc_complex`, `erf_complex`, `fresnel_cs`, `utd_transition`).
w(z) is Weideman's rational approximation (J.A.C. Weideman, "Computation
of the Complex Error Function", SIAM J. Numer. Anal. 31 (1994)
1497-1518): one fixed-degree polynomial in the Möbius-transformed
variable, branch-free. The coefficients are built with numpy's FFT at
import, exactly as the JAX module builds them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_N = 32


def _weideman_coeffs(N: int = _N):
    """Polynomial coefficients of the Weideman expansion (host, once)."""
    M = 2 * N
    M2 = 2 * M
    L = math.sqrt(N / math.sqrt(2.0))
    k = np.arange(-M + 1, M)
    theta = k * math.pi / M
    t = L * np.tan(theta / 2.0)
    f = np.exp(-t * t) * (L * L + t * t)
    f = np.concatenate([[0.0], f])
    a = np.fft.fft(np.fft.fftshift(f)).real / M2
    a = np.flipud(a[1:N + 1])
    return L, a


_L, _A = _weideman_coeffs()
# the JAX module adds each coefficient to a complex64 array, which rounds
# it to f32 first
_A32 = [float(np.float32(a)) for a in _A]
_ROT = complex(np.complex64(np.exp(3j * np.pi / 4)))


def faddeeva(z):
    """w(z) for Im(z) ≥ 0 (Weideman 1994). complex64 in and out."""
    L = _L
    iz = 1j * z
    Zm = (L + iz) / (L - iz)
    p = torch.zeros_like(z)
    for ak in _A32:                     # Horner
        p = p * Zm + ak
    denom = L - iz
    return 2.0 * p / (denom * denom) + (1.0 / math.sqrt(math.pi)) / denom


def faddeeva_any(z):
    """w(z) on the whole plane: for Im z < 0, w(z) = 2·e^{−z²} − w(−z)."""
    upper = z.imag >= 0
    wu = faddeeva(torch.where(upper, z, -z))
    wl = 2.0 * torch.exp(-(z * z)) - wu
    return torch.where(upper, wu, wl)


def erfc_complex(z):
    """erfc(z) = e^{−z²}·w(iz)."""
    return torch.exp(-(z * z)) * faddeeva_any(1j * z)


def erf_complex(z):
    return 1.0 - erfc_complex(z)


def fresnel_cs(t):
    """Fresnel integrals C(t), S(t) = ∫₀ᵗ cos/sin(π u²/2) du of real t,
    by C + iS = (1 + i)/2 · erf(√π/2 · (1 − i)·t). Returns (C, S)."""
    t = torch.as_tensor(t)
    zc = (math.sqrt(math.pi) / 2.0) * (1.0 - 1.0j) * t.to(torch.complex64)
    cs = (1.0 + 1.0j) / 2.0 * erf_complex(zc)
    return cs.real, cs.imag


def utd_transition(x):
    """The UTD transition function F(x) (f32 in, complex64 out):
    F(x) = (1+i)·√(π/2)·√x·w(√x·e^{i3π/4}) for x ≥ 0, and conj(F(|x|))
    for x < 0."""
    sq = torch.sqrt(x.abs())
    zrot = sq.to(torch.complex64) * _ROT
    F = (1.0 + 1.0j) * math.sqrt(math.pi / 2.0) * sq * faddeeva(zrot)
    return torch.where(x < 0, torch.conj(F), F)
