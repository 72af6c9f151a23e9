"""Device-side spectral tables.

Port of wave_tracer_tpu/spectrum/bake.py. Host `Spectrum` objects bake at
scene-build time into flat numpy arrays (one log-spaced wavenumber grid
per spectrum); on the device a lookup is one gather pair plus a lerp. A
discrete spectrum bakes its line weights into the grid cells around each
line, so a lookup at a sampled line returns its weight. Complex spectra
(refractive indices) bake n and κ the same way (`bake_complex`), and
`ComplexSpectrumTable.eval` returns η = n + iκ as complex64. Also the
device evaluation of response sensitivities (CIE CMFs, Smits RGB uplift)
as elementwise torch math.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from wave_tracer_tpu_torch.spectrum import cie
from wave_tracer_tpu_torch.spectrum.spectra import (ComplexSpectrum, Spectrum,
                                                    _SMITS, _SMITS_LAM,
                                                    TWO_PI)

K_RES = 192   # grid points per baked spectrum


@dataclass
class SpectrumTable:
    """Baked real spectra: row s covers [kmin[s], kmax[s]] log-spaced."""
    vals: torch.Tensor      # (S, K_RES) f32 density values
    log_kmin: torch.Tensor  # (S,)
    log_kmax: torch.Tensor  # (S,)

    def eval(self, sid, k):
        """Density of spectrum sid (...,) int at wavenumber k (...,)."""
        sid = sid.clamp_min(0).long()
        lk = torch.log(k.clamp_min(1e-30))
        lo = self.log_kmin[sid]
        hi = self.log_kmax[sid]
        t = (lk - lo) / (hi - lo).clamp_min(1e-12) * (K_RES - 1)
        inside = (t >= 0.0) & (t <= K_RES - 1.0)
        t = t.clamp(0.0, K_RES - 1.0)
        i0 = t.long().clamp(0, K_RES - 2)
        frac = t - i0.to(t.dtype)
        v0 = self.vals[sid, i0]
        v1 = self.vals[sid, i0 + 1]
        return torch.where(inside, v0 * (1.0 - frac) + v1 * frac,
                           torch.zeros_like(t))


def _grid_index(log_kmin, log_kmax, cid, k):
    """(row, cell, frac) of wavenumber k (...,) in row cid's log grid,
    clamped to the grid's ends."""
    cid = cid.clamp_min(0).long()
    lk = torch.log(k.clamp_min(1e-30))
    lo = log_kmin[cid]
    hi = log_kmax[cid]
    t = ((lk - lo) / (hi - lo).clamp_min(1e-12) * (K_RES - 1)).clamp(
        0.0, K_RES - 1.0)
    i0 = t.to(torch.int32).clamp(0, K_RES - 2).long()
    return cid, i0, t - i0.to(t.dtype)


@dataclass
class ComplexSpectrumTable:
    """Baked complex IOR spectra η(k) = n + iκ, row c log-spaced over
    [kmin[c], kmax[c]] and clamped to its ends."""
    n: torch.Tensor         # (C, K_RES)
    kappa: torch.Tensor     # (C, K_RES)
    log_kmin: torch.Tensor  # (C,)
    log_kmax: torch.Tensor  # (C,)

    def eval(self, cid, k):
        """η of row cid (...,) int at wavenumber k (...,) → complex64."""
        cid, i0, frac = _grid_index(self.log_kmin, self.log_kmax, cid, k)
        n = self.n[cid, i0] * (1 - frac) + self.n[cid, i0 + 1] * frac
        kap = self.kappa[cid, i0] * (1 - frac) \
            + self.kappa[cid, i0 + 1] * frac
        return torch.complex(n, kap)


def bake_spectra(specs: list[Spectrum]) -> dict:
    """Host bake → {"vals", "log_kmin", "log_kmax"} numpy arrays."""
    S = max(len(specs), 1)
    vals = np.zeros((S, K_RES), np.float32)
    lo = np.zeros(S, np.float32)
    hi = np.ones(S, np.float32)
    for i, s in enumerate(specs):
        kmin, kmax = s.krange()
        kmin = max(kmin, 1e-9)
        kmax = max(kmax, kmin * (1 + 1e-6))
        if s.is_discrete:
            # line WEIGHTS, not densities: a lookup at a sampled line
            # returns w_i, which the line pmf of the sampler cancels
            kmin = kmin * (1.0 - 1e-3)
            kmax = kmax * (1.0 + 1e-3)
            grid = np.geomspace(kmin, kmax, K_RES)
            row = np.zeros(K_RES)
            for kl, wl in zip(*s.lines()):
                j = np.searchsorted(grid, kl)
                row[max(j - 1, 0)] = max(row[max(j - 1, 0)], wl)
                row[min(j, K_RES - 1)] = max(row[min(j, K_RES - 1)], wl)
            vals[i] = row
        else:
            grid = np.geomspace(kmin, kmax, K_RES)
            vals[i] = s.eval(grid)
        lo[i] = np.log(kmin)
        hi[i] = np.log(kmax)
    return dict(vals=vals, log_kmin=lo, log_kmax=hi)


def bake_complex(specs: list[ComplexSpectrum],
                 k_hint: tuple[float, float] = (1.0, 3e7)) -> dict:
    """Host bake of complex spectra → {"n", "kappa", "log_kmin",
    "log_kmax"} numpy arrays: a tabulated spectrum over its own nodes'
    range, any other over `k_hint` (radio to optical wavenumbers)."""
    C = max(len(specs), 1)
    n = np.ones((C, K_RES), np.float32)
    kap = np.zeros((C, K_RES), np.float32)
    lo = np.zeros(C, np.float32)
    hi = np.ones(C, np.float32)
    for i, s in enumerate(specs):
        kmin, kmax = k_hint
        if hasattr(s, "k_nodes"):
            kmin, kmax = float(s.k_nodes[0]), float(s.k_nodes[-1])
        kmin = max(kmin, 1e-9)
        grid = np.geomspace(kmin, kmax, K_RES)
        eta = s.eval(grid)
        n[i] = np.real(eta)
        kap[i] = np.imag(eta)
        lo[i] = np.log(kmin)
        hi[i] = np.log(kmax)
    return dict(n=n, kappa=kap, log_kmin=lo, log_kmax=hi)


_SMITS_NP = np.stack([
    _SMITS["white"], _SMITS["cyan"], _SMITS["magenta"], _SMITS["yellow"],
    _SMITS["red"], _SMITS["green"], _SMITS["blue"]]).astype(np.float32)


def smits_uplift_dev(rgb, k):
    """Device RGB→spectral uplift; rgb (..., 3), k (...,) → (...,).

    Same Smits-basis decomposition as spectra.smits_uplift, branchless."""
    basis_t = torch.as_tensor(_SMITS_NP, device=k.device)
    lam_nm = TWO_PI / k.clamp_min(1e-30) * 1e9
    lo, hi = _SMITS_LAM
    b = ((lam_nm - lo) / (hi - lo) * 10).to(torch.int32).clamp(0, 9).long()
    inside = (lam_nm >= lo) & (lam_nm <= hi)
    white, cyan, magenta, yellow, red, green, blue = basis_t[:, b]
    r, g, bl = rgb[..., 0], rgb[..., 1], rgb[..., 2]

    out_r = white * r + torch.where(g <= bl,
                                    cyan * (g - r) + blue * (bl - g),
                                    cyan * (bl - r) + green * (g - bl))
    out_g = white * g + torch.where(r <= bl,
                                    magenta * (r - g) + blue * (bl - r),
                                    magenta * (bl - g) + red * (r - bl))
    out_b = white * bl + torch.where(r <= g,
                                     yellow * (r - bl) + green * (g - r),
                                     yellow * (g - bl) + red * (r - g))
    r_min = (r <= g) & (r <= bl)
    g_min = ~r_min & (g <= r) & (g <= bl)
    out = torch.where(r_min, out_r, torch.where(g_min, out_g, out_b))
    return torch.where(inside, out, torch.zeros_like(out))


def xyz_response_dev(k):
    """CIE CMF sensitivities at wavenumber k → (..., 3)."""
    lam_nm = TWO_PI / k.clamp_min(1e-30) * 1e9
    x, y, z = cie.xyz_cmf(lam_nm, xp=torch)
    return torch.stack([x, y, z], dim=-1)
