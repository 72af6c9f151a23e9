"""Per-sensor spectral importance sampling: emitter × sensitivity products.

Port of wave_tracer_tpu/scene/spectral.py. Per sensor, a discrete emitter
distribution plus per-emitter piecewise-linear product tables (continuous
emitters) or line tables (discrete emitters), sampled with a fixed-step
binary search so no (N × K) intermediates materialize.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from wave_tracer_tpu_torch.spectrum.spectra import Spectrum

KP = 256        # product-distribution resolution
LMAX = 16       # max spectral lines per discrete emitter


@dataclass
class SpectralSampler:
    e_w: torch.Tensor       # (E,) emitter selection weights
    e_cdf: torch.Tensor     # (E,) inclusive CDF (normalized)
    x: torch.Tensor         # (E, KP) wavenumber nodes
    f: torch.Tensor         # (E, KP) product density
    cdf: torch.Tensor       # (E, KP) cumulative (unnormalized), cdf[:,0]=0
    total: torch.Tensor     # (E,)
    line_k: torch.Tensor    # (E, LMAX)
    line_w: torch.Tensor    # (E, LMAX) product-weighted line powers
    n_lines: torch.Tensor   # (E,) i32 (0 → continuous emitter)

    @property
    def count(self):
        return self.e_w.shape[0]

    def sample_emitter(self, u):
        """u (N,) → (e (N,) i32, pmf (N,))."""
        idx = torch.searchsorted(self.e_cdf, u.contiguous(), right=True)
        e = idx.clamp(0, self.count - 1).to(torch.int32)
        return e, self.pmf_emitter(e)

    def pmf_emitter(self, e):
        return self.e_w[e.long()] / self.e_w.sum().clamp_min(1e-30)

    def sample_k(self, e, u):
        """Sample k from emitter e's product distribution. Returns
        (k, pdf_k): the continuous density, or the line pmf for discrete
        emitters."""
        e = e.long()
        disc = self.n_lines[e] > 0
        lw = self.line_w[e]                       # (N, LMAX)
        lcdf = torch.cumsum(lw, dim=-1)
        ltot = lcdf[..., -1].clamp_min(1e-30)
        t = (u * ltot)[..., None]
        li = (lcdf < t).to(torch.int32).sum(-1).clamp(0, LMAX - 1).long()
        k_d = torch.gather(self.line_k[e], -1, li[..., None])[..., 0]
        pmf_d = torch.gather(lw, -1, li[..., None])[..., 0] / ltot

        tot = self.total[e].clamp_min(1e-30)
        target = u * tot
        lo = torch.zeros_like(e)
        hi = torch.full_like(e, KP - 2)
        for _ in range(9):     # 2^9 > KP
            mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
            go = self.cdf[e, mid] <= target
            lo = torch.where(go, mid, lo)
            hi = torch.where(go, hi, mid - 1)
        i = lo.clamp(0, KP - 2)
        x0 = self.x[e, i]
        x1 = self.x[e, i + 1]
        f0 = self.f[e, i]
        f1 = self.f[e, i + 1]
        c0 = self.cdf[e, i]
        dx = (x1 - x0).clamp_min(1e-12)
        r = (target - c0).clamp_min(0.0)
        df = (f1 - f0) / dx
        lin = r / f0.clamp_min(1e-20)
        disc2 = (f0 * f0 + 2.0 * df * r).clamp_min(0.0)
        flat = df.abs() < 1e-20
        quad = (torch.sqrt(disc2) - f0) / torch.where(
            flat, torch.ones_like(df), df)
        tseg = torch.minimum(torch.where(flat, lin, quad).clamp_min(0.0),
                             dx)
        k_c = x0 + tseg
        pdf_c = (f0 + df * tseg) / tot
        return torch.where(disc, k_d, k_c), torch.where(disc, pmf_d, pdf_c)

    def pdf_k(self, e, k):
        """Continuous product density of emitter e at k (0 for discrete)."""
        e = e.long()
        lo = torch.zeros_like(e)
        hi = torch.full_like(e, KP - 2)
        for _ in range(9):
            mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
            go = self.x[e, mid] <= k
            lo = torch.where(go, mid, lo)
            hi = torch.where(go, hi, mid - 1)
        i = lo.clamp(0, KP - 2)
        x0 = self.x[e, i]
        x1 = self.x[e, i + 1]
        f0 = self.f[e, i]
        f1 = self.f[e, i + 1]
        t = ((k - x0) / (x1 - x0).clamp_min(1e-12)).clamp(0.0, 1.0)
        val = f0 + (f1 - f0) * t
        inside = (k >= self.x[e, 0]) & (k <= self.x[e, KP - 1])
        zero = torch.zeros_like(val)
        pdf = torch.where(inside, val / self.total[e].clamp_min(1e-30),
                          zero)
        return torch.where(self.n_lines[e] > 0, zero, pdf)

    def joint_spectral_density(self, k):
        """Σ_e pmf(e) · pdf_e(k) over continuous emitters, plus matching
        discrete lines — the spectral-MIS denominator. k (N,) → (N,)."""
        tot_w = self.e_w.sum().clamp_min(1e-30)
        acc = torch.zeros_like(k)
        for e_static in range(self.count):
            e = torch.full(k.shape, e_static, dtype=torch.int32,
                           device=k.device)
            pmf_e = self.e_w[e_static] / tot_w
            cont = self.pdf_k(e, k)
            lk = self.line_k[e_static]
            lw = self.line_w[e_static]
            ltot = lw.sum().clamp_min(1e-30)
            match = (k[..., None] - lk[None, :]).abs() \
                < 1e-5 * k[..., None].clamp_min(1.0)
            pmf_line = torch.where(match, lw[None, :],
                                   torch.zeros_like(lw[None, :])
                                   ).sum(-1) / ltot
            has_lines = self.n_lines[e_static] > 0
            acc = acc + pmf_e * torch.where(has_lines, pmf_line, cont)
        return acc


def build_spectral_sampler(emitters, sensitivity: Spectrum) -> dict:
    """Host build of the per-sensor product tables → dict of numpy arrays
    (the SpectralSampler field names)."""
    E = max(len(emitters), 1)
    e_w = np.zeros(E, np.float64)
    x = np.tile(np.linspace(1.0, 2.0, KP), (E, 1))
    f = np.zeros((E, KP), np.float64)
    cdf = np.zeros((E, KP), np.float64)
    total = np.zeros(E, np.float64)
    line_k = np.zeros((E, LMAX), np.float64)
    line_w = np.zeros((E, LMAX), np.float64)
    n_lines = np.zeros(E, np.int32)

    s_lo, s_hi = sensitivity.krange()
    sens_discrete = getattr(sensitivity, "is_discrete", False)
    for i, em in enumerate(emitters):
        spec = em.spectrum
        if sens_discrete and not spec.is_discrete:
            # line sensitivity × continuous emitter → lines at the
            # sensitivity's wavenumbers weighted by the emitter density
            sk, sw = sensitivity.lines()
            w = np.asarray(spec.eval(sk)) * sw
            n = min(len(sk), LMAX)
            line_k[i, :n] = sk[:n]
            line_w[i, :n] = np.maximum(w[:n], 0.0)
            n_lines[i] = n
            e_w[i] = max(line_w[i, :n].sum(), 1e-30)
            continue
        if spec.is_discrete:
            ks, ws = spec.lines()
            sens = sensitivity.eval(ks)
            # lines outside the sensitivity keep their power: a discrete
            # monochromatic response accepts exactly these lines
            w = ws * np.where(sens > 0, sens, 1.0)
            n = min(len(ks), LMAX)
            line_k[i, :n] = ks[:n]
            line_w[i, :n] = np.maximum(w[:n], 1e-30)
            n_lines[i] = n
            e_w[i] = line_w[i, :n].sum()
            continue
        e_lo, e_hi = spec.krange()
        lo = max(e_lo, s_lo)
        hi = min(e_hi, s_hi)
        if hi <= lo:
            lo, hi = e_lo, e_hi     # fall back to emitter support
        grid = np.geomspace(max(lo, 1e-9), hi, KP)
        prod = np.maximum(spec.eval(grid) * sensitivity.eval(grid), 0.0)
        if prod.max() <= 0:
            prod = np.maximum(spec.eval(grid), 0.0)
        x[i] = grid
        f[i] = prod
        seg = 0.5 * (prod[1:] + prod[:-1]) * np.diff(grid)
        cdf[i, 1:] = np.cumsum(seg)
        total[i] = cdf[i, -1]
        e_w[i] = max(total[i], 1e-30)

    e_cdf = np.cumsum(e_w)
    e_cdf = e_cdf / max(e_cdf[-1], 1e-30)
    f32 = np.float32
    return dict(e_w=e_w.astype(f32), e_cdf=e_cdf.astype(f32),
                x=x.astype(f32), f=f.astype(f32), cdf=cdf.astype(f32),
                total=total.astype(f32), line_k=line_k.astype(f32),
                line_w=line_w.astype(f32), n_lines=n_lines)
