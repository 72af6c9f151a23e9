"""1D distributions: host-built, device-sampled.

Port of wave_tracer_tpu/math/dist.py. A distribution is a dataclass of
flat tensors built on the host (numpy, float64, stored as float32) and
sampled on the device by searchsorted and an analytic inversion per
segment. The unnormalized density values are stored; `total` is the
integral; `pdf()` returns the normalized density.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from wave_tracer_tpu_torch.util.device import card


def _like(v, ref):
    """v as a tensor of ref's dtype and device."""
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def _interp(xq, x, f):
    """np.interp of (x, f) at xq, 0 outside [x[0], x[-1]]."""
    i = (torch.searchsorted(x, xq, right=True) - 1).clamp(0, x.shape[0] - 2)
    x0, x1 = x[i], x[i + 1]
    w = (xq - x0) / torch.where(x1 > x0, x1 - x0, 1.0)
    val = f[i] + w * (f[i + 1] - f[i])
    val = torch.where(xq == x[-1], f[-1], val)
    return torch.where((xq < x[0]) | (xq > x[-1]), 0.0, val)


@dataclass
class PiecewiseLinear1D:
    """Piecewise-linear density over sorted nodes x."""
    x: torch.Tensor        # (K,) node positions
    f: torch.Tensor        # (K,) unnormalized density at the nodes
    cdf: torch.Tensor      # (K,) unnormalized cumulative integral, cdf[0]=0
    total: torch.Tensor    # () integral of f dx

    def pdf(self, xq):
        """Normalized density at query points (0 outside the support)."""
        val = _interp(_like(xq, self.x), self.x, self.f)
        return torch.where(self.total > 0,
                           val / self.total.clamp_min(1e-30), 0.0)

    def sample(self, u):
        """Inverse-CDF sample; u in [0, 1). Returns (x, pdf)."""
        target = _like(u, self.x) * self.total
        # segment i such that cdf[i] <= target < cdf[i+1]
        i = (torch.searchsorted(self.cdf, target, right=True) - 1).clamp(
            0, self.x.shape[0] - 2)
        x0, x1 = self.x[i], self.x[i + 1]
        f0, f1 = self.f[i], self.f[i + 1]
        dx = (x1 - x0).clamp_min(1e-30)
        r = target - self.cdf[i]              # mass into this segment
        df = (f1 - f0) / dx
        # solve f0·t + df·t²/2 = r for t in [0, dx]
        lin = r / f0.clamp_min(1e-30)
        disc = (f0 * f0 + 2.0 * df * r).clamp_min(0.0)
        flat = df.abs() < 1e-20
        quad = (torch.sqrt(disc) - f0) / torch.where(flat, 1.0, df)
        t = torch.minimum(torch.where(flat, lin, quad).clamp_min(0.0), dx)
        return x0 + t, (f0 + df * t) / self.total.clamp_min(1e-30)

    def integral(self, lo, hi):
        """Unnormalized integral of f over [lo, hi]."""
        def cum(v):
            v = torch.minimum(torch.maximum(_like(v, self.x), self.x[0]),
                              self.x[-1])
            i = (torch.searchsorted(self.x, v, right=True) - 1).clamp(
                0, self.x.shape[0] - 2)
            x0, x1 = self.x[i], self.x[i + 1]
            f0, f1 = self.f[i], self.f[i + 1]
            dx = (x1 - x0).clamp_min(1e-30)
            t = torch.minimum((v - x0).clamp_min(0.0), dx)
            return self.cdf[i] + f0 * t + 0.5 * (f1 - f0) / dx * t * t
        return (cum(hi) - cum(lo)).clamp_min(0.0)


def build_piecewise_linear(x, f, device="cuda") -> PiecewiseLinear1D:
    """The piecewise-linear density f over the knots x, on `device` (the
    card unless the CPU is asked for)."""
    device = card(device)
    x = np.asarray(x, np.float64)
    f = np.maximum(np.asarray(f, np.float64), 0.0)
    assert x.ndim == 1 and x.shape == f.shape and len(x) >= 2
    seg = 0.5 * (f[1:] + f[:-1]) * np.diff(x)
    cdf = np.concatenate([[0.0], np.cumsum(seg)])

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return PiecewiseLinear1D(x=t(x), f=t(f), cdf=t(cdf), total=t(cdf[-1]))


@dataclass
class Discrete1D:
    """Discrete distribution over (position, weight) atoms."""
    pos: torch.Tensor     # (K,)
    w: torch.Tensor       # (K,) unnormalized weights
    cdf: torch.Tensor     # (K,) inclusive prefix sum
    total: torch.Tensor   # ()

    @property
    def count(self):
        return self.pos.shape[0]

    def sample(self, u):
        """Returns (index, position, pmf)."""
        target = _like(u, self.cdf) * self.total
        i = torch.searchsorted(self.cdf, target, right=True).clamp(
            0, self.count - 1)
        return i, self.pos[i], self.w[i] / self.total.clamp_min(1e-30)

    def pmf(self, i):
        return self.w[i] / self.total.clamp_min(1e-30)


def build_discrete(pos, w, device="cuda") -> Discrete1D:
    """The atoms (pos, w) on `device` (the card unless the CPU is asked
    for)."""
    device = card(device)
    pos = np.asarray(pos, np.float64).reshape(-1)
    w = np.maximum(np.asarray(w, np.float64).reshape(-1), 0.0)
    cdf = np.cumsum(w)
    total = cdf[-1] if len(cdf) else 0.0

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return Discrete1D(pos=t(pos), w=t(w), cdf=t(cdf), total=t(total))
