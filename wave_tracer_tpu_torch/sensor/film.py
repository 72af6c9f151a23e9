"""Film: 2D accumulation buffers with Gaussian reconstruction splats.

Port of wave_tracer_tpu/sensor/film.py (make_film, splat, develop). Each
sample splats into a (2r+1)² window with per-pixel Gaussian-integrated
weights. Unlike the functional JAX film, `splat` updates the film's
tensors in place (one `index_add_` per target) and returns the film. The
light image of forward rendering (`direct`, `splat_direct`) is not ported
yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass
class Film:
    value: torch.Tensor      # (H, W, C) filtered accumulation
    weight: torch.Tensor     # (H, W) filter weight sum
    rfilter_sigma: float = 0.25
    radius: int = 1

    @property
    def shape(self):
        return self.value.shape


def make_film(width: int, height: int, channels: int = 3,
              rfilter_sigma: float = 0.25, device="cpu") -> Film:
    radius = int(math.ceil(3.0 * rfilter_sigma + 0.5))
    z = dict(dtype=torch.float32, device=device)
    return Film(value=torch.zeros((height, width, channels), **z),
                weight=torch.zeros((height, width), **z),
                rfilter_sigma=rfilter_sigma, radius=radius)


def _gauss_cdf(x, sigma):
    return 0.5 * (1.0 + torch.erf(x / (sigma * math.sqrt(2.0))))


def splat(film: Film, pos, values, mask) -> Film:
    """Splat N samples at continuous pixel positions pos (N, 2) [x, y]
    with channel values (N, C); mask (N,) selects live lanes. Lanes whose
    values are not all finite deposit neither value nor weight."""
    r = film.radius
    sigma = film.rfilter_sigma
    H, W, C = film.value.shape
    keep = mask & torch.isfinite(values).all(-1)
    pos = pos[keep]
    vals = values[keep]
    px = pos[:, 0] - 0.5     # sample position in pixel-center coordinates
    py = pos[:, 1] - 0.5
    ix = torch.floor(px).long()
    iy = torch.floor(py).long()

    offs = torch.arange(-r, r + 1, device=pos.device)
    yy = iy[:, None] + offs[None, :]                      # (N, K)
    xx = ix[:, None] + offs[None, :]
    yf = yy.to(torch.float32)
    xf = xx.to(torch.float32)
    wy = _gauss_cdf(yf + 0.5 - py[:, None], sigma) \
        - _gauss_cdf(yf - 0.5 - py[:, None], sigma)
    wx = _gauss_cdf(xf + 0.5 - px[:, None], sigma) \
        - _gauss_cdf(xf - 0.5 - px[:, None], sigma)
    w = wy[:, :, None] * wx[:, None, :]                   # (N, K, K)
    inside = (yy[:, :, None] >= 0) & (yy[:, :, None] < H) \
        & (xx[:, None, :] >= 0) & (xx[:, None, :] < W)
    w = torch.where(inside, w, torch.zeros_like(w))
    fidx = (yy.clamp(0, H - 1)[:, :, None] * W
            + xx.clamp(0, W - 1)[:, None, :]).reshape(-1)
    wflat = w.reshape(-1)
    K2 = offs.shape[0] ** 2
    film.value.view(H * W, C).index_add_(
        0, fidx, wflat[:, None] * vals.repeat_interleave(K2, dim=0))
    film.weight.view(H * W).index_add_(0, fidx, wflat)
    return film


def develop(film: Film):
    """Final image: filtered value / filter weight."""
    return film.value / film.weight.clamp_min(1e-12)[..., None]
