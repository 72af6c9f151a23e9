"""Film: 2D accumulation buffers with Gaussian reconstruction splats.

Port of wave_tracer_tpu/sensor/film.py (make_film, splat, splat_direct,
splat_direct_gaussian, develop). Each sample splats into a (2r+1)² window
with per-pixel Gaussian-integrated weights; light-tracing samples splat
into a separate light image (`direct`): the nearest texel, or, for the
beams that reach a virtual-plane sensor, a renormalized 5×5 Gaussian
window. The light image is normalized by the samples per element at
develop time. Unlike the functional JAX film, the splats update the
film's tensors in place with one flat `index_add_` each and return the
film.
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
    direct: torch.Tensor | None = None   # (H, W, C) light image

    @property
    def shape(self):
        return self.value.shape


def make_film(width: int, height: int, channels: int = 3,
              rfilter_sigma: float = 0.25, device="cpu") -> Film:
    radius = int(math.ceil(3.0 * rfilter_sigma + 0.5))
    z = dict(dtype=torch.float32, device=device)
    return Film(value=torch.zeros((height, width, channels), **z),
                weight=torch.zeros((height, width), **z),
                direct=torch.zeros((height, width, channels), **z),
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


def splat_direct(film: Film, pos, values, mask) -> Film:
    """Nearest-texel splat into the light image: pos (N, 2) [x, y]
    continuous pixel positions, values (N, C), mask (N,). Samples outside
    the film, masked off, or with a non-finite value deposit nothing."""
    H, W, C = film.direct.shape
    keep = mask & torch.isfinite(values).all(-1) \
        & (pos[:, 0] >= 0) & (pos[:, 0] < W) \
        & (pos[:, 1] >= 0) & (pos[:, 1] < H)
    pos = pos[keep]
    ix = pos[:, 0].to(torch.int64).clamp(0, W - 1)
    iy = pos[:, 1].to(torch.int64).clamp(0, H - 1)
    film.direct.view(H * W, C).index_add_(0, iy * W + ix, values[keep])
    return film


def splat_direct_gaussian(film: Film, pos, sigma_px, values, mask,
                          radius: int = 2) -> Film:
    """Gaussian-weighted direct splat: each beam's wavefront over the
    (2·radius+1)² elements around pos (N, 2), σ (N,) in element units
    (clipped to [0.05, radius]); the weights renormalize over the window
    (the part inside the film), so the deposited power is conserved.
    Lanes masked off or with a non-finite value deposit nothing."""
    H, W, C = film.direct.shape
    keep = mask & torch.isfinite(values).all(-1)
    pos, vals = pos[keep], values[keep]
    sig = sigma_px[keep].clamp(0.05, float(radius))
    px = pos[:, 0] - 0.5
    py = pos[:, 1] - 0.5
    ix = torch.floor(px).long()
    iy = torch.floor(py).long()
    offs = torch.arange(-radius, radius + 1, device=pos.device)
    yy = iy[:, None] + offs[None, :]
    xx = ix[:, None] + offs[None, :]
    d2 = (xx.to(torch.float32)[:, None, :] - px[:, None, None]) ** 2 \
        + (yy.to(torch.float32)[:, :, None] - py[:, None, None]) ** 2
    w = torch.exp(-0.5 * d2 / (sig * sig)[:, None, None])
    inside = (yy[:, :, None] >= 0) & (yy[:, :, None] < H) \
        & (xx[:, None, :] >= 0) & (xx[:, None, :] < W)
    w = torch.where(inside, w, 0.0)
    w = w / w.sum((1, 2)).clamp_min(1e-12)[:, None, None]
    fidx = (yy.clamp(0, H - 1)[:, :, None] * W
            + xx.clamp(0, W - 1)[:, None, :]).reshape(-1)
    K2 = offs.shape[0] ** 2
    film.direct.view(H * W, C).index_add_(
        0, fidx, w.reshape(-1)[:, None] * vals.repeat_interleave(K2, dim=0))
    return film


def develop(film: Film, total_samples_per_element: float = 0.0):
    """Final image: filtered value / filter weight, plus the light image
    divided by the samples per element when that is positive."""
    img = film.value / film.weight.clamp_min(1e-12)[..., None]
    if total_samples_per_element > 0:
        img = img + film.direct / total_samples_per_element
    return img
