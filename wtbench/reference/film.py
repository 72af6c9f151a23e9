"""The film of the plain reference: splats and develop (plain PyTorch).

A camera sample at continuous pixel position (x, y) adds its value times
w to each pixel (i, j) within r = ceil(3σ + 1/2) of pixel (⌊x − 1/2⌋,
⌊y − 1/2⌋), and w to that pixel's weight, where w is the integral of a
unit Gaussian of standard deviation σ pixels, centred on the sample,
over the pixel's square; the developed image is value / weight. A beam
that reaches a coverage plane adds its value to the light image over
the 5 × 5 elements around ⌊x − 1/2⌋, ⌊y − 1/2⌋, weighted by
exp(−d²/2σ²) (σ clipped to [0.05, 2], d from the element's centre),
the weights normalized over the elements inside the map; a point
connection adds its value to the element it falls in. The developed
map is the light image over the samples per element. A sample whose
value is not finite, or that is masked off, adds nothing.
"""

from __future__ import annotations

import math

import torch

from wtbench.reference import cast


def _gauss_cdf(x, sigma):
    return 0.5 * (1.0 + torch.erf(x / (sigma * math.sqrt(2.0))))


def camera_image(splats, H, W, C, sigma, prec="f64"):
    """splats: [(pos (N, 2), values (N, C), mask (N,))] → (H, W, C)."""
    r = int(math.ceil(3.0 * sigma + 0.5))
    dev = splats[0][0].device if splats else "cpu"
    dt = torch.float64 if prec == "f64" else torch.float32
    value = torch.zeros((H * W, C), dtype=dt, device=dev)
    weight = torch.zeros((H * W,), dtype=dt, device=dev)
    offs = torch.arange(-r, r + 1, device=dev)
    for pos, vals, mask in splats:
        keep = mask & torch.isfinite(vals).all(-1)
        pos, vals = cast(pos[keep], prec), cast(vals[keep], prec)
        px, py = pos[:, 0] - 0.5, pos[:, 1] - 0.5
        ix, iy = torch.floor(px).long(), torch.floor(py).long()
        xx = ix[:, None] + offs
        yy = iy[:, None] + offs
        wx = _gauss_cdf(xx + 0.5 - px[:, None], sigma) \
            - _gauss_cdf(xx - 0.5 - px[:, None], sigma)
        wy = _gauss_cdf(yy + 0.5 - py[:, None], sigma) \
            - _gauss_cdf(yy - 0.5 - py[:, None], sigma)
        if prec != "f64":
            wx, wy = cast(wx, prec), cast(wy, prec)
        w = wy[:, :, None] * wx[:, None, :]
        inside = ((yy >= 0) & (yy < H))[:, :, None] \
            & ((xx >= 0) & (xx < W))[:, None, :]
        w = torch.where(inside, w, 0.0).reshape(-1)
        flat = (yy.clamp(0, H - 1)[:, :, None] * W
                + xx.clamp(0, W - 1)[:, None, :]).reshape(-1)
        k2 = offs.shape[0] ** 2
        value.index_add_(0, flat, w[:, None] * vals.repeat_interleave(k2, 0))
        weight.index_add_(0, flat, w)
    img = value / weight.clamp_min(1e-12)[:, None]
    return img.reshape(H, W, C)


def coverage_map(beams, points, H, W, C, samples_per_element, prec="f64",
                 radius=2):
    """beams: [(pos (N, 2), sigma (N,), values (N, C), mask (N,))] and
    points: [(pos, values, mask)] → the developed (H, W, C) map."""
    dev = (beams or points)[0][0].device
    dt = torch.float64 if prec == "f64" else torch.float32
    light = torch.zeros((H * W, C), dtype=dt, device=dev)
    offs = torch.arange(-radius, radius + 1, device=dev)
    for pos, sig, vals, mask in beams:
        keep = mask & torch.isfinite(vals).all(-1)
        pos, vals = cast(pos[keep], prec), cast(vals[keep], prec)
        sig = cast(sig[keep], prec).clamp(0.05, float(radius))
        px, py = pos[:, 0] - 0.5, pos[:, 1] - 0.5
        ix, iy = torch.floor(px).long(), torch.floor(py).long()
        xx = ix[:, None] + offs
        yy = iy[:, None] + offs
        d2 = (xx[:, None, :] - px[:, None, None]) ** 2 \
            + (yy[:, :, None] - py[:, None, None]) ** 2
        w = torch.exp(-0.5 * d2 / (sig * sig)[:, None, None])
        inside = ((yy >= 0) & (yy < H))[:, :, None] \
            & ((xx >= 0) & (xx < W))[:, None, :]
        w = torch.where(inside, w, 0.0)
        w = w / w.sum((1, 2)).clamp_min(1e-12)[:, None, None]
        if prec != "f64":
            w = cast(w, prec)
        flat = (yy.clamp(0, H - 1)[:, :, None] * W
                + xx.clamp(0, W - 1)[:, None, :]).reshape(-1)
        k2 = offs.shape[0] ** 2
        light.index_add_(0, flat, w.reshape(-1)[:, None]
                         * vals.repeat_interleave(k2, 0))
    for pos, vals, mask in points:
        keep = mask & torch.isfinite(vals).all(-1) \
            & (pos[:, 0] >= 0) & (pos[:, 0] < W) \
            & (pos[:, 1] >= 0) & (pos[:, 1] < H)
        pos, vals = pos[keep], cast(vals[keep], prec)
        ix = pos[:, 0].long().clamp(0, W - 1)
        iy = pos[:, 1].long().clamp(0, H - 1)
        light.index_add_(0, iy * W + ix, vals)
    return (light / samples_per_element).reshape(H, W, C)
