"""Sampling warps: unit square -> disk / hemisphere / triangle.

Port of wave_tracer_tpu/sampling/warps.py (the warps the classical bounce
uses). All take u of shape (..., 2); directions are in the local frame
(z = normal) and pdfs are solid-angle densities.
"""

from __future__ import annotations

import math

import torch

INV_PI = 1.0 / math.pi


def concentric_disk(u):
    """Concentric (Shirley) square->disk map, uniform area density."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    cond = ox.abs() > oy.abs()
    one = torch.ones_like(ox)
    safe_ox = torch.where(ox == 0, one, ox)
    safe_oy = torch.where(oy == 0, one, oy)
    r = torch.where(cond, ox, oy)
    theta = torch.where(cond,
                        (math.pi / 4.0) * (oy / safe_ox),
                        (math.pi / 2.0) - (math.pi / 4.0) * (ox / safe_oy))
    d = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return torch.where(zero[..., None], torch.zeros_like(d), d)


def cosine_hemisphere(u):
    d = concentric_disk(u)
    z = torch.sqrt((1.0 - d[..., 0] ** 2 - d[..., 1] ** 2).clamp_min(0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta.clamp_min(0.0) * INV_PI


def uniform_triangle(u):
    """Barycentric coordinates with uniform area density."""
    su0 = torch.sqrt(u[..., 0])
    b0 = 1.0 - su0
    b1 = u[..., 1] * su0
    return torch.stack([b0, b1], dim=-1)
