"""Batched 3D vector helpers over trailing-axis-(3,) torch tensors.

Port of wave_tracer_tpu/math/vec.py. A "vec3" is a tensor of shape
(..., 3).
"""

from __future__ import annotations

import torch


def dot(a, b):
    return (a * b).sum(-1)


def length2(a):
    return (a * a).sum(-1)


def vdot(a, b):
    """dot with keepdims for broadcasting against vectors."""
    return (a * b).sum(-1, keepdim=True)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(a, eps: float = 0.0):
    n2 = length2(a)
    if eps:
        n2 = n2.clamp_min(eps)
    pos = n2 > 0
    inv = torch.where(pos, 1.0 / torch.sqrt(torch.where(
        pos, n2, torch.ones_like(n2))), torch.zeros_like(n2))
    return a * inv[..., None]


def length(a):
    return torch.sqrt(length2(a))


def safe_length(a, eps: float = 1e-30):
    """|a| with a tiny positive floor under the sqrt."""
    return torch.sqrt(length2(a).clamp_min(eps))


def safe_sqrt(x, eps: float = 1e-30):
    """sqrt with an epsilon floor."""
    return torch.sqrt(x.clamp_min(eps))


def reflect(wi, n):
    """Mirror direction of wi about n (both pointing away from the
    surface)."""
    return 2.0 * vdot(wi, n) * n - wi


def vec3(x, y, z):
    """Stack three f32 scalars or tensors, broadcast, into (..., 3)."""
    return torch.stack(torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.float32) for c in (x, y, z))),
        dim=-1)


def x_(v):
    return v[..., 0]


def y_(v):
    return v[..., 1]


def z_(v):
    return v[..., 2]
