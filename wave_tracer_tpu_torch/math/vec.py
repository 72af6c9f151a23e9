"""Batched 3D vector helpers over trailing-axis-(3,) torch tensors.

Port of wave_tracer_tpu/math/vec.py (the helpers the classical bounce
uses). A "vec3" is a tensor of shape (..., 3).
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
