"""Stokes vectors with attached reference frames — batched torch.

Port of wave_tracer_tpu/polarization/stokes.py. S = (I, Q, U, V) as (..., 4); a frame is the transverse
x-axis (..., 3) plus the propagation direction (..., 3).
"""

from __future__ import annotations

import torch

from wave_tracer_tpu_torch.math import vec


def unpolarized(I):
    """Stokes vector for unpolarized intensity I (...,) → (..., 4)."""
    z = torch.zeros_like(I)
    return torch.stack([I, z, z, z], dim=-1)


def intensity(S):
    return S[..., 0]


def dop(S):
    """Degree of polarization √(Q² + U² + V²)/I."""
    return torch.sqrt((S[..., 1:] ** 2).sum(-1)) / S[..., 0].clamp_min(1e-30)


def rotation_angle(x_from, x_to, d):
    """Signed rotation angle about propagation dir d taking frame x-axis
    x_from to x_to (all (..., 3), x ⊥ d)."""
    cosr = vec.dot(x_from, x_to)
    sinr = vec.dot(vec.cross(d, x_from), x_to)
    return torch.atan2(sinr, cosr)


def rotate(S, theta):
    """Rotate the reference frame by θ about the propagation direction:
    S' = R(2θ) S."""
    c = torch.cos(2.0 * theta)
    s = torch.sin(2.0 * theta)
    I, Q, U, V = S[..., 0], S[..., 1], S[..., 2], S[..., 3]
    return torch.stack([I, c * Q + s * U, -s * Q + c * U, V], dim=-1)


def reorient(S, x_from, x_to, d):
    """Re-express S given w.r.t. transverse axis x_from in the frame with
    transverse axis x_to (same propagation direction d)."""
    return rotate(S, rotation_angle(x_from, x_to, d))
