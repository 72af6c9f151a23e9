"""Stokes vectors with attached reference frames — batched torch.

Port of wave_tracer_tpu/polarization/stokes.py (the parts the classical
bounce uses). S = (I, Q, U, V) as (..., 4); a frame is the transverse
x-axis (..., 3) plus the propagation direction (..., 3).
"""

from __future__ import annotations

import torch

from wave_tracer_tpu_torch.math import vec


def unpolarized(I):
    """Stokes vector for unpolarized intensity I (...,) → (..., 4)."""
    z = torch.zeros_like(I)
    return torch.stack([I, z, z, z], dim=-1)


def rotation_angle(x_from, x_to, d):
    """Signed rotation angle about propagation dir d taking frame x-axis
    x_from to x_to (all (..., 3), x ⊥ d)."""
    cosr = vec.dot(x_from, x_to)
    sinr = vec.dot(vec.cross(d, x_from), x_to)
    return torch.atan2(sinr, cosr)
