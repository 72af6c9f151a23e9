"""Mueller operators — batched (..., 4, 4) torch tensors.

Port of wave_tracer_tpu/polarization/mueller.py: identity, isotropic
scale, frame rotation, depolarizer, ideal linear polarizer, the Fresnel interaction matrices built
from complex Jones amplitudes in the S/P basis, and their application and
composition.
"""

from __future__ import annotations

import torch


def identity(batch_shape=(), device=None):
    return torch.eye(4, dtype=torch.float32, device=device).expand(
        tuple(batch_shape) + (4, 4))


def scaled(scale):
    """Isotropic scale (energy factor): scale (...,) → (..., 4, 4)."""
    return scale[..., None, None] * torch.eye(4, dtype=torch.float32,
                                              device=scale.device)


def rotation(theta):
    """Reference-frame rotation R(2θ) as a Mueller matrix."""
    c = torch.cos(2.0 * theta)
    s = torch.sin(2.0 * theta)
    z = torch.zeros_like(theta)
    o = torch.ones_like(theta)
    rows = [
        torch.stack([o, z, z, z], dim=-1),
        torch.stack([z, c, s, z], dim=-1),
        torch.stack([z, -s, c, z], dim=-1),
        torch.stack([z, z, z, o], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def depolarizer(scale):
    """Ideal depolarizer: keeps I (times scale), kills Q, U, V."""
    M = scale.new_zeros(scale.shape + (4, 4))
    M[..., 0, 0] = scale
    return M


def linear_polarizer(theta):
    """Ideal linear polarizer at angle θ to the frame's x-axis."""
    c = torch.cos(2.0 * theta)
    s = torch.sin(2.0 * theta)
    z = torch.zeros_like(theta)
    h = 0.5 * torch.ones_like(theta)
    rows = [torch.stack([h, h * c, h * s, z], dim=-1),
            torch.stack([h * c, h * c * c, h * s * c, z], dim=-1),
            torch.stack([h * s, h * s * c, h * s * s, z], dim=-1),
            torch.stack([z, z, z, z], dim=-1)]
    return torch.stack(rows, dim=-2)


def from_jones_sp(a_s, a_p, scale=None):
    """Mueller matrix of a diagonal Jones operator diag(a_s, a_p) in the
    S/P basis; a_s, a_p complex (...,). Rows and columns (I, Q, U, V) with
    Q = |E_s|² − |E_p|²."""
    As = a_s.abs() ** 2
    Ap = a_p.abs() ** 2
    cross = a_s * a_p.conj()
    re = cross.real
    im = cross.imag
    z = torch.zeros_like(As)
    m00 = 0.5 * (As + Ap)
    m01 = 0.5 * (As - Ap)
    M = torch.stack([
        torch.stack([m00, m01, z, z], dim=-1),
        torch.stack([m01, m00, z, z], dim=-1),
        torch.stack([z, z, re, im], dim=-1),
        torch.stack([z, z, -im, re], dim=-1),
    ], dim=-2)
    if scale is not None:
        M = scale[..., None, None] * M
    return M


def apply(M, S):
    """M (..., 4, 4) @ S (..., 4)."""
    return (M @ S[..., None])[..., 0]


def compose(M2, M1):
    """Operator composition: first M1, then M2."""
    return M2 @ M1
