"""Mueller operators — batched (..., 4, 4) torch tensors.

Port of wave_tracer_tpu/polarization/mueller.py (identity, frame rotation
and depolarizer: the operators of the diffuse and null lobes).
"""

from __future__ import annotations

import torch


def identity(batch_shape=(), device=None):
    return torch.eye(4, dtype=torch.float32, device=device).expand(
        tuple(batch_shape) + (4, 4))


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
