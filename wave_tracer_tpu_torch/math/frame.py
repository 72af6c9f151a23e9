"""Orthonormal frames as batched (t, b, n) triplets.

Port of wave_tracer_tpu/math/frame.py: Frame with to_local/to_world,
build_orthogonal_frame and build_shading_frame over (..., 3) tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from wave_tracer_tpu_torch.math import vec


@dataclass
class Frame:
    t: torch.Tensor  # tangent   (..., 3)
    b: torch.Tensor  # bitangent (..., 3)
    n: torch.Tensor  # normal    (..., 3)

    def to_local(self, v):
        return torch.stack([vec.dot(v, self.t), vec.dot(v, self.b),
                            vec.dot(v, self.n)], dim=-1)

    def to_world(self, v):
        return (v[..., 0:1] * self.t + v[..., 1:2] * self.b
                + v[..., 2:3] * self.n)


def build_orthogonal_frame(n) -> Frame:
    """Arbitrary frame with normal n (branchless |n.x| > |n.y| split)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    cond = nx.abs() > ny.abs()
    sx = 1.0 / torch.sqrt(torch.where(cond, nx * nx + nz * nz,
                                      ny * ny + nz * nz))
    zero = torch.zeros_like(sx)
    b = torch.where(cond[..., None],
                    torch.stack([sx * nz, zero, -sx * nx], dim=-1),
                    torch.stack([zero, sx * nz, -sx * ny], dim=-1))
    t = vec.cross(b, n)
    return Frame(t=t, b=b, n=n)


def build_shading_frame(n, dpdu) -> Frame:
    """Frame with normal n and tangent aligned with dpdu; falls back to
    build_orthogonal_frame where dpdu vanishes."""
    degenerate = vec.length2(dpdu) < 1e-24
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=dpdu.dtype,
                          device=dpdu.device)
    safe_dpdu = torch.where(degenerate[..., None], x_axis, dpdu)
    t = vec.normalize(safe_dpdu - n * vec.vdot(n, safe_dpdu), eps=1e-24)
    b = vec.normalize(vec.cross(n, t), eps=1e-24)
    t = vec.cross(b, n)
    fallback = build_orthogonal_frame(n)
    deg = degenerate[..., None]
    return Frame(t=torch.where(deg, fallback.t, t),
                 b=torch.where(deg, fallback.b, b), n=n)
