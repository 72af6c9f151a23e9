"""Perspective (pinhole) sensor: batched camera rays.

Port of wave_tracer_tpu/sensor/perspective.py (host model, generate_rays,
project and lookat_matrix): rays through jittered pixel positions, the
projection of world points onto the film for light tracing, importance
W = 1 per unit flux.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from wave_tracer_tpu_torch.sensor.response import Response


@dataclass
class PerspectiveSensor:
    width: int = 256
    height: int = 256
    fov: float = math.radians(45.0)    # along image x
    to_world: np.ndarray = field(default_factory=lambda: np.eye(4))
    samples: int = 16
    response: Response = field(default_factory=Response)
    rfilter_scale: float = 1.0
    ray_trace_only: bool = False
    polarimetric: bool = False
    id: str = "camera"
    beam_sigma_pixels: float = 0.25

    @property
    def rfilter_sigma(self):
        return self.beam_sigma_pixels * self.rfilter_scale

    def camera_basis(self):
        """(origin, right, up, forward) world-space camera frame."""
        M = np.asarray(self.to_world, np.float64)
        return M[:3, 3], M[:3, 0], M[:3, 1], M[:3, 2]

    def generate_rays(self, pixel_xy, jitter):
        """Rays through pixels. pixel_xy (N, 2) int [x, y]; jitter (N, 2)
        in [0,1). Returns (ro (N,3), rd (N,3), tan_alpha float)."""
        o, r, u, f = [torch.as_tensor(np.asarray(v, np.float32),
                                      device=jitter.device)
                      for v in self.camera_basis()]
        W, H = self.width, self.height
        tan_half = math.tan(0.5 * self.fov)
        px = pixel_xy[..., 0].to(torch.float32) + jitter[..., 0]
        py = pixel_xy[..., 1].to(torch.float32) + jitter[..., 1]
        ndc_x = (2.0 * px / W - 1.0) * tan_half
        ndc_y = (1.0 - 2.0 * py / H) * tan_half * (H / W)
        d = ndc_x[..., None] * r + ndc_y[..., None] * u + f
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        ro = o.expand(d.shape)
        tan_alpha = 2.0 * tan_half / W
        return ro, d, tan_alpha

    def project(self, p_world):
        """World points (N, 3) → (pixel_xy (N, 2), visible (N,),
        cos_theta (N,), dir_to_p (N, 3), dist (N,))."""
        o, r, u, f = [torch.as_tensor(np.asarray(v, np.float32),
                                      device=p_world.device)
                      for v in self.camera_basis()]
        W, H = self.width, self.height
        tan_half = math.tan(0.5 * self.fov)
        v = p_world - o
        dist = torch.linalg.vector_norm(v, dim=-1)
        d = v / dist.clamp_min(1e-12)[..., None]
        z = (d * f).sum(-1)
        x = (d * r).sum(-1)
        y = (d * u).sum(-1)
        zs = z.clamp_min(1e-6)
        ndc_x = x / zs / tan_half
        ndc_y = y / zs / (tan_half * (H / W))
        px = (ndc_x + 1.0) * 0.5 * W
        py = (1.0 - ndc_y) * 0.5 * H
        visible = (z > 1e-6) & (px >= 0) & (px < W) & (py >= 0) & (py < H)
        return torch.stack([px, py], dim=-1), visible, z, d, dist

    def importance(self):
        """W — emitted importance per unit flux."""
        return 1.0


def lookat_matrix(origin, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world from lookat (+x right, +y up, +z towards target)."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - origin
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-9:
        up = np.array([1.0, 0.0, 0.0]) if abs(fwd[0]) < 0.9 \
            else np.array([0.0, 0.0, 1.0])
        right = np.cross(up, fwd)
        nr = np.linalg.norm(right)
    right = right / nr
    up2 = np.cross(fwd, right)
    M = np.eye(4)
    M[:3, 0] = right
    M[:3, 1] = up2
    M[:3, 2] = fwd
    M[:3, 3] = origin
    return M
