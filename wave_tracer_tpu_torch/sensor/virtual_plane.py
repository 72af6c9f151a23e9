"""Virtual-plane coverage sensor (signal maps).

Port of wave_tracer_tpu/sensor/virtual_plane.py: a non-imaging plane in
space whose texels are sensing elements. Forward-transport beams connect
to it directly, producing e.g. GHz coverage maps. Importance is
1/(π·element_area).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from wave_tracer_tpu_torch.sensor.response import Response


@dataclass
class VirtualPlaneSensor:
    width: int = 256
    height: int = 64
    extent: tuple = (1.0, 0.25)        # physical extents (x, y) in metres
    alpha: float = math.radians(0.001)  # acceptance half-angle
    to_world: np.ndarray = field(default_factory=lambda: np.eye(4))
    samples: int = 16
    response: Response = field(default_factory=Response)
    rfilter_scale: float = 1.0
    ray_trace_only: bool = False
    polarimetric: bool = False
    id: str = "coverage"
    beam_sigma_pixels: float = 0.25

    @property
    def rfilter_sigma(self):
        return self.beam_sigma_pixels * self.rfilter_scale

    def plane_basis(self):
        """(origin, x axis, y axis, normal (z)) in float64."""
        M = np.asarray(self.to_world, np.float64)
        return M[:3, 3], M[:3, 0], M[:3, 1], M[:3, 2]

    def _basis_on(self, device):
        return [torch.tensor(v, dtype=torch.float32, device=device)
                for v in self.plane_basis()]

    def element_area(self) -> float:
        return (self.extent[0] / self.width) * (self.extent[1] / self.height)

    def importance(self) -> float:
        """W = 1/(π·A_element)."""
        return 1.0 / (math.pi * self.element_area())

    def sample_point(self, u2):
        """A uniform point on the plane for u2 (N, 2): returns (sp (N, 3)
        world, pixel_xy (N, 2) element coordinates, area, normal (3,))."""
        o, xa, ya, n = self._basis_on(u2.device)
        ex, ey = self.extent
        lx = (u2[..., 0] - 0.5) * ex
        ly = (u2[..., 1] - 0.5) * ey
        sp = o + lx[..., None] * xa + ly[..., None] * ya
        px = u2[..., 0] * self.width
        py = (1.0 - u2[..., 1]) * self.height
        return sp, torch.stack([px, py], dim=-1), float(ex * ey), n

    def intersect(self, ro, rd):
        """Ray ∩ plane: (t (N,), pixel_xy (N, 2), inside (N,), cos_in (N,)),
        cos_in the cosine against the plane's −normal."""
        o, xa, ya, n = self._basis_on(ro.device)
        denom = (rd * n).sum(-1)
        t = ((o - ro) * n).sum(-1) / torch.where(denom.abs() < 1e-12,
                                                  1e-12, denom)
        p = ro + t[..., None] * rd
        lx = ((p - o) * xa).sum(-1)
        ly = ((p - o) * ya).sum(-1)
        ex, ey = self.extent
        u = lx / ex + 0.5
        v = ly / ey + 0.5
        inside = (t > 0) & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
        px = u * self.width
        py = (1.0 - v) * self.height
        return t, torch.stack([px, py], dim=-1), inside, -denom
