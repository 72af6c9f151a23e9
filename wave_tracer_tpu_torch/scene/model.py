"""Host scene model: the fully loaded description before the device bake.

Port of wave_tracer_tpu/scene/model.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from wave_tracer_tpu_torch.bsdf.model import Material
from wave_tracer_tpu_torch.emitter.model import Emitter
from wave_tracer_tpu_torch.geometry.mesh import TriangleSoup


@dataclass
class Shape:
    soup: TriangleSoup
    material: Material
    emitter: Emitter | None = None      # attached area emitter
    id: str = ""


@dataclass
class IntegratorConfig:
    type: str = "plt_path"        # plt_path (plt_bdpt is not ported yet)
    max_depth: int = 16
    mis: bool = True
    fsd: bool = True              # free-space diffraction (not ported yet)
    ray_trace_only: bool = False  # classical ray-trace mode


@dataclass
class Scene:
    shapes: list = field(default_factory=list)       # [Shape]
    emitters: list = field(default_factory=list)     # [Emitter] (incl. area)
    sensors: list = field(default_factory=list)
    integrator: IntegratorConfig = field(default_factory=IntegratorConfig)
    id: str = "scene"

    def world_aabb(self):
        if not self.shapes:
            return np.zeros(3), np.ones(3)
        mins = np.min([s.soup.positions.min(axis=(0, 1))
                       for s in self.shapes if s.soup.num_tris], axis=0)
        maxs = np.max([s.soup.positions.max(axis=(0, 1))
                       for s in self.shapes if s.soup.num_tris], axis=0)
        return mins, maxs

    def world_radius(self) -> float:
        mins, maxs = self.world_aabb()
        return float(0.5 * np.linalg.norm(maxs - mins)) or 1.0
