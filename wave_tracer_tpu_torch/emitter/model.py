"""Host-side emitter model.

Port of wave_tracer_tpu/emitter/model.py:
* area: mesh-attached cosine-directional radiance (W/sr/m² per wavenumber)
* point: isotropic radiant intensity (W/sr per wavenumber)
* spot: radiant intensity with a linear angular falloff between
  beam_width and cutoff
* directional: irradiance from infinity (W/m² per wavenumber)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from wave_tracer_tpu_torch.spectrum.spectra import Spectrum


@dataclass
class Emitter:
    spectrum: Spectrum = None
    phase_space_extent_scale: float = 1.0
    id: str = ""

    def power(self) -> float:
        raise NotImplementedError


@dataclass
class AreaEmitter(Emitter):
    shape_index: int = -1       # filled by scene build
    area: float = 0.0           # filled by the emitter bake

    def power(self):
        # cosine-hemisphere radiance → power = π · A · ∫L dk
        return math.pi * self.area * self.spectrum.power()


@dataclass
class PointEmitter(Emitter):
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))

    def power(self):
        return 4.0 * math.pi * self.spectrum.power()


@dataclass
class SpotEmitter(Emitter):
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    direction: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0]))
    beam_width: float = math.radians(10.0)   # full-intensity angle
    cutoff: float = math.radians(20.0)

    def power(self):
        # effective solid angle of the linear falloff:
        # 2π(1 − (cos β + cos c)/2)
        sa = 2.0 * math.pi * (1.0 - 0.5 * (math.cos(self.beam_width)
                                           + math.cos(self.cutoff)))
        return sa * self.spectrum.power()


@dataclass
class DirectionalEmitter(Emitter):
    direction: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0]))  # propagation
    scene_radius: float = 1.0     # set by the emitter bake

    def power(self):
        return math.pi * self.scene_radius ** 2 * self.spectrum.power()
