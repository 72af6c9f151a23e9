"""Host-side emitter model.

Port of wave_tracer_tpu/emitter/model.py for area and point emitters:
* area: mesh-attached cosine-directional radiance (W/sr/m² per wavenumber)
* point: isotropic radiant intensity (W/sr per wavenumber)
Spot and directional emitters are not ported yet.
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
