"""Beam sourcing geometry for restart vertices.

Port of `restart_envelope` of wave_tracer_tpu/wave/sourcing.py: the
isotropic-footprint sourcing of FSD restart vertices. (The emitter
sourcing of that module belongs to forward tracing and bdpt, which are
not ported yet.)
"""

from __future__ import annotations

import torch

from wave_tracer_tpu_torch.math import frame as frame_mod
from wave_tracer_tpu_torch.wave import beam as beam_geo
from wave_tracer_tpu_torch.wave import envelope as env_mod


def restart_envelope(rd_new, footprint, k, ta_cap: float = 0.3):
    """A near-point spatial extent whose angular extent is the
    minimum-uncertainty spread of the interaction footprint, capped."""
    N = rd_new.shape[0]
    ta = beam_geo.minimum_uncertainty_tan_alpha(
        footprint.clamp_min(1e-9) ** 2, k).clamp_max(ta_cap)
    ones = torch.ones((N,), dtype=torch.float32, device=rd_new.device)
    return env_mod.EnvState(x=frame_mod.build_orthogonal_frame(rd_new).t,
                            x0=ones * 1e-6, ta=ta, e=ones)
