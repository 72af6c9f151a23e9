"""Beam sourcing geometry: how restart vertices and emitters decide a new
beam's phase-space extents.

Port of wave_tracer_tpu/wave/sourcing.py: the isotropic-footprint
sourcing of FSD restart vertices, the minimum-uncertainty emission beam
of an emitter row (bdpt light subpaths, forward transport) and its full
elliptic envelope (`emitter_envelope`, which, as in the JAX package, no
integrator calls: forward transport forms the same envelope inline).
"""

from __future__ import annotations

import torch

from wave_tracer_tpu_torch.emitter import table as etab
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


def emitter_tan_alpha(et, e0):
    """Per-type angular extent of an emission beam (pre-MUB): a spot's
    cutoff cone, else 5% of the phase-space-extent scale."""
    e0 = e0.long()
    pse = et.pse_scale[e0]
    cosc = et.cos_cutoff[e0]
    ta_spot = torch.sqrt((1.0 - cosc * cosc).clamp_min(1e-12)) \
        / cosc.clamp_min(0.1) * pse
    return torch.where(et.etype[e0] == etab.ET_SPOT, ta_spot, 0.05 * pse)


def source_emitter_mub(et, e0, k):
    """(spatial σ², tanα) of a minimum-uncertainty emission beam: the
    emitter's extents enlarged to SBP ≥ 1/4."""
    ta0 = emitter_tan_alpha(et, e0)
    return beam_geo.make_mub(torch.zeros_like(ta0), ta0, k)


def emitter_envelope(et, e0, k, wo):
    """Full elliptic EnvState for freshly sourced emission beams along wo."""
    se_mub, ta_mub = source_emitter_mub(et, e0, k)
    return env_mod.EnvState(
        x=frame_mod.build_orthogonal_frame(wo).t,
        x0=torch.sqrt(se_mub.clamp_min(0.0)), ta=ta_mub,
        e=torch.ones(e0.shape, dtype=torch.float32, device=wo.device))
