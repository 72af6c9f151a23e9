"""Elliptic beam-envelope transport state + scatter updates.

Port of wave_tracer_tpu/wave/envelope.py. Integrators carry an `EnvState`
per lane and call `surface_scatter` at every surface vertex: the new
envelope is the elliptic cone through the surface footprint ellipse in
the outgoing direction, so grazing incidence stretches it
anisotropically.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from wave_tracer_tpu_torch.math import frame as frame_mod
from wave_tracer_tpu_torch.math import vec
from wave_tracer_tpu_torch.wave import beam as beam_geo
from wave_tracer_tpu_torch.wave import cone as cone_mod


@dataclass
class EnvState:
    """Per-lane elliptic envelope: cross-section at distance z along the
    central ray has major axis (x0 + ta*z) along x and minor axis /e."""
    x: torch.Tensor    # (N, 3) major-axis direction (unit, ⊥ ray dir)
    x0: torch.Tensor   # (N,) major-axis length at the origin
    ta: torch.Tensor   # (N,) tan half-opening (of the major axis)
    e: torch.Tensor    # (N,) major/minor eccentricity ≥ 1

    def major(self, z):
        return self.x0 + self.ta * z

    def minor(self, z):
        return self.major(z) / self.e.clamp_min(1.0)

    def area_radius(self, z):
        """sqrt(major·minor): the isotropic-equivalent footprint radius."""
        return torch.sqrt((self.major(z) * self.minor(z)).clamp_min(0.0))


def initial(rd, x0, ta):
    """Isotropic sourcing envelope (sensor beams)."""
    N = rd.shape[0]
    return EnvState(
        x=frame_mod.build_orthogonal_frame(rd).t,
        x0=torch.full((N,), float(x0), dtype=torch.float32, device=rd.device),
        ta=torch.full((N,), float(ta), dtype=torch.float32, device=rd.device),
        e=torch.ones((N,), dtype=torch.float32, device=rd.device))


def footprint_on_surface(env: EnvState, rd, z, n, cos_min: float = 0.05):
    """Interaction-footprint ellipse axes on the surface: the beam
    cross-section at distance z (axes a*x, b*y ⊥ rd) projected along rd
    onto the plane with normal n, grazing clamped at cos_min. Returns
    (ex, ey) world-space conjugate axes."""
    a = env.major(z)
    b = env.minor(z)
    xh = env.x
    yh = vec.cross(rd, xh)
    nd = vec.dot(n, rd)
    sgn = torch.where(nd >= 0, 1.0, -1.0)
    nd = sgn * nd.abs().clamp_min(cos_min)

    def proj(v):
        return v - (vec.dot(n, v) / nd)[..., None] * rd

    return proj(a[..., None] * xh), proj(b[..., None] * yh)


def surface_scatter(env: EnvState, rd, z, n, wo, specular, k,
                    ta_cap: float = 0.3):
    """Envelope after a surface scatter at distance z along rd. Specular
    lobes keep the incident opening angle; scattered lobes restart at the
    minimum-uncertainty opening for the footprint extent. Returns
    (EnvState, self_intersection_distance)."""
    ex, ey = footprint_on_surface(env, rd, z, n)
    ab = (vec.length(ex) * vec.length(ey)).clamp_min(1e-18)
    ta_mub = beam_geo.minimum_uncertainty_tan_alpha(ab, k)
    ta_next = torch.where(specular, env.ta, ta_mub.clamp_max(ta_cap))
    cone, sid = cone_mod.cone_through_ellipse(ex, ey, n, torch.zeros_like(rd),
                                              wo, ta_next)
    return EnvState(x=cone.x, x0=cone.x0, ta=cone.tan_alpha, e=cone.e), sid


def select(cond, a: EnvState, b: EnvState) -> EnvState:
    """Per-lane choice between two envelopes."""
    return EnvState(**{
        f.name: torch.where(cond.view(cond.shape + (1,) * (
            getattr(a, f.name).dim() - 1)), getattr(a, f.name),
            getattr(b, f.name)) for f in fields(EnvState)})
