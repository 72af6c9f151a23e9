"""Elliptic cone beams: the cone through a footprint ellipse.

Port of wave_tracer_tpu/wave/cone.py (`Cone`, `svd2x2`,
`cone_through_ellipse`). A cone is a central ray + major-axis direction +
tan(α) + eccentricity + initial major-axis length x0; its cross-section
at distance z is an ellipse with major axis (tanα·z + x0) along x and
minor axis scaled by 1/e.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from wave_tracer_tpu_torch.math import frame as frame_mod
from wave_tracer_tpu_torch.math import vec


@dataclass
class Cone:
    o: torch.Tensor          # (..., 3) origin
    d: torch.Tensor          # (..., 3) propagation direction (unit)
    x: torch.Tensor          # (..., 3) major-axis direction (⊥ d)
    x0: torch.Tensor         # (...,) initial major-axis length
    tan_alpha: torch.Tensor  # (...,) tan of half opening angle
    e: torch.Tensor          # (...,) major/minor ratio ≥ 1


def svd2x2(a, b, c, d):
    """Closed-form SVD of [[a, b], [c, d]] (batched).

    Returns (cosU, sinU, s1, s2, theta) with s1 ≥ s2 ≥ 0: left singular
    vectors U = [[cosU, -sinU], [sinU, cosU]], singular values s1, s2 and
    the right rotation angle theta."""
    E = 0.5 * (a + d)
    F = 0.5 * (a - d)
    G = 0.5 * (c + b)
    H = 0.5 * (c - b)
    Q = torch.sqrt(E * E + H * H)
    R = torch.sqrt(F * F + G * G)
    s1 = Q + R
    s2 = (Q - R).abs()
    a1 = torch.atan2(G, F)
    a2 = torch.atan2(H, E)
    theta = 0.5 * (a2 - a1)
    phi = 0.5 * (a2 + a1)
    return torch.cos(phi), torch.sin(phi), s1, s2, theta


def cone_through_ellipse(ex, ey, n, ro, rd, tan_alpha):
    """Cone with direction rd through the ellipse (axes ex, ey ⊥ n) at ro.

    The ellipse is projected orthographically onto the plane ⊥ rd; the
    projected ellipse's principal axes (2×2 SVD) give the cone's major
    axis, x0 and eccentricity (e = sqrt(major/minor)). Returns (cone,
    self_intersection_distance)."""
    of = frame_mod.build_orthogonal_frame(rd)
    cU, sU, lX, lY, _ = svd2x2(vec.dot(ex, of.t), vec.dot(ey, of.t),
                               vec.dot(ex, of.b), vec.dot(ey, of.b))
    e = torch.where(lY > 1e-20, torch.sqrt(lX / lY.clamp_min(1e-20)), 1.0)
    e = e.clamp_min(1.0)
    wx = cU[..., None] * of.t + sU[..., None] * of.b
    wxn = vec.normalize(wx, eps=1e-24)

    degenerate = (vec.length2(ex) + vec.length2(ey)) < 1e-30
    cone = Cone(o=ro, d=rd,
                x=torch.where(degenerate[..., None], of.t, wxn),
                x0=torch.where(degenerate, 0.0, lX),
                tan_alpha=torch.broadcast_to(tan_alpha, lX.shape),
                e=torch.where(degenerate, 1.0, e))
    sid = _cone_plane_exit(cone, n)
    return cone, torch.where(degenerate, 0.0, sid)


def _cone_plane_exit(cone: Cone, n):
    """Distance past the origin where the cone still meets the plane
    through the origin with normal n (conservative isotropic bound)."""
    nd = vec.dot(n, cone.d).abs()
    s = torch.sqrt((1.0 - nd * nd).clamp_min(0.0))
    denom = nd - cone.tan_alpha * s
    grazing = denom <= 1e-6
    sid = cone.x0 * s / denom.clamp_min(1e-6)
    return torch.where(grazing, 1e6 * cone.x0.clamp_min(1e-12), sid)
