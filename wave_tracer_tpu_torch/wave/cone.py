"""Elliptic cone beams: the cone through a footprint ellipse.

Port of wave_tracer_tpu/wave/cone.py (`Cone`, `ray_cone`, `svd2x2`,
`cone_through_ellipse`, `cone_through_ellipsoid`). A cone is a central ray + major-axis direction +
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

    @property
    def one_over_e(self):
        return 1.0 / self.e.clamp_min(1.0)

    @property
    def y(self):
        return vec.cross(self.d, self.x)

    @property
    def z_apex(self):
        """z of the apex (≤ 0); −inf for a degenerate ray."""
        return torch.where(self.is_ray(), -torch.inf,
                           -self.x0 / self.tan_alpha.clamp_min(1e-20))

    def is_ray(self):
        return (self.tan_alpha == 0) & (self.x0 == 0)

    def frame(self) -> frame_mod.Frame:
        return frame_mod.Frame(t=self.x, b=self.y, n=self.d)

    def to_local(self, p):
        u = p - self.o
        return torch.stack([vec.dot(u, self.x), vec.dot(u, self.y),
                            vec.dot(u, self.d)], dim=-1)

    def axes(self, z):
        """(major, minor) axis lengths at distance z."""
        r = self.tan_alpha * z + self.x0
        return r, r * self.one_over_e

    def radius(self, z, r2_local):
        """Cross-section radius at z in the local 2D direction r2 (unit)."""
        a, b = self.axes(z)
        cos2 = r2_local[..., 0] ** 2
        denom = torch.sqrt((a * a * (1 - cos2) + b * b * cos2)
                           .clamp_min(1e-30))
        return torch.where((a == 0) | (b == 0), 0.0, a * b / denom)

    def contains_local(self, p, zmin=0.0, zmax=torch.inf):
        z = p[..., 2]
        ok = (z >= zmin) & (z <= zmax) & (self.z_apex <= z)
        lhs = p[..., 0] ** 2 + (self.e * p[..., 1]) ** 2
        rhs = (z * self.tan_alpha + self.x0) ** 2
        return ok & (lhs <= rhs)

    def contains(self, p, zmin=0.0, zmax=torch.inf):
        return self.contains_local(self.to_local(p), zmin, zmax)

    def project_local(self, p, z):
        """Project a local point to the cross-section at distance z."""
        xy = p[..., :2]
        denom = (self.tan_alpha * p[..., 2] + self.x0).abs()
        scale = (self.tan_alpha * z + self.x0) / denom.clamp_min(1e-30)
        return torch.where(self.is_ray()[..., None], xy,
                           xy * scale[..., None])


def ray_cone(o, d, tan_alpha=None, x0=None):
    """Cone about a central ray with an isotropic cross-section."""
    sh = o.shape[:-1]
    z = torch.zeros(sh, dtype=torch.float32, device=o.device)
    ta = z if tan_alpha is None else torch.broadcast_to(
        torch.as_tensor(tan_alpha, dtype=torch.float32, device=o.device), sh)
    xx0 = z if x0 is None else torch.broadcast_to(
        torch.as_tensor(x0, dtype=torch.float32, device=o.device), sh)
    return Cone(o=o, d=d, x=frame_mod.build_orthogonal_frame(d).t, x0=xx0,
                tan_alpha=ta, e=torch.ones_like(z))


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


def cone_through_ellipsoid(axes, fr: frame_mod.Frame, ro, rd, tan_alpha):
    """Cone with direction rd through the ellipsoid of axis lengths `axes`
    (..., 3) in frame fr, centred at ro: the ellipsoid's outline seen
    along rd, its principal axes by the 2×2 SVD."""
    wo_local = fr.to_local(rd)
    pf = frame_mod.build_orthogonal_frame(wo_local)
    nn = vec.normalize(axes * wo_local, eps=1e-24)
    fc = frame_mod.build_orthogonal_frame(nn)
    t1 = axes * fc.t
    t2 = axes * fc.b
    a = vec.dot(t1, pf.t)
    c = vec.dot(t1, pf.b)
    b = vec.dot(t2, pf.t)
    d = vec.dot(t2, pf.b)
    cU, sU, lX, lY, _ = svd2x2(a, b, c, d)
    e = torch.where(lY > 1e-20, torch.sqrt(lX / lY.clamp_min(1e-20)), 1.0)
    X3 = cU[..., None] * pf.t + sU[..., None] * pf.b
    x_world = vec.normalize(fr.to_world(X3), eps=1e-24)
    degenerate = (a * d - b * c).abs() < 1e-24
    fallback = frame_mod.build_orthogonal_frame(rd).t
    return Cone(o=ro, d=rd,
                x=torch.where(degenerate[..., None], fallback, x_world),
                x0=torch.where(degenerate, 0.0, lX),
                tan_alpha=torch.broadcast_to(
                    torch.as_tensor(tan_alpha, dtype=lX.dtype,
                                    device=lX.device), lX.shape),
                e=torch.where(degenerate, 1.0, e.clamp_min(1.0)))
