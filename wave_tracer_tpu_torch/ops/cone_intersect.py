"""Exact elliptic-cone intersection tests (batched, branch-free).

Port of wave_tracer_tpu/ops/cone_intersect.py. Every test is a closed-form
masked computation over a (lanes, candidates) block.

Convention: all inputs are in the cone's LOCAL SCALED frame — origin at
the cone origin, z along the propagation axis, x along the major axis,
and the y coordinate pre-multiplied by the eccentricity e, so the cone is
circular with radius r(z) = x0 + tan_alpha * z.
"""

from __future__ import annotations

import torch

BIG = 1e30
_EPS = 1e-12


def _safe_div(a, b, eps=_EPS):
    """a / b with |b| < eps replaced by -eps (b < 0) or +eps (b ≥ 0, so
    b = 0 maps to +eps)."""
    return a / torch.where(b.abs() < eps,
                           torch.where(b < 0, -eps, eps), b)


def _apex_floor(x0, ta, zmin):
    """max(zmin, apex) for ta > 0, else zmin; apex = −x0/ta."""
    apex = -_safe_div(x0, ta.clamp_min(_EPS))
    return torch.maximum(torch.as_tensor(zmin, dtype=apex.dtype,
                                         device=apex.device),
                         torch.where(ta > 0, apex, -BIG))


def cone_contains(x0, ta, p, zmin, zmax):
    """Point-in-cone (local scaled coords). p (..., 3)."""
    z = p[..., 2]
    r = x0 + ta * z
    apex = -_safe_div(x0, ta.clamp_min(_EPS))
    ok = (z >= zmin) & (z <= zmax) & (z >= torch.where(ta > 0, apex, -BIG))
    return ok & (p[..., 0] ** 2 + p[..., 1] ** 2 <= r * r)


def cone_edge_entry(x0, ta, A, B, zmin, zmax):
    """Minimal-z point of segment AB inside the cone.

    A, B (..., 3) local scaled. Returns (z, s, valid): the smallest z with
    A + s*(B-A) inside the cone and z in [zmin, zmax]. The candidate set
    {quadratic roots, s=0, s=1, z-window crossings} is evaluated and
    masked."""
    E = B - A
    r0 = x0 + ta * A[..., 2]
    # q(s) = |P_xy|^2 - r(z)^2 = a s^2 + b s + c <= 0 inside
    a = E[..., 0] ** 2 + E[..., 1] ** 2 - (ta * E[..., 2]) ** 2
    b = 2.0 * (A[..., 0] * E[..., 0] + A[..., 1] * E[..., 1]
               - ta * E[..., 2] * r0)
    c = A[..., 0] ** 2 + A[..., 1] ** 2 - r0 * r0

    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    qq = -0.5 * (b + torch.sign(b) * sq)
    s_r1 = _safe_div(qq, a)
    s_r2 = _safe_div(c, qq)
    lin = a.abs() < _EPS
    s_lin = _safe_div(-c, b)
    s_r1 = torch.where(lin, s_lin, s_r1)
    s_r2 = torch.where(lin, s_lin, s_r2)
    roots_ok = torch.where(lin, b.abs() >= _EPS, disc >= 0.0)

    Ez = E[..., 2]
    s_zlo = _safe_div(zmin - A[..., 2], Ez)
    s_zhi = _safe_div(zmax - A[..., 2], Ez)
    zlo_eff = _apex_floor(x0, ta, zmin)
    tol = 1e-6 * (r0 * r0).clamp_min(1.0)

    best_z = torch.full_like(a, BIG)
    best_s = torch.zeros_like(a)
    for s_c, extra in ((s_r1, roots_ok), (s_r2, roots_ok),
                       (torch.zeros_like(s_r1), None),
                       (torch.ones_like(s_r1), None),
                       (s_zlo, None), (s_zhi, None)):
        s = s_c.clamp(0.0, 1.0)
        q = (a * s + b) * s + c
        z = A[..., 2] + s * Ez
        ok = (q <= tol) & (z >= zlo_eff) & (z <= zmax)
        if extra is not None:
            ok = ok & extra
        better = ok & (z < best_z)
        best_z = torch.where(better, z, best_z)
        best_s = torch.where(better, s, best_s)
    valid = best_z < BIG
    return torch.where(valid, best_z, BIG), best_s, valid


def _bound(a, b):
    """Constraint a*z >= b → (lo, hi) interval contribution."""
    lo = torch.where(a > _EPS, b / a.clamp_min(_EPS), -BIG)
    hi = torch.where(a < -_EPS, b / a.clamp_max(-_EPS), BIG)
    infeasible = (a.abs() <= _EPS) & (b > 0)
    return torch.where(infeasible, BIG, lo), torch.where(infeasible, -BIG, hi)


def cone_plane_entry(x0, ta, n, dist, zmin, zmax):
    """Nearest-z point of the cone-surface ∩ plane conic.

    Plane: n·p = dist in local scaled coords (n need not be unit).
    Returns (z, pxy (..., 2), valid)."""
    rho = torch.sqrt(n[..., 0] ** 2 + n[..., 1] ** 2)
    nz = n[..., 2]
    a1 = rho * ta + nz
    b1 = dist - rho * x0
    a2 = rho * ta - nz
    b2 = -dist - rho * x0
    lo1, hi1 = _bound(a1, b1)
    lo2, hi2 = _bound(a2, b2)
    z_lo = torch.maximum(torch.maximum(lo1, lo2), _apex_floor(x0, ta, zmin))
    z_hi = torch.minimum(torch.minimum(hi1, hi2), zmax)
    valid = z_lo <= z_hi
    z = z_lo
    r = x0 + ta * z
    s = torch.sign(dist - nz * z)
    s = torch.where(s == 0, 1.0, s)
    safe_rho = rho.clamp_min(_EPS)
    pxy = (s * r / safe_rho)[..., None] * n[..., 0:2]
    # rho ~ 0: plane ⊥ axis; take the axis point of the disk
    perp = rho <= _EPS
    z_perp = _safe_div(dist, nz)
    z = torch.where(perp, z_perp, z)
    pxy = torch.where(perp[..., None], 0.0, pxy)
    valid = torch.where(perp, (z_perp >= zmin) & (z_perp <= zmax), valid)
    return z, pxy, valid


def _point_in_tri_2d(p, a, b, c):
    """2D point-in-triangle via signed edge functions."""
    def edge(u, v):
        return (v[..., 0] - u[..., 0]) * (p[..., 1] - u[..., 1]) \
            - (v[..., 1] - u[..., 1]) * (p[..., 0] - u[..., 0])
    e0 = edge(a, b)
    e1 = edge(b, c)
    e2 = edge(c, a)
    pos = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
    neg = (e0 <= 0) & (e1 <= 0) & (e2 <= 0)
    return pos | neg


def _axis_tri(A, B, C):
    """z-axis ray vs triangle in local coords. Returns (z, hit)."""
    n = torch.linalg.cross(B - A, C - A, dim=-1)
    denom = n[..., 2]
    d = (n * A).sum(-1)
    z = _safe_div(d, denom)
    inside = _point_in_tri_2d(torch.zeros_like(A[..., 0:2]),
                              A[..., 0:2], B[..., 0:2], C[..., 0:2])
    return z, inside & (denom.abs() > _EPS)


def intersect_cone_tri(x0, ta, A, B, C, zmin, zmax):
    """Exact cone-triangle intersection: minimal-distance entry point.

    A, B, C (..., 3) in local scaled coords. Returns (z, p (..., 3),
    valid): candidates are vertices inside the cone, cone-edge entries,
    the central-axis hit, and the cone∩plane conic near point when it
    falls inside the triangle; minimum z wins."""
    best_z = torch.full_like(A[..., 0], BIG)
    best_p = torch.zeros_like(A)

    def consider(z, p, ok):
        nonlocal best_z, best_p
        better = ok & (z < best_z)
        best_z = torch.where(better, z, best_z)
        best_p = torch.where(better[..., None], p, best_p)

    for V in (A, B, C):
        consider(V[..., 2], V, cone_contains(x0, ta, V, zmin, zmax))
    for (U, V) in ((A, B), (A, C), (B, C)):
        z, s, ok = cone_edge_entry(x0, ta, U, V, zmin, zmax)
        consider(z, U + s[..., None] * (V - U), ok)
    z_ax, hit_ax = _axis_tri(A, B, C)
    zero = torch.zeros_like(z_ax)
    consider(z_ax, torch.stack([zero, zero, z_ax], dim=-1),
             hit_ax & (z_ax >= zmin) & (z_ax <= zmax))
    n = torch.linalg.cross(B - A, C - A, dim=-1)
    dist = (n * A).sum(-1)
    z_c, pxy, ok_c = cone_plane_entry(x0, ta, n, dist, zmin, zmax)
    p_c = torch.cat([pxy, z_c[..., None]], dim=-1)
    # in-triangle test in the projection that drops the axis of largest
    # |n| component (first of equals, as argmax does)
    drop = n.abs().argmax(-1)

    def proj2(v):
        keep0 = torch.where(drop == 0, v[..., 1], v[..., 0])
        keep1 = torch.where(drop == 2, v[..., 1], v[..., 2])
        return torch.stack([keep0, keep1], dim=-1)

    in_tri = _point_in_tri_2d(proj2(p_c), proj2(A), proj2(B), proj2(C))
    consider(z_c, p_c, ok_c & in_tri)
    valid = best_z < BIG
    return torch.where(valid, best_z, BIG), best_p, valid


def to_local_scaled(ro, xh, yh, zh, e, p):
    """World point(s) → cone local scaled coords. ro/xh/yh/zh (..., 3)
    per-lane frame, e (...,) eccentricity, p (..., 3) points."""
    u = p - ro
    return torch.stack([(u * xh).sum(-1), e * (u * yh).sum(-1),
                        (u * zh).sum(-1)], dim=-1)
