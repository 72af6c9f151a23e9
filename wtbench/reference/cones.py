"""Cone entries of the plain reference: the least z at which each lane's
elliptic cone meets each triangle (the cone kernel's query) or each edge
segment (the edge sweep's).

A lane's cone, in its local frame (x along the major axis xh, y along
rd × xh scaled by the eccentricity e, z along rd, origin ro), is
    x² + y² ≤ (x0 + ta·z)²,   zlo ≤ z ≤ zmax,
with zlo = max(zmin, −x0/ta) where ta > 0 and zmin otherwise. The entry
of a set is the least z of its points in the cone. For a triangle or a
segment that least z lies at one of a finite set of points, each tested
for membership and the least member kept:
  - the corners;
  - along each edge: the roots of x² + y² − (x0 + ta·z)² = 0 and the
    crossings of the planes z = zlo and z = zmax;
  - in the triangle's plane: the two points where the conic section
    reaches its extreme z (in the vertical plane through the axis and the
    plane normal's xy part), the section line's two points on the circle
    of each plane z = zlo, z = zmax, and the axis' crossing.
`grow` widens the cone (x0 + grow, the z window by grow at both ends) or,
negative, narrows it: the comparison brackets a float32 answer between
the entries of a narrower and a wider cone.
"""

from __future__ import annotations

import torch

from wtbench.reference import cast

TRI_BLOCK = 2048


def local(points, lane, prec):
    """World points (n, m, 3) or (m, 3) → local (n, m, 3) of each lane."""
    ro, rd, xh, e = (cast(lane[k], prec) for k in ("ro", "rd", "xh", "e"))
    yh = torch.linalg.cross(rd, xh, dim=-1)
    p = cast(points, prec)
    if p.dim() == 2:
        p = p[None]
    u = p - ro[:, None, :]
    return torch.stack([(u * xh[:, None]).sum(-1),
                        e[:, None] * (u * yh[:, None]).sum(-1),
                        (u * rd[:, None]).sum(-1)], -1)


def _window(lane, prec, grow):
    x0, ta, zmax = (cast(lane[k], prec)[:, None]
                    for k in ("x0", "ta", "zmax"))
    zmin = lane["zmin"]        # a float, or one per call of a batch
    zmin = torch.full_like(x0, float(zmin[0] if isinstance(zmin, list)
                                     else zmin))
    apex = -x0 / torch.where(ta > 0, ta, torch.ones_like(ta))
    zlo = torch.where(ta > 0, torch.maximum(zmin, apex), zmin)
    # the apex moves with the widened x0 (x0 + grow), so it stays the apex
    g = torch.as_tensor(grow, dtype=x0.dtype, device=x0.device)
    apex_g = -(x0 + g) / torch.where(ta > 0, ta, torch.ones_like(ta))
    zlo = torch.where(ta > 0, torch.maximum(zmin - g, apex_g), zlo - g)
    return x0 + g, ta, zlo, zmax + g


def _inside(p, x0, ta, zlo, zmax, slack):
    r = x0 + ta * p[..., 2]
    q = p[..., 0] ** 2 + p[..., 1] ** 2 - r * r
    return (q <= slack * (1.0 + r * r)) & (p[..., 2] >= zlo - slack) \
        & (p[..., 2] <= zmax + slack)


def _segment_points(A, B, x0, ta, zlo, zmax):
    """Candidate points (…, 4, 3) on segments AB: the quadratic's roots
    and the slab-plane crossings (NaN where there is none)."""
    E = B - A
    r0 = x0 + ta * A[..., 2]
    a = E[..., 0] ** 2 + E[..., 1] ** 2 - (ta * E[..., 2]) ** 2
    b = 2.0 * (A[..., 0] * E[..., 0] + A[..., 1] * E[..., 1]
               - ta * E[..., 2] * r0)
    c = A[..., 0] ** 2 + A[..., 1] ** 2 - r0 * r0
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    # the numerically stable pair of roots, or the linear root
    qq = -0.5 * (b + torch.where(b >= 0, sq, -sq))
    nan = torch.full_like(a, torch.nan)
    lin = a.abs() <= 1e-300
    s1 = torch.where(lin, -c / torch.where(b != 0, b, nan), qq / a)
    s2 = torch.where(lin, nan, c / torch.where(qq != 0, qq, nan))
    s1 = torch.where(disc >= 0, s1, nan)
    s2 = torch.where(disc >= 0, s2, nan)
    dz = torch.where(E[..., 2] != 0, E[..., 2], nan)
    s3 = (zlo - A[..., 2]) / dz
    s4 = (zmax - A[..., 2]) / dz
    s = torch.stack([s1, s2, s3, s4], -1)
    s = torch.where((s >= 0) & (s <= 1), s, torch.nan)
    return A[..., None, :] + s[..., None] * E[..., None, :]


def _plane_points(A, B, C, x0, ta, zlo, zmax):
    """Candidate points (…, 7, 3) in each triangle's plane (NaN where
    none): the section's two extreme points, the section line's points on
    the circles of z = zlo and z = zmax, and the axis crossing."""
    n = torch.linalg.cross(B - A, C - A, dim=-1)
    d = (n * A).sum(-1)
    nx, ny, nz = n.unbind(-1)
    rho = torch.sqrt(nx * nx + ny * ny)
    nan = torch.full_like(d, torch.nan)
    ok_rho = rho > 0
    ux = torch.where(ok_rho, nx / torch.where(ok_rho, rho, 1.0), nan)
    uy = torch.where(ok_rho, ny / torch.where(ok_rho, rho, 1.0), nan)
    pts = []
    for sgn in (1.0, -1.0):
        den = sgn * ta * rho + nz
        z = (d - sgn * x0 * rho) / torch.where(den != 0, den, nan)
        r = x0 + ta * z
        pts.append(torch.stack([sgn * r * ux, sgn * r * uy, z], -1))
    for h in (zlo.expand_as(d), zmax.expand_as(d)):
        r = x0 + ta * h
        off = (d - nz * h) / torch.where(ok_rho, rho, nan)
        half = torch.sqrt(r * r - off * off)     # NaN: the line misses
        for sgn in (1.0, -1.0):
            pts.append(torch.stack([off * ux - sgn * half * uy,
                                    off * uy + sgn * half * ux, h], -1))
    z_ax = d / torch.where(nz != 0, nz, nan)
    pts.append(torch.stack([torch.zeros_like(z_ax), torch.zeros_like(z_ax),
                            z_ax], -1))
    return torch.stack(pts, -2)


def _in_triangle(P, A, B, C, slack):
    """Whether points P (…, m, 3) lie in triangles A, B, C (…, 3)."""
    v0, v1 = (B - A)[..., None, :], (C - A)[..., None, :]
    v2 = P - A[..., None, :]
    d00 = (v0 * v0).sum(-1)
    d01 = (v0 * v1).sum(-1)
    d11 = (v1 * v1).sum(-1)
    d20 = (v2 * v0).sum(-1)
    d21 = (v2 * v1).sum(-1)
    den = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / den
    w = (d00 * d21 - d01 * d20) / den
    return (v >= -slack) & (w >= -slack) & (v + w <= 1 + slack)


def _least(P, ok):
    z = torch.where(ok & ~torch.isnan(P[..., 2]), P[..., 2],
                    torch.full_like(P[..., 2], torch.inf))
    return z.min(-1).values


def _slack(prec):
    return 1e-9 if prec == "f64" else 1e-4


def triangle_entries(tris, lane, prec="f64", grow=0.0):
    """(n, T) least entry z of each lane's cone into each triangle, inf
    where the cone does not meet it."""
    x0, ta, zlo, zmax = _window(lane, prec, grow)
    sl = _slack(prec)
    out = []
    for s in range(0, tris.shape[0], TRI_BLOCK):
        block = tris[s:s + TRI_BLOCK]
        A, B, C = (local(block[:, i], lane, prec) for i in range(3))
        cone = (x0[..., None], ta[..., None], zlo[..., None],
                zmax[..., None])
        corners = torch.stack([A, B, C], -2)
        z = _least(corners, _inside(corners, *cone, sl))
        for P, Q in ((A, B), (B, C), (C, A)):
            pts = _segment_points(P, Q, x0, ta, zlo, zmax)
            z = torch.minimum(z, _least(pts, _inside(pts, *cone, sl)))
        pts = _plane_points(A, B, C, x0, ta, zlo, zmax)
        ok = _inside(pts, *cone, sl) & _in_triangle(pts, A, B, C, sl)
        out.append(torch.minimum(z, _least(pts, ok)))
    return torch.cat(out, 1)


def segment_entries(p0, p1, lane, prec="f64", grow=0.0):
    """(n, J) least z of each segment p0 → p1 (given per lane (n, J, 3) or
    shared (J, 3)) inside each lane's cone; inf where it does not meet
    it."""
    x0, ta, zlo, zmax = _window(lane, prec, grow)
    A, B = local(p0, lane, prec), local(p1, lane, prec)
    cone = (x0[..., None], ta[..., None], zlo[..., None], zmax[..., None])
    sl = _slack(prec)
    pts = torch.cat([torch.stack([A, B], -2),
                     _segment_points(A, B, x0, ta, zlo, zmax)], -2)
    ok = _inside(pts, *cone, sl) & ~torch.isnan(pts[..., 2])
    return torch.where(ok, pts[..., 2], torch.inf).min(-1).values
