"""Ray–triangle queries of the plain reference: closest hit and any hit.

Möller–Trumbore over every triangle, in blocks of triangles. A pair hits
where the ray's foot lies in the closed triangle and t lies in
(tmin, tmax]; up to three excluded triangle ids per ray; the closest hit
takes the least t, ties to the least id. Besides the answer each query
gives `margin`: how far inside its triangle the foot lies, in world units
(the least of the three barycentric weights times the triangle's height
over the opposite edge), which the comparison uses to tell a ray through
a crack between triangles from a wrong answer.
"""

from __future__ import annotations

import torch

from wtbench.reference import cast

TRI_BLOCK = 8192


def _pairs(v0, e1, e2, h, ro, rd):
    """t, margin (n, b) of every ray against a block of triangles."""
    p = torch.linalg.cross(rd[:, None, :], e2[None], dim=-1)
    det = (e1[None] * p).sum(-1)
    ok = det != 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    s = ro[:, None, :] - v0[None]
    u = (s * p).sum(-1) * inv
    q = torch.linalg.cross(s, e1[None].expand_as(s), dim=-1)
    v = (rd[:, None, :] * q).sum(-1) * inv
    t = (e2[None] * q).sum(-1) * inv
    w = 1.0 - u - v
    margin = torch.minimum(torch.minimum(u * h[None, :, 1], v * h[None, :, 2]),
                           w * h[None, :, 0])
    margin = torch.where(ok, margin, torch.full_like(margin, -torch.inf))
    return t, margin


def _tables(tris, prec):
    """Corner 0, edges and the heights over each corner's opposite edge."""
    tris = cast(tris, prec)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    area2 = torch.linalg.vector_norm(torch.linalg.cross(e1, e2, dim=-1),
                                     dim=-1)
    opp = torch.stack([v2 - v1, v2 - v0, v1 - v0], 1)
    h = area2[:, None] / torch.linalg.vector_norm(opp, dim=-1).clamp_min(
        1e-300)
    return v0, e1, e2, h


def queries(tris, ro, rd, tmin, tmax, ex, prec="f64", tol=0.0):
    """Every ray against every triangle → dict of (n,) tensors:
    t, tri, margin of the closest hit (t = inf and tri = -1 on a miss);
    robust: any hit with margin ≥ tol and t in (tmin + tol, tmax − tol);
    possible: any hit with margin ≥ −tol and t in (tmin − tol, tmax + tol].
    At tol = 0 both are the exact any-hit answer."""
    v0, e1, e2, h = _tables(tris, prec)
    ro, rd, tmin, tmax = (cast(x, prec) for x in (ro, rd, tmin, tmax))
    n = ro.shape[0]
    dev = ro.device
    dt = ro.dtype
    best_t = torch.full((n,), torch.inf, dtype=dt, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.long, device=dev)
    best_m = torch.full((n,), -torch.inf, dtype=dt, device=dev)
    robust = torch.zeros((n,), dtype=torch.bool, device=dev)
    possible = torch.zeros_like(robust)
    ex = ex.long()
    for s in range(0, v0.shape[0], TRI_BLOCK):
        ids = torch.arange(s, min(s + TRI_BLOCK, v0.shape[0]), device=dev)
        t, m = _pairs(v0[ids], e1[ids], e2[ids], h[ids], ro, rd)
        keep = (ids[None, :, None] != ex[:, None, :]).all(-1)
        hit = keep & (m >= 0) & (t > tmin[:, None]) & (t <= tmax[:, None])
        robust |= (keep & (m >= tol) & (t > tmin[:, None] + tol)
                   & (t < tmax[:, None] - tol)).any(1)
        possible |= (keep & (m >= -tol) & (t > tmin[:, None] - tol)
                     & (t <= tmax[:, None] + tol)).any(1)
        tt = torch.where(hit, t, torch.full_like(t, torch.inf))
        bt, j = tt.min(1)                 # the first least: the least id
        better = bt < best_t
        best_t = torch.where(better, bt, best_t)
        best_i = torch.where(better, ids[j], best_i)
        best_m = torch.where(better, m.gather(1, j[:, None])[:, 0], best_m)
    best_i = torch.where(torch.isfinite(best_t), best_i, -1)
    return dict(t=best_t, tri=best_i, margin=best_m, robust=robust,
                possible=possible)


def pair(tris, ro, rd, tri, prec="f64"):
    """(t, margin) of each ray against its own triangle `tri` (n,) ≥ 0."""
    v0, e1, e2, h = _tables(tris[tri.long()], prec)
    ro, rd = cast(ro, prec), cast(rd, prec)
    p = torch.linalg.cross(rd, e2, dim=-1)
    det = (e1 * p).sum(-1)
    inv = 1.0 / torch.where(det != 0, det, torch.ones_like(det))
    s = ro - v0
    u = (s * p).sum(-1) * inv
    q = torch.linalg.cross(s, e1, dim=-1)
    v = (rd * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    m = torch.minimum(torch.minimum(u * h[:, 1], v * h[:, 2]),
                      (1.0 - u - v) * h[:, 0])
    return t, torch.where(det != 0, m, torch.full_like(m, -torch.inf))
