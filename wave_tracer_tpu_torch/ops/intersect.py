"""Primitive intersection tests of the BVH traversal (plain torch).

Port of wave_tracer_tpu/ops/intersect.py (`ray_aabb`, `ray_tri`, `BIG`,
and the point queries `point_segment_dist2`, `tri_point_closest`).
`ray_tri` is the two-sided Möller–Trumbore test, which the BVH route
traces with; the all-pairs kernel K1 tests by Plücker sides instead
(accel/ray_kernels.py), so the two routes may break a tie on a shared
edge differently.

Every product and sum is written out one operation at a time (a cross
product as two multiplications and a subtraction, a dot product as
((x0·y0 + x1·y1) + x2·y2)): each torch operation rounds once, as each
operation of the traversal kernels K4/K5 (csrc/bvh_kernels.cu, built with
-fmad=false) does, so the plain traversal (accel/bvh_kernels.py) and the
kernels give the same bits. min and max propagate NaN, as jnp.minimum /
jnp.maximum do.
"""

from __future__ import annotations

import torch

BIG = 3.4e38               # f32(3.4e38): "no hit" distance


def cross(a, b):
    """a × b over the last axis of two (..., 3) tensors."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def dot(a, b):
    """((a0·b0 + a1·b1) + a2·b2) over the last axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def ray_tri(ro, rd, p0, e1, e2, tmin, tmax):
    """Two-sided Möller–Trumbore. ro, rd (..., 3) rays; p0, e1, e2 (..., 3)
    a vertex and the edges p1 − p0, p2 − p0; broadcasts. Returns (t, u, v,
    hit) with t = BIG where missed; a hit has |det| > 1e-12, u, v ≥ 0,
    u + v ≤ 1 and t in (tmin, tmax]."""
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = ro - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) \
        & (t <= tmax)
    return torch.where(hit, t, BIG), u, v, hit


def ray_aabb(ro, inv_rd, bmin, bmax, tmin, tmax):
    """Slab test of rays (ro, 1/rd) against boxes [bmin, bmax], all (..., 3).
    Returns (t_enter, hit)."""
    t0 = (bmin - ro) * inv_rd
    t1 = (bmax - ro) * inv_rd
    tsm = torch.minimum(t0, t1)
    tbg = torch.maximum(t0, t1)
    t_enter = torch.maximum(torch.maximum(torch.maximum(
        tsm[..., 0], tsm[..., 1]), tsm[..., 2]), tmin)
    t_exit = torch.minimum(torch.minimum(torch.minimum(
        tbg[..., 0], tbg[..., 1]), tbg[..., 2]), tmax)
    return t_enter, t_enter <= t_exit


def safe_inverse(rd):
    """1 / rd with each component at least 1e-30 in magnitude (its sign
    kept, +1e-30 for 0), as the JAX traversals guard it."""
    tiny = torch.where(rd < 0, -1e-30, 1e-30).to(rd.dtype)
    return 1.0 / torch.where(rd.abs() < 1e-30, tiny, rd)


def point_segment_dist2(p, a, b):
    """Squared distance from points p to segments [a, b], all (..., 3),
    and the segment parameter of the closest point: (dist2, t)."""
    ab = b - a
    tproj = (((p - a) * ab).sum(-1)
             / (ab * ab).sum(-1).clamp_min(1e-30)).clamp(0.0, 1.0)
    d = p - (a + tproj[..., None] * ab)
    return (d * d).sum(-1), tproj


def tri_point_closest(p, p0, p1, p2):
    """Squared distance from points p to triangles (p0, p1, p2), all
    (..., 3): to the plane projection where it falls inside the triangle,
    else to the nearest edge."""
    e1 = p1 - p0
    e2 = p2 - p0
    n = torch.linalg.cross(e1, e2, dim=-1)
    nn = (n * n).sum(-1, keepdim=True).clamp_min(1e-30)
    proj = p - ((p - p0) * n).sum(-1, keepdim=True) / nn * n
    d00 = (e1 * e1).sum(-1)
    d01 = (e1 * e2).sum(-1)
    d11 = (e2 * e2).sum(-1)
    d20 = ((proj - p0) * e1).sum(-1)
    d21 = ((proj - p0) * e2).sum(-1)
    denom = (d00 * d11 - d01 * d01).clamp_min(1e-30)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    inside = (v >= 0) & (w >= 0) & (v + w <= 1)
    d2_edge = torch.minimum(torch.minimum(point_segment_dist2(p, p0, p1)[0],
                                          point_segment_dist2(p, p1, p2)[0]),
                            point_segment_dist2(p, p2, p0)[0])
    return torch.where(inside, ((p - proj) ** 2).sum(-1), d2_edge)
