"""Wedge edges and the edge sweep of the plain reference.

`wedges` finds the diffracting edges of a triangle set: edges shared by
two triangles (matched by their corners quantized to 1e-6 of the scene's
extent) whose faces meet at more than 20° from coplanar, then edges of
one triangle; each group in the lexicographic order of its corners' keys
(the keys, the midpoints and the clusters in float32, as stored).
`clusters` buckets them by the grid cell of their midpoints (about 32
edges a cell) with a bounding sphere per cell. `sweep` is the
integrators' edge query: per lane the K edges of least cone entry (ties
to the earlier candidate), over every edge up to 2,048 edges and, above,
over the first 64 edges of each of the 8 clusters whose sphere the
lane's widest radius reaches, nearest along the axis first.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from wtbench.reference import cones

PLANAR_DEG = 20.0
MAX_PLAIN = 2048
N_CLUSTERS = 8
PER_CLUSTER = 64


def _normals(tris):
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def wedges(tris32):
    """tris32 (T, 3, 3) float32 corners → dict of numpy float32 arrays
    p0, p1, center and the count of interior (two-face) edges first."""
    tris32 = np.asarray(tris32, np.float32)
    T = len(tris32)
    # the quantization in the stored (float32) arithmetic
    q = 1e-6 * max(np.abs(tris32).max(), 1.0)
    keys = np.round(tris32 / q).astype(np.int64)
    a = np.concatenate([keys[:, 0], keys[:, 1], keys[:, 2]])
    b = np.concatenate([keys[:, 1], keys[:, 2], keys[:, 0]])
    pa = np.concatenate([tris32[:, 0], tris32[:, 1], tris32[:, 2]])
    pb = np.concatenate([tris32[:, 1], tris32[:, 2], tris32[:, 0]])
    tri = np.tile(np.arange(T), 3)
    swap = [tuple(x) > tuple(y) for x, y in zip(a.tolist(), b.tolist())]
    swap = np.array(swap, bool)
    lo = np.where(swap[:, None], b, a)
    hi = np.where(swap[:, None], a, b)
    key = np.concatenate([lo, hi], 1)
    order = np.lexsort(key.T[::-1])
    key, tri, pa, pb = key[order], tri[order], pa[order], pb[order]
    new = np.concatenate([[True], np.any(key[1:] != key[:-1], 1)])
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, len(key)))
    gn = _normals(tris32.astype(np.float64))
    cent = tris32.astype(np.float64).mean(1)
    out = {"p0": [], "p1": []}
    interior = 0
    for run in (2, 1):
        s = starts[counts == run]
        p0 = pa[s].astype(np.float64)
        p1 = pb[s].astype(np.float64)
        keep = np.linalg.norm(p1 - p0, axis=-1) > 1e-12
        if run == 2:
            tA, tB = tri[s], tri[s + 1]
            n1, n2 = gn[tA], gn[tB]
            m = 0.5 * (p0 + p1)
            c1 = (n1 * (cent[tB] - m)).sum(-1) > 0
            c2 = (n2 * (cent[tA] - m)).sum(-1) > 0
            angle = np.degrees(np.arccos(np.clip((n1 * n2).sum(-1), -1, 1)))
            keep &= (c1 == c2) & (angle > PLANAR_DEG)
            interior = int(keep.sum())
        out["p0"].append(p0[keep])
        out["p1"].append(p1[keep])
    p0 = np.concatenate(out["p0"]).astype(np.float32)
    p1 = np.concatenate(out["p1"]).astype(np.float32)
    center = (0.5 * (p0 + p1)).astype(np.float32)
    return dict(p0=p0, p1=p1, center=center, interior=interior)


def clusters(w):
    """Grid clusters of the wedge edges `w` → dict of numpy arrays:
    center (M, 3), radius (M,), start, count (M,), order (E,)."""
    c = w["center"]
    E = len(c)
    grid = max(2, int(round((max(E, 1) / 32.0) ** (1.0 / 3.0))))
    lo, hi = c.min(0), c.max(0)
    ext = np.maximum(hi - lo, np.float32(1e-9))
    cell = np.minimum((c - lo) / ext * np.float32(grid),
                      np.float32(grid - 1e-4)).astype(np.int64)
    key = (cell[:, 0] * grid + cell[:, 1]) * grid + cell[:, 2]
    order = np.argsort(key, kind="stable")
    ks = key[order]
    start = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
    count = np.diff(np.append(start, E))
    center = np.zeros((len(start), 3), np.float32)
    radius = np.zeros(len(start), np.float32)
    for m, (s, k) in enumerate(zip(start, count)):
        ids = order[s:s + k]
        pts = np.concatenate([w["p0"][ids], w["p1"][ids]])
        center[m] = pts.mean(0)
        radius[m] = np.linalg.norm(pts - center[m], axis=1).max()
    return dict(center=center, radius=radius, start=start, count=count,
                order=order)


def candidates(w, cl, lane):
    """(n, J) candidate edge rows of each lane (−1: none)."""
    n = lane["ro"].shape[0]
    dev = lane["ro"].device
    E = len(w["p0"])
    if E <= MAX_PLAIN:
        return torch.arange(E, device=dev)[None].expand(n, E)
    f32 = torch.float32
    ro, rd, x0, ta, zmax = (lane[k].to(f32) for k in
                            ("ro", "rd", "x0", "ta", "zmax"))
    cen = torch.as_tensor(cl["center"], device=dev)
    rad = torch.as_tensor(cl["radius"], device=dev)
    wv = cen[None] - ro[:, None]
    zc = (wv * rd[:, None]).sum(-1).clamp_min(0.0)
    near = ro[:, None] + zc[..., None] * rd[:, None]
    dist = torch.linalg.vector_norm(near - cen[None], dim=-1)
    reach = x0[:, None] + ta[:, None] * zc + rad[None]
    ok = (dist <= reach) & (zc - rad[None] <= zmax[:, None])
    zs, sel = torch.sort(torch.where(ok, zc, torch.inf), dim=1, stable=True)
    zs, sel = zs[:, :N_CLUSTERS], sel[:, :N_CLUSTERS]
    start = torch.as_tensor(cl["start"], device=dev)[sel]
    count = torch.as_tensor(cl["count"], device=dev)[sel]
    offs = torch.arange(PER_CLUSTER, device=dev)
    pos = start[..., None] + offs
    take = (offs < count[..., None]) & torch.isfinite(zs)[..., None]
    order = torch.as_tensor(cl["order"], device=dev)
    rows = order[pos.clamp_max(E - 1)]
    return torch.where(take, rows, -1).reshape(n, -1)


def sweep(w, cl, lane, prec="f64", grow=0.0):
    """Per lane: (cand (n, J) rows, the cone's entry z (n, J) into each,
    inf where none or no candidate)."""
    cand = candidates(w, cl, lane)
    dev = lane["ro"].device
    p0 = torch.as_tensor(w["p0"], device=dev)
    p1 = torch.as_tensor(w["p1"], device=dev)
    c = cand.clamp_min(0)
    z = cones.segment_entries(p0[c], p1[c], lane, prec, grow)
    return cand, torch.where(cand >= 0, z, math.inf)
