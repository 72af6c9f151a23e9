"""Edge extraction & classification for free-space diffraction, and the
exact cone-mode edge query.

Port of wave_tracer_tpu/accel/edges.py (`EdgeTable`, `classify_edges`,
`_exact_cone_entries`, `edges_near_cone`, `EdgeClusters`,
`build_edge_clusters`, `edges_near_cone_clustered`, and the ball and ray
queries no integrator calls: `edges_in_ball`, `edges_near_ray`,
`edges_near_ray_clustered`). The classification
is numpy host code: a vectorized hash join over quantized vertex
positions finds triangle pairs sharing two vertices and builds wedge
records carrying both outward face normals, the face tangents and the
wedge angle α = π − acos(n1·n2); near-planar wedges (faces within 20° of
coplanar) are dropped and boundary edges get n2 = −n1.

Above MAX_UNCLUSTERED_EDGES edges the integrators take the clustered
sweep (`edges_in_cone` chooses, as the JAX integrators do): the edges are
bucketed by the grid cell of their centre into clusters with bounding
spheres (a host bake), and a lane tests its cone against the spheres,
keeps the N_CLUSTERS nearest clusters and runs the exact entry test on
the first EDGES_PER_CLUSTER edges of each. Plain torch: gathers and two top-k selections.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from wave_tracer_tpu_torch.accel import select
from wave_tracer_tpu_torch.math import vec
from wave_tracer_tpu_torch.ops import cone_intersect as ci

# keep wedges with interior angle at most this
PLANAR_ANGLE_DEG = 160.0
# above this edge count the JAX integrators switch to the clustered sweep
MAX_UNCLUSTERED_EDGES = 2048
# the clustered sweep: clusters kept per lane, edges tested per cluster
N_CLUSTERS = 8
EDGES_PER_CLUSTER = 64

EDGE_KEYS = ("p0", "p1", "e", "n1", "n2", "t1", "t2", "alpha", "length",
             "center", "tri1", "tri2")


@dataclass
class EdgeTable:
    p0: torch.Tensor       # (E, 3) edge endpoint
    p1: torch.Tensor       # (E, 3)
    e: torch.Tensor        # (E, 3) unit edge direction p0→p1
    n1: torch.Tensor       # (E, 3) face-1 outward wedge normal
    n2: torch.Tensor       # (E, 3) face-2 outward normal (−n1 boundary)
    t1: torch.Tensor       # (E, 3) face-1 tangent (⊥ e, into the face)
    t2: torch.Tensor       # (E, 3) face-2 tangent
    alpha: torch.Tensor    # (E,) wedge opening angle
    length: torch.Tensor   # (E,)
    center: torch.Tensor   # (E, 3)
    tri1: torch.Tensor     # (E,) i32 face-1 triangle (device order)
    tri2: torch.Tensor     # (E,) i32 (−1 boundary)

    def __post_init__(self):
        # (E, 24) packed row: p0(0:3) ê(3:6) n1(6:9) n2(9:12) t1(12:15)
        # t2(15:18) α(18) len(19) pad — one gather serves an aperture
        self.pack = torch.cat([
            self.p0, self.e, self.n1, self.n2, self.t1, self.t2,
            self.alpha[:, None], self.length[:, None],
            self.p0.new_zeros((self.count, 4))], dim=1)

    @property
    def count(self):
        return self.p0.shape[0]


def classify_edges(positions: np.ndarray, geo_n: np.ndarray,
                   quant: float = 1e-6) -> dict:
    """positions (T, 3, 3) and geometric normals (T, 3) in device order →
    dict of numpy arrays keyed by EDGE_KEYS (f32, tri ids i32)."""
    T = len(positions)
    if T == 0:
        return _empty()

    scale = max(np.abs(positions).max(), 1.0)
    q = quant * scale
    keys = np.round(positions / q).astype(np.int64)       # (T, 3, 3)

    # every triangle edge: (vertex a, vertex b) with a sorted key pair
    ea = np.concatenate([keys[:, 0], keys[:, 1], keys[:, 2]])
    eb = np.concatenate([keys[:, 1], keys[:, 2], keys[:, 0]])
    pa = np.concatenate([positions[:, 0], positions[:, 1], positions[:, 2]])
    pb = np.concatenate([positions[:, 1], positions[:, 2], positions[:, 0]])
    tri_idx = np.concatenate([np.arange(T)] * 3)

    flip = _lexless(eb, ea)
    ka = np.where(flip[:, None], eb, ea)
    kb = np.where(flip[:, None], ea, eb)
    key = np.concatenate([ka, kb], axis=1)               # (3T, 6)

    order = np.lexsort(key.T[::-1])
    key_s = key[order]
    tri_s = tri_idx[order]
    pa_s = pa[order]
    pb_s = pb[order]

    same = np.all(key_s[1:] == key_s[:-1], axis=1)
    # runs of identical keys: 1 = boundary, 2 = interior wedge, >2 =
    # non-manifold (dropped)
    starts = np.concatenate([[0], np.nonzero(~same)[0] + 1])
    counts = np.diff(np.concatenate([starts, [len(key_s)]]))

    p0_list, p1_list, n1_list, n2_list = [], [], [], []
    t1_list, t2_list = [], []
    s2 = starts[counts == 2]
    s1 = starts[counts == 1]
    if len(s2):
        tA = tri_s[s2]
        tB = tri_s[s2 + 1]
        p0_list.append(pa_s[s2])
        p1_list.append(pb_s[s2])
        n1_list.append(geo_n[tA])
        n2_list.append(geo_n[tB])
        t1_list.append(tA)
        t2_list.append(tB)
    if len(s1):
        tA = tri_s[s1]
        p0_list.append(pa_s[s1])
        p1_list.append(pb_s[s1])
        n1_list.append(geo_n[tA])
        n2_list.append(-geo_n[tA])
        t1_list.append(tA)
        t2_list.append(np.full(len(s1), -1, np.int64))
    if not p0_list:
        return _empty()
    p0 = np.concatenate(p0_list)
    p1 = np.concatenate(p1_list)
    n1 = np.concatenate(n1_list)
    n2 = np.concatenate(n2_list)
    tA = np.concatenate(t1_list)
    tB = np.concatenate(t2_list)

    d = p1 - p0
    length = np.linalg.norm(d, axis=-1)
    ok = length > 1e-12
    p0, p1, n1, n2, tA, tB, d, length = (
        a[ok] for a in (p0, p1, n1, n2, tA, tB, d, length))
    if len(p0) == 0:
        return _empty()
    e = d / length[:, None]
    m = 0.5 * (p0 + p1)
    cent = positions.mean(axis=1)
    interior = tB >= 0
    c1 = cent[tA]
    c2 = cent[np.where(interior, tB, tA)]

    # concave wedges: flip both normals outwards; inconsistent pairs drop
    concave1 = np.sum(n1 * (c2 - m), axis=-1) > 0
    concave2 = np.sum(n2 * (c1 - m), axis=-1) > 0
    inconsistent = interior & (concave1 != concave2)
    flip = interior & concave1 & concave2
    n1 = np.where(flip[:, None], -n1, n1)
    n2 = np.where(flip[:, None], -n2, n2)

    # face tangents ⊥ edge, pointing into each face
    t1v = np.cross(n1, e)
    t1v = np.where((np.sum(t1v * (c1 - m), axis=-1) < 0)[:, None],
                   -t1v, t1v)
    t2v = np.cross(n2, e)
    t2v = np.where((np.sum(t2v * (c2 - m), axis=-1) < 0)[:, None],
                   -t2v, t2v)
    t2v = np.where(interior[:, None], t2v, t1v)

    # wedge angle; drop near-planar interior wedges
    cosn = np.clip(np.sum(n1 * n2, axis=-1), -1.0, 1.0)
    face_angle = np.degrees(np.arccos(cosn))   # 0 = coplanar faces
    keep = (~interior | (face_angle > (180.0 - PLANAR_ANGLE_DEG))) \
        & ~inconsistent
    alpha = np.maximum(0.0, math.pi - np.arccos(cosn))

    (p0, p1, n1, n2, t1v, t2v, tA, tB, alpha, e, length) = (
        a[keep] for a in (p0, p1, n1, n2, t1v, t2v, tA, tB, alpha, e,
                          length))
    if len(p0) == 0:
        return _empty()
    f32 = np.float32
    return dict(p0=p0.astype(f32), p1=p1.astype(f32), e=e.astype(f32),
                n1=n1.astype(f32), n2=n2.astype(f32), t1=t1v.astype(f32),
                t2=t2v.astype(f32), alpha=alpha.astype(f32),
                length=length.astype(f32),
                center=(0.5 * (p0 + p1)).astype(f32),
                tri1=tA.astype(np.int32), tri2=tB.astype(np.int32))


def _lexless(a, b):
    """Lexicographic a < b over the last axis (3 ints)."""
    lt = a[:, 0] < b[:, 0]
    eq0 = a[:, 0] == b[:, 0]
    lt1 = a[:, 1] < b[:, 1]
    eq1 = a[:, 1] == b[:, 1]
    lt2 = a[:, 2] < b[:, 2]
    return lt | (eq0 & (lt1 | (eq1 & lt2)))


def _empty() -> dict:
    z3 = np.zeros((0, 3), np.float32)
    z = np.zeros((0,), np.float32)
    zi = np.zeros((0,), np.int32)
    return dict(p0=z3, p1=z3, e=z3, n1=z3, n2=z3, t1=z3, t2=z3, alpha=z,
                length=z, center=z3, tri1=zi, tri2=zi)


# ---------------------------------------------------------------------------
# device query
# ---------------------------------------------------------------------------

def _exact_cone_entries(ro, rd, env, p0, p1, zmax, zmin: float = 1e-7):
    """Exact elliptic cone–edge entry distances for candidate segments
    p0/p1 (N, J, 3). Returns (z (N, J), ok (N, J))."""
    N, J = p0.shape[:2]
    xh = env.x[:, None, :]
    yh = vec.cross(rd, env.x)[:, None, :]
    ecc = env.e[:, None]
    rdj = rd[:, None, :]

    def to_local(p):
        w = p - ro[:, None, :]
        return torch.stack([(w * xh).sum(-1), ecc * (w * yh).sum(-1),
                            (w * rdj).sum(-1)], dim=-1)

    z, _, ok = ci.cone_edge_entry(
        env.x0[:, None], env.ta[:, None], to_local(p0), to_local(p1),
        torch.full((N, J), zmin, dtype=torch.float32, device=ro.device),
        zmax[:, None].expand(N, J))
    return z, ok


def edges_near_cone(edges: EdgeTable, ro, rd, env, zmax, K: int,
                    tile: int = 1024):
    """Exact elliptic cone-mode edge set: the K earliest entries, ordered
    by entry distance (ties to the lower edge id, as jax.lax.top_k).
    Returns (idx (N, K) i32 with −1 padding, z (N, K) inf-padded,
    count (N,) i32)."""
    E = edges.count
    N = ro.shape[0]
    if E == 0:
        return select.empty_set(N, K, ro.device)

    def keys(s, n):
        z, ok = _exact_cone_entries(ro, rd, env,
                                    edges.p0[None, s:s + n].expand(N, n, 3),
                                    edges.p1[None, s:s + n].expand(N, n, 3),
                                    zmax)
        return torch.where(ok, z, math.inf)
    # padded edges are masked out, so a tile of min(tile, E) gives the
    # same result without (N, 1024, 3) temporaries for a 16-edge scene
    return select.tiled_smallest(N, E, K, min(tile, E), ro.device, keys)


# ---------------------------------------------------------------------------
# clustered sweep (above MAX_UNCLUSTERED_EDGES edges)
# ---------------------------------------------------------------------------

CLUSTER_KEYS = ("center", "radius", "start", "count", "order")


@dataclass
class EdgeClusters:
    """Two-level edge index: bounding-sphere clusters over grid cells."""
    center: torch.Tensor   # (M, 3)
    radius: torch.Tensor   # (M,)
    start: torch.Tensor    # (M,) i32 into `order`
    count: torch.Tensor    # (M,) i32
    order: torch.Tensor    # (E,) i32 edge rows grouped by cluster

    @property
    def num_clusters(self):
        return self.center.shape[0]


def build_edge_clusters(edges: dict) -> dict:
    """Host bake of the edge table `edges` (numpy arrays keyed by
    EDGE_KEYS): bucket the edges by the grid cell of their centre, the
    grid sized so that clusters average ~32 edges → dict of numpy arrays
    keyed by CLUSTER_KEYS; each cluster's sphere is centred on the mean of
    its edges' endpoints."""
    c = np.asarray(edges["center"])
    E = len(c)
    grid = max(2, int(round((max(E, 1) / 32.0) ** (1.0 / 3.0))))
    if E == 0:
        return dict(center=np.zeros((1, 3), np.float32),
                    radius=np.zeros(1, np.float32),
                    start=np.zeros(1, np.int32), count=np.zeros(1, np.int32),
                    order=np.zeros(0, np.int32))
    p0 = np.asarray(edges["p0"])
    p1 = np.asarray(edges["p1"])
    lo = c.min(axis=0)
    hi = c.max(axis=0)
    ext = np.maximum(hi - lo, 1e-9)
    cell = np.minimum((c - lo) / ext * grid, grid - 1e-4).astype(np.int64)
    key = (cell[:, 0] * grid + cell[:, 1]) * grid + cell[:, 2]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    starts = np.concatenate([[0], np.nonzero(np.diff(key_s))[0] + 1])
    counts = np.diff(np.concatenate([starts, [E]]))
    M = len(starts)
    center = np.zeros((M, 3), np.float32)
    radius = np.zeros(M, np.float32)
    for m in range(M):
        ids = order[starts[m]: starts[m] + counts[m]]
        pts = np.concatenate([p0[ids], p1[ids]])
        ctr = pts.mean(axis=0)
        center[m] = ctr
        radius[m] = np.linalg.norm(pts - ctr, axis=1).max()
    return dict(center=center, radius=radius, start=starts.astype(np.int32),
                count=counts.astype(np.int32), order=order.astype(np.int32))


def edges_near_cone_clustered(edges: EdgeTable, clusters: EdgeClusters,
                              ro, rd, env, zmax, K: int):
    """Clustered exact cone-mode edge set: a conservative sphere prefilter
    per cluster (the major-axis radius encloses the elliptic envelope)
    keeps each lane's N_CLUSTERS nearest clusters along its axis; the
    exact cone–edge entries of their first EDGES_PER_CLUSTER edges give
    the K earliest. Returns `edges_near_cone`'s (idx, z, count)."""
    N = ro.shape[0]
    dev = ro.device
    if edges.count == 0:
        return select.empty_set(N, K, dev)
    w = clusters.center[None, :, :] - ro[:, None, :]
    zc = (w * rd[:, None, :]).sum(-1).clamp_min(0.0)
    closest = ro[:, None, :] + zc[..., None] * rd[:, None, :]
    dist = torch.linalg.vector_norm(closest - clusters.center[None], dim=-1)
    reach = env.x0[:, None] + env.ta[:, None] * zc + clusters.radius[None]
    okc = (dist <= reach) & (zc - clusters.radius[None] <= zmax[:, None])
    zsel, sel = select.smallest(torch.where(okc, zc, math.inf), N_CLUSTERS)
    valid_cl = torch.isfinite(zsel)

    base = clusters.start[sel].long()
    cnt = clusters.count[sel]
    offs = torch.arange(EDGES_PER_CLUSTER, device=dev)
    cand = base[..., None] + offs[None, None, :]
    in_range = (offs[None, None, :] < cnt[..., None]) & valid_cl[..., None]
    cand = cand.clamp(0, clusters.order.shape[0] - 1)
    eidx = clusters.order[cand].reshape(N, -1)
    in_range = in_range.reshape(N, -1)
    ei = eidx.long()
    z, ok = _exact_cone_entries(ro, rd, env, edges.p0[ei], edges.p1[ei],
                                zmax)
    return select.pick(torch.where(ok & in_range, z, math.inf), eidx, K)


# ---------------------------------------------------------------------------
# ball and ray queries (plain torch; no integrator calls them)
# ---------------------------------------------------------------------------

def edges_in_ball(edges: EdgeTable, center, radius, K: int,
                  tile: int = 1024):
    """The K nearest edges whose segment meets the ball (center (N, 3),
    radius (N,)), nearest first. Returns (idx (N, K) i32 −1-padded, dist
    (N, K) inf-padded, count (N,) i32)."""
    E = edges.count
    N = center.shape[0]
    dev = center.device
    if E == 0:
        return select.empty_set(N, K, dev)
    d = edges.p1 - edges.p0

    def keys(s, n):
        tp0, td = edges.p0[s:s + n], d[s:s + n]
        tl = edges.length[s:s + n]
        w = center[:, None, :] - tp0[None]
        t_par = ((w * td[None]).sum(-1)
                 / (tl * tl).clamp_min(1e-30)[None]).clamp(0.0, 1.0)
        q = tp0[None] + t_par[..., None] * td[None]
        dist = torch.linalg.vector_norm(center[:, None, :] - q, dim=-1)
        return torch.where(dist <= radius[:, None], dist, math.inf)
    return select.tiled_smallest(N, E, K, tile, dev, keys)


def _ray_segment_keys(ro, rd, x0, tan_alpha, zmax, p0, ed, ll):
    """Closest approach of rays (ro, rd) (N, 3) to segments p0 + u·ed (N or
    1, n, 3) of lengths ll: the ray parameter z of each pair where the
    segment comes within x0 + tanα·z of the ray at 0 < z < zmax, else
    inf. (N, n)."""
    w0 = ro[:, None, :] - p0
    b = (rd[:, None, :] * ed).sum(-1)
    c = (ll * ll).clamp_min(1e-30)
    ddot = (rd[:, None, :] * w0).sum(-1)
    edot = (ed * w0).sum(-1)
    denom = c - b * b
    u = ((b * -ddot + edot) / torch.where(denom < 1e-20, 1e-20, denom)
         ).clamp(0.0, 1.0)
    z = (-ddot + b * u).clamp_min(0.0)
    u = ((z * b + edot) / c).clamp(0.0, 1.0)       # u of the clamped z
    q = p0 + u[..., None] * ed
    pr = ro[:, None, :] + z[..., None] * rd[:, None, :]
    dist = torch.linalg.vector_norm(pr - q, dim=-1)
    ok = (dist <= x0[:, None] + tan_alpha[:, None] * z) & (z > 1e-7) \
        & (z < zmax[:, None])
    return torch.where(ok, z, math.inf)


def edges_near_ray(edges: EdgeTable, ro, rd, x0, tan_alpha, zmax, K: int,
                   tile: int = 1024):
    """Edges inside the swept circular envelope x0 + tanα·z of each ray
    segment (0, zmax): the K earliest by the ray parameter z of closest
    approach. Returns (idx (N, K) −1-padded, z (N, K), count (N,))."""
    E = edges.count
    N = ro.shape[0]
    dev = ro.device
    if E == 0:
        return select.empty_set(N, K, dev)
    ed = edges.p1 - edges.p0

    def keys(s, n):
        return _ray_segment_keys(ro, rd, x0, tan_alpha, zmax,
                                 edges.p0[None, s:s + n], ed[None, s:s + n],
                                 edges.length[None, s:s + n])
    return select.tiled_smallest(N, E, K, tile, dev, keys)


def edges_near_ray_clustered(edges: EdgeTable, clusters: EdgeClusters, ro,
                             rd, x0, tan_alpha, zmax, K: int,
                             n_clusters: int = 8,
                             edges_per_cluster: int = 64):
    """Clustered `edges_near_ray`: the swept envelope against the cluster
    spheres (each lane's n_clusters earliest by the closest-approach z of
    the sphere's centre), then the exact segment test on the first
    edges_per_cluster edges of each. The same contract."""
    N = ro.shape[0]
    dev = ro.device
    if edges.count == 0:
        return select.empty_set(N, K, dev)
    w = clusters.center[None, :, :] - ro[:, None, :]
    zc = (w * rd[:, None, :]).sum(-1).clamp_min(0.0)
    closest = ro[:, None, :] + zc[..., None] * rd[:, None, :]
    dist = torch.linalg.vector_norm(closest - clusters.center[None], dim=-1)
    reach = x0[:, None] + tan_alpha[:, None] * zc + clusters.radius[None]
    okc = (dist <= reach) & (zc - clusters.radius[None] <= zmax[:, None])
    zsel, sel = select.smallest(torch.where(okc, zc, math.inf), n_clusters)
    valid_cl = torch.isfinite(zsel)
    base = clusters.start[sel].long()
    cnt = clusters.count[sel]
    offs = torch.arange(edges_per_cluster, device=dev)
    cand = (base[..., None] + offs[None, None, :]).clamp(
        0, clusters.order.shape[0] - 1)
    in_range = ((offs[None, None, :] < cnt[..., None])
                & valid_cl[..., None]).reshape(N, -1)
    eidx = clusters.order[cand].reshape(N, -1)
    ei = eidx.long()
    p0 = edges.p0[ei]
    zq = _ray_segment_keys(ro, rd, x0, tan_alpha, zmax, p0,
                           edges.p1[ei] - p0,
                           edges.length[ei].clamp_min(1e-12))
    return select.pick(torch.where(in_range, zq, math.inf), eidx, K)


def edges_in_cone(edges: EdgeTable, clusters: EdgeClusters, ro, rd, env,
                  zmax, K: int):
    """The integrators' edge sweep: the clustered sweep above
    MAX_UNCLUSTERED_EDGES edges, the exact all-edges sweep at or below
    it (as the JAX integrators switch). Returns (idx, z, count)."""
    if edges.count > MAX_UNCLUSTERED_EDGES:
        return edges_near_cone_clustered(edges, clusters, ro, rd, env, zmax,
                                         K)
    return edges_near_cone(edges, ro, rd, env, zmax, K)
