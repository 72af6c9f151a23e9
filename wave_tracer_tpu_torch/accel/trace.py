"""Scene geometry on the device, ray-query dispatch, hit attributes.

Port of wave_tracer_tpu/accel/trace.py. Two routes, chosen by the
triangle count as the JAX package chooses them:

* up to MXU_MAX_TRIS triangles, the all-pairs kernels K1/K2
  (accel/ray_kernels.py). The port's own bake keeps such a scene in soup
  order and builds no BVH; a table bridged from the JAX package keeps its
  BVH order (and its tree, unused here).
* above it, the BVH route: the bake permutes the triangles into the leaf
  order of a binned-SAH BVH (accel/bvh.py) and packs its nodes
  (`node_pack`), and `trace_bvh` / `occluded_bvh` walk it with the
  traversal kernels K4/K5 (accel/bvh_kernels.py).

The cone sweep (`cone_boundary_minz`) runs through K3
(accel/cone_kernels.py) on either route. The ball query of the bdpt
blocked-flux integral (`tris_in_ball`) is plain torch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from wave_tracer_tpu_torch.accel import (bvh_kernels, cone_kernels,
                                         ray_kernels)
from wave_tracer_tpu_torch.accel.bvh import FlatBVH, pack_nodes

# above this triangle count the ray queries take the BVH route (K4/K5), as
# the JAX package's do (its all-pairs MXU intersector stops there)
MXU_MAX_TRIS = 1 << 17


def takes_bvh(num_tris: int) -> bool:
    """Whether a scene of `num_tris` triangles takes the BVH route."""
    return num_tris > MXU_MAX_TRIS


@dataclass
class GeoArrays:
    """Device-side scene geometry. Packed rows as in the JAX package:
    tri_geom (T, 12) = p0 e1 e2 pad3; tri_attr (T, 32) = n0 n1 n2 uv0 uv1
    uv2 geo_n dpdu mat shape emitter (ids as f32) pad; on the BVH route
    node_pack (M, 16) = count, left, the children's boxes inline
    (accel/bvh.py::pack_nodes), with the triangles in its leaf order."""
    p0: torch.Tensor        # (T, 3)
    e1: torch.Tensor        # (T, 3)
    e2: torch.Tensor        # (T, 3)
    tri_geom: torch.Tensor  # (T, 12)
    tri_attr: torch.Tensor  # (T, 32)
    mxu_center: torch.Tensor  # (3,) translation of the kernel features
    node_pack: torch.Tensor | None = None   # (M, 16); None: no BVH
    # derived, from detached copies of p0/e1/e2 (the kernels take primal
    # tensors; a GeoArrays made by dataclasses.replace with moved
    # triangles derives them anew): (T, 24) K1/K2 rows
    # (ray_kernels.tri_features), (T, 9) K3 rows [A | B | C]
    # (cone_kernels.cone_tris), and the copies of the triangles that K3
    # and K1/K2 read, in an order that makes their 256-triangle tiles
    # compact (ray_kernels.tile_order), with the tiles' bounds. A scene
    # on the BVH route has no K1/K2 rows (tri_feat, ray_table None)
    tri_feat: torch.Tensor | None = field(init=False)
    cone_tris: torch.Tensor = field(init=False)
    cone_table: cone_kernels.ConeTable = field(init=False)
    ray_table: ray_kernels.RayTable | None = field(init=False)

    def __post_init__(self):
        p0, e1, e2 = self.p0.detach(), self.e1.detach(), self.e2.detach()
        center = self.mxu_center.detach()
        self.cone_tris = cone_kernels.cone_tris(p0, e1, e2)
        order = ray_kernels.tile_order(p0, e1, e2)
        self.cone_table = cone_kernels.cone_table(self.cone_tris, order)
        self.tri_feat = self.ray_table = None
        if not takes_bvh(self.num_tris):
            self.tri_feat = ray_kernels.tri_features(p0, e1, e2, center)
            self.ray_table = ray_kernels.ray_table(p0, e1, e2, center,
                                                   self.tri_feat, order)

    @property
    def num_tris(self):
        return self.p0.shape[0]


def from_soup(soup, mat_id, shape_id, emitter_id,
              bvh: FlatBVH | None = None) -> dict:
    """Host bake of a TriangleSoup + per-tri ids, in device order → dict
    of numpy arrays {p0, e1, e2, tri_geom, tri_attr, mxu_center}; with the
    `bvh` whose leaf order the soup is in (`scene/build.py` permutes it),
    also node_pack (what the traversal reads), node_left and node_count
    (the tree's shape, for its depth) and tri_order (row i of the tables
    is the unpermuted soup's triangle tri_order[i])."""
    p = soup.positions
    T = len(p)
    e1 = (p[:, 1] - p[:, 0]).astype(np.float32)
    e2 = (p[:, 2] - p[:, 0]).astype(np.float32)
    tri_geom = np.zeros((T, 12), np.float32)
    tri_geom[:, 0:3] = p[:, 0]
    tri_geom[:, 3:6] = e1
    tri_geom[:, 6:9] = e2
    tri_attr = np.zeros((T, 32), np.float32)
    tri_attr[:, 0:3] = soup.normals[:, 0]
    tri_attr[:, 3:6] = soup.normals[:, 1]
    tri_attr[:, 6:9] = soup.normals[:, 2]
    tri_attr[:, 9:11] = soup.uvs[:, 0]
    tri_attr[:, 11:13] = soup.uvs[:, 1]
    tri_attr[:, 13:15] = soup.uvs[:, 2]
    tri_attr[:, 15:18] = soup.geo_n
    tri_attr[:, 18:21] = soup.dpdu
    tri_attr[:, 21] = np.asarray(mat_id, np.float32)
    tri_attr[:, 22] = np.asarray(shape_id, np.float32)
    tri_attr[:, 23] = np.asarray(emitter_id, np.float32)
    mxu_center = (p.reshape(-1, 3).mean(axis=0).astype(np.float32)
                  if T else np.zeros(3, np.float32))
    out = dict(p0=np.ascontiguousarray(p[:, 0]), e1=e1, e2=e2,
               tri_geom=tri_geom, tri_attr=tri_attr, mxu_center=mxu_center)
    if bvh is not None:
        out.update(node_left=bvh.node_left, node_count=bvh.node_count,
                   node_pack=pack_nodes(bvh), tri_order=bvh.tri_order)
    return out


def _nodes(geo):
    if geo.node_pack is None:
        raise ValueError(
            f"{geo.num_tris} triangles > MXU_MAX_TRIS = {MXU_MAX_TRIS} take "
            "the BVH route, and this GeoArrays has no node_pack (bake the "
            "scene with scene.build_scene)")
    return geo.node_pack


def trace_bvh(geo: GeoArrays, ro, rd, tmin, tmax, exclude_tri=None,
              need=None, carry=None):
    """Closest hit through the BVH (K4; its twin on the CPU), with
    `trace`'s contract. Returns (t, tri, u, v): u/v of the winner by
    Möller–Trumbore, and t's derivative where one is in play, as
    `ray_kernels.trace_rays` gives them."""
    N = ro.shape[0]
    primal = ray_kernels.primal
    ex = (torch.full((N,), -1, dtype=torch.int32, device=ro.device)
          if exclude_tri is None else exclude_tri)
    if carry is not None:
        carry = (primal(carry[0]), primal(carry[1]))
    t, tri = bvh_kernels.closest_hit(
        _nodes(geo), primal(geo.tri_geom), primal(ro), primal(rd),
        primal(tmin), primal(tmax), primal(ex, torch.int32),
        need if need is None else primal(need), carry)
    return ray_kernels.solve_hits(geo.tri_geom, ro, rd, t, tri)


def occluded_bvh(geo: GeoArrays, ro, rd, tmin, tmax, exclude_tri=None,
                 exclude_tri2=None, exclude_tri3=None, need=None):
    """Any hit through the BVH (K5; its twin on the CPU), with
    `occluded`'s contract."""
    ex = ray_kernels._exclusions(ro.shape[0], ro.device, exclude_tri,
                                 exclude_tri2, exclude_tri3)
    primal = ray_kernels.primal
    return bvh_kernels.any_hit(
        _nodes(geo), primal(geo.tri_geom), primal(ro), primal(rd),
        primal(tmin), primal(tmax), primal(ex),
        need if need is None else primal(need))


def trace(geo: GeoArrays, ro, rd, tmin, tmax, exclude_tri=None, need=None,
          carry=None):
    """Closest hit → (t, tri, u, v); tri == -1 and t = BIG on a miss.
    `need` (N,) bool names the rows to trace (None: all); the others take
    `carry`, the (t, tri) of their last trace (a miss if None), untraced:
    the caller passes it for rows whose ray, tmin, tmax and exclusion are
    those of that trace. Up to MXU_MAX_TRIS triangles K1, above it the
    BVH route (`trace_bvh`)."""
    if geo.num_tris == 0:
        N = ro.shape[0]
        z = torch.zeros((N,), dtype=torch.float32, device=ro.device)
        return (torch.full_like(z, ray_kernels._BIG_F32),
                torch.full((N,), -1, dtype=torch.int32, device=ro.device),
                z, z.clone())
    if takes_bvh(geo.num_tris):
        return trace_bvh(geo, ro, rd, tmin, tmax, exclude_tri, need, carry)
    return ray_kernels.trace_rays(geo, ro, rd, tmin, tmax, exclude_tri,
                                  need, carry)


def occluded(geo: GeoArrays, ro, rd, tmin, tmax, exclude_tri=None,
             exclude_tri2=None, exclude_tri3=None, need=None):
    """Any hit within (tmin, tmax]. `need` (N,) bool names the rows whose
    result is read (None: all); the others return False and are not
    traced. Returns bool (N,). Up to MXU_MAX_TRIS triangles K2, above it
    the BVH route (`occluded_bvh`)."""
    if geo.num_tris == 0:
        return torch.zeros((ro.shape[0],), dtype=torch.bool,
                           device=ro.device)
    if takes_bvh(geo.num_tris):
        return occluded_bvh(geo, ro, rd, tmin, tmax, exclude_tri,
                            exclude_tri2, exclude_tri3, need)
    return ray_kernels.occluded_rays(geo, ro, rd, tmin, tmax, exclude_tri,
                                     exclude_tri2, exclude_tri3, need)


def cone_boundary_minz(geo: GeoArrays, ro, rd, env, bounds, zmax,
                       zmin: float = 1e-7, exclude_tri=None):
    """Earliest exact cone–triangle entry ≥ each schedule boundary.

    bounds (N, B) with B ≤ 16; env the lanes' EnvState. Returns (zc (N, B)
    per-boundary minima, inf where no encounter lies ahead; cnt (N,) i32
    exact encounter count). The kernel reads `primal` copies, so the
    minima are a detached pick. Where the lanes, the bounds or the
    triangles (geo.p0/e1/e2) carry a derivative, K3 also returns each
    minimum's triangle and the minimum takes the derivative of that
    pair's entry z, recomputed by the plain pair math
    (`cone_kernels.minz_pairs`) on the winners' differentiable vertices,
    as the JAX package's exact-AD plain query gives it: zc is the kernel's
    value bit for bit, plus (z − z) with the second term detached. With
    no derivative in play nothing more runs. K3 on either route (the JAX
    package's dense sweep computes the same minima above MXU_MAX_TRIS)."""
    N, B = bounds.shape
    dev = ro.device
    if geo.num_tris == 0:
        return (torch.full((N, B), float("inf"), device=dev),
                torch.zeros((N,), dtype=torch.int32, device=dev))
    if exclude_tri is None:
        exclude_tri = torch.full((N,), -1, dtype=torch.int32, device=dev)
    primal = ray_kernels.primal
    grad = ray_kernels.carries_derivative(
        ro, rd, env.x, env.e, env.x0, env.ta, zmax, bounds, geo.p0, geo.e1,
        geo.e2)
    pad = bounds
    if B < cone_kernels.NB:
        pad = torch.cat([bounds, bounds.new_full(
            (N, cone_kernels.NB - B), cone_kernels.BIG)], dim=1)
    out = cone_kernels.cone_minz(
        geo.cone_tris, primal(ro), primal(rd), primal(env.x), primal(env.e),
        primal(env.x0), primal(env.ta), primal(zmax),
        primal(exclude_tri, torch.int32), primal(pad), zmin,
        table=geo.cone_table, winners=grad)
    zc, cnt = out[0][:, :B], out[1]
    if grad:
        win = out[2][:, :B]
        w = win.clamp_min(0).long()
        verts = torch.cat([geo.p0[w], geo.p0[w] + geo.e1[w],
                           geo.p0[w] + geo.e2[w]], dim=-1)
        z = cone_kernels.minz_pairs(verts, ro, rd, env.x, env.e, env.x0,
                                    env.ta, zmax, zmin)
        zc = torch.where(win >= 0, zc + (z - z.detach()), zc)
    return zc, cnt


def ray_tests_per_lane(geo: GeoArrays) -> float:
    """Ray–triangle pair tests one trace/occluded call issues per lane:
    every triangle on the all-pairs route; 0 on the BVH route, whose count
    depends on the data (as the JAX package reports it)."""
    return 0.0 if takes_bvh(geo.num_tris) else float(geo.num_tris)


def _point_tri_dist(p, a, e1, e2, gn):
    """Exact point-to-triangle distance, batched: p (N, 1, 3) against
    triangle tiles a/e1/e2/gn (1, T, 3). Plane projection and barycentric
    inside test, else the least distance to the three edge segments."""
    w = p - a
    dist_pl = (w * gn).sum(-1)
    q = w - dist_pl[..., None] * gn              # projection, local to a
    d11 = (e1 * e1).sum(-1)
    d12 = (e1 * e2).sum(-1)
    d22 = (e2 * e2).sum(-1)
    q1 = (q * e1).sum(-1)
    q2 = (q * e2).sum(-1)
    det = (d11 * d22 - d12 * d12).clamp_min(1e-30)
    u = (d22 * q1 - d12 * q2) / det
    v = (d11 * q2 - d12 * q1) / det
    inside = (u >= 0) & (v >= 0) & (u + v <= 1)

    def seg_d(s0, sd):
        ww = p - s0
        ll = (sd * sd).sum(-1).clamp_min(1e-30)
        t = ((ww * sd).sum(-1) / ll).clamp(0.0, 1.0)
        r = ww - t[..., None] * sd
        return torch.sqrt((r * r).sum(-1))

    d_edges = torch.minimum(torch.minimum(seg_d(a, e1), seg_d(a, e2)),
                            seg_d(a + e1, e2 - e1))
    return torch.where(inside, dist_pl.abs(), d_edges)


# lane chunk of the ball query: at most this many (lane, triangle) pairs
# of temporaries at once
_BALL_PAIRS = 1 << 22


def tris_in_ball(geo: GeoArrays, center, radius, K: int, tile: int = 512):
    """The K nearest triangles that meet the ball (center (N, 3), radius
    (N,)), nearest first, ties to the lower id (as jax.lax.top_k). Returns
    (idx (N, K) i32, −1-padded, dist (N, K), inf-padded, count (N,) i32).

    Plain torch over triangle tiles of min(tile, T) (padding is masked
    anyway), in lane chunks of at most _BALL_PAIRS pairs; used by the bdpt
    blocked-flux integral. Unlike the JAX package, no clustered variant:
    its TPU path never takes one."""
    T = geo.num_tris
    N = center.shape[0]
    dev = center.device
    bdist = torch.full((N, K), math.inf, device=dev)
    bidx = torch.full((N, K), -1, dtype=torch.int32, device=dev)
    if T == 0:
        return bidx, bdist, torch.zeros((N,), dtype=torch.int32, device=dev)
    tile = min(tile, T)
    gn = geo.tri_attr[:, 15:18]
    chunk = max(1, _BALL_PAIRS // tile)
    for c in range(0, N, chunk):
        cen = center[c:c + chunk, None, :]
        rad = radius[c:c + chunk, None]
        bd, bi = bdist[c:c + chunk], bidx[c:c + chunk]
        for s in range(0, T, tile):
            sl = slice(s, s + tile)
            dist = _point_tri_dist(cen, geo.p0[None, sl], geo.e1[None, sl],
                                   geo.e2[None, sl], gn[None, sl])
            dist = torch.where(dist <= rad, dist, math.inf)
            ids = torch.arange(s, s + dist.shape[1], dtype=torch.int32,
                               device=dev)
            cat_d = torch.cat([bd, dist], dim=1)
            cat_i = torch.cat([bi, ids[None].expand_as(dist)], dim=1)
            # stable ascending sort = top_k of −dist, ties to lower index
            sd, sel = torch.sort(cat_d, dim=1, stable=True)
            bd = sd[:, :K]
            bi = torch.gather(cat_i, 1, sel[:, :K])
        bdist[c:c + chunk], bidx[c:c + chunk] = bd, bi
    valid = torch.isfinite(bdist)
    return (torch.where(valid, bidx, -1), bdist,
            valid.sum(1, dtype=torch.int32))


@dataclass
class SurfaceHit:
    """Interpolated surface interaction (SoA)."""
    p: torch.Tensor         # (N, 3) world hit position
    t: torch.Tensor         # (N,) distance
    tri: torch.Tensor       # (N,) i32, -1 = miss
    valid: torch.Tensor     # (N,) bool
    uv: torch.Tensor        # (N, 2)
    geo_n: torch.Tensor     # (N, 3) geometric normal (as stored)
    ns: torch.Tensor        # (N, 3) interpolated shading normal
    dpdu: torch.Tensor      # (N, 3)
    front: torch.Tensor     # (N,) bool — ray hit the front face
    mat_id: torch.Tensor    # (N,) i32
    shape_id: torch.Tensor  # (N,) i32
    emitter_id: torch.Tensor  # (N,) i32


def hit_attributes(geo: GeoArrays, ro, rd, t, tri, u, v) -> SurfaceHit:
    valid = tri >= 0
    row = geo.tri_attr[tri.clamp_min(0).long()]   # one packed gather
    w = 1.0 - u - v
    uv = (w[:, None] * row[:, 9:11] + u[:, None] * row[:, 11:13]
          + v[:, None] * row[:, 13:15])
    ns = (w[:, None] * row[:, 0:3] + u[:, None] * row[:, 3:6]
          + v[:, None] * row[:, 6:9])
    nlen = torch.sqrt((ns * ns).sum(-1, keepdim=True).clamp_min(1e-30))
    ns = ns / nlen
    gn = row[:, 15:18]
    front = (rd * gn).sum(-1) < 0.0
    tsafe = torch.where(valid, t, torch.zeros_like(t))
    minus1 = torch.full_like(tri, -1)
    return SurfaceHit(
        p=ro + tsafe[:, None] * rd,
        t=tsafe, tri=tri, valid=valid, uv=uv, geo_n=gn, ns=ns,
        dpdu=row[:, 18:21], front=front,
        mat_id=torch.where(valid, row[:, 21].to(torch.int32), minus1),
        shape_id=torch.where(valid, row[:, 22].to(torch.int32), minus1),
        emitter_id=torch.where(valid, row[:, 23].to(torch.int32), minus1),
    )
