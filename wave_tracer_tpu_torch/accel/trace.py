"""Scene geometry on the device, ray-query dispatch, hit attributes.

Port of wave_tracer_tpu/accel/trace.py. Three routes for the ray
queries (`trace`, `occluded`), named by `route(num_tris)` as the JAX
package's `trace` / `occluded` choose them:

* "kernels": up to MXU_MAX_TRIS triangles, the all-pairs kernels K1/K2
  (accel/ray_kernels.py), the JAX package's choice on the TPU. The
  port's own bake keeps such a scene in soup order and builds no BVH; a
  table bridged from the JAX package keeps its BVH order and its tree.
* "bvh": above MXU_MAX_TRIS triangles the bake permutes the triangles
  into the leaf order of a binned-SAH BVH (accel/bvh.py) and packs its
  nodes (`node_pack`), and `trace_bvh` / `occluded_bvh` walk it with the
  traversal kernels K4/K5 (accel/bvh_kernels.py).
* "brute": the all-triangles Möller–Trumbore queries `trace_brute` /
  `occluded_brute` (plain torch, as the JAX package's are jnp code).

WT_TRACE_BACKEND (read at each call, as the JAX package's `_tpu_like`
reads it) = bvh, brute or cpu leaves the all-pairs kernels as the JAX
package's CPU route does: brute up to BRUTE_THRESHOLD triangles, the BVH
above (K4/K5 at any size; the bake builds the tree under the same
value). Unset, auto, mxu or any other value keeps the default above.

The cone sweep (`cone_boundary_minz`) runs through K3
(accel/cone_kernels.py) on every route. The rest is plain torch, as
none of it reaches a Pallas kernel in the JAX package: the cone set
queries of WT_CONE_QUERY (`tris_near_cone`, `tris_near_cone_2pass`,
`tris_near_cone_clustered` over the triangle clusters `TriClusters`,
which the bake builds) and the ball query of the bdpt and Fraunhofer
blocked-flux integral (`tris_in_ball`, and `tris_in_ball_clustered`
above `tri_cluster_min()` triangles).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from wave_tracer_tpu_torch.accel import (bvh_kernels, cone_kernels,
                                         ray_kernels, select)
from wave_tracer_tpu_torch.accel.bvh import FlatBVH, pack_nodes
from wave_tracer_tpu_torch.ops import cone_intersect as ci
from wave_tracer_tpu_torch.ops import intersect as isect
from wave_tracer_tpu_torch.wave.envelope import EnvState

# above this triangle count the ray queries take the BVH route (K4/K5), as
# the JAX package's do (its all-pairs MXU intersector stops there)
MXU_MAX_TRIS = 1 << 17
# off the all-pairs kernels (WT_TRACE_BACKEND=bvh|brute|cpu), the brute
# queries up to this triangle count and the BVH above, as in the JAX package
BRUTE_THRESHOLD = 2048
_OFF_KERNELS = ("bvh", "brute", "cpu")


def takes_bvh(num_tris: int) -> bool:
    """Whether a scene of `num_tris` triangles takes the BVH route by
    default (what the default bake builds a tree for)."""
    return num_tris > MXU_MAX_TRIS


def route(num_tris: int) -> str:
    """The ray queries' route for `num_tris` triangles: "kernels" (K1/K2),
    "bvh" (K4/K5) or "brute", as the JAX package's trace/occluded choose
    under WT_TRACE_BACKEND (read at each call; see the module doc)."""
    if os.environ.get("WT_TRACE_BACKEND", "auto") in _OFF_KERNELS:
        return "brute" if num_tris <= BRUTE_THRESHOLD else "bvh"
    return "bvh" if takes_bvh(num_tris) else "kernels"


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
            f"{geo.num_tris} triangles take the BVH route (above "
            f"MXU_MAX_TRIS = {MXU_MAX_TRIS}, or above BRUTE_THRESHOLD = "
            f"{BRUTE_THRESHOLD} under WT_TRACE_BACKEND=bvh|brute|cpu; now "
            f"{os.environ.get('WT_TRACE_BACKEND')!r}), and this GeoArrays "
            "has no node_pack: bake the scene with scene.build_scene under "
            "the same WT_TRACE_BACKEND")
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
    those of that trace. K1, `trace_bvh` (K4) or `trace_brute`, by
    `route`."""
    if geo.num_tris == 0:
        N = ro.shape[0]
        z = torch.zeros((N,), dtype=torch.float32, device=ro.device)
        return (torch.full_like(z, ray_kernels._BIG_F32),
                torch.full((N,), -1, dtype=torch.int32, device=ro.device),
                z, z.clone())
    way = route(geo.num_tris)
    if way == "bvh":
        return trace_bvh(geo, ro, rd, tmin, tmax, exclude_tri, need, carry)
    if way == "brute":
        return trace_brute(geo, ro, rd, tmin, tmax, exclude_tri, need,
                           carry)
    return ray_kernels.trace_rays(geo, ro, rd, tmin, tmax, exclude_tri,
                                  need, carry)


def occluded(geo: GeoArrays, ro, rd, tmin, tmax, exclude_tri=None,
             exclude_tri2=None, exclude_tri3=None, need=None):
    """Any hit within (tmin, tmax]. `need` (N,) bool names the rows whose
    result is read (None: all); the others return False and are not
    traced. Returns bool (N,). K2, `occluded_bvh` (K5) or
    `occluded_brute`, by `route`."""
    if geo.num_tris == 0:
        return torch.zeros((ro.shape[0],), dtype=torch.bool,
                           device=ro.device)
    way = route(geo.num_tris)
    if way == "bvh":
        return occluded_bvh(geo, ro, rd, tmin, tmax, exclude_tri,
                            exclude_tri2, exclude_tri3, need)
    if way == "brute":
        return occluded_brute(geo, ro, rd, tmin, tmax, exclude_tri,
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
    package's dense sweep computes the same minima on every route)."""
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
    every triangle on the all-pairs and brute routes; 0 on the BVH route,
    whose count depends on the data (as the JAX package reports it)."""
    return 0.0 if route(geo.num_tris) == "bvh" else float(geo.num_tris)


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
# the same for the cone set queries and the brute ray queries, on the CPU
# and on the card (its memory holds larger chunks, and each chunk is
# hundreds of launches)
_CONE_PAIRS = {"cpu": 1 << 22, "cuda": 1 << 24}


def _chunked(N, width, dev, query):
    """query(lanes) → (idx, key, count) over lane slices of at most
    _CONE_PAIRS[dev] // width lanes, concatenated."""
    step = max(1, _CONE_PAIRS[torch.device(dev).type] // max(width, 1))
    parts = [query(slice(s, s + step)) for s in range(0, N, step)]
    return tuple(torch.cat(x) for x in zip(*parts))


def tris_in_ball(geo: GeoArrays, center, radius, K: int, tile: int = 512):
    """The K nearest triangles that meet the ball (center (N, 3), radius
    (N,)), nearest first, ties to the lower id (as jax.lax.top_k). Returns
    (idx (N, K) i32, −1-padded, dist (N, K), inf-padded, count (N,) i32).

    Plain torch over triangle tiles of min(tile, T) (padding is masked
    anyway), in lane chunks of at most _BALL_PAIRS pairs; the bdpt
    blocked-flux integral's query up to `tri_cluster_min()` triangles."""
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


def _cone_local(ro, rd, xh, yh, ecc, p):
    """World points p (n, J, 3) → the lanes' local scaled cone frame (x
    along the major axis, y scaled by the eccentricity, z along the
    ray)."""
    u = p - ro[:, None, :]
    return torch.stack([(u * xh[:, None, :]).sum(-1),
                        ecc * (u * yh[:, None, :]).sum(-1),
                        (u * rd[:, None, :]).sum(-1)], dim=-1)


def _exact_entries(row, ro, rd, env, zmin, zmax):
    """Exact elliptic cone–triangle entry z of the candidate rows
    (n, J, 12) of tri_geom per lane: (z, ok) (n, J)."""
    xh = env.x
    yh = torch.linalg.cross(rd, xh, dim=-1)
    ecc = env.e[:, None]
    a = row[..., 0:3]
    A = _cone_local(ro, rd, xh, yh, ecc, a)
    B = _cone_local(ro, rd, xh, yh, ecc, a + row[..., 3:6])
    C = _cone_local(ro, rd, xh, yh, ecc, a + row[..., 6:9])
    n, J = row.shape[:2]
    z, _, ok = ci.intersect_cone_tri(
        env.x0[:, None], env.ta[:, None], A, B, C,
        torch.full((n, J), zmin, device=row.device),
        zmax[:, None].expand(n, J))
    return z, ok


def _lanes(c, ro, rd, env, zmax, exclude_tri):
    """The lanes c of a cone query's arguments."""
    return (ro[c], rd[c],
            EnvState(x=env.x[c], x0=env.x0[c], ta=env.ta[c], e=env.e[c]),
            zmax[c], exclude_tri[c])


def _no_exclusion(N, dev):
    return torch.full((N,), -1, dtype=torch.int32, device=dev)


def tris_near_cone(geo: GeoArrays, ro, rd, env, zmax, K: int,
                   tile: int = 512, zmin: float = 1e-7, exclude_tri=None):
    """The triangle set that meets the elliptic cone envelope, by the
    exact cone–triangle entry test on every triangle (the top-K query of
    WT_CONE_QUERY=topk). env the lanes' EnvState; the cone rides (ro,
    rd). Returns (idx (N, K) i32 −1-padded, z (N, K) entry distances
    ascending, inf-padded, count (N,) i32), ties to the lower id. Plain
    torch over triangle tiles of min(tile, T), in lane chunks."""
    T = geo.num_tris
    N = ro.shape[0]
    dev = ro.device
    if T == 0:
        return select.empty_set(N, K, dev)
    if exclude_tri is None:
        exclude_tri = _no_exclusion(N, dev)
    tile = min(tile, T)

    def query(c):
        l_ro, l_rd, l_env, l_zmax, l_ex = _lanes(c, ro, rd, env, zmax,
                                                 exclude_tri)
        n = l_ro.shape[0]

        def keys(s, t):
            z, ok = _exact_entries(
                geo.tri_geom[None, s:s + t].expand(n, t, 12), l_ro, l_rd,
                l_env, zmin, l_zmax)
            ids = torch.arange(s, s + t, dtype=torch.int32, device=dev)
            return torch.where(ok & (ids[None] != l_ex[:, None]), z,
                               math.inf)
        return select.tiled_smallest(n, T, K, tile, dev, keys)
    return _chunked(N, tile, dev, query)


def tris_near_ray(geo: GeoArrays, ro, rd, x0, tan_alpha, zmax, K: int,
                  tile: int = 512):
    """`tris_near_cone` for a circular cone of initial radius x0 and
    tan(half angle) tan_alpha about each ray (eccentricity 1)."""
    N = ro.shape[0]
    dev = ro.device
    ax = torch.linalg.cross(rd, torch.tensor([0.0, 0.709, 0.705],
                                             device=dev).expand_as(rd),
                            dim=-1)
    ln = torch.linalg.vector_norm(ax, dim=-1, keepdim=True)
    alt = torch.linalg.cross(rd, torch.tensor([1.0, 0.0, 0.0],
                                              device=dev).expand_as(rd),
                             dim=-1)
    ax = torch.where(ln < 1e-6, alt, ax)
    ax = ax / torch.linalg.vector_norm(ax, dim=-1,
                                       keepdim=True).clamp_min(1e-12)
    env = EnvState(x=ax, x0=torch.as_tensor(x0, device=dev).expand(N),
                   ta=torch.as_tensor(tan_alpha, device=dev).expand(N),
                   e=torch.ones((N,), device=dev))
    return tris_near_cone(geo, ro, rd, env, zmax, K, tile=tile)


def tris_near_cone_2pass(geo: GeoArrays, ro, rd, env, zmax, K: int,
                         J: int = 32, tile: int = 512, zmin: float = 1e-7,
                         exclude_tri=None):
    """Two-pass cone set (WT_CONE_QUERY=2pass): a bounding-sphere pretest
    over all triangles keeps each lane's J earliest candidates (by the
    earliest z the sphere allows), then the exact entry test runs on those
    J only. `tris_near_cone`'s contract; approximate only through the J
    cap."""
    T = geo.num_tris
    N = ro.shape[0]
    dev = ro.device
    if T == 0:
        return select.empty_set(N, K, dev)
    if exclude_tri is None:
        exclude_tri = _no_exclusion(N, dev)
    tile = min(tile, T)

    def query(c):
        l_ro, l_rd, l_env, l_zmax, l_ex = _lanes(c, ro, rd, env, zmax,
                                                 exclude_tri)

        def keys(s, t):
            ta_, t1, t2 = geo.p0[s:s + t], geo.e1[s:s + t], geo.e2[s:s + t]
            # per-tile bounding spheres (shared across lanes)
            cen = ta_ + (t1 + t2) / 3.0
            r1 = ((ta_ - cen) ** 2).sum(-1)
            r2 = ((ta_ + t1 - cen) ** 2).sum(-1)
            r3 = ((ta_ + t2 - cen) ** 2).sum(-1)
            rad = torch.sqrt(torch.maximum(torch.maximum(r1, r2), r3))[None]
            w = cen[None] - l_ro[:, None, :]
            zc = (w * l_rd[:, None, :]).sum(-1).clamp_min(0.0)
            d2 = (w * w).sum(-1) - zc * zc
            reach = l_env.x0[:, None] + l_env.ta[:, None] * zc + rad
            ids = torch.arange(s, s + t, dtype=torch.int32, device=dev)
            ok = (d2 <= reach * reach) & (zc - rad <= l_zmax[:, None]) \
                & (zc + rad > zmin) & (ids[None] != l_ex[:, None])
            return torch.where(ok, (zc - rad).clamp_min(0.0), math.inf)
        cand, bz, _ = select.tiled_smallest(l_ro.shape[0], T, J, tile, dev,
                                            keys)
        z, ok = _exact_entries(geo.tri_geom[cand.clamp_min(0).long()], l_ro,
                               l_rd, l_env, zmin, l_zmax)
        return select.pick(torch.where(ok & torch.isfinite(bz), z, math.inf),
                           cand, K)
    return _chunked(N, tile, dev, query)


# ---------------------------------------------------------------------------
# two-level clustered triangle-set queries (sublinear cone and ball sweeps)
# ---------------------------------------------------------------------------

# the clustered queries' shape: clusters expanded per lane, candidates
# taken per cluster (the bake splits clusters at TRI_CAP, so a query with
# TRI_CAP candidates per cluster sees every member)
TRI_N_CLUSTERS = int(os.environ.get("WT_TRI_NCL", 12))
TRI_CAP = int(os.environ.get("WT_TRI_CAP", 64))

TRI_CLUSTER_KEYS = ("center", "radius", "start", "count", "order")


def tri_cluster_min(device) -> int:
    """Above this triangle count the bdpt and Fraunhofer blocked-flux ball
    query takes the clustered index: 16,384 on the CPU, 2^30 (never) on
    the card, as the JAX package chooses by platform;
    WT_TRI_CLUSTER_MIN overrides it (read per call)."""
    env = os.environ.get("WT_TRI_CLUSTER_MIN")
    if env:
        return int(env)
    return 16384 if torch.device(device).type == "cpu" else 1 << 30


@dataclass
class TriClusters:
    """Bounding-sphere clusters over grid cells of triangle centroids."""
    center: torch.Tensor   # (M, 3)
    radius: torch.Tensor   # (M,)
    start: torch.Tensor    # (M,) i32 into `order`
    count: torch.Tensor    # (M,) i32
    order: torch.Tensor    # (T,) i32 triangle rows grouped by cluster

    @property
    def num_clusters(self):
        return self.center.shape[0]


def build_tri_clusters(p0, e1, e2, grid: int | None = None,
                       target: int = 32, cap: int = 64) -> dict:
    """Host bake (numpy, float64): bucket the triangles by the grid cell of
    their centroid → dict of numpy arrays keyed by TRI_CLUSTER_KEYS; each
    cluster's sphere covers its triangles' vertices. The grid grows (×1.5
    + 1, at most 6 times, up to 128) until the occupied cells average at
    most `target` triangles, and a cell of more than `cap` triangles is
    split into chunks of at most `cap`."""
    p0 = np.asarray(p0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    T = len(p0)
    if T == 0:
        return dict(center=np.zeros((1, 3), np.float32),
                    radius=np.zeros(1, np.float32),
                    start=np.zeros(1, np.int32), count=np.zeros(1, np.int32),
                    order=np.zeros(0, np.int32))
    c = p0 + (e1 + e2) / 3.0
    lo = c.min(axis=0)
    ext = np.maximum(c.max(axis=0) - lo, 1e-9)
    if grid is None:
        grid = max(2, int(round((max(T, 1) / float(target))
                                ** (1.0 / 3.0))))
        for _ in range(6):
            cell = np.minimum((c - lo) / ext * grid,
                              grid - 1e-4).astype(np.int64)
            key = (cell[:, 0] * grid + cell[:, 1]) * grid + cell[:, 2]
            occupied = len(np.unique(key))
            if T / max(occupied, 1) <= target or grid >= 128:
                break
            grid = int(grid * 1.5) + 1
    cell = np.minimum((c - lo) / ext * grid, grid - 1e-4).astype(np.int64)
    key = (cell[:, 0] * grid + cell[:, 1]) * grid + cell[:, 2]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    cell_starts = np.concatenate([[0], np.nonzero(np.diff(key_s))[0] + 1])
    cell_counts = np.diff(np.concatenate([cell_starts, [T]]))
    starts, counts = [], []
    for s, n in zip(cell_starts, cell_counts):
        for off in range(0, n, cap):
            starts.append(s + off)
            counts.append(min(cap, n - off))
    starts = np.asarray(starts, np.int64)
    counts = np.asarray(counts, np.int64)
    M = len(starts)
    center = np.zeros((M, 3), np.float32)
    radius = np.zeros(M, np.float32)
    A, B, C = p0, p0 + e1, p0 + e2
    for m in range(M):
        ids = order[starts[m]: starts[m] + counts[m]]
        pts = np.concatenate([A[ids], B[ids], C[ids]])
        ctr = 0.5 * (pts.min(axis=0) + pts.max(axis=0))
        center[m] = ctr
        radius[m] = np.sqrt(((pts - ctr) ** 2).sum(axis=1).max())
    return dict(center=center, radius=radius, start=starts.astype(np.int32),
                count=counts.astype(np.int32), order=order.astype(np.int32))


def _nearest_clusters(key, ok, n_clusters):
    """Each lane's n_clusters clusters of least key (n, M) among those
    `ok`: (sel (n, n_cl), valid (n, n_cl))."""
    z, sel = select.smallest(torch.where(ok, key, math.inf), n_clusters)
    return sel, torch.isfinite(z)


def _clusters_near_cone(clusters: TriClusters, ro, rd, x0, ta, zmax,
                        n_clusters: int):
    """The n_clusters clusters whose spheres touch the swept envelope r(z)
    = x0 + ta·z earliest, by the earliest entry z a sphere allows (a
    cluster whose centre projects later can still hold the nearest
    triangles). Returns (sel (N, n_cl), valid (N, n_cl))."""
    cc, cr = clusters.center[None], clusters.radius[None]
    w = cc - ro[:, None, :]
    zc = (w * rd[:, None, :]).sum(-1).clamp_min(0.0)
    closest = ro[:, None, :] + zc[..., None] * rd[:, None, :]
    dist = torch.linalg.vector_norm(closest - cc, dim=-1)
    ok = (dist <= x0[:, None] + ta[:, None] * zc + cr) \
        & (zc - cr <= zmax[:, None])
    return _nearest_clusters((zc - cr).clamp_min(0.0), ok, n_clusters)


def _cluster_candidates(clusters: TriClusters, sel, valid_cl, cap: int):
    """Expand the selected clusters into (N, n_cl·cap) candidate triangle
    rows and their in-range mask (a cluster longer than cap is cut)."""
    N = sel.shape[0]
    base = clusters.start[sel].long()
    cnt = clusters.count[sel]
    offs = torch.arange(cap, device=sel.device)
    cand = base[..., None] + offs[None, None, :]
    in_range = (offs[None, None, :] < cnt[..., None]) & valid_cl[..., None]
    cand = cand.clamp(0, clusters.order.shape[0] - 1)
    return clusters.order[cand].reshape(N, -1), in_range.reshape(N, -1)


def tris_near_cone_clustered(geo: GeoArrays, clusters: TriClusters, ro, rd,
                             env, zmax, K: int, n_clusters: int | None = None,
                             tris_per_cluster: int | None = None,
                             zmin: float = 1e-7, exclude_tri=None):
    """Clustered cone set (WT_CONE_QUERY=clustered): the envelope against
    the cluster spheres (`_clusters_near_cone`), then the exact entry test
    on the candidate lists of each lane's n_clusters earliest clusters
    only. `tris_near_cone`'s contract (a triangle is in one cluster only,
    so no dedup)."""
    N = ro.shape[0]
    dev = ro.device
    if geo.num_tris == 0:
        return select.empty_set(N, K, dev)
    if exclude_tri is None:
        exclude_tri = _no_exclusion(N, dev)
    n_clusters = n_clusters or TRI_N_CLUSTERS
    tris_per_cluster = tris_per_cluster or TRI_CAP

    def query(c):
        l_ro, l_rd, l_env, l_zmax, l_ex = _lanes(c, ro, rd, env, zmax,
                                                 exclude_tri)
        sel, valid_cl = _clusters_near_cone(clusters, l_ro, l_rd, l_env.x0,
                                            l_env.ta, l_zmax, n_clusters)
        tidx, in_range = _cluster_candidates(clusters, sel, valid_cl,
                                             tris_per_cluster)
        z, ok = _exact_entries(geo.tri_geom[tidx.long()], l_ro, l_rd, l_env,
                               zmin, l_zmax)
        ok = ok & in_range & (tidx != l_ex[:, None])
        return select.pick(torch.where(ok, z, math.inf), tidx, K)
    return _chunked(N, max(clusters.num_clusters,
                           n_clusters * tris_per_cluster), dev, query)


def tris_in_ball_clustered(geo: GeoArrays, clusters: TriClusters, center,
                           radius, K: int, n_clusters: int | None = None,
                           tris_per_cluster: int | None = None):
    """Clustered `tris_in_ball`: ball against the cluster spheres, then
    exact point–triangle distances (normals from e1 × e2) on the candidate
    lists of each lane's n_clusters nearest clusters (by the least
    distance a sphere allows). The same contract, nearest first;
    approximate where more clusters than n_clusters meet a ball."""
    N = center.shape[0]
    dev = center.device
    if geo.num_tris == 0:
        return select.empty_set(N, K, dev)
    n_clusters = n_clusters or TRI_N_CLUSTERS
    tris_per_cluster = tris_per_cluster or TRI_CAP
    cc, cr = clusters.center[None], clusters.radius[None]

    def query(c):
        cen, rad = center[c], radius[c]
        d = torch.linalg.vector_norm(cc - cen[:, None, :], dim=-1)
        sel, valid_cl = _nearest_clusters(
            (d - cr).clamp_min(0.0), d <= rad[:, None] + cr, n_clusters)
        tidx, in_range = _cluster_candidates(clusters, sel, valid_cl,
                                             tris_per_cluster)
        row = geo.tri_geom[tidx.long()]
        a, t1, t2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
        gn = torch.linalg.cross(t1, t2, dim=-1)
        gn = gn / torch.linalg.vector_norm(gn, dim=-1,
                                           keepdim=True).clamp_min(1e-30)
        dist = _point_tri_dist(cen[:, None, :], a, t1, t2, gn)
        ok = in_range & (dist <= rad[:, None])
        return select.pick(torch.where(ok, dist, math.inf), tidx, K)
    return _chunked(N, max(clusters.num_clusters,
                           n_clusters * tris_per_cluster), dev, query)


def cone_tri_entry_point(geo: GeoArrays, ro, rd, env, tri, zmin, zmax):
    """Entry distance and world point of each lane's cone into ONE
    triangle tri (N,) i32 (−1: invalid). Returns (z (N,), p (N, 3),
    valid (N,))."""
    row = geo.tri_geom[tri.clamp_min(0).long()]
    xh = env.x
    yh = torch.linalg.cross(rd, xh, dim=-1)

    def to_local(p):
        u = p - ro
        return torch.stack([(u * xh).sum(-1), env.e * (u * yh).sum(-1),
                            (u * rd).sum(-1)], dim=-1)

    A = to_local(row[:, 0:3])
    B = to_local(row[:, 0:3] + row[:, 3:6])
    C = to_local(row[:, 0:3] + row[:, 6:9])
    z, p, ok = ci.intersect_cone_tri(env.x0, env.ta, A, B, C, zmin, zmax)
    inv_e = 1.0 / env.e.clamp_min(1.0)
    pw = ro + p[..., 0:1] * xh + (p[..., 1] * inv_e)[..., None] * yh \
        + p[..., 2:3] * rd
    return z, pw, ok & (tri >= 0)


# ---------------------------------------------------------------------------
# plain all-triangles ray queries (Möller–Trumbore): the "brute" route
# ---------------------------------------------------------------------------

_TRI_TILE = 512


def _row_slices(N, T, dev):
    """Row slices of the brute queries: at most _CONE_PAIRS[dev] (row,
    triangle) pairs of temporaries at once (each of Möller–Trumbore's
    vectors is rows × tile × 3 floats), and one slice when N is 0."""
    step = max(1, _CONE_PAIRS[torch.device(dev).type]
               // max(min(_TRI_TILE, T), 1))
    return [slice(s, s + step) for s in range(0, max(N, 1), step)]


def _closest_brute(geo: GeoArrays, ro, rd, tmin, tmax, exclude_tri):
    """trace_brute's closest hit of one row slice, without need/carry."""
    N = ro.shape[0]
    dev = ro.device
    best_t = torch.full((N,), isect.BIG, device=dev)
    best_i = torch.full((N,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((N,), device=dev)
    best_v = torch.zeros((N,), device=dev)
    rows = torch.arange(N, device=dev)
    for s in range(0, geo.num_tris, _TRI_TILE):
        sl = slice(s, s + _TRI_TILE)
        t, u, v, hit = isect.ray_tri(ro[:, None, :], rd[:, None, :],
                                     geo.p0[None, sl], geo.e1[None, sl],
                                     geo.e2[None, sl], tmin[:, None],
                                     tmax[:, None])
        ids = torch.arange(s, s + t.shape[1], dtype=torch.int32,
                           device=dev)
        hit = hit & (ids[None] != exclude_tri[:, None])
        t = torch.where(hit, t, isect.BIG)
        j = torch.argmin(t, dim=1)
        tt = t[rows, j]
        better = tt < best_t
        best_t = torch.where(better, tt, best_t)
        best_i = torch.where(better, (s + j).to(torch.int32), best_i)
        best_u = torch.where(better, u[rows, j], best_u)
        best_v = torch.where(better, v[rows, j], best_v)
    return best_t, best_i, best_u, best_v


def trace_brute(geo: GeoArrays, ro, rd, tmin, tmax, exclude_tri=None,
                need=None, carry=None):
    """Closest hit over all triangles by two-sided Möller–Trumbore, in
    row slices (_row_slices) and triangle tiles, with `trace`'s contract.
    Returns (t, tri, u, v): t = BIG and tri = −1 on a miss; ties to the
    lower id. Derivatives flow through the winner's Möller–Trumbore t, u
    and v, as through the JAX package's trace_brute. Every row is tested
    (a host sync would cost more than the rows); rows off `need` then
    take `carry` (a miss if None) bit for bit, with u/v and t's
    derivative from the carried triangle (`ray_kernels.solve_hits`, as
    the K1 route gives them)."""
    N = ro.shape[0]
    dev = ro.device
    if exclude_tri is None:
        exclude_tri = torch.full((N,), -1, dtype=torch.int32, device=dev)
    parts = [_closest_brute(geo, ro[r], rd[r], tmin[r], tmax[r],
                            exclude_tri[r])
             for r in _row_slices(N, geo.num_tris, dev)]
    best_t, best_i, best_u, best_v = (torch.cat(x) for x in zip(*parts))
    best_i = torch.where(best_t < isect.BIG, best_i, -1)
    if need is None:
        return best_t, best_i, best_u, best_v
    if carry is None:
        carry = (torch.full_like(best_t, isect.BIG),
                 torch.full_like(best_i, -1))
    primal = ray_kernels.primal
    ct, ci, cu, cv = ray_kernels.solve_hits(
        geo.tri_geom, ro, rd, primal(carry[0], torch.float32),
        primal(carry[1], torch.int32))
    return (torch.where(need, best_t, ct), torch.where(need, best_i, ci),
            torch.where(need, best_u, cu), torch.where(need, best_v, cv))


def _any_brute(geo: GeoArrays, ro, rd, tmin, tmax, ex):
    """occluded_brute's any hit of one row slice, without need."""
    occ = torch.zeros((ro.shape[0],), dtype=torch.bool, device=ro.device)
    for s in range(0, geo.num_tris, _TRI_TILE):
        sl = slice(s, s + _TRI_TILE)
        _, _, _, hit = isect.ray_tri(ro[:, None, :], rd[:, None, :],
                                     geo.p0[None, sl], geo.e1[None, sl],
                                     geo.e2[None, sl], tmin[:, None],
                                     tmax[:, None])
        ids = torch.arange(s, s + hit.shape[1], dtype=torch.int32,
                           device=ro.device)
        keep = (ids[None, :, None] != ex[:, None, :]).all(-1)
        occ = occ | (hit & keep).any(1)
    return occ


def occluded_brute(geo: GeoArrays, ro, rd, tmin, tmax, exclude_tri=None,
                   exclude_tri2=None, exclude_tri3=None, need=None):
    """Any hit in (tmin, tmax] over all triangles, up to three excluded
    ids per ray, in row slices (_row_slices) and triangle tiles, with
    `occluded`'s contract: rows off `need` are False. Returns bool (N,)."""
    N = ro.shape[0]
    ex = ray_kernels._exclusions(N, ro.device, exclude_tri, exclude_tri2,
                                 exclude_tri3)
    occ = torch.cat([_any_brute(geo, ro[r], rd[r], tmin[r], tmax[r], ex[r])
                     for r in _row_slices(N, geo.num_tris, ro.device)])
    return occ if need is None else occ & need


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
