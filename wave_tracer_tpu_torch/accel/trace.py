"""Scene geometry on the device, ray-query dispatch, hit attributes.

Port of wave_tracer_tpu/accel/trace.py for the all-pairs backend. The
triangles stay in the order they were baked in (the port's own bake keeps
soup order; a table bridged from the JAX package keeps its BVH order).
No BVH is built: scenes up to MXU_MAX_TRIS triangles go through the
all-pairs kernels K1/K2 (accel/ray_kernels.py); a larger scene on a CUDA
tensor raises, since the BVH backend is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from wave_tracer_tpu_torch.accel import ray_kernels

MXU_MAX_TRIS = 1 << 17


@dataclass
class GeoArrays:
    """Device-side scene geometry. Packed rows as in the JAX package:
    tri_geom (T, 12) = p0 e1 e2 pad3; tri_attr (T, 32) = n0 n1 n2 uv0 uv1
    uv2 geo_n dpdu mat shape emitter (ids as f32) pad."""
    p0: torch.Tensor        # (T, 3)
    e1: torch.Tensor        # (T, 3)
    e2: torch.Tensor        # (T, 3)
    tri_geom: torch.Tensor  # (T, 12)
    tri_attr: torch.Tensor  # (T, 32)
    mxu_center: torch.Tensor  # (3,) translation of the kernel features
    tri_feat: torch.Tensor  # (T, 24) K1/K2 rows (ray_kernels.tri_features)

    @property
    def num_tris(self):
        return self.p0.shape[0]


def from_soup(soup, mat_id, shape_id, emitter_id) -> dict:
    """Host bake of a TriangleSoup + per-tri ids (soup order) → dict of
    numpy arrays {p0, e1, e2, tri_geom, tri_attr, mxu_center}."""
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
    return dict(p0=np.ascontiguousarray(p[:, 0]), e1=e1, e2=e2,
                tri_geom=tri_geom, tri_attr=tri_attr, mxu_center=mxu_center)


def _check_size(geo, ro):
    if geo.num_tris > MXU_MAX_TRIS and ro.device.type == "cuda":
        raise NotImplementedError(
            f"{geo.num_tris} triangles > {MXU_MAX_TRIS}: the BVH backend "
            "is not ported yet")


def trace(geo: GeoArrays, ro, rd, tmin, tmax, exclude_tri=None):
    """Closest hit → (t, tri, u, v); tri == -1 and t = BIG on a miss."""
    _check_size(geo, ro)
    if geo.num_tris == 0:
        N = ro.shape[0]
        z = torch.zeros((N,), dtype=torch.float32, device=ro.device)
        return (torch.full_like(z, ray_kernels._BIG_F32),
                torch.full((N,), -1, dtype=torch.int32, device=ro.device),
                z, z.clone())
    return ray_kernels.trace_rays(geo, ro, rd, tmin, tmax, exclude_tri)


def occluded(geo: GeoArrays, ro, rd, tmin, tmax, exclude_tri=None,
             exclude_tri2=None, exclude_tri3=None):
    """Any hit within (tmin, tmax]. Returns bool (N,)."""
    _check_size(geo, ro)
    if geo.num_tris == 0:
        return torch.zeros((ro.shape[0],), dtype=torch.bool,
                           device=ro.device)
    return ray_kernels.occluded_rays(geo, ro, rd, tmin, tmax, exclude_tri,
                                     exclude_tri2, exclude_tri3)


def ray_tests_per_lane(geo: GeoArrays) -> float:
    """Ray–triangle pair tests one trace/occluded call issues per lane
    (all-pairs: every triangle)."""
    return float(geo.num_tris)


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
