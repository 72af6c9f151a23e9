"""Triangle meshes as flat SoA numpy arrays (host-side, scene-build time).

Port of wave_tracer_tpu/geometry/mesh.py for the shapes the procedural
scenes use (rectangle, cube, icosphere). Meshes are de-indexed into a flat
world space triangle soup; vertices transform in float64; zero-area
triangles are dropped; where all three shading normals oppose the
geometric normal the winding is flipped; dpdu is the per-triangle
surface differential.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from wave_tracer_tpu_torch.core.transform import Transform


@dataclass
class TriangleSoup:
    """Flat world-space triangle arrays. T triangles.

    positions: (T, 3, 3) float32; normals: (T, 3, 3) float32 shading
    normals; uvs: (T, 3, 2) float32; geo_n: (T, 3) float32 geometric
    normals; dpdu: (T, 3) float32 tangents.
    """
    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    geo_n: np.ndarray
    dpdu: np.ndarray

    @property
    def num_tris(self) -> int:
        return len(self.positions)

    def areas(self) -> np.ndarray:
        e1 = self.positions[:, 1] - self.positions[:, 0]
        e2 = self.positions[:, 2] - self.positions[:, 0]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    @staticmethod
    def concatenate(soups: list["TriangleSoup"]) -> "TriangleSoup":
        return TriangleSoup(
            positions=np.concatenate([s.positions for s in soups]),
            normals=np.concatenate([s.normals for s in soups]),
            uvs=np.concatenate([s.uvs for s in soups]),
            geo_n=np.concatenate([s.geo_n for s in soups]),
            dpdu=np.concatenate([s.dpdu for s in soups]),
        )


def _surface_differentials(p0, p1, p2, uv0, uv1, uv2):
    """Per-triangle dpdu from the UV parameterization; zero if degenerate."""
    e1 = p1 - p0
    e2 = p2 - p0
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    dpdu = (duv2[:, 1, None] * e1 - duv1[:, 1, None] * e2) * inv[:, None]
    return np.where(ok[:, None], dpdu, 0.0)


def build_soup(vertices: np.ndarray, indices: np.ndarray,
               normals: np.ndarray | None = None,
               uvs: np.ndarray | None = None,
               to_world: Transform | None = None) -> TriangleSoup:
    """De-index and transform a mesh into world-space triangle soup."""
    vertices = np.asarray(vertices, np.float64)
    indices = np.asarray(indices, np.int64).reshape(-1, 3)
    vertices_w = to_world.apply_point(vertices) if to_world is not None \
        else vertices

    p = vertices_w[indices]  # (T, 3, 3)
    if uvs is not None and len(uvs):
        uv = np.asarray(uvs, np.float64)[indices]
    else:
        uv = np.zeros((len(indices), 3, 2))

    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    gn = np.cross(e1, e2)
    glen = np.linalg.norm(gn, axis=-1)
    valid = glen > 0
    p, uv, gn, glen = p[valid], uv[valid], gn[valid], glen[valid]
    idx = indices[valid]
    gn = gn / glen[:, None]

    if normals is not None and len(normals):
        n = np.asarray(normals, np.float64)
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-300)
        if to_world is not None:
            n = to_world.apply_normal(n)
        ns = n[idx]  # (T, 3, 3)
        d = np.einsum("tvj,tj->tv", ns, gn)
        flip = np.all(d < 0, axis=-1)
        p[flip] = p[flip][:, [1, 0, 2]]
        uv[flip] = uv[flip][:, [1, 0, 2]]
        ns[flip] = ns[flip][:, [1, 0, 2]]
        gn[flip] = -gn[flip]
    else:
        ns = np.repeat(gn[:, None, :], 3, axis=1)

    dpdu = _surface_differentials(p[:, 0], p[:, 1], p[:, 2],
                                  uv[:, 0], uv[:, 1], uv[:, 2])
    return TriangleSoup(
        positions=p.astype(np.float32),
        normals=ns.astype(np.float32),
        uvs=uv.astype(np.float32),
        geo_n=gn.astype(np.float32),
        dpdu=dpdu.astype(np.float32),
    )


def rectangle(length: float, to_world: Transform | None = None,
              tessellation: int = 1) -> TriangleSoup:
    """Axis-aligned square in the local xy plane, centred at the origin,
    side `length`, normal +z."""
    verts, uvs, idx = [], [], []
    rt = 1.0 / tessellation
    for ix in range(tessellation):
        for iy in range(tessellation):
            t = len(verts)
            u0, v0 = ix * rt, iy * rt
            u1 = 1.0 if ix + 1 == tessellation else (ix + 1) * rt
            v1 = 1.0 if iy + 1 == tessellation else (iy + 1) * rt
            for (u, v) in [(u0, v0), (u1, v0), (u1, v1), (u0, v1)]:
                verts.append([(u - 0.5) * length, (v - 0.5) * length, 0.0])
                uvs.append([u, v])
            idx += [[t, t + 1, t + 2], [t + 2, t + 3, t]]
    return build_soup(np.array(verts), np.array(idx), None, np.array(uvs),
                      to_world)


_GOLDEN = (1.0 + np.sqrt(5.0)) / 2.0
_ICO_POS = np.array([
    [0, 1 / _GOLDEN, -1], [1 / _GOLDEN, 1, 0], [-1 / _GOLDEN, 1, 0],
    [0, 1 / _GOLDEN, 1], [0, -1 / _GOLDEN, 1], [-1, 0, 1 / _GOLDEN],
    [0, -1 / _GOLDEN, -1], [1, 0, -1 / _GOLDEN], [1, 0, 1 / _GOLDEN],
    [-1, 0, -1 / _GOLDEN], [1 / _GOLDEN, -1, 0], [-1 / _GOLDEN, -1, 0]],
    np.float64)
_ICO_IDX = np.array([
    [2, 1, 0], [1, 2, 3], [5, 4, 3], [4, 8, 3], [7, 6, 0], [6, 9, 0],
    [11, 10, 4], [10, 11, 6], [9, 5, 2], [5, 9, 11], [8, 7, 1], [7, 8, 10],
    [2, 5, 3], [8, 1, 3], [9, 2, 0], [1, 7, 0], [11, 9, 6], [7, 10, 6],
    [5, 11, 4], [10, 8, 4]], np.int64)


_CUBE_POS = np.array([
    [1, -1, -1], [1, -1, 1], [-1, -1, 1], [-1, -1, -1],
    [1, 1, -1], [-1, 1, -1], [-1, 1, 1], [1, 1, 1],
    [1, -1, -1], [1, 1, -1], [1, 1, 1], [1, -1, 1],
    [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1],
    [-1, -1, 1], [-1, 1, 1], [-1, 1, -1], [-1, -1, -1],
    [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1]], np.float64)
_CUBE_N = np.array([
    [0, -1, 0]] * 4 + [[0, 1, 0]] * 4 + [[1, 0, 0]] * 4 +
    [[0, 0, 1]] * 4 + [[-1, 0, 0]] * 4 + [[0, 0, -1]] * 4, np.float64)
_CUBE_UV = np.array([[0, 1], [1, 1], [1, 0], [0, 0]] * 6, np.float64)
_CUBE_IDX = np.array([
    [0, 1, 2], [3, 0, 2], [4, 5, 6], [7, 4, 6], [8, 9, 10], [11, 8, 10],
    [12, 13, 14], [15, 12, 14], [16, 17, 18], [19, 16, 18],
    [20, 21, 22], [23, 20, 22]], np.int64)


def cube(length: float, to_world: Transform | None = None) -> TriangleSoup:
    """Axis-aligned cube of side `length` centred at the origin: 12
    triangles, one flat-shaded face pair per side."""
    return build_soup(_CUBE_POS * (length / 2.0), _CUBE_IDX, _CUBE_N,
                      _CUBE_UV, to_world)


def sphere(center, radius: float, to_world: Transform | None = None,
           tessellation: int = 20) -> TriangleSoup:
    """Subdivided icosphere; recursion = round(log2(tess/3)). Shading
    normals are exact sphere normals."""
    recursion = int(max(0.0, np.log2(tessellation / 3.0)) + 0.5)
    tris = _ICO_POS[_ICO_IDX]  # (20, 3, 3)
    for _ in range(recursion):
        p0, p1, p2 = tris[:, 0], tris[:, 1], tris[:, 2]
        p01, p02, p12 = (p0 + p1) / 2, (p0 + p2) / 2, (p1 + p2) / 2
        tris = np.concatenate([
            np.stack([p0, p01, p02], axis=1),
            np.stack([p01, p1, p12], axis=1),
            np.stack([p01, p12, p02], axis=1),
            np.stack([p02, p12, p2], axis=1)])
    n = tris / np.linalg.norm(tris, axis=-1, keepdims=True)
    verts = (n * radius + np.asarray(center, np.float64)).reshape(-1, 3)
    normals = n.reshape(-1, 3)
    uv = np.stack([np.arctan2(normals[:, 2], normals[:, 0]) / (2 * np.pi),
                   np.arcsin(np.clip(normals[:, 1], -1, 1)) / np.pi + 0.5],
                  axis=-1)
    idx = np.arange(len(verts)).reshape(-1, 3)
    return build_soup(verts, idx, normals, uv, to_world)
