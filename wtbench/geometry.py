"""Frozen scene geometry of the benchmark's configurations (numpy only).

The primitives the configurations are made of, written out here so that a
later change to the program's own mesh code cannot move the yardstick: a
square of side L in its local xy plane, the 12-triangle cube, and an
icosahedron subdivided `subdivisions` times and pushed onto its sphere.
A `Part` holds world-space corners; the configuration hands the same
float32 corners to the program (as its triangle soup) and to the plain
reference (`triangles`), in one order, so triangle ids agree.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Part:
    """World-space triangle corners (T, 3, 3) f32, optional per-corner
    shading normals (T, 3, 3) f32 and uvs (T, 3, 2) f32."""
    corners: np.ndarray
    normals: np.ndarray | None
    uvs: np.ndarray


def _matrix(rows):
    return np.asarray(rows, np.float64).reshape(4, 4)


def _apply(rows, p):
    m = _matrix(rows)
    return np.asarray(p, np.float64) @ m[:3, :3].T + m[:3, 3]


def _apply_normal(rows, n):
    m = _matrix(rows)[:3, :3]
    out = np.asarray(n, np.float64) @ np.linalg.inv(m)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.where(norm > 0, norm, 1.0)


def _part(verts, idx, normals, uvs):
    """De-index; where all three shading normals face away from the
    geometric normal, swap the first two corners (as the scene format
    orients a face by its normals); drop zero-area triangles."""
    p = verts[idx]
    uv = uvs[idx]
    gn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    keep = np.linalg.norm(gn, axis=-1) > 0
    p, uv, gn = p[keep], uv[keep], gn[keep]
    ns = None
    if normals is not None:
        ns = normals[idx][keep]
        flip = np.all(np.einsum("tvj,tj->tv", ns, gn) < 0, axis=-1)
        for a in (p, uv, ns):
            a[flip] = a[flip][:, [1, 0, 2]]
        ns = ns.astype(np.float32)
    return Part(p.astype(np.float32), ns, uv.astype(np.float32))


def square(length, rows):
    """A square of side `length` in its local xy plane, normal +z."""
    q = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    verts = np.concatenate([(q - 0.5) * length, np.zeros((4, 1))], 1)
    idx = np.array([[0, 1, 2], [2, 3, 0]])
    return _part(_apply(rows, verts), idx, None, q)


_CUBE_POS = np.array([
    [1, -1, -1], [1, -1, 1], [-1, -1, 1], [-1, -1, -1],
    [1, 1, -1], [-1, 1, -1], [-1, 1, 1], [1, 1, 1],
    [1, -1, -1], [1, 1, -1], [1, 1, 1], [1, -1, 1],
    [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1],
    [-1, -1, 1], [-1, 1, 1], [-1, 1, -1], [-1, -1, -1],
    [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1]], np.float64)
_CUBE_N = np.array([[0, -1, 0]] * 4 + [[0, 1, 0]] * 4 + [[1, 0, 0]] * 4
                   + [[0, 0, 1]] * 4 + [[-1, 0, 0]] * 4 + [[0, 0, -1]] * 4,
                   np.float64)
_CUBE_UV = np.array([[0, 1], [1, 1], [1, 0], [0, 0]] * 6, np.float64)
_CUBE_IDX = np.array([
    [0, 1, 2], [3, 0, 2], [4, 5, 6], [7, 4, 6], [8, 9, 10], [11, 8, 10],
    [12, 13, 14], [15, 12, 14], [16, 17, 18], [19, 16, 18],
    [20, 21, 22], [23, 20, 22]])


def cube(rows):
    """The cube [-1/2, 1/2]^3 (12 triangles) under the transform `rows`."""
    return _part(_apply(rows, _CUBE_POS * 0.5), _CUBE_IDX,
                 _apply_normal(rows, _CUBE_N), _CUBE_UV)


_G = (1.0 + np.sqrt(5.0)) / 2.0
_ICO_POS = np.array([
    [0, 1 / _G, -1], [1 / _G, 1, 0], [-1 / _G, 1, 0], [0, 1 / _G, 1],
    [0, -1 / _G, 1], [-1, 0, 1 / _G], [0, -1 / _G, -1], [1, 0, -1 / _G],
    [1, 0, 1 / _G], [-1, 0, -1 / _G], [1 / _G, -1, 0], [-1 / _G, -1, 0]],
    np.float64)
_ICO_IDX = np.array([
    [2, 1, 0], [1, 2, 3], [5, 4, 3], [4, 8, 3], [7, 6, 0], [6, 9, 0],
    [11, 10, 4], [10, 11, 6], [9, 5, 2], [5, 9, 11], [8, 7, 1], [7, 8, 10],
    [2, 5, 3], [8, 1, 3], [9, 2, 0], [1, 7, 0], [11, 9, 6], [7, 10, 6],
    [5, 11, 4], [10, 8, 4]])


def icosphere(center, radius, subdivisions):
    """20·4^subdivisions triangles; each split into four at its edge
    midpoints, then every corner pushed onto the sphere. Shading normals
    are the exact sphere normals."""
    tris = _ICO_POS[_ICO_IDX]
    for _ in range(subdivisions):
        p0, p1, p2 = tris[:, 0], tris[:, 1], tris[:, 2]
        p01, p02, p12 = (p0 + p1) / 2, (p0 + p2) / 2, (p1 + p2) / 2
        tris = np.concatenate([np.stack([p0, p01, p02], 1),
                               np.stack([p01, p1, p12], 1),
                               np.stack([p01, p12, p02], 1),
                               np.stack([p02, p12, p2], 1)])
    n = (tris / np.linalg.norm(tris, axis=-1, keepdims=True)).reshape(-1, 3)
    verts = n * radius + np.asarray(center, np.float64)
    uv = np.stack([np.arctan2(n[:, 2], n[:, 0]) / (2 * np.pi),
                   np.arcsin(np.clip(n[:, 1], -1, 1)) / np.pi + 0.5], -1)
    return _part(verts, np.arange(len(verts)).reshape(-1, 3), n, uv)


def triangles(parts):
    """The corners of `parts` in order, as float64 (T, 3, 3): the plain
    reference's geometry."""
    return np.concatenate([p.corners for p in parts]).astype(np.float64)
