"""Affine 4x4 transforms (host-side numpy; applied at scene-build time).

Port of wave_tracer_tpu/core/transform.py: lookat, matrix, translate,
rotate and scale, composed as the scene dialect composes a sequence of
transform elements (each new element applies after the accumulated one:
transform = new @ transform). Matrices are numpy row-major 4x4 acting on
column vectors: p' = M @ [p, 1].
"""

from __future__ import annotations

import math

import numpy as np


class Transform:
    __slots__ = ("m",)

    def __init__(self, m: np.ndarray | None = None):
        self.m = np.eye(4, dtype=np.float64) if m is None \
            else np.asarray(m, np.float64)

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m)

    @property
    def inverse(self) -> "Transform":
        return Transform(np.linalg.inv(self.m))

    @property
    def linear(self) -> np.ndarray:
        return self.m[:3, :3]

    @property
    def normal_matrix(self) -> np.ndarray:
        """Inverse-transpose of the linear part, for transforming normals."""
        return np.linalg.inv(self.m[:3, :3]).T

    def apply_point(self, p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, np.float64)
        return p @ self.m[:3, :3].T + self.m[:3, 3]

    def apply_vector(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, np.float64)
        return v @ self.m[:3, :3].T

    def apply_normal(self, n: np.ndarray) -> np.ndarray:
        n = np.asarray(n, np.float64)
        out = n @ self.normal_matrix.T
        norm = np.linalg.norm(out, axis=-1, keepdims=True)
        return out / np.where(norm > 0, norm, 1.0)

    @staticmethod
    def translate(t) -> "Transform":
        m = np.eye(4)
        m[:3, 3] = t
        return Transform(m)

    @staticmethod
    def scale(s) -> "Transform":
        s = np.broadcast_to(np.asarray(s, np.float64), (3,))
        m = np.eye(4)
        m[0, 0], m[1, 1], m[2, 2] = s
        return Transform(m)

    @staticmethod
    def rotate(axis, angle_rad: float) -> "Transform":
        """Rotation about `axis` by `angle_rad` (right-handed)."""
        a = np.asarray(axis, np.float64)
        a = a / np.linalg.norm(a)
        c, s = math.cos(angle_rad), math.sin(angle_rad)
        x, y, z = a
        R = np.array([
            [c + x * x * (1 - c), x * y * (1 - c) - z * s,
             x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c),
             y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
             c + z * z * (1 - c)],
        ])
        m = np.eye(4)
        m[:3, :3] = R
        return Transform(m)

    @staticmethod
    def lookat(origin, target, up=None) -> "Transform":
        """Camera-to-world: local +z → view direction, columns [l, u, d, o]
        with l = normalize(cross(up, d)), u = cross(d, l). Without `up`,
        the tangent of the orthogonal frame around d."""
        origin = np.asarray(origin, np.float64)
        target = np.asarray(target, np.float64)
        d = target - origin
        d = d / np.linalg.norm(d)
        if up is None:
            up = _orthogonal_tangent(d)
        up = np.asarray(up, np.float64)
        left = np.cross(up, d)
        left = left / np.linalg.norm(left)
        u = np.cross(d, left)
        m = np.eye(4)
        m[:3, 0] = left
        m[:3, 1] = u
        m[:3, 2] = d
        m[:3, 3] = origin
        return Transform(m)

    @staticmethod
    def from_rows(values) -> "Transform":
        """16 row-major values as in <matrix value="..."/>."""
        return Transform(np.asarray(values, np.float64).reshape(4, 4))


def _orthogonal_tangent(n: np.ndarray) -> np.ndarray:
    """The tangent of the orthogonal frame built around unit n (the
    frame's bitangent b is chosen from n's larger x or y component)."""
    if abs(n[0]) > abs(n[1]):
        x = 1.0 / math.sqrt(n[0] * n[0] + n[2] * n[2])
        b = np.array([x * n[2], 0.0, -x * n[0]])
    else:
        x = 1.0 / math.sqrt(n[1] * n[1] + n[2] * n[2])
        b = np.array([0.0, x * n[2], -x * n[1]])
    return np.cross(b, n)
