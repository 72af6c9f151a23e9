"""Affine 4x4 transforms (host-side numpy; applied at scene-build time).

Port of wave_tracer_tpu/core/transform.py, reduced to what the procedural
scenes use. Matrices are numpy row-major 4x4 acting on column vectors:
p' = M @ [p, 1].
"""

from __future__ import annotations

import numpy as np


class Transform:
    __slots__ = ("m",)

    def __init__(self, m: np.ndarray | None = None):
        self.m = np.eye(4, dtype=np.float64) if m is None \
            else np.asarray(m, np.float64)

    @property
    def normal_matrix(self) -> np.ndarray:
        """Inverse-transpose of the linear part, for transforming normals."""
        return np.linalg.inv(self.m[:3, :3]).T

    def apply_point(self, p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, np.float64)
        return p @ self.m[:3, :3].T + self.m[:3, 3]

    def apply_normal(self, n: np.ndarray) -> np.ndarray:
        n = np.asarray(n, np.float64)
        out = n @ self.normal_matrix.T
        norm = np.linalg.norm(out, axis=-1, keepdims=True)
        return out / np.where(norm > 0, norm, 1.0)

    @staticmethod
    def from_rows(values) -> "Transform":
        """16 row-major values as in <matrix value="..."/>."""
        return Transform(np.asarray(values, np.float64).reshape(4, 4))
