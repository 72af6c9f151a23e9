"""Minimal Wavefront OBJ reader (host, numpy).

Port of wave_tracer_tpu/geometry/obj.py. Reads v/vn/vt/f records; faces
are fan-triangulated; per-face-vertex normal and texcoord indices are
resolved by de-indexing into per-corner arrays (negative indices count
from the end), as geometry.mesh.build_soup_from_corners takes them.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Returns (corner_positions (T,3,3), corner_normals (T,3,3)|None,
    corner_uvs (T,3,2)|None) — already de-indexed per corner."""
    vs, vns, vts = [], [], []
    fv, fn, ft = [], [], []
    has_n = has_t = False

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                vs.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("vn "):
                p = line.split()
                vns.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("vt "):
                p = line.split()
                vts.append([float(p[1]), float(p[2])])
            elif line.startswith("f "):
                corners = line.split()[1:]
                parsed = []
                for c in corners:
                    sub = c.split("/")
                    vi = int(sub[0])
                    ti = int(sub[1]) if len(sub) > 1 and sub[1] else 0
                    ni = int(sub[2]) if len(sub) > 2 and sub[2] else 0
                    parsed.append((vi, ti, ni))
                for k in range(1, len(parsed) - 1):
                    tri = [parsed[0], parsed[k], parsed[k + 1]]
                    fv.append([t[0] for t in tri])
                    ft.append([t[1] for t in tri])
                    fn.append([t[2] for t in tri])
                    if any(t[2] for t in tri):
                        has_n = True
                    if any(t[1] for t in tri):
                        has_t = True

    vs = np.asarray(vs, np.float64)
    vns = np.asarray(vns, np.float64) if vns else None
    vts = np.asarray(vts, np.float64) if vts else None

    def resolve(idx_arr, pool):
        idx = np.asarray(idx_arr, np.int64)
        idx = np.where(idx > 0, idx - 1, len(pool) + idx)
        return pool[idx]

    pos = resolve(fv, vs)
    normals = resolve(fn, vns) if (has_n and vns is not None) else None
    uvs = resolve(ft, vts) if (has_t and vts is not None) else None
    return pos, normals, uvs
