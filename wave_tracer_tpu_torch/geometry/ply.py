"""Minimal PLY mesh reader (ascii, binary little- and big-endian; numpy).

Port of wave_tracer_tpu/geometry/ply.py: vertex positions, per-vertex
normals and uv/st texcoords where the file has them, and faces
fan-triangulated; other elements and list properties are skipped.
"""

from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str):
    """Returns (vertices (V,3) f64, faces (T,3) i64, normals (V,3) or None,
    uvs (V,2) or None)."""
    with open(path, "rb") as f:
        data = f.read()

    # -- header --
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, list_count_dtype|None)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], _PLY_TYPES[parts[3]],
                                        _PLY_TYPES[parts[2]]))
            else:
                elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]], None))

    verts = normals = uvs = None
    faces = []

    if fmt == "ascii":
        tokens = body.decode("ascii").split("\n")
        li = 0
        for name, count, props in elements:
            rows = tokens[li:li + count]
            li += count
            if name == "vertex":
                arr = np.array([r.split() for r in rows], dtype=np.float64)
                cols = {p[0]: i for i, p in enumerate(props)}
                verts, normals, uvs = _extract_vertex_data(arr, cols)
            elif name == "face":
                for r in rows:
                    t = r.split()
                    n = int(t[0])
                    ids = list(map(int, t[1:1 + n]))
                    for k in range(1, n - 1):
                        faces.append([ids[0], ids[k], ids[k + 1]])
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        off = 0
        for name, count, props in elements:
            if all(p[2] is None for p in props):
                dt = np.dtype([(p[0], endian + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                if name == "vertex":
                    cols = {p[0]: p[0] for p in props}
                    verts, normals, uvs = _extract_vertex_struct(arr, cols)
            else:
                # list property (faces): parse row by row
                if name == "face" and len(props) == 1:
                    cnt_dt = np.dtype(endian + props[0][2])
                    idx_dt = np.dtype(endian + props[0][1])
                    for _ in range(count):
                        n = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                        off += cnt_dt.itemsize
                        ids = np.frombuffer(body, idx_dt, n, off)
                        off += idx_dt.itemsize * n
                        for k in range(1, n - 1):
                            faces.append([ids[0], ids[k], ids[k + 1]])
                else:
                    # generic list property skip
                    for _ in range(count):
                        for pname, pdt, cdt in props:
                            if cdt is None:
                                off += np.dtype(endian + pdt).itemsize
                            else:
                                n = int(np.frombuffer(
                                    body, np.dtype(endian + cdt), 1, off)[0])
                                off += np.dtype(endian + cdt).itemsize
                                off += np.dtype(endian + pdt).itemsize * n

    return (verts, np.asarray(faces, np.int64).reshape(-1, 3),
            normals, uvs)


def _extract_vertex_data(arr, cols):
    verts = np.stack([arr[:, cols["x"]], arr[:, cols["y"]],
                      arr[:, cols["z"]]], axis=-1)
    normals = uvs = None
    if all(k in cols for k in ("nx", "ny", "nz")):
        normals = np.stack([arr[:, cols["nx"]], arr[:, cols["ny"]],
                            arr[:, cols["nz"]]], axis=-1)
    for ua, va in (("u", "v"), ("s", "t")):
        if ua in cols and va in cols:
            uvs = np.stack([arr[:, cols[ua]], arr[:, cols[va]]], axis=-1)
            break
    return verts, normals, uvs


def _extract_vertex_struct(arr, cols):
    verts = np.stack([arr["x"], arr["y"], arr["z"]],
                     axis=-1).astype(np.float64)
    normals = uvs = None
    names = arr.dtype.names
    if all(k in names for k in ("nx", "ny", "nz")):
        normals = np.stack([arr["nx"], arr["ny"], arr["nz"]],
                           axis=-1).astype(np.float64)
    for ua, va in (("u", "v"), ("s", "t")):
        if ua in names and va in names:
            uvs = np.stack([arr[ua], arr[va]], axis=-1).astype(np.float64)
            break
    return verts, normals, uvs
