"""The C++ BVH builder (bvh_builder.cpp), compiled at first use and loaded
with ctypes.

Port of wave_tracer_tpu/native/__init__.py. The library is compiled with
`g++ -O3 -shared -fPIC` into wave_tracer_tpu_torch/_build/, named by a
hash of the source and the flags (so it is rebuilt only when either
changes), never next to the source. No `-march=native`: the library is
built on whichever host runs it, and is the same code on every host. A
failed compile raises with the compiler's message; nothing falls back to
the numpy builder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "bvh_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# no contraction of a·b + c into one fused multiply-add, so that every
# host builds the tree the numpy builder builds
FLAGS = ["-O3", "-shared", "-fPIC", "-ffp-contract=off"]

_lib = None


def library_path() -> Path:
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libwt_bvh_{tag.hexdigest()[:16]}.so"


def build() -> ctypes.CDLL:
    """Compile bvh_builder.cpp (if its hash changed) and bind it."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("BVH builder: no C++ compiler (g++) found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"BVH builder: {cxx} failed on {SRC.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.wt_bvh_build.restype = ctypes.c_int64
    lib.wt_bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int]
    lib.wt_bvh_read.restype = None
    lib.wt_bvh_read.argtypes = [ctypes.POINTER(ctypes.c_float)] * 2 \
        + [ctypes.POINTER(ctypes.c_int32)] * 3
    _lib = lib
    return lib


def build_bvh_native(positions: np.ndarray):
    """C++ binned-SAH build of positions (T, 3, 3) → FlatBVH, leaves of at
    most LEAF_TILE triangles."""
    from wave_tracer_tpu_torch.accel.bvh import LEAF_TILE, FlatBVH

    lib = build()
    pos = np.ascontiguousarray(positions, np.float32)
    T = len(pos)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    n_nodes = lib.wt_bvh_build(pos.ctypes.data_as(fp), T, LEAF_TILE)
    node_min = np.zeros((n_nodes, 3), np.float32)
    node_max = np.zeros((n_nodes, 3), np.float32)
    node_left = np.zeros(n_nodes, np.int32)
    node_count = np.zeros(n_nodes, np.int32)
    tri_order = np.zeros(T, np.int32)
    lib.wt_bvh_read(node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
                    node_left.ctypes.data_as(ip),
                    node_count.ctypes.data_as(ip),
                    tri_order.ctypes.data_as(ip))
    return FlatBVH(node_min=node_min, node_max=node_max, node_left=node_left,
                   node_count=node_count, tri_order=tri_order)
