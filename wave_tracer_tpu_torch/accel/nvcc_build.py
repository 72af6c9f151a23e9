"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source `csrc/<name>.cu` has a plain C interface and is compiled for
sm_90a into a shared library under `wave_tracer_tpu_torch/_build/`, named
by a hash of the source and the flags, so a library is rebuilt only when
its source changes. `build(*names)` starts one nvcc per missing library,
all at once, waits for them and loads the results. Binding (argtypes) is
left to the wrapper module that owns the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source additions. K3's membership tests and K4/K5's traversal
# decisions sit on float thresholds; with no multiply-add contraction every
# operation rounds as its plain torch version's separate elementwise
# operations do
EXTRA_FLAGS = {"cone_kernels": ["-fmad=false"],
               "bvh_kernels": ["-fmad=false"]}

# name → {"seconds": nvcc wall time, "ptxas": its report, "library": path}
BUILD_INFO: dict = {}
_libs: dict = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(cand):
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return cand


def _flags(name):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _library_path(name):
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def build(*names):
    """Compile (where needed, in parallel) and load csrc/<name>.cu for
    each name. Returns {name: ctypes.CDLL}."""
    jobs = []
    for name in names:
        if name in _libs:
            continue
        so = _library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, so, tmp, proc, time.perf_counter()))
    errors = []
    for name, so, tmp, proc, t0 in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{out}{err}")
            continue
        os.replace(tmp, so)
        BUILD_INFO[name] = dict(seconds=time.perf_counter() - t0,
                                ptxas=err.strip())
    if errors:
        raise RuntimeError("\n".join(errors))
    for name in names:
        if name not in _libs:
            so = _library_path(name)
            _libs[name] = ctypes.CDLL(str(so))
            BUILD_INFO.setdefault(name, {})["library"] = str(so)
    return {name: _libs[name] for name in names}
