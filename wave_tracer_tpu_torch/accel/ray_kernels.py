"""All-pairs ray-triangle queries: CUDA kernels K1/K2 and their torch twins.

Port of wave_tracer_tpu/accel/mxu_trace.py. Every intersection quantity
is bilinear in per-ray and per-triangle features:

  side(edge P->Q) = d · (P × Q) + (o × d) · (Q − P)        (Plücker)
  t · (d · N)     = N · A − N · o                          (plane)
  d · N           = side_AB + side_BC + side_CA            (identity)

with o and the vertices translated by the scene's `mxu_center` to keep the
moments small. A pair hits when the three sides share a sign, their sum
has |Σ sides| > 1e-12, and t = tn / (d · N) lies in (tmin, tmax],
excluding up to three triangle ids per ray. d · N is evaluated directly
rather than as the sum of the sides (the JAX kernel's identity): for small
triangles far from mxu_center the sides cancel, and t from their sum
carries ~1e-4 relative error.

* `closest_hit` (K1): least (t, id) per ray, ties to the smaller id.
* `any_hit` (K2): whether any pair hits.

On a CUDA tensor each wrapper launches its hand-written kernel
(csrc/ray_kernels.cu, built with nvcc for sm_90a at first use and loaded
with ctypes) and adds one to LAUNCHES; on a CPU tensor it runs the plain
torch twin (`_closest_ref` / `_anyhit_ref`, the port of `_launch_ref`: a
loop over triangle tiles of 512 with a running min or max, fp32 matmuls,
never materializing (N, 4T)). Any other device raises.

Triangle features are compact rows (T, 24) f32:
  [A×B | B−A | B×C | C−B | C×A | A−C | −N | N·A | pad2]
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

BIG = 3.4e38               # f32(3.4e38): "no hit" distance
_BIG_F32 = float(np.float32(BIG))
# K1's "no hit" word (order_key(BIG) << 32 | 0xFFFFFFFF) as a signed int64
_NO_HIT = int(np.uint64(((int(np.float32(BIG).view(np.uint32)) | 1 << 31)
                         << 32) | 0xFFFFFFFF).view(np.int64))
DEN_EPS = 1e-12
NF = 24                    # floats per triangle row
TILE_REF = 512             # triangle tile of the torch twins

LAUNCHES = {"closest": 0, "anyhit": 0}

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "ray_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
BUILD_INFO = {}            # seconds, ptxas report, library path


def tri_features(p0, e1, e2, center):
    """Compact kernel rows (T, 24) f32 from p0/e1/e2 (T, 3) and center (3,).
    Built in float64 and rounded once, as the JAX feature bake does."""
    f64 = torch.float64
    A = p0.to(f64) - center.to(f64)
    e1 = e1.to(f64)
    e2 = e2.to(f64)
    B = A + e1
    C = A + e2
    N = torch.linalg.cross(e1, e2, dim=-1)
    out = torch.zeros((A.shape[0], NF), dtype=f64, device=A.device)
    out[:, 0:3] = torch.linalg.cross(A, B, dim=-1)
    out[:, 3:6] = B - A
    out[:, 6:9] = torch.linalg.cross(B, C, dim=-1)
    out[:, 9:12] = C - B
    out[:, 12:15] = torch.linalg.cross(C, A, dim=-1)
    out[:, 15:18] = A - C
    out[:, 18:21] = -N
    out[:, 21] = (N * A).sum(-1)
    return out.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------

def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(cand):
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return cand


def build():
    """Compile csrc/ray_kernels.cu (if its hash changed) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libray_kernels_{tag[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(_SRC)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
        BUILD_INFO.update(seconds=time.perf_counter() - t0,
                          ptxas=proc.stderr.strip())
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("wt_closest_hit", "wt_any_hit"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, vp, ci, vp, vp]
        fn.restype = ci
    BUILD_INFO["library"] = str(so)
    _lib = lib
    return lib


def _chunks(N, T, device):
    """Triangle-range split so that ~8 blocks of 256 rays run per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ray_blocks = -(-N // 256)
    tiles = -(-T // 256)
    return max(1, min(tiles, -(-8 * sms // ray_blocks)))


def _check(tri_feat, center, ro, rd, tmin, tmax, ex):
    dev = ro.device
    for name, x, dt in (("tri_feat", tri_feat, torch.float32),
                        ("center", center, torch.float32),
                        ("ro", ro, torch.float32), ("rd", rd, torch.float32),
                        ("tmin", tmin, torch.float32),
                        ("tmax", tmax, torch.float32),
                        ("exclude", ex, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
    N = ro.shape[0]
    if (tri_feat.ndim != 2 or tri_feat.shape[1] != NF
            or ro.shape != (N, 3) or rd.shape != (N, 3)
            or tmin.shape != (N,) or tmax.shape != (N,)
            or ex.shape != (N, 3) or center.shape != (3,)):
        raise ValueError("ray kernel: bad shapes")
    if tri_feat.data_ptr() % 16:
        raise ValueError("tri_feat: the kernel reads float4, so the rows "
                         "must start on a 16-byte boundary")


def _launch(anyhit, tri_feat, center, ro, rd, tmin, tmax, ex):
    lib = build()
    _check(tri_feat, center, ro, rd, tmin, tmax, ex)
    N, T = ro.shape[0], tri_feat.shape[0]
    stream = ctypes.c_void_p(torch.cuda.current_stream(ro.device).cuda_stream)
    chunks = _chunks(N, T, ro.device)
    args = (tri_feat.data_ptr(), T, chunks, center.data_ptr(), ro.data_ptr(),
            rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), ex.data_ptr(), N)
    if anyhit:
        occ = torch.zeros((N,), dtype=torch.uint8, device=ro.device)
        err = lib.wt_any_hit(*args, occ.data_ptr(), stream)
        out = occ
    else:
        best = torch.full((N,), _NO_HIT, dtype=torch.int64,
                          device=ro.device)
        err = lib.wt_closest_hit(*args, best.data_ptr(), stream)
        out = best
    if err != 0:
        raise RuntimeError(f"ray kernel launch failed: cudaError {err}")
    LAUNCHES["anyhit" if anyhit else "closest"] += 1
    return out


def _unpack(best):
    """K1's int64 words (order_key(t) << 32 | id) → (t f32, tri int32).
    order_key flips every bit of a negative float and only the sign bit of
    the rest (csrc/ray_kernels.cu); id 0xFFFFFFFF means no hit."""
    key = (best >> 32) & 0xFFFFFFFF
    bits = torch.where(key >= 1 << 31, key ^ (1 << 31), key ^ 0xFFFFFFFF)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    t = bits.to(torch.int32).view(torch.float32)
    low = best & 0xFFFFFFFF
    tri = torch.where(low == 0xFFFFFFFF, -1, low).to(torch.int32)
    return t, tri


# ---------------------------------------------------------------------------
# plain torch twins (the port of mxu_trace._launch_ref)
# ---------------------------------------------------------------------------

def _ray_features(ro, rd, center):
    o = ro - center
    m = torch.linalg.cross(o, rd, dim=-1)
    return torch.cat([rd, m, o, torch.ones_like(ro[:, :1])], dim=-1)


def _tile_matrix(tf):
    """(bt, 24) rows → (10, 5·bt) matrix: columns [s0, s1, s2, tn, d·N]
    per triangle, contracted against ray features [d, o×d, o, 1]."""
    bt = tf.shape[0]
    W = tf.new_zeros((bt, 5, 10))
    for k in range(3):
        W[:, k, 0:6] = tf[:, 6 * k:6 * k + 6]
    W[:, 3, 6:9] = tf[:, 18:21]
    W[:, 3, 9] = tf[:, 21]
    W[:, 4, 0:3] = -tf[:, 18:21]
    return W.reshape(bt * 5, 10).T


def _tile_hits(rf, tf, base, tmin, tmax, ex):
    """Shared twin body: (t, hit, ids) of one triangle tile."""
    S = (rf @ _tile_matrix(tf)).view(rf.shape[0], -1, 5)
    s0, s1, s2, tn, dn = S.unbind(-1)
    denom = s0 + s1 + s2
    pos = (s0 >= 0) & (s1 >= 0) & (s2 >= 0)
    neg = (s0 <= 0) & (s1 <= 0) & (s2 <= 0)
    dok = denom.abs() > DEN_EPS
    t = tn / torch.where(dok, dn, torch.ones_like(dn))
    ids = base + torch.arange(tf.shape[0], device=rf.device,
                              dtype=torch.int32)
    hit = (pos | neg) & dok & (t > tmin[:, None]) & (t <= tmax[:, None])
    for c in range(ex.shape[1]):
        hit &= ids[None, :] != ex[:, c:c + 1]
    return t, hit, ids


def _closest_ref(tri_feat, center, ro, rd, tmin, tmax, ex):
    """Twin of K1 → (t (N,) f32, BIG on miss; tri (N,) int32, -1 on miss)."""
    N = ro.shape[0]
    rf = _ray_features(ro, rd, center)
    best_t = torch.full((N,), _BIG_F32, dtype=torch.float32, device=ro.device)
    best_i = torch.full((N,), -1, dtype=torch.int32, device=ro.device)
    for base in range(0, tri_feat.shape[0], TILE_REF):
        t, hit, ids = _tile_hits(rf, tri_feat[base:base + TILE_REF], base,
                                 tmin, tmax, ex)
        t = torch.where(hit, t, torch.full_like(t, _BIG_F32))
        trow = t.min(dim=1).values
        idrow = torch.where(t <= trow[:, None], ids[None, :],
                            torch.full_like(t, 2 ** 30, dtype=torch.int32)
                            ).min(dim=1).values
        better = trow < best_t
        best_i = torch.where(better, idrow, best_i)
        best_t = torch.where(better, trow, best_t)
    return best_t, best_i


def _anyhit_ref(tri_feat, center, ro, rd, tmin, tmax, ex):
    """Twin of K2 → occluded (N,) bool."""
    rf = _ray_features(ro, rd, center)
    occ = torch.zeros((ro.shape[0],), dtype=torch.bool, device=ro.device)
    for base in range(0, tri_feat.shape[0], TILE_REF):
        _, hit, _ = _tile_hits(rf, tri_feat[base:base + TILE_REF], base,
                               tmin, tmax, ex)
        occ |= hit.any(dim=1)
    return occ


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def closest_hit(tri_feat, center, ro, rd, tmin, tmax, ex):
    """K1: closest hit per ray. ex (N, 3) int32 excluded ids (-1 = none).
    Returns (t (N,) f32 with BIG on miss, tri (N,) int32 with -1 on miss)."""
    if ro.device.type == "cpu":
        return _closest_ref(tri_feat, center, ro, rd, tmin, tmax, ex)
    if ro.device.type != "cuda":
        raise NotImplementedError(f"ray kernels: no backend for {ro.device}")
    return _unpack(_launch(False, tri_feat, center, ro, rd, tmin, tmax, ex))


def any_hit(tri_feat, center, ro, rd, tmin, tmax, ex):
    """K2: whether any triangle hits in (tmin, tmax]. Returns (N,) bool."""
    if ro.device.type == "cpu":
        return _anyhit_ref(tri_feat, center, ro, rd, tmin, tmax, ex)
    if ro.device.type != "cuda":
        raise NotImplementedError(f"ray kernels: no backend for {ro.device}")
    return _launch(True, tri_feat, center, ro, rd, tmin, tmax, ex).bool()


# ---------------------------------------------------------------------------
# ray queries (the contracts of mxu_trace.trace_mxu / occluded_mxu)
# ---------------------------------------------------------------------------

def _exclusions(N, device, *ids):
    cols = [torch.full((N,), -1, dtype=torch.int32, device=device)
            if x is None else x.to(torch.int32) for x in ids]
    cols += [cols[0].new_full((N,), -1)] * (3 - len(cols))
    return torch.stack(cols, dim=-1).contiguous()


def trace_rays(geo, ro, rd, tmin, tmax, exclude_tri=None):
    """Closest hit over all triangles. Returns (t, tri, u, v): t = BIG and
    tri = -1 on a miss; u/v of the winner recomputed here with the standard
    Möller–Trumbore formula from one gather."""
    N = ro.shape[0]
    ex = _exclusions(N, ro.device, exclude_tri)
    t, tri = closest_hit(geo.tri_feat, geo.mxu_center, ro.contiguous(),
                         rd.contiguous(), tmin.contiguous(),
                         tmax.contiguous(), ex)
    valid = tri >= 0
    row = geo.tri_geom[tri.clamp_min(0).long()]
    p0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    pvec = torch.linalg.cross(rd, e2, dim=-1)
    det = (e1 * pvec).sum(-1)
    one = torch.ones_like(det)
    inv_det = torch.where(det.abs() > 1e-12,
                          1.0 / torch.where(det == 0, one, det),
                          torch.zeros_like(det))
    tvec = ro - p0
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    v = (rd * qvec).sum(-1) * inv_det
    zero = torch.zeros_like(u)
    u = torch.where(valid, u.clamp(0.0, 1.0), zero)
    v = torch.where(valid, v.clamp(0.0, 1.0), zero)
    return t, tri, u, v


def occluded_rays(geo, ro, rd, tmin, tmax, exclude_tri=None,
                  exclude_tri2=None, exclude_tri3=None):
    """Any hit within (tmin, tmax]. Returns bool (N,)."""
    N = ro.shape[0]
    ex = _exclusions(N, ro.device, exclude_tri, exclude_tri2, exclude_tri3)
    return any_hit(geo.tri_feat, geo.mxu_center, ro.contiguous(),
                   rd.contiguous(), tmin.contiguous(), tmax.contiguous(), ex)
