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

* `closest_hit` (K1): least (t, id) per ray, ties to the smaller id. An
  optional bool `need` mask names the rows to trace; the others keep
  `carry`, the (t, tri) the caller already has for them (a miss if
  None), and the kernel never traces them.
* `any_hit` (K2): whether any pair hits. Rows outside `need` return
  False and are never traced.

Both kernels read their own copy of the triangles (`RayTable`), sorted so
that their 256-triangle tiles are compact (`tile_order`), and skip, per
warp, the tiles whose box (`tile_boxes`) no segment of the warp meets;
K1 walks each block's tiles near to far and shrinks each segment to the
best t found so far. `_tile_box_may_hit` is the plain twin of that cull,
which the tests hold against the pair tests.

On a CUDA tensor each wrapper launches its hand-written kernel
(csrc/ray_kernels.cu, built with nvcc for sm_90a at first use and loaded
with ctypes) and adds one to LAUNCHES; on a CPU tensor it runs the plain
torch twin (`_closest_ref` / `_anyhit_ref`, the port of `_launch_ref`: a
loop over triangle tiles of 512 with a running min or max, fp32 matmuls,
never materializing (N, 4T); it computes every row and keeps the carried
result off the need mask). Any other device raises.

Triangle features are compact rows (T, 24) f32:
  [A×B | B−A | B×C | C−B | C×A | A−C | −N | N·A | pad2]
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from wave_tracer_tpu_torch.accel import nvcc_build

BIG = 3.4e38               # f32(3.4e38): "no hit" distance
_BIG_F32 = float(np.float32(BIG))
# K1's "no hit" word (order_key(BIG) << 32 | 0xFFFFFFFF) as a signed int64
_NO_HIT = int(np.uint64(((int(np.float32(BIG).view(np.uint32)) | 1 << 31)
                         << 32) | 0xFFFFFFFF).view(np.int64))
DEN_EPS = 1e-12
NF = 24                    # floats per triangle row
TILE_REF = 512             # triangle tile of the torch twins
TILE = 256                 # triangles per bounding-box tile
BLOCKS_PER_SM = 4          # K2's persistent grid
K1_BLOCKS_PER_SM = 3       # K1's persistent grid (its __launch_bounds__)
K1_MAX_TILES = 512         # tiles K1 sorts in shared memory (T <= 2^17)

LAUNCHES = {"closest": 0, "anyhit": 0}


_functorch = torch._C._functorch


def carries_derivative(*xs):
    """Whether any of the tensors requires grad (with grad mode on),
    carries a forward-mode tangent, or is wrapped by a torch.func
    transform."""
    return any(x is not None and (
        (x.requires_grad and torch.is_grad_enabled())
        or _functorch.is_functorch_wrapped_tensor(x)
        or fwAD.unpack_dual(x).tangent is not None) for x in xs)


def primal(x, dtype=None):
    """The plain contiguous tensor a kernel reads (of `dtype` if given): x
    detached and, inside a torch.func transform (jvp, grad), unwrapped to
    the value it holds. Unwrapping comes last: inside a transform even a
    no-op `.to` returns a wrapped tensor."""
    x = (x if dtype is None else x.to(dtype)).contiguous().detach()
    while _functorch.is_functorch_wrapped_tensor(x):
        x = _functorch.get_unwrapped(x)
    return x


def outside_transforms():
    """A context in which torch.func transforms wrap no new tensor: the
    launch code allocates its outputs and work buffers there, so a kernel
    reads and writes plain memory (its inputs are `primal` already)."""
    return torch._C._DisableFuncTorch()


def check_primal(what, *xs):
    """The kernels read raw memory and have no derivative: a tensor that
    requires grad, carries a tangent or is wrapped by a torch.func
    transform must not reach them. Their callers pass `primal` tensors and
    restore the derivative outside the kernel (`trace_rays`); anything
    else raises."""
    if any(x is not None and (x.requires_grad
                              or _functorch.is_functorch_wrapped_tensor(x)
                              or _functorch.is_batchedtensor(x)
                              or fwAD.unpack_dual(x).tangent is not None)
           for x in xs):
        raise ValueError(f"{what}: inputs must be primal (detached) "
                         "tensors; the kernel has no derivative")


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


def tile_boxes(p0, e1, e2, center):
    """(ceil(T / 256), 8) f32 boxes of the 256-triangle tiles in row
    order, translated by `center` as the kernel rows are: [lo | s | hi |
    0] with s the tile's largest |v − center| component. Taken in f64 and
    rounded outward."""
    T = p0.shape[0]
    nt = -(-T // TILE)
    if T == 0:
        return p0.new_zeros((0, 8))
    f64 = torch.float64
    A = p0.to(f64) - center.to(f64)
    v = torch.stack([A, A + e1.to(f64), A + e2.to(f64)], 1)
    rows = torch.arange(nt * TILE, device=p0.device).clamp_max(T - 1)
    v = v[rows].reshape(nt, TILE * 3, 3)
    lo, hi = v.amin(1), v.amax(1)
    s = v.abs().amax(2).amax(1, keepdim=True)
    slack = 1e-6 * (s + 1.0)
    return torch.cat([lo - slack, s * (1 + 1e-6), hi + slack,
                      torch.zeros_like(s)], 1).float()


def tile_order(p0, e1, e2):
    """(T,) int64 row order of the kernels' own copies of the triangles
    (K2's `RayTable`, K3's `cone_kernels.ConeTable`), so that each
    256-triangle tile holds triangles that lie together: the bake order
    may interleave distant ones (an icosphere bakes each level of its
    subdivision in turn), and a tile cull can only skip a compact tile.
    The centroids are split at a multiple of 256 across the longest side
    of their box, recursively, down to single tiles; triangles more than
    16× the median extent go last. Computed on the host, once per scene."""
    v = torch.stack([p0, p0 + e1, p0 + e2], 1).detach().cpu().double()
    v = v.numpy()
    if len(v) == 0:
        return torch.zeros((0,), dtype=torch.long, device=p0.device)
    c = v.mean(1)
    ext = np.linalg.norm(v.max(1) - v.min(1), axis=-1)
    big = ext > 16 * np.median(ext)
    leaves = []

    def split(idx):
        if len(idx) <= TILE:
            leaves.append(idx)
            return
        pts = c[idx]
        axis = int(np.argmax(pts.max(0) - pts.min(0)))
        k = TILE * -(-(-(-len(idx) // TILE)) // 2)
        part = np.argpartition(pts[:, axis], k - 1)
        split(idx[part[:k]])
        split(idx[part[k:]])

    split(np.flatnonzero(~big))
    order = np.concatenate(leaves + [np.flatnonzero(big)])
    return torch.from_numpy(order).to(p0.device)


class RayTable(NamedTuple):
    """K1's and K2's own copy of the triangles, in `tile_order`: the
    kernel rows (T, 24), the bake-order id of each row (T,) i32, which
    exclusions and K1's ties compare, and the rows' tile boxes
    (`tile_boxes`)."""
    feat: torch.Tensor
    ids: torch.Tensor
    boxes: torch.Tensor


def ray_table(p0, e1, e2, center, feat, order):
    """The RayTable of the triangles p0/e1/e2 with rows `feat`
    (`tri_features`) in the row order `order` (`tile_order`)."""
    return RayTable(feat[order].contiguous(), order.to(torch.int32),
                    tile_boxes(p0[order], e1[order], e2[order], center))


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------

_lib = None


def build():
    """Compile csrc/ray_kernels.cu (if its hash changed) and bind it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = nvcc_build.build("ray_kernels")["ray_kernels"]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wt_closest_hit.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp, vp, vp,
                                   vp, vp, vp, ci, vp, vp, ci, vp]
    lib.wt_any_hit.argtypes = [vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp,
                               vp, ci, vp, ci, vp]
    for fn in (lib.wt_closest_hit, lib.wt_any_hit):
        fn.restype = ci
    _lib = lib
    return lib


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


def need_list(need):
    """The rows of a bool mask as a device-side list, with no host sync:
    (rows (N + 1,) i32 whose first `count` entries are the set rows in
    order, count (1,) i32). A cumsum ranks the set rows; the rest scatter
    into the spare last slot."""
    N = need.shape[0]
    csum = torch.cumsum(need, 0, dtype=torch.int32)
    dst = torch.where(need, csum - 1, N).long()
    rows = torch.empty((N + 1,), dtype=torch.int32, device=need.device)
    rows.scatter_(0, dst, torch.arange(N, dtype=torch.int32,
                                       device=need.device))
    return rows, csum[-1:]


def _check_table(table, tri_feat, center, ro, rd, tmin, tmax, ex):
    feat, ids, boxes = table
    _check(feat, center, ro, rd, tmin, tmax, ex)
    dev = ro.device
    T = feat.shape[0]
    if (feat.shape != tri_feat.shape or ids.shape != (T,)
            or ids.dtype != torch.int32 or ids.device != dev
            or not ids.is_contiguous() or boxes.device != dev
            or boxes.dtype != torch.float32
            or boxes.shape != (-(-T // TILE), 8)
            or not boxes.is_contiguous()):
        raise ValueError("table: need the RayTable (`ray_table`) of these "
                         f"triangles on {dev}")


def _need_rows(need, N, dev):
    """(rows, count) of the need list, or (None, None) for all rows."""
    if need is None:
        return None, None
    if need.shape != (N,) or need.dtype != torch.bool or need.device != dev:
        raise ValueError(f"need: a bool (N,) mask on {dev}")
    return need_list(need)


def _launch_closest(tri_feat, table, center, ro, rd, tmin, tmax, ex,
                    need=None, carry=None, *, every_pair=False):
    """K1's launch → (N,) int64 words. `every_pair` tests every pair of
    every tile in tile order: the same words, slower; the reference its
    walk and culls are held to."""
    lib = build()
    _check_table(table, tri_feat, center, ro, rd, tmin, tmax, ex)
    feat, ids, boxes = table
    dev = ro.device
    N, T = ro.shape[0], feat.shape[0]
    if -(-T // TILE) > K1_MAX_TILES:
        raise ValueError(f"closest hit: {T} triangles > "
                         f"{K1_MAX_TILES * TILE}")
    rows, count = _need_rows(need, N, dev)
    best = torch.full((N,), _NO_HIT, dtype=torch.int64, device=dev)
    if need is not None and carry is not None:
        if any(x.shape != (N,) or x.device != dev for x in carry):
            raise ValueError(f"carry: (t, tri), each (N,) on {dev}")
        best = torch.where(need, best, _pack(*carry))
    if N == 0:
        return best
    queue = torch.zeros((1,), dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    err = lib.wt_closest_hit(feat.data_ptr(), ids.data_ptr(),
                             boxes.data_ptr(), T, int(every_pair),
                             center.data_ptr(), ro.data_ptr(), rd.data_ptr(),
                             tmin.data_ptr(), tmax.data_ptr(), ex.data_ptr(),
                             None if rows is None else rows.data_ptr(),
                             None if count is None else count.data_ptr(), N,
                             best.data_ptr(), queue.data_ptr(),
                             K1_BLOCKS_PER_SM * sms, stream)
    if err != 0:
        raise RuntimeError(f"ray kernel launch failed: cudaError {err}")
    LAUNCHES["closest"] += 1
    return best


def _launch_anyhit(tri_feat, table, center, ro, rd, tmin, tmax, ex, need):
    lib = build()
    _check_table(table, tri_feat, center, ro, rd, tmin, tmax, ex)
    feat, ids, boxes = table
    dev = ro.device
    N, T = ro.shape[0], feat.shape[0]
    occ = torch.zeros((N,), dtype=torch.uint8, device=dev)
    if N == 0:
        return occ
    rows, count = _need_rows(need, N, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    err = lib.wt_any_hit(feat.data_ptr(), ids.data_ptr(), boxes.data_ptr(),
                         T,
                         center.data_ptr(), ro.data_ptr(), rd.data_ptr(),
                         tmin.data_ptr(), tmax.data_ptr(), ex.data_ptr(),
                         None if rows is None else rows.data_ptr(),
                         None if count is None else count.data_ptr(), N,
                         occ.data_ptr(), BLOCKS_PER_SM * sms, stream)
    if err != 0:
        raise RuntimeError(f"ray kernel launch failed: cudaError {err}")
    LAUNCHES["anyhit"] += 1
    return occ


def _pack(t, tri):
    """(t f32, tri int32) → K1's int64 words (order_key(t) << 32 | id), the
    inverse of `_unpack`; tri -1 packs to id 0xFFFFFFFF."""
    b = t.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    key = torch.where(b >= 1 << 31, b ^ 0xFFFFFFFF, b | 1 << 31)
    hi = torch.where(key >= 1 << 31, key - (1 << 32), key)
    return hi * (1 << 32) + (tri.long() & 0xFFFFFFFF)


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
    S = (rf @ _tile_matrix(tf)).view(rf.shape[0], tf.shape[0], 5)
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


def _closest_ref(tri_feat, center, ro, rd, tmin, tmax, ex, need=None,
                 carry=None):
    """Twin of K1 → (t (N,) f32, BIG on miss; tri (N,) int32, -1 on miss).
    Rows outside `need` return `carry` (t, tri), or a miss if None."""
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
    if need is None:
        return best_t, best_i
    if carry is None:
        carry = (torch.full_like(best_t, _BIG_F32),
                 torch.full_like(best_i, -1))
    return (torch.where(need, best_t, carry[0]),
            torch.where(need, best_i, carry[1].to(torch.int32)))


def _anyhit_ref(tri_feat, center, ro, rd, tmin, tmax, ex, need=None):
    """Twin of K2 → occluded (N,) bool; rows outside `need` are False."""
    if need is not None:
        occ = torch.zeros((ro.shape[0],), dtype=torch.bool, device=ro.device)
        occ[need] = _anyhit_ref(tri_feat, center, ro[need], rd[need],
                                tmin[need], tmax[need], ex[need])
        return occ
    rf = _ray_features(ro, rd, center)
    occ = torch.zeros((ro.shape[0],), dtype=torch.bool, device=ro.device)
    for base in range(0, tri_feat.shape[0], TILE_REF):
        _, hit, _ = _tile_hits(rf, tri_feat[base:base + TILE_REF], base,
                               tmin, tmax, ex)
        occ |= hit.any(dim=1)
    return occ


def _tile_box_may_hit(boxes, center, ro, rd, tmin, tmax):
    """Twin of K1's and K2's tile cull (seg_may_hit) → (N, ntiles) bool:
    may the segment o + t·d, t in [tmin, tmax], meet the tile's padded
    box? (K1 asks with tmax = the best t so far.)"""
    o = (ro - center)[:, None, :]
    d = rd[:, None, :]
    lo, s, hi = boxes[None, :, 0:3], boxes[None, :, 3], boxes[None, :, 4:7]
    omax = o.abs().amax(-1)
    pad = 2e-3 * (omax + s) + 1e-6
    dlen = (d * d).sum(-1).clamp_min(1e-30).sqrt()
    dt = pad / dlen
    tn, tf = tmin[:, None] - dt, tmax[:, None] + dt
    inv = 1.0 / d
    a = (lo - pad[..., None] - o) * inv
    b = (hi + pad[..., None] - o) * inv
    for k in range(3):
        tn = torch.fmax(tn, torch.fmin(a[..., k], b[..., k]))
        tf = torch.fmin(tf, torch.fmax(a[..., k], b[..., k]))
    return tn <= tf


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def closest_hit(tri_feat, center, ro, rd, tmin, tmax, ex, need=None,
                carry=None, *, table):
    """K1: closest hit per ray. ex (N, 3) int32 excluded ids (-1 = none).
    `need` (N,) bool, or None for all rows, names the rows to trace; the
    others return `carry` (t, tri), or a miss if None, untraced. The
    kernel reads `table`, the RayTable of `tri_feat` (`ray_table`); the
    plain version reads `tri_feat`. Returns (t (N,) f32 with BIG on miss,
    tri (N,) int32 with -1 on miss). Every input must be primal
    (`check_primal`)."""
    check_primal("closest hit", tri_feat, center, ro, rd, tmin, tmax, ex,
                 need, *(carry or ()))
    with outside_transforms():
        if ro.device.type == "cpu":
            return _closest_ref(tri_feat, center, ro, rd, tmin, tmax, ex,
                                need, carry)
        if ro.device.type != "cuda":
            raise NotImplementedError(
                f"ray kernels: no backend for {ro.device}")
        return _unpack(_launch_closest(tri_feat, table, center, ro, rd,
                                       tmin, tmax, ex, need, carry))


def any_hit(tri_feat, center, ro, rd, tmin, tmax, ex, need=None, *, table):
    """K2: whether any triangle hits in (tmin, tmax]. `need` (N,) bool, or
    None for all rows, names the rows to trace; the others are False.
    The kernel reads `table`, the RayTable of `tri_feat` (`ray_table`);
    the plain version reads `tri_feat`. Returns (N,) bool. Every input
    must be primal (`check_primal`)."""
    check_primal("any hit", tri_feat, center, ro, rd, tmin, tmax, ex, need)
    with outside_transforms():
        if ro.device.type == "cpu":
            return _anyhit_ref(tri_feat, center, ro, rd, tmin, tmax, ex,
                               need)
        if ro.device.type != "cuda":
            raise NotImplementedError(
                f"ray kernels: no backend for {ro.device}")
        return _launch_anyhit(tri_feat, table, center, ro, rd, tmin, tmax,
                              ex, need).bool()


# ---------------------------------------------------------------------------
# ray queries (the contracts of mxu_trace.trace_mxu / occluded_mxu)
# ---------------------------------------------------------------------------

def _exclusions(N, device, *ids):
    cols = [torch.full((N,), -1, dtype=torch.int32, device=device)
            if x is None else x.to(torch.int32) for x in ids]
    cols += [cols[0].new_full((N,), -1)] * (3 - len(cols))
    return torch.stack(cols, dim=-1).contiguous()


def trace_rays(geo, ro, rd, tmin, tmax, exclude_tri=None, need=None,
               carry=None):
    """Closest hit over all triangles, traced for the rows of `need` (all
    if None); the others take `carry` (t, tri). Returns (t, tri, u, v): t =
    BIG and tri = -1 on a miss; u/v of the winner recomputed here with the
    standard Möller–Trumbore formula from one gather.

    The kernel traces `primal` copies of the rays, so (t, tri) is a
    detached pick. u and v, and t where the rays or `geo.tri_geom` carry a
    derivative, take theirs from the winner's Möller–Trumbore solve, as
    the JAX package's exact-AD CPU traces do: t is the kernel's value bit
    for bit, plus (t_mt − t_mt) with the second term detached. With no
    derivative in play t is the kernel's and costs nothing more."""
    N = ro.shape[0]
    ex = _exclusions(N, ro.device, exclude_tri)
    if carry is not None:
        carry = (primal(carry[0]), primal(carry[1]))
    t, tri = closest_hit(geo.tri_feat, geo.mxu_center, primal(ro),
                         primal(rd), primal(tmin), primal(tmax), primal(ex),
                         need if need is None else primal(need), carry,
                         table=geo.ray_table)
    return solve_hits(geo.tri_geom, ro, rd, t, tri)


def solve_hits(tri_geom, ro, rd, t, tri):
    """(t, tri, u, v) of a closest-hit query's (t, tri) (BIG and -1 on a
    miss): u/v of the winner by the standard Möller–Trumbore formula from
    one gather of `tri_geom`, and t plus (t_mt − t_mt) with the second term
    detached where the rays or `tri_geom` carry a derivative (`trace_rays`
    says why)."""
    valid = tri >= 0
    row = tri_geom[tri.clamp_min(0).long()]
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
    if carries_derivative(ro, rd, tri_geom):
        t_mt = (e2 * qvec).sum(-1) * inv_det
        t = torch.where(valid, t + (t_mt - t_mt.detach()), t)
    return t, tri, u, v


def occluded_rays(geo, ro, rd, tmin, tmax, exclude_tri=None,
                  exclude_tri2=None, exclude_tri3=None, need=None):
    """Any hit within (tmin, tmax] for the rows of `need` (all rows if
    None); False elsewhere. Returns bool (N,)."""
    N = ro.shape[0]
    ex = _exclusions(N, ro.device, exclude_tri, exclude_tri2, exclude_tri3)
    return any_hit(geo.tri_feat, geo.mxu_center, primal(ro), primal(rd),
                   primal(tmin), primal(tmax), primal(ex),
                   need if need is None else primal(need),
                   table=geo.ray_table)
