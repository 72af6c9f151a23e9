"""BVH traversal: CUDA kernels K4 (closest hit) and K5 (any hit) and their
plain torch twins.

The port's counterpart of wave_tracer_tpu/accel/trace.py::trace_bvh and
::occluded_bvh, the lock-step traversals the JAX package runs above
MXU_MAX_TRIS triangles as one device loop. Both walk the flat binary BVH
of accel/bvh.py through its packed rows: `node_pack` (M, 16) = count,
left, the two children's boxes inline (accel/bvh.py::pack_nodes), and
`tri_geom` (T, 12) = p0, e1, e2, pad, with the triangles in BVH leaf order
(a leaf names the rows left .. left + count − 1). Per ray, a stack of
MAX_DEPTH + 2 node ids, the root pre-pushed; each step pops one node:

* closest hit (K4, `_closest_ref`): an internal node's two children are
  slab-tested against [tmin, best t] and the nearer (left on a tie)
  pushed last; a leaf's triangles are Möller–Trumbore-tested
  (ops/intersect.py) against [tmin, best t], one excluded id skipped, a
  strictly smaller t winning. Returns (t, tri): BIG and −1 on a miss.
* any hit (K5, `_anyhit_ref`): children against [tmin, tmax], the right
  pushed first; leaf triangles against three excluded ids; a ray stops at
  its first hit. Returns occluded (N,) bool.

The twins step every ray in lock-step, as the JAX loops do (rays that
have finished drop out of the working set); a lane of the twin does
exactly what one thread of the kernel does, operation for operation, and
the kernels are built with -fmad=false, so their outputs equal the
twins' bit for bit. Each wrapper takes a `need` mask: rows off it are
neither read nor traced (K4 returns their `carry`, a miss if None; K5
False).

On a CUDA tensor each wrapper launches its hand-written kernel
(csrc/bvh_kernels.cu, built with nvcc for sm_90a at first use and loaded
with ctypes) and adds one to util/stats.py's `launches/k4` or
`launches/k5`; on a CPU tensor it runs the twin.
Any other device raises; nothing falls back from a failed build or launch.
"""

from __future__ import annotations

import ctypes

import torch

from wave_tracer_tpu_torch.accel import nvcc_build
from wave_tracer_tpu_torch.accel.bvh import LEAF_TILE, MAX_DEPTH
from wave_tracer_tpu_torch.accel.ray_kernels import (check_primal,
                                                     outside_transforms)
from wave_tracer_tpu_torch.ops.intersect import (BIG, ray_aabb, ray_tri,
                                                 safe_inverse)
from wave_tracer_tpu_torch.util.stats import registry

STACK = MAX_DEPTH + 2      # per-ray stack of node ids (the .cu's STACK)
NODE_F = 16                # floats per node_pack row
TRI_F = 12                 # floats per tri_geom row

_K4_LAUNCHES = registry.counter("launches/k4")
_K5_LAUNCHES = registry.counter("launches/k5")

_lib = None


def build():
    """Compile csrc/bvh_kernels.cu (if its hash changed) and bind it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = nvcc_build.build("bvh_kernels")["bvh_kernels"]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wt_bvh_closest.argtypes = [vp] * 10 + [ci, vp, vp, vp]
    lib.wt_bvh_any.argtypes = [vp] * 8 + [ci, vp, vp]
    for fn in (lib.wt_bvh_closest, lib.wt_bvh_any):
        fn.restype = ci
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# plain torch twins (the lock-step loops of the JAX package)
# ---------------------------------------------------------------------------

def _push(stack, sp, node, hit):
    """Push `node` where `hit` (and the stack has room) → new sp."""
    ok = hit & (sp < STACK)
    at = sp.clamp_max(STACK - 1)[:, None]
    stack.scatter_(1, at, torch.where(ok, node, stack.gather(1, at)[:, 0])
                   [:, None])
    return sp + ok.long()


def _pop(stack, sp, nodes):
    """Pop each lane's top node → (sp, count, left, node row)."""
    sp = sp - 1
    node = stack.gather(1, sp[:, None])[:, 0]
    row = nodes[node]
    return sp, node, row[:, 0].long(), row[:, 1].long(), row


def _count(stats, key, x):
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(x.sum())


def _seen(stats, key, size, ids, ok):
    """Mark the rows `ids` (where `ok`) as read, for the bytes a run needs."""
    if stats is not None:
        seen = stats.setdefault(key, torch.zeros(
            (size + 1,), dtype=torch.bool, device=ids.device))
        seen.scatter_(0, torch.where(ok, ids, size), True)


def _closest_ref(nodes, tris, ro, rd, tmin, tmax, ex, stats=None):
    """Twin of K4 over every row → (t (N,) f32, BIG on a miss; tri (N,)
    int32, −1 on a miss). `stats`, a dict, gathers what the walk did:
    internal nodes popped ("internal"), leaves popped ("leaves"),
    triangles tested ("tri_tests"), and masks of the node and triangle
    rows read ("nodes_seen", "tris_seen")."""
    N, dev = ro.shape[0], ro.device
    out_t = torch.full((N,), BIG, dtype=torch.float32, device=dev)
    out_i = torch.full((N,), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(N, device=dev)
    o, d, lo, ex = ro, rd, tmin, ex.long()
    inv = safe_inverse(rd)
    best_t = torch.minimum(tmax, torch.full_like(tmax, BIG))
    best_i = torch.full((N,), -1, dtype=torch.long, device=dev)
    stack = torch.zeros((N, STACK), dtype=torch.long, device=dev)
    sp = torch.ones((N,), dtype=torch.long, device=dev)
    while lane.numel():
        sp, node, cnt, left, row = _pop(stack, sp, nodes)
        _seen(stats, "nodes_seen", nodes.shape[0], node, cnt >= 0)
        inner = cnt == 0
        _count(stats, "internal", inner)
        _count(stats, "leaves", ~inner)
        lt, lhit = ray_aabb(o, inv, row[:, 2:5], row[:, 5:8], lo, best_t)
        rt, rhit = ray_aabb(o, inv, row[:, 8:11], row[:, 11:14], lo, best_t)
        near = lt <= rt
        sp = _push(stack, sp, torch.where(near, left + 1, left),
                   torch.where(near, rhit, lhit) & inner)
        sp = _push(stack, sp, torch.where(near, left, left + 1),
                   torch.where(near, lhit, rhit) & inner)
        for k in range(LEAF_TILE):
            ti = left + k
            ok = ~inner & (k < cnt) & (ti != ex)
            _count(stats, "tri_tests", ok)
            _seen(stats, "tris_seen", tris.shape[0], ti, ok)
            trow = tris[torch.where(ok, ti, 0)]
            t, _, _, hit = ray_tri(o, d, trow[:, 0:3], trow[:, 3:6],
                                   trow[:, 6:9], lo, best_t)
            better = hit & ok & (t < best_t)
            best_t = torch.where(better, t, best_t)
            best_i = torch.where(better, ti, best_i)
        done = sp == 0
        if done.any():
            fin = lane[done]
            out_t[fin] = torch.where(best_i[done] >= 0, best_t[done], BIG)
            out_i[fin] = best_i[done].to(torch.int32)
            keep = ~done
            lane, o, d, inv, lo, ex, best_t, best_i, stack, sp = (
                x[keep] for x in (lane, o, d, inv, lo, ex, best_t, best_i,
                                  stack, sp))
    return out_t, out_i


def _anyhit_ref(nodes, tris, ro, rd, tmin, tmax, ex, stats=None):
    """Twin of K5 over every row → occluded (N,) bool; ex (N, 3) excluded
    ids. `stats` as `_closest_ref`'s."""
    N, dev = ro.shape[0], ro.device
    occ = torch.zeros((N,), dtype=torch.bool, device=dev)
    lane = torch.arange(N, device=dev)
    o, d, lo, hi, ex = ro, rd, tmin, tmax, ex.long()
    inv = safe_inverse(rd)
    stack = torch.zeros((N, STACK), dtype=torch.long, device=dev)
    sp = torch.ones((N,), dtype=torch.long, device=dev)
    while lane.numel():
        sp, node, cnt, left, row = _pop(stack, sp, nodes)
        _seen(stats, "nodes_seen", nodes.shape[0], node, cnt >= 0)
        inner = cnt == 0
        _count(stats, "internal", inner)
        _count(stats, "leaves", ~inner)
        _, lhit = ray_aabb(o, inv, row[:, 2:5], row[:, 5:8], lo, hi)
        _, rhit = ray_aabb(o, inv, row[:, 8:11], row[:, 11:14], lo, hi)
        sp = _push(stack, sp, left + 1, rhit & inner)
        sp = _push(stack, sp, left, lhit & inner)
        hit_any = torch.zeros_like(inner)
        for k in range(LEAF_TILE):
            ti = left + k
            ok = ~inner & (k < cnt) & (ti != ex[:, 0]) & (ti != ex[:, 1]) \
                & (ti != ex[:, 2])
            _count(stats, "tri_tests", ok)
            _seen(stats, "tris_seen", tris.shape[0], ti, ok)
            trow = tris[torch.where(ok, ti, 0)]
            _, _, _, hit = ray_tri(o, d, trow[:, 0:3], trow[:, 3:6],
                                   trow[:, 6:9], lo, hi)
            hit_any |= hit & ok
        done = (sp == 0) | hit_any
        if done.any():
            occ[lane[done]] = hit_any[done]
            keep = ~done
            lane, o, d, inv, lo, hi, ex, stack, sp = (
                x[keep] for x in (lane, o, d, inv, lo, hi, ex, stack, sp))
    return occ


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def _check(nodes, tris, ro, rd, tmin, tmax, ex, ex_cols, need):
    dev = ro.device
    N = ro.shape[0]
    for name, x, dt in (("nodes", nodes, torch.float32),
                        ("tris", tris, torch.float32),
                        ("ro", ro, torch.float32), ("rd", rd, torch.float32),
                        ("tmin", tmin, torch.float32),
                        ("tmax", tmax, torch.float32),
                        ("exclude", ex, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
    ex_shape = (N,) if ex_cols == 1 else (N, ex_cols)
    if (nodes.ndim != 2 or nodes.shape[1] != NODE_F or tris.ndim != 2
            or tris.shape[1] != TRI_F or ro.shape != (N, 3)
            or rd.shape != (N, 3) or tmin.shape != (N,)
            or tmax.shape != (N,) or ex.shape != ex_shape):
        raise ValueError("bvh kernel: bad shapes")
    if nodes.data_ptr() % 16 or tris.data_ptr() % 16:
        raise ValueError("nodes, tris: the kernels read float4, so the "
                         "rows must start on a 16-byte boundary")
    if need is not None and (need.shape != (N,) or need.dtype != torch.bool
                             or need.device != dev):
        raise ValueError(f"need: a bool (N,) mask on {dev}")


def _need_u8(need):
    return None if need is None else need.to(torch.uint8).contiguous()


def _launch_closest(nodes, tris, ro, rd, tmin, tmax, ex, need=None,
                    carry=None):
    lib = build()
    _check(nodes, tris, ro, rd, tmin, tmax, ex, 1, need)
    dev, N = ro.device, ro.shape[0]
    out_t = torch.empty((N,), dtype=torch.float32, device=dev)
    out_i = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return out_t, out_i
    ct = ci = None
    if need is not None and carry is not None:
        if any(x.shape != (N,) or x.device != dev for x in carry):
            raise ValueError(f"carry: (t, tri), each (N,) on {dev}")
        ct = carry[0].to(torch.float32).contiguous()
        ci = carry[1].to(torch.int32).contiguous()
    need8 = _need_u8(need)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = lib.wt_bvh_closest(nodes.data_ptr(), tris.data_ptr(),
                             ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(),
                             tmax.data_ptr(), ex.data_ptr(), ptr(need8),
                             ptr(ct), ptr(ci), N, out_t.data_ptr(),
                             out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bvh kernel launch failed: cudaError {err}")
    _K4_LAUNCHES.add()
    return out_t, out_i


def _launch_any(nodes, tris, ro, rd, tmin, tmax, ex, need=None):
    lib = build()
    _check(nodes, tris, ro, rd, tmin, tmax, ex, 3, need)
    dev, N = ro.device, ro.shape[0]
    occ = torch.empty((N,), dtype=torch.uint8, device=dev)
    if N == 0:
        return occ
    need8 = _need_u8(need)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    err = lib.wt_bvh_any(nodes.data_ptr(), tris.data_ptr(), ro.data_ptr(),
                         rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
                         ex.data_ptr(),
                         None if need8 is None else need8.data_ptr(), N,
                         occ.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bvh kernel launch failed: cudaError {err}")
    _K5_LAUNCHES.add()
    return occ


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def closest_hit(nodes, tris, ro, rd, tmin, tmax, ex, need=None, carry=None):
    """K4: closest hit per ray over the BVH `nodes` (M, 16) of the
    triangles `tris` (T, 12) (node_pack, tri_geom). ex (N,) int32 excluded
    id (−1 none). `need` (N,) bool, or None for all rows, names the rows
    to trace; the others return `carry` (t, tri), or a miss if None,
    untraced. Returns (t (N,) f32, BIG on a miss; tri (N,) int32, −1 on a
    miss). Every input must be primal (`ray_kernels.check_primal`)."""
    check_primal("bvh closest hit", nodes, tris, ro, rd, tmin, tmax, ex,
                 need, *(carry or ()))
    with outside_transforms():
        if ro.device.type == "cuda":
            return _launch_closest(nodes, tris, ro, rd, tmin, tmax, ex,
                                   need, carry)
        if ro.device.type != "cpu":
            raise NotImplementedError(
                f"bvh kernels: no backend for {ro.device}")
        if need is None:
            return _closest_ref(nodes, tris, ro, rd, tmin, tmax, ex)
        if carry is None:
            t = torch.full((ro.shape[0],), BIG, dtype=torch.float32)
            tri = torch.full((ro.shape[0],), -1, dtype=torch.int32)
        else:
            t = carry[0].to(torch.float32).clone()
            tri = carry[1].to(torch.int32).clone()
        t[need], tri[need] = _closest_ref(
            nodes, tris, *(x[need] for x in (ro, rd, tmin, tmax, ex)))
        return t, tri


def any_hit(nodes, tris, ro, rd, tmin, tmax, ex, need=None):
    """K5: whether any triangle hits in (tmin, tmax]; ex (N, 3) int32
    excluded ids (−1 none). `need` (N,) bool, or None for all rows, names
    the rows to trace; the others are False. Returns (N,) bool. Every
    input must be primal (`ray_kernels.check_primal`)."""
    check_primal("bvh any hit", nodes, tris, ro, rd, tmin, tmax, ex, need)
    with outside_transforms():
        if ro.device.type == "cuda":
            return _launch_any(nodes, tris, ro, rd, tmin, tmax, ex,
                               need).bool()
        if ro.device.type != "cpu":
            raise NotImplementedError(
                f"bvh kernels: no backend for {ro.device}")
        if need is None:
            return _anyhit_ref(nodes, tris, ro, rd, tmin, tmax, ex)
        occ = torch.zeros((ro.shape[0],), dtype=torch.bool)
        occ[need] = _anyhit_ref(
            nodes, tris, *(x[need] for x in (ro, rd, tmin, tmax, ex)))
        return occ
