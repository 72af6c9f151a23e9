"""Host-side binary BVH build (binned SAH), flattened to arrays.

Port of wave_tracer_tpu/accel/bvh.py, the same algorithm: a binned-SAH
binary tree over the triangles' bounds (N_BINS bins on the widest
centroid axis, leaves of at most LEAF_TILE triangles, depth capped at
MAX_DEPTH so that a traversal's per-ray stack stays small; `pack_nodes`
refuses a tree whose capped leaves outgrow LEAF_TILE). Children are adjacent (right =
left + 1) and a leaf names a contiguous range of `tri_order`, the
permutation into the soup's triangles. Above NATIVE_THRESHOLD triangles
the C++ builder (wave_tracer_tpu_torch/native) builds the same arrays;
below it, the numpy code here. accel/trace.py takes this tree for a scene
above MXU_MAX_TRIS triangles (the BVH route, kernels K4/K5).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_DEPTH = 30
LEAF_TILE = 4      # the largest leaf; K4/K5 and their twins test this many
N_BINS = 16        # SAH bins on the widest centroid axis
# node_pack holds each node's `left` (a node or a triangle index) as
# float32, exact up to 2^24
MAX_PACKED_INDEX = 1 << 24


@dataclass
class FlatBVH:
    node_min: np.ndarray    # (N, 3) f32
    node_max: np.ndarray    # (N, 3) f32
    node_left: np.ndarray   # (N,) i32 — internal: left child (right=left+1); leaf: first tri
    node_count: np.ndarray  # (N,) i32 — 0 internal, >0 leaf triangle count
    tri_order: np.ndarray   # (T,) i32 permutation into the original tri arrays

    @property
    def num_nodes(self):
        return len(self.node_min)

    def depth(self) -> int:
        return tree_depth(self.node_left, self.node_count)


def tree_depth(node_left, node_count) -> int:
    """The depth of the tree of these node arrays (a lone leaf: 0)."""
    d = {0: 0}
    best = 0
    stack = [0]
    while stack:
        i = stack.pop()
        if node_count[i] == 0:
            left = node_left[i]
            d[left] = d[left + 1] = d[i] + 1
            best = max(best, d[left])
            stack += [left, left + 1]
    return best


NATIVE_THRESHOLD = 4096   # use the C++ builder above this triangle count


def build_bvh(positions: np.ndarray) -> FlatBVH:
    """Binned-SAH binary BVH over triangle soup positions (T, 3, 3).

    Above NATIVE_THRESHOLD triangles the C++ builder (native/) builds it,
    with the same array layout; a failed compile of that builder raises.
    """
    T = len(positions)
    if T > NATIVE_THRESHOLD:
        from wave_tracer_tpu_torch import native
        return native.build_bvh_native(positions)
    if T == 0:
        return FlatBVH(np.zeros((1, 3), np.float32),
                       np.zeros((1, 3), np.float32),
                       np.zeros(1, np.int32), np.zeros(1, np.int32),
                       np.zeros(0, np.int32))
    tmin = positions.min(axis=1).astype(np.float64)
    tmax = positions.max(axis=1).astype(np.float64)
    cent = 0.5 * (tmin + tmax)

    order = np.arange(T, dtype=np.int64)
    node_min, node_max, node_left, node_count = [], [], [], []

    def new_node():
        node_min.append(None)
        node_max.append(None)
        node_left.append(0)
        node_count.append(0)
        return len(node_min) - 1

    root = new_node()
    # work stack: (node_idx, start, end, depth)
    stack = [(root, 0, T, 0)]
    while stack:
        ni, s, e, depth = stack.pop()
        ids = order[s:e]
        bmin = tmin[ids].min(axis=0)
        bmax = tmax[ids].max(axis=0)
        node_min[ni] = bmin
        node_max[ni] = bmax
        n = e - s
        if n <= LEAF_TILE or depth >= MAX_DEPTH:
            node_left[ni] = s
            node_count[ni] = n
            continue

        # binned SAH over the best axis
        c = cent[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            # all centroids identical: split in half
            mid = s + n // 2
        else:
            scale = N_BINS * (1.0 - 1e-7) / ext[axis]
            bidx = ((c[:, axis] - cmin[axis]) * scale).astype(np.int64)
            # per-bin bounds + counts
            counts = np.bincount(bidx, minlength=N_BINS)
            binmin = np.full((N_BINS, 3), np.inf)
            binmax = np.full((N_BINS, 3), -np.inf)
            np.minimum.at(binmin, bidx, tmin[ids])
            np.maximum.at(binmax, bidx, tmax[ids])
            # prefix/suffix areas
            def areas(mn, mx):
                d = np.maximum(mx - mn, 0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
            lmin = np.minimum.accumulate(binmin, axis=0)
            lmax = np.maximum.accumulate(binmax, axis=0)
            rmin = np.minimum.accumulate(binmin[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(binmax[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = np.cumsum(counts[::-1])[::-1]
            cost = np.full(N_BINS - 1, np.inf)
            la = areas(lmin, lmax)[:-1]
            ra = areas(rmin, rmax)[1:]
            valid = (lcnt[:-1] > 0) & (rcnt[1:] > 0)
            cost[valid] = (la * lcnt[:-1] + ra * rcnt[1:])[valid]
            best = int(np.argmin(cost))
            if not np.isfinite(cost[best]):
                mid = s + n // 2
            else:
                sel = bidx <= best
                # partition preserving relative order
                left_ids = ids[sel]
                right_ids = ids[~sel]
                order[s:s + len(left_ids)] = left_ids
                order[s + len(left_ids):e] = right_ids
                mid = s + len(left_ids)
                if mid == s or mid == e:
                    mid = s + n // 2

        li = new_node()
        ri = new_node()
        assert ri == li + 1
        node_left[ni] = li
        node_count[ni] = 0
        stack.append((ri, mid, e, depth + 1))
        stack.append((li, s, mid, depth + 1))

    return FlatBVH(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        node_left=np.asarray(node_left, np.int32),
        node_count=np.asarray(node_count, np.int32),
        tri_order=order.astype(np.int32),
    )


def check_traversable(node_count, num_nodes: int, num_tris: int):
    """Raise unless K4/K5 walk this tree exactly: every leaf at most
    LEAF_TILE triangles (a leaf cut by MAX_DEPTH may hold more, and the
    rest could never be hit), and every index exact in node_pack's
    float32 (`MAX_PACKED_INDEX`)."""
    largest = int(np.max(node_count, initial=0))
    if largest > LEAF_TILE:
        raise ValueError(
            f"the BVH has a leaf of {largest} triangles (its depth reached "
            f"MAX_DEPTH = {MAX_DEPTH}); the traversal tests at most "
            f"LEAF_TILE = {LEAF_TILE} per leaf")
    if max(num_nodes, num_tris) > MAX_PACKED_INDEX:
        raise ValueError(
            f"{num_tris} triangles, {num_nodes} BVH nodes: node_pack holds "
            f"indices as float32, exact only up to {MAX_PACKED_INDEX}")


def pack_nodes(bvh: FlatBVH) -> np.ndarray:
    """(M, 16) f32 node rows, as the JAX package's `from_soup` packs them:
    [count, left, left child's min and max, right child's min and max,
    pad2]; a leaf's child columns hold node 0's box (never read). Raises
    for a tree that K4/K5 cannot walk exactly (`check_traversable`)."""
    nmin = np.asarray(bvh.node_min, np.float32)
    nmax = np.asarray(bvh.node_max, np.float32)
    nleft = np.asarray(bvh.node_left, np.int64)
    ncount = np.asarray(bvh.node_count, np.int64)
    M = len(nleft)
    check_traversable(ncount, M, len(bvh.tri_order))
    node_pack = np.zeros((max(M, 1), 16), np.float32)
    if M:
        node_pack[:, 0] = ncount
        node_pack[:, 1] = nleft
        internal = ncount == 0
        li = np.where(internal, np.clip(nleft, 0, M - 1), 0)
        ri = np.where(internal, np.clip(nleft + 1, 0, M - 1), 0)
        node_pack[:, 2:5] = nmin[li]
        node_pack[:, 5:8] = nmax[li]
        node_pack[:, 8:11] = nmin[ri]
        node_pack[:, 11:14] = nmax[ri]
    return node_pack
