"""The K-smallest selection of the set queries (plain torch).

The JAX package's triangle and edge set queries keep, per lane, the K
entries of least key (entry distance, distance) with `jax.lax.top_k` of
the negated keys, merging a running top K with each tile of candidates.
Ties there go to the lower position, so the result is the K least by
(key, id) whatever the tiling: a stable ascending sort gives the same.
Keys are inf where a candidate is not taken; results are (idx (N, K) i32,
−1 where the key is inf, key (N, K), count (N,) i32).
"""

from __future__ import annotations

import math

import torch


def smallest(z, k):
    """(values, indices) of the k smallest of each row, ascending, ties to
    the lower index; k may exceed the row."""
    sz, sel = torch.sort(z, dim=1, stable=True)
    return sz[:, :k], sel[:, :k]


def empty_set(N, K, dev):
    """The result of a query with nothing to find."""
    return (torch.full((N, K), -1, dtype=torch.int32, device=dev),
            torch.full((N, K), math.inf, device=dev),
            torch.zeros((N,), dtype=torch.int32, device=dev))


def pick(keys, ids, K):
    """The K candidates of least key among ids (N, J) with keys (N, J)."""
    z, sel = smallest(keys, K)
    idx = torch.gather(ids, 1, sel)
    valid = torch.isfinite(z)
    return (torch.where(valid, idx, -1), z, valid.sum(1, dtype=torch.int32))


def tiled_smallest(N, T, K, tile, dev, tile_keys):
    """The K candidates of least key among T, in tiles: tile_keys(s, n)
    gives the keys (N, n) of candidates s..s+n. A running top K merges
    each tile, so no (N, T) array is formed."""
    bz = torch.full((N, K), math.inf, device=dev)
    bidx = torch.full((N, K), -1, dtype=torch.int32, device=dev)
    for s in range(0, T, tile):
        zk = tile_keys(s, min(tile, T - s))
        ids = torch.arange(s, s + zk.shape[1], dtype=torch.int32,
                           device=dev)
        bz, sel = smallest(torch.cat([bz, zk], dim=1), K)
        bidx = torch.gather(torch.cat([bidx, ids[None].expand_as(zk)],
                                      dim=1), 1, sel)
    valid = torch.isfinite(bz)
    return (torch.where(valid, bidx, -1), bz,
            valid.sum(1, dtype=torch.int32))
