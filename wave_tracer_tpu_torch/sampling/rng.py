"""Deterministic counter-based sampling for wavefront rendering.

Port of the Sobol mode of wave_tracer_tpu/sampling/rng.py, bit for bit:
every draw is a pure function of (base seed, pixel, sample, depth, use).
Each logical (u1, u2) pair comes from dimensions (0, 1) of the padded
Owen-scrambled Sobol sequence at index = sample id, decorrelated per
(pixel, depth, use) by hash-based scrambling (sampling/sobol.py).

The JAX package's threefry chain (its "uniform" sampler and `normal`)
feeds no draw of the Sobol mode: the Sobol stream reads only the last word
of the base key, which for ``PRNGKey(seed)`` is ``seed mod 2^32``. So the
port's base key is that plain integer, and the threefry sampler is not
ported (asking for it raises).

uint32 values are carried in int64 tensors (see sampling/sobol.py).
"""

from __future__ import annotations

import os

import torch

from wave_tracer_tpu_torch.sampling import sobol
from wave_tracer_tpu_torch.sampling.sobol import M32, mul32

# Dimension salts: one namespace per consumer so streams never collide.
D_PIXEL_JITTER = 0
D_LENS = 1
D_SPECTRUM = 2
D_EMITTER_PICK = 3
D_EMITTER_POS = 4
D_EMITTER_DIR = 5
D_BSDF_LOBE = 6
D_BSDF_DIR = 7
D_NEE = 8
D_RR = 9
D_FSD = 10
D_SENSOR = 11
D_PHASE = 12


def make_base_key(seed: int) -> int:
    """The Sobol-mode base key: the last word of jax's PRNGKey(seed)."""
    if os.environ.get("WT_SAMPLER", "sobol") != "sobol":
        raise NotImplementedError(
            "only the Sobol sampler is ported (WT_SAMPLER=sobol)")
    return int(seed) & M32


def sample_key(base_key: int, pixel_id, sample_id):
    """Sampling stream for one (pixel, sample) path: a dict of int64
    tensors holding uint32 values."""
    pix = pixel_id.long() & M32
    strm = sobol._hash(pix ^ base_key)
    idx = sample_id.long() & M32
    return {"idx": idx, "strm": strm, "d": torch.zeros_like(idx)}


def depth_key(stream, depth):
    """Sub-stream for one bounce; depth is an int or a per-lane tensor
    (compacted wavefronts where each lane sits at its own bounce)."""
    if isinstance(depth, torch.Tensor):
        d = depth.long() & M32
    else:
        d = torch.full_like(stream["idx"], int(depth) & M32)
    return {"idx": stream["idx"], "strm": stream["strm"], "d": d}


depth_key_v = depth_key


def uniform(stream, salt: int, n: int | None = None):
    """U[0,1) draws: one per lane, or (N, n) when n is given. Component
    pairs (2i, 2i+1) are dims (0, 1) of the scrambled sequence at
    index = sample id, scramble stream hash(pixel, depth, salt, i)."""
    nn = 1 if n is None else n
    salt_term = ((salt & M32) * 0x85EBCA6B) & M32
    seed0 = stream["strm"] ^ ((mul32(stream["d"], 0x9E3779B9) + salt_term)
                              & M32)
    cols = []
    for i in range(nn):
        seed = (seed0 + (((i // 2) * 0xC2B2AE35) & M32)) & M32
        cols.append(sobol.sample(stream["idx"], i % 2, seed))
    if n is None:
        return cols[0]
    return torch.stack(cols, dim=-1)
