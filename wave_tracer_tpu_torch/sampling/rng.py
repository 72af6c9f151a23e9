"""Deterministic counter-based sampling for wavefront rendering.

Port of wave_tracer_tpu/sampling/rng.py, bit for bit: every draw is a pure
function of (base seed, pixel, sample, depth, use). Two samplers, chosen
by WT_SAMPLER when the base key is made (`make_base_key`):

* "sobol" (the default): each logical (u1, u2) pair comes from dimensions
  (0, 1) of the padded Owen-scrambled Sobol sequence at index = sample
  id, decorrelated per (pixel, depth, use) by hash-based scrambling
  (sampling/sobol.py). The Sobol stream reads only the last word of the
  JAX package's ``PRNGKey(seed)``, which is ``seed mod 2^32``, so the base
  key is that plain integer and the streams carry no threefry words.
* any other value ("uniform"): threefry-2x32 fold_in chains, as
  ``jax.random`` computes them with ``jax_threefry_partitionable`` on:
  the base key is the two words of ``PRNGKey(seed)``, each stream carries
  a per-lane key (N, 2) beside the Sobol fields, and a draw is
  ``jax.random.uniform(fold_in(key, salt), shape)``.

The JAX package reads WT_SAMPLER once at import; the port reads it in
`make_base_key`, so a render takes the sampler its base key was made
with. `normal` draws from the threefry chain, as in the JAX package; a
Sobol stream carries none (computing it would add launches to every
Sobol draw), so `normal` needs a threefry stream or raw keys.

uint32 values are carried in int64 tensors (see sampling/sobol.py).
"""

from __future__ import annotations

import os

import numpy as np
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

# threefry-2x32: the rotations of its two alternating groups of 4 rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 hash (20 rounds) of counter words (x0, x1) under
    key words (k0, k1): uint32 values in int64 tensors or ints,
    broadcasting. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def fold_in(key, data):
    """jax.random.fold_in: key (..., 2) int64 words, data an int or an
    int tensor broadcasting against key[..., 0] → the new key (..., 2)."""
    if isinstance(data, torch.Tensor):
        data = data.long() & M32
    else:
        data = int(data) & M32
    w0, w1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(w0, w1), dim=-1)


def _bits(key, n: int | None):
    """jax.random's 32 random bits per element of shape () or (n,) for
    each key (N, 2) (the partitionable form: counter words (0, i), bits
    = the output words' xor) → (N,) or (N, n) int64."""
    k0, k1 = key[..., 0:1], key[..., 1:2]
    idx = torch.arange(1 if n is None else n, dtype=torch.int64,
                       device=key.device)
    w0, w1 = threefry2x32(k0, k1, 0, idx)
    b = w0 ^ w1
    return b[..., 0] if n is None else b


def _unit_floats(bits):
    """Bits → [0, 1) f32: 23 mantissa bits under the exponent of 1.0,
    minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
        - 1.0


def _threefry_uniform(keys, salt: int, n: int | None):
    u = _unit_floats(_bits(fold_in(keys, salt), n))
    return u.clamp_min(0.0)


def make_base_key(seed: int):
    """The base key of the sampler WT_SAMPLER names: for "sobol" (the
    default) the last word of jax's PRNGKey(seed), an int; otherwise both
    words of it, a tuple (0, seed mod 2^32) (jax without x64 keeps only
    the low 32 bits of a seed)."""
    if os.environ.get("WT_SAMPLER", "sobol") != "sobol":
        return (0, int(seed) & M32)
    return int(seed) & M32


def sample_key(base_key, pixel_id, sample_id):
    """Sampling stream for one (pixel, sample) path: a dict of int64
    tensors holding uint32 values; with a threefry base key also the
    lanes' threefry key (N, 2)."""
    threefry = isinstance(base_key, tuple)
    pix = pixel_id.long() & M32
    strm = sobol._hash(pix ^ (base_key[1] if threefry else base_key))
    idx = sample_id.long() & M32
    out = {"idx": idx, "strm": strm, "d": torch.zeros_like(idx)}
    if threefry:
        key = torch.tensor(base_key, dtype=torch.int64, device=pix.device)
        out["key"] = fold_in(fold_in(key, pix), idx)
    return out


def depth_key(stream, depth):
    """Sub-stream for one bounce; depth is an int or a per-lane tensor
    (compacted wavefronts where each lane sits at its own bounce)."""
    if isinstance(depth, torch.Tensor):
        d = depth.long() & M32
    else:
        d = torch.full_like(stream["idx"], int(depth) & M32)
    out = {"idx": stream["idx"], "strm": stream["strm"], "d": d}
    if "key" in stream:
        out["key"] = fold_in(stream["key"], d)
    return out


depth_key_v = depth_key


def uniform(stream, salt: int, n: int | None = None):
    """U[0,1) draws: one per lane, or (N, n) when n is given. Sobol
    streams: component pairs (2i, 2i+1) are dims (0, 1) of the scrambled
    sequence at index = sample id, scramble stream hash(pixel, depth,
    salt, i). Threefry streams (and raw keys (N, 2)): jax.random.uniform
    of fold_in(key, salt)."""
    if not isinstance(stream, dict):
        return _threefry_uniform(stream, salt, n)
    if "key" in stream:
        return _threefry_uniform(stream["key"], salt, n)
    nn = 1 if n is None else n
    salt_term = ((salt & M32) * 0x85EBCA6B) & M32
    seed0 = stream["strm"] ^ ((mul32(stream["d"], 0x9E3779B9) + salt_term)
                              & M32)
    offs = torch.tensor([((i // 2) * 0xC2B2AE35) & M32 for i in range(nn)],
                        dtype=torch.int64, device=seed0.device)
    u = sobol.sample_dims(stream["idx"], [i % 2 for i in range(nn)],
                          (seed0[..., None] + offs) & M32)
    return u[..., 0] if n is None else u


def uniform2(stream, salt: int):
    return uniform(stream, salt, 2)


# jax.random.normal draws u in [nextafter(−1, 0), 1) and returns √2·erfinv(u)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SCALE = float(np.float32(1.0) - np.float32(_NORMAL_LO))   # 2.0
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w − 2.5 for w = −log1p(−x²) < 5, else in √w − 3
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x):
    """erfinv of f32 x in (−1, 1) by XLA's polynomial, each Horner step
    one rounding (a fused multiply-add, as XLA's CPU backend contracts
    it): the JAX package's values to about one ulp."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_W_LT5[0], _ERFINV_W_GE5[0])
    for a, b in zip(_ERFINV_W_LT5[1:], _ERFINV_W_GE5[1:]):
        c = torch.where(lt, float(np.float32(a)), float(np.float32(b)))
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def normal(stream, salt: int, n: int | None = None):
    """Standard-normal draws of the threefry chain, one per lane or (N,
    n): jax.random.normal of fold_in(key, salt). stream is a threefry
    stream or raw keys (N, 2). erfinv by XLA's polynomial (`_erfinv`):
    draws agree with the JAX package's to about one ulp."""
    if isinstance(stream, dict):
        if "key" not in stream:
            raise ValueError(
                "normal draws from the threefry chain, which a Sobol "
                "stream does not carry: make the base key with "
                "WT_SAMPLER=uniform")
        stream = stream["key"]
    f = _unit_floats(_bits(fold_in(stream, salt), n))
    u = (f * _NORMAL_SCALE + _NORMAL_LO).clamp_min(_NORMAL_LO)
    return _SQRT2 * _erfinv(u)
