"""Owen-scrambled Sobol sequences — device-side, stateless.

Port of wave_tracer_tpu/sampling/sobol.py, bit for bit. torch's uint32
supports few operations and its `>>` on int32 is arithmetic, so every
uint32 value here is carried in an int64 tensor in [0, 2^32) and masked
with `& 0xFFFFFFFF` after each shift, multiply and add. Products are
split into 16-bit halves so no int64 product overflows. The result turns
into f32 only at the end, as the JAX twin does (which can round up to 1.0;
kept identical).
"""

from __future__ import annotations

import numpy as np
import torch

_JK = [
    # (s, a, [m...]) Joe-Kuo primitive polynomials / direction numbers
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
    (5, 4, [1, 1, 5, 5, 5]),
]

N_DIMS = len(_JK) + 1
_BITS = 32
M32 = 0xFFFFFFFF


def _direction_matrices() -> np.ndarray:
    """(N_DIMS, 32) uint32 direction numbers."""
    V = np.zeros((N_DIMS, _BITS), np.uint64)
    for i in range(_BITS):
        V[0, i] = np.uint64(1) << np.uint64(31 - i)
    for d, (s, a, m_init) in enumerate(_JK, start=1):
        m = list(m_init)
        for i in range(s, _BITS):
            mi = m[i - s] ^ (m[i - s] << s)
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    mi ^= m[i - k] << k
            m.append(mi)
        for i in range(_BITS):
            V[d, i] = np.uint64(m[i]) << np.uint64(31 - i)
    return V.astype(np.uint32)


_V = [[int(v) for v in row] for row in _direction_matrices()]


def mul32(x, c: int):
    """(x · c) mod 2^32 for x an int64 tensor in [0, 2^32), c a constant."""
    c &= M32
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _byte_tables(dim: int) -> np.ndarray:
    """(4·256,) XORs of dimension dim's direction numbers over every value
    of each byte of the index: entry 256·p + v is the XOR of V[8p + b]
    for the set bits b of v."""
    tab = np.zeros((4, 256), np.int64)
    for p in range(4):
        for v in range(256):
            for b in range(8):
                if (v >> b) & 1:
                    tab[p, v] ^= _V[dim][8 * p + b]
    return tab.reshape(-1)


_BYTE_TABLES = [None] + [_byte_tables(d) for d in range(1, N_DIMS)]
_TABLE_CACHE = {}


def sobol_raw(index, dim: int):
    """Unscrambled Sobol sample bits of a static dimension (int64 u32):
    the XOR of the direction numbers of the index's set bits, looked up
    one byte at a time."""
    idx = index & M32
    if dim == 0:
        return _reverse_bits(idx)        # van der Corput = bit reversal
    key = (dim, idx.device)
    tab = _TABLE_CACHE.get(key)
    if tab is None:
        tab = _TABLE_CACHE[key] = torch.from_numpy(
            _BYTE_TABLES[dim]).to(idx.device)
    out = tab[idx & 0xFF]
    for p in range(1, 4):
        out = out ^ tab[256 * p + ((idx >> (8 * p)) & 0xFF)]
    return out


def _hash(x):
    x = x & M32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _owen_scramble(bits, seed):
    """Laine–Karras style hash-based Owen scrambling of reversed bits."""
    v = _reverse_bits(bits)
    v = (v + seed) & M32
    v = v ^ mul32(v, 0x6C50B47C)
    v = v ^ mul32(v, 0xB82F1E52)
    v = v ^ mul32(v, 0xC7AFE638)
    v = v ^ mul32(v, 0x8D22F6E6)
    return _reverse_bits(v)


def _reverse_bits(x):
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & M32) | (x >> 16)


def sample(index, dim: int, seed):
    """Owen-scrambled Sobol u ∈ [0,1): index (...,) sample index, dim a
    static dimension, seed (...,) u32 decorrelation stream (int64)."""
    return sample_dims(index, [dim], seed[..., None])[..., 0]


def sample_dims(index, dims, seed):
    """`sample` for several static dimensions at once: index (...,),
    dims a list of n ints, seed (..., n) one stream per column → (..., n).
    Every column equals its own `sample` call bit for bit; the columns
    share each torch op, so n columns cost the launches of one."""
    raw = {d: sobol_raw(index, d % N_DIMS) for d in set(dims)}
    bits = torch.stack([raw[d] for d in dims], dim=-1)
    salt = torch.tensor([(d * 0x9E3779B9) & M32 for d in dims],
                        dtype=torch.int64, device=seed.device)
    s = _owen_scramble(bits, _hash(seed + salt))
    return s.to(torch.float32) * (1.0 / 4294967296.0)


def sample2(index, dim_pair: int, seed):
    """A (u1, u2) pair from dimensions 2·dim_pair and 2·dim_pair + 1."""
    return sample_dims(index, [2 * dim_pair, 2 * dim_pair + 1],
                       seed[..., None].expand(seed.shape + (2,)))
