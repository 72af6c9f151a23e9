"""Port parity: the Sobol sampler of wave_tracer_tpu_torch is bit-equal to
the JAX package's over a grid of pixel × sample × depth × salt.

Both packages get the same seeded numpy inputs; draws are compared as f32
bit patterns, and the scrambled uint32 words as integers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wave_tracer_tpu.sampling import rng as jrng
from wave_tracer_tpu.sampling import sobol as jsobol
from wave_tracer_tpu_torch.sampling import rng as trng
from wave_tracer_tpu_torch.sampling import sobol as tsobol


def _grid(seed=0):
    r = np.random.default_rng(seed)
    pix = np.concatenate([np.arange(64), r.integers(0, 1 << 20, 64)])
    sid = np.concatenate([np.arange(8), r.integers(0, 1 << 16, 8)])
    P, S = np.meshgrid(pix, sid, indexing="ij")
    return P.reshape(-1).astype(np.int32), S.reshape(-1).astype(np.int32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_uniform_bit_equal(seed):
    pix, sid = _grid(seed)
    jkeys = jrng.sample_key(jrng.make_base_key(seed), jnp.asarray(pix),
                            jnp.asarray(sid))
    tkeys = trng.sample_key(trng.make_base_key(seed), torch.from_numpy(pix),
                            torch.from_numpy(sid))
    np.testing.assert_array_equal(np.asarray(jkeys["strm"]),
                                  tkeys["strm"].numpy().astype(np.uint32))
    depth_v = np.random.default_rng(seed + 1).integers(
        0, 9, len(pix)).astype(np.int32)
    for depth in (0, 3, 7):
        jd = jrng.depth_key(jkeys, depth)
        td = trng.depth_key(tkeys, depth)
        for salt in (jrng.D_PIXEL_JITTER, jrng.D_SPECTRUM, jrng.D_NEE,
                     jrng.D_RR, 12):
            a = jrng.uniform(jd, salt, 4)
            b = trng.uniform(td, salt, 4)
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    jd = jrng.depth_key_v(jkeys, jnp.asarray(depth_v))
    td = trng.depth_key_v(tkeys, torch.from_numpy(depth_v))
    for salt in (jrng.D_EMITTER_PICK, jrng.D_BSDF_DIR):
        np.testing.assert_array_equal(
            _bits(jrng.uniform(jd, salt)), _bits(trng.uniform(td, salt)))


def test_sobol_words_bit_equal():
    r = np.random.default_rng(3)
    idx = r.integers(0, 1 << 31, 4096).astype(np.uint32)
    seed = r.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    ti = torch.from_numpy(idx.astype(np.int64))
    ts = torch.from_numpy(seed.astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(jsobol._hash(jnp.asarray(seed))),
        tsobol._hash(ts).numpy().astype(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(jsobol._reverse_bits(jnp.asarray(idx))),
        tsobol._reverse_bits(ti).numpy().astype(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(jsobol._owen_scramble(jnp.asarray(idx),
                                         jnp.asarray(seed))),
        tsobol._owen_scramble(ti, ts).numpy().astype(np.uint32))
    for dim in (0, 1, 2):
        np.testing.assert_array_equal(
            np.asarray(jsobol.sobol_raw(jnp.asarray(idx), dim)),
            tsobol.sobol_raw(ti, dim).numpy().astype(np.uint32))
        np.testing.assert_array_equal(
            _bits(jsobol.sample(jnp.asarray(idx), dim, jnp.asarray(seed))),
            _bits(tsobol.sample(ti, dim, ts).numpy()))


def test_base_key_is_last_key_word():
    for seed in (0, 1, 2 ** 31 + 5):
        raw = np.asarray(jax.random.key_data(jrng.make_base_key(seed)))
        assert int(raw.reshape(-1)[-1]) == trng.make_base_key(seed)
