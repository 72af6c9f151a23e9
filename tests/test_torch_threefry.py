"""Port parity for the threefry sampler (WT_SAMPLER other than "sobol"):
wave_tracer_tpu_torch/sampling/rng.py against wave_tracer_tpu/sampling/
rng.py on the CPU.

The JAX package draws through jax.random with `jax_threefry_partitionable`
on (jax 0.9's default): the port computes those words. A change of that
default changes every draw, so `test_jax_threefry_setting` pins it.

* base keys, per-lane sample and depth keys, uniform draws: bit-equal;
* `normal` within 1e-6 absolute (torch's erfinv is not XLA's
  polynomial);
* a classical box render under WT_SAMPLER=uniform (bridged JAX bake)
  against the JAX render with its sampler switched, at PERF.md §2's
  classical bars, and the CLI under the variable;
* the Sobol default computes no threefry word.

The JAX module reads WT_SAMPLER once at import: its sampler is switched
here through its module variable; the port reads the variable when it
makes a base key.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from test_render import make_box_scene
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.render import render_scene as jrender
from wave_tracer_tpu.sampling import rng as jrng
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu_torch import cli
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.sampling import rng as trng
from wave_tracer_tpu_torch.scene.bridge import SPECTRAL_KEYS
from wave_tracer_tpu_torch.scene.build import BuiltScene
from wave_tracer_tpu_torch.scene.procedural import box_scene_xml
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene

cap_torch_threads()

SEEDS = (0, 7, 1234, 2**31 - 1, 2**31, 2**32 + 3, -1, -5)
RES, SPP, DEPTH, LANES = 16, 2, 4, 256
COUNTERS = ("rays_cast", "shadow_rays", "surface_interactions",
            "rr_terminations", "sum_path_depth")


@pytest.fixture
def threefry(monkeypatch):
    """Both packages on the threefry sampler."""
    monkeypatch.setenv("WT_SAMPLER", "uniform")
    monkeypatch.setattr(jrng, "_SAMPLER", "uniform")


def _words(key):
    return np.asarray(key).astype(np.int64)


def test_jax_threefry_setting():
    assert jax.config.jax_threefry_partitionable is True


def test_threefry2x32_matches_jax():
    r = np.random.default_rng(0)
    k = r.integers(0, 2**32, (2,), dtype=np.uint64).astype(np.uint32)
    x = r.integers(0, 2**32, (2, 37), dtype=np.uint64).astype(np.uint32)
    want = jprng.threefry_2x32(jnp.asarray(k), jnp.asarray(x.ravel()))
    w0, w1 = trng.threefry2x32(int(k[0]), int(k[1]),
                               torch.from_numpy(x[0].astype(np.int64)),
                               torch.from_numpy(x[1].astype(np.int64)))
    np.testing.assert_array_equal(
        np.concatenate([w0.numpy(), w1.numpy()]), _words(want))
    # Random123's known answer for key (0, 0), counter (0, 0)
    a, b = trng.threefry2x32(0, 0, torch.zeros(1, dtype=torch.int64), 0)
    assert (int(a[0]), int(b[0])) == (0x6B200159, 0x99BA4EFE)


def test_base_keys(monkeypatch):
    monkeypatch.delenv("WT_SAMPLER", raising=False)
    assert trng.make_base_key(1234) == 1234     # Sobol: the last word
    monkeypatch.setenv("WT_SAMPLER", "uniform")
    for seed in SEEDS:
        assert trng.make_base_key(seed) == tuple(
            _words(jax.random.PRNGKey(seed)).tolist()), seed


def _streams():
    r = np.random.default_rng(3)
    pix = r.integers(0, 65536, 300).astype(np.int32)
    sid = r.integers(0, 64, 300).astype(np.int32)
    depth = r.integers(0, 9, 300).astype(np.int32)
    return pix, sid, depth


def test_stream_keys_bit_equal(threefry):
    pix, sid, depth = _streams()
    for seed in (0, 1234, -1):
        js = jrng.sample_key(jrng.make_base_key(seed), jnp.asarray(pix),
                             jnp.asarray(sid))
        ts = trng.sample_key(trng.make_base_key(seed),
                             *map(torch.from_numpy, (pix, sid)))
        np.testing.assert_array_equal(ts["key"].numpy(), _words(js["key"]))
        for f in ("idx", "strm"):
            np.testing.assert_array_equal(ts[f].numpy(), _words(js[f]))
        jd, td = jrng.depth_key(js, 5), trng.depth_key(ts, 5)
        np.testing.assert_array_equal(td["key"].numpy(), _words(jd["key"]))
        jv = jrng.depth_key_v(js, jnp.asarray(depth))
        tv = trng.depth_key_v(ts, torch.from_numpy(depth))
        np.testing.assert_array_equal(tv["key"].numpy(), _words(jv["key"]))
        np.testing.assert_array_equal(tv["d"].numpy(), _words(jv["d"]))


@pytest.mark.parametrize("n", [None, 1, 2, 5, 34])
def test_uniform_draws_bit_equal(threefry, n):
    pix, sid, depth = _streams()
    js = jrng.depth_key_v(jrng.sample_key(jrng.make_base_key(99),
                                          jnp.asarray(pix),
                                          jnp.asarray(sid)),
                          jnp.asarray(depth))
    ts = trng.depth_key_v(trng.sample_key(trng.make_base_key(99),
                                          *map(torch.from_numpy, (pix, sid))),
                          torch.from_numpy(depth))
    for salt in (trng.D_PIXEL_JITTER, trng.D_RR, trng.D_FSD):
        want = np.asarray(jrng.uniform(js, salt, n))
        got = trng.uniform(ts, salt, n).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).all() and (got < 1).all()
    np.testing.assert_array_equal(trng.uniform2(ts, 3).numpy(),
                                  np.asarray(jrng.uniform2(js, 3)))
    # the raw-keys call
    np.testing.assert_array_equal(
        trng.uniform(ts["key"], 4, n).numpy(),
        np.asarray(jrng.uniform(js["key"], 4, n)))


@pytest.mark.parametrize("n", [None, 3])
def test_normal_draws(threefry, n):
    pix, sid, depth = _streams()
    js = jrng.depth_key(jrng.sample_key(jrng.make_base_key(5),
                                        jnp.asarray(pix), jnp.asarray(sid)),
                        2)
    ts = trng.depth_key(trng.sample_key(trng.make_base_key(5),
                                        *map(torch.from_numpy, (pix, sid))),
                        2)
    want = np.asarray(jrng.normal(js, 7, n))
    got = trng.normal(ts, 7, n).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() > 2.0


def test_sobol_streams_compute_no_threefry_word(monkeypatch):
    """The default sampler never reaches the threefry hash, so its draws
    and launches are those of the Sobol-only sampler; `normal` needs a
    threefry stream."""
    def boom(*a, **kw):
        raise AssertionError("threefry in Sobol mode")

    monkeypatch.delenv("WT_SAMPLER", raising=False)
    monkeypatch.setattr(trng, "threefry2x32", boom)
    pix, sid, depth = _streams()
    s = trng.depth_key_v(trng.sample_key(trng.make_base_key(1),
                                         *map(torch.from_numpy, (pix, sid))),
                         torch.from_numpy(depth))
    assert "key" not in s
    trng.uniform(s, 2, 4)
    scene = tmake_box_scene(res=8, spp=1)
    from wave_tracer_tpu_torch.scene.build import build_scene
    img, _ = render_scene(build_scene(scene, device="cpu"), device="cpu",
                          pool_lanes=64)
    assert np.isfinite(img).all()
    with pytest.raises(ValueError, match="threefry"):
        trng.normal(s, 1)


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


def _classical(scene):
    scene.integrator.fsd = False
    scene.integrator.max_depth = DEPTH
    return scene


def test_classical_render_under_threefry_matches_jax(threefry):
    jb = jbuild(_classical(make_box_scene(res=RES, spp=SPP)))
    jimg, jst = jrender(jb, spp=SPP, batch_lanes=LANES)
    arrays = _flatten(jb.data)
    built = BuiltScene.upload(
        _classical(tmake_box_scene(res=RES, spp=SPP)), arrays,
        [{k: arrays[f"spectral.{k}"] for k in SPECTRAL_KEYS}], "cpu")
    img, st = render_scene(built, device="cpu", pool_lanes=LANES)
    assert st["mode"] == "ray-compact" and np.isfinite(img).all()
    np.testing.assert_allclose(img.mean((0, 1)), jimg.mean((0, 1)),
                               rtol=0.01)
    scale = np.maximum(np.abs(jimg), np.abs(jimg).mean())
    assert ((np.abs(img - jimg) <= 1e-3 * scale).all(-1).mean() >= 0.98)
    for k in COUNTERS:
        a, b = st["device_counters"][k], jst["device_counters"][k]
        assert abs(a - b) <= 0.005 * b, (k, a, b)
    # other streams than the Sobol default's
    with pytest.MonkeyPatch.context() as m:
        m.delenv("WT_SAMPLER")
        sobol, _ = render_scene(built, device="cpu", pool_lanes=LANES)
    assert not np.array_equal(img, sobol)


def test_cli_renders_under_threefry(threefry, tmp_path):
    p = tmp_path / "box.xml"
    p.write_text(box_scene_xml(8, 2, 3, True, "point"))
    out = tmp_path / "out"
    assert cli.main(["render", str(p), "--device", "cpu", "-o",
                     str(out)]) == 0
    assert (out / "camera.exr").exists() or list(out.glob("*.exr"))
