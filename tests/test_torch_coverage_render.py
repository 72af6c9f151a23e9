"""Port parity for the coverage slice as a whole: wave_tracer_tpu_torch's
forward transport (`trace_forward`, and `render_scene` on a virtual-plane
sensor) against the JAX package on the CPU, on the GHz street-canyon
scene of tests/test_coverage.py (`make_coverage_scene`, 16×16 elements,
depth 4), its JAX bake bridged into the port so that both read the same
tables; 256 lanes of one batch, as tests/test_forward_polarimetric.py
traces them.

Bars (all stated again at each test):
  * FSD off: every output of every lane, polarimetric, at rtol 1e-4.
  * FSD on (the UTD carry here, the Fraunhofer mode in
    test_torch_coverage_modules.py): the first-crossing records of at
    least 94% of the lanes, and at least 94% of the (lane, depth) FSD-NEE
    records, agree at rtol 1e-4. The FSD sampling and the coherent sum
    sit on float thresholds that two lowerings of the same JAX code
    already resolve differently: the JAX package bounds its own lane
    flips between lowerings at 6% (tests/test_gradients_wave.py:206);
    its jitted and eager traces of these 256 lanes agree on 100% of the
    crossing records and 99.80% of the FSD-NEE records, the port and the
    eager trace on 100% and 100% (`python
    tests/test_torch_coverage_render.py` prints them).
  * One render of each package at film level (bars at the test).
  * The shadowing property of tests/test_coverage.py on a port render.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_coverage import make_coverage_scene as jmake_coverage
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.integrator.plt_path_forward import \
    trace_forward as jtrace_forward
from wave_tracer_tpu.render import render_scene as jrender
from wave_tracer_tpu.sampling import rng as jrng
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu_torch.integrator.plt_path_forward import trace_forward
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.sampling import rng
from wave_tracer_tpu_torch.scene.bridge import SPECTRAL_KEYS
from wave_tracer_tpu_torch.scene.build import BuiltScene, build_scene
from wave_tracer_tpu_torch.scene.procedural import make_coverage_scene
from wave_tracer_tpu_torch.sensor.perspective import PerspectiveSensor

cap_torch_threads()

RES, N, DEPTH, SEED = 16, 256, 4, 7
RTOL = 1e-4
FLIP_BOUND = 0.06


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


def bridged_scenes(res=RES, polarimetric=False, integrator="plt_path"):
    """(JAX scene, its JAX bake, the port's scene with that bake bridged
    in)."""
    js, ts = jmake_coverage(res), make_coverage_scene(res)
    for s in (js, ts):
        s.sensors[0].polarimetric = polarimetric
        s.integrator.type = integrator
    jb = jbuild(js)
    arrays = _flatten(jb.data)
    spectral = {k: arrays[f"spectral.{k}"] for k in SPECTRAL_KEYS}
    return js, jb, BuiltScene.upload(ts, arrays, [spectral], "cpu")


def trace_pair(*, fsd=True, fsd_mode="utd", polarimetric=False, n=N):
    """One batch of `n` lanes (sample id 0) traced by both packages:
    (JAX outputs, port outputs as numpy), each (pos, values, ok, sig,
    nee_pos, nee_val, nee_ok)."""
    js, jb, tb = bridged_scenes(polarimetric=polarimetric)
    jdata = jb.data.replace(spectral=jb.spectral_per_sensor[0])
    kw = dict(max_depth=DEPTH, eps=1e-4, fsd=fsd, fsd_mode=fsd_mode)
    jo = jtrace_forward(jdata, jnp.arange(n, dtype=jnp.int32),
                        jrng.make_base_key(SEED), jnp.zeros((n,), jnp.int32),
                        sensor=js.sensors[0], edge_table=jdata.edges, **kw)
    to = trace_forward(tb.data, torch.arange(n, dtype=torch.int32),
                       rng.make_base_key(SEED),
                       torch.zeros((n,), dtype=torch.int32),
                       sensor=tb.scene.sensors[0], edge_table=tb.data.edges,
                       **kw)
    flat = lambda o: [np.asarray(x) for x in o[:4] + tuple(o[4])]  # noqa
    return flat(jo), [x.numpy() for x in to[:4] + tuple(to[4])]


def _close(a, b):
    """Per-row agreement at RTOL, with an absolute floor of 1e-6 of the
    largest magnitude (rows of the first axis)."""
    a2, b2 = a.reshape(len(a), -1), b.reshape(len(b), -1)
    tol = RTOL * np.abs(b2) + 1e-6 * max(np.abs(b2).max(), 1e-30)
    return (np.abs(a2 - b2) <= tol).all(1)


def crossing_agreement(j, t):
    """Share of lanes whose first-crossing record agrees: the valid flag
    equal and, where valid, position, value and σ at RTOL."""
    same = j[2] == t[2]
    for i in (0, 1, 3):
        same &= ~j[2] | _close(t[i], j[i])
    return same.mean()


def nee_agreement(j, t):
    """Share of (lane, depth) FSD-NEE records that agree: the valid flag
    equal and, where valid, the point and the value at RTOL."""
    ok_j, ok_t = j[6], t[6]
    same = (ok_j == ok_t) & (~ok_j | (_close(t[4], j[4])
                                      & _close(t[5], j[5])))
    return same.mean()


def test_trace_forward_fsd_off_per_lane_polarimetric():
    """FSD off, polarimetric (I, Q, U, V per channel): every output of
    every lane agrees at rtol 1e-4 (floor 1e-6 of the largest); the flags
    are equal. Oblique SPM reflections polarize some recorded crossing,
    and the I channel equals the port's scalar trace."""
    j, t = trace_pair(fsd=False, polarimetric=True)
    assert t[1].shape == (N, 4) and t[5].shape == (N * DEPTH, 4)
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_array_equal(t[6], j[6])
    assert j[2].sum() > N // 4 and not j[6].any()
    for i in (0, 1, 3):
        assert _close(t[i], j[i]).all(), i
    v = t[1][t[2]]
    dop = np.abs(v[:, 1:3]).max(1) / np.maximum(v[:, 0], 1e-20)
    assert (dop > 1e-3).any() and (dop < 1.0 + 1e-3).all()
    _, tb_ = bridged_scenes()[1:]
    scalar = trace_forward(
        tb_.data, torch.arange(N, dtype=torch.int32),
        rng.make_base_key(SEED), torch.zeros((N,), dtype=torch.int32),
        sensor=tb_.scene.sensors[0], edge_table=tb_.data.edges,
        max_depth=DEPTH, eps=1e-4, fsd=False)
    np.testing.assert_allclose(scalar[1][:, 0].numpy(), t[1][:, 0],
                               rtol=1e-6)


def test_trace_forward_utd_per_lane():
    """FSD on with the deferred coherent UTD carry (the product's
    default): at least 94% of the lanes' crossing records and of the
    (lane, depth) FSD-NEE records agree at rtol 1e-4 (the JAX package's
    6% bound on lane flips between its own lowerings); FSD-NEE
    connections are made on both sides."""
    j, t = trace_pair(fsd=True, fsd_mode="utd")
    assert j[6].sum() > 0 and t[6].sum() > 0
    assert crossing_agreement(j, t) >= 1 - FLIP_BOUND
    assert nee_agreement(j, t) >= 1 - FLIP_BOUND
    assert np.isfinite(t[5]).all() and (t[5][t[6], 0] >= 0).all()
    p = t[4][t[6]]
    assert ((p >= 0) & (p <= RES)).all()


def film_stats(img, ref):
    """(median ratio of the elements lit in both maps, Pearson correlation
    of the dB maps, share of elements within 0.1 dB) of a coverage map
    against a reference; the dB map is what the scene's tonemap shows.
    The map sums FSD-NEE point splats whose weights span decades, so one
    flipped record moves an element by orders of magnitude: the mean and
    the linear correlation follow single elements, these three do not."""
    a, b = img[..., 0], ref[..., 0]
    la = 10.0 * np.log10(np.maximum(a, 1e-30))
    lb = 10.0 * np.log10(np.maximum(b, 1e-30))
    both = (a > 0) & (b > 0)
    return (float(np.median(a[both] / b[both])),
            np.corrcoef(la.ravel(), lb.ravel())[0, 1],
            (np.abs(la - lb) <= 0.1).mean())


# film-level bars, against the JAX package's own spread between its
# jitted and eager renders of this scene (`python
# tests/test_torch_coverage_render.py` prints it: median ratio 1.0, dB
# Pearson 0.976, 95.3% of the elements within 0.1 dB; their means 4.0%
# apart)
FILM_MEDIAN_RTOL, FILM_DB_CORR, FILM_DB_SHARE = 1e-3, 0.95, 0.90


def check_film(img, ref):
    median, corr, share = film_stats(img, ref)
    assert abs(median - 1.0) <= FILM_MEDIAN_RTOL, median
    assert corr >= FILM_DB_CORR, corr
    assert share >= FILM_DB_SHARE, share


def test_render_matches_jax_at_film_level():
    """render_scene of each package on the bridged scene, 16×16 elements
    × 4 samples in one batch of 1,024 lanes: mode, shape and counts
    equal; the median ratio of the elements lit in both within 1e-3 of 1,
    the dB maps' Pearson correlation >= 0.95 and >= 90% of the elements
    within 0.1 dB (see film_stats)."""
    js, jb, tb = bridged_scenes()
    jimg, jst = jrender(jb, spp=4, batch_lanes=1024)
    img, st = render_scene(tb, spp=4, device="cpu", pool_lanes=1024)
    assert st["mode"] == jst["mode"] == "forward-wave"
    assert img.shape == jimg.shape == (RES, RES, 1)
    assert st["paths"] == jst["paths"] == 4 * RES * RES
    assert st["spp_done"] == jst["spp_done"] == 4
    assert np.isfinite(img).all() and (img > 0).mean() > 0.5
    check_film(img, jimg)


def test_batches_and_own_bake():
    """A partial last batch (384 + 384 + 256 lanes) renders every path
    once and counts its batches. The port's own bake keeps triangles and
    edges in soup order, so its apertures sum their edges in another
    order and a few records flip: its map meets the film-level bars
    against the bridged bake's. plt_bdpt takes the Fraunhofer mode."""
    _, _, tb = bridged_scenes()
    own = build_scene(make_coverage_scene(RES), device="cpu")
    img, st = render_scene(tb, spp=4, device="cpu", pool_lanes=384)
    assert st["batches"] == 3 and st["paths"] == 1024
    img2, _ = render_scene(own, spp=4, device="cpu", pool_lanes=384)
    check_film(img2, img)
    own.scene.integrator.type = "plt_bdpt"
    img3, st3 = render_scene(own, spp=4, device="cpu", pool_lanes=384)
    assert st3["mode"] == "forward-wave" and np.isfinite(img3).all()
    assert (img3 > 0).mean() > 0.5


def test_coverage_map_shadowing():
    """tests/test_coverage.py's bar on a port render at 32×32 elements ×
    8 samples: finite, more than 20% of the elements lit, and the
    building shadows the far third of the plane (mean signal below 0.75
    of the near third's, or far less of it lit)."""
    built = build_scene(make_coverage_scene(32), device="cpu")
    img, st = render_scene(built, device="cpu")
    assert st["mode"] == "forward-wave"
    cov = img[..., 0]
    assert np.isfinite(cov).all()
    lit = cov > 0
    assert lit.mean() > 0.2, "coverage map mostly empty"
    H = cov.shape[0]
    near, far = cov[: H // 3], cov[2 * H // 3:]
    m_near = near[near > 0].mean() if (near > 0).any() else 0
    m_far = far[far > 0].mean() if (far > 0).any() else m_near
    assert (m_far < 0.75 * m_near) or (far > 0).mean() \
        < 0.6 * (near > 0).mean(), f"no shadowing: near {m_near} far {m_far}"


def test_unported_and_no_fallback():
    """A perspective sensor on an SPM scene renders by backward transport
    (the surface_spm lobe draws its lobe pair there too); without a card,
    rendering on "cuda" raises rather than running on the CPU."""
    built = build_scene(make_coverage_scene(8), device="cpu")
    plane = built.scene.sensors[0]
    built.scene.sensors = [PerspectiveSensor(width=8, height=8)]
    try:
        img, st = render_scene(built, spp=1, device="cpu")
        assert img.shape == (8, 8, 3) and np.isfinite(img).all()
        assert st["mode"] in ("wave-compact", "ray-compact")
    finally:
        built.scene.sensors = [plane]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            render_scene(built, spp=1)


if __name__ == "__main__":
    # the spread behind FLIP_BOUND and FILM_*: the JAX package's jitted
    # and eager traces and renders of the bridged scene, and the port
    # against both
    import jax

    def jax_trace(eager):
        js_, jb_, _ = bridged_scenes()
        jdata = jb_.data.replace(spectral=jb_.spectral_per_sensor[0])
        run = lambda: jtrace_forward(  # noqa: E731
            jdata, jnp.arange(N, dtype=jnp.int32), jrng.make_base_key(SEED),
            jnp.zeros((N,), jnp.int32), sensor=js_.sensors[0],
            edge_table=jdata.edges, max_depth=DEPTH, eps=1e-4)
        if eager:
            with jax.disable_jit():
                out = run()
        else:
            out = run()
        return [np.asarray(x) for x in out[:4] + tuple(out[4])]

    jit_t, port_t = trace_pair()
    eager_t = jax_trace(True)
    for tag, x, y in (("JAX jit vs eager", jit_t, eager_t),
                      ("port vs JAX jit", port_t, jit_t),
                      ("port vs JAX eager", port_t, eager_t)):
        print(f"{tag}, {N} lanes: crossing records agree "
              f"{crossing_agreement(x, y):.2%}, FSD-NEE records "
              f"{nee_agreement(x, y):.2%}")
    _, jb_, tb_ = bridged_scenes()
    jit_img, _ = jrender(jb_, spp=4, batch_lanes=1024)
    with jax.disable_jit():
        eager_img, _ = jrender(jb_, spp=4, batch_lanes=1024)
    port_img, _ = render_scene(tb_, spp=4, device="cpu", pool_lanes=1024)
    for tag, x, y in (("JAX jit vs eager", jit_img, eager_img),
                      ("port vs JAX jit", port_img, jit_img),
                      ("port vs JAX eager", port_img, eager_img)):
        m, c, f = film_stats(x, y)
        print(f"{tag}, 16x16 x 4: median ratio {m:.6f}, dB Pearson "
              f"{c:.4f}, {f:.2%} of elements within 0.1 dB, means "
              f"{x.mean() / y.mean() - 1:+.2%} apart")
