"""Pixel gradients through plt_bdpt: the port's `trace_bdpt` (both walks,
every (s, t) connection with its MIS weight, the t = 1 light splats)
splatted and developed as the JAX package's TestBdptGradients does
(test_gradients_breadth.py:199), under torch's reverse mode
(`.backward()`) and forward mode (`torch.autograd.forward_ad`,
`torch.func.jvp`), held against the JAX package's `trace_bdpt` under
`jax.jvp` on the same bridged tables and Sobol draws, and against the
port's own central differences.

The box of tests/test_render.py at 8×8, 1 spp, depth 4 (the JAX test's
setup), with free-space diffraction off and on (the Fraunhofer walks).
The JAX side runs its ray queries through the plain references of its
Pallas kernels (`jax_kernel_references`), which K1/K2 port; the back-wall
translation needs its default brute trace (exact-AD t; see
test_torch_gradients.py).

`jax.grad` through the JAX `trace_bdpt` returns NaN for every spectra
row: a masked-off lane's term is NaN (a frame built on a zero normal, in
an unused vertex slot or a missed hit), so its zero cotangent turns to
NaN. The port's frames of a zero normal are zero (the repair this file
tests), so its reverse mode is finite; it is held against the JAX
derivative along each row, taken by the JAX jvp (one compile serves the
maps and the rows).

Bars, each stated at its assert: FSD off, per lane at rtol 1e-4 (PERF.md
§2's bdpt bar); FSD on, the image and maps at the bdpt image bars (means
within 2%, Pearson ≥ 0.999) with ≥ 84% of pixels within 1e-2·max(|ref|,
mean|ref|) (at 8×8 × 1 spp a pixel is one lane, and the JAX package's
own jitted and eager walks agree on 84.4% here); per-row reverse-mode
gradients at rtol 1e-3 (FSD off) and 6% (FSD on: the JAX package's own
lowerings differ by up to 5.4%); AD against central differences at the
JAX tests' tolerances. `PYTHONPATH=. python
tests/test_torch_gradients_bdpt.py` prints the JAX package's spread
behind these bars (~6 min).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from test_render import make_box_scene
from test_torch_gradients import (BACK_WALL, _flatten, _translate_j,
                                  _translate_t, classical_share,
                                  emitter_rows, fd_close,
                                  jax_kernel_references, jax_scaled, lanes,
                                  port_jvp, port_scaled, wave_bars)
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.integrator.plt_bdpt import trace_bdpt as jtrace_bdpt
from wave_tracer_tpu.sampling import rng as jrng
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.sensor import film as jfilm
from wave_tracer_tpu_torch.accel import ray_kernels
from wave_tracer_tpu_torch.integrator.path import STAT_FSD
from wave_tracer_tpu_torch.integrator.plt_bdpt import trace_bdpt
from wave_tracer_tpu_torch.math import frame as frame_mod
from wave_tracer_tpu_torch.scene.bridge import scene_data_from_numpy
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene
from wave_tracer_tpu_torch.sensor import film as tfilm

cap_torch_threads()

RES, DEPTH, KEY = 8, 4, 13         # test_gradients_breadth.py's setup
FSD = [False, True]


# ≥ 84% of pixels within 1e-2·max(|ref|, mean|ref|) with FSD on: at 8×8 ×
# 1 spp a pixel is one lane, and the JAX package's own jitted and eager
# walks agree on 84.4% of the pixels here (PERF.md §2's 90% is taken at
# 16×16 × 4 spp; `python tests/test_torch_gradients_bdpt.py` prints the
# spread)
FSD_PIXEL_SHARE = 0.84
# with FSD on, the derivative of the image mean along a spectra row: the
# JAX package's eager and jitted walks differ by 0.7%, 3.0%, 5.4%, 0% and
# 0.8% on the five rows (the same script)
FSD_ROW_RTOL = 0.06


def _bdpt_bars(a, ref):
    """The bdpt image bars with FSD on: each channel's mean within 2%,
    Pearson ≥ 0.999, ≥ FSD_PIXEL_SHARE of the pixels within
    1e-2·max(|ref|, mean|ref|)."""
    np.testing.assert_allclose(a.mean((0, 1)), ref.mean((0, 1)), rtol=0.02)
    pearson, share = wave_bars(a, ref)
    assert pearson >= 0.999 and share >= FSD_PIXEL_SHARE, (pearson, share)


def _classical_close(a, ref):
    """Per pixel: within 1e-3·max(|ref|, mean|ref|) on every channel (the
    classical image bar of PERF.md §2)."""
    scale = np.maximum(np.abs(ref), np.abs(ref).mean())
    return (np.abs(a - ref) <= 1e-3 * scale).all(-1)


@pytest.fixture(scope="module")
def box():
    scene = make_box_scene(res=RES, spp=1)
    jb = jbuild(scene)
    return dict(scene=scene, jb=jb,
                sensor=tmake_box_scene(res=RES, spp=1).sensors[0],
                data=scene_data_from_numpy(_flatten(jb.data), "cpu"))


def _jax_image(data, sensor, fsd):
    """(image, camera values (N, C), light-splat values (N·T, C), their
    ok flags as f32) of one batch of the JAX trace_bdpt."""
    pxy, jit, sids = (jnp.asarray(x) for x in lanes(RES))
    pos, values, ok, (lp, lv, lo) = jtrace_bdpt(
        data, pxy, jit, jrng.make_base_key(KEY), sids, sensor=sensor,
        max_depth=DEPTH, eps=1e-4, fsd=fsd)
    film = jfilm.make_film(RES, RES, values.shape[-1], sensor.rfilter_sigma)
    film = jfilm.splat(film, pos, values, ok)
    film = jfilm.splat_direct(film, lp, lv, lo)
    return jfilm.develop(film, 1.0), values, lv, lo.astype(jnp.float32)


@pytest.fixture(scope="module")
def jax_results(box):
    """Every JAX number the tests read: per FSD setting one jitted jvp over
    row scales (image, values, the maps w.r.t. every row and the
    emitters' rows, the derivative of the image mean along each row), and
    the back-wall translation's jvp through the default trace."""
    jb, sensor = box["jb"], box["scene"].sensors[0]
    S = jb.data.tables.spectra.vals.shape[0]
    ones = jnp.ones((S,))
    out = {}
    with jax_kernel_references():
        for fsd in FSD:
            jvp_rows = jax.jit(lambda rs, drs, fsd=fsd: jax.jvp(
                lambda r: _jax_image(jax_scaled(jb.data, r), sensor, fsd),
                (rs,), (drs,)))
            p, t = jvp_rows(ones, jnp.asarray(emitter_rows(jb.data)))
            r = {"image": p[0], "values": p[1], "lt_values": p[2],
                 "lt_ok": p[3] > 0, "map_emit": t[0]}
            r["row_grad"] = [jnp.mean(jvp_rows(ones, jnp.zeros((S,)).at[
                i].set(1.0))[1][0]) for i in range(S)]
            out[fsd] = {k: np.asarray(v) for k, v in r.items()}
    wall = jax.jit(lambda th: jax.jvp(lambda x: _jax_image(_translate_j(
        jb.data, BACK_WALL, x * jnp.asarray([0.0, 0.0, 1.0])), sensor,
        False)[0], (th,), (1.0,)))
    out["wall_image"], out["wall_map"] = (np.asarray(x) for x in wall(0.0))
    return out


def _port(box, data, fsd, with_stats=False, sl=slice(None)):
    """(image, camera values, light-splat values, their ok flags[,
    counters]) of one batch of the port's trace_bdpt over the lanes sl."""
    pxy, jit, sids = (torch.from_numpy(x)[sl] for x in lanes(RES))
    sensor = box["sensor"]
    out = trace_bdpt(data, pxy, jit, KEY, sids, sensor=sensor,
                     max_depth=DEPTH, eps=1e-4, fsd=fsd,
                     with_stats=with_stats)
    pos, values, ok, (lp, lv, lo) = out[:4]
    film = tfilm.make_film(RES, RES, values.shape[-1], sensor.rfilter_sigma)
    tfilm.splat(film, pos, values, ok)
    tfilm.splat_direct(film, lp, lv, lo)
    return (tfilm.develop(film, 1.0), values, lv, lo) + tuple(out[4:])


def _image(box, data, fsd, **kw):
    return _port(box, data, fsd, **kw)[0]


def _emitter_mask(box):
    return torch.from_numpy(emitter_rows(box["jb"].data))


def _emitter_scaled(box, theta):
    return port_scaled(box["data"], 1.0 + _emitter_mask(box) * (theta - 1.0))


# ---------------------------------------------------------------------------
# values and the emitter-scale map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsd", FSD)
def test_values_match_jax(box, jax_results, fsd):
    """FSD off: every lane's camera value and every light splat at rtol
    1e-4 (floor 1e-6 of the largest), the splat flags equal. FSD on: the
    image at the bdpt image bars, and the walks diffract."""
    img, values, lv, lo, stats = (x.numpy() for x in _port(
        box, box["data"], fsd, with_stats=True))
    ref = jax_results[fsd]
    assert np.isfinite(img).all() and img.mean() > 0
    if fsd:
        assert stats[STAT_FSD] > 0
        _bdpt_bars(img, ref["image"])
        return
    np.testing.assert_array_equal(lo, ref["lt_ok"])
    for a, b in ((values, ref["values"]), (lv[lo], ref["lt_values"][lo])):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * np.abs(b).max())
    np.testing.assert_allclose(img, ref["image"], rtol=1e-4,
                               atol=1e-6 * np.abs(ref["image"]).max())


@pytest.mark.parametrize("fsd", FSD)
def test_emitter_scale_map(box, jax_results, fsd):
    """Forward mode: the pixel map w.r.t. θ scaling the emitters' rows,
    against JAX's jvp map (FSD off: rtol 1e-4; on: the bdpt image bars),
    against the port's central differences (rtol 0.12, atol 0.02·max|fd|
    on every pixel, test_gradients_breadth.py:243), and against the image
    itself: bdpt has no Russian roulette and its MIS weights are
    radiance-free, so the image is linear in θ and the map at θ = 1 is
    the image (rtol 1e-5, atol 1e-6·max)."""
    img, g = port_jvp(lambda th: _image(box, _emitter_scaled(box, th), fsd),
                      torch.tensor(1.0), torch.tensor(1.0))
    g, img = g.numpy(), img.numpy()
    ref = jax_results[fsd]["map_emit"]
    assert np.isfinite(g).all() and (g != 0).any()
    if fsd:
        _bdpt_bars(g, ref)
    else:
        np.testing.assert_allclose(g, ref, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref).max())
    h = 0.05
    fd = ((_image(box, _emitter_scaled(box, 1.0 + h), fsd)
           - _image(box, _emitter_scaled(box, 1.0 - h), fsd))
          / (2 * h)).numpy()
    np.testing.assert_allclose(g, fd, rtol=0.12, atol=0.02 * np.abs(fd).max())
    np.testing.assert_allclose(g, img, rtol=1e-5,
                               atol=1e-6 * np.abs(img).max())


# ---------------------------------------------------------------------------
# reverse mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsd", FSD)
def test_spectra_row_gradients_match_jax(box, jax_results, fsd):
    """Reverse mode: d mean(image) / d(row scale) for every spectra row
    (the emitters' and the reflectances'), against the JAX derivative
    along each row: rtol 1e-3 with FSD off; with FSD on rtol
    FSD_ROW_RTOL (the Fraunhofer walks' classification and RIS picks sit
    on float thresholds: the JAX package's own eager and jitted walks
    differ by up to 5.4% on a reflectance row here)."""
    S = box["data"].tables.spectra.vals.shape[0]
    rs = torch.ones(S, requires_grad=True)
    _image(box, port_scaled(box["data"], rs), fsd).mean().backward()
    g, ref = rs.grad.numpy(), jax_results[fsd]["row_grad"]
    assert np.isfinite(g).all() and (np.abs(g) > 0).sum() >= 2
    np.testing.assert_allclose(g, ref, rtol=FSD_ROW_RTOL if fsd else 1e-3,
                               atol=1e-6 * np.abs(ref).max())


def test_zero_normal_frame_is_finite():
    """The repair reverse mode needs: build_orthogonal_frame of a zero
    normal is the zero frame (it was NaN, as the JAX twin's is, and a
    masked-off lane's NaN term turned its zero cotangent into NaN); unit
    normals keep their frames bit for bit."""
    r = np.random.default_rng(3)
    n = torch.tensor(r.normal(size=(256, 3)), dtype=torch.float32)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n[::7] = 0.0
    f = frame_mod.build_orthogonal_frame(n)
    z = (n == 0).all(-1)
    for v in (f.t, f.b):
        assert torch.isfinite(v).all() and not v[z].any()
    nx, ny, nz = n[~z].unbind(-1)
    cond = nx.abs() > ny.abs()
    sx = 1.0 / torch.sqrt(torch.where(cond, nx * nx + nz * nz,
                                      ny * ny + nz * nz))
    b = torch.where(cond[:, None],
                    torch.stack([sx * nz, 0 * sx, -sx * nx], -1),
                    torch.stack([0 * sx, sx * nz, -sx * ny], -1))
    assert torch.equal(f.b[~z], b)
    assert torch.equal(f.t[~z], torch.linalg.cross(b, n[~z], dim=-1))


def lane_sum(values, lt_values, lt_ok):
    """Σ of every lane's camera value and live light splat: a sum over
    lanes (the developed image is not: its filter weights normalize
    across neighbouring lanes)."""
    return values.sum() + torch.where(lt_ok[:, None], lt_values, 0.0).sum()


def test_reverse_mode_in_lane_batches(box):
    """Gradients of the lane sum accumulated over lane batches (the card's
    full-width reverse mode) equal one batch of every lane, FSD on."""
    data = box["data"]
    S = data.tables.spectra.vals.shape[0]
    rs = torch.ones(S, requires_grad=True)
    lane_sum(*_port(box, port_scaled(data, rs), True)[1:]).backward()
    whole = rs.grad.clone()
    assert torch.isfinite(whole).all() and (whole != 0).all()
    rs.grad = None
    for b in range(0, RES * RES, 24):
        lane_sum(*_port(box, port_scaled(data, rs), True,
                        sl=slice(b, b + 24))[1:]).backward()
    torch.testing.assert_close(rs.grad, whole, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("fsd", FSD)
def test_forward_and_reverse_modes_agree(box, monkeypatch, fsd):
    """For each spectra row, Σ over pixels of the forward_ad map equals
    that row's reverse-mode gradient of the image sum; torch.func.jvp gives
    the forward_ad map. K1/K2's plain versions see primal tensors only."""
    seen = []
    for name in ("_closest_ref", "_anyhit_ref"):
        inner = getattr(ray_kernels, name)

        def spy(*xs, inner=inner, **kw):
            seen.extend(x for x in xs if isinstance(x, torch.Tensor))
            return inner(*xs, **kw)
        monkeypatch.setattr(ray_kernels, name, spy)
    data = box["data"]
    S = data.tables.spectra.vals.shape[0]

    def f(r):
        return _image(box, port_scaled(data, r), fsd)

    rs = torch.ones(S, requires_grad=True)
    f(rs).sum().backward()
    for row in range(S):
        drs = torch.zeros(S)
        drs[row] = 1.0
        _, g = port_jvp(f, torch.ones(S), drs)
        np.testing.assert_allclose(float(g.sum()), float(rs.grad[row]),
                                   rtol=1e-4, atol=1e-12)
    _, g_fwd = port_jvp(f, torch.ones(S), torch.ones(S))
    _, g_func = torch.func.jvp(f, (torch.ones(S),), (torch.ones(S),))
    torch.testing.assert_close(g_func, g_fwd, rtol=1e-5, atol=1e-14)
    assert seen and not any(
        x.requires_grad or fwAD.unpack_dual(x).tangent is not None
        or torch._C._functorch.is_functorch_wrapped_tensor(x) for x in seen)


# ---------------------------------------------------------------------------
# geometry: the back wall translated along its normal
# ---------------------------------------------------------------------------

def test_wall_translation(box, jax_results):
    """Forward mode through the hit distance of both walks and every
    connection: the back wall moved along +z, FSD off, against the JAX jvp
    through its exact-AD brute trace. That trace and the JAX kernel
    references (which the port equals per lane) already disagree at the
    classical image bar on 14% of these pixels (ties on wall diagonals
    and shadow-ray grazes; `python tests/test_torch_gradients_bdpt.py`):
    the port's image agrees with the brute one on at least the share the
    JAX kernel references' does, and on those pixels the maps agree at
    the classical bar on ≥ 98%. The map against the port's central
    differences at the JAX back-wall bar (> 97% of pixels at rtol 0.15,
    atol 0.03·max|fd|), at h = 1e-3: at the classical test's 5e-3 a few
    light splats change their nearest texel inside [−h, h] (95.8% of
    pixels match), a step the derivative does not see."""
    data = box["data"]
    zhat = torch.tensor([0.0, 0.0, 1.0])

    def f(th):
        return _image(box, _translate_t(data, BACK_WALL, th * zhat), False)

    p, g = port_jvp(f, torch.tensor(0.0), torch.tensor(1.0))
    p, g = p.numpy(), g.numpy()
    assert np.isfinite(g).all() and (g != 0).any()
    same = _classical_close(p, jax_results["wall_image"])
    assert same.mean() >= _classical_close(
        jax_results[False]["image"], jax_results["wall_image"]).mean()
    assert _classical_close(g, jax_results["wall_map"])[same].mean() >= 0.98
    h = 1e-3
    fd = ((f(torch.tensor(h)) - f(torch.tensor(-h))) / (2 * h)).numpy()
    assert fd_close(g, fd, 0.15, 0.03) > 0.97
    # reverse mode gives the same derivative of the image sum
    theta = torch.tensor(0.0, requires_grad=True)
    f(theta).sum().backward()
    np.testing.assert_allclose(float(theta.grad), g.sum(), rtol=1e-4)


def jax_spread():
    """The JAX package's own spread behind the FSD-on and wall bars: its
    jitted and eager (jax.disable_jit) walks with FSD on, and its kernel
    references against its default brute trace with FSD off, at the
    classical and bdpt image bars; with FSD on, the derivative of the
    image mean along each spectra row, jitted against eager."""
    scene = make_box_scene(res=RES, spp=1)
    jb, sensor = jbuild(scene), scene.sensors[0]
    S = jb.data.tables.spectra.vals.shape[0]
    ones = jnp.ones((S,))

    def rows(fsd):
        def run():
            return np.array([float(jnp.mean(jax.jvp(
                lambda r: _jax_image(jax_scaled(jb.data, r), sensor, fsd)[0],
                (ones,), (jnp.zeros((S,)).at[i].set(1.0),))[1]))
                for i in range(S)])
        return run

    out = {}
    with jax_kernel_references():
        for fsd in FSD:
            out["jit", fsd] = np.asarray(jax.jit(
                lambda d, fsd=fsd: _jax_image(d, sensor, fsd)[0])(jb.data))
        with jax.disable_jit():
            out["eager", True] = np.asarray(
                _jax_image(jb.data, sensor, True)[0])
            out["eager rows"] = rows(True)()
        out["jit rows"] = np.array(jax.jit(lambda: jnp.stack([
            jnp.mean(jax.jvp(lambda r: _jax_image(jax_scaled(
                jb.data, r), sensor, True)[0], (ones,), (jnp.zeros((S,)).at[
                    i].set(1.0),))[1]) for i in range(S)]))())
    brute = np.asarray(jax.jit(
        lambda d: _jax_image(d, sensor, False)[0])(jb.data))
    jit_on = out["jit", True]
    print("FSD on, eager against jitted: Pearson, share within 1e-2:",
          wave_bars(out["eager", True], jit_on), "means ratio",
          out["eager", True].mean((0, 1)) / jit_on.mean((0, 1)))
    print("FSD on, d mean / d row, eager / jitted:",
          out["eager rows"] / out["jit rows"])
    print("FSD off, brute against kernel references, classical share:",
          classical_share(brute, out["jit", False]))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax_spread()
