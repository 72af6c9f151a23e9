"""Pixel gradients through forward transport: the port's `trace_forward`
splatted by `film.splat_direct_gaussian` (the first crossings) and
`film.splat_direct` (the FSD-NEE point splats), under torch's reverse and
forward modes, held against the JAX package's `trace_forward` under
`jax.jvp` on the same bridged tables and Sobol draws, and against the
port's own central differences.

UTD (the plt_path deferred coherent carry): the GHz street canyon of
tests/test_coverage.py (`make_coverage_scene`) at 16×16 elements, 512
lanes, depth 4, w.r.t. the emitter's spectrum row and the ITU concrete
row (its n and κ scaled apart). The JAX side runs its ray queries through
the plain references of its Pallas kernels (`jax_kernel_references`).

Fraunhofer (the plt_bdpt t = 0 strategy): the double slit of
`scene/procedural.py::slit_screen_xml`, loaded by both packages' XML
loaders, at 32×32 elements, 512 lanes, depth 4, w.r.t. the aperture
geometry (TestApertureGeometryGradients, test_gradients_wave.py:330,
351): the screen translated along x, and the central strip widened. The
JAX side moves its tables with that class's own helpers and traces with
its default brute trace (exact-AD t: the kernel references read tables
baked at upload); the port moves its tables with a torch twin, through
`dataclasses.replace` (GeoArrays and EdgeTable derive their kernel and
packed tables anew). The integer picks (edge-set membership, top-K, the
RIS winner and proposals) carry no derivative, as in JAX.

`jax.grad` through the JAX `trace_forward` returns NaN for the concrete
row, with FSD on and off (a masked-off lane's NaN term, e.g. a frame of a
zero direction, turns its zero cotangent into NaN); the port's reverse
mode is finite (test_torch_gradients_bdpt.py::
test_zero_normal_frame_is_finite) and is held against the JAX derivative
along each row, taken by the JAX jvp.

Bars, each stated at its assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from test_coverage import make_coverage_scene as jmake_coverage
from test_gradients_wave import (_edge_shape_mask, _move_geometry,
                                 _tri_shape_mask)
from test_torch_gradients import (_flatten, emitter_rows, fd_close,
                                  jax_kernel_references, port_jvp)
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.integrator.plt_path_forward import \
    trace_forward as jtrace_forward
from wave_tracer_tpu.sampling import rng as jrng
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.scene import xml as jxml
from wave_tracer_tpu.sensor import film as jfilm
from wave_tracer_tpu_torch.integrator.plt_path_forward import trace_forward
from wave_tracer_tpu_torch.scene import xml as txml
from wave_tracer_tpu_torch.scene.bridge import SPECTRAL_KEYS
from wave_tracer_tpu_torch.scene.build import BuiltScene
from wave_tracer_tpu_torch.scene.procedural import (SLIT_SCREEN,
                                                    make_coverage_scene,
                                                    slit_screen_xml)
from wave_tracer_tpu_torch.sensor import film as tfilm

cap_torch_threads()

N, DEPTH = 512, 4
UTD_RES, UTD_KEY, UTD_EPS = 16, 5, 1e-4
SLIT_RES, SLIT_KEY, SLIT_EPS = 32, 11, 1e-5
CENTRAL, SCREEN = 1, (0, 1, 2)     # shape ids in slit_screen_xml
# the JAX package's share of FSD-NEE splats that flip between two of its
# own lowerings is 1.7-4% (test_gradients_wave.py:205-206): a pixel map
# with those splats is held on at least 94% of its pixels
NEE_SHARE = 0.94


def _bridge(jscene, tscene):
    """(JAX data with the sensor's spectral sampler, port BuiltScene over
    the same JAX bake)."""
    jb = jbuild(jscene)
    arrays = _flatten(jb.data)
    spectral = {k: arrays[f"spectral.{k}"] for k in SPECTRAL_KEYS}
    return (jb.data.replace(spectral=jb.spectral_per_sensor[0]),
            BuiltScene.upload(tscene, arrays, [spectral], "cpu"))


def _jax_films(data, sensor, key, eps, **kw):
    """(film with the FSD-NEE splats, film of the crossings alone) of one
    JAX forward batch."""
    pos, values, ok, sig, (npos, nval, nok) = jtrace_forward(
        data, jnp.arange(N, dtype=jnp.int32), jrng.make_base_key(key),
        jnp.zeros((N,), jnp.int32), sensor=sensor, edge_table=data.edges,
        max_depth=DEPTH, eps=eps, **kw)
    film = jfilm.make_film(sensor.width, sensor.height, values.shape[-1],
                           sensor.rfilter_sigma)
    film = jfilm.splat_direct_gaussian(film, pos, sig, values, ok)
    crossings = jfilm.develop(film, 1.0)
    return jfilm.develop(jfilm.splat_direct(film, npos, nval, nok),
                         1.0), crossings


def _port_films(data, sensor, key, eps, debug=False, **kw):
    """The port's (film with the FSD-NEE splats, film of the crossings
    alone[, final lane state])."""
    out = trace_forward(data, torch.arange(N, dtype=torch.int32), key,
                        torch.zeros((N,), dtype=torch.int32), sensor=sensor,
                        edge_table=data.edges, max_depth=DEPTH, eps=eps,
                        debug=debug, **kw)
    pos, values, ok, sig, (npos, nval, nok) = out[:5]
    film = tfilm.make_film(sensor.width, sensor.height, values.shape[-1],
                           sensor.rfilter_sigma)
    tfilm.splat_direct_gaussian(film, pos, sig, values, ok)
    crossings = tfilm.develop(film, 1.0)
    tfilm.splat_direct(film, npos, nval, nok)
    return (tfilm.develop(film, 1.0), crossings) + tuple(out[5:])


# ---------------------------------------------------------------------------
# UTD: the coverage scene, w.r.t. the emitter and the ITU concrete rows
# ---------------------------------------------------------------------------

def _jax_params(data, p):
    """p = (spectra row scales (S), concrete n scale, concrete κ scale)."""
    S = data.tables.spectra.vals.shape[0]
    st, cs = data.tables.spectra, data.tables.cspectra
    return data.replace(tables=data.tables.replace(
        spectra=st.replace(vals=st.vals * p[:S, None]),
        cspectra=cs.replace(n=cs.n * p[S], kappa=cs.kappa * p[S + 1])))


def _port_params(data, p):
    S = data.tables.spectra.vals.shape[0]
    st, cs = data.tables.spectra, data.tables.cspectra
    return dataclasses.replace(data, tables=dataclasses.replace(
        data.tables,
        spectra=dataclasses.replace(st, vals=st.vals * p[:S, None]),
        cspectra=dataclasses.replace(cs, n=cs.n * p[S],
                                     kappa=cs.kappa * p[S + 1])))


@pytest.fixture(scope="module")
def coverage():
    js, ts = jmake_coverage(UTD_RES), make_coverage_scene(UTD_RES)
    jdata, tb = _bridge(js, ts)
    assert jdata.tables.cspectra.n.shape[0] == 1     # the concrete row
    S = jdata.tables.spectra.vals.shape[0]
    emit = np.concatenate([emitter_rows(jdata), np.zeros(2, np.float32)])
    out = dict(jsensor=js.sensors[0], sensor=tb.scene.sensors[0],
               data=tb.data, P=S + 2, emit=emit)
    ones = jnp.ones((S + 2,))
    with jax_kernel_references():
        for fsd in (False, True):
            jvp = jax.jit(lambda p, dp, fsd=fsd: jax.jvp(
                lambda x: _jax_films(_jax_params(jdata, x), js.sensors[0],
                                     UTD_KEY, UTD_EPS, fsd=fsd), (p,), (dp,)))
            (full, cross), (map_full, _) = jvp(ones, jnp.asarray(emit))
            rows = []
            for i in range(S + 2):
                _, (t_full, t_cross) = jvp(ones, jnp.zeros((S + 2,)).at[
                    i].set(1.0))
                rows.append((jnp.mean(t_full), jnp.mean(t_cross), t_full))
            out[fsd] = dict(
                image=np.asarray(full), map_emit=np.asarray(map_full),
                row_full=np.array([float(r[0]) for r in rows]),
                row_cross=np.array([float(r[1]) for r in rows]),
                map_concrete=np.asarray(rows[S][2] + rows[S + 1][2]))
    return out


def _utd(cov, p, fsd=True, **kw):
    return _port_films(_port_params(cov["data"], p), cov["sensor"],
                       UTD_KEY, UTD_EPS, fsd=fsd, **kw)


def _emitter_theta(cov, theta):
    return 1.0 + torch.from_numpy(cov["emit"]) * (theta - 1.0)


def test_utd_emitter_map(coverage):
    """Forward mode, NEE splats included: the pixel map w.r.t. the
    emitter's scale against the port's central differences at
    test_gradients_wave.py:177's bar (rtol 0.12, atol 0.02·max|fd|, every
    pixel), against JAX's jvp map at that tolerance on ≥ 94% of the
    pixels (FSD-NEE flips), and against the image (the carry's roulette
    ratio and the coherent sums are radiance-free, so the map at θ = 1 is
    the image: rtol 1e-5, atol 1e-6·max)."""
    cov = coverage
    img, g = port_jvp(lambda th: _utd(cov, _emitter_theta(cov, th))[0],
                      torch.tensor(1.0), torch.tensor(1.0))
    g, img = g.numpy(), img.numpy()
    assert np.isfinite(g).all() and (g > 0).sum() > UTD_RES
    h = 0.05
    fd = ((_utd(cov, _emitter_theta(cov, 1.0 + h))[0]
           - _utd(cov, _emitter_theta(cov, 1.0 - h))[0]) / (2 * h)).numpy()
    np.testing.assert_allclose(g, fd, rtol=0.12, atol=0.02 * np.abs(fd).max())
    assert fd_close(g, cov[True]["map_emit"], 0.12, 0.02) >= NEE_SHARE
    assert fd_close(img, cov[True]["image"], 0.12, 0.02) >= NEE_SHARE
    np.testing.assert_allclose(g, img, rtol=1e-5,
                               atol=1e-6 * np.abs(img).max())


@pytest.mark.parametrize("fsd", [False, True])
def test_utd_row_gradients_match_jax(coverage, fsd):
    """Reverse mode over the complex64 UTD chain: d mean(film) / d(scale)
    of every spectra row and of the concrete row's n and κ, against the
    JAX derivative along each. FSD off: the whole film at rtol 1e-3. FSD
    on: the crossings' film (no FSD-NEE point splats) within 2% (the wave
    mean bar: the FSD sampling sits on float thresholds)."""
    cov = coverage
    p = torch.ones(cov["P"], requires_grad=True)
    film = _utd(cov, p, fsd=fsd)[0 if not fsd else 1]
    film.mean().backward()
    g = p.grad.numpy()
    ref = cov[fsd]["row_full" if not fsd else "row_cross"]
    assert np.isfinite(g).all() and (g[-2:] != 0).all()
    np.testing.assert_allclose(g, ref, rtol=1e-3 if not fsd else 0.02,
                               atol=1e-6 * np.abs(ref).max())


def test_utd_concrete_map_with_nee(coverage):
    """Forward mode w.r.t. the concrete row (n and κ together), the FSD-NEE
    point splats included: against JAX's jvp map at rtol 0.12, atol
    0.02·max on ≥ 94% of the pixels (the JAX package's own lowerings flip
    1.7-4% of those splats); reverse mode gives the same derivative of
    the film's sum (rtol 1e-4)."""
    cov = coverage
    P = cov["P"]
    dp = torch.zeros(P)
    dp[-2:] = 1.0
    _, g = port_jvp(lambda p: _utd(cov, p)[0], torch.ones(P), dp)
    g = g.numpy()
    assert np.isfinite(g).all() and (g != 0).any()
    assert fd_close(g, cov[True]["map_concrete"], 0.12, 0.02) >= NEE_SHARE
    p = torch.ones(P, requires_grad=True)
    _utd(cov, p)[0].sum().backward()
    np.testing.assert_allclose(float(p.grad[-2:].sum()), g.sum(), rtol=1e-4)


def test_utd_modes_agree_in_lane_batches(coverage):
    """torch.func.jvp gives the forward_ad map; the film is a sum over
    lanes, so reverse-mode gradients accumulated over the two halves of
    the lanes (the card's lane batches) equal the whole batch's."""
    cov = coverage
    P = cov["P"]
    dp = torch.from_numpy(cov["emit"])
    _, g_fwd = port_jvp(lambda p: _utd(cov, p)[0], torch.ones(P), dp)
    _, g_func = torch.func.jvp(lambda p: _utd(cov, p)[0], (torch.ones(P),),
                               (dp,))
    torch.testing.assert_close(g_func, g_fwd, rtol=1e-5, atol=0.0)
    p = torch.ones(P, requires_grad=True)
    _utd(cov, p)[1].sum().backward()
    whole = p.grad.clone()
    p.grad = None
    data = _port_params(cov["data"], p)
    for half in (slice(0, N // 2), slice(N // 2, N)):
        ids = torch.arange(N, dtype=torch.int32)[half]
        pos, values, ok, sig, _ = trace_forward(
            data, ids, UTD_KEY, torch.zeros_like(ids), sensor=cov["sensor"],
            edge_table=data.edges, max_depth=DEPTH, eps=UTD_EPS)
        film = tfilm.make_film(UTD_RES, UTD_RES, values.shape[-1],
                               cov["sensor"].rfilter_sigma)
        tfilm.splat_direct_gaussian(film, pos, sig, values, ok)
        tfilm.develop(film, 1.0).sum().backward(retain_graph=True)
    torch.testing.assert_close(p.grad, whole, rtol=1e-5, atol=0.0)


# ---------------------------------------------------------------------------
# Fraunhofer: the slit screen, w.r.t. the aperture geometry
# ---------------------------------------------------------------------------

MOVES = ["translate", "widen"]


def _jax_delta(tmask, emask, move, theta):
    """test_gradients_wave.py:330/351's vertex maps: the screen along x,
    or x → x + sign(x)·θ on the central strip."""
    xhat = jnp.asarray([1.0, 0.0, 0.0])

    def delta_fn(v):
        m = (tmask if v.shape[0] == tmask.shape[0] else emask)
        m = m.astype(jnp.float32)
        if move == "translate":
            return (theta * m)[:, None] * xhat
        dx = jnp.sign(v[..., 0]) * theta * m
        return jnp.stack([dx, jnp.zeros_like(dx), jnp.zeros_like(dx)], -1)
    return delta_fn


def _tri_mask_t(data, ids):
    sid = data.geo.tri_attr[:, 22]
    return torch.stack([sid == s for s in ids]).any(0)


def _edge_mask_t(data, ids):
    tri1 = data.edges.tri1
    sid = data.geo.tri_attr[tri1.clamp_min(0).long(), 22]
    return torch.stack([sid == s for s in ids]).any(0) & (tri1 >= 0)


def _move_t(data, move, theta):
    """The port's twin of test_gradients_wave.py::_move_geometry with the
    two vertex maps: the triangles (p0, e1, e2 and the packed tri_geom
    rows) and the edges (p0, p1, center; EdgeTable repacks itself)."""
    ids = SCREEN if move == "translate" else (CENTRAL,)
    tmask = _tri_mask_t(data, ids).to(torch.float32)
    emask = _edge_mask_t(data, ids).to(torch.float32)

    def delta(v, m):
        if move == "translate":
            dx = theta * m
        else:
            dx = torch.sign(v[..., 0]) * theta * m
        return torch.stack([dx, torch.zeros_like(dx), torch.zeros_like(dx)],
                           -1)

    geo = data.geo
    v0, v1, v2 = geo.p0, geo.p0 + geo.e1, geo.p0 + geo.e2
    n0, n1, n2 = (v + delta(v, tmask) for v in (v0, v1, v2))
    geo = dataclasses.replace(
        geo, p0=n0, e1=n1 - n0, e2=n2 - n0,
        tri_geom=torch.cat([n0, n1 - n0, n2 - n0, geo.tri_geom[:, 9:]], 1))
    ed = data.edges
    ed = dataclasses.replace(ed, p0=ed.p0 + delta(ed.p0, emask),
                             p1=ed.p1 + delta(ed.p1, emask),
                             center=ed.center + delta(ed.center, emask))
    return dataclasses.replace(data, geo=geo, edges=ed)


@pytest.fixture(scope="module")
def slits(tmp_path_factory):
    path = tmp_path_factory.mktemp("slits") / "slits.xml"
    path.write_text(slit_screen_xml(SLIT_RES, 2, DEPTH))
    js, ts = jxml.load_scene_xml(str(path)), txml.load_scene_xml(str(path))
    jdata, tb = _bridge(js, ts)
    out = dict(sensor=tb.scene.sensors[0], data=tb.data)
    jsensor = js.sensors[0]
    masks = {m: (_tri_shape_mask(jdata, ids), _edge_shape_mask(jdata, ids))
             for m, ids in (("translate", SCREEN), ("widen", (CENTRAL,)))}

    def f(th):
        d = _move_geometry(jdata, lambda v: _jax_delta(
            *masks["translate"], "translate", th[0])(v)
            + _jax_delta(*masks["widen"], "widen", th[1])(v))
        return _jax_films(d, jsensor, SLIT_KEY, SLIT_EPS,
                          fsd_mode="fraunhofer")[1]

    jvp = jax.jit(lambda t, dt: jax.jvp(f, (t,), (dt,)))
    for i, move in enumerate(MOVES):
        img, g = jvp(jnp.zeros(2), jnp.zeros(2).at[i].set(1.0))
        out[move] = (np.asarray(img), np.asarray(g))
    return out


def _fringes(sl, move, theta, **kw):
    return _port_films(_move_t(sl["data"], move, theta), sl["sensor"],
                       SLIT_KEY, SLIT_EPS, fsd_mode="fraunhofer", **kw)


def test_slit_screen_loads_alike_and_classifies_its_edges(slits):
    """Both loaders read slit_screen_xml to the same scene: three strips
    (6 triangles) whose 12 boundary edges are all classified; the slits'
    vertical edges sit at ±(strip/2) and ±(strip/2 + slit)."""
    data = slits["data"]
    g = SLIT_SCREEN
    assert data.geo.num_tris == 6 and data.edges.count == 12
    p0, p1 = data.edges.p0, data.edges.p1
    y = torch.cat([p0, p1])[:, 1].abs()
    torch.testing.assert_close(y, torch.full_like(y, 0.5 * g["height"]))
    vertical = (p0[:, 0] == p1[:, 0]) & (p0[:, 1] != p1[:, 1])
    assert int(vertical.sum()) == 6
    x = p0[vertical, 0].abs()
    for edge_x in (0.5 * g["strip"], 0.5 * g["strip"] + g["slit"]):
        assert int((x - edge_x).abs().lt(1e-7).sum()) == 2


def port_jvp_all(f, x, dx):
    """(f(x)'s outputs, their forward-mode tangents along dx; None where an
    output carries none)."""
    with fwAD.dual_level():
        out = f(fwAD.make_dual(x, dx))
        prim, tan = [], []
        for o in out:
            if isinstance(o, torch.Tensor):
                u = fwAD.unpack_dual(o)
                prim.append(u.primal)
                tan.append(u.tangent)
            else:
                prim.append(o)
                tan.append(None)
    return prim, tan


@pytest.mark.parametrize("move", MOVES)
def test_aperture_geometry_gradients(slits, move):
    """Forward mode through the Fraunhofer aperture (projected endpoints,
    ASF phases, blocked flux, the redirect ξ·Ξ⁻¹(θ), the splat position
    and weights), the crossings' film: every tangent finite and not all
    zero, the FSD redirect taken; against the port's central differences
    at h = 4 µm on ≥ 95% of the pixels within rtol 0.15, atol
    0.03·max|fd| (the JAX test's oracle); against the JAX jvp map at that
    tolerance on ≥ 90% of the pixels, and the image likewise."""
    sl = slits
    (_, img, state), (_, g, _) = port_jvp_all(
        lambda th: _fringes(sl, move, th, debug=True), torch.tensor(0.0),
        torch.tensor(1.0))
    g, img = g.numpy(), img.numpy()
    assert bool(state["sampled_fsd"].any())
    assert np.isfinite(g).all() and (g != 0).any()
    h = 4e-6
    fd = ((_fringes(sl, move, torch.tensor(h))[1]
           - _fringes(sl, move, torch.tensor(-h))[1]) / (2 * h)).numpy()
    assert fd_close(g, fd, 0.15, 0.03) >= 0.95
    jimg, jmap = sl[move]
    assert fd_close(img, jimg, 0.15, 0.03) >= 0.90
    assert fd_close(g, jmap, 0.15, 0.03) >= 0.90


# ---------------------------------------------------------------------------
# the repairs reverse mode needs on these paths
# ---------------------------------------------------------------------------

def test_fresnel_masked_rows_backprop_finite():
    """A masked-off row passes reverse mode a zero cotangent; the
    dielectric Fresnel turned it into NaN (as jax.grad does) at grazing
    incidence (ci = 0: the divisor of Z = |ct/(η·ci)| squared to 0) and,
    through |ct/(η·ci)| at ct = 0, on the total-internal-reflection rows
    of the coverage scene (test_utd_row_gradients_match_jax[True] fails
    without the cos θt floor). The values of the other rows are unchanged
    (against the JAX twin at rtol 1e-6)."""
    from wave_tracer_tpu.polarization import fresnel as jfresnel
    from wave_tracer_tpu_torch.polarization import fresnel as tfresnel
    r = np.random.default_rng(4)
    n = 64
    # from the dense side (η1/η2 = 1.5): TIR beyond 41.8°, and one grazing
    # row
    w = r.normal(size=(n, 3)).astype(np.float32)
    w[:, 2] = np.abs(w[:, 2])
    w[0] = (1.0, 0.0, 0.0)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    nrm = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    x = torch.tensor(1.0, requires_grad=True)
    eta12 = torch.complex(1.5 * x * torch.ones(n), 0.01 * torch.ones(n))
    f = tfresnel.fresnel(eta12, torch.from_numpy(w), torch.from_numpy(nrm))
    assert f["tir"].any() and (~f["tir"]).any() and bool(f["tir"][0])
    (f["Ts"].sum() + f["Tp"].sum() + f["rs"].abs().sum()).backward()
    assert torch.isfinite(x.grad)
    jf = jfresnel.fresnel(jnp.full((n,), 1.5 + 0.01j, jnp.complex64),
                          jnp.asarray(w), jnp.asarray(nrm))
    keep = ~f["tir"].numpy()
    for key in ("Ts", "Tp", "rs", "ts", "Z"):
        np.testing.assert_allclose(f[key].detach().numpy()[keep],
                                   np.asarray(jf[key])[keep], rtol=1e-6,
                                   atol=1e-7, err_msg=key)
