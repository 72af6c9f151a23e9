"""Pixel gradients through the wave plt_path (free-space diffraction on):
the port's `trace_paths_wave` under torch's reverse and forward modes,
held against the JAX package's `trace_paths_wave` under `jax.jvp` on
the same bridged tables and Sobol draws, and against the
port's own central differences (test_gradients_wave.py's box class and
test_gradients_breadth.py's SPM roughness).

The JAX side runs its ray and cone queries through the plain references
of its Pallas kernels (`jax_kernel_references`), which K1/K2/K3 port; the
two packages then agree to float rounding here, but the wave path's
traversal classes and FSD sets rest on float thresholds, so the pixel
maps are held at the wave image bars of PERF.md §2 (Pearson ≥ 0.999, ≥
90% of pixels within 1e-2·max(|ref|, mean|ref|)). The port's per-row
reverse-mode gradients of the image mean are held at rtol 1e-3 against
the JAX derivatives along each row (its jvp, compiled once for the maps:
a jax.grad of the wave path would cost a second compile).

The geometry stays fixed here: K3's per-boundary minima carry no
derivative (the kernel returns no winning triangle), so geometry
gradients go through the classical path (test_torch_gradients.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_render import make_box_scene
from test_torch_gradients import (_flatten, emitter_rows, fd_close,
                                  jax_kernel_references, jax_scaled, lanes,
                                  port_jvp, port_scaled, wave_bars)
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.bsdf import Material, SpmBSDF, SurfaceProfile
from wave_tracer_tpu.integrator.plt_path import \
    trace_paths_wave as jtrace_paths_wave
from wave_tracer_tpu.sampling import rng as jrng
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.spectrum.spectra import (ComplexUniformSpectrum,
                                              UniformSpectrum)
from wave_tracer_tpu.texture.texture import ConstantSpectrumTexture
from wave_tracer_tpu_torch.integrator.path import STAT_EDGE_HIT, STAT_FSD
from wave_tracer_tpu_torch.integrator.path import trace_paths
from wave_tracer_tpu_torch.integrator.plt_path import trace_paths_wave
from wave_tracer_tpu_torch.render import Renderer
from wave_tracer_tpu_torch.scene.build import build_scene
from wave_tracer_tpu_torch.scene.bridge import scene_data_from_numpy
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene

cap_torch_threads()

RES, DEPTH, KEY = 8, 3, 3          # test_gradients_wave.py's setup
SPM_DEPTH, SPM_KEY = 2, 11         # test_gradients_breadth.py's
ROUGH = 0.31837                    # its roughness marker value


def _metal_scene():
    """test_gradients_breadth.py's roughness scene: the box with an SPM
    conductor (Gaussian profile) on the floor, ceiling and back wall."""
    scene = make_box_scene(res=RES, spp=1)
    metal = Material(
        bsdf=SpmBSDF(ior=ComplexUniformSpectrum(0.27 + 2.9j),
                     profile=SurfaceProfile(
                         type="gaussian",
                         roughness=ConstantSpectrumTexture(
                             UniformSpectrum(ROUGH, 1.0, 1e9)))),
        twosided=True, name="metal")
    for sh in scene.shapes[:3]:
        sh.material = metal
    return scene


def _rough_rows(data_j):
    vals = np.asarray(data_j.tables.spectra.vals)
    rows = np.array([np.allclose(v, ROUGH, atol=1e-5) for v in vals],
                    np.float32)
    assert rows.any(), "roughness spectrum row not found"
    return rows


@pytest.fixture(scope="module")
def box():
    scene = make_box_scene(res=RES, spp=1)
    jb = jbuild(scene)
    metal = _metal_scene()
    jm = jbuild(metal)
    return dict(scene=scene, jb=jb, jm=jm,
                sensor=tmake_box_scene(res=RES, spp=1).sensors[0],
                data=scene_data_from_numpy(_flatten(jb.data), "cpu"),
                metal=scene_data_from_numpy(_flatten(jm.data), "cpu"))


@pytest.fixture(scope="module")
def jax_results(box):
    """Every JAX number the wave tests read, through the kernel
    references: values, pixel maps and the per-row derivatives of the image
    mean (one jitted jvp over row scales), and the SPM roughness map."""
    jb, sensor = box["jb"], box["scene"].sensors[0]
    pxy, jit, sids = (jnp.asarray(x) for x in lanes(RES))

    def values(data, depth=DEPTH, key=KEY):
        return jtrace_paths_wave(data, pxy, jit, jrng.make_base_key(key),
                                 sids, sensor=sensor, edge_table=data.edges,
                                 max_depth=depth, eps=1e-4)[1]

    S = jb.data.tables.spectra.vals.shape[0]
    ones = jnp.ones((S,))
    out = {}
    with jax_kernel_references():
        jvp_rows = jax.jit(lambda rs, drs: jax.jvp(
            lambda r: values(jax_scaled(jb.data, r)), (rs,), (drs,)))
        out["values"], out["map_all"] = (np.asarray(x) for x in jvp_rows(
            ones, ones))
        out["map_emit"] = np.asarray(jvp_rows(
            ones, jnp.asarray(emitter_rows(jb.data)))[1])
        # d mean(values) / d(row scale), one row at a time through the
        # compiled jvp (a jax.grad of the wave path would compile again)
        out["row_grad"] = np.array([float(jnp.mean(jvp_rows(
            ones, jnp.zeros((S,)).at[r].set(1.0))[1])) for r in range(S)])
        jm = box["jm"]
        Sm = jm.data.tables.spectra.vals.shape[0]
        out["spm_values"], out["spm_map"] = (np.asarray(x) for x in jax.jit(
            lambda rs, drs: jax.jvp(lambda r: values(
                jax_scaled(jm.data, r), SPM_DEPTH, SPM_KEY), (rs,), (drs,)))(
            jnp.ones((Sm,)), jnp.asarray(_rough_rows(jm.data))))
    return out


def _port(box, data, depth=DEPTH, key=KEY, with_stats=False):
    pxy, jit, sids = (torch.from_numpy(x) for x in lanes(RES))
    return trace_paths_wave(data, pxy, jit, key, sids, sensor=box["sensor"],
                            edge_table=data.edges, max_depth=depth, eps=1e-4,
                            with_stats=with_stats)


def _values(box, data, **kw):
    return _port(box, data, **kw)[1]


def _map(box, data, mask, **kw):
    """(image, forward-mode pixel map w.r.t. θ scaling the rows of mask)."""
    return port_jvp(lambda th: _values(box, port_scaled(
        data, 1.0 + mask * (th - 1.0)), **kw), torch.tensor(1.0),
        torch.tensor(1.0))


def test_trace_paths_wave_matches_jax_and_fsd_fires(box, jax_results):
    """Forward values at the wave bars; the FSD terms fire at this size and
    depth, so the wave image differs from the classical one."""
    pos, values, valid, stats = _port(box, box["data"], with_stats=True)
    v, ref = values.numpy(), jax_results["values"]
    assert v.shape == ref.shape == (RES * RES, 3) and valid.all()
    assert np.isfinite(v).all() and v.mean() > 0
    np.testing.assert_allclose(v.mean(0), ref.mean(0), rtol=0.02)
    pearson, share = wave_bars(v, ref)
    assert pearson >= 0.999 and share >= 0.90
    assert float(stats[STAT_FSD]) > 0 and float(stats[STAT_EDGE_HIT]) > 0
    pxy, jit, sids = (torch.from_numpy(x) for x in lanes(RES))
    classical = trace_paths(box["data"], pxy, jit, KEY, sids,
                            sensor=box["sensor"], max_depth=DEPTH,
                            eps=1e-4)[1].numpy()
    assert np.abs(v - classical).max() > 1e-3 * np.abs(classical).max()


def test_spectra_row_gradients_match_jax(box, jax_results):
    S = box["data"].tables.spectra.vals.shape[0]
    rs = torch.ones(S, requires_grad=True)
    _values(box, port_scaled(box["data"], rs)).mean().backward()
    g, ref = rs.grad.numpy(), jax_results["row_grad"]
    assert np.isfinite(g).all() and (np.abs(g) > 0).sum() >= 2
    np.testing.assert_allclose(g, ref, rtol=1e-3,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("rows", ["all", "emitters"])
def test_pixel_maps_match_jax_and_fd(box, jax_results, rows):
    """Forward mode: the pixel map w.r.t. every spectra row (reflectance
    and emitters) or the emitters' rows only, against JAX at the wave bars
    and against the port's central differences at test_gradients_wave.py's
    tolerance (rtol 0.12, atol 0.02·max|fd|, every pixel)."""
    data = box["data"]
    S = data.tables.spectra.vals.shape[0]
    mask = torch.ones(S) if rows == "all" else torch.from_numpy(
        emitter_rows(box["jb"].data))
    img, g = _map(box, data, mask)
    g, img = g.numpy(), img.numpy()
    ref = jax_results["map_all" if rows == "all" else "map_emit"]
    assert np.isfinite(g).all() and (g != 0).any()
    pearson, share = wave_bars(g, ref)
    assert pearson >= 0.999 and share >= 0.90
    h = 0.05

    def f(th):
        return _values(box, port_scaled(data, 1.0 + mask * (th - 1.0)))

    fd = ((f(1.0 + h) - f(1.0 - h)) / (2 * h)).numpy()
    np.testing.assert_allclose(g, fd, rtol=0.12,
                               atol=0.02 * np.abs(fd).max())
    if rows == "emitters":
        lit = img.sum(-1) > 1e-3 * img.max()
        assert (g.sum(-1)[lit] > 0).all()


def test_emitter_scale_map_is_the_image(box):
    """The image is linear in the emitters' scale: its forward-mode map
    equals the image (the check the card runs at full depth)."""
    data = box["data"]
    mask = torch.from_numpy(emitter_rows(box["jb"].data))
    img, g = _map(box, data, mask, depth=8)
    torch.testing.assert_close(g, img, rtol=1e-5,
                               atol=1e-6 * float(img.abs().max()))


def test_spm_roughness_map_matches_jax_and_fd(box, jax_results):
    """The SPM roughness row through the wave NEE (depth 2): against JAX at
    the wave bars, and against the port's central differences at
    test_gradients_breadth.py's bar (> 97% of pixels at rtol 0.15, atol
    0.03·max|fd|)."""
    data = box["metal"]
    assert data.tables.materials.has_spm
    mask = torch.from_numpy(_rough_rows(box["jm"].data))
    img, g = _map(box, data, mask, depth=SPM_DEPTH, key=SPM_KEY)
    g = g.numpy()
    assert np.isfinite(g).all() and (g != 0).any()
    pearson, share = wave_bars(img.numpy(), jax_results["spm_values"])
    assert pearson >= 0.999 and share >= 0.90
    pearson, share = wave_bars(g, jax_results["spm_map"])
    assert pearson >= 0.999 and share >= 0.90
    h = 0.05

    def f(th):
        return _values(box, port_scaled(data, 1.0 + mask * (th - 1.0)),
                       depth=SPM_DEPTH, key=SPM_KEY)

    fd = ((f(1.0 + h) - f(1.0 - h)) / (2 * h)).numpy()
    assert fd_close(g, fd, 0.15, 0.03) > 0.97


def test_reverse_mode_in_lane_batches(box):
    """The loss is a sum over lanes, so gradients accumulated over lane
    batches equal the gradient of one batch of every lane (the card's
    full-width reverse mode)."""
    data = box["data"]
    S = data.tables.spectra.vals.shape[0]
    pxy, jit, sids = (torch.from_numpy(x) for x in lanes(RES))
    rs = torch.ones(S, requires_grad=True)

    def run(sl):
        d = port_scaled(data, rs)
        return trace_paths_wave(d, pxy[sl], jit[sl], KEY, sids[sl],
                                sensor=box["sensor"], edge_table=d.edges,
                                max_depth=DEPTH, eps=1e-4)[1].sum()

    run(slice(None)).backward()
    whole = rs.grad.clone()
    rs.grad = None
    for b in range(0, RES * RES, 24):
        run(slice(b, b + 24)).backward()
    torch.testing.assert_close(rs.grad, whole, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("fsd", [True, False])
def test_batched_renderer_matches_the_pool(fsd):
    """Renderer(compact=False) (trace_paths_wave / trace_paths over pixel
    batch × spp batch lanes) draws what the pool draws: the same image to
    splat-order rounding, the same lane counters."""
    scene = tmake_box_scene(res=12, spp=2)
    scene.integrator.fsd = fsd
    scene.integrator.max_depth = 4
    built = build_scene(scene, device="cpu")
    pool, st_pool = Renderer(built, device="cpu",
                             pool_lanes=96).render_sensor()
    img, st = Renderer(built, device="cpu", pool_lanes=96,
                       compact=False).render_sensor()
    assert st["mode"] == ("wave" if fsd else "ray")
    assert st_pool["mode"] == ("wave-compact" if fsd else "ray-compact")
    np.testing.assert_allclose(img, pool, rtol=1e-5,
                               atol=1e-6 * np.abs(pool).max())
    # the counters taken over live lanes (the wave bounce counts its
    # interactions over every lane of the pool, dead ones included)
    for k in ("rays_cast", "rr_terminations", "sum_path_depth",
              "edge_sweep_hits", "ballistic_traversals",
              "diffusive_traversals"):
        assert st["device_counters"][k] == st_pool["device_counters"][k], k


def _complex_cases():
    """(name, port function, JAX function, numpy args, numpy tangents) for
    the complex64 chains of the wave path: the Faddeeva rational, the UTD
    transition and coefficients, Fresnel at a dielectric and a conductor,
    and Jones → Mueller."""
    from wave_tracer_tpu.math import special as jspecial
    from wave_tracer_tpu.polarization import fresnel as jfresnel
    from wave_tracer_tpu.polarization import mueller as jmueller
    from wave_tracer_tpu.wave import utd as jutd
    from wave_tracer_tpu_torch.math import special as tspecial
    from wave_tracer_tpu_torch.polarization import fresnel as tfresnel
    from wave_tracer_tpu_torch.polarization import mueller as tmueller
    from wave_tracer_tpu_torch.wave import utd as tutd
    r = np.random.default_rng(9)
    N = 256

    def unit(n):
        v = r.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    def cplx(n, im_pos=False):
        im = r.normal(size=n)
        return (r.normal(size=n) + 1j * (np.abs(im) if im_pos else im)
                ).astype(np.complex64)

    x = (r.normal(size=N) * 3).astype(np.float32)
    n_up = np.tile(np.float32([0.0, 0.0, 1.0]), (N, 1))
    w = unit(N)
    eta_d = (1.5 + 0.01j * r.random(N)).astype(np.complex64)
    eta_c = (0.27 + 2.9j + 0.1 * r.random(N)).astype(np.complex64)
    k = (2 * np.pi / r.uniform(400e-9, 700e-9, N)).astype(np.float32)
    e = np.tile(np.float32([0.0, 0.0, 1.0]), (N, 1))
    tff = np.tile(np.float32([1.0, 0.0, 0.0]), (N, 1))
    nff = np.tile(np.float32([0.0, 1.0, 0.0]), (N, 1))
    ro = r.uniform(0.5, 2.0, N).astype(np.float32)
    alpha = np.full(N, np.pi / 2, np.float32)
    wi, wo = unit(N), unit(N)

    def fres(mod, conductor):
        f = mod.fresnel_reflection_conductor if conductor else mod.fresnel

        def run(eta, w_, n_):
            out = f(eta, w_, n_)
            return tuple(out[key] for key in sorted(out)) \
                if isinstance(out, dict) else out
        return run

    return [
        ("faddeeva", tspecial.faddeeva, jspecial.faddeeva,
         [cplx(N, True)], [cplx(N)]),
        ("utd_transition", tspecial.utd_transition, jspecial.utd_transition,
         [x], [r.normal(size=N).astype(np.float32)]),
        ("utd_coefficients",
         lambda k_, ro_: tutd.utd_coefficients(
             k_, *(torch.from_numpy(v) for v in (wi, wo)), ro_,
             *(torch.from_numpy(v) for v in (e, tff, nff, alpha))),
         lambda k_, ro_: jutd.utd_coefficients(
             k_, *(jnp.asarray(v) for v in (wi, wo)), ro_,
             *(jnp.asarray(v) for v in (e, tff, nff, alpha))),
         [k, ro], [k * 1e-3, np.ones(N, np.float32)]),
        ("fresnel", fres(tfresnel, False), fres(jfresnel, False),
         [eta_d, w, n_up], [cplx(N), np.zeros_like(w), np.zeros_like(w)]),
        ("fresnel_conductor", fres(tfresnel, True), fres(jfresnel, True),
         [eta_c, w, n_up], [cplx(N), np.zeros_like(w), np.zeros_like(w)]),
        ("from_jones_sp", tmueller.from_jones_sp, jmueller.from_jones_sp,
         [cplx(N), cplx(N)], [cplx(N), cplx(N)]),
    ]


@pytest.mark.parametrize("case", range(6))
def test_complex_chain_jvp_matches_jax(case):
    """torch.func.jvp and forward_ad through the complex64 chains of the
    wave path against jax.jvp, at rtol 1e-4 of each output's largest
    tangent (no op needed a rewrite for forward mode)."""
    import torch.autograd.forward_ad as fwAD
    name, tf, jf, args, tans = _complex_cases()[case]
    targs = tuple(torch.from_numpy(a) for a in args)
    ttans = tuple(torch.from_numpy(t) for t in tans)
    _, t_func = torch.func.jvp(tf, targs, ttans)
    with fwAD.dual_level():
        out = tf(*(fwAD.make_dual(a, t) for a, t in zip(targs, ttans)))
        out = out if isinstance(out, tuple) else (out,)
        t_fwd = tuple(fwAD.unpack_dual(o).tangent for o in out)
    _, j_tan = jax.jvp(jf, tuple(jnp.asarray(a) for a in args),
                       tuple(jnp.asarray(t) for t in tans))
    t_func = t_func if isinstance(t_func, tuple) else (t_func,)
    j_tan = j_tan if isinstance(j_tan, tuple) else (j_tan,)
    assert len(t_func) == len(j_tan) == len(t_fwd), name
    for a, b, ref in zip(t_func, t_fwd, j_tan):
        if ref.dtype == jax.dtypes.float0:      # a bool or integer output
            assert b is None, name
            continue
        ref = np.asarray(ref)
        if b is None:            # an output that does not depend on args
            assert not np.abs(ref).any(), name
            continue
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6 * scale, err_msg=name)
