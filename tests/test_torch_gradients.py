"""Pixel gradients through the classical plt_path: the port's `trace_paths`
under torch's reverse mode (`.backward()`) and forward mode
(`torch.autograd.forward_ad`, `torch.func.jvp`), held against the JAX
package's `trace_paths` under `jax.grad` / `jax.jvp` on the same bridged
tables and Sobol draws, and against the port's own central differences.

The JAX side runs its ray queries through the plain references of its
Pallas kernels (`jax_kernel_references`), as its own CPU tests of those
kernels do: K1/K2 port those all-pairs tests, tie-breaks included, and
the two packages then agree to float rounding. The JAX package's default
CPU trace (brute Möller–Trumbore) breaks a tie on an edge shared by two
triangles of one wall the other way: at 8×8 one camera ray of 64 falls on
such a diagonal and takes another path from there. Wall translation needs
that brute trace (its t is exact-AD; the kernel reference's is not), so
it is held at the classical image bar of PERF.md §2 (≥ 98% of pixels
within 1e-3·max(|ref|, mean|ref|)).

Bars, each stated at its assert: values and pixel maps against JAX at
the classical bar; per-row reverse-mode gradients of the image mean
against `jax.grad` at rtol 1e-3; AD against the port's central
differences at the JAX tests' tolerances (test_gradients.py,
test_gradients_breadth.py).

Also here: the two faults this slice fixed (sampled directions, densities
and η carry no derivative; the hit distance carries the Möller–Trumbore
derivative of the winning triangle and keeps the kernel's value bit for
bit), the primal-only rule of the kernel wrappers, kernel tables rebuilt
for moved triangles, the bridge's leaves, the film splat's derivative,
and the batched renderer (`Renderer(compact=False)`) against the JAX
package's.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F

from test_render import make_box_scene
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.accel import mxu_trace as jmxu
from wave_tracer_tpu.accel import trace as jtrace
from wave_tracer_tpu.bsdf import Material, SpmBSDF, SurfaceProfile
from wave_tracer_tpu.bsdf.model import DielectricBSDF
from wave_tracer_tpu.integrator.path import trace_paths as jtrace_paths
from wave_tracer_tpu.render.renderer import Renderer as JRenderer
from wave_tracer_tpu.sampling import rng as jrng
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.spectrum.spectra import (ComplexUniformSpectrum,
                                              UniformSpectrum)
from wave_tracer_tpu.texture.texture import ConstantSpectrumTexture
from wave_tracer_tpu_torch.accel import cone_kernels, ray_kernels
from wave_tracer_tpu_torch.accel import trace as ttrace
from wave_tracer_tpu_torch.bsdf import device as tbsdf
from wave_tracer_tpu_torch.bsdf import table as tmtab
from wave_tracer_tpu_torch.integrator.path import trace_paths
from wave_tracer_tpu_torch.render import Renderer
from wave_tracer_tpu_torch.scene.bridge import (SPECTRAL_KEYS,
                                                scene_data_from_numpy)
from wave_tracer_tpu_torch.scene.build import BuiltScene
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene
from wave_tracer_tpu_torch.sensor import film as tfilm

cap_torch_threads()

RES, DEPTH, KEY = 8, 3, 3          # test_gradients.py's setup
WALL_DEPTH, WALL_KEY = 2, 7        # test_gradients_breadth.py's
BACK_WALL, LEFT_WALL = 2, 3        # shape ids in make_box_scene


# ---------------------------------------------------------------------------
# shared helpers (test_torch_gradients_wave.py imports them)
# ---------------------------------------------------------------------------

def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


@contextlib.contextmanager
def jax_kernel_references():
    """The JAX package's ray and cone queries through the plain references
    of its Pallas kernels (`mxu_trace._launch_ref`, and
    `cone_boundary_minz_mxu` off the TPU), which K1/K2/K3 port."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jtrace, "_tpu_like", lambda: True)
        m.setattr(jmxu, "_launch", jmxu._launch_ref)
        m.setenv("WT_CONE_QUERY", "mxu")
        yield


def lanes(res):
    """One lane per pixel, jitter 0.5, sample 0 (the JAX tests' lanes), as
    numpy arrays."""
    pix = np.arange(res * res, dtype=np.int32)
    return (np.stack([pix % res, pix // res], -1),
            np.full((res * res, 2), 0.5, np.float32),
            np.zeros(res * res, np.int32))


def jax_scaled(data, row_scale):
    st = data.tables.spectra
    return data.replace(tables=data.tables.replace(
        spectra=st.replace(vals=st.vals * row_scale[:, None])))


def port_scaled(data, row_scale):
    st = data.tables.spectra
    return dataclasses.replace(data, tables=dataclasses.replace(
        data.tables, spectra=dataclasses.replace(
            st, vals=st.vals * row_scale[:, None])))


def port_jvp(f, x, dx):
    """(f(x), its forward-mode derivative along dx)."""
    with fwAD.dual_level():
        primal, tangent = fwAD.unpack_dual(f(fwAD.make_dual(x, dx)))
    return primal, tangent


def emitter_rows(data_j):
    """Row mask (S,) f32 of the emitters' spectra."""
    S = data_j.tables.spectra.vals.shape[0]
    rows = np.zeros(S, np.float32)
    for sid in np.unique(np.asarray(data_j.emitters.spec_id)):
        if sid >= 0:
            rows[int(sid)] = 1.0
    assert rows.any()
    return rows


def classical_share(a, ref):
    """Share of pixels within 1e-3·max(|ref|, mean|ref|) on every
    channel (PERF.md §2, classical)."""
    scale = np.maximum(np.abs(ref), np.abs(ref).mean())
    return float((np.abs(a - ref) <= 1e-3 * scale).all(-1).mean())


def wave_bars(a, ref):
    """(Pearson correlation, share of pixels within 1e-2·max(|ref|,
    mean|ref|)) (PERF.md §2, wave)."""
    scale = np.maximum(np.abs(ref), np.abs(ref).mean())
    share = float((np.abs(a - ref) <= 1e-2 * scale).all(-1).mean())
    return float(np.corrcoef(a.ravel(), ref.ravel())[0, 1]), share


def fd_close(g, fd, rtol, atol_frac):
    """Share of entries where AD matches central differences (the JAX
    tests' np.isclose oracle, atol a fraction of max|fd|)."""
    scale = max(float(np.abs(fd).max()), 1e-30)
    return float(np.isclose(g, fd, rtol=rtol, atol=atol_frac * scale).mean())


# ---------------------------------------------------------------------------
# the classical setup: JAX results once per module
# ---------------------------------------------------------------------------

def _translate_j(data, shape_id, delta):
    mask = (data.geo.shape_id == shape_id).astype(jnp.float32)[:, None]
    d3 = mask * delta[None, :]
    return data.replace(geo=data.geo.replace(
        p0=data.geo.p0 + d3, tri_geom=data.geo.tri_geom.at[:, 0:3].add(d3)))


def _translate_t(data, shape_id, delta):
    """Rigid translation of one shape: p0 and the packed tri_geom rows,
    as test_gradients_breadth.py's translate_shape moves them."""
    mask = (data.geo.tri_attr[:, 22] == shape_id).to(torch.float32)[:, None]
    d3 = mask * delta[None, :]
    geo = dataclasses.replace(data.geo, p0=data.geo.p0 + d3,
                              tri_geom=data.geo.tri_geom + F.pad(d3, (0, 9)))
    return dataclasses.replace(data, geo=geo)


@pytest.fixture(scope="module")
def box():
    scene = make_box_scene(res=RES, spp=1)
    scene.integrator.fsd = False
    jb = jbuild(scene)
    arrays = _flatten(jb.data)
    tscene = tmake_box_scene(res=RES, spp=1)
    tscene.integrator.fsd = False
    return dict(scene=scene, jb=jb, arrays=arrays, tscene=tscene,
                data=scene_data_from_numpy(arrays, "cpu"))


@pytest.fixture(scope="module")
def jax_results(box):
    """Every JAX number the classical tests read: values and pixel maps
    (one jitted jvp over row scales), the per-row gradient of the image
    mean (jax.grad), both through the kernel references; and the wall
    translation's pixel map through the default (exact-AD) trace."""
    jb, sensor = box["jb"], box["scene"].sensors[0]
    pxy, jit, sids = (jnp.asarray(x) for x in lanes(RES))
    S = jb.data.tables.spectra.vals.shape[0]

    def values(data, depth=DEPTH, key=KEY):
        return jtrace_paths(data, pxy, jit, jrng.make_base_key(key), sids,
                            sensor=sensor, max_depth=depth, eps=1e-4)[1]

    out = {}
    with jax_kernel_references():
        jvp_rows = jax.jit(lambda rs, drs: jax.jvp(
            lambda r: values(jax_scaled(jb.data, r)), (rs,), (drs,)))
        ones = jnp.ones((S,))
        out["values"], out["map_all"] = (np.asarray(x) for x in jvp_rows(
            ones, ones))
        out["map_emit"] = np.asarray(jvp_rows(
            ones, jnp.asarray(emitter_rows(jb.data)))[1])
        out["row_grad"] = np.asarray(jax.grad(
            lambda rs: jnp.mean(values(jax_scaled(jb.data, rs))))(ones))
    wall = jax.jit(lambda t: jax.jvp(lambda th: values(_translate_j(
        jb.data, BACK_WALL, th * jnp.asarray([0.0, 0.0, 1.0])),
        WALL_DEPTH, WALL_KEY), (t,), (1.0,)))
    out["wall_values"], out["wall_map"] = (np.asarray(x)
                                           for x in wall(0.0))
    return out


def _port_values(box, data, depth=DEPTH, key=KEY, with_stats=False):
    pxy, jit, sids = (torch.from_numpy(x) for x in lanes(RES))
    return trace_paths(data, pxy, jit, key, sids,
                       sensor=box["tscene"].sensors[0], max_depth=depth,
                       eps=1e-4, with_stats=with_stats)


def _values(box, data, **kw):
    return _port_values(box, data, **kw)[1]


# ---------------------------------------------------------------------------
# port against JAX
# ---------------------------------------------------------------------------

def test_trace_paths_matches_jax(box, jax_results):
    pos, values, valid, stats = _port_values(box, box["data"],
                                             with_stats=True)
    ref = jax_results["values"]
    v = values.numpy()
    assert v.shape == ref.shape == (RES * RES, 3) and valid.all()
    assert np.isfinite(v).all() and v.mean() > 0
    np.testing.assert_allclose(v.mean(0), ref.mean(0), rtol=0.01)
    assert classical_share(v, ref) >= 0.98
    assert stats.shape == (20,) and float(stats[0]) > 0
    pxy, jit, _ = lanes(RES)
    np.testing.assert_array_equal(pos.numpy(), pxy + jit)


def test_spectra_row_gradients_match_jax(box, jax_results):
    """Reverse mode: d mean(values) / d(row scale), every row."""
    S = box["data"].tables.spectra.vals.shape[0]
    rs = torch.ones(S, requires_grad=True)
    _values(box, port_scaled(box["data"], rs)).mean().backward()
    g, ref = rs.grad.numpy(), jax_results["row_grad"]
    assert np.isfinite(g).all() and (np.abs(g) > 0).sum() >= 2
    np.testing.assert_allclose(g, ref, rtol=1e-3,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("rows", ["all", "emitters"])
def test_pixel_maps_match_jax(box, jax_results, rows):
    """Forward mode: the pixel map w.r.t. one θ scaling every spectra row
    (reflectance and emitters) or the emitters' rows only."""
    data = box["data"]
    S = data.tables.spectra.vals.shape[0]
    mask = torch.ones(S) if rows == "all" else torch.from_numpy(
        emitter_rows(box["jb"].data))
    _, g = port_jvp(lambda th: _values(box, port_scaled(
        data, 1.0 + mask * (th - 1.0))), torch.tensor(1.0), torch.tensor(1.0))
    g = g.numpy()
    ref = jax_results["map_all" if rows == "all" else "map_emit"]
    assert np.isfinite(g).all() and (g != 0).any()
    assert classical_share(g, ref) >= 0.98


def test_wall_translation_matches_jax(box, jax_results):
    """Forward mode through the hit distance: the back wall moved along
    +z, against the JAX package's exact-AD brute trace."""
    data = box["data"]
    zhat = torch.tensor([0.0, 0.0, 1.0])
    p, g = port_jvp(lambda th: _values(
        box, _translate_t(data, BACK_WALL, th * zhat), depth=WALL_DEPTH,
        key=WALL_KEY), torch.tensor(0.0), torch.tensor(1.0))
    assert np.isfinite(g.numpy()).all() and (g != 0).any()
    assert classical_share(p.numpy(), jax_results["wall_values"]) >= 0.98
    assert classical_share(g.numpy(), jax_results["wall_map"]) >= 0.98


# ---------------------------------------------------------------------------
# port AD against the port's central differences (the JAX tests' oracles)
# ---------------------------------------------------------------------------

def _mean_of(box, theta, mask=None):
    data = box["data"]
    S = data.tables.spectra.vals.shape[0]
    rs = torch.ones(S) * theta if mask is None \
        else 1.0 + mask * (theta - 1.0)
    return _values(box, port_scaled(data, rs)).mean()


def test_reflectance_gradient_vs_fd(box):
    theta = torch.tensor(1.0, requires_grad=True)
    _mean_of(box, theta).backward()
    g = float(theta.grad)
    h = 0.05
    fd = float(_mean_of(box, torch.tensor(1.0 + h))
               - _mean_of(box, torch.tensor(1.0 - h))) / (2 * h)
    assert np.isfinite(g) and g > 0     # brighter spectra → brighter image
    np.testing.assert_allclose(g, fd, rtol=0.2)


def test_dominant_row_monotone(box):
    S = box["data"].tables.spectra.vals.shape[0]
    rs = torch.ones(S, requires_grad=True)
    _values(box, port_scaled(box["data"], rs)).mean().backward()
    row = int(rs.grad.abs().argmax())
    mask = torch.zeros(S)
    mask[row] = 1.0
    theta = torch.tensor(1.0, requires_grad=True)
    l1 = _mean_of(box, theta, mask)
    l1.backward()
    g1 = float(theta.grad)
    l2 = float(_mean_of(box, torch.tensor(2.0), mask))
    assert g1 > 0 and l2 > float(l1)
    assert 0.3 * g1 <= l2 - float(l1) <= 4.0 * g1


def test_grad_nonzero_one_bounce(box):
    """test_grad_smoke.py's check: 4×4, depth 2."""
    scene = tmake_box_scene(res=4, spp=1)
    pxy, jit, sids = (torch.from_numpy(x) for x in lanes(4))
    theta = torch.tensor(1.0, requires_grad=True)
    data = port_scaled(box["data"], torch.ones(
        box["data"].tables.spectra.vals.shape[0]) * theta)
    values = trace_paths(data, pxy, jit, 0, sids, sensor=scene.sensors[0],
                         max_depth=2, eps=1e-4)[1]
    values.mean().backward()
    assert np.isfinite(float(theta.grad)) and float(theta.grad) > 0


@pytest.mark.parametrize("wall,direction", [(BACK_WALL, (0.0, 0.0, 1.0)),
                                            (LEFT_WALL, (-1.0, 0.0, 0.0))])
def test_wall_translation_vs_fd(box, wall, direction):
    data = box["data"]
    d = torch.tensor(direction)

    def f(th):
        return _values(box, _translate_t(data, wall, th * d),
                       depth=WALL_DEPTH, key=WALL_KEY)

    _, g = port_jvp(f, torch.tensor(0.0), torch.tensor(1.0))
    h = 5e-3
    fd = ((f(torch.tensor(h)) - f(torch.tensor(-h))) / (2 * h)).numpy()
    g = g.numpy()
    assert np.isfinite(g).all() and (g != 0).any()
    # the JAX tests' bars: > 97% (back wall) and > 95% (side wall)
    assert fd_close(g, fd, 0.15, 0.03) > (0.97 if wall == BACK_WALL
                                          else 0.95)


def test_forward_and_reverse_modes_agree(box):
    """Σ over pixels of the forward-mode map w.r.t. one row equals that
    row's reverse-mode gradient of the sum; torch.func.jvp gives the
    forward_ad map."""
    data = box["data"]
    S = data.tables.spectra.vals.shape[0]
    rs = torch.ones(S, requires_grad=True)
    _values(box, port_scaled(data, rs)).sum().backward()
    for row in range(S):
        drs = torch.zeros(S)
        drs[row] = 1.0
        _, g = port_jvp(lambda r: _values(box, port_scaled(data, r)),
                        torch.ones(S), drs)
        np.testing.assert_allclose(float(g.sum()), float(rs.grad[row]),
                                   rtol=1e-4, atol=1e-12)
    _, g_fwd = port_jvp(lambda th: _values(box, port_scaled(
        data, torch.ones(S) * th)), torch.tensor(1.0), torch.tensor(1.0))
    _, g_func = torch.func.jvp(lambda th: _values(box, port_scaled(
        data, torch.ones(S) * th)), (torch.tensor(1.0),),
        (torch.tensor(1.0),))
    torch.testing.assert_close(g_func, g_fwd, rtol=1e-5, atol=1e-14)


# ---------------------------------------------------------------------------
# the two faults
# ---------------------------------------------------------------------------

def _lobe_scene():
    """The JAX box with a dielectric floor and an SPM conductor ceiling."""
    scene = make_box_scene(res=4, spp=1)
    scene.shapes[0].material = Material(
        bsdf=DielectricBSDF(ior=ComplexUniformSpectrum(1.5 + 0.0j)),
        name="glass")
    scene.shapes[1].material = Material(
        bsdf=SpmBSDF(ior=ComplexUniformSpectrum(0.27 + 2.9j),
                     profile=SurfaceProfile(
                         type="gaussian",
                         roughness=ConstantSpectrumTexture(
                             UniformSpectrum(0.31837, 1.0, 1e9)))),
        twosided=True, name="metal")
    return scene


@pytest.mark.parametrize("mode", ["reverse", "forward"])
def test_sampled_directions_carry_no_derivative(mode):
    """Fault 1: bsdf.sample's wo, pdf and η are detached, Mw is not (the
    JAX package's stop_gradient), for the dielectric and the SPM lobe,
    TIR and grazing lanes included."""
    data = scene_data_from_numpy(_flatten(jbuild(_lobe_scene()).data),
                                 "cpu")
    tables = data.tables
    assert tables.materials.has_dielectric and tables.materials.has_spm
    mtype = tables.materials.pack[:, tmtab.C_MTYPE].long()
    r = np.random.default_rng(5)
    N = 512
    wi = r.normal(size=(N, 3))
    wi[:, 2] = np.where(np.arange(N) % 4 == 0, 1e-4, wi[:, 2])  # grazing
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wi = torch.tensor(wi, dtype=torch.float32)
    k = torch.tensor(2 * np.pi / r.uniform(400e-9, 700e-9, N),
                     dtype=torch.float32)
    u4 = torch.tensor(r.random((N, 4)), dtype=torch.float32)
    uv = torch.zeros((N, 2))
    for mt in (tmtab.MT_DIELECTRIC, tmtab.MT_SPM):
        row = int((mtype == mt).nonzero()[0, 0])
        mat_id = torch.full((N,), row, dtype=torch.int32)

        def sample(tabs):
            return tbsdf.sample(tabs, mat_id, wi, uv, k, u4)

        def scaled(theta):
            c, s = tables.cspectra, tables.spectra
            return dataclasses.replace(
                tables, cspectra=dataclasses.replace(
                    c, n=c.n * theta, kappa=c.kappa * theta),
                spectra=dataclasses.replace(s, vals=s.vals * theta))

        if mode == "reverse":
            theta = torch.tensor(1.0, requires_grad=True)
            bs = sample(scaled(theta))
            assert bs.Mw.requires_grad
            for x in (bs.wo, bs.pdf, bs.eta):
                assert not x.requires_grad and x.grad_fn is None
            assert torch.isfinite(torch.autograd.grad(
                bs.Mw.sum(), theta)[0])
        else:
            with fwAD.dual_level():
                bs = sample(scaled(fwAD.make_dual(torch.tensor(1.0),
                                                  torch.tensor(1.0))))
                tan = {name: fwAD.unpack_dual(getattr(bs, name)).tangent
                       for name in ("wo", "pdf", "eta", "Mw")}
            assert tan["Mw"] is not None
            assert torch.isfinite(tan["Mw"]).all()
            assert tan["wo"] is None and tan["pdf"] is None \
                and tan["eta"] is None
        if mt == tmtab.MT_DIELECTRIC:
            assert bool((bs.refracted & bs.valid).any())   # η ≠ 1 lanes


def _back_wall_rays(box):
    sensor = box["tscene"].sensors[0]
    pxy, jit, _ = (torch.from_numpy(x) for x in lanes(RES))
    ro, rd, _ = sensor.generate_rays(pxy, jit)
    N = ro.shape[0]
    # the camera's origin is one row expanded to N: copy it to give it a
    # tangent of its own
    return ro.clone(), rd, torch.full((N,), 1e-4), torch.full((N,), 1e30)


def test_trace_rays_t_keeps_its_value_and_gains_the_wall_derivative(box):
    """Fault 2: t from K1's plain version is the same bits with and without
    a derivative in play, and d t / d(wall z) matches central differences
    of t on the lanes that hit the back wall."""
    data = box["data"]
    ro, rd, tmin, tmax = _back_wall_rays(box)
    zhat = torch.tensor([0.0, 0.0, 1.0])
    t0, tri0, u0, v0 = ttrace.trace(data.geo, ro, rd, tmin, tmax)
    theta = torch.tensor(0.0, requires_grad=True)
    geo = _translate_t(data, BACK_WALL, theta * zhat).geo
    t, tri, u, v = ttrace.trace(geo, ro, rd, tmin, tmax)
    assert torch.equal(t.detach(), t0) and torch.equal(tri, tri0)
    assert torch.equal(u.detach(), u0) and torch.equal(v.detach(), v0)
    on_wall = (data.geo.tri_attr[tri0.clamp_min(0).long(), 22]
               == BACK_WALL) & (tri0 >= 0)
    assert int(on_wall.sum()) >= 16
    (g,) = torch.autograd.grad(t[on_wall].sum(), theta, retain_graph=True)
    h = 1e-3

    def t_at(th):
        return ttrace.trace(_translate_t(data, BACK_WALL, th * zhat).geo,
                            ro, rd, tmin, tmax)[0][on_wall]

    fd = (t_at(torch.tensor(h)) - t_at(torch.tensor(-h))) / (2 * h)
    # per lane dt/dz = -1/|rd_z| for a wall at z = -1 + θ seen from z 3.2
    _, tan = port_jvp(t_at, torch.tensor(0.0), torch.tensor(1.0))
    torch.testing.assert_close(tan, fd, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(g, fd.sum(), rtol=1e-3, atol=1e-4)
    # the carried rows of the need/carry path take the derivative too
    need = torch.arange(ro.shape[0]) % 2 == 0
    t_c = ttrace.trace(geo, ro, rd, tmin, tmax, need=need,
                       carry=(t, tri))[0]
    assert torch.equal(t_c.detach(), t0)
    (g_c,) = torch.autograd.grad(t_c[on_wall].sum(), theta)
    torch.testing.assert_close(g_c, g, rtol=1e-6, atol=0.0)


def test_kernel_wrappers_take_primal_tensors_only(box):
    """A tensor that requires grad, carries a tangent or is wrapped by a
    torch.func transform never reaches K1/K2/K3: their wrappers raise on
    one, and the ray queries hand them primal copies."""
    geo = box["data"].geo
    ro, rd, tmin, tmax = _back_wall_rays(box)
    N = ro.shape[0]
    ex = torch.full((N, 3), -1, dtype=torch.int32)
    args = (geo.tri_feat, geo.mxu_center)
    rog = ro.clone().requires_grad_()
    with pytest.raises(ValueError, match="primal"):
        ray_kernels.closest_hit(*args, rog, rd, tmin, tmax, ex,
                                table=geo.ray_table)
    with pytest.raises(ValueError, match="primal"):
        ray_kernels.any_hit(*args, ro, rd, tmin, tmax.requires_grad_(), ex,
                            table=geo.ray_table)
    tmax = tmax.detach()
    with fwAD.dual_level():
        dual = fwAD.make_dual(ro, torch.ones_like(ro))
        with pytest.raises(ValueError, match="primal"):
            ray_kernels.closest_hit(*args, dual, rd, tmin, tmax, ex,
                                    table=geo.ray_table)
        t_dual = ttrace.trace(geo, dual, rd, tmin, tmax)[0]
        assert fwAD.unpack_dual(t_dual).tangent is not None
    tri9 = geo.cone_tris
    z = torch.zeros(N)
    with pytest.raises(ValueError, match="primal"):
        cone_kernels.cone_minz(tri9, rog, rd, rd, z, z, z, z + 1.0,
                               torch.full((N,), -1, dtype=torch.int32),
                               torch.zeros((N, 16)), table=geo.cone_table)
    seen = []

    def spy(*xs, **kw):
        seen.extend(x for x in xs if isinstance(x, torch.Tensor))
        return closest(*xs, **kw)

    closest = ray_kernels._closest_ref
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ray_kernels, "_closest_ref", spy)
        torch.func.jvp(lambda o: ttrace.trace(geo, o, rd, tmin, tmax)[0],
                       (ro,), (torch.ones_like(ro),))
    assert seen and not any(
        x.requires_grad or torch._C._functorch.is_functorch_wrapped_tensor(x)
        for x in seen)


def test_moved_triangles_rebuild_the_kernel_tables(box):
    """A GeoArrays made by dataclasses.replace with moved triangles derives
    its K1/K2/K3 tables anew, from detached copies."""
    data = box["data"]
    theta = torch.tensor(0.25, requires_grad=True)
    geo = _translate_t(data, BACK_WALL,
                       theta * torch.tensor([0.0, 0.0, 1.0])).geo
    fresh = ttrace.GeoArrays(p0=geo.p0.detach(), e1=geo.e1, e2=geo.e2,
                             tri_geom=geo.tri_geom.detach(),
                             tri_attr=geo.tri_attr,
                             mxu_center=geo.mxu_center)
    assert not torch.equal(geo.tri_feat, data.geo.tri_feat)
    for name in ("tri_feat", "cone_tris"):
        x = getattr(geo, name)
        assert not x.requires_grad and torch.equal(x, getattr(fresh, name))
    for a, b in zip(geo.ray_table + geo.cone_table,
                    fresh.ray_table + fresh.cone_table):
        assert not a.requires_grad and torch.equal(a, b)


def test_bridge_float_tables_are_leaves(box):
    data = scene_data_from_numpy(box["arrays"], "cpu")
    vals = data.tables.spectra.vals
    assert vals.is_leaf and vals.dtype == torch.float32
    vals.requires_grad_()
    data.emitters.pack.requires_grad_()
    assert data.tables.materials.comp_child.dtype == torch.int32
    assert data.emitters.etri_idx.dtype == torch.int32
    values = _values(box, data)
    values.sum().backward()
    assert torch.isfinite(vals.grad).all() and vals.grad.abs().sum() > 0


def test_film_splat_is_differentiable():
    r = np.random.default_rng(2)
    pos = torch.tensor(r.uniform(0, 6, (64, 2)), dtype=torch.float32)
    values = torch.tensor(r.random((64, 3)), dtype=torch.float32,
                          requires_grad=True)
    film = tfilm.make_film(6, 6, 3)
    tfilm.splat(film, pos, values, torch.ones(64, dtype=torch.bool))
    img = tfilm.develop(film)
    (g,) = torch.autograd.grad(img.sum(), values)
    # d Σ img / d value_i = Σ_px w_i(px) / W(px), the same for each channel
    assert torch.isfinite(g).all() and (g > 0).all()
    torch.testing.assert_close(g, g[:, :1].expand(-1, 3))
    with fwAD.dual_level():
        film = tfilm.make_film(6, 6, 3)
        tfilm.splat(film, pos, fwAD.make_dual(values.detach(),
                                              torch.ones_like(values)),
                    torch.ones(64, dtype=torch.bool))
        tan = fwAD.unpack_dual(tfilm.develop(film)).tangent
    torch.testing.assert_close(tan.sum(), g.sum(), rtol=1e-5, atol=0.0)


# ---------------------------------------------------------------------------
# the batched renderer
# ---------------------------------------------------------------------------

def test_batched_renderer_matches_jax(box):
    """Renderer(compact=False) renders the classical box through
    trace_paths in pixel batch × spp batch lanes, as the JAX package's
    Renderer(compact=False) does."""
    SPP, LANES = 2, 64
    scene = make_box_scene(res=RES, spp=SPP)
    scene.integrator.fsd = False
    scene.integrator.max_depth = DEPTH
    jb = jbuild(scene)
    with jax_kernel_references():
        jimg, jst = JRenderer(jb, batch_lanes=LANES,
                              compact=False).render_sensor(0, SPP)
    arrays = _flatten(jb.data)
    spectral = {k: arrays[f"spectral.{k}"] for k in SPECTRAL_KEYS}
    tscene = tmake_box_scene(res=RES, spp=SPP)
    tscene.integrator.fsd = False
    tscene.integrator.max_depth = DEPTH
    built = BuiltScene.upload(tscene, arrays, [spectral], "cpu")
    img, st = Renderer(built, device="cpu", pool_lanes=LANES,
                       compact=False).render_sensor(0, SPP)
    assert st["mode"] == jst["mode"] == "ray"
    assert st["pool_lanes"] == LANES
    np.testing.assert_allclose(img.mean((0, 1)), jimg.mean((0, 1)),
                               rtol=0.01)
    assert classical_share(img, jimg) >= 0.98
    for k in ("rays_cast", "shadow_rays", "surface_interactions",
              "rr_terminations", "sum_path_depth"):
        a, b = st["device_counters"][k], jst["device_counters"][k]
        assert abs(a - b) <= 0.005 * b, (k, a, b)
