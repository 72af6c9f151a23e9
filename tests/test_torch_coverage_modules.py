"""Port parity for the modules of the coverage slice: each
wave_tracer_tpu_torch function against its JAX twin on the same seeded
numpy inputs, in f32.

Held at rtol 1e-4 unless stated (the absolute floor at each assert):
transcendental functions, complex square roots and divisions round
differently in the last bits in the two frameworks, and the SPM lobe
chains dozens of them. ITU refractive indices (float64 numpy on both
sides) are held at rtol 1e-5 and the host bakes bit for bit. Boolean and
integer outputs must be equal.

The material, texture, spectrum, complex-spectrum, edge and emitter
tables come from the JAX bake of one scene (the coverage scene's
concrete, plus SPM materials with a roughness texture, a gaussian and a
dirac profile, scale spectra and an exterior index, and a diffuse row),
flattened to numpy and uploaded through the port's bridge, so both sides
read the same tables. The last two tests hold the Fraunhofer forward mode
(plt_bdpt's) per lane and at film level, at the bars of
test_torch_coverage_render.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_coverage import make_coverage_scene as jmake_coverage
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.bsdf import device as jbsdf
from wave_tracer_tpu.bsdf import model as jmodel
from wave_tracer_tpu.bsdf import profiles as jprof
from wave_tracer_tpu.core.transform import Transform as JTransform
from wave_tracer_tpu.geometry import mesh as jmesh
from wave_tracer_tpu.polarization import fresnel as jfres
from wave_tracer_tpu.polarization import mueller as jmueller
from wave_tracer_tpu.scene import Shape as JShape
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.scene.spectral import \
    build_spectral_sampler as jspectral
from wave_tracer_tpu.sensor import film as jfilm
from wave_tracer_tpu.sensor import response as jresponse
from wave_tracer_tpu.sensor import tonemap as jtonemap
from wave_tracer_tpu.spectrum import bake as jbake
from wave_tracer_tpu.spectrum import ior as jior
from wave_tracer_tpu.spectrum import spectra as jspectra
from wave_tracer_tpu.texture.texture import ConstantSpectrumTexture as JTex
from wave_tracer_tpu.wave import fraunhofer as jfr
from wave_tracer_tpu.wave import sourcing as jsourcing
from wave_tracer_tpu_torch.bsdf import device as tbsdf
from wave_tracer_tpu_torch.bsdf import profiles as tprof
from wave_tracer_tpu_torch.geometry import mesh as tmesh
from wave_tracer_tpu_torch.polarization import fresnel as tfres
from wave_tracer_tpu_torch.polarization import mueller as tmueller
from wave_tracer_tpu_torch.scene.bridge import scene_data_from_numpy
from wave_tracer_tpu_torch.scene.build import bake_scene_arrays
from wave_tracer_tpu_torch.scene.procedural import make_coverage_scene
from wave_tracer_tpu_torch.scene.spectral import \
    build_spectral_sampler as tspectral
from wave_tracer_tpu_torch.sensor import film as tfilm
from wave_tracer_tpu_torch.sensor import response as tresponse
from wave_tracer_tpu_torch.sensor import tonemap as ttonemap
from wave_tracer_tpu_torch.spectrum import bake as tbake
from wave_tracer_tpu_torch.spectrum import ior as tior
from wave_tracer_tpu_torch.spectrum import spectra as tspectra
from wave_tracer_tpu_torch.wave import fraunhofer as tfr
from wave_tracer_tpu_torch.wave import sourcing as tsourcing

cap_torch_threads()

RTOL = 1e-4
N = 2048
K0 = 2 * np.pi / (299792458.0 / 10e9)          # 10 GHz


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _close(a, b, rtol=RTOL, atol=0.0, err_msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _material_scene():
    """Five materials on five panels: diffuse; textured-roughness fractal
    SPM of a conductor; ITU glass with a gaussian profile, an exterior
    index and scale spectra; the coverage scene's concrete; a dirac SPM."""
    rough = JTex(jspectra.UniformSpectrum(0.3, 1.0, 1e8))
    mats = [
        jmodel.Material(bsdf=jmodel.DiffuseBSDF(
            reflectance=JTex(jspectra.UniformSpectrum(0.7, 1.0, 1e8)))),
        jmodel.Material(bsdf=jmodel.SpmBSDF(
            ior=jspectra.ComplexUniformSpectrum(0.2 + 3.0j),
            profile=jmodel.SurfaceProfile(type="fractal", gamma=2.5,
                                          roughness=rough)),
            twosided=True),
        jmodel.Material(bsdf=jmodel.SpmBSDF(
            ior=jior.ITUComplexSpectrum("glass"),
            ext_ior=jspectra.ComplexUniformSpectrum(1.2),
            profile=jmodel.SurfaceProfile(type="gaussian", sigma=0.05),
            reflection_scale=jspectra.UniformSpectrum(0.8, 1.0, 1e8),
            transmission_scale=jspectra.UniformSpectrum(0.6, 1.0, 1e8)),
            twosided=True),
        jmodel.Material(bsdf=jmodel.SpmBSDF(
            ior=jior.ITUComplexSpectrum("concrete"),
            profile=jmodel.SurfaceProfile(type="fractal", gamma=3.0,
                                          T=400.0, sigma=0.02)),
            twosided=True),
        jmodel.Material(bsdf=jmodel.SpmBSDF(
            ior=jior.ITUComplexSpectrum("brick"),
            profile=jmodel.SurfaceProfile(type="dirac"))),
    ]
    shapes = [JShape(jmesh.rectangle(1.0, JTransform.from_rows(
        [1, 0, 0, 2.0 * i, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1])), m)
        for i, m in enumerate(mats)]
    scene = jmake_coverage(8)
    scene.shapes = shapes + scene.shapes
    return scene


@pytest.fixture(scope="module")
def tables():
    jb = jbuild(_material_scene())
    arrays = _flatten(jb.data)
    return jb.data, scene_data_from_numpy(arrays, "cpu"), arrays


# ---------------------------------------------------------------- spectra

def test_discrete_spectrum_and_its_bake():
    r = np.random.default_rng(0)
    ks = np.sort(r.uniform(50.0, 900.0, 5))
    ws = r.uniform(0.1, 10.0, 5)
    js, ts = jspectra.DiscreteSpectrum(ks, ws), tspectra.DiscreteSpectrum(
        ks, ws)
    assert ts.is_discrete and js.is_discrete
    q = r.uniform(10.0, 1000.0, 64)
    np.testing.assert_array_equal(ts.eval(q), js.eval(q))
    for a, b in zip(ts.lines(), js.lines()):
        np.testing.assert_array_equal(a, b)
    assert ts.krange() == js.krange() and ts.power() == js.power()
    assert ts.mean_wavenumber() == js.mean_wavenumber()
    # baked among a continuous spectrum: the host arrays bit for bit, and a
    # lookup at each line returns its weight on both sides
    uni = (jspectra.UniformSpectrum(0.5, 1.0, 1e4),
           tspectra.UniformSpectrum(0.5, 1.0, 1e4))
    jt = jbake.bake_spectra([uni[0], js])
    tt = tbake.bake_spectra([uni[1], ts])
    for key in ("vals", "log_kmin", "log_kmax"):
        np.testing.assert_array_equal(tt[key], np.asarray(getattr(jt, key)))
    table = tbake.SpectrumTable(**{k: _t(v) for k, v in tt.items()})
    sid = np.array([1] * 5 + [0] * 3, np.int32)
    k = np.concatenate([ks, [5.0, 50.0, 500.0]]).astype(np.float32)
    got = table.eval(_t(sid, torch.int32), _t(k))
    _close(got, jt.eval(jnp.asarray(sid), jnp.asarray(k)), rtol=1e-5)
    _close(got[:5], ws, rtol=1e-5)


@pytest.mark.parametrize("name", ["concrete", "brick", "wood", "glass"])
def test_itu_complex_spectrum(name):
    """η of ITU-R P.2040 materials from 1 to 40 GHz (float64 on both
    sides): rtol 1e-5; Im η < 0 (the conductivity term) inside the
    table's band, 0 outside it (1 GHz itself rounds below the band)."""
    k = 2 * np.pi * np.geomspace(1e9, 40e9, 97) / tior.C_LIGHT
    te, je = tior.ITUComplexSpectrum(name).eval(k), \
        jior.ITUComplexSpectrum(name).eval(k)
    np.testing.assert_allclose(te, je, rtol=1e-5)
    band = te != 0
    assert band[1:].all()
    assert (te.imag[band] < 0).all() and (te.real[band] > 1).all()
    assert tior.EPS0 == jior.EPS0 and tior.C_LIGHT == jior.C_LIGHT
    assert tior.ITU_P2040_TABLE3 == jior.ITU_P2040_TABLE3


def test_bake_complex():
    """The host bake bit for bit (ITU, uniform and tabulated spectra), and
    η(k) of the device table at seeded wavenumbers at rtol 1e-4."""
    nodes = np.array([100.0, 300.0, 700.0])
    jspecs = [jior.ITUComplexSpectrum("concrete"),
              jspectra.ComplexUniformSpectrum(0.2 + 3.0j),
              jspectra.ComplexTabulatedSpectrum(nodes, [1.5, 1.7, 1.6],
                                                [0.0, -0.1, -0.3])]
    tspecs = [tior.ITUComplexSpectrum("concrete"),
              tspectra.ComplexUniformSpectrum(0.2 + 3.0j),
              tspectra.ComplexTabulatedSpectrum(nodes, [1.5, 1.7, 1.6],
                                                [0.0, -0.1, -0.3])]
    q = np.geomspace(50.0, 900.0, 33)
    for a, b in zip(tspecs, jspecs):
        np.testing.assert_array_equal(a.eval(q), b.eval(q))
    jt, tt = jbake.bake_complex(jspecs), tbake.bake_complex(tspecs)
    for key in ("n", "kappa", "log_kmin", "log_kmax"):
        np.testing.assert_array_equal(tt[key], np.asarray(getattr(jt, key)))
    table = tbake.ComplexSpectrumTable(**{k: _t(v) for k, v in tt.items()})
    r = np.random.default_rng(1)
    cid = r.integers(0, 3, N).astype(np.int32)
    k = r.uniform(20.0, 1000.0, N).astype(np.float32)
    got = table.eval(_t(cid, torch.int32), _t(k))
    assert got.dtype == torch.complex64
    _close(got, jt.eval(jnp.asarray(cid), jnp.asarray(k)), atol=1e-6)


def test_spectral_sampler_with_discrete_lines():
    """The per-sensor tables for a line transmitter seen through a line
    sensitivity (the coverage scene) and through a continuous one, and a
    continuous emitter seen through a line sensitivity: bit for bit."""
    line = (jspectra.DiscreteSpectrum([K0], [100.0]),
            tspectra.DiscreteSpectrum([K0], [100.0]))
    sens = (jspectra.DiscreteSpectrum([K0, 1.1 * K0], [1.0, 0.5]),
            tspectra.DiscreteSpectrum([K0, 1.1 * K0], [1.0, 0.5]))
    flat = (jspectra.UniformSpectrum(2.0, 100.0, 400.0),
            tspectra.UniformSpectrum(2.0, 100.0, 400.0))

    class Em:
        def __init__(self, s):
            self.spectrum = s

    for e, s in ((line, sens), (line, flat), (flat, sens)):
        j = jspectral([Em(e[0])], s[0])
        t = tspectral([Em(e[1])], s[1])
        for f in dataclasses.fields(j):
            np.testing.assert_array_equal(t[f.name],
                                          np.asarray(getattr(j, f.name)),
                                          err_msg=f.name)


def test_responses_and_tonemap():
    r = np.random.default_rng(2)
    k = r.uniform(100.0, 400.0, 64).astype(np.float32)
    jt = jbake.bake_spectra([jspectra.UniformSpectrum(0.5, 100.0, 400.0),
                             jspectra.UniformSpectrum(0.25, 100.0, 400.0)])
    tt = tbake.SpectrumTable(**{f.name: _t(np.asarray(getattr(jt, f.name)))
                                for f in dataclasses.fields(jt)})
    cases = [
        dict(type="monochromatic", spectrum=(
            jspectra.DiscreteSpectrum([K0], [1.0]),
            tspectra.DiscreteSpectrum([K0], [1.0])), rows=None),
        dict(type="monochromatic", spectrum=(
            jspectra.UniformSpectrum(0.5, 100.0, 400.0),
            tspectra.UniformSpectrum(0.5, 100.0, 400.0)), rows=[0]),
        dict(type="multichannel", spectrum=None, rows=[0, 1]),
        dict(type="XYZ", spectrum=None, rows=None),
    ]
    for c in cases:
        sj, st_ = c["spectrum"] or (None, None)
        jr = jresponse.Response(type=c["type"], spectrum=sj,
                                channel_spectra=[None, None]
                                if c["type"] == "multichannel" else [])
        tr = tresponse.Response(type=c["type"], spectrum=st_,
                                channel_spectra=[None, None]
                                if c["type"] == "multichannel" else [])
        assert tr.channels == jr.channels
        rows = c["rows"]
        got = tr.sensitivities(_t(k), tt, rows)
        want = jr.sensitivities(
            jnp.asarray(k), jt, None if rows is None else
            [jnp.full(k.shape, x, jnp.int32) for x in rows])
        _close(got, want, rtol=1e-5, err_msg=c["type"])
    img = r.uniform(0.0, 1e-5, (8, 8, 1)) ** 3
    for kw in (dict(type="dB", db_min=-120, db_max=-40),
               dict(type="gamma"), dict(type="sRGB")):
        np.testing.assert_array_equal(ttonemap.Tonemap(**kw).apply(img),
                                      jtonemap.Tonemap(**kw).apply(img))


# --------------------------------------------------------------- profiles

def _params(pkg, ptype, r, n, k):
    gamma = r.uniform(2.2, 4.0, n).astype(np.float32)
    T = r.uniform(5.0, 800.0, n).astype(np.float32)
    sigmah = r.uniform(0.0, 0.05, n).astype(np.float32)
    if pkg == "jax":
        return jprof.make_params(jnp.full((n,), ptype, jnp.int32), None,
                                 jnp.asarray(gamma), jnp.asarray(k),
                                 T_direct=jnp.asarray(T),
                                 sigmah=jnp.asarray(sigmah))
    return tprof.make_params(torch.full((n,), ptype, dtype=torch.int32),
                             None, _t(gamma), _t(k), T_direct=_t(T),
                             sigmah=_t(sigmah))


@pytest.mark.parametrize("ptype", [tprof.PROFILE_DIRAC,
                                   tprof.PROFILE_GAUSSIAN,
                                   tprof.PROFILE_FRACTAL])
def test_profiles(ptype):
    """psd, sample and pdf at GHz wavenumbers. The draws include u → 1
    (the floor under 1 − M·u) and grazing wi (the φ_max clip). Valid
    flags equal; the valid draws' directions at rtol 1e-4 / atol 1e-5,
    densities at rtol 1e-4 / atol 1e-6 of their largest."""
    r = np.random.default_rng(10 + ptype)
    k = r.uniform(20.0, 840.0, N).astype(np.float32)
    pj = _params("jax", ptype, np.random.default_rng(3), N, k)
    pt = _params("torch", ptype, np.random.default_rng(3), N, k)
    _close(pt.sigma2_norm, pj.sigma2_norm)
    wi = _unit(r, N)
    wi[: N // 8, 2] = r.uniform(0.0, 1e-3, N // 8)       # grazing
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    u2 = r.random((N, 2)).astype(np.float32)
    u2[-N // 8:, 0] = 1.0 - r.uniform(0.0, 1e-6, N // 8)   # u → 1
    u2[-N // 8:, 0] = np.minimum(u2[-N // 8:, 0], np.float32(1 - 2 ** -24))
    z2 = r.uniform(0.0, 0.5, N).astype(np.float32)
    _close(tprof.psd(pt, _t(z2), _t(k)), jprof.psd(pj, jnp.asarray(z2),
                                                    jnp.asarray(k)),
           atol=1e-6 * float(np.abs(jprof.psd(pj, jnp.asarray(z2),
                                              jnp.asarray(k))).max()))
    wo_t, pdf_t, psd_t, ok_t = tprof.sample(pt, _t(wi), _t(k), _t(u2))
    wo_j, pdf_j, psd_j, ok_j = jprof.sample(pj, jnp.asarray(wi),
                                            jnp.asarray(k), jnp.asarray(u2))
    ok = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok)
    assert ok.any() or ptype == tprof.PROFILE_DIRAC
    # directions of the valid draws (the BSDF discards the others; near
    # the horizon, where the invalid ones sit, z = sqrt(1 − |wo⊥|²) turns
    # last-bit differences of 1 − M·u into 1e-2 of z)
    _close(wo_t[ok], np.asarray(wo_j)[ok], atol=1e-5)
    for a, b in ((pdf_t, pdf_j), (psd_t, psd_j)):
        _close(a, b, atol=1e-6 * float(np.abs(np.asarray(b)).max() + 1e-30))
    assert torch.isfinite(wo_t).all() and torch.isfinite(pdf_t).all()
    wo = _unit(r, N)
    wo[:, 2] = np.abs(wo[:, 2]) * np.sign(wi[:, 2])
    pj_ = jprof.pdf(pj, jnp.asarray(wi), jnp.asarray(wo), jnp.asarray(k))
    _close(tprof.pdf(pt, _t(wi), _t(wo), _t(k)), pj_,
           atol=1e-6 * float(np.abs(np.asarray(pj_)).max() + 1e-30))
    _close(tprof.alpha_specular(pt, _t(wi[:, 2]), _t(wo[:, 2]), _t(k)),
           jprof.alpha_specular(pj, jnp.asarray(wi[:, 2]),
                                jnp.asarray(wo[:, 2]), jnp.asarray(k)),
           atol=1e-7)


# ---------------------------------------------------------------- fresnel

def _fresnel_cases():
    """(eta12 complex64, w, n): normal and grazing incidence, total
    internal reflection (real η ratio > 1 from the back... and front),
    the ITU conductivity sign (Im η < 0), Im η = −0.0 and +0.0, and
    random directions on both sides."""
    r = np.random.default_rng(4)
    n_case = 64
    etas = np.concatenate([
        np.full(n_case, 1 / (2.29 - 0.107j)),       # air → concrete
        np.full(n_case, 2.29 - 0.107j),             # concrete → air (TIR)
        np.full(n_case, complex(1.5, -0.0)),        # Im η = −0.0
        np.full(n_case, complex(1.5, 0.0)),         # Im η = +0.0
        np.full(n_case, 1 / complex(0.2, 3.0)),     # conductor
        r.uniform(0.3, 3.0, n_case) - 1j * r.uniform(0.0, 0.5, n_case),
    ]).astype(np.complex64)
    M = len(etas)
    w = _unit(r, M)
    w[0::8] = [0.0, 0.0, 1.0]                        # normal
    w[1::8] = [1.0, 0.0, 0.0]                        # grazing (exact)
    w[2::8] = [0.999999, 0.0, 0.0014142]             # nearly grazing
    w[3::8] = [0.0, 0.0, -1.0]                       # normal, back side
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    n = np.zeros_like(w)
    n[:, 2] = 1.0
    return etas, w, n


def _cplx(x):
    return torch.from_numpy(np.asarray(x))


def test_fresnel_branch_cuts():
    """`fresnel` and `fresnel_reflection_conductor` at rtol 1e-4 / atol
    1e-6 (amplitudes are O(1)); TIR and grazing flags equal; the torch
    complex square root takes the JAX branch, signs of zero included."""
    etas, w, n = _fresnel_cases()
    ft = tfres.fresnel(_cplx(etas), _t(w), _t(n))
    fj = jfres.fresnel(jnp.asarray(etas), jnp.asarray(w), jnp.asarray(n))
    np.testing.assert_array_equal(ft["tir"].numpy(), np.asarray(fj["tir"]))
    assert ft["tir"].any() and (~ft["tir"]).any()
    for key in ("t", "eta", "Z", "rs", "rp", "ts", "tp", "Ts", "Tp"):
        _close(ft[key], fj[key], atol=1e-6, err_msg=key)
    rt = tfres.fresnel_reflection_conductor(_cplx(etas), _t(w), _t(n))
    rj = jfres.fresnel_reflection_conductor(jnp.asarray(etas),
                                            jnp.asarray(w), jnp.asarray(n))
    for a, b in zip(rt, rj):
        _close(a, b, atol=1e-6)
        # the imaginary parts' signs agree wherever they are not ~0
        big = np.abs(np.asarray(b).imag) > 1e-5
        np.testing.assert_array_equal(np.sign(a.numpy().imag[big]),
                                      np.sign(np.asarray(b).imag[big]))
    # the oriented refraction itself
    dt = tfres.refract_dir(_t(etas.real), _t(w), _t(n))
    dj = jfres.refract_dir(jnp.asarray(etas.real), jnp.asarray(w),
                           jnp.asarray(n))
    for a, b in zip(dt, dj):
        if b.dtype == jnp.bool_:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, atol=1e-6)


def test_mueller_jones():
    r = np.random.default_rng(5)
    a_s = (r.normal(size=N) + 1j * r.normal(size=N)).astype(np.complex64)
    a_p = (r.normal(size=N) + 1j * r.normal(size=N)).astype(np.complex64)
    sc = r.uniform(0.0, 2.0, N).astype(np.float32)
    Mt = tmueller.from_jones_sp(_cplx(a_s), _cplx(a_p), _t(sc))
    Mj = jmueller.from_jones_sp(jnp.asarray(a_s), jnp.asarray(a_p),
                                jnp.asarray(sc))
    _close(Mt, Mj, atol=1e-6)
    S = r.normal(size=(N, 4)).astype(np.float32)
    _close(tmueller.apply(Mt, _t(S)), jmueller.apply(Mj, jnp.asarray(S)),
           atol=1e-5)
    _close(tmueller.compose(Mt, Mt), jmueller.compose(Mj, Mj), atol=1e-4)
    _close(tmueller.scaled(_t(sc)), jmueller.scaled(jnp.asarray(sc)))


# ------------------------------------------------------------- SPM lobe

def _lobe_inputs(data_j, seed):
    r = np.random.default_rng(seed)
    M = data_j.tables.materials.pack.shape[0]
    mat = r.integers(-1, M, N).astype(np.int32)
    wi = _unit(r, N)
    wi[: N // 16] = [0.0, 0.0, 1.0]
    wo = _unit(r, N)
    k = r.uniform(20.0, 840.0, N).astype(np.float32)
    k[N // 2:] = np.float32(K0)
    uv = r.random((N, 2)).astype(np.float32)
    u4 = r.random((N, 4)).astype(np.float32)
    return mat, wi, wo, uv, k, u4


def test_spm_sample(tables):
    """The SPM lobe of `sample` (with the diffuse and null rows around it)
    on the bridged JAX bake: flags equal; wo at atol 1e-5, pdf and Mw at
    rtol 1e-4 with an absolute floor of 1e-5 of each lane's largest Mw
    entry (pdf: of its largest)."""
    data_j, data_t, _ = tables
    assert data_t.tables.materials.has_spm
    mat, wi, _, uv, k, u4 = _lobe_inputs(data_j, 6)
    bj = jbsdf.sample(data_j.tables, jnp.asarray(mat), jnp.asarray(wi),
                      jnp.asarray(uv), jnp.asarray(k), jnp.asarray(u4))
    bt = tbsdf.sample(data_t.tables, _t(mat, torch.int32), _t(wi), _t(uv),
                      _t(k), _t(u4))
    for key in ("specular", "refracted", "valid"):
        np.testing.assert_array_equal(getattr(bt, key).numpy(),
                                      np.asarray(getattr(bj, key)),
                                      err_msg=key)
    ok = np.asarray(bj.valid)
    assert ok.mean() > 0.5 and np.asarray(bj.refracted).any() \
        and np.asarray(bj.specular).any() \
        and (~np.asarray(bj.specular) & ok).any()
    _close(bt.wo[ok], np.asarray(bj.wo)[ok], atol=1e-5)
    _close(bt.eta, bj.eta, rtol=1e-5)
    _close(bt.pdf[ok], np.asarray(bj.pdf)[ok],
           atol=1e-5 * float(np.abs(np.asarray(bj.pdf)[ok]).max()))
    Mj = np.asarray(bj.Mw)[ok]
    floor = 1e-5 * np.abs(Mj).max((1, 2), keepdims=True)
    Mt = bt.Mw[ok].numpy()
    assert (np.abs(Mt - Mj) <= RTOL * np.abs(Mj) + floor).all()


def test_spm_eval_f(tables):
    """The SPM scatter lobe of `eval_f` (and its pdf), both hemispheres:
    rtol 1e-4 with an absolute floor of 1e-6 of the largest value."""
    data_j, data_t, _ = tables
    mat, wi, wo, uv, k, _ = _lobe_inputs(data_j, 7)
    Mj, pj = jbsdf.eval_f(data_j.tables, jnp.asarray(mat), jnp.asarray(wi),
                          jnp.asarray(wo), jnp.asarray(uv), jnp.asarray(k))
    Mt, pt = tbsdf.eval_f(data_t.tables, _t(mat, torch.int32), _t(wi),
                          _t(wo), _t(uv), _t(k))
    assert np.asarray(pj).max() > 0 and (np.asarray(Mj)[:, 0, 0] > 0).any()
    _close(Mt, Mj, atol=1e-6 * float(np.abs(np.asarray(Mj)).max()))
    _close(pt, pj, atol=1e-6 * float(np.abs(np.asarray(pj)).max()))


def test_bridge_and_own_bake_of_the_coverage_scene(tables):
    """The port's own bake of its coverage scene equals the JAX bake in
    every table the BVH order does not permute (materials, spectra,
    complex spectra, emitters, the spectral sampler); the geometry holds
    the same triangles; a dielectric row now loads (its lobe is ported)
    and a material type the port does not know raises at the bridge."""
    jb = jbuild(jmake_coverage(16))
    ja = _flatten(jb.data)
    ta, per_sensor = bake_scene_arrays(make_coverage_scene(16))
    for key in ta:
        if key.startswith(("tables.", "spectral.")) or key in (
                "emitters.pack", "emitters.power", "emitters.spec_id",
                "emitters.scene_radius"):
            np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)
    tris = np.sort(np.round(np.concatenate(
        [ta["geo.p0"], ta["geo.e1"], ta["geo.e2"]], 1), 5), axis=0)
    jtris = np.sort(np.round(np.concatenate(
        [ja["geo.p0"], ja["geo.e1"], ja["geo.e2"]], 1), 5), axis=0)
    np.testing.assert_allclose(tris, jtris, atol=1e-5)
    assert ta["edges.p0"].shape == ja["edges.p0"].shape
    np.testing.assert_array_equal(
        tmesh.cube(2.0).positions,
        np.asarray(jmesh.cube(2.0).positions))
    glass = dict(tables[2])
    pack = np.array(glass["tables.materials.pack"])
    pack[0, 0] = 1                          # a dielectric row
    glass["tables.materials.pack"] = pack
    assert scene_data_from_numpy(glass, "cpu").tables.materials \
        .has_dielectric
    pack = pack.copy()
    pack[0, 0] = 7                          # no such material type
    glass["tables.materials.pack"] = pack
    with pytest.raises(NotImplementedError, match="material type"):
        scene_data_from_numpy(glass, "cpu")


# ------------------------------------------------------ sensor and film

def test_virtual_plane_sensor():
    """intersect and sample_point of the coverage scene's plane, on seeded
    rays from above and below and seeded uniforms: flags equal, t and
    positions at rtol 1e-4 / atol 1e-4 (elements)."""
    js, ts = jmake_coverage(64).sensors[0], make_coverage_scene(64).sensors[0]
    assert ts.importance() == js.importance()
    r = np.random.default_rng(8)
    ro = r.uniform([-40, -5, -40], [40, 12, 40], (N, 3)).astype(np.float32)
    rd = _unit(r, N)
    out_t = ts.intersect(_t(ro), _t(rd))
    out_j = js.intersect(jnp.asarray(ro), jnp.asarray(rd))
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    assert out_t[2].any() and (~out_t[2]).any()
    inside = np.asarray(out_j[2])
    _close(out_t[0][inside], np.asarray(out_j[0])[inside], atol=1e-4)
    _close(out_t[1][inside], np.asarray(out_j[1])[inside], atol=1e-4)
    _close(out_t[3], out_j[3], atol=1e-7)
    u2 = r.random((N, 2)).astype(np.float32)
    pt_t = ts.sample_point(_t(u2))
    pt_j = js.sample_point(jnp.asarray(u2))
    _close(pt_t[0], pt_j[0], atol=1e-5)
    _close(pt_t[1], pt_j[1], atol=1e-5)
    assert pt_t[2] == pt_j[2]
    _close(pt_t[3], pt_j[3])


def test_splat_direct_gaussian():
    """One flat index_add_ against the JAX scatter: positions inside, on
    and beyond the film's edges, σ below and above the clip, masked and
    non-finite lanes; rtol 1e-4 / atol 1e-6 of the largest texel."""
    r = np.random.default_rng(9)
    H, W, C = 12, 16, 4
    pos = r.uniform(-2.0, 18.0, (N, 2)).astype(np.float32)
    sig = r.uniform(0.0, 3.0, N).astype(np.float32)
    vals = r.uniform(0.0, 1.0, (N, C)).astype(np.float32)
    vals[::97] = np.nan
    mask = r.random(N) < 0.8
    fj = jfilm.splat_direct_gaussian(jfilm.make_film(W, H, C, 0.25),
                                     jnp.asarray(pos), jnp.asarray(sig),
                                     jnp.asarray(vals), jnp.asarray(mask))
    ft = tfilm.splat_direct_gaussian(tfilm.make_film(W, H, C, 0.25),
                                     _t(pos), _t(sig), _t(vals),
                                     _t(mask, torch.bool))
    dj = np.asarray(fj.direct)
    assert np.isfinite(dj).all() and dj.max() > 0
    _close(ft.direct, dj, atol=1e-6 * dj.max())


# ---------------------------------------------------- wave and sourcing

def test_build_aperture_3d_curv(tables):
    """The Fraunhofer aperture of the bridged edges with a quadratic
    wavefront phase: every field at rtol 1e-4 with an absolute floor of
    1e-5 of its largest value; valid slots equal. Without curv, the
    amplitudes are real (the parent's result)."""
    data_j, data_t, _ = tables
    E = int(data_j.edges.count)
    r = np.random.default_rng(11)
    n, K = 512, 8
    idx = np.where(r.random((n, K)) < 0.8, r.integers(0, E, (n, K)),
                   -1).astype(np.int32)
    pick = np.asarray(data_j.edges.p0)[np.maximum(idx[:, 0], 0)]
    origin = (pick + r.normal(scale=0.3, size=(n, 3))).astype(np.float32)
    rd = _unit(r, n)
    fx = np.cross(rd, _unit(r, n))
    fx = (fx / np.linalg.norm(fx, axis=-1, keepdims=True)).astype(np.float32)
    fy = np.cross(rd, fx).astype(np.float32)
    sigma = r.uniform(0.05, 0.5, n).astype(np.float32)
    r_env = (3.0 * sigma).astype(np.float32)
    k = np.full(n, K0, np.float32)
    curv = (0.5 * k * (1 / r.uniform(1.0, 30.0, n)
                       + 1 / r.uniform(1.0, 30.0, n))).astype(np.float32)
    args_j = [jnp.asarray(x) for x in (idx, origin, rd, fx, fy, sigma,
                                       r_env, k)]
    args_t = [_t(idx, torch.int32)] + [_t(x) for x in (origin, rd, fx, fy,
                                                       sigma, r_env, k)]
    apj, sj = jfr.build_aperture_3d(data_j.edges, *args_j,
                                    curv=jnp.asarray(curv))
    apt, st = tfr.build_aperture_3d(data_t.edges, *args_t, curv=_t(curv))
    _close(st, sj)
    assert np.asarray(apj.valid).any()
    for name, val in apt.items():
        want = np.asarray(getattr(apj, name))
        if want.dtype == bool:
            np.testing.assert_array_equal(val.numpy(), want, err_msg=name)
        else:
            _close(val, want, atol=1e-5 * float(np.abs(want).max() + 1e-30),
                   err_msg=name)
    assert np.abs(np.asarray(apj.a_b).imag).max() > 0
    flat, _ = tfr.build_aperture_3d(data_t.edges, *args_t)
    assert float(flat.a_b.imag.abs().max()) == 0.0


def test_emitter_envelope(tables):
    """The elliptic envelope of freshly sourced emission beams (no
    integrator of either package calls it): rtol 1e-4."""
    data_j, data_t, _ = tables
    r = np.random.default_rng(12)
    n = 256
    e0 = np.zeros(n, np.int32)
    k = r.uniform(50.0, 800.0, n).astype(np.float32)
    wo = _unit(r, n)
    ej = jsourcing.emitter_envelope(data_j.emitters, jnp.asarray(e0),
                                    jnp.asarray(k), jnp.asarray(wo))
    et = tsourcing.emitter_envelope(data_t.emitters, _t(e0, torch.int32),
                                    _t(k), _t(wo))
    for name in ("x", "x0", "ta", "e"):
        _close(getattr(et, name), getattr(ej, name), atol=1e-7,
               err_msg=name)


# ------------------------------------------------- Fraunhofer forward

def test_trace_forward_fraunhofer_per_lane():
    """The Fraunhofer forward mode (the plt_bdpt t = 0 strategy: ASF
    redirects with the blocked-flux partition and the curvature phase)
    over 256 lanes of the bridged coverage scene, against the JAX trace:
    at least 94% of the lanes' crossing records agree at rtol 1e-4 (the
    RIS pick and the blocked-flux branch sit on float thresholds; the
    JAX package's own bound on lane flips between lowerings is 6%); no
    FSD-NEE connection on either side."""
    from test_torch_coverage_render import (FLIP_BOUND, crossing_agreement,
                                            trace_pair)
    j, t = trace_pair(fsd=True, fsd_mode="fraunhofer")
    assert j[2].sum() > 0
    assert crossing_agreement(j, t) >= 1 - FLIP_BOUND
    assert not j[6].any() and not t[6].any()


def test_fraunhofer_render_matches_jax_at_film_level():
    """render_scene of each package on the bridged scene under plt_bdpt
    (the Fraunhofer forward mode), 16×16 elements × 4 samples in one
    batch of 1,024 lanes, at the UTD render's film-level bars
    (test_torch_coverage_render.py::check_film)."""
    from test_torch_coverage_render import (RES, bridged_scenes, check_film,
                                            jrender, render_scene)
    _, jb, tb = bridged_scenes(integrator="plt_bdpt")
    jimg, jst = jrender(jb, spp=4, batch_lanes=1024)
    img, st = render_scene(tb, spp=4, device="cpu", pool_lanes=1024)
    assert st["mode"] == jst["mode"] == "forward-wave"
    assert img.shape == jimg.shape == (RES, RES, 1)
    assert np.isfinite(img).all() and (img > 0).mean() > 0.5
    check_film(img, jimg)
