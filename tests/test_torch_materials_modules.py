"""Port parity for the modules of the materials slice: each
wave_tracer_tpu_torch function against its JAX twin on the same seeded
numpy inputs, in f32.

Tolerances, each stated at its assert:
  * the dielectric lobe (`sample`, `eval_f`), spot and directional
    emitters and normal-mapped frames at rtol 1e-4 (transcendentals,
    complex square roots and divisions round differently in the last bits
    in the two frameworks);
  * texture lookups (RGB, checkerboard, bitmap at several footprints) at
    rtol 1e-5;
  * `MaterialTable.resolve`, the opacity mask's pass-through draws and
    every boolean or integer output bit for bit;
  * the host bakes (spectra, textures with their mip atlas, materials,
    emitters) bit for bit, and the new spectra's baked tables too.

The device tables come from the JAX bake of the materials box
(`jmake_materials_box`, the JAX-API twin of
scene/procedural.py::make_materials_box_scene), flattened to numpy and
uploaded through the port's bridge, so both sides read the same tables.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_render import make_box_scene as jmake_box
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.bsdf import device as jbsdf
from wave_tracer_tpu.bsdf import model as jmodel
from wave_tracer_tpu.core.transform import Transform as JTransform
from wave_tracer_tpu.emitter import model as jemodel
from wave_tracer_tpu.emitter import table as jetab
from wave_tracer_tpu.geometry import mesh as jmesh
from wave_tracer_tpu.math import frame as jframe
from wave_tracer_tpu.scene import Shape as JShape
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.scene.spectral import \
    build_spectral_sampler as jspectral
from wave_tracer_tpu.spectrum import bake as jbake
from wave_tracer_tpu.spectrum import spectra as jspectra
from wave_tracer_tpu.texture import texture as jtex
from wave_tracer_tpu_torch.bsdf import device as tbsdf
from wave_tracer_tpu_torch.emitter import table as tetab
from wave_tracer_tpu_torch.math import frame as tframe
from wave_tracer_tpu_torch.scene.bridge import scene_data_from_numpy
from wave_tracer_tpu_torch.scene.build import bake_scene_arrays
from wave_tracer_tpu_torch.scene.procedural import make_materials_box_scene
from wave_tracer_tpu_torch.scene.spectral import \
    build_spectral_sampler as tspectral
from wave_tracer_tpu_torch.spectrum import bake as tbake
from wave_tracer_tpu_torch.spectrum import spectra as tspectra
from wave_tracer_tpu_torch.texture import texture as ttex

cap_torch_threads()

N = 2048
K_GREEN = 2 * np.pi / 550e-9


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


def jmake_materials_box(res=32, spp=8, seed=7):
    """The JAX-API twin of make_materials_box_scene (same shapes, order,
    materials, textures and emitters, the same seeded images)."""
    scene = jmake_box(res=res, spp=spp)
    floor, _, back, _, right = scene.shapes[:5]
    rng = np.random.default_rng(seed)
    floor.material = jmodel.Material(bsdf=jmodel.DiffuseBSDF(
        reflectance=jtex.CheckerboardTexture(
            rgb_a=(0.8, 0.8, 0.8), rgb_b=(0.2, 0.2, 0.2),
            uv_scale=(8.0, 8.0))), name="checker")
    back.material = jmodel.Material(bsdf=jmodel.DiffuseBSDF(
        reflectance=jtex.BitmapTexture(data=rng.uniform(
            0.1, 0.9, (256, 256, 3)).astype(np.float32))), name="bitmap")
    nmap = np.concatenate([rng.uniform(0.35, 0.65, (64, 64, 2)),
                           np.ones((64, 64, 1))], axis=-1)
    conductor = jmodel.SpmBSDF(
        ior=jspectra.ComplexUniformSpectrum(0.27 + 2.9j),
        profile=jmodel.SurfaceProfile(type="gaussian", roughness=(
            jtex.ConstantSpectrumTexture(
                jspectra.UniformSpectrum(0.3, 1.0, 1e9)))))
    k_mid = 2 * math.pi / 550e-9
    right.material = jmodel.Material(bsdf=jmodel.CompositeBSDF(bins=[
        (jspectra.K_VISIBLE_MIN, k_mid, jmodel.Material(
            bsdf=jmodel.DiffuseBSDF(
                reflectance=jtex.ConstantRGBTexture((0.1, 0.7, 0.2))),
            normalmap=jtex.BitmapTexture(data=nmap.astype(np.float32)),
            name="green_bumpy")),
        (k_mid, jspectra.K_VISIBLE_MAX, jmodel.Material(
            bsdf=conductor, twosided=True, name="rough_metal"))]),
        name="composite")
    scene.shapes += [
        JShape(jmesh.sphere([0.35, 0.45, 0.1], 0.42, tessellation=48),
               jmodel.Material(bsdf=jmodel.DielectricBSDF(
                   ior=jspectra.ComplexUniformSpectrum(1.5)), name="glass")),
        JShape(jmesh.sphere([-0.5, 0.35, -0.45], 0.34, tessellation=48),
               jmodel.Material(bsdf=conductor, name="rough_metal_sphere")),
        JShape(jmesh.rectangle(0.6, JTransform.from_rows(
            [1, 0, 0, -0.45, 0, 1, 0, 1.25, 0, 0, 1, 0.3, 0, 0, 0, 1])),
            jmodel.Material(bsdf=jmodel.DiffuseBSDF(
                reflectance=jtex.ConstantRGBTexture((0.6, 0.5, 0.3))),
                twosided=True, opacity=jtex.CheckerboardTexture(
                    rgb_a=(1.0, 1.0, 1.0), rgb_b=(0.0, 0.0, 0.0),
                    uv_scale=(4.0, 4.0)), name="masked"))]
    k_nodes = 2 * math.pi / np.array([700e-9, 600e-9, 500e-9, 400e-9])
    src, dst = np.array([-0.6, 1.75, 0.7]), np.array([0.35, 0.45, 0.1])
    scene.emitters.append(jemodel.SpotEmitter(
        spectrum=jspectra.PiecewiseLinearSpectrum(
            k_nodes, np.array([1.0, 3.0, 2.0, 0.5]) * 2e-13),
        position=src, direction=(dst - src) / np.linalg.norm(dst - src),
        beam_width=math.radians(12.0), cutoff=math.radians(20.0)))
    return scene


@pytest.fixture(scope="module")
def tables():
    """(JAX SceneData, the port's SceneData bridged from it, the port's
    own bake of its twin scene)."""
    jb = jbuild(jmake_materials_box(res=16, spp=2))
    arrays = _flatten(jb.data)
    return jb.data, scene_data_from_numpy(arrays, "cpu"), arrays, \
        bake_scene_arrays(make_materials_box_scene(res=16, spp=2))[0]


def _close(a, b, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_own_bake_matches_jax_bake(tables):
    """The port's own bake of its twin scene holds the JAX bake's tables
    bit for bit (the mip atlas, the composite bins, the spot row), and its
    triangle soup and edge count agree."""
    _, _, ja, ta = tables
    for key in ta:
        if key.startswith(("tables.", "spectral.")) or key in (
                "emitters.pack", "emitters.power", "emitters.spec_id",
                "emitters.scene_radius", "emitters.etype"):
            np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)
    assert ta["geo.p0"].shape == ja["geo.p0"].shape == (10254, 3)
    assert ta["edges.p0"].shape == ja["edges.p0"].shape
    assert ta["edges.p0"].shape[0] <= 2048


SPECTRA = [
    lambda m: m.PiecewiseLinearSpectrum(
        2 * np.pi / np.array([700e-9, 550e-9, 400e-9]), [1.0, 3.0, 0.5]),
    lambda m: m.BinnedSpectrum(
        2 * np.pi / np.array([700e-9, 600e-9, 500e-9, 400e-9]),
        [0.5, 2.0, 1.0]),
    lambda m: m.GaussianSpectrum(K_GREEN, 0.05 * K_GREEN, 2.0),
    lambda m: m.AnalyticSpectrum("1 + 0.5*sin(lambda_nm/40)"),
    lambda m: m.ScaledSpectrum(m.BlackbodySpectrum(4000.0, 1e-12), 3.0),
    lambda m: m.CompositeSpectrum(bins=[
        (m.K_VISIBLE_MIN, K_GREEN, m.UniformSpectrum(1.0, 1.0, 1e9)),
        (K_GREEN, m.K_VISIBLE_MAX, m.GaussianSpectrum(1.3 * K_GREEN,
                                                      0.1 * K_GREEN))]),
    lambda m: m.CompositeSpectrum(bins=[
        (1e7, 1.2e7, m.DiscreteSpectrum([1.05e7, 1.3e7], [2.0, 1.0])),
        (1.2e7, 2e7, m.DiscreteSpectrum([1.5e7], [4.0]))]),
]


@pytest.mark.parametrize("make", SPECTRA, ids=[
    "piecewise_linear", "binned", "gaussian", "analytic", "scaled",
    "composite", "composite_discrete"])
def test_spectra_bake_and_sampler(make):
    """The new spectra: host evaluations, power and mean wavenumber at
    rtol 1e-12 (float64 numpy on both sides), baked tables and the
    spectral sampler's tables bit for bit, and sampled wavenumbers equal
    (continuous emission by its CDF, discrete by its line pmf)."""
    js, ts = make(jspectra), make(tspectra)
    k = np.geomspace(tspectra.K_VISIBLE_MIN * 0.8,
                     tspectra.K_VISIBLE_MAX * 1.2, 257)
    np.testing.assert_allclose(ts.eval(k), js.eval(k), rtol=1e-12)
    assert ts.krange() == js.krange()
    assert ts.is_discrete == js.is_discrete
    if not ts.is_discrete:
        np.testing.assert_allclose(ts.power(), js.power(), rtol=1e-12)
        np.testing.assert_allclose(ts.mean_wavenumber(),
                                   js.mean_wavenumber(), rtol=1e-12)
    jt = _flatten(jbake.bake_spectra([js]))
    tt = tbake.bake_spectra([ts])
    for key in tt:
        np.testing.assert_array_equal(tt[key], jt[key], err_msg=key)
    from wave_tracer_tpu.emitter.model import PointEmitter as JPoint
    from wave_tracer_tpu_torch.emitter.model import PointEmitter as TPoint
    sens_j = jspectra.UniformSpectrum(1.0, 1.0, 1e9)
    sens_t = tspectra.UniformSpectrum(1.0, 1.0, 1e9)
    jsp = jspectral([JPoint(spectrum=js)], sens_j)
    tsp = tspectral([TPoint(spectrum=ts)], sens_t)
    for key in tsp:
        np.testing.assert_array_equal(tsp[key], np.asarray(getattr(jsp, key)),
                                      err_msg=key)
    from wave_tracer_tpu_torch.scene.bridge import spectral_from_numpy
    sp = spectral_from_numpy(tsp, "cpu")
    u = np.random.default_rng(3).random(N).astype(np.float32)
    e = np.zeros(N, np.int32)
    kj, pj = jsp.sample_k(jnp.asarray(e), jnp.asarray(u))
    kt, pt = sp.sample_k(torch.as_tensor(e), torch.as_tensor(u))
    _close(kt, kj, 1e-6)
    _close(pt, pj, 1e-5)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)      # copies


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _rows(data_j):
    """Material rows of the materials box by role."""
    pack = np.asarray(data_j.tables.materials.pack)
    comp = np.asarray(data_j.tables.materials.comp_child)
    return dict(glass=int(np.nonzero(pack[:, 0] == 1)[0][0]),
                composite=int(np.nonzero(comp[:, 0] >= 0)[0][0]),
                masked=int(np.nonzero(pack[:, 4] >= 0)[0][0]),
                spm=int(np.nonzero(pack[:, 0] == 2)[0][-1]))


def _lobe_inputs(data_j, seed, mat=None):
    """Seeded lanes: every material row (or `mat`) and -1, directions on
    both sides with grazing ones, visible wavenumbers (and the composite's
    bin edges), uvs that wrap, uniforms and mip footprints."""
    r = np.random.default_rng(seed)
    M = data_j.tables.materials.pack.shape[0]
    mats = r.integers(-1, M, N).astype(np.int32) if mat is None \
        else np.full(N, mat, np.int32)
    wi = _unit(r, N)
    wi[: N // 8, 2] = r.choice([1e-4, -1e-4, 2e-3, -2e-3], N // 8)
    wi[: N // 8] /= np.linalg.norm(wi[: N // 8], axis=-1, keepdims=True)
    wo = _unit(r, N)
    k = r.uniform(tspectra.K_VISIBLE_MIN, tspectra.K_VISIBLE_MAX,
                  N).astype(np.float32)
    k[:8] = np.float32(K_GREEN)
    uv = r.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    u4 = r.random((N, 4)).astype(np.float32)
    duv = np.exp(r.uniform(np.log(1e-5), 0.0, N)).astype(np.float32)
    return mats, wi, wo, uv, k, u4, duv


def _check_sample(bt, bj, min_valid=0.5):
    """Flags equal; wo at atol 1e-5, pdf and Mw at rtol 1e-4 with an
    absolute floor of 1e-5 of each lane's largest Mw entry (pdf: of the
    largest pdf)."""
    for key in ("specular", "refracted", "valid"):
        np.testing.assert_array_equal(getattr(bt, key).numpy(),
                                      np.asarray(getattr(bj, key)),
                                      err_msg=key)
    ok = np.array(bj.valid)                  # writable: it indexes torch
    assert ok.mean() > min_valid
    _close(bt.wo[ok], np.array(bj.wo)[ok], 0.0, atol=1e-5)
    _close(bt.eta, bj.eta, 1e-5)
    _close(bt.pdf[ok], np.asarray(bj.pdf)[ok], 1e-4,
           atol=1e-5 * float(np.abs(np.asarray(bj.pdf)[ok]).max()))
    Mj = np.asarray(bj.Mw)[ok]
    floor = 1e-5 * np.abs(Mj).max((1, 2), keepdims=True)
    assert (np.abs(bt.Mw[ok].numpy() - Mj) <= 1e-4 * np.abs(Mj) + floor).all()


def test_dielectric_sample_and_eval(tables):
    """The dielectric lobe alone: total internal reflection (wi inside
    the glass), grazing lanes, both picks; at the tolerances of
    _check_sample. Its eval_f is a delta: zero, as in JAX."""
    data_j, data_t, _, _ = tables
    assert data_t.tables.materials.has_dielectric
    mat, wi, wo, uv, k, u4, duv = _lobe_inputs(data_j, 11,
                                               _rows(data_j)["glass"])
    bj = jax_sample(data_j.tables, jnp.asarray(mat), jnp.asarray(wi),
                    jnp.asarray(uv), jnp.asarray(k), jnp.asarray(u4))
    bt = tbsdf.sample(data_t.tables, _t(mat, torch.int32), _t(wi), _t(uv),
                      _t(k), _t(u4))
    _check_sample(bt, bj)
    inside = wi[:, 2] < 0
    sin2 = 1.0 - wi[:, 2] ** 2
    tir = inside & (sin2 * 1.5 ** 2 > 1.0)
    refr = bt.refracted.numpy()
    assert tir.any() and not refr[tir].any() and refr[~tir].any()
    assert (bt.specular.numpy() & bt.valid.numpy()).mean() > 0.9
    Mt, pt = tbsdf.eval_f(data_t.tables, _t(mat, torch.int32), _t(wi),
                          _t(wo), _t(uv), _t(k))
    assert not Mt.any() and not pt.any()


def jax_sample(*args, duv=None):
    import jax
    return jax.jit(jbsdf.sample)(*args, duv)


def test_all_rows_sample_and_eval(tables):
    """Every row of the materials box (diffuse with RGB, checkerboard and
    bitmap reflectances read through the mip footprint, dielectric,
    surface_spm, the composite resolved per lane, the masked panel, null)
    through `sample` and `eval_f`, as the JAX package's compiled kernels
    compute them, at the tolerances of _check_sample (eval_f: rtol 1e-4
    with an absolute floor of 1e-6 of the largest value)."""
    import jax
    data_j, data_t, _, _ = tables
    mat, wi, wo, uv, k, u4, duv = _lobe_inputs(data_j, 12)
    bj = jax_sample(data_j.tables, jnp.asarray(mat), jnp.asarray(wi),
                    jnp.asarray(uv), jnp.asarray(k), jnp.asarray(u4),
                    duv=jnp.asarray(duv))
    bt = tbsdf.sample(data_t.tables, _t(mat, torch.int32), _t(wi), _t(uv),
                      _t(k), _t(u4), _t(duv))
    _check_sample(bt, bj, min_valid=0.4)
    Mj, pj = jax.jit(jbsdf.eval_f)(
        data_j.tables, jnp.asarray(mat), jnp.asarray(wi), jnp.asarray(wo),
        jnp.asarray(uv), jnp.asarray(k), jnp.asarray(duv))
    Mt, pt = tbsdf.eval_f(data_t.tables, _t(mat, torch.int32), _t(wi),
                          _t(wo), _t(uv), _t(k), _t(duv))
    assert np.asarray(pj).max() > 0 and (np.asarray(Mj)[:, 0, 0] > 0).any()
    _close(Mt, Mj, 1e-4, atol=1e-6 * float(np.abs(np.asarray(Mj)).max()))
    _close(pt, pj, 1e-4, atol=1e-6 * float(np.abs(np.asarray(pj)).max()))


def test_opacity_mask(tables):
    """The masked panel: the pass-through draw bit for bit against the
    compiled JAX kernel, on lanes whose mask uniform sits within a few
    ulps of the opacity, and on random lanes; the uniform itself equals
    XLA's fused rounding on 2^16 lanes; eval_f scales by the opacity."""
    import jax
    data_j, data_t, _, _ = tables
    row = _rows(data_j)["masked"]
    mat, wi, wo, uv, k, u4, _ = _lobe_inputs(data_j, 13, row)
    wi[:, 2] = np.abs(wi[:, 2])
    tex = int(np.asarray(data_j.tables.materials.pack)[row, 4])
    op = np.clip(np.asarray(jtex.eval_texture_scalar(
        data_j.tables.textures, data_j.tables.spectra,
        jnp.full((N,), tex, jnp.int32), jnp.asarray(uv), jnp.asarray(k))),
        0.0, 1.0).astype(np.float32)
    # half the lanes: u0 solved so the mix lands a few ulps off the
    # opacity (u3 fixed), where a rounding difference would flip the draw
    h = N // 2
    u4[:h, 3] = 0.5
    target = (op[:h] - np.float32(0.5) * np.float32(0.381966)) % 1.0
    u0 = (target / np.float32(0.618034)).astype(np.float32)
    steps = np.random.default_rng(5).integers(-3, 4, h)
    u4[:h, 0] = np.clip(u0 + steps * np.spacing(u0), 0.0,
                        np.float32(1.0) - np.spacing(np.float32(1.0)))
    bj = jax_sample(data_j.tables, jnp.asarray(mat), jnp.asarray(wi),
                    jnp.asarray(uv), jnp.asarray(k), jnp.asarray(u4))
    bt = tbsdf.sample(data_t.tables, _t(mat, torch.int32), _t(wi), _t(uv),
                      _t(k), _t(u4))
    through_j = np.asarray(bj.specular) & ~np.asarray(bj.refracted) \
        & np.all(np.isclose(np.asarray(bj.wo), -wi), -1)
    assert 0.2 < through_j.mean() < 0.8
    _check_sample(bt, bj)
    u = np.random.default_rng(6).random((1 << 16, 4)).astype(np.float32)
    mix_j = jax.jit(lambda u: (u[..., 0] * 0.618034
                               + u[..., 3] * 0.381966) % 1.0)(u)
    np.testing.assert_array_equal(tbsdf.mask_uniform(_t(u)).numpy(),
                                  np.asarray(mix_j))
    Mt, pt = tbsdf.eval_f(data_t.tables, _t(mat, torch.int32), _t(wi),
                          _t(wo), _t(uv), _t(k))
    Mj, pj = jbsdf.eval_f(data_j.tables, jnp.asarray(mat), jnp.asarray(wi),
                          jnp.asarray(wo), jnp.asarray(uv), jnp.asarray(k))
    assert (np.asarray(pj) == 0).any() and (np.asarray(pj) > 0).any()
    _close(Mt, Mj, 1e-4, atol=1e-6 * float(np.abs(np.asarray(Mj)).max()))
    _close(pt, pj, 1e-4, atol=1e-6 * float(np.abs(np.asarray(pj)).max()))


def test_resolve(tables):
    """MaterialTable.resolve bit for bit: the box's composite at and
    around its bin edges and outside every bin, other rows and -1; and a
    table with overlapping bins, where the first bin that holds k wins."""
    data_j, data_t, _, _ = tables
    r = np.random.default_rng(14)
    M = data_j.tables.materials.pack.shape[0]
    comp = _rows(data_j)["composite"]
    mat = np.where(r.random(N) < 0.7, comp,
                   r.integers(-1, M, N)).astype(np.int32)
    edges = np.asarray(data_j.tables.materials.comp_kmin)[comp, :2]
    k = r.uniform(0.5 * edges[0], 1.5 * tspectra.K_VISIBLE_MAX,
                  N).astype(np.float32)
    near = np.concatenate([edges, np.asarray(
        data_j.tables.materials.comp_kmax)[comp, :2]]).astype(np.float32)
    k[:64] = np.repeat(near, 16) + np.tile(np.arange(-8, 8), 4) \
        * np.spacing(np.repeat(near, 16))
    out_j = np.asarray(data_j.tables.materials.resolve(jnp.asarray(mat),
                                                       jnp.asarray(k)))
    out_t = data_t.tables.materials.resolve(_t(mat, torch.int32), _t(k))
    assert out_t.dtype == torch.int32
    np.testing.assert_array_equal(out_t.numpy(), out_j)
    assert len(np.unique(out_j[mat == comp])) == 3     # two children, null

    from wave_tracer_tpu.bsdf.table import bake_materials as jbake_mat
    from wave_tracer_tpu_torch.bsdf.table import (MaterialTable,
                                                  bake_materials)
    from wave_tracer_tpu_torch.bsdf import model as tmodel
    mats = {}
    for lib, name in ((jmodel, "j"), (tmodel, "t")):
        kids = [lib.Material(bsdf=None, name=f"c{i}") for i in range(3)]
        mats[name] = [lib.Material(bsdf=lib.CompositeBSDF(bins=[
            (1.0, 3.0, kids[0]), (2.0, 4.0, kids[1]),
            (0.5, 5.0, kids[2])]))] + kids
    jt = jbake_mat(mats["j"], {}, {}, {})
    tt = bake_materials(mats["t"], {}, {}, {})
    for key in tt:
        np.testing.assert_array_equal(tt[key], np.asarray(getattr(jt, key)),
                                      err_msg=key)
    table = MaterialTable(**{key: _t(v, torch.int32 if key == "comp_child"
                                     else torch.float32)
                             for key, v in tt.items()}, has_composite=True)
    mid = r.integers(-1, 4, N).astype(np.int32)
    kk = r.uniform(0.0, 6.0, N).astype(np.float32)
    kk[:8] = [0.5, 1.0, 2.0, 3.0, 4.0, 5.0, 2.5, 3.5]
    mid[:8] = 0
    np.testing.assert_array_equal(
        table.resolve(_t(mid, torch.int32), _t(kk)).numpy(),
        np.asarray(jt.resolve(jnp.asarray(mid), jnp.asarray(kk))))


@pytest.mark.parametrize("duv", [None, 1e-4, 3e-3, 0.05, 1.0])
def test_texture_lookups(tables, duv):
    """Every texture of the materials box (constant spectrum, constant
    RGB, checkerboard, the 256² bitmap and the 64² normal map, both with
    their mip atlas) at uvs that wrap, as RGB and as a spectral scalar,
    at rtol 1e-5 (absolute floor 1e-6): without a footprint (level 0) and
    at footprints from below a texel to the whole image."""
    data_j, data_t, _, _ = tables
    r = np.random.default_rng(15)
    T = data_j.tables.textures.pack.shape[0]
    tex = np.arange(N, dtype=np.int32) % T
    uv = r.uniform(-2.0, 3.0, (N, 2)).astype(np.float32)
    k = r.uniform(tspectra.K_VISIBLE_MIN, tspectra.K_VISIBLE_MAX,
                  N).astype(np.float32)
    d_j = None if duv is None else jnp.full((N,), duv, jnp.float32)
    d_t = None if duv is None else torch.full((N,), duv)
    rgb_j = jtex.eval_texture_rgb(data_j.tables.textures,
                                  data_j.tables.spectra, jnp.asarray(tex),
                                  jnp.asarray(uv), d_j)
    rgb_t = ttex.eval_texture_rgb(data_t.tables.textures,
                                  data_t.tables.spectra, _t(tex, torch.int32),
                                  _t(uv), d_t)
    _close(rgb_t, rgb_j, 1e-5, atol=1e-6)
    sc_j = jtex.eval_texture_scalar(data_j.tables.textures,
                                    data_j.tables.spectra, jnp.asarray(tex),
                                    jnp.asarray(uv), jnp.asarray(k), d_j)
    sc_t = ttex.eval_texture_scalar(data_t.tables.textures,
                                    data_t.tables.spectra,
                                    _t(tex, torch.int32), _t(uv), _t(k), d_t)
    _close(sc_t, sc_j, 1e-5, atol=1e-6)
    types = np.asarray(data_j.tables.textures.pack)[:, 0]
    assert {0, 1, 2, 3} <= set(types.astype(int).tolist())


def test_mip_levels_of_the_bitmap(tables):
    """The trilinear lookup picks coarser levels as the footprint grows:
    at a footprint of the whole image every texel of the bitmap reads its
    mean (the last level); the atlas packs the 256² pyramid along x."""
    data_j, data_t, _, _ = tables
    tt = data_t.tables.textures
    slot = 0
    info = tt.mip_info[slot].numpy()
    assert info[0].tolist() == [0, 256, 256] and info[1].tolist() == \
        [256, 128, 128] and int(tt.n_mips[slot]) == 8
    bitmap = int(np.nonzero(tt.pack[:, 0].numpy() == 2)[0][0])
    uv = torch.rand((512, 2), generator=torch.Generator().manual_seed(0))
    tex = torch.full((512,), bitmap, dtype=torch.int32)
    spread = [float(ttex.eval_texture_rgb(tt, None, tex, uv,
                                          torch.full((512,), d)).std(0).max())
              for d in (1e-4, 1 / 64, 1 / 8, 1.0)]
    assert spread[0] > spread[1] > spread[2] > spread[3]


def test_apply_normalmap(tables):
    """Normal-mapped shading frames on the composite wall's bumpy child
    (k in its band), its conductor child (no map: unchanged) and other
    rows, against the JAX frames at rtol 1e-4 (atol 1e-6)."""
    data_j, data_t, _, _ = tables
    mat, wi, _, uv, k, _, duv = _lobe_inputs(data_j, 16)
    comp = _rows(data_j)["composite"]
    mat[: N // 2] = comp
    r = np.random.default_rng(17)
    n = _unit(r, N)
    dpdu = r.normal(size=(N, 3)).astype(np.float32)
    sf_j = jframe.build_shading_frame(jnp.asarray(n), jnp.asarray(dpdu))
    sf_t = tframe.build_shading_frame(_t(n), _t(dpdu))
    for d_j, d_t in ((None, None), (jnp.asarray(duv), _t(duv))):
        fj = jbsdf.apply_normalmap(data_j.tables, jnp.asarray(mat),
                                   jnp.asarray(uv), jnp.asarray(k), sf_j,
                                   d_j)
        ft = tbsdf.apply_normalmap(data_t.tables, _t(mat, torch.int32),
                                   _t(uv), _t(k), sf_t, d_t)
        for axis in ("t", "b", "n"):
            _close(getattr(ft, axis), getattr(fj, axis), 1e-4, atol=1e-6,
                   msg=axis)
    moved = np.abs(ft.n.numpy() - n).max(-1) > 1e-6
    child = int(np.asarray(data_j.tables.materials.comp_child)[comp, 0])
    bumpy = ((mat == comp) & (k < K_GREEN)) | (mat == child)
    assert moved[bumpy].mean() > 0.9 and not moved[~bumpy].any()


@pytest.fixture(scope="module")
def emitters():
    """A box lit by an area panel, a point, a spot (piecewise-linear
    spectrum) and a directional emitter: (JAX data, bridged port data)."""
    def extra(lib, spec):
        src = np.array([0.2, 1.8, 0.4])
        d = np.array([-0.3, -1.0, -0.2])
        return [lib.PointEmitter(spectrum=spec[0],
                                 position=np.array([0.5, 1.5, 0.0])),
                lib.SpotEmitter(spectrum=spec[1], position=src,
                                direction=d / np.linalg.norm(d),
                                beam_width=math.radians(15.0),
                                cutoff=math.radians(35.0)),
                lib.DirectionalEmitter(spectrum=spec[2],
                                       direction=d / np.linalg.norm(d))]
    k_nodes = 2 * math.pi / np.array([700e-9, 550e-9, 400e-9])
    scene = jmake_box(res=8, spp=1)
    scene.emitters += extra(jemodel, [
        jspectra.UniformSpectrum(1e-13), jspectra.PiecewiseLinearSpectrum(
            k_nodes, [1e-13, 3e-13, 2e-13]),
        jspectra.GaussianSpectrum(K_GREEN, 0.1 * K_GREEN, 1e-13)])
    jb = jbuild(scene)
    return jb.data, scene_data_from_numpy(_flatten(jb.data), "cpu")


def test_spot_and_directional_emitters(emitters):
    """sample_direct, sample_emission and pdf_emission_dir of every
    emitter type against JAX at rtol 1e-4 (absolute floor 1e-6 of each
    output's largest value); type flags and validity equal."""
    data_j, data_t = emitters
    et_t = data_t.emitters
    assert et_t.has_spot and et_t.has_directional
    r = np.random.default_rng(18)
    E = int(et_t.count)
    e = (np.arange(N) % E).astype(np.int32)
    x = r.uniform([-0.9, 0.05, -0.9], [0.9, 1.9, 0.9], (N, 3)).astype(
        np.float32)
    k = r.uniform(tspectra.K_VISIBLE_MIN, tspectra.K_VISIBLE_MAX,
                  N).astype(np.float32)
    u = r.random((N, 4)).astype(np.float32)
    ej, etj = data_j.emitters, data_j.tables.spectra

    def check(out_t, out_j):
        for key, vt in out_t.items():
            vj = np.asarray(out_j[key])
            if vt.dtype == torch.bool or key == "tri":
                np.testing.assert_array_equal(vt.numpy(), vj, err_msg=key)
            else:
                _close(vt, vj, 1e-4, atol=1e-6 * float(np.abs(vj).max()),
                       msg=key)

    check(tetab.sample_direct(et_t, data_t.geo, data_t.tables.spectra,
                              _t(e, torch.int32), _t(x), _t(k), _t(u[:, :3])),
          jetab.sample_direct(ej, data_j.geo, etj, jnp.asarray(e),
                              jnp.asarray(x), jnp.asarray(k),
                              jnp.asarray(u[:, :3])))
    em_t = tetab.sample_emission(et_t, data_t.geo, data_t.tables.spectra,
                                 _t(e, torch.int32), _t(k), _t(u))
    em_j = jetab.sample_emission(ej, data_j.geo, etj, jnp.asarray(e),
                                 jnp.asarray(k), jnp.asarray(u))
    check(em_t, em_j)
    ln, wo = _unit(r, N), _unit(r, N)
    spot = e == 2
    wo[spot[: N]] = np.asarray(em_j["wo"])[spot]    # inside the cone
    pd_t = tetab.pdf_emission_dir(et_t, _t(e, torch.int32), _t(ln), _t(wo))
    pd_j = jetab.pdf_emission_dir(ej, jnp.asarray(e), jnp.asarray(ln),
                                  jnp.asarray(wo))
    _close(pd_t, pd_j, 1e-4)
    types = np.asarray(ej.etype)[e]
    assert (np.asarray(pd_j)[types == 2] > 0).all()
    assert (np.asarray(pd_j)[types == 3] == 0).all()
    assert (em_t["weight"][torch.as_tensor(types == 2)] > 0).float().mean() \
        > 0.3


def test_polarimetric_to_values():
    """The pool's develop of a polarimetric sensor: I/Q/U/V per response
    channel, interleaved, against the JAX pool's to_values bit for bit;
    an RGB sensor's values are the intensity row only."""
    from wave_tracer_tpu.integrator.path_compact import \
        _pool_parts as jparts
    from wave_tracer_tpu_torch.integrator.path_compact import \
        _pool_parts as tparts
    from wave_tracer_tpu_torch.scene.procedural import make_box_scene
    r = np.random.default_rng(19)
    n = 64
    L = r.normal(size=(n, 4)).astype(np.float32)
    w = r.random(n).astype(np.float32)
    sens = r.random((n, 3)).astype(np.float32)
    for pol in (True, False):
        js = jmake_box(res=4, spp=1).sensors[0]
        ts = make_box_scene(res=4, spp=1).sensors[0]
        js.polarimetric = ts.polarimetric = pol
        to_j = jparts(js, 4, 1e-4, True, 3, 0.5, False, False, False, 8)[1]
        to_t = tparts(ts, 4, 1e-4, True, 3, 0.5, False)[1]
        vj = np.asarray(to_j(dict(L=jnp.asarray(L)),
                             dict(w_spectral=jnp.asarray(w),
                                  sens=jnp.asarray(sens)), n))
        vt = to_t(dict(L=_t(L)), dict(w_spectral=_t(w), sens=_t(sens)))
        assert vt.shape == ((n, 12) if pol else (n, 3))
        np.testing.assert_array_equal(vt.numpy(), vj)


def _open_scene(lib):
    """A checkerboard ground with a glass and a rough-conductor sphere,
    open to the sky and lit by a directional emitter, seen from above at
    an angle: 16×16, 4 spp, classical plt_path at depth 4. `lib`: the
    package's modules (model, emitter model, mesh, Transform, spectra,
    textures, scene and sensor types)."""
    ground = lib.Shape(lib.mesh.rectangle(4.0, lib.Transform.from_rows(
        [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0, 0, 0, 0, 1])), lib.model.Material(
        bsdf=lib.model.DiffuseBSDF(reflectance=lib.tex.CheckerboardTexture(
            uv_scale=(6.0, 6.0)))))
    glass = lib.Shape(lib.mesh.sphere([0.4, 0.5, 0.0], 0.5, tessellation=12),
                      lib.model.Material(bsdf=lib.model.DielectricBSDF(
                          ior=lib.spectra.ComplexUniformSpectrum(1.5))))
    metal = lib.Shape(lib.mesh.sphere([-0.6, 0.4, -0.3], 0.4,
                                      tessellation=12),
                      lib.model.Material(bsdf=lib.model.SpmBSDF(
                          ior=lib.spectra.ComplexUniformSpectrum(0.27 + 2.9j),
                          profile=lib.model.SurfaceProfile(type="gaussian",
                                                           sigma=0.05))))
    d = np.array([0.3, -1.0, -0.4])
    sun = lib.emodel.DirectionalEmitter(
        spectrum=lib.spectra.UniformSpectrum(1e-13),
        direction=d / np.linalg.norm(d))
    sensor = lib.PerspectiveSensor(
        width=16, height=16, fov=math.radians(50.0),
        to_world=lib.lookat_matrix([0.0, 3.0, 3.5], [0.0, 0.3, 0.0]),
        samples=4, response=lib.Response(type="RGB", colourspace="sRGB",
                                         white_point="D65"))
    return lib.Scene(shapes=[ground, glass, metal], emitters=[sun],
                     sensors=[sensor], integrator=lib.IntegratorConfig(
                         max_depth=4, fsd=False))


def test_directional_open_scene_render():
    """The directional emitter lights an open scene: the port's render of
    the bridged JAX bake against the JAX render per pixel, at the
    classical bars of tests/test_torch_render.py (each channel's mean
    within 1%, >= 98% of pixels within 1e-3·max(|ref|, mean|ref|), rays,
    shadow rays and depth sum within 0.5%)."""
    import types
    from wave_tracer_tpu.render import render_scene as jrender
    from wave_tracer_tpu import scene as jscene
    from wave_tracer_tpu.sensor import perspective as jpersp
    from wave_tracer_tpu.sensor.response import Response as JResponse
    from wave_tracer_tpu_torch.bsdf import model as tmodel
    from wave_tracer_tpu_torch.core.transform import Transform as TTransform
    from wave_tracer_tpu_torch.emitter import model as temodel
    from wave_tracer_tpu_torch.geometry import mesh as tmesh
    from wave_tracer_tpu_torch.render import render_scene
    from wave_tracer_tpu_torch.scene import model as tscene
    from wave_tracer_tpu_torch.scene.bridge import SPECTRAL_KEYS
    from wave_tracer_tpu_torch.scene.build import BuiltScene
    from wave_tracer_tpu_torch.sensor import perspective as tpersp
    from wave_tracer_tpu_torch.sensor.response import Response as TResponse
    jlib = types.SimpleNamespace(
        model=jmodel, emodel=jemodel, mesh=jmesh, Transform=JTransform,
        spectra=jspectra, tex=jtex, Shape=jscene.Shape, Scene=jscene.Scene,
        IntegratorConfig=jscene.IntegratorConfig,
        PerspectiveSensor=jpersp.PerspectiveSensor,
        lookat_matrix=jpersp.lookat_matrix, Response=JResponse)
    tlib = types.SimpleNamespace(
        model=tmodel, emodel=temodel, mesh=tmesh, Transform=TTransform,
        spectra=tspectra, tex=ttex, Shape=tscene.Shape, Scene=tscene.Scene,
        IntegratorConfig=tscene.IntegratorConfig,
        PerspectiveSensor=tpersp.PerspectiveSensor,
        lookat_matrix=tpersp.lookat_matrix, Response=TResponse)
    jb = jbuild(_open_scene(jlib))
    jimg, jst = jrender(jb, spp=4, batch_lanes=1024)
    jimg = np.asarray(jimg)
    arrays = _flatten(jb.data)
    assert (arrays["emitters.etype"] == 3).all()
    built = BuiltScene.upload(
        _open_scene(tlib), arrays,
        [{k: arrays[f"spectral.{k}"] for k in SPECTRAL_KEYS}], "cpu")
    img, st = render_scene(built, device="cpu", pool_lanes=1024)
    assert st["mode"] == jst["mode"] == "ray-compact"
    assert img.shape == jimg.shape == (16, 16, 3)
    assert np.isfinite(img).all() and jimg.mean() > 0
    np.testing.assert_allclose(img.mean((0, 1)), jimg.mean((0, 1)),
                               rtol=0.01)
    scale = np.maximum(np.abs(jimg), np.abs(jimg).mean())
    assert ((np.abs(img - jimg) <= 1e-3 * scale).all(-1)).mean() >= 0.98
    for key in ("rays_cast", "shadow_rays", "sum_path_depth"):
        a, b = st["device_counters"][key], jst["device_counters"][key]
        assert abs(a - b) <= 0.005 * b, (key, a, b)
