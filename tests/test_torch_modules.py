"""Port parity, module by module: each wave_tracer_tpu_torch function of
the classical slice against its JAX twin on the same seeded numpy inputs,
at rtol 1e-5 / atol 1e-6 in f32 (the two frameworks round transcendental
functions and sums differently in the last bits).

The device tables come from the JAX bake of the box scene, flattened to
numpy and uploaded through the port's bridge, so both sides read the same
tables."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_render import make_box_scene
from wave_tracer_tpu.bsdf import device as jbsdf
from wave_tracer_tpu.emitter import table as jetab
from wave_tracer_tpu.integrator import path as jpath
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.sensor import film as jfilm
from wave_tracer_tpu_torch.bsdf import device as tbsdf
from wave_tracer_tpu_torch.emitter import table as tetab
from wave_tracer_tpu_torch.integrator import path as tpath
from wave_tracer_tpu_torch.scene.bridge import scene_data_from_numpy
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene
from wave_tracer_tpu_torch.sensor import film as tfilm

RTOL, ATOL = 1e-5, 1e-6
N = 512


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


@pytest.fixture(scope="module")
def tables():
    jb = jbuild(make_box_scene(res=8, spp=1))
    jp = jbuild(make_box_scene(res=8, spp=1, emitter="point"))
    return dict(
        area=(jb.data, scene_data_from_numpy(_flatten(jb.data), "cpu")),
        point=(jp.data, scene_data_from_numpy(_flatten(jp.data), "cpu")))


def _close(a, b, name=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(b, a, err_msg=name)
    else:
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=name)


def _inputs(seed):
    r = np.random.default_rng(seed)
    wi = r.normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = r.normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    k = (2 * np.pi / r.uniform(380e-9, 720e-9, N)).astype(np.float32)
    u4 = r.random((N, 4)).astype(np.float32)
    uv = r.random((N, 2)).astype(np.float32)
    return wi, wo, k, u4, uv


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("seed", [0, 1])
def test_diffuse_sample_and_eval(tables, seed):
    jd, td = tables["area"]
    wi, wo, k, u4, uv = _inputs(seed)
    M = jd.tables.materials.count
    mat = np.random.default_rng(seed + 9).integers(-1, M, N).astype(np.int32)
    js = jbsdf.sample(jd.tables, jnp.asarray(mat), jnp.asarray(wi),
                      jnp.asarray(uv), jnp.asarray(k), jnp.asarray(u4))
    ts = tbsdf.sample(td.tables, *_t(mat, wi, uv, k, u4))
    for f in ("pdf", "Mw", "specular", "valid", "refracted"):
        _close(getattr(js, f), getattr(ts, f), f)
    # wo.z = sqrt(1 − x² − y²) magnifies last-bit differences near grazing
    # by 1/(2z); it is compared through z² and its sign, which are not
    jwo, two = np.asarray(js.wo), ts.wo.numpy()
    _close(jwo[:, :2], two[:, :2], "wo.xy")
    _close(jwo[:, 2] ** 2, two[:, 2] ** 2, "wo.z²")
    np.testing.assert_array_equal(np.sign(two[:, 2]), np.sign(jwo[:, 2]))
    jf, jp = jbsdf.eval_f(jd.tables, jnp.asarray(mat), jnp.asarray(wi),
                          jnp.asarray(wo), jnp.asarray(uv), jnp.asarray(k))
    tf, tp = tbsdf.eval_f(td.tables, *_t(mat, wi, wo, uv, k))
    _close(jf, tf, "eval_f M")
    _close(jp, tp, "eval_f pdf")


@pytest.mark.parametrize("kind", ["area", "point"])
def test_emitter_queries(tables, kind):
    jd, td = tables[kind]
    r = np.random.default_rng(3)
    x = r.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (N, 3)).astype(
        np.float32)
    k = (2 * np.pi / r.uniform(380e-9, 720e-9, N)).astype(np.float32)
    u3 = r.random((N, 3)).astype(np.float32)
    e = np.zeros(N, np.int32)
    jn = jetab.sample_direct(jd.emitters, jd.geo, jd.tables.spectra,
                             jnp.asarray(e), jnp.asarray(x), jnp.asarray(k),
                             jnp.asarray(u3))
    tn = tetab.sample_direct(td.emitters, td.geo, td.tables.spectra,
                             *_t(e, x, k, u3))
    for f in ("wo", "dist", "Li", "pdf_sa", "delta_dir", "y", "ln", "valid",
              "tri"):
        _close(jn[f], tn[f], f)
    eid = r.integers(-1, jd.emitters.count, N).astype(np.int32)
    cos = r.uniform(-1, 1, N).astype(np.float32)
    d2 = r.uniform(0.01, 4.0, N).astype(np.float32)
    _close(jetab.emission_radiance(jd.emitters, jd.tables.spectra,
                                   jnp.asarray(eid), jnp.asarray(k),
                                   jnp.asarray(cos)),
           tetab.emission_radiance(td.emitters, td.tables.spectra,
                                   *_t(eid, k, cos)), "Le")
    _close(jetab.pdf_direct_solid_angle(jd.emitters, jnp.asarray(eid),
                                        jnp.asarray(d2), jnp.asarray(cos)),
           tetab.pdf_direct_solid_angle(td.emitters, *_t(eid, d2, cos)),
           "pdf_direct")
    u = r.random(N).astype(np.float32)
    je, jpmf = jpath._sample_emitter_by_power(jd.emitters, jnp.asarray(u))
    te, tpmf = tpath._sample_emitter_by_power(td.emitters, *_t(u))
    _close(je, te, "e")
    _close(jpmf, tpmf, "pmf")
    _close(jpath._emitter_pmf(jd.emitters, jnp.asarray(eid)),
           tpath._emitter_pmf(td.emitters, *_t(eid)), "emitter_pmf")


def test_spectral_sampler(tables):
    jd, td = tables["area"]
    r = np.random.default_rng(4)
    u = r.random((N, 2)).astype(np.float32)
    je, jpmf = jd.spectral.sample_emitter(jnp.asarray(u[:, 0]))
    te, tpmf = td.spectral.sample_emitter(*_t(u[:, 0]))
    _close(je, te, "e")
    _close(jpmf, tpmf, "pmf")
    jk, jpk = jd.spectral.sample_k(je, jnp.asarray(u[:, 1]))
    tk, tpk = td.spectral.sample_k(te, *_t(u[:, 1]))
    _close(jk, tk, "k")
    _close(jpk, tpk, "pdf_k")
    _close(jd.spectral.joint_spectral_density(jk),
           td.spectral.joint_spectral_density(tk), "joint")


def test_generate_rays():
    js = make_box_scene(res=24, spp=1).sensors[0]
    ts = tmake_box_scene(res=24, spp=1).sensors[0]
    r = np.random.default_rng(5)
    pxy = r.integers(0, 24, (N, 2)).astype(np.int32)
    jit = r.random((N, 2)).astype(np.float32)
    jro, jrd, jta = js.generate_rays(jnp.asarray(pxy), jnp.asarray(jit))
    tro, trd, tta = ts.generate_rays(*_t(pxy, jit))
    _close(jro, tro, "ro")
    _close(jrd, trd, "rd")
    assert math.isclose(jta, tta, rel_tol=1e-12)
    kk = (2 * np.pi / r.uniform(360e-9, 830e-9, N)).astype(np.float32)
    _close(js.response.sensitivities(jnp.asarray(kk)),
           ts.response.sensitivities(*_t(kk)), "sensitivities")


def test_compose_scatter():
    r = np.random.default_rng(6)

    def unit(n):
        v = r.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    M_old = r.normal(size=(N, 4, 4)).astype(np.float32)
    M_b = r.normal(size=(N, 4, 4)).astype(np.float32)
    d_out, d_in = unit(N), unit(N)
    d_in[:8] = d_out[:8]                    # degenerate scattering planes
    x_old = np.cross(d_out, unit(N)).astype(np.float32)
    x_old /= np.linalg.norm(x_old, axis=-1, keepdims=True)
    jM, jx = jpath.compose_scatter(*[jnp.asarray(a) for a in
                                     (M_old, x_old, d_out, M_b, d_in)])
    tM, tx = tpath.compose_scatter(*_t(M_old, x_old, d_out, M_b, d_in))
    np.testing.assert_allclose(tM.numpy(), np.asarray(jM), rtol=RTOL,
                               atol=1e-5)   # sums of 16 O(1) products
    _close(jx, tx, "x_new")
    _close(jpath._power_heuristic(jnp.asarray(M_b[:, 0, 0]),
                                  jnp.asarray(M_b[:, 1, 1])),
           tpath._power_heuristic(*_t(M_b[:, 0, 0], M_b[:, 1, 1])), "ph")


def test_film_splat_develop():
    r = np.random.default_rng(8)
    W, H, C = 20, 12, 3
    pos = np.stack([r.uniform(-1, W + 1, N), r.uniform(-1, H + 1, N)],
                   -1).astype(np.float32)
    vals = r.random((N, C)).astype(np.float32)
    vals[3, 1] = np.inf                     # non-finite lanes drop out
    mask = r.random(N) < 0.8
    jf = jfilm.make_film(W, H, C, 0.25)
    tf = tfilm.make_film(W, H, C, 0.25)
    for _ in range(2):
        jf = jfilm.splat(jf, jnp.asarray(pos), jnp.asarray(vals),
                         jnp.asarray(mask))
        tf = tfilm.splat(tf, *_t(pos, vals, mask))
    _close(jf.value, tf.value, "value")
    _close(jf.weight, tf.weight, "weight")
    # develop = value / weight: held exactly on the same film, and over
    # the whole chain with the splat bar (rtol, atol on value and weight)
    # propagated through the division: |Δ| ≤ atol·(1+|d|)/w + 2·rtol·|d|
    same = tfilm.Film(*_t(jf.value, jf.weight))
    _close(jfilm.develop(jf), tfilm.develop(same), "develop")
    d_ref = np.asarray(jfilm.develop(jf))
    w = np.maximum(np.asarray(jf.weight), 1e-12)[..., None]
    bound = ATOL * (1 + np.abs(d_ref)) / w + 2 * RTOL * np.abs(d_ref)
    assert (np.abs(tfilm.develop(tf).numpy() - d_ref) <= bound).all()
