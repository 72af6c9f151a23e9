"""Port parity for the modules of the bdpt slice: each wave_tracer_tpu_torch
function against its JAX twin on the same seeded numpy inputs, in f32.

Smooth functions are held at rtol 1e-5 / atol 1e-6 (the two frameworks
round transcendental functions and sums differently in the last bits).
Functions that chain dozens of such operations through erf, sinc and
complex sums (the Gaussian polygon mass, the Fraunhofer aperture and ASF)
are held at rtol 1e-4, with the absolute floor stated at each. Boolean and
integer outputs must be equal.

The device tables come from the JAX bake of the box scene, flattened to
numpy and uploaded through the port's bridge, so both sides read the same
tables. The last test holds one whole `trace_bdpt` batch per lane, FSD
off (see its docstring for the bar)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_render import make_box_scene
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.accel import trace as jtrace
from wave_tracer_tpu.emitter import table as jetab
from wave_tracer_tpu.integrator import plt_bdpt as jbdpt
from wave_tracer_tpu.math import gaussian2d as jg2d
from wave_tracer_tpu.polarization import stokes as jstokes
from wave_tracer_tpu.sampling import rng as jrng
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.sensor import film as jfilm
from wave_tracer_tpu.wave import fraunhofer as jfr
from wave_tracer_tpu.wave import sourcing as jsourcing
from wave_tracer_tpu_torch.accel import trace as ttrace
from wave_tracer_tpu_torch.emitter import table as tetab
from wave_tracer_tpu_torch.integrator import plt_bdpt as tbdpt
from wave_tracer_tpu_torch.math import gaussian2d as tg2d
from wave_tracer_tpu_torch.polarization import stokes as tstokes
from wave_tracer_tpu_torch.sampling import rng as trng
from wave_tracer_tpu_torch.scene.bridge import scene_data_from_numpy
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene
from wave_tracer_tpu_torch.sensor import film as tfilm
from wave_tracer_tpu_torch.wave import fraunhofer as tfr
from wave_tracer_tpu_torch.wave import sourcing as tsourcing

cap_torch_threads()

RTOL, ATOL = 1e-5, 1e-6
N = 512


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.tensor(np.asarray(x)) for x in xs]


def _close(a, b, name="", rtol=RTOL, atol=ATOL):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(b, a, err_msg=name)
    else:
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=name)


def _unit(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _wavenumbers(r, n):
    return (2 * np.pi / r.uniform(380e-9, 720e-9, n)).astype(np.float32)


@pytest.fixture(scope="module")
def tables():
    jb = jbuild(make_box_scene(res=8, spp=1))
    jp = jbuild(make_box_scene(res=8, spp=1, emitter="point"))
    return dict(
        area=(jb.data, scene_data_from_numpy(_flatten(jb.data), "cpu")),
        point=(jp.data, scene_data_from_numpy(_flatten(jp.data), "cpu")))


# ---------------------------------------------------------------------------
# math/gaussian2d.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_clip_and_polygon_mass(seed):
    r = np.random.default_rng(seed)
    K = 8
    pa, pb, pc = (r.normal(size=(N, K, 3)).astype(np.float32)
                  for _ in range(3))
    pb[:, :2, 2] = pa[:, :2, 2]             # edges parallel to the slab
    z0 = r.uniform(-1.0, 0.5, (N, K)).astype(np.float32)
    z1 = (z0 + r.uniform(0.0, 1.5, (N, K))).astype(np.float32)
    jv, jn = jg2d.clip_triangle_z(*_j(pa, pb, pc, z0, z1))
    tv, tn = tg2d.clip_triangle_z(*_t(pa, pb, pc, z0, z1))
    _close(jn, tn, "nverts")
    assert (np.asarray(jn) == 0).any() and (np.asarray(jn) >= 4).any()
    _close(jv, tv, "verts")
    sx = r.uniform(0.05, 2.0, (N, K)).astype(np.float32)
    sy = r.uniform(0.05, 2.0, (N, K)).astype(np.float32)
    # a mass is a sum of fan triangles, each a sum of erf differences and
    # a 16-point quadrature: held at rtol 1e-4, atol 1e-6 (masses ≤ 1)
    jm = jg2d.polygon_gaussian_mass(jv, jn, *_j(sx, sy))
    tm = tg2d.polygon_gaussian_mass(torch.tensor(np.asarray(jv)),
                                    torch.tensor(np.asarray(jn)),
                                    *_t(sx, sy))
    assert (np.asarray(jm) > 0.01).mean() > 0.2
    _close(jm, tm, "mass", rtol=1e-4, atol=1e-6)
    _close(jg2d.integrate_triangle(*_j(pa[..., :2], pb[..., :2],
                                       pc[..., :2], sx, sy)),
           tg2d.integrate_triangle(*_t(pa[..., :2], pb[..., :2],
                                       pc[..., :2], sx, sy)),
           "triangle", rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# wave/fraunhofer.py
# ---------------------------------------------------------------------------

def test_fraunhofer_luts():
    """The port's own tables equal, bit for bit, those the JAX module
    builds (and the ones it ships)."""
    ref = jfr._build_luts()
    mine = tfr._build_luts()
    assert set(ref) == set(mine)
    for key in ref:
        np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)
        np.testing.assert_array_equal(mine[key], jfr._LUTS[key],
                                      err_msg=key)


@pytest.fixture(scope="module")
def aperture(tables):
    """Apertures over the box's edge table: beams aimed at a point next to
    a random edge, with that edge and seven random others (some −1)."""
    jd, td = tables["area"]
    r = np.random.default_rng(11)
    E = int(jd.edges.count)
    e0 = r.integers(0, E, N)
    p0 = np.asarray(jd.edges.p0)[e0]
    p1 = np.asarray(jd.edges.p1)[e0]
    sigma = r.uniform(2e-4, 5e-3, N).astype(np.float32)
    wp = (p0 + r.uniform(0, 1, (N, 1)) * (p1 - p0)
          + r.normal(size=(N, 3)) * sigma[:, None]).astype(np.float32)
    rd = _unit(r, N)
    fx = np.cross(rd, _unit(r, N)).astype(np.float32)
    fx /= np.linalg.norm(fx, axis=-1, keepdims=True)
    fy = np.cross(rd, fx).astype(np.float32)
    idx = r.integers(-1, E, (N, 8)).astype(np.int32)
    idx[:, 0] = e0
    r_env = (3.0 * sigma * r.uniform(1.0, 2.0, N)).astype(np.float32)
    k = _wavenumbers(r, N)
    args = (idx, wp, rd, fx, fy, sigma, r_env, k)
    jap, jscale = jfr.build_aperture_3d(jd.edges, *_j(*args), subdiv=3)
    tap, tscale = tfr.build_aperture_3d(td.edges, *_t(*args), subdiv=3)
    return jap, tap, jscale, tscale, r


def _same(jap):
    """The JAX aperture as a torch aperture (identical inputs)."""
    return tfr.FraunhoferAperture(**{
        f.name: torch.tensor(np.asarray(getattr(jap, f.name)))
        for f in dataclasses.fields(tfr.FraunhoferAperture)})


def test_build_aperture_3d(aperture):
    jap, tap, jscale, tscale, _ = aperture
    assert np.asarray(jap.valid).any(1).mean() > 0.3
    _close(jscale, tscale, "scale")
    _close(jap.valid, tap.valid, "valid")
    for f in ("e", "v"):
        _close(getattr(jap, f), getattr(tap, f), f, rtol=1e-4, atol=1e-4)
    # amplitudes sqrt(density) of up to ~1e3 /m; powers ~ |e|⁴·|a|² with
    # |e| up to tens of mm: held relative to each lane's largest
    for f in ("a_b", "iab_2", "edge_pdf"):
        a, b = np.asarray(getattr(jap, f)), getattr(tap, f).numpy()
        scale = np.abs(a).max(1, keepdims=True) + 1e-30
        assert (np.abs(a - b) <= 1e-4 * scale).all(), f
    for f in ("psi02", "P0", "P0_pdf", "total"):
        _close(getattr(jap, f), getattr(tap, f), f, rtol=1e-4, atol=1e-12)


def test_asf_and_psi(aperture):
    jap, _, _, _, r = aperture
    tap = _same(jap)
    xi = (r.normal(size=(N, 2)) * r.choice([0.05, 0.5, 3.0], (N, 1))
          ).astype(np.float32)
    # each is a coherent sum of up to 24 complex terms with phases v·ξ of
    # up to ~100 rad: held relative to the lane's largest term
    jpsi, tpsi = np.asarray(jfr.psi(jap, jnp.asarray(xi))), \
        tfr.psi(tap, torch.tensor(xi)).numpy()
    scale = np.abs(jpsi).max(1, keepdims=True) + 1e-30
    assert (np.abs(jpsi - tpsi) <= 1e-4 * scale).all()
    for name in ("asf", "sampling_density", "proposal_density"):
        a = np.asarray(getattr(jfr, name)(jap, jnp.asarray(xi)))
        b = getattr(tfr, name)(tap, torch.tensor(xi)).numpy()
        tot = np.asarray(jap.total) + 1e-30
        assert (np.abs(a - b) <= 1e-4 * np.abs(a) + 1e-6 * tot).all(), name


def test_sample_xi(aperture):
    """The same ξ within 1e-5 relative on >= 99.9% of draws (a draw whose
    uniform sits on a CDF bound can take the neighbouring cell)."""
    jap, _, _, _, r = aperture
    tap = _same(jap)
    u4 = r.random((N, 4)).astype(np.float32)
    u4[:4, 1:] = [[0.0, 0.0, 0.0], [1 - 1e-7] * 3, [0.5] * 3,
                  [1e-7, 0.3, 0.999]]
    jxi, jdens, jp0 = jfr.sample_xi(jap, jnp.asarray(u4))
    txi, tdens, tp0 = tfr.sample_xi(tap, torch.tensor(u4)[:, None])
    _close(jp0, tp0[:, 0], "zero order")
    jxi, txi = np.asarray(jxi), txi[:, 0].numpy()
    near = np.isclose(txi, jxi, rtol=1e-5, atol=1e-7).all(-1)
    assert near.mean() >= 0.999
    a, b = np.asarray(jdens)[near], tdens[:, 0].numpy()[near]
    assert np.isclose(b, a, rtol=1e-4, atol=1e-6 * a.max()).all()

    M = tbdpt.M_RIS
    uM = r.random((N, M, 4)).astype(np.float32)
    up = r.random(N).astype(np.float32)
    jx, jasf, jw, jok = jfr.sample_xi_sir(jap, *_j(uM, up))
    tx, tasf, tw, tok = tfr.sample_xi_sir(tap, *_t(uM, up))
    _close(jok, tok, "valid")
    assert np.asarray(jok).mean() > 0.3
    near = np.isclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                      atol=1e-7).all(-1)
    assert near.mean() >= 0.999
    ok = np.asarray(jok) & near
    for name, a, b in (("asf", jasf, tasf), ("w_ris", jw, tw)):
        a, b = np.asarray(a)[ok], b.numpy()[ok]
        assert np.isclose(b, a, rtol=1e-4, atol=1e-6 * np.abs(a).max()
                          ).all(), name


def test_xi_wo_round_trip():
    r = np.random.default_rng(12)
    xi = (r.normal(size=(N, 2)) * 3.0).astype(np.float32)
    scale = (_wavenumbers(r, N) * 1e-3).astype(np.float32)
    jwo, jok = jfr.xi_to_wo(*_j(xi, scale))
    two, tok = tfr.xi_to_wo(*_t(xi, scale))
    _close(jok, tok, "ok")
    _close(jwo, two, "wo")
    jxi, jok2 = jfr.wo_to_xi(jwo, jnp.asarray(scale))
    txi, tok2 = tfr.wo_to_xi(two, torch.tensor(scale))
    _close(jok2, tok2, "ok back")
    _close(jxi, txi, "xi back", rtol=1e-5, atol=1e-5)
    # the round trip returns ξ where the direction is kept
    back = tok.numpy() & tok2.numpy()
    assert back.mean() > 0.5
    np.testing.assert_allclose(txi.numpy()[back], xi[back], rtol=1e-3,
                               atol=1e-5)
    ap = tfr.empty_fr_aperture(3, 24, device="cpu")
    assert not ap.valid.any() and ap.a_b.dtype == torch.complex64


# ---------------------------------------------------------------------------
# accel/trace.py::tris_in_ball
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [4, 8, 16])
def test_tris_in_ball(tables, K):
    jd, td = tables["area"]
    r = np.random.default_rng(13 + K)
    c = r.uniform([-1.2, -0.2, -1.2], [1.2, 2.2, 1.2], (N, 3)).astype(
        np.float32)
    # points over the floor's diagonal: ties between its two triangles
    c[:32] = np.stack([np.linspace(-0.9, 0.9, 32), np.full(32, 0.3),
                       np.linspace(-0.9, 0.9, 32)], -1)
    radius = r.uniform(0.05, 1.5, N).astype(np.float32)
    ji, jdist, jc = jtrace.tris_in_ball(jd.geo, *_j(c, radius), K)
    ti, tdist, tc = ttrace.tris_in_ball(td.geo, *_t(c, radius), K)
    _close(jc, tc, "count")
    assert (np.asarray(jc) > 0).mean() > 0.5
    # the same index sets, in the same order, but where two triangles lie
    # at one distance (the floor's two halves under its diagonal, a wall's
    # two halves seen from a corner) and the frameworks' distances differ
    # by an ulp: there either may come first, or be the K-th. The sorted
    # distances agree everywhere, so such a swap is between equidistant
    # triangles
    _close(jdist, tdist, "dist", rtol=1e-6, atol=1e-6)
    ji, ti = np.asarray(ji), ti.numpy()
    assert (np.sort(ji, 1) == np.sort(ti, 1)).all(1).mean() >= 0.99
    assert (ji == ti).all(1).mean() >= 0.99


# ---------------------------------------------------------------------------
# polarization, emitters, sourcing, sensor, film
# ---------------------------------------------------------------------------

def test_stokes_reorient():
    r = np.random.default_rng(14)
    S = r.normal(size=(N, 4)).astype(np.float32)
    d = _unit(r, N)
    xa = np.cross(d, _unit(r, N)).astype(np.float32)
    xa /= np.linalg.norm(xa, axis=-1, keepdims=True)
    xb = np.cross(d, _unit(r, N)).astype(np.float32)
    xb /= np.linalg.norm(xb, axis=-1, keepdims=True)
    theta = r.uniform(-np.pi, np.pi, N).astype(np.float32)
    _close(jstokes.rotate(*_j(S, theta)), tstokes.rotate(*_t(S, theta)),
           "rotate")
    _close(jstokes.reorient(*_j(S, xa, xb, d)),
           tstokes.reorient(*_t(S, xa, xb, d)), "reorient", atol=1e-5)


@pytest.mark.parametrize("kind", ["area", "point"])
def test_emission_sampling(tables, kind):
    jd, td = tables[kind]
    r = np.random.default_rng(15)
    k = _wavenumbers(r, N)
    u4 = r.random((N, 4)).astype(np.float32)
    e = np.zeros(N, np.int32)
    je = jetab.sample_emission(jd.emitters, jd.geo, jd.tables.spectra,
                               *_j(e, k, u4))
    te = tetab.sample_emission(td.emitters, td.geo, td.tables.spectra,
                               *_t(e, k, u4))
    for f in ("y", "ln", "wo", "weight", "pdf_area", "pdf_dir", "valid"):
        _close(je[f], te[f], f)
    eid = r.integers(-1, 1, N).astype(np.int32)
    ln, wo = _unit(r, N), _unit(r, N)
    _close(jetab.pdf_emission_dir(jd.emitters, *_j(eid, ln, wo)),
           tetab.pdf_emission_dir(td.emitters, *_t(eid, ln, wo)), "pdf_dir")
    ja, jta = jsourcing.source_emitter_mub(jd.emitters, *_j(e, k))
    ta_, tta = tsourcing.source_emitter_mub(td.emitters, *_t(e, k))
    _close(ja, ta_, "mub extent")
    _close(jta, tta, "mub tan")


def test_project():
    js = make_box_scene(res=24, spp=1).sensors[0]
    ts = tmake_box_scene(res=24, spp=1).sensors[0]
    r = np.random.default_rng(16)
    p = r.uniform([-1.5, -0.5, -1.5], [1.5, 2.5, 4.0], (N, 3)).astype(
        np.float32)
    p[:4] = [0.0, 1.0, 3.2]                 # at the eye
    for name, a, b in zip(("pxy", "visible", "cos", "dir", "dist"),
                          js.project(jnp.asarray(p)),
                          ts.project(torch.tensor(p))):
        _close(a, b, name, atol=1e-5)


def test_splat_direct_develop():
    r = np.random.default_rng(17)
    W, H, C = 20, 12, 3
    pos = np.stack([r.uniform(-1, W + 1, N), r.uniform(-1, H + 1, N)],
                   -1).astype(np.float32)
    vals = r.random((N, C)).astype(np.float32)
    vals[3, 1] = np.nan                     # non-finite lanes drop out
    mask = r.random(N) < 0.8
    jf = jfilm.make_film(W, H, C, 0.25)
    tf = tfilm.make_film(W, H, C, 0.25)
    for _ in range(2):
        jf = jfilm.splat_direct(jf, *_j(pos, vals, mask))
        tf = tfilm.splat_direct(tf, *_t(pos, vals, mask))
        jf = jfilm.splat(jf, *_j(pos, vals, mask))
        tf = tfilm.splat(tf, *_t(pos, vals, mask))
    _close(jf.direct, tf.direct, "direct")
    for n in (0.0, 4.0):
        same = tfilm.Film(*_t(jf.value, jf.weight), direct=torch.tensor(
            np.asarray(jf.direct)))
        _close(jfilm.develop(jf, n), tfilm.develop(same, n), f"develop {n}")


# ---------------------------------------------------------------------------
# integrator/plt_bdpt.py: one whole batch, per lane
# ---------------------------------------------------------------------------

def test_trace_bdpt_per_lane():
    """256 lanes (64 pixels × 4 samples) of the box at depth 4, FSD off,
    from the bridged JAX tables: the values, the light-splat values and
    positions, and `ok` per lane. `ok` and the counters must be equal.
    Values are held at rtol 1e-4 on all and 1e-5 on >= 95%. Measured: the
    largest deviation is 3.5e-5 (values) and 5.1e-5 (light splats), with
    7 of 768 and 37 of 1,725 values above 1e-5. The walks' vertices
    differ by up to 1.7e-6 m (the JAX CPU trace intersects with
    Möller–Trumbore, the port's K1 with Plücker sides), and each value
    sums up to 27 MIS-weighted strategies whose geometry terms divide by
    squared lengths and by cosines of segments that may graze a wall."""
    scene = make_box_scene(res=16, spp=4)
    scene.integrator.fsd = False
    jb = jbuild(scene)
    td = scene_data_from_numpy(_flatten(jb.data), "cpu")
    jsensor = jb.scene.sensors[0]
    tsensor = tmake_box_scene(res=16, spp=4).sensors[0]
    n = 256
    pix, sid = np.arange(n) // 4, np.arange(n) % 4
    pxy = np.stack([pix % 16, pix // 16], -1).astype(np.int32)
    eps = 1e-4 * jb.scene.world_radius()
    jkey = jrng.make_base_key(0)
    jjit = jrng.uniform(jrng.sample_key(jkey, *_j(pix, sid)),
                        jrng.D_PIXEL_JITTER, 2)
    data = jb.data.replace(spectral=jb.spectral_per_sensor[0])
    jout = jax.jit(lambda d, p, j, s: jbdpt.trace_bdpt(
        d, p, j, jkey, s, sensor=jsensor, max_depth=4, eps=eps, fsd=False,
        with_stats=True))(data, jnp.asarray(pxy), jjit,
                          jnp.asarray(sid, jnp.int32))
    jout = jax.tree.map(np.asarray, jout)
    tkey = trng.make_base_key(0)
    tjit = trng.uniform(trng.sample_key(tkey, *_t(pix, sid)),
                        trng.D_PIXEL_JITTER, 2)
    _close(jjit, tjit, "jitter")
    tout = tbdpt.trace_bdpt(td, torch.tensor(pxy), tjit, tkey,
                            torch.tensor(sid), sensor=tsensor, max_depth=4,
                            eps=eps, fsd=False, with_stats=True)
    (jpos, jval, jok, (jlp, jlv, jlok), jst) = jout
    (tpos, tval, tok, (tlp, tlv, tlok), tst) = [
        tuple(x.numpy() for x in o) if isinstance(o, tuple) else o.numpy()
        for o in tout]
    _close(jpos, tpos, "pos")
    _close(jok, tok, "ok")
    _close(jlok, tlok, "light ok")
    _close(jst, tst, "counters")
    assert jval.max() > 0 and jlok.mean() > 0.3
    _close(jlp, tlp, "light pos", rtol=1e-5, atol=1e-4)

    def held(a, b, name):
        rel = np.abs(a - b) <= 1e-5 * np.abs(a) + 1e-30
        assert rel.mean() >= 0.95, (name, rel.mean())
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=0, err_msg=name)

    held(jval, tval, "values")
    held(jlv[jlok], tlv[jlok], "light values")
