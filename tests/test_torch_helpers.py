"""Port parity for the JAX package's last helpers: wave_tracer_tpu_torch
against wave_tracer_tpu on the CPU, with inputs made from a numpy seed,
and the checks of the JAX tests that cover them (tests/test_trace.py
TestTrisNearRay, tests/test_wave.py TestSpecial/TestCone/
test_edges_in_ball, tests/test_spectrum.py TestDistributions,
tests/test_util.py's Sobol pairs) on the port.

Tolerances: ids, counts and integer words bit-equal; special functions
within 1e-5 relative; geometry within 1e-5 relative (1e-6 absolute near
0); distributions and query distances within 1e-6 relative.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_threads import cap_torch_threads
from test_trace import make_geo
from wave_tracer_tpu.accel import edges as jedges
from wave_tracer_tpu.accel import trace as jtrace
from wave_tracer_tpu.bsdf import device as jdevice
from wave_tracer_tpu.core.transform import Transform
from wave_tracer_tpu.geometry import mesh as jmesh
from wave_tracer_tpu.math import dist as jdist
from wave_tracer_tpu.math import frame as jframe
from wave_tracer_tpu.math import special as jspecial
from wave_tracer_tpu.math import vec as jvec
from wave_tracer_tpu.ops import intersect as jisect
from wave_tracer_tpu.polarization import mueller as jmueller
from wave_tracer_tpu.polarization import stokes as jstokes
from wave_tracer_tpu.sampling import sobol as jsobol
from wave_tracer_tpu.sampling import warps as jwarps
from wave_tracer_tpu.spectrum import spectra as jspectra
from wave_tracer_tpu.util import log as jlog
from wave_tracer_tpu.wave import beam as jbeam
from wave_tracer_tpu.wave import cone as jcone
from wave_tracer_tpu.wave.envelope import EnvState as JEnv
from wave_tracer_tpu_torch.accel import edges as tedges
from wave_tracer_tpu_torch.accel import trace as ttrace
from wave_tracer_tpu_torch.bsdf import device as tdevice
from wave_tracer_tpu_torch.math import dist as tdist
from wave_tracer_tpu_torch.math import frame as tframe
from wave_tracer_tpu_torch.math import special as tspecial
from wave_tracer_tpu_torch.math import vec as tvec
from wave_tracer_tpu_torch.ops import intersect as tisect
from wave_tracer_tpu_torch.polarization import mueller as tmueller
from wave_tracer_tpu_torch.polarization import stokes as tstokes
from wave_tracer_tpu_torch.sampling import sobol as tsobol
from wave_tracer_tpu_torch.sampling import warps as twarps
from wave_tracer_tpu_torch.spectrum import spectra as tspectra
from wave_tracer_tpu_torch.util import log as tlog
from wave_tracer_tpu_torch.wave import beam as tbeam
from wave_tracer_tpu_torch.wave import cone as tcone
from wave_tracer_tpu_torch.wave.envelope import EnvState as TEnv

cap_torch_threads()

GEO_KEYS = ("p0", "e1", "e2", "tri_geom", "tri_attr", "mxu_center")


def _t(*xs):
    out = [torch.from_numpy(np.array(x)) for x in xs]
    return out[0] if len(out) == 1 else out


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# math/dist.py (tests/test_spectrum.py:17-41)
# ---------------------------------------------------------------------------

class TestDistributions:
    def test_piecewise_linear_sampling_matches_pdf(self):
        x = np.array([0.0, 1.0, 2.0, 4.0])
        f = np.array([0.0, 2.0, 1.0, 0.0])
        d = tdist.build_piecewise_linear(x, f, device="cpu")
        np.testing.assert_allclose(float(d.total), 3.5, rtol=1e-6)
        u = torch.linspace(0.001, 0.999, 4001)
        xs, pdf = d.sample(u)
        hist, edges = np.histogram(xs.numpy(), bins=32, range=(0, 4),
                                   density=True)
        centers = 0.5 * (edges[1:] + edges[:-1])
        np.testing.assert_allclose(hist, d.pdf(centers).numpy(), atol=0.06)
        np.testing.assert_allclose(pdf.numpy(), d.pdf(xs).numpy(),
                                   atol=1e-4)

    def test_piecewise_linear_integral(self):
        x = np.linspace(0, np.pi, 200)
        d = tdist.build_piecewise_linear(x, np.sin(x), device="cpu")
        np.testing.assert_allclose(float(d.integral(0.0, np.pi)), 2.0,
                                   rtol=1e-3)
        np.testing.assert_allclose(float(d.integral(0.5, 1.0)),
                                   np.cos(0.5) - np.cos(1.0), rtol=1e-3)

    def test_discrete(self):
        d = tdist.build_discrete([1.0, 2.0, 3.0], [1.0, 2.0, 1.0],
                                device="cpu")
        i, pos, pmf = d.sample(torch.tensor(0.5))
        assert int(i) == 1 and float(pos) == 2.0
        np.testing.assert_allclose(float(pmf), 0.5)
        np.testing.assert_allclose(float(d.pmf(torch.tensor(0))), 0.25)

    def test_matches_jax(self):
        r = np.random.default_rng(0)
        x = np.sort(r.uniform(0, 10, 40))
        f = np.abs(r.normal(size=40))
        f[5:8] = 0.0
        jd, td = jdist.build_piecewise_linear(x, f), \
            tdist.build_piecewise_linear(x, f, device="cpu")
        for k in ("x", "f", "cdf", "total"):
            np.testing.assert_array_equal(getattr(td, k).numpy(),
                                          np.asarray(getattr(jd, k)))
        u = r.random(2000).astype(np.float32)
        for a, b in zip(td.sample(_t(u)), jd.sample(jnp.asarray(u))):
            _close(a.numpy(), b, rtol=1e-6, atol=1e-6)
        q = r.uniform(-1, 11, 500).astype(np.float32)
        _close(td.pdf(_t(q)).numpy(), jd.pdf(jnp.asarray(q)), rtol=1e-6)
        lo, hi = np.sort(r.uniform(-1, 11, (2, 50)).astype(np.float32), 0)
        _close(td.integral(*_t(lo, hi)).numpy(),
               jd.integral(jnp.asarray(lo), jnp.asarray(hi)), rtol=1e-5)
        w = r.random(17)
        jq, tq = jdist.build_discrete(x[:17], w), \
            tdist.build_discrete(x[:17], w, device="cpu")
        i, pos, pmf = tq.sample(_t(u))
        ji, jpos, jpmf = jq.sample(jnp.asarray(u))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        _close(pmf.numpy(), jpmf, rtol=1e-6)


# ---------------------------------------------------------------------------
# math/special.py (tests/test_wave.py:31)
# ---------------------------------------------------------------------------

class TestSpecial:
    def test_fresnel_vs_scipy(self):
        import scipy.special as ss
        t = np.linspace(-4, 4, 201)
        S_ref, C_ref = ss.fresnel(t)
        C, S = tspecial.fresnel_cs(_t(t.astype(np.float32)))
        np.testing.assert_allclose(C.numpy(), C_ref, atol=5e-5)
        np.testing.assert_allclose(S.numpy(), S_ref, atol=5e-5)

    @pytest.mark.parametrize("name", ["faddeeva_any", "erfc_complex",
                                      "erf_complex"])
    def test_complex_functions_match_jax(self, name):
        r = np.random.default_rng(2)
        z = (r.uniform(-3, 3, 800) + 1j * r.uniform(-3, 3, 800)).astype(
            np.complex64)
        want = np.asarray(getattr(jspecial, name)(jnp.asarray(z)))
        got = getattr(tspecial, name)(_t(z)).numpy()
        err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        assert err.max() < 1e-5

    def test_fresnel_matches_jax(self):
        t = np.linspace(-6, 6, 601).astype(np.float32)
        for a, b in zip(tspecial.fresnel_cs(_t(t)),
                        jspecial.fresnel_cs(jnp.asarray(t))):
            _close(a.numpy(), b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# ops/intersect.py, accel/trace.py: tris_near_ray (tests/test_trace.py:
# 186-226), cone_tri_entry_point, trace_brute, occluded_brute
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sphere_geo():
    jgeo, _ = make_geo(jmesh.sphere([0, 0, 0], 1.0, tessellation=24))
    tgeo = ttrace.GeoArrays(**{k: _t(getattr(jgeo, k)) for k in GEO_KEYS})
    return jgeo, tgeo


class TestTrisNearRay:
    def test_direct_hit_and_graze(self, sphere_geo):
        _, geo = sphere_geo
        idx, z, cnt = ttrace.tris_near_ray(
            geo, torch.tensor([[0.0, 0, -3]]), torch.tensor([[0.0, 0, 1]]),
            torch.tensor([0.05]), torch.tensor([0.0]), torch.tensor([10.0]),
            16)
        assert int(cnt[0]) > 0
        assert abs(float(z[0, 0]) - 2.0) < 0.1

    def test_miss_with_envelope_capture(self, sphere_geo):
        _, geo = sphere_geo
        ro = torch.tensor([[1.2, 0, -3]])
        rd = torch.tensor([[0.0, 0, 1]])
        cnt0 = ttrace.tris_near_ray(geo, ro, rd, torch.tensor([0.01]),
                                    torch.tensor([0.0]),
                                    torch.tensor([10.0]), 16)[2]
        cnt1 = ttrace.tris_near_ray(geo, ro, rd, torch.tensor([0.5]),
                                    torch.tensor([0.0]),
                                    torch.tensor([10.0]), 16)[2]
        assert int(cnt0[0]) == 0 and int(cnt1[0]) > 0

    def test_ordered_by_z(self, sphere_geo):
        _, geo = sphere_geo
        idx, z, cnt = ttrace.tris_near_ray(
            geo, torch.tensor([[0.0, 0, -3]]), torch.tensor([[0.0, 0, 1]]),
            torch.tensor([0.3]), torch.tensor([0.05]), torch.tensor([10.0]),
            16)
        zz = z[0, :int(cnt[0])].numpy()
        assert (np.diff(zz) >= -1e-6).all()

    def test_matches_jax(self, sphere_geo):
        jgeo, tgeo = sphere_geo
        r = np.random.default_rng(4)
        n = 64
        ro = (3.0 * _unit(r, n)).astype(np.float32)
        rd = 0.5 * r.normal(size=(n, 3)).astype(np.float32) - ro
        rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(
            np.float32)
        x0 = r.uniform(0.0, 0.05, n).astype(np.float32)
        ta = r.uniform(0.0, 0.05, n).astype(np.float32)
        zmax = np.full(n, 10.0, np.float32)
        ji, jz, jc = map(np.asarray, jtrace.tris_near_ray(
            jgeo, *map(jnp.asarray, (ro, rd, x0, ta, zmax)), 8))
        ti, tz, tc = (a.numpy() for a in ttrace.tris_near_ray(
            tgeo, *_t(ro, rd, x0, ta, zmax), 8))
        assert jc.sum() > 50 and (ti == ji).mean() >= 0.995
        same = (ti == ji) & (ji >= 0)
        _close(tz[same], jz[same], rtol=1e-5)
        # the entry point into each lane's first triangle
        x = np.cross(rd, [0.0, 0.57, 0.8])
        x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
        e = r.uniform(1.0, 3.0, n).astype(np.float32)
        tri = ji[:, 0].astype(np.int32)
        zmin = np.full(n, 1e-7, np.float32)
        a = jtrace.cone_tri_entry_point(
            jgeo, jnp.asarray(ro), jnp.asarray(rd),
            JEnv(*map(jnp.asarray, (x, x0, ta, e))), jnp.asarray(tri),
            jnp.asarray(zmin), jnp.asarray(zmax))
        b = ttrace.cone_tri_entry_point(
            tgeo, *_t(ro, rd), TEnv(*_t(x, x0, ta, e)), *_t(tri, zmin, zmax))
        ok = np.asarray(a[2])
        np.testing.assert_array_equal(b[2].numpy(), ok)
        assert ok.sum() > 20
        _close(b[0].numpy()[ok], np.asarray(a[0])[ok])
        _close(b[1].numpy()[ok], np.asarray(a[1])[ok])


def test_brute_ray_queries_match_jax_and_k1_k2(sphere_geo):
    jgeo, tgeo = sphere_geo
    r = np.random.default_rng(6)
    n = 512
    ro = (3.0 * _unit(r, n)).astype(np.float32)
    rd = 0.8 * r.normal(size=(n, 3)).astype(np.float32) - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = r.uniform(1.5, 5.0, n).astype(np.float32)
    args = (ro, rd, tmin, tmax)
    jt, ji, ju, jv = map(np.asarray, jtrace.trace_brute(
        jgeo, *map(jnp.asarray, args)))
    tt, ti, tu, tv = (a.numpy() for a in ttrace.trace_brute(tgeo,
                                                            *_t(*args)))
    assert (ji >= 0).sum() > 100
    assert (ti == ji).mean() >= 0.995
    same = ti == ji
    _close(tt[same], jt[same])
    _close(tu[same], ju[same], atol=1e-5)
    # K1's plain version agrees on the hits
    kt, ki, _, _ = ttrace.trace(tgeo, *_t(*args))
    assert (ki.numpy() == ti).mean() >= 0.995
    ex = np.where(ji >= 0, ji, -1).astype(np.int32)
    jo = np.asarray(jtrace.occluded_brute(jgeo, *map(jnp.asarray, args),
                                          jnp.asarray(ex)))
    to = ttrace.occluded_brute(tgeo, *_t(*args), _t(ex)).numpy()
    assert (to == jo).mean() >= 0.995 and jo.any() and not jo.all()
    ko = ttrace.occluded(tgeo, *_t(*args), _t(ex)).numpy()
    assert (ko == to).mean() >= 0.995


def test_point_queries_match_jax():
    r = np.random.default_rng(7)
    n = 1000
    p, a, b, c = (r.normal(size=(n, 3)).astype(np.float32)
                  for _ in range(4))
    jd, jtp = jisect.point_segment_dist2(*map(jnp.asarray, (p, a, b)))
    td, ttp = tisect.point_segment_dist2(*_t(p, a, b))
    _close(td.numpy(), jd)
    _close(ttp.numpy(), jtp)
    want = np.asarray(jisect.tri_point_closest(*map(jnp.asarray,
                                                     (p, a, b, c))))
    _close(tisect.tri_point_closest(*_t(p, a, b, c)).numpy(), want,
           rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# accel/edges.py: edges_in_ball (tests/test_wave.py:138), edges_near_ray,
# edges_near_ray_clustered
# ---------------------------------------------------------------------------

def test_edges_in_ball_cube_corner():
    soup = jmesh.cube(1.0)
    et = tedges.EdgeTable(**{k: _t(v) for k, v in tedges.classify_edges(
        soup.positions, soup.geo_n).items()})
    idx, dist, cnt = tedges.edges_in_ball(
        et, torch.tensor([[0.5, 0.5, 0.5], [10.0, 0.0, 0.0]]),
        torch.tensor([0.3, 0.1]), K=8)
    assert int(cnt[0]) == 3 and int(cnt[1]) == 0


@pytest.fixture(scope="module")
def cube_city():
    """300 seeded unit-ish cubes: 3,600 wedge edges, clustered."""
    r = np.random.default_rng(8)
    soups = []
    for _ in range(300):
        s, (tx, ty, tz) = r.uniform(0.2, 0.8), r.uniform(-10, 10, 3)
        soups.append(jmesh.cube(s, Transform.from_rows(
            [1, 0, 0, tx, 0, 1, 0, ty, 0, 0, 1, tz, 0, 0, 0, 1])))
    soup = jmesh.TriangleSoup.concatenate(soups)
    jet = jedges.classify_edges(soup.positions, soup.geo_n)
    jcl = jedges.build_edge_clusters(jet)
    tnp = tedges.classify_edges(soup.positions, soup.geo_n)
    tet = tedges.EdgeTable(**{k: _t(v) for k, v in tnp.items()})
    tcl = tedges.EdgeClusters(**{k: _t(v) for k, v in
                                 tedges.build_edge_clusters(tnp).items()})
    assert tet.count == jet.count > 2048
    return jet, jcl, tet, tcl


def test_edges_in_ball_matches_jax(cube_city):
    jet, _, tet, _ = cube_city
    r = np.random.default_rng(9)
    c = r.uniform(-10, 10, (256, 3)).astype(np.float32)
    rad = r.uniform(0.1, 1.5, 256).astype(np.float32)
    ji, jd, jc = map(np.asarray, jedges.edges_in_ball(
        jet, jnp.asarray(c), jnp.asarray(rad), 8))
    ti, td, tc = (a.numpy() for a in tedges.edges_in_ball(tet, *_t(c, rad),
                                                          8))
    assert jc.sum() > 100
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tc, jc)
    _close(td, jd, rtol=1e-6)


@pytest.mark.parametrize("clustered", [False, True])
def test_edges_near_ray_matches_jax(cube_city, clustered):
    jet, jcl, tet, tcl = cube_city
    r = np.random.default_rng(10)
    n = 256
    ro = r.uniform(-12, 12, (n, 3)).astype(np.float32)
    rd = (r.uniform(-10, 10, (n, 3)) - ro).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    x0 = r.uniform(0.0, 0.2, n).astype(np.float32)
    ta = r.uniform(0.0, 0.05, n).astype(np.float32)
    zmax = np.full(n, 40.0, np.float32)
    args = (ro, rd, x0, ta, zmax)
    if clustered:
        ji, jz, jc = map(np.asarray, jedges.edges_near_ray_clustered(
            jet, jcl, *map(jnp.asarray, args), 8))
        ti, tz, tc = (a.numpy() for a in tedges.edges_near_ray_clustered(
            tet, tcl, *_t(*args), 8))
    else:
        ji, jz, jc = map(np.asarray, jedges.edges_near_ray(
            jet, *map(jnp.asarray, args), 8))
        ti, tz, tc = (a.numpy() for a in tedges.edges_near_ray(
            tet, *_t(*args), 8))
    assert jc.sum() > 100
    assert (tc == jc).mean() >= 0.995
    # edges meeting at a cube's corner share its closest approach: such
    # ties part on the last bit, so slots are compared where z is unique
    both = np.isfinite(tz) & np.isfinite(jz)
    _close(tz[both], jz[both], rtol=1e-5)
    zs = np.where(np.isfinite(jz), jz, 1e30)
    gap = np.abs(np.diff(zs, axis=1)) > 1e-5 * np.abs(zs[:, 1:])
    unique = np.ones_like(ji, bool)
    unique[:, 1:] &= gap
    unique[:, :-1] &= gap
    unique[:, -1] = False           # its tie may lie past the K cut
    unique &= ji >= 0
    assert unique.sum() > 100
    assert (ti == ji)[unique].mean() >= 0.995


# ---------------------------------------------------------------------------
# wave/cone.py (tests/test_wave.py:45), wave/beam.py
# ---------------------------------------------------------------------------

def test_ray_cone_contains_axes():
    c = tcone.ray_cone(torch.zeros((1, 3)), torch.tensor([[0.0, 0.0, 1.0]]),
                       tan_alpha=torch.tensor([0.1]))
    a, b = c.axes(torch.tensor([2.0]))
    np.testing.assert_allclose(a.numpy(), [0.2], atol=1e-6)
    np.testing.assert_allclose(b.numpy(), [0.2], atol=1e-6)
    assert bool(c.contains(torch.tensor([[0.1, 0.0, 2.0]]))[0])
    assert not bool(c.contains(torch.tensor([[0.3, 0.0, 2.0]]))[0])


@pytest.fixture(scope="module")
def cones():
    r = np.random.default_rng(11)
    n = 256
    o = r.normal(size=(n, 3)).astype(np.float32)
    d = _unit(r, n)
    x0 = r.uniform(0.0, 0.1, n).astype(np.float32)
    ta = r.uniform(0.0, 0.2, n).astype(np.float32)
    x0[:8] = ta[:8] = 0.0                       # degenerate rays
    jc = jcone.ray_cone(*map(jnp.asarray, (o, d, ta, x0)))
    tc = tcone.ray_cone(*_t(o, d, ta, x0))
    return r, jc, tc


def test_ray_cone_and_its_methods_match_jax(cones):
    r, jc, tc = cones
    for f in ("o", "d", "x", "x0", "tan_alpha", "e"):
        _close(getattr(tc, f).numpy(), getattr(jc, f))
    n = tc.x0.shape[0]
    z = r.uniform(0.0, 5.0, n).astype(np.float32)
    p = r.normal(size=(n, 3)).astype(np.float32)
    d2 = r.normal(size=(n, 2)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    for a, b in zip(tc.axes(_t(z)), jc.axes(jnp.asarray(z))):
        _close(a.numpy(), b)
    _close(tc.y.numpy(), jc.y)
    _close(tc.z_apex.numpy(), jc.z_apex)
    _close(tc.to_local(_t(p)).numpy(), jc.to_local(jnp.asarray(p)))
    _close(tc.radius(_t(z), _t(d2)).numpy(),
           jc.radius(jnp.asarray(z), jnp.asarray(d2)))
    np.testing.assert_array_equal(tc.contains(_t(p), 0.0, 3.0).numpy(),
                                  np.asarray(jc.contains(jnp.asarray(p),
                                                         0.0, 3.0)))
    _close(tc.project_local(_t(p), _t(z)).numpy(),
           jc.project_local(jnp.asarray(p), jnp.asarray(z)), rtol=1e-4)
    np.testing.assert_array_equal(tc.is_ray().numpy(),
                                  np.asarray(jc.is_ray()))


def test_cone_through_ellipsoid_matches_jax():
    r = np.random.default_rng(12)
    n = 256
    axes = r.uniform(0.01, 1.0, (n, 3)).astype(np.float32)
    nrm = _unit(r, n)
    jf = jframe.build_orthogonal_frame(jnp.asarray(nrm))
    tf = tframe.build_orthogonal_frame(_t(nrm))
    ro = r.normal(size=(n, 3)).astype(np.float32)
    rd = _unit(r, n)
    ta = r.uniform(0.0, 0.1, n).astype(np.float32)
    jc = jcone.cone_through_ellipsoid(jnp.asarray(axes), jf, jnp.asarray(ro),
                                      jnp.asarray(rd), jnp.asarray(ta))
    tc = tcone.cone_through_ellipsoid(_t(axes), tf, *_t(ro, rd, ta))
    for f in ("x", "x0", "tan_alpha", "e"):
        got, want = getattr(tc, f).numpy(), np.asarray(getattr(jc, f))
        if f == "x":                             # an axis: up to its sign
            got = got * np.sign((got * want).sum(-1, keepdims=True))
        _close(got, want, rtol=1e-4, atol=1e-5)


def test_beam_wavefront_and_footprints_match_jax(cones):
    r, jc, tc = cones
    n = tc.x0.shape[0]
    major = r.uniform(0.0, 1.0, n).astype(np.float32)
    minor = (major * r.uniform(0.1, 1.0, n)).astype(np.float32)
    jsx, jsy = jbeam.wavefront_sigma(jnp.asarray(major), jnp.asarray(minor))
    tsx, tsy = tbeam.wavefront_sigma(*_t(major, minor))
    _close(tsx.numpy(), jsx)
    _close(tsy.numpy(), jsy)
    _close(tbeam.wavefront_amplitude(tsx, tsy).numpy(),
           jbeam.wavefront_amplitude(jsx, jsy))
    p2 = r.normal(scale=0.2, size=(n, 2)).astype(np.float32)
    _close(tbeam.wavefront_density(_t(p2), tsx, tsy).numpy(),
           jbeam.wavefront_density(jnp.asarray(p2), jsx, jsy), rtol=1e-4)
    rr = r.uniform(0.0, 0.5, n).astype(np.float32)
    _close(tbeam.wavefront_mass_in_radius(_t(rr), tsx, tsy).numpy(),
           jbeam.wavefront_mass_in_radius(jnp.asarray(rr), jsx, jsy))
    z = r.uniform(0.0, 5.0, n).astype(np.float32)
    for a, b in zip(tbeam.beam_footprint_axes(tc, _t(z)),
                    jbeam.beam_footprint_axes(jc, jnp.asarray(z))):
        _close(a.numpy(), b)
    d, nn = _unit(r, n), _unit(r, n)
    for a, b in zip(tbeam.surface_footprint_ellipse(tc, _t(z), *_t(d, nn)),
                    jbeam.surface_footprint_ellipse(
                        jc, jnp.asarray(z), jnp.asarray(d), jnp.asarray(nn))):
        _close(a.numpy(), b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the small rest: vec, frame, mueller, stokes, sobol (tests/test_util.py),
# warps, spectra, bsdf/device, util/log
# ---------------------------------------------------------------------------

def test_vec_helpers_match_jax():
    r = np.random.default_rng(13)
    wi, n = _unit(r, 100), _unit(r, 100)
    _close(tvec.reflect(*_t(wi, n)).numpy(),
           jvec.reflect(jnp.asarray(wi), jnp.asarray(n)))
    v = tvec.vec3(1.0, torch.tensor([2.0, 3.0]), 4)
    np.testing.assert_array_equal(v.numpy(), np.asarray(
        jvec.vec3(1.0, jnp.asarray([2.0, 3.0]), 4)))
    assert v.dtype == torch.float32
    for name in ("x_", "y_", "z_"):
        np.testing.assert_array_equal(getattr(tvec, name)(_t(wi)).numpy(),
                                      np.asarray(getattr(jvec, name)(wi)))
    np.testing.assert_array_equal(tdevice.vecz(_t(wi)).numpy(),
                                  np.asarray(jdevice.vecz(wi)))


def test_rotate_frame_matches_jax():
    r = np.random.default_rng(14)
    n = _unit(r, 50)
    q, _ = np.linalg.qr(r.normal(size=(50, 3, 3)))
    q = q.astype(np.float32)
    jf = jframe.rotate_frame(jnp.asarray(q), jframe.build_orthogonal_frame(
        jnp.asarray(n)))
    tf = tframe.rotate_frame(_t(q), tframe.build_orthogonal_frame(_t(n)))
    for f in ("t", "b", "n"):
        _close(getattr(tf, f).numpy(), getattr(jf, f))


def test_polarization_helpers_match_jax():
    r = np.random.default_rng(15)
    th = r.uniform(-3, 3, 64).astype(np.float32)
    _close(tmueller.linear_polarizer(_t(th)).numpy(),
           jmueller.linear_polarizer(jnp.asarray(th)))
    S = r.normal(size=(64, 4)).astype(np.float32)
    S[:, 0] = np.abs(S[:, 0]) + 2.0
    np.testing.assert_array_equal(tstokes.intensity(_t(S)).numpy(),
                                  np.asarray(jstokes.intensity(S)))
    _close(tstokes.dop(_t(S)).numpy(), jstokes.dop(jnp.asarray(S)))
    # a polarizer fully polarizes unpolarized light, halving it
    out = tmueller.apply(tmueller.linear_polarizer(_t(th)),
                         tstokes.unpolarized(torch.ones(64)))
    _close(tstokes.dop(out).numpy(), np.ones(64))
    _close(tstokes.intensity(out).numpy(), np.full(64, 0.5))


def test_sobol_sample2():
    """tests/test_util.py's 2D check, and the JAX pairs bit for bit."""
    n = 256
    idx = torch.arange(n)
    pts = tsobol.sample2(idx, 0, torch.zeros(n, dtype=torch.int64)).numpy()
    counts = np.bincount((pts[:, 0] > 0.5).astype(int) * 2
                         + (pts[:, 1] > 0.5).astype(int), minlength=4)
    np.testing.assert_allclose(counts, n / 4, atol=2)
    seed = np.random.default_rng(16).integers(0, 2**32, n, dtype=np.uint64)
    for pair in (0, 1, 3):
        want = np.asarray(jsobol.sample2(jnp.arange(n), pair,
                                         jnp.asarray(seed, jnp.uint32)))
        got = tsobol.sample2(idx, pair, _t(seed.astype(np.int64))).numpy()
        np.testing.assert_array_equal(got, want)


def test_warps_and_spectra_helpers_match_jax():
    r = np.random.default_rng(17)
    u = r.random((200, 2)).astype(np.float32)
    _close(twarps.uniform_hemisphere(_t(u)).numpy(),
           jwarps.uniform_hemisphere(jnp.asarray(u)))
    assert twarps.uniform_hemisphere_pdf() == jwarps.uniform_hemisphere_pdf()
    cc = r.uniform(-1, 1, 50).astype(np.float32)
    sa = twarps.solid_angle_of_cone(_t(cc))
    _close(sa.numpy(), jwarps.solid_angle_of_cone(jnp.asarray(cc)))
    _close(twarps.uniform_cone_pdf(sa).numpy(),
           jwarps.uniform_cone_pdf(jnp.asarray(sa.numpy())))
    n01 = r.normal(size=(200, 2)).astype(np.float32)
    sig = r.uniform(0.1, 2.0, 200).astype(np.float32)
    _close(twarps.gaussian2d(*_t(n01, sig)).numpy(),
           jwarps.gaussian2d(jnp.asarray(n01), jnp.asarray(sig)))
    lam = np.array([380e-9, 550e-9, 1e-3])
    np.testing.assert_array_equal(tspectra.wavelength_to_wavenumber(lam),
                                  jspectra.wavelength_to_wavenumber(lam))
    k = tspectra.wavelength_to_wavenumber(lam)
    np.testing.assert_allclose(tspectra.wavenumber_to_wavelength(k), lam,
                               rtol=1e-15)


def test_progress_bar_matches_jax(monkeypatch):
    outs = []
    for mod in (jlog, tlog):
        clock = iter([100.0, 101.0, 102.5, 104.0])
        monkeypatch.setattr(mod.time, "time", lambda: next(clock))
        buf = io.StringIO()
        bar = mod.ProgressBar("render", 40, width=20, stream=buf)
        for done in (10, 10, 40):
            bar.update(done)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "100.0%" in outs[1] and outs[1].endswith("\n")
