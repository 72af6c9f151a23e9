"""Port parity for the modules of the wave slice: each wave_tracer_tpu_torch
function against its JAX twin on the same seeded numpy inputs, in f32.

Smooth functions are held at rtol 1e-5 / atol 1e-6 (the two frameworks
round transcendental functions and sums differently in the last bits).
The FSD functions (aperture, UTD evaluation, coherent sum, pdf, sampling)
chain dozens of such operations and atan2/erfinv, and are held at rtol
1e-4 on the same inputs. Boolean and integer outputs must be equal,
except the edge query's ids, which must agree on >= 99.9% of lanes (an
envelope-edge entry test may flip on a last-bit difference).

The device tables come from the JAX bake of the box scene, flattened to
numpy and uploaded through the port's bridge, so both sides read the same
edge table."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_render import make_box_scene
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.accel import edges as jedges
from wave_tracer_tpu.integrator import traversal as jtrav
from wave_tracer_tpu.math import special as jspecial
from wave_tracer_tpu.ops import cone_intersect as jci
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.wave import beam as jbeam
from wave_tracer_tpu.wave import cone as jcone
from wave_tracer_tpu.wave import envelope as jenv
from wave_tracer_tpu.wave import fsd as jfsd
from wave_tracer_tpu.wave import sourcing as jsourcing
from wave_tracer_tpu.wave import utd as jutd
from wave_tracer_tpu_torch.accel import edges as tedges
from wave_tracer_tpu_torch.integrator import traversal as ttrav
from wave_tracer_tpu_torch.math import special as tspecial
from wave_tracer_tpu_torch.ops import cone_intersect as tci
from wave_tracer_tpu_torch.scene.bridge import scene_data_from_numpy
from wave_tracer_tpu_torch.wave import beam as tbeam
from wave_tracer_tpu_torch.wave import cone as tcone
from wave_tracer_tpu_torch.wave import envelope as tenv
from wave_tracer_tpu_torch.wave import fsd as tfsd
from wave_tracer_tpu_torch.wave import sourcing as tsourcing
from wave_tracer_tpu_torch.wave import utd as tutd

cap_torch_threads()

RTOL, ATOL = 1e-5, 1e-6
N = 256


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


def _env_pair(r, n, ta_max=0.1):
    rd = _unit(r, n)
    x = np.cross(rd, _unit(r, n)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    f = dict(x=x, x0=r.uniform(1e-4, 0.05, n).astype(np.float32),
             ta=r.uniform(1e-4, ta_max, n).astype(np.float32),
             e=r.uniform(1.0, 3.0, n).astype(np.float32))
    return rd, jenv.EnvState(**{k: jnp.asarray(v) for k, v in f.items()}), \
        tenv.EnvState(**{k: torch.tensor(v) for k, v in f.items()})


@pytest.fixture(scope="module")
def box():
    scene = make_box_scene(res=8, spp=1)
    jb = jbuild(scene)
    return jb.data, scene_data_from_numpy(_flatten(jb.data), "cpu")


# ---------------------------------------------------------------------------
# ops/cone_intersect.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_cone_intersect(seed):
    r = np.random.default_rng(seed)
    J = 16
    x0 = r.uniform(0.0, 0.3, (N, 1)).astype(np.float32)
    ta = r.uniform(0.0, 0.3, (N, 1)).astype(np.float32)
    ta[::7] = 0.0

    def pts():
        p = r.uniform(-1, 1, (N, J, 3)).astype(np.float32)
        p[..., 2] = r.uniform(-0.5, 5.0, (N, J))
        return p

    A, B, C = pts(), pts(), pts()
    zmin = np.full((N, J), 1e-7, np.float32)
    zmax = np.full((N, J), 4.0, np.float32)
    _close(jci.cone_contains(*_j(x0, ta, A, zmin, zmax)),
           tci.cone_contains(*_t(x0, ta, A, zmin, zmax)), "contains")
    for name, a, b in zip(("z", "s", "valid"),
                          jci.cone_edge_entry(*_j(x0, ta, A, B, zmin, zmax)),
                          tci.cone_edge_entry(*_t(x0, ta, A, B, zmin, zmax))):
        _close(a, b, f"edge {name}")
    n = np.cross(B - A, C - A).astype(np.float32)
    n[::5, :, :2] = 0.0                       # planes ⊥ the axis
    dist = np.sum(n * A, axis=-1).astype(np.float32)
    for name, a, b in zip(
            ("z", "pxy", "valid"),
            jci.cone_plane_entry(*_j(x0, ta, n, dist, zmin, zmax)),
            tci.cone_plane_entry(*_t(x0, ta, n, dist, zmin, zmax))):
        _close(a, b, f"plane {name}")
    for name, a, b in zip(
            ("z", "p", "valid"),
            jci.intersect_cone_tri(*_j(x0, ta, A, B, C, zmin, zmax)),
            tci.intersect_cone_tri(*_t(x0, ta, A, B, C, zmin, zmax))):
        _close(a, b, f"tri {name}")
    ro, xh, yh, zh = (r.normal(size=(N, 1, 3)).astype(np.float32)
                      for _ in range(4))
    e = r.uniform(1, 2, (N, 1)).astype(np.float32)
    _close(jci.to_local_scaled(*_j(ro, xh, yh, zh, e, A)),
           tci.to_local_scaled(*_t(ro, xh, yh, zh, e, A)), "to_local")


# ---------------------------------------------------------------------------
# wave/beam.py, wave/cone.py, wave/envelope.py, wave/sourcing.py
# ---------------------------------------------------------------------------

def test_beam_mub():
    r = np.random.default_rng(2)
    se = r.uniform(0.0, 1e-6, N).astype(np.float32)
    ta = r.uniform(0.0, 0.2, N).astype(np.float32)
    se[::5] = 0.0
    ta[::3] = 0.0
    k = _wavenumbers(r, N)
    for f in ("sbp", "is_mub", "minimum_uncertainty_tan_alpha",
              "minimum_uncertainty_spatial_extent", "make_mub"):
        jf, tf = getattr(jbeam, f), getattr(tbeam, f)
        if f == "minimum_uncertainty_tan_alpha":
            a, b = jf(*_j(se, k)), tf(*_t(se, k))
        elif f == "minimum_uncertainty_spatial_extent":
            a, b = jf(*_j(ta, k)), tf(*_t(ta, k))
        else:
            a, b = jf(*_j(se, ta, k)), tf(*_t(se, ta, k))
        if isinstance(a, tuple):
            for i, (x, y) in enumerate(zip(a, b)):
                _close(x, y, f"{f}[{i}]")
        else:
            _close(a, b, f)


def test_cone_through_ellipse():
    r = np.random.default_rng(3)
    ex = r.normal(size=(N, 3)).astype(np.float32) * 0.01
    ey = r.normal(size=(N, 3)).astype(np.float32) * 0.004
    ex[::9] = 0.0
    ey[::9] = 0.0                            # degenerate ellipses
    n, rd = _unit(r, N), _unit(r, N)
    ta = r.uniform(0, 0.3, N).astype(np.float32)
    p = np.zeros((N, 3), np.float32)
    jc, jsid = jcone.cone_through_ellipse(*_j(ex, ey, n, p, rd, ta))
    tc, tsid = tcone.cone_through_ellipse(*_t(ex, ey, n, p, rd, ta))
    for f in ("x", "x0", "tan_alpha", "e"):
        _close(getattr(jc, f), getattr(tc, f), f, atol=1e-5)
    _close(jsid, tsid, "sid", atol=1e-5)
    a, b, c, d = (r.normal(size=N).astype(np.float32) for _ in range(4))
    for i, (x, y) in enumerate(zip(jcone.svd2x2(*_j(a, b, c, d)),
                                   tcone.svd2x2(*_t(a, b, c, d)))):
        _close(x, y, f"svd2x2[{i}]", atol=1e-5)


def test_envelope_and_restart():
    r = np.random.default_rng(4)
    rd, jst, tst = _env_pair(r, N)
    z = r.uniform(0, 3, N).astype(np.float32)
    n = _unit(r, N)
    n = np.where(np.sum(n * rd, -1, keepdims=True) > 0, -n, n)
    wo = _unit(r, N)
    spec = r.random(N) < 0.3
    k = _wavenumbers(r, N)
    _close(jst.major(jnp.asarray(z)), tst.major(torch.tensor(z)), "major")
    _close(jst.minor(jnp.asarray(z)), tst.minor(torch.tensor(z)), "minor")
    ji = jenv.initial(jnp.asarray(rd), 0.0, 0.01)
    ti = tenv.initial(torch.tensor(rd), 0.0, 0.01)
    for f in ("x", "x0", "ta", "e"):
        _close(getattr(ji, f), getattr(ti, f), f"initial {f}")
    for name, a, b in zip(
            ("ex", "ey"),
            jenv.footprint_on_surface(jst, *_j(rd, z, n)),
            tenv.footprint_on_surface(tst, *_t(rd, z, n))):
        _close(a, b, f"footprint {name}")
    (je, jsid) = jenv.surface_scatter(jst, *_j(rd, z, n, wo, spec, k))
    (te, tsid) = tenv.surface_scatter(tst, *_t(rd, z, n, wo, spec, k))
    for f in ("x", "x0", "ta", "e"):
        _close(getattr(je, f), getattr(te, f), f"scatter {f}", atol=1e-5)
    _close(jsid, tsid, "scatter sid", atol=1e-5)
    cond = r.random(N) < 0.5
    jsel = jenv.select(jnp.asarray(cond), je, jst)
    tsel = tenv.select(torch.tensor(cond), te, tst)
    for f in ("x", "x0", "ta", "e"):
        _close(getattr(jsel, f), getattr(tsel, f), f"select {f}", atol=1e-5)
    fp = r.uniform(0, 0.05, N).astype(np.float32)
    jr = jsourcing.restart_envelope(*_j(rd, fp, k))
    tr = tsourcing.restart_envelope(*_t(rd, fp, k))
    for f in ("x", "x0", "ta", "e"):
        _close(getattr(jr, f), getattr(tr, f), f"restart {f}")


# ---------------------------------------------------------------------------
# integrator/traversal.py
# ---------------------------------------------------------------------------

def test_traversal_schedule():
    r = np.random.default_rng(5)
    lam = r.uniform(380e-9, 720e-9, N).astype(np.float32)
    _close(jtrav.segment_boundaries(jnp.asarray(lam)),
           ttrav.segment_boundaries(torch.tensor(lam)), "bounds")
    bounds = np.asarray(jtrav.segment_boundaries(jnp.asarray(lam)))
    # encounters around the boundaries, some none ahead
    zc = (bounds * r.uniform(1.0, 3.0, (N, 16))).astype(np.float32)
    zc = np.minimum.accumulate(zc[:, ::-1], axis=1)[:, ::-1].copy()
    zc[r.random((N, 16)) < 0.3] = np.inf
    t_ray = r.uniform(0, 0.2, N).astype(np.float32)
    hit = r.random(N) < 0.7
    dist_max = np.where(hit, t_ray * 1.02, 8.0).astype(np.float32)
    _, jst, tst = _env_pair(r, N)
    js = jtrav.schedule_from_minz(*_j(t_ray, hit, zc), jst,
                                  *_j(lam, dist_max))
    ts = ttrav.schedule_from_minz(*_t(t_ray, hit, zc), tst,
                                  *_t(lam, dist_max))
    for f in ("ballistic", "diffusive", "z_region", "escaped"):
        _close(getattr(js, f), getattr(ts, f), f)
    assert np.asarray(js.diffusive).any() and np.asarray(js.ballistic).any()
    _close(jtrav.region_depth(jst, js.z_region),
           ttrav.region_depth(tst, ts.z_region), "region_depth")


# ---------------------------------------------------------------------------
# math/special.py, wave/utd.py
# ---------------------------------------------------------------------------

def test_faddeeva_and_transition():
    r = np.random.default_rng(6)
    z = (r.uniform(-6, 6, N) + 1j * r.uniform(0, 6, N)).astype(np.complex64)
    _close(jspecial.faddeeva(jnp.asarray(z)),
           tspecial.faddeeva(torch.tensor(z)), "faddeeva")
    x = (np.sign(r.normal(size=N)) * 10 ** r.uniform(-4, 3, N)).astype(
        np.float32)
    _close(jspecial.utd_transition(jnp.asarray(x)),
           tspecial.utd_transition(torch.tensor(x)), "utd_transition")


def _wedges(r, n):
    nff = _unit(r, n)
    tff = np.cross(nff, _unit(r, n)).astype(np.float32)
    tff /= np.linalg.norm(tff, axis=-1, keepdims=True)
    e = np.cross(nff, tff).astype(np.float32)
    nbf = _unit(r, n)
    alpha = r.uniform(0.1, 3.0, n).astype(np.float32)
    v = r.uniform(-1, 1, (n, 3)).astype(np.float32)
    half_l = r.uniform(0.05, 0.5, n).astype(np.float32)
    return v, e, tff, nff, nbf, alpha, half_l


def test_utd():
    r = np.random.default_rng(7)
    v, e, tff, nff, nbf, alpha, half_l = _wedges(r, N)
    src = (v + r.normal(size=(N, 3)) * 2).astype(np.float32)
    dst = (v + r.normal(size=(N, 3)) * 2).astype(np.float32)
    phi = r.uniform(-7, 7, N).astype(np.float32)
    n = (2.0 - alpha / np.pi).astype(np.float32)
    for sgn in (1, -1):
        _close(jutd.utd_a(sgn, *_j(phi, n)), tutd.utd_a(sgn, *_t(phi, n)),
               "utd_a")
    for a, b in zip(jutd.fermat_point_to(*_j(v, e, tff, nff, half_l, src,
                                              dst)),
                    tutd.fermat_point_to(*_t(v, e, tff, nff, half_l, src,
                                              dst))):
        _close(a, b, "fermat_to", atol=1e-5)
    wo = _unit(r, N)
    for a, b in zip(jutd.fermat_point_dir(*_j(v, e, tff, nff, half_l, src,
                                               wo)),
                    tutd.fermat_point_dir(*_t(v, e, tff, nff, half_l, src,
                                               wo))):
        _close(a, b, "fermat_dir", rtol=1e-4, atol=1e-4)
    k = _wavenumbers(r, N)
    wi = _unit(r, N)
    ro = r.uniform(0.1, 3.0, N).astype(np.float32)
    for name, a, b in zip(
            ("Ds", "Dh"),
            jutd.utd_coefficients(*_j(k, wi, wo, ro, e, tff, nff, alpha)),
            tutd.utd_coefficients(*_t(k, wi, wo, ro, e, tff, nff, alpha))):
        _close(a, b, name, rtol=1e-4, atol=1e-9)


# ---------------------------------------------------------------------------
# accel/edges.py, wave/fsd.py
# ---------------------------------------------------------------------------

def _lanes_in_box(r, n):
    ro = r.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3)).astype(
        np.float32)
    # wide envelopes so that most lanes sweep some edges
    rd, jst, tst = _env_pair(r, n, ta_max=0.5)
    zmax = r.uniform(0.5, 4.0, n).astype(np.float32)
    return ro, rd, jst, tst, zmax


def test_edges_near_cone(box):
    jd, td = box
    r = np.random.default_rng(8)
    n = 1024
    ro, rd, jst, tst, zmax = _lanes_in_box(r, n)
    ji, jz, jc = jedges.edges_near_cone(jd.edges, *_j(ro, rd), jst,
                                       jnp.asarray(zmax), 8)
    ti, tz, tc = tedges.edges_near_cone(td.edges, *_t(ro, rd), tst,
                                        torch.tensor(zmax), 8)
    same = (np.asarray(ji) == ti.numpy()).all(1)
    assert same.mean() >= 0.999
    assert (np.asarray(jc) > 0).mean() > 0.3
    _close(np.asarray(jc)[same], tc.numpy()[same], "count")
    # entry distances: the JAX sweep runs inside a jitted loop, where XLA's
    # fusion rounds some intermediates unlike its own eager ops (which the
    # port matches bit for bit); a candidate at a membership threshold then
    # picks another entry point of the same edge (seen on 2 of 8192 slots)
    jz, tz = np.asarray(jz)[same], tz.numpy()[same]
    near = np.isclose(tz, jz, rtol=RTOL, atol=ATOL) | (np.isinf(jz)
                                                       & np.isinf(tz))
    assert near.mean() >= 0.999


def test_edge_table_refuses_clustered_sizes(box):
    """Above MAX_UNCLUSTERED_EDGES edges the integrators' edge sweep
    (`edges_in_cone`) takes the clustered sweep, as the JAX integrators
    do; at or below it the exact all-edges sweep runs. The bridge
    refuses a table that comes without its clusters. (The clustered sweep
    itself is held against the JAX package in
    test_torch_edges_clustered.py.)"""
    jd, td = box
    bare = {k: v for k, v in _flatten(jd).items()
            if not k.startswith("edge_clusters.")}
    with pytest.raises(KeyError, match="edge_clusters"):
        scene_data_from_numpy(bare, "cpu")
    big = tedges.EdgeTable(**{
        k: getattr(td.edges, k).repeat_interleave(
            tedges.MAX_UNCLUSTERED_EDGES // td.edges.count + 1, dim=0)
        for k in tedges.EDGE_KEYS})
    assert big.count > tedges.MAX_UNCLUSTERED_EDGES
    ro = torch.tensor([[0.0, 1.0, 0.5]] * 2)
    rd = torch.tensor([[-0.6, 0.0, -0.8], [0.6, 0.0, -0.8]])
    env = tenv.initial(rd, 0.0, 0.6)
    zmax = torch.full((2,), 4.0)
    clusters = tedges.EdgeClusters(**{
        k: torch.from_numpy(v) for k, v in tedges.build_edge_clusters(
            {k: getattr(big, k).numpy() for k in ("center", "p0", "p1")}
        ).items()})
    got = tedges.edges_in_cone(big, clusters, ro, rd, env, zmax, 8)
    ref = tedges.edges_near_cone_clustered(big, clusters, ro, rd, env,
                                           zmax, 8)
    assert (got[2] > 0).all()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    got = tedges.edges_in_cone(td.edges, td.edge_clusters, ro, rd, env,
                               zmax, 8)
    ref = tedges.edges_near_cone(td.edges, ro, rd, env, zmax, 8)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def apertures(box):
    jd, td = box
    r = np.random.default_rng(9)
    ro, rd, jst, tst, zmax = _lanes_in_box(r, N)
    idx, _, _ = jedges.edges_near_cone(jd.edges, *_j(ro, rd), jst,
                                       jnp.asarray(zmax), 8)
    idx = np.asarray(idx)
    wp = (ro + rd * r.uniform(0.1, 1.0, (N, 1))).astype(np.float32)
    radius = r.uniform(0.05, 1.0, N).astype(np.float32)
    jap = jfsd.build_aperture(jd.edges, *_j(idx, wp, -rd, radius))
    tap = tfsd.build_aperture(td.edges, *_t(idx, wp, -rd, radius))
    src = (ro - rd * r.uniform(0.2, 1.0, (N, 1))).astype(np.float32)
    k = _wavenumbers(r, N)
    return jd, td, jap, tap, src, wp, k, r


def test_build_aperture(apertures):
    jd, td, jap, tap, *_ = apertures
    assert np.asarray(jap.valid).any()
    for f in ("v", "half_l", "nff", "tff", "nbf", "alpha", "edge_idx",
              "valid", "w"):
        _close(getattr(jap, f), getattr(tap, f), f, rtol=1e-4, atol=1e-6)
    for a, b in zip(jfsd.aperture_face_tris(jd.edges, jap),
                    tfsd.aperture_face_tris(td.edges, tap)):
        _close(a, b, "face tris")
    je = jfsd.empty_aperture(4, 8)
    te = tfsd.empty_aperture(4, 8, device="cpu")
    for f in ("v", "edge_idx", "valid", "w"):
        _close(getattr(je, f), getattr(te, f), f"empty {f}")


def _same_aperture(jap):
    """The JAX aperture as a torch aperture (identical inputs)."""
    return tfsd.FsdAperture(**{
        f.name: torch.tensor(np.asarray(getattr(jap, f.name)))
        for f in dataclasses.fields(tfsd.FsdAperture)})


def test_fsd_eval_and_coherent_sum(apertures):
    _, _, jap, _, src, wp, k, r = apertures
    tap = _same_aperture(jap)
    jev = jfsd.fsd_eval(jap, *_j(k, src, wp))
    tev = tfsd.fsd_eval(tap, *_t(k, src, wp))
    for f in ("p", "ri", "ro", "wi", "wo", "valid"):
        _close(jev[f], tev[f], f, rtol=1e-4, atol=1e-6)
    assert np.asarray(jev["valid"]).any()
    for f in ("Ds", "Dh"):
        _close(jev[f], tev[f], f, rtol=1e-4, atol=1e-7)
    vis = r.random(N) < 0.7
    unsh = r.random((N, 8)) < 0.8
    # the coherent sum of identical inputs (its phase is (ri + ro − d)·k in
    # f32, so last-bit distance differences would move it by O(1) rad)
    tev_same = {key: torch.tensor(np.asarray(val))
                for key, val in jev.items()}
    js = jfsd.coherent_sum(jev, *_j(k, src, wp, vis, unsh))
    ts = tfsd.coherent_sum(tev_same, *_t(k, src, wp, vis, unsh))
    for a, b in zip(js, ts):
        _close(a, b, "coherent_sum", rtol=1e-4, atol=1e-6)
    _close(jfsd.fsd_intensity(*js), tfsd.fsd_intensity(*ts), "intensity",
           rtol=1e-4, atol=1e-6)


def test_fsd_sample_and_pdf(apertures):
    _, _, jap, _, src, wp, k, r = apertures
    tap = _same_aperture(jap)
    wo = _unit(r, N)
    _close(jfsd.fsd_pdf(jap, *_j(k, src, wo)),
           tfsd.fsd_pdf(tap, *_t(k, src, wo)), "pdf", rtol=1e-4, atol=1e-6)
    u4 = r.random((N, 4)).astype(np.float32)
    u4[:8, 3] = [0.0, 1e-7, 0.5, 1 - 1e-7, 0.999999, 0.25, 0.75, 0.9]
    js = jfsd.fsd_sample(jap, *_j(k, src, wp, u4))
    ts = tfsd.fsd_sample(tap, *_t(k, src, wp, u4))
    for f in ("is_direct", "valid"):
        _close(js[f], ts[f], f)
    assert not np.asarray(js["is_direct"]).all()
    for f in ("wo", "p"):
        _close(js[f], ts[f], f, rtol=1e-4, atol=1e-5)
    # the pdf of a sampled direction sits near the peak of a Gaussian in
    # azimuth of width σ = sqrt(45/(k·ri)) ~ 2e-3 rad. There the 1-ulp
    # differences of atan2 between the frameworks (on ~16% of inputs),
    # ~2.4e-7 rad at |φ| ~ π, move the pdf by (x/σ)·(2.4e-7/σ) ~ 2.4e-4
    # relative at x ~ 2σ: the pdf is held at rtol 1e-4 on >= 99% of the
    # lanes and at 1e-3 on all
    jpdf, tpdf = np.asarray(js["pdf"]), ts["pdf"].numpy()
    assert np.isclose(tpdf, jpdf, rtol=1e-4, atol=1e-5).mean() >= 0.99
    _close(jpdf, tpdf, "pdf", rtol=1e-3, atol=1e-5)


def test_torch_mod_matches_jnp_mod():
    x = np.linspace(-20, 20, 4001).astype(np.float32)
    for y in (np.pi / 2, 2 * np.pi):
        _close(jnp.mod(jnp.asarray(x), y), tutd.floor_mod(torch.tensor(x), y),
               "mod", rtol=0, atol=0)
    assert jax.numpy.asarray(0).dtype == np.int32


# ---------------------------------------------------------------------------
# integrator/plt_path.py: one wave bounce from an identical lane state
# ---------------------------------------------------------------------------

def _to_torch_state(ps):
    out = {}
    for key, val in ps.items():
        if key == "env":
            out[key] = tenv.EnvState(**{
                f.name: torch.tensor(np.asarray(getattr(val, f.name)))
                for f in dataclasses.fields(tenv.EnvState)})
        elif key == "fsd_ap":
            out[key] = _same_aperture(val)
        else:
            out[key] = torch.tensor(np.asarray(val))
    return out


def _fields(ps):
    """Flat {name: numpy array} of a lane state, lanes first."""
    out = {}
    for key, val in ps.items():
        if key == "stats":
            continue
        if dataclasses.is_dataclass(val):
            for f in dataclasses.fields(val):
                out[f"{key}.{f.name}"] = np.asarray(getattr(val, f.name))
        else:
            out[key] = np.asarray(val)
    return out


def test_wave_bounce_step():
    """One wave_bounce from the same lane state: the JAX pool's fresh
    camera lanes after one JAX bounce (so envelopes, apertures and the
    deferred FSD carry are populated), bounced once more by each package
    with the same Sobol streams. Discrete fields (activity, exclusions,
    FSD flags, the edges of valid aperture slots) must agree on >= 99% of
    lanes; on those lanes, whose traversal class therefore agrees, every
    float field is held at rtol 1e-4 (atol 1e-4 of the field's largest
    magnitude; aperture fields in valid slots only). The throughput M, its
    carry M_prev and the radiance L are held so on >= 99% of those lanes:
    the deferred coherent sum takes (ri + ro − d)·k in f32 with k ~ 1e7
    rad/m toward the bounce's hit point, whose distance the port's
    Plücker closest-hit and the JAX CPU path's Möller–Trumbore test round
    differently in the last bits, so the FSD factor of a lane whose carry
    is valid can differ by O(1e-3) (3 lanes of 1024 seen)."""
    from wave_tracer_tpu.integrator import path_compact as jpc
    from wave_tracer_tpu.integrator import plt_path as jpp
    from wave_tracer_tpu.integrator.path import N_STATS
    from wave_tracer_tpu.sampling import rng as jrng
    from wave_tracer_tpu_torch.integrator import plt_path as tpp
    from wave_tracer_tpu_torch.sampling import rng as trng

    scene = make_box_scene(res=16, spp=4)
    scene.integrator.fsd = True
    jb = jbuild(scene)
    jd = jb.data
    td = scene_data_from_numpy(_flatten(jd), "cpu")
    n, K = 512, 8
    eps = 1e-4 * scene.world_radius()
    kw = dict(eps=eps, mis=True, fsd=True, K=K, rr_depth=3, rr_floor=0.5,
              with_stats=True)
    fresh = jpc._pool_parts(scene.sensors[0], 5, eps, True, 3, 0.5, True,
                            True, True, K)[0]
    ids = jnp.arange(n, dtype=jnp.int32)
    ps, meta = fresh(jd, jrng.make_base_key(0), n, ids)
    ps["stats"] = jnp.zeros((N_STATS,), jnp.float32)
    ps = jpp.wave_bounce(jd, jd.edges, ps, jrng.depth_key_v(
        meta["keys"], meta["depth"]), meta["k"], meta["depth"], **kw)
    depth = meta["depth"] + 1
    jout = jpp.wave_bounce(jd, jd.edges, ps, jrng.depth_key_v(
        meta["keys"], depth), meta["k"], depth, **kw)

    npix = 16 * 16
    tids = torch.arange(n)
    tkeys = trng.sample_key(trng.make_base_key(0), tids % npix,
                            tids // npix)
    tdepth = torch.tensor(np.asarray(depth)).long()
    tout = tpp.wave_bounce(td, td.edges, _to_torch_state(ps),
                           trng.depth_key_v(tkeys, tdepth),
                           torch.tensor(np.asarray(meta["k"])), tdepth, **kw)

    jf, tf = _fields(jout), _fields(tout)
    assert jf.keys() == tf.keys()
    # an edge the query admits at the envelope's rim may enter one
    # package's aperture slots and not the other's; a slot that is not
    # valid carries no weight, so only valid slots' edges are compared
    for f in (jf, tf):
        f["fsd_ap.edge_idx"] = np.where(f["fsd_ap.valid"],
                                        f["fsd_ap.edge_idx"], -1)
    discrete = [k for k in jf if jf[k].dtype == bool
                or np.issubdtype(jf[k].dtype, np.integer)]
    agree = np.ones(n, bool)
    for k in discrete:
        agree &= (jf[k] == tf[k]).reshape(n, -1).all(1)
    assert agree.mean() >= 0.99
    assert np.asarray(jout["active"]).mean() > 0.3
    assert np.asarray(jout["sampled_fsd"]).any()
    valid = jf["fsd_ap.valid"][agree]
    for k in jf:
        if k in discrete:
            continue
        a, b = jf[k][agree], tf[k][agree]
        atol = 1e-4 * max(np.abs(a).max(), 1e-30)
        if k.startswith("fsd_ap."):       # only valid slots carry weight
            a, b = a[valid], b[valid]
        if k in ("M", "M_prev", "L"):
            close = np.isclose(b, a, rtol=1e-4, atol=atol)
            assert close.reshape(len(a), -1).all(1).mean() >= 0.99, k
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=atol,
                                       err_msg=k)


def test_wave_bounce_refuses_fsd_off():
    """The port's wave bounce runs with FSD on only; the renderer takes
    the classical bounce when FSD is off."""
    from wave_tracer_tpu_torch.integrator import plt_path as tpp
    with pytest.raises(NotImplementedError, match="fsd=False"):
        tpp.wave_bounce(None, None, {}, None, None, 0, eps=1e-4, mis=True,
                        fsd=False, K=8, rr_depth=3, rr_floor=0.5)


def test_wave_bounce_reads_no_unneeded_shadow_row(monkeypatch):
    """The wave bounce passes K2 need masks (the FSD legs of valid
    aperture slots of lanes whose carry is valid, NEE of surface lanes
    with a valid light sample). With every row outside those masks
    poisoned with random booleans, one bounce gives bit-identical outputs,
    counters included: nothing reads an unneeded row."""
    from wave_tracer_tpu_torch.accel import trace as ttrace
    from wave_tracer_tpu_torch.integrator import path_compact as tpc
    from wave_tracer_tpu_torch.integrator import plt_path as tpp
    from wave_tracer_tpu_torch.sampling import rng as trng
    from wave_tracer_tpu_torch.scene import build_scene as tbuild
    from wave_tracer_tpu_torch.scene.procedural import \
        make_box_scene as tmake_box_scene
    from wave_tracer_tpu_torch.sensor import film as tfilm

    scene = tmake_box_scene(res=16, spp=4)
    scene.integrator.fsd = True
    built = tbuild(scene, device="cpu")
    data = dataclasses.replace(built.data,
                               spectral=built.spectral_per_sensor[0])
    sensor = scene.sensors[0]
    eps = 1e-4 * scene.world_radius()
    _, _, init_state, body, _ = tpc._pool_parts(sensor, 8, eps, True, 3,
                                                0.5, True)
    film = tfilm.make_film(16, 16, sensor.response.channels,
                           sensor.rfilter_sigma, device="cpu")
    key = trng.make_base_key(0)
    c = init_state(data, film, key, 0, 512, "cpu")
    for _ in range(2):          # fill the pool, then populate the carry
        c = body(data, key, 16 * 16 * 4, c)
    ps, meta = c["ps"], c["meta"]
    assert ps["fsd_valid"].any() and not ps["fsd_valid"].all()
    dkeys = trng.depth_key_v({"idx": meta["idx"], "strm": meta["strm"]},
                             meta["depth"])
    kw = dict(eps=eps, mis=True, fsd=True, K=tpc.FSD_SLOTS, rr_depth=3,
              rr_floor=0.5, with_stats=True)

    def step():
        st = {k: v for k, v in ps.items()}
        return tpp.wave_bounce(data, data.edges, st, dkeys, meta["k"],
                               meta["depth"], **kw)

    clean = step()
    real = ttrace.occluded
    r = np.random.default_rng(0)
    seen = []

    def poisoned(*args, need=None, **kwargs):
        assert need is not None
        out = real(*args, need=need, **kwargs)
        seen.append(float(need.float().mean()))
        noise = torch.from_numpy(r.random(out.shape[0]) < 0.5)
        return torch.where(need, out, noise)

    monkeypatch.setattr(ttrace, "occluded", poisoned)
    dirty = step()
    assert len(seen) == 2 and all(0.0 < s < 1.0 for s in seen)
    for name, a in _fields(clean).items():
        assert np.array_equal(a, _fields(dirty)[name], equal_nan=True), name
    assert torch.equal(clean["stats"], dirty["stats"])
