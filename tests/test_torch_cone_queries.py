"""Port parity for the JAX package's other cone queries and the triangle
clusters: wave_tracer_tpu_torch against wave_tracer_tpu on the CPU, with
inputs made from a numpy seed.

* `traversal.schedule` equals the JAX function decision for decision,
  and `tris_near_cone` + `schedule` equals K3's plain minima +
  `schedule_from_minz` wherever K covers every encounter (as
  tests/test_traversal.py holds the JAX pair).
* `tris_near_cone`, `tris_near_cone_2pass`, `tris_near_cone_clustered`
  (64 cones of tests/test_trace.py's generator on its 9,216-triangle
  sphere): slots equal on ≥ 99.5% (the JAX jitted loops round some
  entries differently), z within 1e-5 relative where they agree;
  `tris_in_ball_clustered` bit-equal in ids and counts.
* `build_tri_clusters` bit-equal; both bakes carry `tri_clusters.*`, the
  bridge requires them.
* The blocked-flux ball query (bdpt and Fraunhofer): above
  `tri_cluster_min()` triangles the JAX package takes the clustered query.
  On the sphere with the threshold lowered the two routes differ (the
  clustered query expands only the 12 nearest clusters, the brute one
  ranks every triangle): the port routes as the JAX package does.
* The wave box under every WT_CONE_QUERY mode against the JAX render at
  PERF.md §2's wave bars, and the box with a 1,280-triangle icosphere
  under the default query and "mxu" (its other modes:
  tests/test_torch_cone_query_renders.py).
"""

import contextlib
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_render import make_box_scene
from test_torch_threads import cap_torch_threads
import test_trace
from test_trace import make_geo
from wave_tracer_tpu.accel import trace as jtrace
from wave_tracer_tpu.geometry import mesh as jmesh
from wave_tracer_tpu.integrator import plt_bdpt as jbdpt
from wave_tracer_tpu.integrator import traversal as jtrav
from wave_tracer_tpu.render import render_scene as jrender
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.wave.envelope import EnvState as JEnv
from wave_tracer_tpu_torch.accel import trace as ttrace
from wave_tracer_tpu_torch.integrator import plt_bdpt as tbdpt
from wave_tracer_tpu_torch.integrator import traversal as ttrav
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.scene import build as tbuild
from wave_tracer_tpu_torch.scene.bridge import (SPECTRAL_KEYS,
                                                scene_data_from_numpy)
from wave_tracer_tpu_torch.scene.build import BuiltScene
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene
from wave_tracer_tpu_torch.wave.envelope import EnvState as TEnv

cap_torch_threads()

K = 8
N_CONES = 64
GEO_KEYS = ("p0", "e1", "e2", "tri_geom", "tri_attr", "mxu_center")
MODES = ("", "mxu", "topk", "2pass", "clustered")
RES, SPP, DEPTH, LANES = 16, 2, 4, 256
COUNTERS = ("rays_cast", "surface_interactions", "fsd_interactions",
            "diffusive_traversals", "sum_path_depth")


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.fixture(scope="module")
def sphere():
    """The 9,216-triangle sphere of tests/test_trace.py (JAX bake, BVH
    order), the same rows as a port GeoArrays, and both cluster sets."""
    jgeo, _ = make_geo(jmesh.sphere([0, 0, 0], 1.0, tessellation=48))
    tgeo = ttrace.GeoArrays(**{k: torch.from_numpy(np.array(
        getattr(jgeo, k))) for k in GEO_KEYS})
    jcl = jtrace.build_tri_clusters(jgeo.p0, jgeo.e1, jgeo.e2)
    tcl_np = ttrace.build_tri_clusters(np.asarray(jgeo.p0),
                                       np.asarray(jgeo.e1),
                                       np.asarray(jgeo.e2))
    tcl = ttrace.TriClusters(**{k: torch.from_numpy(v)
                                for k, v in tcl_np.items()})
    return dict(jgeo=jgeo, tgeo=tgeo, jcl=jcl, tcl=tcl, tcl_np=tcl_np)


@pytest.fixture(scope="module")
def cones():
    """tests/test_trace.py's seeded cones: origins on a radius-3 sphere,
    aimed near the unit sphere, x0 in [0.005, 0.05], ta in [0, 0.08]."""
    jro, jrd, jenv = test_trace.TestClusteredTriQueries()._random_cones(
        N_CONES)
    tro, trd = _t(jro, jrd)
    tenv = TEnv(*_t(jenv.x, jenv.x0, jenv.ta, jenv.e))
    zmax = np.full(N_CONES, 10.0, np.float32)
    return dict(j=(jro, jrd, jenv, jnp.asarray(zmax)),
                t=(tro, trd, tenv, torch.from_numpy(zmax)))


def _query(name, side, sphere):
    geo = sphere[f"{side}geo"]
    mod = jtrace if side == "j" else ttrace
    if name == "clustered":
        return lambda *a, **kw: mod.tris_near_cone_clustered(
            geo, sphere[f"{side}cl"], *a, **kw)
    fn = {"topk": mod.tris_near_cone, "2pass": mod.tris_near_cone_2pass}
    return lambda *a, **kw: fn[name](geo, *a, **kw)


@pytest.mark.parametrize("name", ["topk", "2pass", "clustered"])
def test_cone_set_query_matches_jax(name, sphere, cones):
    ji, jz, jc = map(np.asarray, _query(name, "j", sphere)(*cones["j"], K))
    ti, tz, tc = (x.numpy() for x in _query(name, "t", sphere)(
        *cones["t"], K))
    assert jc.sum() > 100
    assert (ti == ji).mean() >= 0.995
    assert (tc == jc).mean() >= 0.995
    same = (ti == ji) & (ji >= 0)
    np.testing.assert_allclose(tz[same], jz[same], rtol=1e-5)
    assert (np.isfinite(tz) == (ti >= 0)).all()


def test_cone_set_query_exclusion(sphere, cones):
    """exclude_tri drops a lane's triangle from every query."""
    ro, rd, env, zmax = cones["t"]
    first = ttrace.tris_near_cone(sphere["tgeo"], ro, rd, env, zmax, K)[0]
    ex = first[:, 0]
    for name in ("topk", "2pass", "clustered"):
        idx = _query(name, "t", sphere)(ro, rd, env, zmax, K,
                                        exclude_tri=ex)[0]
        assert not ((idx == ex[:, None]) & (ex[:, None] >= 0)).any(), name


def test_ball_query_clustered_matches_jax(sphere):
    r = np.random.default_rng(1)
    c = r.normal(scale=1.1, size=(N_CONES, 3)).astype(np.float32)
    rad = r.uniform(0.02, 0.3, N_CONES).astype(np.float32)
    ji, jd, jc = map(np.asarray, jtrace.tris_in_ball_clustered(
        sphere["jgeo"], sphere["jcl"], jnp.asarray(c), jnp.asarray(rad), K))
    ti, td, tc = (x.numpy() for x in ttrace.tris_in_ball_clustered(
        sphere["tgeo"], sphere["tcl"], *_t(c, rad), K))
    assert jc.sum() > 50
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(td, jd, rtol=1e-5)


def test_schedule_matches_jax():
    r = np.random.default_rng(5)
    n = 512
    lam = r.uniform(4e-7, 7e-7, n).astype(np.float32)
    t_ray = r.uniform(1e-4, 3.0, n).astype(np.float32)
    hit = r.random(n) < 0.7
    t_ray[~hit] = 1e30
    tz = np.sort(r.uniform(1e-5, 3.0, (n, K)).astype(np.float32), axis=1)
    tz[r.random((n, K)) < 0.3] = np.inf
    tz = np.sort(tz, axis=1)
    x0 = r.uniform(0.0, 1e-3, n).astype(np.float32)
    ta = r.uniform(0.0, 1e-3, n).astype(np.float32)
    dmax = r.uniform(1.0, 4.0, n).astype(np.float32)
    x = np.tile(np.float32([1, 0, 0]), (n, 1))
    e = np.ones(n, np.float32)
    a = jtrav.schedule(jnp.asarray(t_ray), jnp.asarray(hit), jnp.asarray(tz),
                       JEnv(*map(jnp.asarray, (x, x0, ta, e))),
                       jnp.asarray(lam), jnp.asarray(dmax))
    b = ttrav.schedule(*_t(t_ray, hit, tz), TEnv(*_t(x, x0, ta, e)),
                       *_t(lam, dmax))
    for f in ("ballistic", "diffusive", "escaped", "z_region"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
    assert b.diffusive.any() and b.ballistic.any() and b.escaped.any()


def test_schedule_from_set_equals_schedule_from_minz():
    """tests/test_traversal.py's check of the JAX pair, on the port: the
    K-capped set + `schedule` decides as the per-boundary minima (K3's
    plain version) + `schedule_from_minz` wherever K = 16 covers every
    encounter."""
    jgeo, _ = make_geo(jmesh.sphere([0, 0, 0], 1.0, tessellation=16))
    geo = ttrace.GeoArrays(**{k: torch.from_numpy(np.array(
        getattr(jgeo, k))) for k in GEO_KEYS})
    n = 128
    r = np.random.default_rng(5)
    ro = r.normal(size=(n, 3))
    ro = 3.0 * ro / np.linalg.norm(ro, axis=1, keepdims=True)
    rd = 0.4 * r.normal(size=(n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    x = np.cross(rd, [0.0, 0.57, 0.8])
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    env = TEnv(*_t(np.float32(x), np.float32(r.uniform(0.001, 0.02, n)),
                   np.float32(r.uniform(0.0, 0.03, n)),
                   np.ones(n, np.float32)))
    ro, rd = _t(np.float32(ro), np.float32(rd))
    zmax = torch.full((n,), 10.0)
    lam = torch.full((n,), 5e-4)
    t_ray = torch.full((n,), 2.0)
    ray_hit = torch.ones((n,), dtype=torch.bool)
    _, tz, cnt = ttrace.tris_near_cone(geo, ro, rd, env, zmax, 16)
    a = ttrav.schedule(t_ray, ray_hit, tz, env, lam, zmax)
    zc, cnt2 = ttrace.cone_boundary_minz(
        geo, ro, rd, env, ttrav.segment_boundaries(lam), zmax)
    b = ttrav.schedule_from_minz(t_ray, ray_hit, zc, env, lam, zmax)
    covered = cnt < 16
    assert covered.float().mean() > 0.5
    for f in ("ballistic", "diffusive", "escaped"):
        np.testing.assert_array_equal(getattr(a, f)[covered].numpy(),
                                      getattr(b, f)[covered].numpy(),
                                      err_msg=f)
    np.testing.assert_allclose(b.z_region[covered].numpy(),
                               a.z_region[covered].numpy(), rtol=1e-5,
                               atol=1e-6)
    assert (cnt2 >= cnt).all()


@pytest.mark.parametrize("which", ["sphere", "box_icosphere"])
def test_build_tri_clusters_equals_jax(which, sphere):
    if which == "sphere":
        g = sphere["jgeo"]
        p0, e1, e2 = g.p0, g.e1, g.e2
        ours = sphere["tcl_np"]
    else:
        soup = jmesh.TriangleSoup.concatenate(
            [s.soup for s in _with_icosphere(make_box_scene(8, 1)).shapes])
        p = soup.positions
        p0, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
        ours = ttrace.build_tri_clusters(np.asarray(p0), np.asarray(e1),
                                         np.asarray(e2), cap=16)
    theirs = jtrace.build_tri_clusters(p0, e1, e2,
                                       cap=64 if which == "sphere" else 16)
    for k in ttrace.TRI_CLUSTER_KEYS:
        a = np.asarray(getattr(theirs, k))
        assert ours[k].dtype == a.dtype, k
        np.testing.assert_array_equal(ours[k], a, err_msg=k)
    order = ours["order"]
    assert sorted(order.tolist()) == list(range(len(np.asarray(p0))))
    assert (ours["count"] <= (64 if which == "sphere" else 16)).all()


def _with_icosphere(scene, mesh_mod=jmesh, shape_cls=None):
    """The box with a 1,280-triangle icosphere inside it."""
    if shape_cls is None:
        from wave_tracer_tpu.scene.model import Shape as shape_cls
    scene.shapes.append(shape_cls(
        mesh_mod.sphere([0.3, 0.6, -0.2], 0.4, tessellation=24),
        scene.shapes[0].material))
    return scene


def _t_icosphere(scene):
    from wave_tracer_tpu_torch.geometry import mesh as tmesh
    from wave_tracer_tpu_torch.scene.model import Shape
    return _with_icosphere(scene, tmesh, Shape)


@pytest.mark.parametrize("route", ["soup", "bvh"])
def test_bake_carries_tri_clusters(route, monkeypatch):
    """The port's bake clusters its triangle tables as they are stored
    (on the BVH route after the leaf-order permutation), as the JAX bake
    clusters its BVH-ordered tables; the bridge uploads them."""
    if route == "bvh":
        monkeypatch.setattr(ttrace, "MXU_MAX_TRIS", 1024)
    scene = _t_icosphere(tmake_box_scene(8, 1))
    arrays, _ = tbuild.bake_scene_arrays(scene)
    want = ttrace.build_tri_clusters(arrays["geo.p0"], arrays["geo.e1"],
                                     arrays["geo.e2"], cap=ttrace.TRI_CAP)
    for k in ttrace.TRI_CLUSTER_KEYS:
        np.testing.assert_array_equal(arrays[f"tri_clusters.{k}"], want[k])
    data = scene_data_from_numpy(arrays, "cpu")
    assert data.tri_clusters.num_clusters == len(want["center"])
    assert data.tri_clusters.order.dtype == torch.int32
    if route == "bvh":
        # the same leaf order as the JAX bake's: the same clusters
        jb = jbuild(_with_icosphere(make_box_scene(8, 1)))
        for k in ttrace.TRI_CLUSTER_KEYS:
            np.testing.assert_array_equal(
                arrays[f"tri_clusters.{k}"],
                np.asarray(getattr(jb.data.tri_clusters, k)), err_msg=k)


def test_bridge_requires_tri_clusters():
    jb = jbuild(make_box_scene(8, 1))
    arrays = _flatten(jb.data)
    data = scene_data_from_numpy(arrays, "cpu")
    np.testing.assert_array_equal(data.tri_clusters.order.numpy(),
                                  np.asarray(jb.data.tri_clusters.order))
    bare = {k: v for k, v in arrays.items()
            if not k.startswith("tri_clusters.")}
    with pytest.raises(KeyError, match="tri_clusters"):
        scene_data_from_numpy(bare, "cpu")


def test_tri_cluster_min(monkeypatch):
    monkeypatch.delenv("WT_TRI_CLUSTER_MIN", raising=False)
    assert ttrace.tri_cluster_min("cpu") == 16384
    assert ttrace.tri_cluster_min(torch.device("cuda")) == 1 << 30
    monkeypatch.setenv("WT_TRI_CLUSTER_MIN", "77")
    assert ttrace.tri_cluster_min("cpu") == 77


def _flux_args(seed=7, n=256):
    """Seeded beams that end near the unit sphere, with the interaction
    depth and wavefront sigma of the bdpt FSD block."""
    r = np.random.default_rng(seed)
    ro = r.normal(size=(n, 3))
    ro = 3.0 * ro / np.linalg.norm(ro, axis=1, keepdims=True)
    rd = 0.6 * r.normal(size=(n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    fx = np.cross(rd, [0.0, 0.57, 0.8])
    fx /= np.linalg.norm(fx, axis=1, keepdims=True)
    fy = np.cross(rd, fx)
    z = r.uniform(1.6, 2.4, n)
    x0 = r.uniform(0.01, 0.25, n)
    ta = r.uniform(0.0, 0.05, n)
    fp = x0 + ta * z
    return [np.asarray(a, np.float32)
            for a in (ro, rd, fx, fy, z, 2.0 * fp, x0, ta, fp / 3.0)]


def test_blocked_flux_routes_as_jax(sphere, monkeypatch):
    """On the sphere with the cluster threshold lowered below its 9,216
    triangles, the JAX `_blocked_flux` takes `tris_in_ball_clustered`, and
    its result differs from the brute route's on some beams (so a port
    that always took the brute query differed from it too). The port
    takes the same route: it equals the JAX clustered result, and with the
    default CPU threshold (16,384) the JAX brute one. The JAX threshold is
    cached per process, so the JAX route is forced by replacing its
    function here, never through the variable."""
    args = _flux_args()
    jgeo, tgeo = sphere["jgeo"], sphere["tgeo"]
    jbrute = np.asarray(jbdpt._blocked_flux(jgeo, *map(jnp.asarray, args)))
    monkeypatch.setattr(jtrace, "tri_cluster_min", lambda: 1024)
    jclus = np.asarray(jbdpt._blocked_flux(jgeo, *map(jnp.asarray, args),
                                           tri_clusters=sphere["jcl"]))
    assert (jbrute > 0).sum() > 100
    # the finding: the routes differ on a few beams, by up to ~6e-3
    assert (np.abs(jclus - jbrute) > 1e-4).sum() >= 1

    monkeypatch.delenv("WT_TRI_CLUSTER_MIN", raising=False)
    tdef = tbdpt._blocked_flux(tgeo, *_t(*args),
                               tri_clusters=sphere["tcl"]).numpy()
    np.testing.assert_allclose(tdef, jbrute, atol=1e-5)
    monkeypatch.setenv("WT_TRI_CLUSTER_MIN", "1024")
    tlow = tbdpt._blocked_flux(tgeo, *_t(*args),
                               tri_clusters=sphere["tcl"]).numpy()
    np.testing.assert_allclose(tlow, jclus, atol=1e-5)


# ---------------------------------------------------------------------------
# the wave box under each WT_CONE_QUERY mode
# ---------------------------------------------------------------------------

def _wave(scene):
    scene.integrator.fsd = True
    scene.integrator.max_depth = DEPTH
    return scene


@contextlib.contextmanager
def cone_query(mode, jax=False):
    """WT_CONE_QUERY set to mode ("" unsets it) for a block; for a JAX
    render also the JAX renderer's stepped driver (WT_COMPACT_MODE), which
    compiles one bounce instead of the whole pool loop: the same image and
    counters, a third less compile time."""
    names = ("WT_CONE_QUERY", "WT_COMPACT_MODE")
    prev = {k: os.environ.pop(k, None) for k in names}
    if mode:
        os.environ["WT_CONE_QUERY"] = mode
    if jax:
        os.environ["WT_COMPACT_MODE"] = "stepped"
    try:
        yield
    finally:
        for k in names:
            os.environ.pop(k, None)
            if prev[k] is not None:
                os.environ[k] = prev[k]


@pytest.fixture(scope="module")
def box_renders():
    """The JAX default render of the box, and the port's own bake under
    each mode. On the 12-triangle box every query sees every encounter (2
    passes keep J = 32 ≥ 12 candidates, 12 clusters cover the box's 8), so
    the JAX package's modes render one image: its default is the
    reference of each."""
    with cone_query("", jax=True):
        jimg, jst = jrender(jbuild(_wave(make_box_scene(res=RES, spp=SPP))),
                            spp=SPP, batch_lanes=LANES)
    built = tbuild.build_scene(_wave(tmake_box_scene(res=RES, spp=SPP)),
                               device="cpu")
    out = {}
    for mode in MODES:
        with cone_query(mode):
            out[mode] = render_scene(built, device="cpu", pool_lanes=LANES)
    return (jimg, jst), out, built.data.geo.num_tris


def _icosphere_scene():
    """The box with a 1,280-triangle icosphere inside it (1,292 tris)."""
    from wave_tracer_tpu.scene.model import Shape
    return _wave(_with_icosphere(make_box_scene(res=RES, spp=SPP), jmesh,
                                 Shape))


def icosphere_renders(jax_modes, port_modes):
    """JAX renders of the icosphere box per mode (each a fresh scene, so
    a fresh trace that reads the mode) and the port's, per mode, from the
    bridged bake of the first."""
    jax_out, built = {}, None
    for mode in jax_modes:
        with cone_query(mode, jax=True):
            jb = jbuild(_icosphere_scene())
            jax_out[mode] = jrender(jb, spp=SPP, batch_lanes=LANES)
        if built is None:
            arrays = _flatten(jb.data)
            built = BuiltScene.upload(
                _wave(tmake_box_scene(res=RES, spp=SPP)), arrays,
                [{k: arrays[f"spectral.{k}"] for k in SPECTRAL_KEYS}], "cpu")
    port_out = {}
    for mode in port_modes:
        with cone_query(mode):
            port_out[mode] = render_scene(built, device="cpu",
                                          pool_lanes=LANES)
    return jax_out, port_out, built.data.geo.num_tris


def assert_wave_bars(img, jimg, st, jst, counters=COUNTERS):
    """PERF.md §2's wave bars."""
    assert img.shape == jimg.shape and np.isfinite(img).all()
    np.testing.assert_allclose(img.mean((0, 1)), jimg.mean((0, 1)),
                               rtol=0.02)
    assert np.corrcoef(img.ravel(), jimg.ravel())[0, 1] >= 0.999
    scale = np.maximum(np.abs(jimg), np.abs(jimg).mean())
    assert (np.abs(img - jimg) <= 1e-2 * scale).all(-1).mean() >= 0.90
    for k in counters:
        a, b = st["device_counters"][k], jst["device_counters"][k]
        assert abs(a - b) <= 0.02 * b, (k, a, b)


@pytest.mark.parametrize("mode", MODES)
def test_wave_box_under_cone_query_matches_jax(mode, box_renders):
    (jimg, jst), out, T = box_renders
    img, st = out[mode]
    assert st["mode"] == "wave-compact"
    assert_wave_bars(img, jimg, st, jst)
    per_lane = {"topk": T, "2pass": 32, "clustered":
                ttrace.TRI_N_CLUSTERS * ttrace.TRI_CAP}.get(mode, T)
    dc = st["device_counters"]
    assert dc["cone_tri_tests"] > 0
    # the cone-test counter counts each query's tests per lane
    lanes = dc["ray_tri_tests"] / (T * 19)     # 2 + (2K + 1) traces
    assert dc["cone_tri_tests"] == pytest.approx(lanes * per_lane,
                                                 rel=1e-6)
    if mode == "mxu":       # the default's minima, bit for bit
        np.testing.assert_array_equal(img, out[""][0])


@pytest.fixture(scope="module")
def icosphere():
    return icosphere_renders(("",), ("", "mxu", "topk"))


@pytest.mark.parametrize("mode", ["", "mxu"])
def test_icosphere_wave_render_default_query_matches_jax(mode, icosphere):
    """The box with a 1,280-triangle icosphere under the default query and
    "mxu" (the other modes: tests/test_torch_cone_query_renders.py); the
    K-capped topk query sees fewer diffusive regions there (the JAX
    package's renders: 1,090 against 1,055 at this size)."""
    jax_out, port_out, T = icosphere
    assert T == 1292
    jimg, jst = jax_out[""]
    img, st = port_out[mode]
    assert st["mode"] == "wave-compact"
    assert_wave_bars(img, jimg, st, jst, COUNTERS + ("cone_tri_tests",))
    np.testing.assert_array_equal(img, port_out[""][0])
    dc = port_out["topk"][1]["device_counters"]
    assert dc["diffusive_traversals"] < st["device_counters"][
        "diffusive_traversals"]
