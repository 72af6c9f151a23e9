"""The JAX package's last switches in the port, against the JAX package on
the CPU: WT_TRACE_BACKEND (the ray queries' route), WT_COMPACT_MODE and
WT_COMPACT_LANES (the compacted render's driver and pool width).

* Route parity: for every value of WT_TRACE_BACKEND and triangle counts
  about both limits, the port's `trace` / `occluded` call the function
  the JAX package's call (K1/K2 for its all-pairs MXU kernels, K4/K5 for
  its lock-step BVH, the brute queries for its), and
  `ray_tests_per_lane` is equal. The JAX side runs with
  `platform_is_tpu` patched to True for the values that keep the
  platform's choice: the port's default is the JAX package's TPU route.
* The brute route keeps `trace`'s need/carry contract and
  `occluded`'s need, and its derivatives; its row slices change nothing.
* Renders of the box (12 triangles) under WT_TRACE_BACKEND=brute on both
  sides (both test triangles by Möller–Trumbore in one triangle order) at
  the bars of PERF.md §2, and the wave bounce step per lane.
* The BVH route below 2^17 triangles (BRUTE_THRESHOLD lowered to 1024 in
  both packages, the box with a 1,280-triangle icosphere): the queries
  on the JAX package's bridged tree, the port's own bake, a render.
* No silent fallback: a BVH route without a tree raises, and so do the
  entry points that default to the card when there is none.
* The pool's switches: both WT_COMPACT_MODE values give one film, bit for
  bit; WT_COMPACT_LANES takes the default width's place as in the JAX
  renderer, and the stats report the width.
* Forward-mode pixel maps through `trace_paths` under brute against
  `jax.jvp` under the same value, per lane.

The JAX renderer caches its compiled pool kernels under a key without
the route, so every JAX render here starts from an empty cache.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_render import make_box_scene
from test_torch_bvh import _with_sphere
from test_torch_gradients import (BACK_WALL, _translate_j, _translate_t,
                                  emitter_rows, jax_scaled, lanes,
                                  port_jvp, port_scaled)
from test_torch_cuda import SMALL_TREES, small_tree, small_tree_tables
from test_torch_threads import cap_torch_threads
from test_torch_wave_modules import _fields, _to_torch_state
from wave_tracer_tpu.accel import bvh as jbvh
from wave_tracer_tpu.accel import mxu_trace as jmxu
from wave_tracer_tpu.accel import trace as jtrace
from wave_tracer_tpu.geometry import mesh as jmesh
from wave_tracer_tpu.integrator.path import trace_paths as jtrace_paths
from wave_tracer_tpu.render import render_scene as jrender
from wave_tracer_tpu.render import renderer as jrenderer
from wave_tracer_tpu.sampling import rng as jrng
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.scene.model import Shape as JShape
from wave_tracer_tpu_torch.accel import bvh_kernels, ray_kernels
from wave_tracer_tpu_torch.accel import trace as ttrace
from wave_tracer_tpu_torch.geometry import mesh
from wave_tracer_tpu_torch.integrator.path import trace_paths
from wave_tracer_tpu_torch.math import dist as tdist
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.render import renderer as trenderer
from wave_tracer_tpu_torch.scene import bridge
from wave_tracer_tpu_torch.scene.bridge import (SPECTRAL_KEYS,
                                                scene_data_from_numpy)
from wave_tracer_tpu_torch.scene.build import (BuiltScene, bake_scene_arrays,
                                               build_scene)
from wave_tracer_tpu_torch.scene.model import Shape
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene
from wave_tracer_tpu_torch.wave import fraunhofer as tfr
from wave_tracer_tpu_torch.wave import fsd as tfsd

cap_torch_threads()

RES, SPP, DEPTH, LANES = 16, 2, 5, 1024
N_RAYS = 1000
# a value the JAX package does not know keeps the platform's choice
VALUES = (None, "auto", "mxu", "bvh", "brute", "cpu", "gpu")
COUNTS = (12, 2048, 2049, 131072, 131073)
CLASSICAL_COUNTERS = ("rays_cast", "shadow_rays", "surface_interactions",
                      "rr_terminations", "sum_path_depth")
WAVE_COUNTERS = ("rays_cast", "surface_interactions", "fsd_interactions",
                 "diffusive_traversals", "sum_path_depth")
# counted over live lanes only, so a pool's width cannot move them
LANE_COUNTERS = ("rays_cast", "rr_terminations", "sum_path_depth",
                 "edge_sweep_hits", "ballistic_traversals",
                 "diffusive_traversals")


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


def _set_backend(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("WT_TRACE_BACKEND", raising=False)
    else:
        monkeypatch.setenv("WT_TRACE_BACKEND", value)


def classical_bars(img, ref, st, st_ref):
    """PERF.md §2, classical: channel means within 1%, >= 98% of pixels
    within 1e-3·max(|ref|, mean|ref|), counters within 0.5%; returns the
    share of pixels."""
    assert np.isfinite(img).all() and img.mean() > 0
    np.testing.assert_allclose(img.mean((0, 1)), ref.mean((0, 1)),
                               rtol=0.01)
    scale = np.maximum(np.abs(ref), np.abs(ref).mean())
    share = (np.abs(img - ref) <= 1e-3 * scale).all(-1).mean()
    assert share >= 0.98
    for k in CLASSICAL_COUNTERS:
        a, b = st["device_counters"][k], st_ref["device_counters"][k]
        assert abs(a - b) <= 0.005 * b, (k, a, b)
    return share


def wave_bars(img, ref, st, st_ref):
    """PERF.md §2, wave: channel means within 2%, Pearson >= 0.999, >= 90%
    of pixels within 1e-2·max(|ref|, mean|ref|), counters within 2%."""
    assert np.isfinite(img).all() and img.mean() > 0
    np.testing.assert_allclose(img.mean((0, 1)), ref.mean((0, 1)),
                               rtol=0.02)
    assert np.corrcoef(img.ravel(), ref.ravel())[0, 1] >= 0.999
    scale = np.maximum(np.abs(ref), np.abs(ref).mean())
    share = (np.abs(img - ref) <= 1e-2 * scale).all(-1).mean()
    assert share >= 0.90
    for k in WAVE_COUNTERS:
        a, b = st["device_counters"][k], st_ref["device_counters"][k]
        assert abs(a - b) <= 0.02 * b, (k, a, b)
    return share


def _counting(monkeypatch):
    """Calls of the K1/K2 and K4/K5 wrappers' CPU twins."""
    calls = {"k1k2": 0, "bvh": 0}

    def counted(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    for mod, name, key in ((ray_kernels, "_closest_ref", "k1k2"),
                           (ray_kernels, "_anyhit_ref", "k1k2"),
                           (bvh_kernels, "_closest_ref", "bvh"),
                           (bvh_kernels, "_anyhit_ref", "bvh")):
        monkeypatch.setattr(mod, name, counted(getattr(mod, name), key))
    return calls


# ---------------------------------------------------------------------------
# route parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", COUNTS)
@pytest.mark.parametrize("value", VALUES, ids=lambda v: v or "unset")
def test_route_matches_jax(value, T, monkeypatch):
    _set_backend(monkeypatch, value)
    if value not in ("bvh", "brute", "cpu"):
        monkeypatch.setattr(jtrace, "platform_is_tpu", lambda: True)
    took = []

    def recorder(name):
        def record(*a, **k):
            took.append(name)
        return record
    for name in ("trace_brute", "trace_bvh", "occluded_brute",
                 "occluded_bvh"):
        monkeypatch.setattr(jtrace, name, recorder(name.split("_")[1]))
        monkeypatch.setattr(ttrace, name, recorder(name.split("_")[1]))
    for name in ("trace_mxu", "occluded_mxu"):
        monkeypatch.setattr(jmxu, name, recorder("kernels"))
    for name in ("trace_rays", "occluded_rays"):
        monkeypatch.setattr(ray_kernels, name, recorder("kernels"))
    geo = types.SimpleNamespace(num_tris=T)
    ray = (torch.zeros((1, 3)), torch.ones((1, 3)), torch.zeros(1),
           torch.ones(1))
    jtrace.trace(geo, *ray)
    ttrace.trace(geo, *ray)
    jtrace.occluded(geo, *ray)
    ttrace.occluded(geo, *ray)
    assert took[0] == took[1] == took[2] == took[3] == ttrace.route(T), took
    assert len(took) == 4
    assert ttrace.ray_tests_per_lane(geo) == jtrace.ray_tests_per_lane(geo)


# ---------------------------------------------------------------------------
# the brute route's contract
# ---------------------------------------------------------------------------

def _soup_rays(T=700, N=512, seed=0):
    r = np.random.default_rng(seed)
    p0 = (r.normal(size=(T, 3)) * 2 + 5.0).astype(np.float32)
    e1 = r.normal(size=(T, 3)).astype(np.float32)
    e2 = r.normal(size=(T, 3)).astype(np.float32)
    tri_geom = np.concatenate([p0, e1, e2, np.zeros((T, 3), np.float32)], 1)
    t = torch.from_numpy
    geo = ttrace.GeoArrays(p0=t(p0), e1=t(e1), e2=t(e2),
                           tri_geom=t(tri_geom),
                           tri_attr=torch.zeros((T, 32)),
                           mxu_center=t(p0.mean(0)))
    ro = (r.normal(size=(N, 3)) * 3 + 5.0).astype(np.float32)
    rd = r.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tmin = np.full(N, 1e-4, np.float32)
    tmax = np.where(np.arange(N) % 2 == 0, 1e30,
                    r.uniform(1.0, 6.0, N)).astype(np.float32)
    need = t(r.random(N) < 0.4)
    return geo, tuple(map(t, (ro, rd, tmin, tmax))), need, r


def test_brute_need_and_carry(monkeypatch):
    """Rows off `need` return their carry (t, tri) bit for bit (a miss
    without one) with u/v of the carried triangle; the needed rows equal
    a trace of all. occluded: needed rows as a test of all, the others
    False, with one to three exclusions."""
    monkeypatch.setenv("WT_TRACE_BACKEND", "brute")
    geo, rays, need, r = _soup_rays()
    N, T = rays[0].shape[0], geo.num_tris
    _, first, _, _ = ttrace.trace_brute(geo, *rays)
    ex = torch.where(torch.arange(N) % 3 > 0, first, -1)
    full = ttrace.trace_brute(geo, *rays, ex)
    assert 0.2 < (full[1] >= 0).float().mean() < 1.0
    carry = (full[0] + 0.5, torch.roll(full[1], 1))
    got = ttrace.trace(geo, *rays, ex, need=need, carry=carry)
    for a, b in zip(got, full):
        assert torch.equal(a[need], b[need])
    assert torch.equal(got[0][~need], carry[0][~need])
    assert torch.equal(got[1][~need], carry[1][~need])
    _, _, cu, cv = ray_kernels.solve_hits(geo.tri_geom, *rays[:2], *carry)
    assert torch.equal(got[2][~need], cu[~need])
    assert torch.equal(got[3][~need], cv[~need])
    t0, i0, u0, v0 = ttrace.trace(geo, *rays, ex, need=need)
    assert (i0[~need] == -1).all() and (t0[~need] == ttrace.isect.BIG).all()
    assert (u0[~need] == 0).all() and (v0[~need] == 0).all()
    ex3 = np.full((N, 3), -1, np.int32)
    ex3[:, 0] = first.numpy()
    ex3[1::2, 1] = r.integers(0, T, len(ex3[1::2]))
    ex3[::4, 2] = r.integers(0, T, len(ex3[::4]))
    exs = [torch.from_numpy(ex3[:, c]) for c in range(3)]
    o_all = ttrace.occluded_brute(geo, *rays, *exs)
    assert 0.2 < o_all.float().mean() < 0.9
    o = ttrace.occluded(geo, *rays, *exs, need=need)
    assert torch.equal(o[need], o_all[need]) and not o[~need].any()


@pytest.mark.parametrize("query", ["trace", "occluded"])
def test_brute_row_slices_change_nothing(query, monkeypatch):
    """The brute queries test rows in slices of at most _CONE_PAIRS (row,
    triangle) pairs: 37 rows a slice (14 slices, the last one short) give
    the one-slice result bit for bit, need/carry and exclusions included,
    and no rows give empty results."""
    monkeypatch.setenv("WT_TRACE_BACKEND", "brute")
    geo, rays, need, _ = _soup_rays()
    N = rays[0].shape[0]
    ex = torch.where(torch.arange(N) % 3 > 0,
                     torch.arange(N, dtype=torch.int32) % geo.num_tris, -1)
    if query == "trace":
        carry = (torch.full((N,), 2.0), torch.arange(N, dtype=torch.int32))
        run = lambda *a: ttrace.trace(geo, *a, ex[:len(a[0])],  # noqa: E731
                                      need=need[:len(a[0])],
                                      carry=tuple(c[:len(a[0])]
                                                  for c in carry))
    else:
        run = lambda *a: (ttrace.occluded(  # noqa: E731
            geo, *a, ex[:len(a[0])], need=need[:len(a[0])]),)
    one = run(*rays)
    pairs = dict(ttrace._CONE_PAIRS, cpu=37 * ttrace._TRI_TILE)
    monkeypatch.setattr(ttrace, "_CONE_PAIRS", pairs)
    assert len(ttrace._row_slices(N, geo.num_tris, "cpu")) == 14
    sliced = run(*rays)
    for a, b in zip(sliced, one):
        assert torch.equal(a, b)
    for x in run(*(v[:0] for v in rays)):
        assert x.shape == (0,)


def test_brute_derivatives_through_carry():
    """Forward mode w.r.t. the ray origins: traced rows take the
    Möller–Trumbore derivative of their winner; carried rows (their own
    hit carried) the same derivative from `solve_hits`."""
    geo, rays, need, _ = _soup_rays(seed=2)
    ro, rd, tmin, tmax = rays
    dro = torch.from_numpy(np.random.default_rng(9).normal(
        size=tuple(ro.shape)).astype(np.float32))
    t_all, i_all, _, _ = ttrace.trace_brute(geo, *rays)
    _, dt_all = port_jvp(lambda o: ttrace.trace_brute(
        geo, o, rd, tmin, tmax)[0], ro, dro)
    _, dt = port_jvp(lambda o: ttrace.trace_brute(
        geo, o, rd, tmin, tmax, need=need, carry=(t_all, i_all))[0], ro, dro)
    hit = i_all >= 0
    assert torch.equal(dt[need & hit], dt_all[need & hit])
    torch.testing.assert_close(dt[~need & hit], dt_all[~need & hit],
                               rtol=1e-5, atol=1e-6)
    assert (dt_all[hit] != 0).all()


# ---------------------------------------------------------------------------
# the box under brute on both sides
# ---------------------------------------------------------------------------

def _box(fsd, res=RES, spp=SPP, depth=DEPTH, jax_side=True):
    scene = (make_box_scene if jax_side else tmake_box_scene)(res=res,
                                                              spp=spp)
    scene.integrator.fsd = fsd
    scene.integrator.max_depth = depth
    return scene


def _bridged(jb, tscene):
    arrays = _flatten(jb.data)
    spectral = {k: arrays[f"spectral.{k}"] for k in SPECTRAL_KEYS}
    return BuiltScene.upload(tscene, arrays, [spectral], "cpu")


@pytest.mark.parametrize("fsd", [False, True], ids=["classical", "wave"])
def test_brute_render_matches_jax(fsd, monkeypatch):
    """The box at 16×16 × 2 spp, depth 5, on the JAX package's bridged
    tables, WT_TRACE_BACKEND=brute and WT_CONE_QUERY=mxu on both sides;
    the port's K1/K2 and K4/K5 twins never run."""
    monkeypatch.setenv("WT_TRACE_BACKEND", "brute")
    monkeypatch.setenv("WT_CONE_QUERY", "mxu")
    monkeypatch.setenv("WT_COMPACT_MODE", "stepped")
    monkeypatch.setattr(jrenderer, "_kernel_cache", {})
    jb = jbuild(_box(fsd))
    jimg, jst = jrender(jb, spp=SPP, batch_lanes=LANES)
    calls = _counting(monkeypatch)
    img, st = render_scene(_bridged(jb, _box(fsd, jax_side=False)),
                           device="cpu", pool_lanes=LANES)
    assert calls == {"k1k2": 0, "bvh": 0}
    assert st["mode"] == jst["mode"] == ("wave-compact" if fsd
                                         else "ray-compact")
    assert img.shape == jimg.shape == (RES, RES, 3)
    if fsd:
        wave_bars(img, jimg, st, jst)
    else:
        # one test, one triangle order: every pixel within the bar
        assert classical_bars(img, jimg, st, jst) == 1.0


def test_brute_wave_bounce_step_matches_jax(monkeypatch):
    """test_torch_wave_modules.py::test_wave_bounce_step on 1,024 lanes
    with both packages' ray queries on the brute route (and the cone
    query on K3's reference), at the tightest bars this supports. With
    the port's default route (Plücker K1 against the JAX package's
    Möller–Trumbore) 4 lanes of 1,024 differ in a discrete field and 3
    of the others exceed rtol 1e-4 in M. Here the hits agree, and what
    is left is the edge query's rim test on last-bit differences (3
    lanes: an edge in a valid aperture slot of one package only) and one
    lane's M (the coherent sum's phase (ri + ro − d)·k, k ~ 1e7 rad/m).
    So: discrete fields agree on all but at most 3 lanes; on the others
    every float field is held per lane at rtol 1e-4 (atol 1e-4 of the
    field's largest magnitude; aperture fields in valid slots only), M,
    M_prev and L on all but at most one lane (test_wave_bounce_step:
    99% of lanes for each bar)."""
    from wave_tracer_tpu.integrator import path_compact as jpc
    from wave_tracer_tpu.integrator import plt_path as jpp
    from wave_tracer_tpu.integrator.path import N_STATS
    from wave_tracer_tpu_torch.integrator import plt_path as tpp
    from wave_tracer_tpu_torch.sampling import rng as trng

    monkeypatch.setenv("WT_TRACE_BACKEND", "brute")
    monkeypatch.setenv("WT_CONE_QUERY", "mxu")
    scene = make_box_scene(res=16, spp=4)
    scene.integrator.fsd = True
    jd = jbuild(scene).data
    td = scene_data_from_numpy(_flatten(jd), "cpu")
    n, K = 1024, 8
    eps = 1e-4 * scene.world_radius()
    kw = dict(eps=eps, mis=True, fsd=True, K=K, rr_depth=3, rr_floor=0.5,
              with_stats=True)
    fresh = jpc._pool_parts(scene.sensors[0], 5, eps, True, 3, 0.5, True,
                            True, True, K)[0]
    ps, meta = fresh(jd, jrng.make_base_key(0), n,
                     jnp.arange(n, dtype=jnp.int32))
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
    for f in (jf, tf):
        f["fsd_ap.edge_idx"] = np.where(f["fsd_ap.valid"],
                                        f["fsd_ap.edge_idx"], -1)
    discrete = [k for k in jf if jf[k].dtype == bool
                or np.issubdtype(jf[k].dtype, np.integer)]
    agree = np.ones(n, bool)
    for k in discrete:
        agree &= (jf[k] == tf[k]).reshape(n, -1).all(1)
    assert (~agree).sum() <= 3
    assert np.asarray(jout["active"]).mean() > 0.3
    assert np.asarray(jout["sampled_fsd"]).any()
    valid = jf["fsd_ap.valid"][agree]
    for k in jf:
        if k in discrete:
            continue
        a, b = jf[k][agree], tf[k][agree]
        atol = 1e-4 * max(np.abs(a).max(), 1e-30)
        if k.startswith("fsd_ap."):
            a, b = a[valid], b[valid]
        if k in ("M", "M_prev", "L"):
            close = np.isclose(b, a, rtol=1e-4, atol=atol)
            assert (~close.reshape(len(a), -1).all(1)).sum() <= 1, k
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=atol,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the BVH route below 2^17 triangles
# ---------------------------------------------------------------------------

@pytest.fixture
def low_brute(monkeypatch):
    """WT_TRACE_BACKEND=bvh with BRUTE_THRESHOLD below the box with the
    icosphere's 1,292 triangles, in both packages."""
    monkeypatch.setenv("WT_TRACE_BACKEND", "bvh")
    monkeypatch.setattr(jtrace, "BRUTE_THRESHOLD", 1024)
    monkeypatch.setattr(ttrace, "BRUTE_THRESHOLD", 1024)


def _sphere_box(res=RES, spp=1, fsd=False, jax_side=True):
    scene = _with_sphere(_box(fsd, res, spp, DEPTH, jax_side),
                         jmesh if jax_side else mesh,
                         JShape if jax_side else Shape)
    return scene


@pytest.mark.parametrize("which", ["box", "box_icosphere"])
def test_bridge_keeps_the_jax_tree(which):
    """The bridge loads the JAX bake's tree at every size, so the port
    walks the JAX package's own tree; the K1/K2 tables are built as
    well."""
    scene = _box(False) if which == "box" else _sphere_box()
    ja = _flatten(jbuild(scene).data)
    geo = scene_data_from_numpy(ja, "cpu").geo
    assert geo.node_pack is not None and geo.ray_table is not None
    np.testing.assert_array_equal(geo.node_pack.numpy(), ja["geo.node_pack"])


@pytest.mark.parametrize("case", SMALL_TREES)
def test_bvh_twins_on_small_trees_match_jax(case):
    """K4/K5's twins on trees below 2^17 triangles (a root that is a
    leaf, one split, the box with the icosphere) equal the JAX package's
    trace_bvh / occluded_bvh on the same tree (its own builder gives the
    same one): ids and occlusion equal, t within 1e-6."""
    pos, tree = small_tree(case)
    jtree = jbvh.build_bvh(pos[np.argsort(tree.tri_order)])
    np.testing.assert_array_equal(jtree.node_left, tree.node_left)
    np.testing.assert_array_equal(jtree.tri_order, tree.tri_order)
    nodes, tris, _ = small_tree_tables(case, "cpu")
    jgeo = types.SimpleNamespace(node_pack=jnp.asarray(nodes.numpy()),
                                 tri_geom=jnp.asarray(tris.numpy()))
    r = np.random.default_rng(12)
    lo, hi = pos.min((0, 1)) - 0.5, pos.max((0, 1)) + 0.5
    ro = r.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
    rd = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tmin = np.full(N_RAYS, 1e-4, np.float32)
    tmax = np.where(np.arange(N_RAYS) % 2 == 0, 1e30,
                    r.uniform(0.5, 3.0, N_RAYS)).astype(np.float32)
    ex = np.where(np.arange(N_RAYS) % 3 == 0,
                  r.integers(0, len(pos), N_RAYS), -1).astype(np.int32)
    rays = (ro, rd, tmin, tmax, ex)
    jt, ji, _, _ = (np.asarray(x) for x in jtrace.trace_bvh(
        jgeo, *map(jnp.asarray, rays)))
    tt, ti = (x.numpy() for x in bvh_kernels.closest_hit(
        nodes, tris, *map(torch.from_numpy, rays)))
    np.testing.assert_array_equal(ti, ji)
    assert (ti >= 0).any()
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6)
    ex3 = np.stack([ex, np.roll(ex, 1), np.roll(ex, 2)], -1)
    jo = np.asarray(jtrace.occluded_bvh(
        jgeo, *map(jnp.asarray, rays[:4]),
        *(jnp.asarray(ex3[:, c]) for c in range(3))))
    to = bvh_kernels.any_hit(nodes, tris, *map(torch.from_numpy, rays[:4]),
                             torch.from_numpy(ex3)).numpy()
    np.testing.assert_array_equal(to, jo)
    assert to.any()


def test_bvh_route_queries_match_jax(low_brute, monkeypatch):
    """trace/occluded on the JAX package's bridged tables of the box with
    the icosphere take the K4/K5 twins and equal the JAX package's route
    (its trace_bvh/occluded_bvh): ids and occlusion equal, t within
    1e-6, u and v within 1e-5 (test_torch_bvh.py says why)."""
    jd = jbuild(_sphere_box()).data
    geo = scene_data_from_numpy(_flatten(jd), "cpu").geo
    assert geo.num_tris == 1292 and ttrace.route(geo.num_tris) == "bvh"
    r = np.random.default_rng(11)
    ro = r.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95],
                   (N_RAYS, 3)).astype(np.float32)
    rd = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tmin = np.full(N_RAYS, 1e-4, np.float32)
    tmax = np.where(np.arange(N_RAYS) % 2 == 0, 1e30,
                    r.uniform(0.1, 2.0, N_RAYS)).astype(np.float32)
    rays = (ro, rd, tmin, tmax)
    calls = _counting(monkeypatch)
    _, first, _, _ = ttrace.trace(geo, *map(torch.from_numpy, rays))
    ex = torch.where(torch.arange(N_RAYS) % 3 > 0, first, -1)
    jt, ji, ju, jv = (np.asarray(x) for x in jtrace.trace(
        jd.geo, *map(jnp.asarray, rays), jnp.asarray(ex.numpy())))
    tt, ti, tu, tv = (x.numpy() for x in ttrace.trace(
        geo, *map(torch.from_numpy, rays), ex))
    np.testing.assert_array_equal(ti, ji)
    assert 0.2 < (ti >= 0).mean() < 1.0
    hit = ti >= 0
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=0, atol=1e-6)
    assert (tt[~hit] == jt[~hit]).all()
    np.testing.assert_allclose(tu, ju, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    ex2 = np.roll(first.numpy(), 1)
    ex3 = np.where(np.arange(N_RAYS) % 2 == 0, np.roll(first.numpy(), 2), -1)
    exs = (ex.numpy(), ex2, ex3.astype(np.int32))
    jo = np.asarray(jtrace.occluded(jd.geo, *map(jnp.asarray, rays),
                                    *map(jnp.asarray, exs)))
    to = ttrace.occluded(geo, *map(torch.from_numpy, rays),
                         *map(torch.from_numpy, exs)).numpy()
    np.testing.assert_array_equal(to, jo)
    assert 0.2 < to.mean() < 0.9
    assert calls["bvh"] == 3 and calls["k1k2"] == 0


def test_bvh_route_bake_equals_jax_bake(low_brute, monkeypatch):
    """Under the variable the port's own bake of the box with the
    icosphere builds the tree and bakes every table in its leaf order:
    equal to the JAX bake, table for table. It keeps K1/K2's tables, so
    the same bake renders under the default route, where a pair test
    counts every triangle again."""
    ja = _flatten(jbuild(_sphere_box()).data)
    ta, _ = bake_scene_arrays(_sphere_box(jax_side=False))
    for key in bridge.KEYS + ("geo.node_pack", "geo.node_left",
                              "geo.node_count"):
        if key == "geo.mxu_center":       # a mean: summation order differs
            np.testing.assert_allclose(ta[key], ja[key], rtol=1e-6)
            continue
        np.testing.assert_array_equal(np.asarray(ta[key]), ja[key],
                                      err_msg=key)
    geo = scene_data_from_numpy(ta, "cpu").geo
    assert geo.node_pack is not None and geo.ray_table is not None
    assert ttrace.ray_tests_per_lane(geo) == 0.0
    monkeypatch.delenv("WT_TRACE_BACKEND")
    assert ttrace.ray_tests_per_lane(geo) == 1292.0


def test_default_bake_is_unchanged(monkeypatch):
    """With the variable unset the bake below 2^17 triangles keeps the
    soup order and builds no tree, as before."""
    monkeypatch.delenv("WT_TRACE_BACKEND", raising=False)
    ta, _ = bake_scene_arrays(_sphere_box(jax_side=False))
    assert "geo.node_pack" not in ta and "geo.tri_order" not in ta
    soup = mesh.TriangleSoup.concatenate(
        [s.soup for s in _sphere_box(jax_side=False).shapes])
    np.testing.assert_array_equal(ta["geo.p0"], soup.positions[:, 0])


def test_bvh_route_render_matches_jax(low_brute, monkeypatch):
    """The classical box with the icosphere at 16×16 × 1 spp, depth 5,
    under the variable on both sides (the JAX package's lock-step BVH,
    the port's K4/K5 twins on its own bake) at the classical bars."""
    monkeypatch.setenv("WT_COMPACT_MODE", "stepped")
    monkeypatch.setattr(jrenderer, "_kernel_cache", {})
    jimg, jst = jrender(jbuild(_sphere_box()), spp=1, batch_lanes=LANES)
    calls = _counting(monkeypatch)
    built = build_scene(_sphere_box(jax_side=False), device="cpu")
    img, st = render_scene(built, device="cpu", pool_lanes=LANES)
    assert calls["bvh"] > 0 and calls["k1k2"] == 0, calls
    assert st["mode"] == jst["mode"] == "ray-compact"
    assert img.shape == jimg.shape == (RES, RES, 3)
    classical_bars(img, jimg, st, jst)


# ---------------------------------------------------------------------------
# no silent fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("query", ["trace", "occluded"])
def test_bvh_route_without_a_tree_raises(low_brute, monkeypatch, query):
    """A scene baked without the variable has no tree; under it the BVH
    route raises and names the variable, and never falls back to K1/K2."""
    monkeypatch.delenv("WT_TRACE_BACKEND")
    geo = build_scene(_sphere_box(jax_side=False), device="cpu").data.geo
    assert geo.node_pack is None
    monkeypatch.setenv("WT_TRACE_BACKEND", "bvh")
    calls = _counting(monkeypatch)
    ray = (torch.zeros((4, 3)), torch.ones((4, 3)) / 3 ** 0.5,
           torch.zeros(4), torch.ones(4))
    with pytest.raises(ValueError, match="WT_TRACE_BACKEND"):
        getattr(ttrace, query)(geo, *ray)
    assert calls == {"k1k2": 0, "bvh": 0}


@pytest.mark.parametrize("entry", ["build_piecewise_linear", "build_discrete",
                                   "empty_aperture", "empty_fr_aperture"])
def test_entry_points_default_to_the_card(entry):
    """These entry points allocate on the card unless the CPU is asked
    for, and raise without a card rather than fall back."""
    make = {"build_piecewise_linear": lambda **k: tdist.build_piecewise_linear(
                [0.0, 1.0], [1.0, 2.0], **k),
            "build_discrete": lambda **k: tdist.build_discrete(
                [1.0, 2.0], [1.0, 1.0], **k),
            "empty_aperture": lambda **k: tfsd.empty_aperture(2, 4, **k),
            "empty_fr_aperture": lambda **k: tfr.empty_fr_aperture(
                2, 4, **k)}[entry]
    first = lambda x: next(v for v in vars(x).values()      # noqa: E731
                           if isinstance(v, torch.Tensor))
    assert first(make(device="cpu")).device.type == "cpu"
    if torch.cuda.is_available():
        assert first(make()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------------------
# the pool's switches
# ---------------------------------------------------------------------------

def test_compact_modes_give_one_film(monkeypatch):
    """WT_COMPACT_MODE=while and stepped render the same film, bit for
    bit, with the same counters (tests/test_compact.py's requirement of
    the JAX package's two drivers). The port has one driver, which reads
    no variable: this guards that the wave box's render stays
    deterministic, so that no result can depend on the value."""
    built = build_scene(_box(True, jax_side=False), device="cpu")
    out = {}
    for mode in ("while", "stepped"):
        monkeypatch.setenv("WT_COMPACT_MODE", mode)
        img, st, r = render_scene(built, device="cpu", pool_lanes=LANES,
                                  return_renderer=True)
        out[mode] = (img, st, r.last_film)
    (iw, sw, fw), (is_, ss, fs) = out["while"], out["stepped"]
    assert sw["mode"] == ss["mode"]
    np.testing.assert_array_equal(is_, iw)
    for f in ("value", "weight", "direct"):
        assert torch.equal(getattr(fs, f), getattr(fw, f)), f
    for k in sw["device_counters"]:
        assert ss["device_counters"][k] == sw["device_counters"][k], k


@pytest.mark.parametrize("cap,pool_lanes,width", [
    (None, None, RES * RES * SPP), ("256", None, 256), ("256", 128, 128),
    ("100000", 384, 384)])
def test_compact_lanes_caps_the_pool(cap, pool_lanes, width, monkeypatch):
    """lanes = min(pool_lanes or COMPACT_LANES_MAX, WT_COMPACT_LANES), as
    the JAX renderer sizes its pool, and never more than the paths; the
    image does not depend on the width (every draw is keyed by pixel and
    sample)."""
    built = build_scene(_box(True, spp=SPP, jax_side=False), device="cpu")
    monkeypatch.delenv("WT_COMPACT_LANES", raising=False)
    ref, st_ref = render_scene(built, device="cpu")
    if cap is not None:
        monkeypatch.setenv("WT_COMPACT_LANES", cap)
    img, st = render_scene(built, device="cpu", pool_lanes=pool_lanes)
    assert st["pool_lanes"] == width
    assert RES * RES * SPP <= trenderer.POOL_LANES_CPU
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-12)
    for k in LANE_COUNTERS:
        assert st["device_counters"][k] == st_ref["device_counters"][k], k


@pytest.mark.parametrize("cap,pool_lanes,dev,width", [
    (None, None, "cpu", 1 << 13), (None, None, "cuda", 1 << 18),
    (None, 384, "cuda", 384), ("16384", None, "cpu", 16384),
    ("16384", None, "cuda", 16384), ("1048576", None, "cuda", 1 << 17),
    ("256", 128, "cpu", 128), ("100000", 1 << 18, "cuda", 100000),
    ("0", None, "cpu", None), ("-3", 384, "cuda", None)])
def test_compact_lanes_width(cap, pool_lanes, dev, width, monkeypatch):
    """The pool width: unset, pool_lanes or the port's default for the
    device; set, the variable in the default's place, bounded by
    pool_lanes or the JAX renderer's batch_lanes (2^17), as JAX's
    min(batch_lanes, WT_COMPACT_LANES); below 1, a ValueError."""
    monkeypatch.delenv("WT_COMPACT_LANES", raising=False)
    if cap is not None:
        monkeypatch.setenv("WT_COMPACT_LANES", cap)
    assert trenderer.COMPACT_LANES_MAX == jrenderer.Renderer.batch_lanes
    if width is None:
        with pytest.raises(ValueError, match="WT_COMPACT_LANES"):
            trenderer.pool_width(pool_lanes, torch.device(dev))
    else:
        assert trenderer.pool_width(pool_lanes, torch.device(dev)) == width


# ---------------------------------------------------------------------------
# forward-mode gradients under brute
# ---------------------------------------------------------------------------

GRAD_RES, GRAD_DEPTH, GRAD_KEY = 8, 2, 7


def test_brute_forward_maps_match_jax(monkeypatch):
    """The classical box's pixel maps by forward mode through
    trace_paths under WT_TRACE_BACKEND=brute, against the JAX package's
    jax.jvp under the same value on the same bridged tables and draws,
    per lane at rtol 1e-4 (atol 1e-6 of the map's largest magnitude):
    w.r.t. a translation of the back wall along +z (through the hit
    distance) and a scale of the emitters' spectra."""
    monkeypatch.setenv("WT_TRACE_BACKEND", "brute")
    scene = _box(False, res=GRAD_RES, spp=1, depth=GRAD_DEPTH)
    jb = jbuild(scene)
    data = scene_data_from_numpy(_flatten(jb.data), "cpu")
    tsensor = _box(False, GRAD_RES, 1, GRAD_DEPTH, False).sensors[0]
    pxy, jit, sids = lanes(GRAD_RES)
    zhat = np.asarray([0.0, 0.0, 1.0], np.float32)
    mask = emitter_rows(jb.data)

    def jvalues(d):
        return jtrace_paths(d, *map(jnp.asarray, (pxy, jit)),
                            jrng.make_base_key(GRAD_KEY), jnp.asarray(sids),
                            sensor=scene.sensors[0], max_depth=GRAD_DEPTH,
                            eps=1e-4)[1]

    def tvalues(d):
        return trace_paths(d, *map(torch.from_numpy, (pxy, jit)), GRAD_KEY,
                           torch.from_numpy(sids), sensor=tsensor,
                           max_depth=GRAD_DEPTH, eps=1e-4)[1]
    maps = {
        "back_wall": (
            lambda th: jvalues(_translate_j(jb.data, BACK_WALL,
                                            th * jnp.asarray(zhat))),
            lambda th: tvalues(_translate_t(data, BACK_WALL,
                                            th * torch.from_numpy(zhat))),
            0.0),
        "emitters": (
            lambda th: jvalues(jax_scaled(jb.data, 1.0 + jnp.asarray(mask)
                                          * (th - 1.0))),
            lambda th: tvalues(port_scaled(data, 1.0 + torch.from_numpy(mask)
                                           * (th - 1.0))),
            1.0)}
    for name, (jf, tf, at) in maps.items():
        jv, jg = (np.asarray(x) for x in jax.jit(lambda t: jax.jvp(
            jf, (t,), (1.0,)))(at))
        tv, tg = (x.numpy() for x in port_jvp(tf, torch.tensor(at),
                                               torch.tensor(1.0)))
        assert np.isfinite(tg).all() and (tg != 0).any(), name
        np.testing.assert_allclose(tv, jv, rtol=1e-4,
                                   atol=1e-6 * np.abs(jv).max(),
                                   err_msg=name)
        np.testing.assert_allclose(tg, jg, rtol=1e-4,
                                   atol=1e-6 * np.abs(jg).max(),
                                   err_msg=name)
