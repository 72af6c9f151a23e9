"""Port parity for the BVH route (scenes above MXU_MAX_TRIS triangles):
the BVH builders, the traversals and a render, against the JAX package
on the CPU.

* The numpy `build_bvh` equals the JAX package's array for array, on the
  box with an icosphere inside (1,292 triangles) and on the sphere of
  tests/test_trace.py; the C++ builder equals the JAX package's C++
  builder (through its own loader, from a copy of its library) on 5,120.
* `trace_bvh` / `occluded_bvh` (the plain twins of K4/K5 on the CPU)
  equal the JAX functions on the same tree: ids and occlusion equal, t
  within 1e-6, u and v within 1e-5 (the JAX package's own lowerings
  part by 2.4e-6 there; see the test).
* With MXU_MAX_TRIS lowered so that the box with the icosphere takes the
  BVH route: the bake equals the JAX bake (the same tree, so the same
  triangle order, edge table and emitter tables); the closest hits agree
  with K1's plain twin on >= 99.9% of ids; the wave render meets the
  wave bars of PERF.md §2 against the JAX render. The BVH route tests
  triangles by Möller–Trumbore and K1 by Plücker sides, so a ray through
  an edge or a vertex shared by two triangles may name either one: a
  difference of tie-breaking, not a fault (ROADMAP.md §3).
"""

import dataclasses
import hashlib
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_render import make_box_scene
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu import native as jnative
from wave_tracer_tpu.accel import bvh as jbvh
from wave_tracer_tpu.accel import trace as jtrace
from wave_tracer_tpu.geometry import mesh as jmesh
from wave_tracer_tpu.ops import intersect as jintersect
from wave_tracer_tpu.render import render_scene as jrender
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.scene.model import Shape as JShape
from wave_tracer_tpu_torch import native
from wave_tracer_tpu_torch.accel import bvh, bvh_kernels, ray_kernels
from wave_tracer_tpu_torch.accel import trace as ttrace
from wave_tracer_tpu_torch.geometry import mesh
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.scene import bridge
from wave_tracer_tpu_torch.scene.build import bake_scene_arrays, build_scene
from wave_tracer_tpu_torch.scene.model import Shape
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene

cap_torch_threads()

BVH_FIELDS = ("node_min", "node_max", "node_left", "node_count", "tri_order")
SPHERE = dict(center=[0.3, 0.6, -0.2], radius=0.4, tessellation=24)
N = 1000
RES, DEPTH, LANES = 16, 3, 256


def _with_sphere(scene, mesh_mod, shape_cls):
    """The box with an icosphere of 1,280 triangles inside it."""
    scene.shapes.append(shape_cls(
        mesh_mod.sphere(SPHERE["center"], SPHERE["radius"],
                        tessellation=SPHERE["tessellation"]),
        scene.shapes[0].material))
    return scene


def _box_sphere_soup():
    return jmesh.TriangleSoup.concatenate(
        [s.soup for s in _with_sphere(make_box_scene(8, 1), jmesh,
                                      JShape).shapes])


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


def _leaf_order(soup, ids, tree):
    """The port's soup of `soup` (a JAX package's) and the id arrays, in
    the leaf order of `tree`, as scene/build.py hands them to from_soup."""
    own = mesh.TriangleSoup(**{f: getattr(soup, f) for f in (
        "positions", "normals", "uvs", "geo_n", "dpdu")})
    return (own.take(tree.tri_order),
            *(np.asarray(x)[tree.tri_order] for x in ids))


@pytest.mark.parametrize("which", ["box_icosphere", "test_trace_sphere"])
def test_numpy_build_equals_jax(which):
    soup = (_box_sphere_soup() if which == "box_icosphere"
            else jmesh.sphere([0, 0, 0], 1.0, tessellation=24))
    assert len(soup.positions) <= bvh.NATIVE_THRESHOLD
    a = jbvh.build_bvh(soup.positions)
    b = bvh.build_bvh(soup.positions)
    for f in BVH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(y, x, err_msg=f)
    assert b.depth() == a.depth() <= bvh.MAX_DEPTH
    # the packed node rows and the permuted triangle rows: as the JAX bake
    T = len(soup.positions)
    ids = (np.zeros(T), np.zeros(T), np.full(T, -1))
    jg = jtrace.from_soup(soup, *ids, a)
    tg = ttrace.from_soup(*_leaf_order(soup, ids, b), b)
    for k in ("node_pack", "tri_geom", "tri_attr", "p0", "e1", "e2"):
        np.testing.assert_array_equal(tg[k], np.asarray(getattr(jg, k)),
                                      err_msg=k)


def test_native_build_equals_jax_native(tmp_path, monkeypatch):
    """The C++ builder on 5,120 triangles (above NATIVE_THRESHOLD) equals
    the JAX package's C++ builder, which loads through its own loader from
    a copy of its tracked library (the loader rebuilds a library older
    than its source in place; the copy is newer, so nothing is built and
    the tracked file is not touched); both equal the numpy builder."""
    lib = jnative._LIB
    before = hashlib.sha256(open(lib, "rb").read()).hexdigest()
    copy = tmp_path / "libwt_native.so"
    shutil.copy(lib, copy)
    monkeypatch.setattr(jnative, "_LIB", str(copy))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    pos = jmesh.sphere([0.5, 1.0, -0.3], 0.8, tessellation=48).positions
    assert len(pos) == 5120 > bvh.NATIVE_THRESHOLD
    a = jnative.build_bvh_native(pos)
    assert a is not None, "the JAX package's native builder did not load"
    b = bvh.build_bvh(pos)                      # through native/ here
    assert native.library_path().exists()
    monkeypatch.setattr(bvh, "NATIVE_THRESHOLD", 1 << 30)
    c = bvh.build_bvh(pos)                      # the numpy builder
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(c, f), getattr(a, f),
                                      err_msg=f)
    assert hashlib.sha256(open(lib, "rb").read()).hexdigest() == before


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed compile raises with the compiler's message; there is no
    quiet fall-back to the numpy builder."""
    bad = tmp_path / "bvh_builder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed on bvh_builder.cpp"):
        native.build()


def test_builders_and_kernels_share_constants():
    """The C++ builder, the CUDA kernels and the Python modules agree on
    the depth cap, the SAH bins, the leaf size and the stack depth."""
    root = Path(bvh.__file__).resolve().parents[1]
    cpp = (root / "native" / "bvh_builder.cpp").read_text()
    cu = (root / "csrc" / "bvh_kernels.cu").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const(cpp, "kMaxDepth") == bvh.MAX_DEPTH
    assert const(cpp, "kNumBins") == bvh.N_BINS
    assert const(cu, "LEAF_TILE") == bvh.LEAF_TILE
    assert const(cu, "STACK") == bvh_kernels.STACK == bvh.MAX_DEPTH + 2


@pytest.mark.parametrize("case", ["depth_cap", "float32_index",
                                  "bridged_tree"])
def test_untraversable_tree_refused(case, monkeypatch):
    """A tree that K4/K5 would walk wrongly raises at the bake or the
    bridge: a leaf of more than LEAF_TILE triangles (the depth cap cut
    it), an index past float32's exact integers in node_pack, or a
    bridged node_pack with such a leaf."""
    if case == "float32_index":
        z3, z1 = np.zeros((1, 3), np.float32), np.zeros(1, np.int32)
        big = np.broadcast_to(np.int32(0), (bvh.MAX_PACKED_INDEX + 1,))
        with pytest.raises(ValueError, match="float32"):
            bvh.pack_nodes(bvh.FlatBVH(z3, z3, z1, z1, big))
        return
    monkeypatch.setattr(ttrace, "MXU_MAX_TRIS", 1024)
    if case == "depth_cap":
        monkeypatch.setattr(bvh, "MAX_DEPTH", 3)
        with pytest.raises(ValueError, match="leaf of"):
            bake_scene_arrays(_route_scene())
        return
    ta, _ = bake_scene_arrays(_route_scene())
    bad = dict(ta)
    bad["geo.node_pack"] = ta["geo.node_pack"].copy()
    leaf = np.nonzero(bad["geo.node_pack"][:, 0] > 0)[0][0]
    bad["geo.node_pack"][leaf, 0] = bvh.LEAF_TILE + 1
    with pytest.raises(ValueError, match="leaf of"):
        bridge.scene_data_from_numpy(bad, "cpu")


@pytest.fixture(scope="module")
def trees():
    """(JAX GeoArrays, the port's) of the box with the icosphere, on the
    same tree, and N seeded rays: origins in the box, unit directions, a
    third excluding the triangle the ray hits first."""
    soup = _box_sphere_soup()
    T = len(soup.positions)
    ids = (np.zeros(T), np.zeros(T), np.full(T, -1))
    jg = jtrace.from_soup(soup, *ids, jbvh.build_bvh(soup.positions))
    tree = bvh.build_bvh(soup.positions)
    d = ttrace.from_soup(*_leaf_order(soup, ids, tree), tree)
    tg = ttrace.GeoArrays(**{k: torch.from_numpy(d[k]) for k in (
        "p0", "e1", "e2", "tri_geom", "tri_attr", "mxu_center",
        "node_pack")})
    r = np.random.default_rng(11)
    ro = r.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95],
                   (N, 3)).astype(np.float32)
    rd = r.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tmin = np.full(N, 1e-4, np.float32)
    tmax = np.where(np.arange(N) % 2 == 0, 1e30,
                    r.uniform(0.1, 2.0, N)).astype(np.float32)
    _, first, _, _ = jtrace.trace_bvh(jg, *map(jnp.asarray, (ro, rd, tmin)),
                                      jnp.full(N, 1e30, jnp.float32))
    first = np.asarray(first)
    cohort = np.arange(N) % 3          # 0: no exclusion, 1 and 2: some
    ex = np.where(cohort > 0, first, -1).astype(np.int32)
    # the occlusion test's exclusions: one, two or three ids
    ex3 = np.full((N, 3), -1, np.int32)
    ex3[cohort == 1, 0] = first[cohort == 1]
    two = cohort == 2
    three = two & (np.arange(N) % 2 == 0)
    ex3[two, 0] = first[two]
    ex3[two, 1] = r.integers(0, T, two.sum())
    ex3[three, 2] = r.integers(0, T, three.sum())
    return jg, tg, (ro, rd, tmin, tmax), ex, ex3


def test_trace_bvh_equals_jax(trees):
    jg, tg, rays, ex, _ = trees
    jt, ji, ju, jv = (np.asarray(x) for x in jtrace.trace_bvh(
        jg, *map(jnp.asarray, rays), jnp.asarray(ex)))
    tt, ti, tu, tv = (x.numpy() for x in ttrace.trace_bvh(
        tg, *map(torch.from_numpy, rays), torch.from_numpy(ex)))
    np.testing.assert_array_equal(ti, ji)
    assert 0.2 < (ti >= 0).mean() < 1.0
    hit = ti >= 0
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=0, atol=1e-6)
    assert (tt[~hit] == jt[~hit]).all()
    # u and v: the JAX package's own two lowerings of the same formula
    # part by up to 2.4e-6 here (its ray_tri run eagerly on the winners
    # against the values out of trace_bvh's jitted loop, which XLA fuses);
    # the port's equal the eager ones bit for bit and lie within 1e-5 of
    # the loop's
    row = np.asarray(jg.tri_geom)[np.maximum(ti, 0)]
    _, eu, ev, _ = (np.asarray(x) for x in jintersect.ray_tri(*map(
        jnp.asarray, (rays[0], rays[1], row[:, 0:3], row[:, 3:6],
                      row[:, 6:9], rays[2], rays[3]))))
    np.testing.assert_array_equal(tu[hit], eu[hit])
    np.testing.assert_array_equal(tv[hit], ev[hit])
    np.testing.assert_allclose(tu, ju, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)


def test_occluded_bvh_equals_jax(trees):
    jg, tg, rays, _, ex3 = trees
    jo = np.asarray(jtrace.occluded_bvh(
        jg, *map(jnp.asarray, rays),
        *(jnp.asarray(ex3[:, c]) for c in range(3))))
    to = ttrace.occluded_bvh(
        tg, *map(torch.from_numpy, rays),
        *(torch.from_numpy(ex3[:, c]) for c in range(3))).numpy()
    np.testing.assert_array_equal(to, jo)
    assert 0.2 < to.mean() < 0.9


def test_bvh_need_and_carry(trees):
    """Rows off `need` are neither traced nor read: K4's twin returns
    their carried hit, K5's False; the needed rows equal a trace of all."""
    _, tg, rays, ex, ex3 = trees
    ro, rd, tmin, tmax = map(torch.from_numpy, rays)
    need = torch.from_numpy(np.random.default_rng(3).random(N) < 0.4)
    nodes, tris = tg.node_pack, tg.tri_geom
    t_all, i_all = bvh_kernels.closest_hit(nodes, tris, ro, rd, tmin, tmax,
                                           torch.from_numpy(ex))
    carry = (torch.full((N,), 7.0), torch.full((N,), 5, dtype=torch.int32))
    t, i = bvh_kernels.closest_hit(nodes, tris, ro, rd, tmin, tmax,
                                   torch.from_numpy(ex), need, carry)
    assert torch.equal(t[need], t_all[need])
    assert torch.equal(i[need], i_all[need])
    assert (t[~need] == 7.0).all() and (i[~need] == 5).all()
    t0, i0 = bvh_kernels.closest_hit(nodes, tris, ro, rd, tmin, tmax,
                                     torch.from_numpy(ex), need)
    assert (i0[~need] == -1).all() and (t0[~need] == bvh_kernels.BIG).all()
    o_all = bvh_kernels.any_hit(nodes, tris, ro, rd, tmin, tmax,
                                torch.from_numpy(ex3))
    o = bvh_kernels.any_hit(nodes, tris, ro, rd, tmin, tmax,
                            torch.from_numpy(ex3), need)
    assert torch.equal(o[need], o_all[need]) and not o[~need].any()


def _route_scene(res=RES, spp=1):
    scene = _with_sphere(tmake_box_scene(res, spp), mesh, Shape)
    scene.integrator.fsd = True
    scene.integrator.max_depth = DEPTH
    return scene


@pytest.fixture
def low_limit(monkeypatch):
    """MXU_MAX_TRIS below the box with the icosphere's 1,292 triangles."""
    monkeypatch.setattr(ttrace, "MXU_MAX_TRIS", 1024)


def test_bvh_bake_equals_jax_bake(low_limit):
    """Above the limit the port bakes in the BVH's leaf order: every
    table the JAX bake of the same scene holds is equal (the edge table
    and the emitters' triangle ids included), and so is the tree."""
    jscene = _with_sphere(make_box_scene(RES, 1), jmesh, JShape)
    ja = _flatten(jbuild(jscene).data)
    ta, _ = bake_scene_arrays(_route_scene())
    for key in bridge.KEYS + ("geo.node_pack", "geo.node_left",
                              "geo.node_count"):
        if key == "geo.mxu_center":       # a mean: summation order differs
            np.testing.assert_allclose(ta[key], ja[key], rtol=1e-6)
            continue
        np.testing.assert_array_equal(np.asarray(ta[key]), ja[key],
                                      err_msg=key)
    data = bridge.scene_data_from_numpy(ta, "cpu")
    assert data.geo.ray_table is None and data.geo.node_pack is not None
    assert ttrace.ray_tests_per_lane(data.geo) == 0.0


def test_bvh_route_agrees_with_k1(low_limit):
    """The box with the icosphere on the BVH route against K1's plain
    twin on the same triangles: ids on >= 99.9% of N rays, t within rtol
    1e-4 / atol 1e-5 where they agree."""
    built = build_scene(_route_scene(), device="cpu")
    geo = built.data.geo
    assert geo.node_pack is not None and geo.tri_feat is None
    r = np.random.default_rng(5)
    ro = torch.from_numpy(r.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95],
                                    (N, 3)).astype(np.float32))
    rd = torch.from_numpy(r.normal(size=(N, 3)).astype(np.float32))
    rd = rd / rd.norm(dim=-1, keepdim=True)
    tmin, tmax = torch.full((N,), 1e-4), torch.full((N,), 1e30)
    t, tri, _, _ = ttrace.trace(geo, ro, rd, tmin, tmax)
    feat = ray_kernels.tri_features(geo.p0, geo.e1, geo.e2, geo.mxu_center)
    ex = torch.full((N, 3), -1, dtype=torch.int32)
    t1, tri1 = ray_kernels._closest_ref(feat, geo.mxu_center, ro, rd, tmin,
                                        tmax, ex)
    same = tri == tri1
    assert same.float().mean() >= 0.999
    assert (tri >= 0).float().mean() > 0.7
    hit = same & (tri >= 0)
    assert ((t - t1).abs() <= 1e-4 * t1.abs() + 1e-5)[hit].all()


def test_bvh_route_wave_render_matches_jax(low_limit, monkeypatch):
    """The wave render (plt_path, FSD on) of the box with the icosphere at
    16×16 × 1 spp, depth 3, on the BVH route, against the JAX package's
    render of the same scene (its CPU trace: the all-pairs sweep), at the
    wave bars of PERF.md §2: channel means within 2%, Pearson >= 0.999,
    >= 90% of pixels within 1e-2·max(|ref|, mean|ref|), counters within
    2%. The port's K1 and K2 twins never run, K4's and K5's do."""
    calls = {"bvh": 0, "k1k2": 0}

    def counted(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    for mod, name, key in ((bvh_kernels, "_closest_ref", "bvh"),
                           (bvh_kernels, "_anyhit_ref", "bvh"),
                           (ray_kernels, "_closest_ref", "k1k2"),
                           (ray_kernels, "_anyhit_ref", "k1k2")):
        monkeypatch.setattr(mod, name, counted(getattr(mod, name), key))
    jscene = _with_sphere(make_box_scene(RES, 1), jmesh, JShape)
    jscene.integrator.fsd = True
    jscene.integrator.max_depth = DEPTH
    jimg, jst = jrender(jbuild(jscene), spp=1, batch_lanes=LANES)
    built = build_scene(_route_scene(), device="cpu")
    img, st = render_scene(built, device="cpu", pool_lanes=LANES)
    assert calls["bvh"] > 0 and calls["k1k2"] == 0, calls
    assert st["mode"] == jst["mode"] == "wave-compact"
    assert img.shape == jimg.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    np.testing.assert_allclose(img.mean((0, 1)), jimg.mean((0, 1)),
                               rtol=0.02)
    assert np.corrcoef(img.ravel(), jimg.ravel())[0, 1] >= 0.999
    scale = np.maximum(np.abs(jimg), np.abs(jimg).mean())
    assert (np.abs(img - jimg) <= 1e-2 * scale).all(-1).mean() >= 0.90
    for k in ("rays_cast", "surface_interactions", "fsd_interactions",
              "diffusive_traversals", "sum_path_depth"):
        a, b = st["device_counters"][k], jst["device_counters"][k]
        assert abs(a - b) <= 0.02 * b, (k, a, b)
