"""Port parity: the port's own host bake (scene/build.py) of the box scene
equals the JAX package's build_scene arrays, flattened to numpy.

The JAX bake keeps triangles in BVH order and the port in soup order, so
triangle-indexed arrays compare after applying the JAX bvh.tri_order, and
the emitter tables (device-order triangle indices plus per-emitter area
CDFs) compare after mapping the indices through the same permutation.
Everything else is computed by the same numpy code and must be equal."""

import dataclasses

import numpy as np
import pytest
import torch

from test_render import make_box_scene
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu_torch.scene import bridge
from wave_tracer_tpu_torch.scene.build import bake_scene_arrays, build_scene
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene

cap_torch_threads()

TRI_KEYS = ("geo.p0", "geo.e1", "geo.e2", "geo.tri_geom", "geo.tri_attr")


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


@pytest.fixture(scope="module", params=["area", "point"])
def bakes(request):
    jb = jbuild(make_box_scene(res=16, spp=4, emitter=request.param))
    arrays, per_sensor = bake_scene_arrays(
        tmake_box_scene(res=16, spp=4, emitter=request.param))
    return _flatten(jb.data), np.asarray(jb.bvh.tri_order), arrays, \
        per_sensor


def _emitter_tris(a, idx_map=None):
    """{emitter: {soup triangle: probability}} from the concatenated CDF."""
    out = {}
    pack, idx, cdf = (a["emitters.pack"], a["emitters.etri_idx"],
                      a["emitters.etri_cdf"])
    for e in range(len(pack)):
        start, cnt = int(pack[e, 14]), int(pack[e, 15])
        ids = idx[start:start + cnt]
        if idx_map is not None:
            ids = idx_map[ids]
        p = np.diff(np.concatenate([[0.0], cdf[start:start + cnt]]))
        out[e] = dict(zip(ids.tolist(), p.tolist()))
    return out


def test_bake_equals_jax(bakes):
    ja, perm, ta, _ = bakes
    for key in bridge.KEYS:
        a, b = ja[key], np.asarray(ta[key])
        if key in TRI_KEYS:
            np.testing.assert_array_equal(b[perm], a, err_msg=key)
        elif key == "geo.mxu_center":      # a mean: summation order differs
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=key)
        elif key in ("emitters.etri_idx", "emitters.etri_cdf") \
                or key.startswith("edges."):
            continue                       # below, through the permutation
        else:
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(b, a, err_msg=key)
    ej, et = _emitter_tris(ja, idx_map=perm), _emitter_tris(ta)
    assert ej.keys() == et.keys()
    for e in ej:
        assert ej[e].keys() == et[e].keys()
        for tri, p in ej[e].items():
            assert abs(et[e][tri] - p) < 1e-6


def _canonical_edges(a, tri_map=None):
    """Edge rows in an order-free form: faces ordered by soup triangle id
    (tri_map takes device ids to soup ids), endpoints ordered
    lexicographically (e follows p0 → p1), rows sorted by endpoints."""
    e = {k: np.array(a[f"edges.{k}"]) for k in bridge.EDGE_KEYS}
    for k in ("tri1", "tri2"):
        if tri_map is not None:
            e[k] = np.where(e[k] >= 0, tri_map[np.maximum(e[k], 0)], -1)
    swap = (e["tri2"] >= 0) & (e["tri2"] < e["tri1"])
    for x, y in (("n1", "n2"), ("t1", "t2"), ("tri1", "tri2")):
        s = swap.reshape(-1, *([1] * (e[x].ndim - 1)))
        e[x], e[y] = np.where(s, e[y], e[x]), np.where(s, e[x], e[y])
    rev = np.array([tuple(q) > tuple(p) for p, q in zip(e["p0"], e["p1"])],
                   bool).reshape(-1, 1) if len(e["p0"]) else \
        np.zeros((0, 1), bool)
    e["p0"], e["p1"] = (np.where(rev, e["p1"], e["p0"]),
                        np.where(rev, e["p0"], e["p1"]))
    e["e"] = np.where(rev, -e["e"], e["e"])
    order = np.lexsort(np.concatenate([e["p0"], e["p1"]], 1).T[::-1])
    return {k: v[order] for k, v in e.items()}


def test_edge_table_equals_jax(bakes):
    """The port classifies the soup-order triangles and JAX the BVH-order
    ones, so rows come out in another order and an edge's two faces may be
    listed the other way round; after a canonical form of each table
    (faces by soup triangle id through bvh.tri_order) every value is
    computed by the same numpy code on the same triangles."""
    ja, perm, ta, _ = bakes
    ej = _canonical_edges(ja, tri_map=perm)
    et = _canonical_edges(ta)
    assert len(et["p0"]) == len(ej["p0"]) > 0
    for k in bridge.EDGE_KEYS:
        assert ej[k].dtype == et[k].dtype, k
        np.testing.assert_array_equal(et[k], ej[k], err_msg=k)


def test_bridge_round_trip(bakes):
    _, _, ta, per_sensor = bakes
    data = bridge.scene_data_from_numpy(ta, "cpu")
    for key in bridge.KEYS:
        if key == "tables.materials.comp_child":
            continue                       # only checked (all -1), not kept
        obj = data
        for part in key.split("."):
            obj = getattr(obj, part)
        np.testing.assert_array_equal(obj.numpy(), np.asarray(ta[key]),
                                      err_msg=key)
    assert data.geo.tri_feat.shape == (data.geo.num_tris, 24)
    assert data.geo.tri_feat.dtype == torch.float32
    assert data.geo.cone_tris.shape == (data.geo.num_tris, 9)
    assert data.edges.pack.shape == (data.edges.count, 24)
    built = build_scene(tmake_box_scene(res=16, spp=4), device="cpu")
    assert len(built.spectral_per_sensor) == len(per_sensor) == 1
    assert built.device == torch.device("cpu")


def test_bridge_refuses_unported_rows(bakes):
    """Material, texture and emitter type codes the port does not know
    raise at the bridge; dielectric rows, bitmap textures and spot
    emitters (ported) load and set their tables' flags."""
    _, _, ta, _ = bakes
    for key, col, code, flag in (
            ("tables.materials.pack", 0, 1, "materials.has_dielectric"),
            ("tables.textures.pack", 0, 2, "textures.has_bitmap"),
            ("emitters.etype", None, 2, "has_spot")):
        ok = dict(ta)
        arr = np.array(ta[key])
        if col is None:
            arr[0] = code
        else:
            arr[0, col] = code
        ok[key] = arr
        data = bridge.scene_data_from_numpy(ok, "cpu")
        obj = data.emitters if key.startswith("emitters") else data.tables
        for part in flag.split("."):
            obj = getattr(obj, part)
        assert obj is True, flag
        bad = dict(ta)
        arr = arr.copy()
        if col is None:
            arr[0] = 9
        else:
            arr[0, col] = 9
        bad[key] = arr
        with pytest.raises(NotImplementedError, match="type"):
            bridge.scene_data_from_numpy(bad, "cpu")
