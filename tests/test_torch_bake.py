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
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu_torch.scene import bridge
from wave_tracer_tpu_torch.scene.build import bake_scene_arrays, build_scene
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene

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
        elif key in ("emitters.etri_idx", "emitters.etri_cdf"):
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
    built = build_scene(tmake_box_scene(res=16, spp=4), device="cpu")
    assert len(built.spectral_per_sensor) == len(per_sensor) == 1
    assert built.device == torch.device("cpu")


def test_bridge_refuses_unported_rows(bakes):
    _, _, ta, _ = bakes
    bad = dict(ta)
    pack = np.array(ta["tables.materials.pack"])
    pack[0, 0] = 1                          # a dielectric row
    bad["tables.materials.pack"] = pack
    with pytest.raises(NotImplementedError):
        bridge.scene_data_from_numpy(bad, "cpu")
    bad = dict(ta)
    tex = np.array(ta["tables.textures.pack"])
    tex[0, 0] = 2                           # a bitmap texture
    bad["tables.textures.pack"] = tex
    with pytest.raises(NotImplementedError):
        bridge.scene_data_from_numpy(bad, "cpu")
