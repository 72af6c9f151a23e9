"""The frozen scenes give the sizes the configurations state."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from wtbench import geometry
from wtbench.configs import city_10ghz, cornell_box_81k
from wtbench.reference import edges

REPO = Path(__file__).resolve().parents[2]


def cfg(name):
    return json.loads((REPO / f"wtbench/configs/{name}.json").read_text())


def test_cornell_box_81k_triangles():
    c = cfg("cornell_box_81k")
    tris = geometry.triangles([p for p, _, _ in cornell_box_81k.parts(c)])
    assert tris.shape == (81932, 3, 3) == (c["triangles"], 3, 3)


def test_city_10ghz_triangles_and_wedges():
    c = cfg("city_10ghz")
    tris = geometry.triangles(city_10ghz.parts(c))
    assert len(tris) == 2354 == c["triangles"]
    w = edges.wedges(tris.astype(np.float32))
    assert len(w["p0"]) == 2356 == c["wedge_edges"]


def test_frozen_scenes_equal_the_procedural_ones_today():
    # the frozen copies started equal to the program's procedural scenes:
    # the box's walls and lamp, and its icosphere as the program's own
    # mesh.sphere builds it where the configuration places it (the
    # procedural box keeps the classic 5.56-unit box's placement)
    from wave_tracer_tpu_torch.geometry.mesh import sphere
    from wave_tracer_tpu_torch.scene.procedural import (
        make_box_scene, make_city_coverage_scene)
    c = cfg("cornell_box_81k")
    box = make_box_scene(16, 1, icosphere=False)
    ico = c["icosphere"]
    port = np.concatenate([s.soup.positions for s in box.shapes] + [
        sphere(ico["center"], ico["radius"],
               tessellation=3 * 2 ** ico["subdivisions"]).positions])
    mine = geometry.triangles([p for p, _, _ in cornell_box_81k.parts(c)])
    assert np.array_equal(port, mine.astype(np.float32))
    city = make_city_coverage_scene(16)
    port = np.concatenate([s.soup.positions for s in city.shapes])
    mine = geometry.triangles(city_10ghz.parts(cfg("city_10ghz")))
    assert np.array_equal(port, mine.astype(np.float32))


def test_the_scene_bakes_the_same_triangles():
    from wave_tracer_tpu_torch.scene.build import bake_scene_arrays
    from wtbench.tests.conftest import UTD_TINY
    c = cfg("city_10ghz")
    arrays, _ = bake_scene_arrays(city_10ghz.scene(c, dict(UTD_TINY,
                                                           resolution=8)))
    tris = geometry.triangles(city_10ghz.parts(c)).astype(np.float32)
    assert np.array_equal(arrays["geo.p0"], tris[:, 0])
    assert len(arrays["edges.p0"]) == 2356
