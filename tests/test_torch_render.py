"""Port parity for the whole classical slice: wave_tracer_tpu_torch renders
the box (plt_path, fsd=False) on the CPU and is held against the JAX
package's render_scene on the CPU, with the same seed.

Both sample every path from the same bit-equal Sobol streams, so the
comparison is per pixel. The bars are loose only to absorb (a) the rare
near-edge hit flips between the port's Plücker all-pairs test and the JAX
CPU path's Möller–Trumbore brute test, and (b) splat-order rounding:
  * image mean per channel within 1%;
  * >= 98% of pixels within 1e-3·max(|ref|, mean|ref|);
  * device counters (rays, shadow, surface, rr_kill, depth_sum) within 0.5%.
The port's own bake keeps triangles in soup order, so its NEE picks other
triangles of the lamp for the same draw than the JAX BVH order does: that
render is held to the JAX image mean within 5%."""

import dataclasses

import numpy as np
import pytest

from test_render import make_box_scene
from wave_tracer_tpu.render import render_scene as jrender
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu_torch.render import Renderer, render_scene
from wave_tracer_tpu_torch.scene.build import BuiltScene, build_scene
from wave_tracer_tpu_torch.scene.bridge import SPECTRAL_KEYS
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene

RES, SPP, DEPTH, LANES = 24, 4, 5, 1024
COUNTERS = ("rays_cast", "shadow_rays", "surface_interactions",
            "rr_terminations", "sum_path_depth")


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


def _classical(scene):
    scene.integrator.fsd = False
    scene.integrator.max_depth = DEPTH
    return scene


@pytest.fixture(scope="module")
def renders():
    jb = jbuild(_classical(make_box_scene(res=RES, spp=SPP)))
    jimg, jst = jrender(jb, spp=SPP, batch_lanes=LANES)
    arrays = _flatten(jb.data)
    spectral = {k: arrays[f"spectral.{k}"] for k in SPECTRAL_KEYS}
    tscene = _classical(tmake_box_scene(res=RES, spp=SPP))
    bridged = BuiltScene.upload(tscene, arrays, [spectral], "cpu")
    bimg, bst = render_scene(bridged, device="cpu", pool_lanes=LANES)
    own = build_scene(tscene, device="cpu")
    oimg, ost = render_scene(own, device="cpu", pool_lanes=LANES)
    return dict(jax=(jimg, jst), bridged=(bimg, bst), own=(oimg, ost),
                own_built=own)


def test_bridged_render_matches_jax(renders):
    jimg, jst = renders["jax"]
    img, st = renders["bridged"]
    assert img.shape == jimg.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    mean, mref = img.mean((0, 1)), jimg.mean((0, 1))
    np.testing.assert_allclose(mean, mref, rtol=0.01)
    scale = np.maximum(np.abs(jimg), np.abs(jimg).mean())
    within = (np.abs(img - jimg) <= 1e-3 * scale).all(-1)
    assert within.mean() >= 0.98
    for k in COUNTERS:
        a, b = st["device_counters"][k], jst["device_counters"][k]
        assert abs(a - b) <= 0.005 * b, (k, a, b)
    assert st["mode"] == "ray-compact" and st["paths_per_sec"] > 0


def test_own_bake_render_mean(renders):
    jimg, _ = renders["jax"]
    img, st = renders["own"]
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), jimg.mean(), rtol=0.05)
    assert st["device_counters"]["rays_cast"] > 0


def test_pool_size_does_not_change_the_image(renders):
    img, st = renders["own"]
    img2, st2 = render_scene(renders["own_built"], device="cpu",
                             pool_lanes=LANES // 4)
    np.testing.assert_allclose(img2, img, rtol=1e-5, atol=1e-12)
    for k in COUNTERS:
        assert st2["device_counters"][k] == st["device_counters"][k]


def test_unported_configurations_raise(renders):
    built = renders["own_built"]
    assert Renderer(built).device == "cuda"
    built.scene.integrator.fsd = True
    try:
        with pytest.raises(NotImplementedError):
            render_scene(built, device="cpu")
        built.scene.integrator.ray_trace_only = True   # classical again
        img, _ = render_scene(built, spp=1, device="cpu", pool_lanes=256)
        assert np.isfinite(img).all()
    finally:
        built.scene.integrator.fsd = False
        built.scene.integrator.ray_trace_only = False
