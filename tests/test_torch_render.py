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
import functools

import numpy as np
import pytest

from test_render import make_box_scene
from wave_tracer_tpu.render import render_scene as jrender
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu_torch.accel import ray_kernels
from wave_tracer_tpu_torch.integrator import path_compact
from wave_tracer_tpu_torch.render import renderer as renderer_mod
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


class _PlaneSensor:
    """Stands in for a sensor type the port does not render."""
    ray_trace_only = False


def test_unported_configurations_raise(renders, monkeypatch):
    built = renders["own_built"]
    assert Renderer(built).device == "cuda"
    sensors = built.scene.sensors
    built.scene.sensors = [_PlaneSensor()]
    try:
        with pytest.raises(NotImplementedError, match="_PlaneSensor"):
            render_scene(built, device="cpu")
    finally:
        built.scene.sensors = sensors
    with monkeypatch.context() as m:
        m.setenv("WT_SAMPLER", "uniform")
        with pytest.raises(NotImplementedError, match="Sobol"):
            render_scene(built, spp=1, device="cpu", pool_lanes=256)
    built.scene.integrator.type = "plt_bdpt"
    sensor = built.scene.sensors[0]
    try:
        sensor.polarimetric = True
        with pytest.raises(NotImplementedError, match="polarimetric"):
            render_scene(built, spp=1, device="cpu", pool_lanes=256)
        sensor.polarimetric = False
        built.scene.integrator.ray_trace_only = True   # classical again
        img, st = render_scene(built, spp=1, device="cpu", pool_lanes=256)
        assert np.isfinite(img).all() and st["mode"] == "ray-compact"
    finally:
        sensor.polarimetric = False
        built.scene.integrator.type = "plt_path"
        built.scene.integrator.ray_trace_only = False


def test_carried_hits_change_nothing(renders, monkeypatch):
    """The pool traces only the lanes whose ray changed and carries the
    last hit of the others; lanes ended by the depth cap hold a new ray
    that is not traced yet, and refilled lanes a fresh one. The image and
    every counter equal, bit for bit, those of a render that traces every
    lane at every step (a pool smaller than the paths, so lanes refill)."""
    built = renders["own_built"]
    shares = []
    real = ray_kernels.closest_hit

    def spy(*args, **kw):
        need = args[7] if len(args) > 7 else kw.get("need")
        shares.append(None if need is None else need.float().mean().item())
        return real(*args, **kw)

    monkeypatch.setattr(ray_kernels, "closest_hit", spy)
    img, st = render_scene(built, device="cpu", pool_lanes=LANES)
    assert None not in shares and shares[0] == 1.0
    assert min(shares) < 0.5
    del shares[:]
    monkeypatch.setattr(renderer_mod, "render_pool", functools.partial(
        path_compact.render_pool, carry_hits=False))
    img0, st0 = render_scene(built, device="cpu", pool_lanes=LANES)
    assert shares and all(x is None for x in shares)
    np.testing.assert_array_equal(img, img0)
    assert st["device_counters"] == st0["device_counters"]
