"""Port parity for the whole materials slice: wave_tracer_tpu_torch renders
the materials box (scene/procedural.py::make_materials_box_scene: glass,
a rough conductor, bitmap, checkerboard, composite, normal-mapped and
masked surfaces, an area lamp and a spot light, 10,254 triangles) at
16×16 × 4 spp on the CPU (depth 5; bdpt depth 4), from the JAX
package's bake of its twin
(test_torch_materials_modules.jmake_materials_box), and is held against
the JAX package's render_scene on the CPU, with the same seed and lanes.

The bars are those of the earlier slices' render tests:
  * classical plt_path (FSD off), per pixel as
    tests/test_torch_render.py holds the box: each channel's mean within
    1%, >= 98% of pixels within 1e-3·max(|ref|, mean|ref|), the counters
    rays, shadow rays, surface interactions, RR kills and depth sum
    within 0.5%;
  * the wave plt_path (FSD on) as tests/test_torch_wave_render.py holds
    the box: each channel's mean within 2%, Pearson >= 0.999, >= 90% of
    pixels within 1e-2·max(|ref|, mean|ref|), the live-lane counters
    within 2%;
  * plt_bdpt with Fraunhofer FSD and a polarimetric sensor, on the
    intensity plane of each channel as tests/test_torch_bdpt_render.py
    holds the box (means within 2%, Pearson >= 0.999, >= 90% of pixels
    within 1e-2), and every pixel's Stokes vector physical: |(Q, U, V)|
    <= I·(1 + 1e-5) + 1e-6·max I on both sides.
A last test renders the box of the earlier slices with every feature
branch of the material, texture and emitter tables forced on: the image
and counters equal bit for bit those of the render that skips the
branches no row uses (and draws no lobe pair), under each integrator.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_materials_modules import jmake_materials_box
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.render import render_scene as jrender
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.scene.bridge import SPECTRAL_KEYS
from wave_tracer_tpu_torch.scene.build import BuiltScene, build_scene
from wave_tracer_tpu_torch.scene.procedural import (make_box_scene,
                                                    make_materials_box_scene)

cap_torch_threads()

RES, SPP, DEPTH, LANES = 16, 4, 5, 1024
BDPT_DEPTH = 4     # as tests/test_torch_bdpt_render.py: the JAX bdpt
                   # compile grows with the subpaths' vertex count


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


def _configure(scene, integrator, fsd, polarimetric=False):
    scene.integrator.type = integrator
    scene.integrator.fsd = fsd
    scene.integrator.max_depth = BDPT_DEPTH if integrator == "plt_bdpt" \
        else DEPTH
    scene.sensors[0].polarimetric = polarimetric
    return scene


def _pair(integrator, fsd, polarimetric=False):
    """(JAX image and stats, the port's image and stats) of the bridged
    materials box."""
    jb = jbuild(_configure(jmake_materials_box(res=RES, spp=SPP),
                           integrator, fsd, polarimetric))
    jimg, jst = jrender(jb, spp=SPP, batch_lanes=LANES)
    arrays = _flatten(jb.data)
    tscene = _configure(make_materials_box_scene(res=RES, spp=SPP),
                        integrator, fsd, polarimetric)
    bridged = BuiltScene.upload(
        tscene, arrays, [{k: arrays[f"spectral.{k}"] for k in SPECTRAL_KEYS}],
        "cpu")
    img, st = render_scene(bridged, device="cpu", pool_lanes=LANES)
    return (np.asarray(jimg), jst), (img, st)


def _counters(st, jst, keys, rtol):
    for key in keys:
        a, b = st["device_counters"][key], jst["device_counters"][key]
        assert abs(a - b) <= rtol * b, (key, a, b)


def _image_bars(img, ref, *, mean_rtol, px_tol, px_frac, corr=None):
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert ref.mean() > 0
    np.testing.assert_allclose(img.mean((0, 1)), ref.mean((0, 1)),
                               rtol=mean_rtol)
    scale = np.maximum(np.abs(ref), np.abs(ref).mean())
    assert ((np.abs(img - ref) <= px_tol * scale).all(-1)).mean() >= px_frac
    if corr is not None:
        assert np.corrcoef(img.ravel(), ref.ravel())[0, 1] >= corr


def test_classical_matches_jax_per_pixel():
    (jimg, jst), (img, st) = _pair("plt_path", fsd=False)
    assert st["mode"] == jst["mode"] == "ray-compact"
    _image_bars(img, jimg, mean_rtol=0.01, px_tol=1e-3, px_frac=0.98)
    _counters(st, jst, ("rays_cast", "shadow_rays", "surface_interactions",
                        "rr_terminations", "sum_path_depth"), 0.005)


def test_wave_matches_jax():
    (jimg, jst), (img, st) = _pair("plt_path", fsd=True)
    assert st["mode"] == jst["mode"] == "wave-compact"
    _image_bars(img, jimg, mean_rtol=0.02, px_tol=1e-2, px_frac=0.90,
                corr=0.999)
    _counters(st, jst, ("rays_cast", "rr_terminations", "sum_path_depth",
                        "ballistic_traversals", "diffusive_traversals"),
              0.02)
    assert st["device_counters"]["fsd_interactions"] > 0


def test_polarimetric_bdpt_matches_jax():
    (jimg, jst), (img, st) = _pair("plt_bdpt", fsd=True, polarimetric=True)
    assert st["mode"] == jst["mode"] == "bdpt"
    assert img.shape == jimg.shape == (RES, RES, 12)
    _image_bars(img[..., 0::4], jimg[..., 0::4], mean_rtol=0.02,
                px_tol=1e-2, px_frac=0.90, corr=0.999)
    for im in (img, jimg):
        s = im.reshape(RES, RES, 3, 4)
        pol = np.linalg.norm(s[..., 1:], axis=-1)
        assert (pol <= s[..., 0] * (1 + 1e-5)
                + 1e-6 * s[..., 0].max()).all()
        assert pol.max() > 0          # the glass and metal polarize
    assert st["device_counters"]["fsd_interactions"] > 0


def _force_all_branches(built):
    """The same bake with every has_* flag of its tables set."""
    t = built.data.tables
    tables = dataclasses.replace(
        t, materials=dataclasses.replace(
            t.materials, has_spm=True, has_dielectric=True, has_mask=True,
            has_normalmap=True, has_composite=True),
        textures=dataclasses.replace(t.textures, has_rgb=True,
                                     has_bitmap=True, has_checker=True))
    emitters = dataclasses.replace(built.data.emitters, has_spot=True,
                                   has_directional=True)
    return dataclasses.replace(built, data=dataclasses.replace(
        built.data, tables=tables, emitters=emitters))


@pytest.mark.parametrize("integrator,fsd", [
    ("plt_path", False), ("plt_path", True), ("plt_bdpt", True)])
def test_box_unchanged_by_the_feature_branches(integrator, fsd):
    """The box of the earlier slices uses none of this slice's features:
    skipping their branches (and the lobe pair's draw) leaves every pixel
    and counter bit for bit what the full selection gives."""
    scene = _configure(make_box_scene(res=8, spp=2), integrator, fsd)
    built = build_scene(scene, device="cpu")
    t = built.data.tables
    assert not (t.materials.has_spm or t.materials.has_dielectric
                or t.materials.has_mask or t.textures.has_rgb
                or built.data.emitters.has_spot)
    img, st = render_scene(built, device="cpu", pool_lanes=64)
    img_all, st_all = render_scene(_force_all_branches(built), device="cpu",
                                   pool_lanes=64)
    np.testing.assert_array_equal(img_all, img)
    assert st_all["device_counters"] == st["device_counters"]
