"""Port parity for the whole bdpt slice: wave_tracer_tpu_torch renders the
box with plt_bdpt and Fraunhofer free-space diffraction on, on the CPU,
and is held against the JAX package's render_scene on the CPU, with the
same seed and batches of 1024 lanes (16×16 pixels × 4 spp: one batch).

Both sample every path from the same bit-equal Sobol streams, but the
FSD classification of a walk step (edge-sweep membership, the mid-flight
window) and the RIS pick sit on float thresholds, and the walks' vertices
differ by ~1e-6 m (Möller–Trumbore against Plücker intersection), so a few
lanes take another branch. The bars are those of the wave slice
(tests/test_torch_wave_render.py):
  * each channel's mean within 2%;
  * Pearson correlation of the images >= 0.999;
  * >= 90% of pixels within 1e-2·max(|ref|, mean|ref|);
  * the counters, all counted over live lanes: rays_cast,
    surface_interactions, fsd_interactions, sum_path_depth and
    shadow_rays within 2%; edge_sweep_hits within 8% and
    null_interactions within 18%. Those two count rare steps (about
    1,200 and 420 here) of which a lane that takes another branch moves
    several: the JAX package's own jitted and eager (jax.disable_jit)
    light walks of 256 of these lanes differ by 4.4% (129 against 135)
    and 10% (63 against 70) on them, and the bars are about twice that;
    the port's walk differs from the eager one by 1.5% and 2.9%
    (`python tests/test_torch_bdpt_render.py` prints the three).
The port's own bake keeps triangles and edges in soup order, so its NEE
picks other lamp triangles for the same draw than the JAX BVH order does:
that render is held to the JAX image mean within 5%."""

import dataclasses

import numpy as np
import pytest
import torch

from test_render import make_box_scene
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.render import render_scene as jrender
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu_torch.accel import ray_kernels
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.scene.build import BuiltScene, build_scene
from wave_tracer_tpu_torch.scene.bridge import SPECTRAL_KEYS
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene

cap_torch_threads()

RES, SPP, DEPTH, LANES = 16, 4, 4, 1024
COUNTERS = ("rays_cast", "surface_interactions", "fsd_interactions",
            "sum_path_depth", "shadow_rays")
RARE_COUNTERS = {"edge_sweep_hits": 0.08, "null_interactions": 0.18}


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


def _bdpt(scene, fsd=True, depth=DEPTH):
    scene.integrator.type = "plt_bdpt"
    scene.integrator.fsd = fsd
    scene.integrator.max_depth = depth
    return scene


@pytest.fixture(scope="module")
def renders():
    jb = jbuild(_bdpt(make_box_scene(res=RES, spp=SPP)))
    jimg, jst = jrender(jb, spp=SPP, batch_lanes=LANES)
    arrays = _flatten(jb.data)
    spectral = {k: arrays[f"spectral.{k}"] for k in SPECTRAL_KEYS}
    tscene = _bdpt(tmake_box_scene(res=RES, spp=SPP))
    bridged = BuiltScene.upload(tscene, arrays, [spectral], "cpu")
    bimg, bst = render_scene(bridged, device="cpu", pool_lanes=LANES)
    own = build_scene(tscene, device="cpu")
    oimg, ost = render_scene(own, device="cpu", pool_lanes=LANES)
    return dict(jax=(jimg, jst), bridged=(bimg, bst), own=(oimg, ost),
                bridged_built=bridged, own_built=own)


def test_bridged_bdpt_render_matches_jax(renders):
    jimg, jst = renders["jax"]
    img, st = renders["bridged"]
    assert st["mode"] == jst["mode"] == "bdpt"
    assert img.shape == jimg.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    np.testing.assert_allclose(img.mean((0, 1)), jimg.mean((0, 1)),
                               rtol=0.02)
    assert np.corrcoef(img.ravel(), jimg.ravel())[0, 1] >= 0.999
    scale = np.maximum(np.abs(jimg), np.abs(jimg).mean())
    within = (np.abs(img - jimg) <= 1e-2 * scale).all(-1)
    assert within.mean() >= 0.90
    assert st["device_counters"]["fsd_interactions"] > 0
    for k in COUNTERS:
        a, b = st["device_counters"][k], jst["device_counters"][k]
        assert abs(a - b) <= 0.02 * b, (k, a, b)
    for k, rtol in RARE_COUNTERS.items():
        a, b = st["device_counters"][k], jst["device_counters"][k]
        assert abs(a - b) <= rtol * b, (k, a, b)
    assert st["paths"] == RES * RES * SPP and st["spp_done"] == SPP


def test_own_bake_bdpt_render_mean(renders):
    jimg, _ = renders["jax"]
    img, st = renders["own"]
    assert np.isfinite(img).all() and st["mode"] == "bdpt"
    np.testing.assert_allclose(img.mean(), jimg.mean(), rtol=0.05)
    assert st["device_counters"]["fsd_interactions"] > 0


@pytest.mark.parametrize("lanes", [LANES // 4, 3 * LANES // 8])
def test_batch_width_does_not_change_the_image(renders, lanes):
    """Every draw is keyed by (pixel, sample): batches of 256 lanes (4
    pixel batches) or of 384 (a partial last batch) give the same image
    and counters as one batch of 1024, up to splat-order rounding."""
    img, st = renders["own"]
    img2, st2 = render_scene(renders["own_built"], device="cpu",
                             pool_lanes=lanes)
    assert st2["pool_lanes"] < st["pool_lanes"]
    np.testing.assert_allclose(img2, img, rtol=1e-5, atol=1e-12)
    assert st2["device_counters"] == st["device_counters"]


def test_rows_off_need_are_never_read(renders, monkeypatch):
    """Every K1 and K2 call of the bdpt render passes a need mask; rows
    off it get a poisoned result (K1: a hit on triangle 0 at t = 0.5, K2:
    occluded), and the image and every counter stay bit for bit."""
    built = renders["bridged_built"]
    img0, st0 = render_scene(built, device="cpu", pool_lanes=LANES)
    real_closest, real_any = ray_kernels.closest_hit, ray_kernels.any_hit
    shares = {"closest": [], "anyhit": []}

    def closest(*args, **kw):
        t, tri = real_closest(*args, **kw)
        need = args[7]
        shares["closest"].append(need.float().mean().item())
        return (torch.where(need, t, 0.5),
                torch.where(need, tri, torch.zeros_like(tri)))

    def any_hit(*args, **kw):
        occ = real_any(*args, **kw)
        need = args[7]
        shares["anyhit"].append(need.float().mean().item())
        return torch.where(need, occ, True)

    monkeypatch.setattr(ray_kernels, "closest_hit", closest)
    monkeypatch.setattr(ray_kernels, "any_hit", any_hit)
    img, st = render_scene(built, device="cpu", pool_lanes=LANES)
    assert min(shares["closest"]) < 0.5 and min(shares["anyhit"]) < 0.5
    # the walks' 2·(depth+2) traces, and depth·(depth+2) shadow calls
    assert len(shares["closest"]) == 2 * (DEPTH + 2)
    assert len(shares["anyhit"]) == DEPTH * (DEPTH + 2)
    np.testing.assert_array_equal(img, img0)
    assert st["device_counters"] == st0["device_counters"]


def test_bdpt_matches_path_mean():
    """FSD off, the port's bdpt and plt_path estimate the same image of
    the box: means within the bar of tests/test_bdpt.py (0.95-1.06) at
    24×24, 16 spp, depth 8 (measured 1.004 at 16×16)."""
    scene = tmake_box_scene(res=24, spp=16)
    scene.integrator.fsd = False
    scene.integrator.max_depth = 8
    built = build_scene(scene, device="cpu")
    img_p, st_p = render_scene(built, device="cpu")
    assert st_p["mode"] == "ray-compact"
    scene.integrator.type = "plt_bdpt"
    img_b, st_b = render_scene(built, device="cpu")
    assert st_b["mode"] == "bdpt" and np.isfinite(img_b).all()
    ratio = img_b.mean() / img_p.mean()
    assert 0.95 < ratio < 1.06, ratio
    assert np.corrcoef(img_p.ravel(), img_b.ravel())[0, 1] > 0.995


def _walk_spread():
    """The rare counters of one light walk (256 lanes of the box at depth 4,
    FSD on) by the JAX package jitted, by it eagerly (jax.disable_jit),
    and by the port: the spread the rare-counter bars are set against."""
    import jax
    import jax.numpy as jnp

    from wave_tracer_tpu.emitter import table as jetab
    from wave_tracer_tpu.integrator import plt_bdpt as jbdpt
    from wave_tracer_tpu.sampling import rng as jrng
    from wave_tracer_tpu.wave import sourcing as jsourcing
    from wave_tracer_tpu_torch.integrator import plt_bdpt as tbdpt
    from wave_tracer_tpu_torch.integrator.path import (STAT_EDGE_HIT,
                                                       STAT_NULL)
    from wave_tracer_tpu_torch.sampling import rng as trng
    from wave_tracer_tpu_torch.scene.bridge import scene_data_from_numpy

    scene = make_box_scene(res=RES, spp=SPP)
    jb = jbuild(scene)
    td = scene_data_from_numpy(_flatten(jb.data), "cpu")
    data = jb.data.replace(spectral=jb.spectral_per_sensor[0])
    n = 256
    pix, sid = np.arange(n) // 4, np.arange(n) % 4
    eps = 1e-4 * jb.scene.world_radius()
    jkeys = jrng.sample_key(jrng.make_base_key(0), jnp.asarray(pix),
                            jnp.asarray(sid))
    u = jrng.uniform(jkeys, jrng.D_SPECTRUM, 2)
    e0, _ = data.spectral.sample_emitter(u[:, 0])
    k, _ = data.spectral.sample_k(e0, u[:, 1])
    u_em = jnp.concatenate([jrng.uniform(jkeys, jrng.D_EMITTER_POS, 3),
                            jrng.uniform(jkeys, jrng.D_EMITTER_DIR, 1)], -1)
    em = jetab.sample_emission(data.emitters, data.geo, data.tables.spectra,
                               e0, k, u_em)
    beta = em["weight"] / data.spectral.pmf_emitter(e0)
    _, ta = jsourcing.source_emitter_mub(data.emitters, e0, k)

    def jwalk():
        return jbdpt._walk(data, None, jkeys, k, em["y"], em["wo"], beta,
                           em["pdf_dir"], DEPTH, eps, 32, ta0=ta,
                           polar="stokes", edge_table=data.edges, fsd=True,
                           K=8)["stats"]

    def t(x):
        return torch.tensor(np.asarray(x))

    tkeys = trng.sample_key(trng.make_base_key(0), t(pix), t(sid))
    rows = dict(jitted=np.asarray(jax.jit(jwalk)()))
    with jax.disable_jit():
        rows["eager"] = np.asarray(jwalk())
    rows["port"] = tbdpt._walk(
        td, tkeys, t(k), t(em["y"]), t(em["wo"]), t(beta), t(em["pdf_dir"]),
        DEPTH, eps, 32, ta0=t(ta), polar="stokes", use_fsd=True,
        K=8)["stats"].numpy()
    for name, st in rows.items():
        print(f"{name}: edge_sweep_hits {st[STAT_EDGE_HIT]:.0f}, "
              f"null_interactions {st[STAT_NULL]:.0f}")


if __name__ == "__main__":
    # python tests/test_torch_bdpt_render.py (with the repo on PYTHONPATH)
    import conftest  # noqa: F401  (JAX on the CPU)
    _walk_spread()
