"""Port parity for the whole wave slice: wave_tracer_tpu_torch renders the
box with plt_path and free-space diffraction on (the wave bounce through
the compacted pool) on the CPU, and is held against the JAX package's
render_scene on the CPU, with the same seed and 1024 lanes.

Both sample every path from the same bit-equal Sobol streams, but the
traversal class and the FSD sets of a lane rest on float thresholds
(cone-entry membership, the envelope window), and the coherent sum takes
(ri + ro − d)·k in f32 with k ~ 1e7 rad/m, where one ulp of a distance is
O(1) rad of phase. Swapping only the JAX package's own cone-query backend
(the same math, executed differently) moves the image by: channel means
within 0.15%, Pearson 0.99999, 95.5% of pixels within 1e-2 and counters
within 0.75%. The bars are about twice that spread:
  * each channel's mean within 2%;
  * Pearson correlation of the images >= 0.999;
  * >= 90% of pixels within 1e-2·max(|ref|, mean|ref|);
  * rays_cast, surface_interactions, fsd_interactions,
    diffusive_traversals and sum_path_depth within 2%.
The port's own bake keeps triangles and edges in soup order, so its NEE
picks other lamp triangles for the same draw than the JAX BVH order does:
that render is held to the JAX image mean within 5%."""

import dataclasses
import functools

import numpy as np
import pytest

from test_render import make_box_scene
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.render import render_scene as jrender
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu_torch.accel import ray_kernels
from wave_tracer_tpu_torch.integrator import path_compact, plt_path
from wave_tracer_tpu_torch.render import renderer as renderer_mod
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.scene.build import BuiltScene, build_scene
from wave_tracer_tpu_torch.scene.bridge import SPECTRAL_KEYS
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene
from wave_tracer_tpu_torch.util import stats as stats_mod

cap_torch_threads()

RES, SPP, DEPTH, LANES = 16, 4, 5, 1024
COUNTERS = ("rays_cast", "surface_interactions", "fsd_interactions",
            "diffusive_traversals", "sum_path_depth")
# counters taken over live lanes only (the JAX package counts surface,
# FSD and null interactions and shadow rays over the whole pool, dead
# lanes included, so those depend on the pool size)
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


def _wave(scene):
    scene.integrator.fsd = True
    scene.integrator.max_depth = DEPTH
    return scene


@pytest.fixture(scope="module")
def renders():
    jb = jbuild(_wave(make_box_scene(res=RES, spp=SPP)))
    jimg, jst = jrender(jb, spp=SPP, batch_lanes=LANES)
    arrays = _flatten(jb.data)
    spectral = {k: arrays[f"spectral.{k}"] for k in SPECTRAL_KEYS}
    tscene = _wave(tmake_box_scene(res=RES, spp=SPP))
    bridged = BuiltScene.upload(tscene, arrays, [spectral], "cpu")
    bimg, bst = render_scene(bridged, device="cpu", pool_lanes=LANES)
    own = build_scene(tscene, device="cpu")
    oimg, ost = render_scene(own, device="cpu", pool_lanes=LANES)
    return dict(jax=(jimg, jst), bridged=(bimg, bst), own=(oimg, ost),
                own_built=own)


def test_bridged_wave_render_matches_jax(renders):
    jimg, jst = renders["jax"]
    img, st = renders["bridged"]
    assert jst["mode"] == st["mode"] == "wave-compact"
    assert img.shape == jimg.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    np.testing.assert_allclose(img.mean((0, 1)), jimg.mean((0, 1)),
                               rtol=0.02)
    assert np.corrcoef(img.ravel(), jimg.ravel())[0, 1] >= 0.999
    scale = np.maximum(np.abs(jimg), np.abs(jimg).mean())
    assert (np.abs(img - jimg) <= 1e-2 * scale).all(-1).mean() >= 0.90
    for k in COUNTERS:
        a, b = st["device_counters"][k], jst["device_counters"][k]
        assert abs(a - b) <= 0.02 * b, (k, a, b)
    dc = st["device_counters"]
    assert dc["fsd_interactions"] > 0 and dc["edge_sweep_hits"] > 0
    assert sum(dc["tris_per_cone_hist"]) == dc["rays_cast"]


def test_own_bake_wave_render_mean(renders):
    jimg, _ = renders["jax"]
    img, st = renders["own"]
    assert st["mode"] == "wave-compact"
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), jimg.mean(), rtol=0.05)
    assert st["device_counters"]["fsd_interactions"] > 0


def test_wave_pool_size_does_not_change_the_image(renders):
    img, st = renders["own"]
    img2, st2 = render_scene(renders["own_built"], device="cpu",
                             pool_lanes=LANES // 4)
    np.testing.assert_allclose(img2, img, rtol=1e-5, atol=1e-12)
    for k in LANE_COUNTERS:
        assert st2["device_counters"][k] == st["device_counters"][k], k


def test_fsd_scene_without_edges_renders_classically(renders):
    """As in the JAX renderer: FSD needs wedge edges, and a scene whose
    edge table is empty takes the classical bounce."""
    own = renders["own_built"]
    arrays = dict(own.arrays)
    for key in [k for k in arrays if k.startswith("edges.")]:
        arrays[key] = arrays[key][:0]
    bare = BuiltScene.upload(own.scene, arrays, own.spectral_arrays, "cpu")
    img, st = render_scene(bare, spp=1, device="cpu", pool_lanes=256)
    assert bare.data.edges.count == 0
    assert st["mode"] == "ray-compact" and np.isfinite(img).all()
    assert st["device_counters"]["fsd_interactions"] == 0


def test_wave_carried_hits_change_nothing(renders, monkeypatch):
    """The pool traces only the lanes whose ray changed and carries the
    last hit of the others; lanes ended by the depth cap hold a new ray
    that is not traced yet, and refilled lanes a fresh one. The image and
    every counter equal, bit for bit, those of a render that traces every
    lane at every step (a pool smaller than the paths, so lanes refill).
    The wave bounce reads every lane's hit (zmax, and counters over the
    whole pool), dead lanes included."""
    built = renders["own_built"]
    shares = []
    real = ray_kernels.closest_hit

    def spy(*args, **kw):
        need = args[7] if len(args) > 7 else kw.get("need")
        shares.append(None if need is None else need.float().mean().item())
        return real(*args, **kw)

    monkeypatch.setattr(ray_kernels, "closest_hit", spy)
    img, st = render_scene(built, device="cpu", pool_lanes=LANES // 4)
    assert None not in shares and shares[0] == 1.0
    assert min(shares) < 0.5
    del shares[:]
    monkeypatch.setattr(renderer_mod, "render_pool", functools.partial(
        path_compact.render_pool, carry_hits=False))
    img0, st0 = render_scene(built, device="cpu", pool_lanes=LANES // 4)
    assert shares and all(x is None for x in shares)
    np.testing.assert_array_equal(img, img0)
    assert st["device_counters"] == st0["device_counters"]


@pytest.mark.parametrize("lanes", [LANES // 4, 100])
def test_wave_pool_sweeps_only_the_rows_it_reads(renders, monkeypatch,
                                                 lanes):
    """K3 sweeps only the rows whose answer is read: the live lanes, and
    the dead ones whose ray no bounce has classified yet (lanes the depth
    cap ended while the pool drains); a dead lane counts the interaction
    it was classified under. The image and every counter equal, bit for
    bit, those of a render that sweeps every row and classifies every
    lane anew at each bounce (the bounce without the carried class).
    k3/rows_swept is integrator/rays_cast plus those dead unclassified
    rows, and with k3/rows_skipped makes pool/lane_slots."""
    built = renders["own_built"]
    reg = stats_mod.registry
    names = ("k3/rows_swept", "k3/rows_skipped", "pool/lane_slots")
    unclassified = []
    real_swept = plt_path.swept_lanes

    def spy(st, with_stats):
        rows = real_swept(st, with_stats)
        unclassified.append(int((rows & ~st["active"]).sum()))
        return rows

    monkeypatch.setattr(plt_path, "swept_lanes", spy)
    before = [reg.counter(n).value for n in names]
    img, st = render_scene(built, device="cpu", pool_lanes=lanes)
    swept, skipped, slots = (reg.counter(n).value - b
                             for n, b in zip(names, before))
    monkeypatch.setattr(plt_path, "swept_lanes", real_swept)
    real_bounce = path_compact.wave_bounce

    def every_row(data, edges, st, *args, **kw):
        st = dict(st)
        carried = st.pop("interaction")
        return dict(real_bounce(data, edges, st, *args, **kw),
                    interaction=carried)

    monkeypatch.setattr(path_compact, "wave_bounce", every_row)
    before = reg.counter("k3/rows_skipped").value
    img0, st0 = render_scene(built, device="cpu", pool_lanes=lanes)
    assert reg.counter("k3/rows_skipped").value == before
    np.testing.assert_array_equal(img, img0)
    assert st["device_counters"] == st0["device_counters"]
    assert swept == st["device_counters"]["rays_cast"] + sum(unclassified)
    assert sum(unclassified) > 0 and skipped > 0
    assert swept + skipped == slots == lanes * len(unclassified)
