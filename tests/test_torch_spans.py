"""The port's spans and pool counters (wave_tracer_tpu_torch/util/stats.py)
on the CPU: off without a profiler, nested as the pool, the bounces and
the forward depth step name them under one, the pool's occupancy
counters, and the benchmark's readers of them in a traced run of a tiny
cell."""

import time

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from test_torch_threads import cap_torch_threads
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.scene.build import build_scene
from wave_tracer_tpu_torch.scene.procedural import make_box_scene
from wave_tracer_tpu_torch.util.stats import registry

cap_torch_threads()

RES, SPP, DEPTH = 8, 2, 4
PATHS = RES * RES * SPP
WAVE_STAGES = ("trace", "cones", "edges", "fsd", "nee", "scatter")
CLASSICAL_STAGES = ("trace", "nee", "scatter")


def parent_of(name):
    """The span each span of a pool render runs under."""
    if name == "wt.frame":
        return None
    if name in ("wt.pool.step", "wt.pool.poll"):
        return "wt.frame"
    if name.startswith("wt.pool."):
        return "wt.pool.step"
    return "wt.pool.bounce"


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for fsd in (True, False):
        scene = make_box_scene(res=RES, spp=SPP)
        scene.integrator.fsd = fsd
        scene.integrator.max_depth = DEPTH
        out[fsd] = build_scene(scene, device="cpu")
    return out


def test_spans_off_without_profiler(scenes, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    registry.reset()
    _, st = render_scene(scenes[True], device="cpu", pool_lanes=PATHS // 4)
    assert st["mode"] == "wave-compact"
    assert not [k for k, v in registry.report().items()
                if k.startswith("wt.") and v["count"]]
    assert registry.spans == []


@pytest.mark.parametrize("fsd", [True, False], ids=["wave", "classical"])
def test_spans_under_profiler(scenes, fsd):
    registry.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, st = render_scene(scenes[fsd], device="cpu",
                             pool_lanes=PATHS // 4)
    stages = WAVE_STAGES if fsd else CLASSICAL_STAGES
    names = {"wt.frame", "wt.pool.step", "wt.pool.splat", "wt.pool.refill",
             "wt.pool.bounce", "wt.pool.poll"} \
        | {f"wt.bounce.{s}" for s in stages}
    counts = {e.key: e.count for e in prof.key_averages()
              if e.key.startswith("wt.")}
    assert set(counts) == names
    rep = registry.report()
    for name in names:
        assert rep[name]["count"] == counts[name], name
        assert 0 <= rep[name]["self_stream_s"] \
            <= rep[name]["stream_s"] + 1e-9, name
    assert counts["wt.frame"] == 1
    assert counts["wt.pool.step"] == st["pool_steps"] \
        == counts["wt.pool.poll"] == counts["wt.bounce.trace"]

    # the profiler's nesting: each span's nearest enclosing wt. span
    for e in prof.events():
        if not e.name.startswith("wt."):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith("wt."):
            up = up.cpu_parent
        assert (up.name if up else None) == parent_of(e.name), e.name
    # the registry's: the same parents, and children's stream time within
    # their parents'
    kids = {}
    for s in registry.spans:
        assert (s.parent.name if s.parent else None) == parent_of(s.name)
        if s.parent is not None:
            kids.setdefault(id(s.parent), [s.parent, []])[1].append(s)
    for parent, children in kids.values():
        assert sum(c.stream_s for c in children) <= parent.stream_s + 1e-9
    # a bounce's stages run in order, one after another, none overlapping
    for parent, children in kids.values():
        if parent.name == "wt.pool.bounce":
            assert [c.name for c in children] \
                == [f"wt.bounce.{s}" for s in stages]
            for a, b in zip(children, children[1:]):
                assert a.host1 <= b.host0
    assert {s.frame for s in registry.spans} == {registry.spans[0].frame}


def test_forward_spans_under_profiler():
    from wave_tracer_tpu_torch.scene.procedural import make_coverage_scene
    built = build_scene(make_coverage_scene(8), device="cpu")
    depth = built.scene.integrator.max_depth
    registry.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, st = render_scene(built, device="cpu", spp=1, pool_lanes=64)
    assert st["mode"] == "forward-wave" and st["batches"] == 1
    counts = {e.key: e.count for e in prof.key_averages()
              if e.key.startswith("wt.")}
    assert counts == {"wt.frame": 1, "wt.forward.step": depth,
                      "wt.forward.edges": depth}
    rep = registry.report()
    assert {k: rep[k]["count"] for k in counts} == counts
    assert [(s.name, s.parent and s.parent.name)
            for s in registry.spans[:3]] \
        == [("wt.frame", None), ("wt.forward.step", "wt.frame"),
            ("wt.forward.edges", "wt.forward.step")]


@pytest.mark.parametrize("lanes", [PATHS, PATHS // 4],
                         ids=["width_paths", "width_quarter"])
def test_pool_counters(scenes, lanes):
    registry.reset()
    _, st = render_scene(scenes[True], device="cpu", pool_lanes=lanes)
    rep = registry.report()
    steps, slots = rep["pool/steps"], rep["pool/lane_slots"]
    assert st["pool_lanes"] == lanes
    assert (st["pool_steps"], st["pool_lane_slots"]) == (steps, slots)
    assert slots == lanes * steps
    assert 0 < rep["pool/drain_steps"] < steps
    if lanes == PATHS:           # the first step hands out every id
        assert rep["pool/drain_steps"] == steps - 1
    rays = st["device_counters"]["rays_cast"]
    assert rep["integrator/rays_cast"] == rays
    assert st["pool_occupancy"] == rays / slots
    assert 0 < st["pool_occupancy"] <= 1


def test_traced_tiny_cell_reports_program_metrics(tmp_path):
    from wtbench import harness
    from wtbench.tests.conftest import TINY_BOX, add_tiny_cells

    add_tiny_cells(tmp_path)
    cell = harness.load_cell(tmp_path, TINY_BOX, tmp_path / "wtbench")
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    registry.reset()
    try:
        result, _ = harness.run(cell, 2 ** 31 + 77, 0.0, 1, "cpu",
                                time.perf_counter())
    finally:
        torch.set_num_threads(n)
    metrics = result["metrics"]
    for name in ("pool_occupancy", "cone_stage_pct", "pool_overhead_pct"):
        assert 0 < metrics[name]["value"] <= 100, name
        assert metrics[name]["unit"] == "%"
    rep = registry.report()
    assert metrics["pool_occupancy"]["value"] == pytest.approx(
        100 * rep["integrator/rays_cast"] / rep["pool/lane_slots"])
    # the spans are the traced window's frames only
    assert rep["wt.frame"]["count"] == result["attempted"]
