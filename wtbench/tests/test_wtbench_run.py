"""Whole runs of the harness on the CPU (its look for a card skipped) on
throwaway tiny cells that are added by files and entries alone: the
result line's schema, the traced run, the control, and each fault the
cells can have coming out as not correct."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from wtbench import harness
from wtbench.tests.conftest import TINY_BOX, TINY_CITY

REPO = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 77


def run(cell, trace=0, seed=SEED):
    return harness.run(cell, seed, 0.0, trace, "cpu", time.perf_counter())


def numbers(checks):
    return {name: (v, limit) for name, v, limit in checks}


def test_extra_cell_from_files_only(tiny_cells):
    cell = tiny_cells[TINY_BOX]
    assert cell.config["name"] == "tiny_box"
    assert cell.traffic["resolution"] == 16
    assert "frames_done" in cell.readers
    # a split of a quantity by the metric it moves needs an entry only
    city = tiny_cells[TINY_CITY]
    assert city.readers["k1_roofline.coverage"].__file__.endswith(
        "metrics/k1_roofline.py")


def test_line_schema(tiny_cells):
    result, checks = run(tiny_cells[TINY_BOX])
    line = harness.line(result, checks)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 2 and line["failed"] == 0
    assert set(line["metrics"]) == {"image_paths_per_s", "peak_mem_gib",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            m["unit"] == "GiB"
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(tiny_cells[TINY_BOX].traffic["check"]
                                      ["limits"])
    json.dumps(line)


def test_traced_line(tiny_cells):
    result, checks = run(tiny_cells[TINY_CITY], trace=1)
    line = harness.line(result, checks)
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert {"busy_s", "window_s"} <= set(line["device"])
    # no device here: only the host-clock readers find something
    assert set(line["metrics"]) == {"bake_s", "frames_done"}


@pytest.mark.parametrize("name", [TINY_BOX, TINY_CITY])
def test_control_is_not_correct(tiny_cells, name):
    cell = tiny_cells[name]
    prog = harness.Program(cell, "cpu")
    win = harness.window(prog, SEED, 0.0)
    limits = cell.traffic["check"]["limits"]
    got = harness.judge(cell, win, "cpu", control=True)
    assert not harness.decide([(k, got[k], limits[k]) for k in limits]), got


# ---- faults planted underneath the timed path ----------------------------

def _k1_unchanged(mp):
    from wave_tracer_tpu_torch.accel import ray_kernels as rk

    def closest(tri_feat, center, ro, rd, tmin, tmax, ex, need=None,
                carry=None):
        n = ro.shape[0]
        if carry is None:
            return (torch.full((n,), rk._BIG_F32),
                    torch.full((n,), -1, dtype=torch.int32))
        return carry[0].clone(), carry[1].clone()
    mp.setattr(rk, "_closest_ref", closest)
    return "k1_bad"


def _k1_altered(mp):
    from wave_tracer_tpu_torch.accel import ray_kernels as rk
    orig = rk._closest_ref

    def closest(*a, **kw):
        t, tri = orig(*a, **kw)
        return t, torch.where(tri >= 0, (tri + 1) % 300, tri)
    mp.setattr(rk, "_closest_ref", closest)
    return "k1_bad"


def _k2_half(mp):
    from wave_tracer_tpu_torch.accel import ray_kernels as rk
    orig = rk._anyhit_ref

    def anyhit(*a, **kw):
        occ = orig(*a, **kw).clone()
        occ[occ.shape[0] // 2:] = False
        return occ
    mp.setattr(rk, "_anyhit_ref", anyhit)
    return "k2_bad"


def _k3_altered(mp):
    from wave_tracer_tpu_torch.accel import cone_kernels as ck
    orig = ck._minz_ref

    def minz(*a, **kw):
        zc, cnt, *rest = orig(*a, **kw)
        return (zc * 1.01, cnt, *rest)
    mp.setattr(ck, "_minz_ref", minz)
    return "k3_bad"


def _film_unchanged(mp):
    from wave_tracer_tpu_torch.sensor import film
    mp.setattr(film, "splat", lambda f, *a, **kw: f)
    return "film_gap"


def _film_half(mp):
    from wave_tracer_tpu_torch.sensor import film
    splat = film.splat

    def half(f, pos, values, mask):
        keep = mask.clone()
        keep[keep.shape[0] // 2:] = False
        return splat(f, pos, values, keep)
    mp.setattr(film, "splat", half)
    return "film_gap"


def _map_half(mp):
    from wave_tracer_tpu_torch.sensor import film
    splat = film.splat_direct_gaussian

    def half(f, pos, sig, values, mask, radius=2):
        keep = mask.clone()
        keep[keep.shape[0] // 2:] = False
        return splat(f, pos, sig, values, keep, radius)
    mp.setattr(film, "splat_direct_gaussian", half)
    return "film_gap"


def _edges_altered(mp):
    from wave_tracer_tpu_torch.accel import edges
    orig = edges.edges_near_cone

    def near(*a, **kw):
        idx, z, cnt = orig(*a, **kw)
        return idx, z * 0.9, cnt
    mp.setattr(edges, "edges_near_cone", near)
    return "edges_bad"


def _utd_altered(mp):
    from wave_tracer_tpu_torch.wave import fsd
    orig = fsd.coherent_sum

    def conj(*a, **kw):
        ts, th = orig(*a, **kw)
        return ts.conj() * 1.1, th
    mp.setattr(fsd, "coherent_sum", conj)
    return "utd_bad"


def _camera_lanes_half(mp):
    # the pool traces the first half of the frame's (pixel, sample) ids
    # and splats them as a whole frame: the film develops value / weight,
    # so the image keeps its expected value
    from wave_tracer_tpu_torch.render import renderer
    orig = renderer.render_pool

    def pool(data, film, base_key, id_bounds, lanes, **kw):
        lo, hi = id_bounds
        return orig(data, film, base_key, (lo, lo + (hi - lo) // 2), lanes,
                    **kw)
    mp.setattr(renderer, "render_pool", pool)
    return "work_gap"


def _beams_half(mp):
    # each forward batch traces the first half of its lanes; the map is
    # developed by the samples the frame asked for
    from wave_tracer_tpu_torch.render import renderer
    orig = renderer.trace_forward

    def forward(data, ids, base_key, batch, **kw):
        n = ids.shape[0] // 2
        return orig(data, ids[:n], base_key, batch[:n], **kw)
    mp.setattr(renderer, "trace_forward", forward)
    return "work_gap"


# K2 is held by the box's k2_bad; the coverage mix compares no any-hit
# rows (PERF.md, Open questions)
FAULTS = [(TINY_BOX, _k1_unchanged), (TINY_BOX, _k1_altered),
          (TINY_BOX, _k3_altered), (TINY_BOX, _film_unchanged),
          (TINY_BOX, _film_half), (TINY_BOX, _k2_half),
          (TINY_BOX, _camera_lanes_half),
          (TINY_CITY, _k1_unchanged),
          (TINY_CITY, _edges_altered), (TINY_CITY, _utd_altered),
          (TINY_CITY, _map_half), (TINY_CITY, _beams_half)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f.__name__.strip("_") for _, f in FAULTS])
def test_fault_is_not_correct(tiny_cells, monkeypatch, name, fault):
    which = fault(monkeypatch)
    _, checks = run(tiny_cells[name])
    got = numbers(checks)
    assert not harness.decide(checks), got
    assert got[which][0] > got[which][1], got


def test_no_card_no_result(tmp_path):
    # run.py refuses without a card (this sandbox has none): exit 2, no
    # result line
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "wtbench/run.py", "--workload",
                          "cornell_box_81k.wave", "--seed", "1",
                          "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_bare_checkout_fails(tmp_path):
    # a directory with only BENCHMARK.json and wtbench/ cannot run
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "wtbench", tmp_path / "wtbench")
    out = subprocess.run([sys.executable, "wtbench/run.py", "--workload",
                          "cornell_box_81k.wave", "--seed", "1",
                          "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
