"""Fixtures of the benchmark's own tests: a copy of the benchmark with a
throwaway tiny cell of each path, made from files alone."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_BOX = "tiny_box.wave_tiny"
TINY_CITY = "tiny_city.utd_tiny"
# the coverage mix (forward transport with the UTD carry), which no cell
# of BENCHMARK.json runs yet; its limits are these tests' own
UTD_TINY = dict(
    why="test", integrator="plt_path", fsd=True, resolution=16,
    samples_per_frame=2, max_depth=4, loop="closed", min_frames=3,
    trace_seconds=0.1,
    check=dict(rows=dict(k1=256, edges=256, utd=64), film="coverage",
               limits=dict(k1_bad=0.01, edges_bad=0.03, utd_bad=0.025,
                           film_gap=1e-4, work_gap=0)))


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def add_tiny_cells(root):
    """Copy the benchmark under `root` and add two cells by files and
    entries only: the box with a 320-triangle icosphere and the city of
    2 × 2 blocks (the coverage path, with its metrics), both at 16 × 16
    and 2 samples a frame."""
    bench = root / "wtbench"
    shutil.copytree(REPO / "wtbench", bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    box = json.loads((bench / "configs/cornell_box_81k.json").read_text())
    box.update(name="tiny_box", triangles=332)
    box["icosphere"]["subdivisions"] = 2
    city = json.loads((bench / "configs/city_10ghz.json").read_text())
    city["blocks"].update(count=2, heights=[[6.0, 9.0], [4.5, 11.0]])
    city.update(name="tiny_city", triangles=50)
    for name, cfg, src in (("tiny_box", box, "cornell_box_81k"),
                           ("tiny_city", city, "city_10ghz")):
        (bench / f"configs/{name}.json").write_text(json.dumps(cfg))
        shutil.copy(bench / f"configs/{src}.py", bench / f"configs/{name}.py")
    t = json.loads((bench / "traffic/wave.json").read_text())
    t.update(resolution=16, samples_per_frame=2, trace_seconds=0.1)
    (bench / "traffic/wave_tiny.json").write_text(json.dumps(t))
    (bench / "traffic/utd_tiny.json").write_text(json.dumps(UTD_TINY))
    (bench / "metrics/frames_done.py").write_text(
        "def read(ctx):\n    return float(ctx['frames'])\n")
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in ("tiny_box", "tiny_city"):
        b["configs"].append(dict(name=name, source="test",
                                 file=f"wtbench/configs/{name}.json",
                                 reduced=[], why="test"))
    for cell, cfg, mix in ((TINY_BOX, "tiny_box", "wave_tiny"),
                           (TINY_CITY, "tiny_city", "utd_tiny")):
        b["workloads"].append(dict(name=cell, config=cfg, traffic=mix,
                                   chips=1, why="test"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "cornell_box_81k.wave" in m.get("workloads", []):
            m["workloads"].append(TINY_BOX)
    # the coverage path's metrics, which no cell of BENCHMARK.json reports
    # yet: its rate, its launches, and K1's roofline split by the metric
    # it moves (read by wtbench/metrics/k1_roofline.py)
    cov = dict(source="device_trace", moves="coverage_beams_per_s",
               workloads=[TINY_CITY])
    b["end_to_end"].append(dict(name="coverage_beams_per_s", unit="beams/s",
                                better="higher", bound=0.1,
                                source="host_clock", workloads=[TINY_CITY]))
    b["per_layer"] += [
        dict(cov, name="launches_per_kbeam", unit="launches/kbeam",
             better="lower", layer="forward transport"),
        dict(cov, name="k1_roofline.coverage", unit="%", better="higher",
             layer="ray kernels")]
    b["per_layer"].append(dict(name="frames_done", unit="frames",
                               better="higher", source="host_clock",
                               layer="test", moves="setup_s",
                               workloads=[TINY_BOX, TINY_CITY]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return bench


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    add_tiny_cells(root)
    return root


@pytest.fixture(scope="session")
def tiny_cells(tiny_root):
    from wtbench import harness
    return {name: harness.load_cell(tiny_root, name, tiny_root / "wtbench")
            for name in (TINY_BOX, TINY_CITY)}
