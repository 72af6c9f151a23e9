"""One run of one benchmark cell: set-up, the measured window of whole
frames, the comparison with the plain reference, the metrics.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in BENCHMARK.json:
  wtbench/configs/<config>.json   its numbers, source, assumed, reduced;
  wtbench/configs/<config>.py     `parts(cfg)`, its frozen geometry, and
                                  `scene(cfg, traffic)`, the program's
                                  Scene of it;
  wtbench/traffic/<traffic>.json  integrator, FSD, resolution, samples a
                                  frame, depth, the checks and limits;
  wtbench/metrics/<metric>.py     `read(ctx)`, the metric's value or None;
                                  a quantity split by the end-to-end
                                  metric it moves (<stem>.<part>) is read
                                  by wtbench/metrics/<stem>.py unless a
                                  file of its own is there.
A frame is one render of the whole sensor (an image or a coverage map);
frames run back to back, each with a sample seed made from --seed and
its index, until the window has lasted --seconds and at least
`min_frames` frames are done; the window ends with the frame that ends
it.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wave_tracer_tpu")


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    builder: object
    traffic: dict
    end_to_end: list
    per_layer: list
    readers: dict = field(default_factory=dict)


def load_cell(root, workload, bench_dir=HERE):
    """The cell `workload` of root/BENCHMARK.json with its files under
    bench_dir (the benchmark's folder)."""
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if workload not in work:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = work[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((Path(root) / conf["file"]).read_text())
    builder = load_module(bench_dir / "configs" / f"{w['config']}.py",
                          f"wtbench_config_{w['config']}")
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    layer = [m for m in bench["per_layer"] if mine(m)]
    readers = {m["name"]: load_module(reader_file(bench_dir, m["name"]),
                                      f"wtbench_metric_{i}")
               for i, m in enumerate(e2e + layer)}
    return Cell(workload, cfg, builder, traffic, e2e, layer, readers)


def reader_file(bench_dir, name):
    """metrics/<name>.py, else metrics/<stem>.py for a split <stem>.<part>."""
    own = Path(bench_dir) / "metrics" / f"{name}.py"
    if own.exists():
        return own
    return Path(bench_dir) / "metrics" / f"{name.split('.')[0]}.py"


def frame_seed(seed, index):
    """The program's sample seed of frame `index` of a run (index −1: the
    warm-up frame), 32 bits drawn from (seed, index)."""
    h = hashlib.sha256(f"{int(seed)}/{int(index)}".encode()).digest()
    return int.from_bytes(h[:4], "little")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _parts(cell):
    return [p[0] if isinstance(p, tuple) else p
            for p in cell.builder.parts(cell.config)]


class Program:
    """The program under test, set up for one cell: its scene baked on
    `device` and one warm frame rendered at the cell's own shapes."""

    def __init__(self, cell, device):
        import torch
        from wave_tracer_tpu_torch.scene.build import build_scene

        self.cell, self.device = cell, device
        self.cuda = device == "cuda"
        tr = cell.traffic
        self.spp = tr["samples_per_frame"]
        self.work = tr["resolution"] ** 2 * self.spp
        scene = cell.builder.scene(cell.config, tr)
        t0 = time.perf_counter()
        self.built = build_scene(scene, device=device)
        self.sync()
        self.bake_s = time.perf_counter() - t0
        self.torch = torch

    def sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def frame(self, seed, index):
        """One whole frame (image or map) → the developed image (numpy;
        returned once the card is done)."""
        from wave_tracer_tpu_torch.render import render_scene
        return render_scene(self.built, spp=self.spp,
                            seed=frame_seed(seed, index),
                            device=self.device)[0]

    def free(self):
        """Drop the program's state before the reference runs."""
        self.built = None
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


@dataclass
class Window:
    frames: int
    seconds: float
    failed: int
    checked: int
    image: object
    recorder: object
    profile: object = None
    frame_s: list = field(default_factory=list)


def window(prog, seed, seconds, trace=False, min_frames=None):
    """Frames back to back, the seed's checked frame recorded, until
    `seconds` have passed and `min_frames` frames are done."""
    from wtbench import trace as trace_mod
    from wtbench.record import Recorder

    tr = prog.cell.traffic
    chk = tr["check"]
    min_frames = tr["min_frames"] if min_frames is None else min_frames
    checked = random.Random(int(seed)).randrange(tr["min_frames"])
    rec = Recorder(chk["rows"], seed, prog.device, chk["rows"],
                   count_calls=bool(trace))
    rec.install()
    frames = failed = 0
    image = prof = None
    ends = []
    try:
        if trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if prog.cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
            span = record_function(trace_mod.WINDOW)
            span.__enter__()
        w0 = time.perf_counter()
        while True:
            rec.checking = rec.film = frames == checked
            img = prog.frame(seed, frames)
            if frames == checked:
                image = img
            failed += int(not np.isfinite(img).all())
            frames += 1
            elapsed = time.perf_counter() - w0
            ends.append(elapsed)
            if elapsed >= seconds and frames >= max(min_frames, checked + 1):
                break
        if trace:
            span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
    finally:
        rec.uninstall()
    return Window(frames, elapsed, failed, checked, image, rec, prof,
                  [b - a for a, b in zip([0.0] + ends, ends)])


def judge(cell, win, device, control=False):
    """{check name: number} of the window's recorded frame against the
    plain reference (with `control`, of the reference in TF32 in the
    program's place)."""
    from wtbench import check
    from wtbench.geometry import triangles

    geo = check.Geometry(triangles(_parts(cell)), device)
    s = _on(win.recorder.samples, device)
    numbers = {}
    for name, kind, fn in (("k1_bad", "k1", check.k1),
                           ("k2_bad", "k2", check.k2),
                           ("k3_bad", "k3", check.k3),
                           ("edges_bad", "edges", check.edge_sweep)):
        if s[kind]:
            numbers[name] = fn(s[kind], geo, control)
    if s["utd"]:
        numbers["utd_bad"] = check.utd_sums(s["utd"], k0(cell), control)
    img, sp = win.image, _on(win.recorder.splats, device)
    spp = cell.traffic["samples_per_frame"]
    if cell.traffic["check"]["film"] == "camera":
        numbers["film_gap"] = check.camera_film(
            sp["camera"], img, img.shape, camera_sigma(cell), control)
        numbers["work_gap"] = check.camera_work(sp["camera"], img.shape, spp)
    else:
        numbers["film_gap"] = check.coverage_film(
            sp["beam"], sp["point"], img, img.shape, spp, control)
        numbers["work_gap"] = check.coverage_work(sp["beam"], img.shape, spp)
    return {k: (v[0] / max(v[1], 1) if isinstance(v, tuple) else v)
            for k, v in numbers.items()}


def _on(kept, device):
    """The recorder's host copies, back on `device` for the reference."""
    import torch

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, (tuple, list)):
            return type(x)(move(v) for v in x)
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        return x
    return move(kept)


def run(cell, seed, seconds, trace, device, t_start):
    """One run → (result dict without its `checks`, [(name, value,
    limit)]). `device` "cuda" on the card; "cpu" only where a test drives
    the rest of a run without one."""
    import torch

    from wtbench import trace as trace_mod

    prog = Program(cell, device)
    prog.frame(seed, -1)
    prog.sync()
    setup_s = time.perf_counter() - t_start
    tr = cell.traffic
    budget = min(seconds, tr["trace_seconds"]) if trace else seconds
    win = window(prog, seed, budget, trace)
    peak = torch.cuda.max_memory_allocated() if prog.cuda else 0
    prog.free()
    numbers = judge(cell, win, device)
    checks = [(name, numbers.get(name), limit)
              for name, limit in tr["check"]["limits"].items()]

    ctx = dict(setup_s=setup_s, bake_s=prog.bake_s, window_s=win.seconds,
               frames=win.frames, work_per_frame=prog.work,
               memory_peak_bytes=peak, calls=win.recorder.calls)
    dev_info = dict(platform="gpu" if prog.cuda else "cpu",
                    kind=torch.cuda.get_device_name(0) if prog.cuda
                    else "cpu", count=1, memory_peak_bytes=int(peak))
    result = dict(attempted=win.frames, failed=win.failed, device=dev_info,
                  frame_s=win.frame_s)
    if trace:
        summary = trace_mod.reduce(win.profile)
        ctx["trace"] = summary
        dev_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = dict(device_ops=summary["device_ops"],
                                   idle_gaps=summary["idle_gaps"])
        wanted = cell.per_layer
    else:
        wanted = cell.end_to_end
    metrics = {}
    for m in wanted:
        v = cell.readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    result["metrics"] = metrics
    return result, checks


def decide(checks):
    """`correct`: every number compared is at or under its limit."""
    return all(v is not None and v <= limit for _, v, limit in checks)


def line(result, checks):
    """The result line: correct, attempted, failed, metrics, device,
    breakdown (traced runs) and, last, each number compared with its
    limit."""
    out = dict(correct=decide(checks), attempted=result["attempted"],
               failed=result["failed"], metrics=result["metrics"],
               device=result["device"])
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["checks"] = {name: dict(value=v, limit=limit)
                     for name, v, limit in checks}
    return out


def k0(cell):
    return cell.builder.wavenumber(cell.config)


def camera_sigma(cell):
    return float(cell.config["camera"]["rfilter_sigma"])
