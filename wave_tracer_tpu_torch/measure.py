"""Measurements of the port on one CUDA card.

    python -m wave_tracer_tpu_torch.measure pool      # wave pool widths
    python -m wave_tracer_tpu_torch.measure bdpt      # bdpt batch widths
    python -m wave_tracer_tpu_torch.measure profile   # torch.profiler split
    python -m wave_tracer_tpu_torch.measure cells     # every cell, in turn
    python -m wave_tracer_tpu_torch.measure launches  # launches per step
    python -m wave_tracer_tpu_torch.measure summarize A1.log,A2.log B1.log,B2.log

`bdpt` renders the bdpt box cell (plt_bdpt, fsd=True, 256×256, 4 spp,
max_depth 8) with batches of 2^16, 2^17 and 2^18 lanes, in two passes of
opposite order, printing paths/s. `pool` renders the wave box headline (plt_path,
fsd=True, 256×256, 8 spp, max_depth 8) at 2^16, 2^17 and 2^18 lanes, in
two passes of opposite order, and the box + icosphere at 4 spp once per
width, printing paths/s. `profile` runs torch.profiler over one render
of the wave box, the wave box + icosphere and the classical box +
icosphere (8 spp) at the default pool width and prints the device time
by op and kernel and the device's busy share of the wall time (and the
bdpt box cell's, the two coverage cells' and the two materials-box cells':
`make_materials_box_scene(256)` through the wave path at 8 spp and
through polarimetric plt_bdpt at 4 spp, depth 8), with each cell's CUDA
kernel launches per pool step (per K1 launch: the pool traces once a
step) or per bdpt batch. `launches` prints those counts alone for the
wave box, the classical box (16 spp), the bdpt box cell and the two
coverage cells (per forward batch there), from one profiled render each
after a warm-up, for an A/B of two trees. `cells` renders the wave box
headline, the classical box (fsd=False, 256×256, 16 spp, max_depth 8),
the classical box + icosphere (8 spp, as bench.py times it), the wave
box + icosphere (4 spp), the bdpt box cell and the two coverage cells
(`make_coverage_scene(256)`: 256×256 elements × 8 samples, depth 4,
plt_path with the UTD carry and plt_bdpt with the Fraunhofer forward
mode) at the default pool or batch width, in turn, CELL_READINGS times
each, printing every reading, for an A/B of two trees in one call (the
cells' readings move from one to the next). Every line starts with the
card's name and power limit. Needs a card: without one each mode exits
nonzero, except `summarize`, which reads the logs of `cells` runs, one
comma-separated group of files per argument (the parent's runs, then the
change's), and prints each cell's readings per group as median and
interquartile range, and each later group's median over the first's.
"""

from __future__ import annotations

import re
import subprocess
import sys
import time

import torch

WIDTHS = (1 << 16, 1 << 17, 1 << 18)
CELL_READINGS = 5


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi: n/a"


def wave_scene(res, spp, depth, icosphere=False, fsd=True,
               integrator="plt_path"):
    from wave_tracer_tpu_torch.scene.procedural import make_box_scene
    scene = make_box_scene(res=res, spp=spp, icosphere=icosphere)
    scene.integrator.type = integrator
    scene.integrator.fsd = fsd
    scene.integrator.max_depth = depth
    return scene


def bdpt_scene():
    """bench.py's bdpt cell: the box, plt_bdpt, FSD on, 256×256, 4 spp,
    max_depth 8."""
    return wave_scene(256, 4, 8, integrator="plt_bdpt")


BDPT_TAG = "bdpt box 256x256 4 spp depth 8"


def materials_cells():
    """The materials box at 256×256, depth 8: the wave path at 8 spp and
    polarimetric plt_bdpt at 4 spp."""
    from wave_tracer_tpu_torch.scene.procedural import \
        make_materials_box_scene
    out = []
    for integrator, spp, pol in (("plt_path", 8, False),
                                 ("plt_bdpt", 4, True)):
        scene = make_materials_box_scene(res=256, spp=spp)
        scene.integrator.type = integrator
        scene.integrator.max_depth = 8
        scene.sensors[0].polarimetric = pol
        out.append((f"materials box 256x256 {spp} spp depth 8 "
                    f"{'wave' if integrator == 'plt_path' else 'bdpt pol'}",
                    scene))
    return out


def coverage_cells():
    """The coverage map at 256×256 elements × 8 samples, depth 4, by
    plt_path (UTD FSD) and by plt_bdpt (Fraunhofer forward)."""
    from wave_tracer_tpu_torch.scene.procedural import make_coverage_scene
    out = []
    for integrator, mode in (("plt_path", "utd"), ("plt_bdpt", "fraunhofer")):
        scene = make_coverage_scene(256)
        scene.integrator.type = integrator
        out.append((f"coverage 256x256 8 spe depth 4 {integrator} ({mode})",
                    scene))
    return out


def bdpt():
    from wave_tracer_tpu_torch.render import render_scene
    from wave_tracer_tpu_torch.scene import build_scene
    card = card_line()
    box = build_scene(bdpt_scene(), device="cuda")
    render_scene(box, spp=1, device="cuda")                # warm-up
    for order in (WIDTHS, WIDTHS[::-1]):
        for lanes in order:
            _, st = render_scene(box, device="cuda", pool_lanes=lanes)
            torch.cuda.synchronize()
            print(f"{card} | {BDPT_TAG}, batch {lanes}: "
                  f"{st['paths_per_sec']:.1f} paths/s ({st['seconds']:.3f} s,"
                  f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                  f" GiB)", flush=True)
            torch.cuda.reset_peak_memory_stats()


def pool():
    from wave_tracer_tpu_torch.render import render_scene
    from wave_tracer_tpu_torch.scene import build_scene
    card = card_line()
    box = build_scene(wave_scene(256, 8, 8), device="cuda")
    big = build_scene(wave_scene(256, 4, 8, icosphere=True), device="cuda")
    render_scene(box, spp=1, device="cuda")                # warm-up
    for order in (WIDTHS, WIDTHS[::-1]):
        for lanes in order:
            _, st = render_scene(box, device="cuda", pool_lanes=lanes)
            print(f"{card} | wave box 256x256 8 spp depth 8, pool {lanes}: "
                  f"{st['paths_per_sec']:.1f} paths/s "
                  f"({st['seconds']:.3f} s)", flush=True)
    for lanes in WIDTHS:
        _, st = render_scene(big, device="cuda", pool_lanes=lanes)
        print(f"{card} | wave box+icosphere 256x256 4 spp depth 8, pool "
              f"{lanes}: {st['paths_per_sec']:.1f} paths/s "
              f"({st['seconds']:.3f} s)", flush=True)


def cells():
    from wave_tracer_tpu_torch.render import render_scene
    from wave_tracer_tpu_torch.scene import build_scene
    card = card_line()
    built = [(tag, build_scene(scene, device="cuda")) for tag, scene in [
        ("wave box 256x256 8 spp depth 8", wave_scene(256, 8, 8)),
        ("classical box 256x256 16 spp depth 8",
         wave_scene(256, 16, 8, fsd=False)),
        ("classical box+icosphere 256x256 8 spp depth 8",
         wave_scene(256, 8, 8, icosphere=True, fsd=False)),
        ("wave box+icosphere 256x256 4 spp depth 8",
         wave_scene(256, 4, 8, icosphere=True)),
        (BDPT_TAG, bdpt_scene())] + coverage_cells()]
    for _, b in built:
        render_scene(b, spp=1, device="cuda")              # warm-up
    for _ in range(CELL_READINGS):
        for tag, b in built:
            _, st = render_scene(b, device="cuda")
            print(f"{card} | {tag}: {st['paths_per_sec']:.1f} paths/s "
                  f"({st['seconds']:.3f} s)", flush=True)


def _self_dev_us(e):
    """Self device time (µs) of a profiler average, across torch versions."""
    t = getattr(e, "self_device_time_total", None)
    return t if t is not None else e.self_cuda_time_total


def _dev_us(e):
    t = getattr(e, "device_time_total", None)
    return t if t is not None else e.cuda_time_total


def _profiled_render(built):
    """One render of `built` under torch.profiler after a warm-up →
    (wall s, event averages, CUDA kernel averages, render stats, (CUDA
    kernel launches, launches per pool step, forward depth step or bdpt
    batch: over K1's launches, or over the batches, unit)))."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from wave_tracer_tpu_torch.accel import ray_kernels as rk
    from wave_tracer_tpu_torch.render import render_scene
    render_scene(built, spp=1, device="cuda")          # warm-up
    torch.cuda.synchronize()
    k1 = rk.LAUNCHES["closest"]
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, st = render_scene(built, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    launches = sum(e.count for e in kernels)
    if st["mode"] == "bdpt":
        per, unit = launches / -(-st["paths"] // st["pool_lanes"]), "batch"
    else:       # K1 traces once a pool step, or once a forward depth step
        per = launches / max(rk.LAUNCHES["closest"] - k1, 1)
        unit = "depth step" if st["mode"].startswith("forward") \
            else "pool step"
    return wall, events, kernels, st, (launches, per, unit)


def profile():
    from wave_tracer_tpu_torch.scene import build_scene
    card = card_line()
    for tag, scene in [("wave box 256x256 8 spp depth 8",
                        wave_scene(256, 8, 8)),
                       ("wave box+icosphere 256x256 4 spp depth 8",
                        wave_scene(256, 4, 8, icosphere=True)),
                       ("classical box+icosphere 256x256 8 spp depth 8",
                        wave_scene(256, 8, 8, icosphere=True, fsd=False)),
                       (BDPT_TAG, bdpt_scene())] + coverage_cells() \
            + materials_cells():
        built = build_scene(scene, device="cuda")
        wall, events, kernels, st, (n, per, unit) = _profiled_render(built)
        busy = sum(_self_dev_us(e) for e in kernels) / 1e3
        print(f"{card} | {tag}: wall {wall * 1e3:.1f} ms under the profiler,"
              f" device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%)"
              f", {st['paths_per_sec']:.1f} paths/s, {n} CUDA kernel "
              f"launches ({per:.1f} per {unit})", flush=True)
        top = sorted(kernels, key=lambda e: -_self_dev_us(e))[:15]
        for e in top:
            print(f"  {_self_dev_us(e) / 1e3:10.1f} ms "
                  f"{e.count:8d}x  {e.key[:90]}", flush=True)
        ops = sorted((e for e in events if e.device_type.name == "CPU"),
                     key=lambda e: -_dev_us(e))[:12]
        for e in ops:
            print(f"  op {_dev_us(e) / 1e3:10.1f} ms device, "
                  f"{e.cpu_time_total / 1e3:10.1f} ms cpu {e.count:8d}x  "
                  f"{e.key[:60]}", flush=True)


def launches():
    from wave_tracer_tpu_torch.scene import build_scene
    card = card_line()
    for tag, scene in [("wave box 256x256 8 spp depth 8",
                        wave_scene(256, 8, 8)),
                       ("classical box 256x256 16 spp depth 8",
                        wave_scene(256, 16, 8, fsd=False)),
                       (BDPT_TAG, bdpt_scene())] + coverage_cells():
        _, _, _, st, (n, per, unit) = _profiled_render(
            build_scene(scene, device="cuda"))
        print(f"{card} | {tag}: {n} CUDA kernel launches, {per:.1f} per "
              f"{unit} ({st['mode']})", flush=True)


def summarize(groups):
    import numpy as np
    readings = []
    for group in groups:
        cells = {}
        for path in group.split(","):
            with open(path) as f:
                for line in f:
                    m = re.match(r".* \| (.+): ([0-9.]+) paths/s", line)
                    if m:
                        cells.setdefault(m.group(1), []).append(
                            float(m.group(2)))
        readings.append(cells)
    for tag in readings[0]:
        base = float(np.median(readings[0][tag]))
        parts = []
        for i, cells in enumerate(readings):
            x = np.asarray(cells.get(tag, [np.nan]))
            q1, med, q3 = np.percentile(x, [25, 50, 75])
            parts.append(f"group {i}: n={x.size} median {med:.1f} IQR "
                         f"[{q1:.1f}, {q3:.1f}]"
                         + (f" ({med / base:.3f}x)" if i else ""))
        print(f"{tag}: " + "; ".join(parts), flush=True)


def main(argv):
    if argv and argv[0] == "summarize":
        summarize(argv[1:])
        return 0
    if not torch.cuda.is_available():
        print("measure: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    modes = dict(pool=pool, bdpt=bdpt, profile=profile, cells=cells,
                 launches=launches)
    if not argv or any(m not in modes for m in argv):
        print(f"measure: modes are {sorted(modes)}", file=sys.stderr)
        return 2
    for mode in argv:
        modes[mode]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
