"""Command line: `python -m wave_tracer_tpu_torch render scene.xml`.

Port of wave_tracer_tpu/cli.py: subcommands `render` and `version`;
options for the output directory, `-D` defines, `--mesh_scale`, the spp,
seed and lane overrides, `--ray-tracing`, statistics, masks, checkpoints
and resume, and a tev preview. Each sensor writes `<id>.exr` (linear
float32, XYZ developed to RGB for an RGB response; I/Q/U/V files besides
for a polarimetric sensor) and `<id>.png`. Unlike the JAX CLI's half
floats, float32 keeps the radiance of physically scaled scenes: half
floats flush values below 6e-8 (the box scenes render about 1e-8) to a
few steps or zero. Rendering runs on the card
(`--device cuda`, the default) unless `--device cpu` is asked for;
without a card it exits with an error instead of rendering on the CPU.

The first Ctrl-C finishes the chunk in flight, writes the completed work
and a resumable `<id>.ckpt.npz` (continue with `--resume`); a second one
aborts. `--ui [PORT]` serves the live web page of util/ui.py (pause,
resume, terminate, capture; Ctrl-C ends a paused render too).

`--distributed` renders with one process per device (parallel/): the same
command runs for every rank, with `--coordinator host:port
--num-processes N --process-id R` or under torchrun; every rank renders
its share of the lanes on its own device and only rank 0 logs and writes
the outputs, since every rank holds the same merged image. It takes no
`--resume`, `--checkpoint` or `--ui` (the JAX CLI ignores the first two
and promises a checkpoint it never writes): its ranks share every chunk,
so Ctrl-C aborts the render and nothing is written.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import numpy as np

from wave_tracer_tpu_torch import __version__

PROG = "wave_tracer_tpu_torch"


def parse_defines(pairs):
    """{name: value} from -D arguments, each `name=value[,name=value...]`."""
    out = {}
    for p in pairs or []:
        for item in p.split(","):
            if not item:
                continue
            if "=" not in item:
                raise SystemExit(f"bad define {item!r}; expected name=value")
            k, v = item.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def cmd_render(args):
    import torch

    from wave_tracer_tpu_torch.util.log import Logger, Verbosity

    if args.distributed and (args.resume or args.checkpoint):
        raise SystemExit(f"{PROG}: --resume and --checkpoint are refused "
                         "with --distributed: a distributed render writes "
                         "no checkpoint")
    if args.distributed and args.ui is not None:
        raise SystemExit(f"{PROG}: --ui is refused with --distributed: the "
                         "distributed render has no interrupt system")
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit(f"{PROG}: no CUDA device; pass --device cpu to "
                         "render on the CPU")
    device = args.device
    if args.distributed:
        # before any device use: one rank per device, the same command for
        # every rank (parallel/launch.py)
        from wave_tracer_tpu_torch.parallel import launch
        launch.initialize_distributed(args.coordinator, args.num_processes,
                                      args.process_id, device=args.device)
        device = str(launch.local_device(torch.device(args.device).type))
    main_rank = not args.distributed or launch.is_main_process()
    try:
        return _render(args, device, main_rank, Logger(
            Verbosity.NORMAL if main_rank else Verbosity.QUIET,
            prefix=f"[{PROG}] "))
    finally:
        if args.distributed:
            launch.shutdown()


def _render(args, device, main_rank, log):
    """Render every sensor of the scene file; with --distributed every
    rank renders and only rank 0 (main_rank) writes and logs."""
    from wave_tracer_tpu_torch.render import render_scene
    from wave_tracer_tpu_torch.render.checkpoint import (load_checkpoint,
                                                         save_checkpoint)
    from wave_tracer_tpu_torch.render.output import write_exr, write_png
    from wave_tracer_tpu_torch.accel.bvh import tree_depth
    from wave_tracer_tpu_torch.scene import build_scene
    from wave_tracer_tpu_torch.scene.xml import load_scene_xml
    from wave_tracer_tpu_torch.sensor.tonemap import Tonemap, srgb_encode

    t0 = time.time()
    scene = load_scene_xml(args.scene, parse_defines(args.define),
                           mesh_scale=args.mesh_scale)
    if args.ray_tracing:
        # classical ray tracing: no wave transport or FSD anywhere
        scene.integrator.ray_trace_only = True
    log(f"loaded '{os.path.basename(args.scene)}': {len(scene.shapes)} "
        f"shapes, {len(scene.emitters)} emitters, {len(scene.sensors)} "
        f"sensors")
    built = build_scene(scene, device=device)
    ntris = built.data.geo.num_tris
    # the BVH route's tree depth, as the JAX CLI prints it
    a = built.arrays
    depth = ""
    if "geo.node_left" in a:
        depth = tree_depth(a["geo.node_left"], a["geo.node_count"])
        depth = f", BVH depth {depth}"
    log(f"scene built: {ntris} triangles, {built.data.edges.count} edges"
        f"{depth} ({time.time() - t0:.1f}s)")

    outdir = args.output or "."
    if main_rank:
        os.makedirs(outdir, exist_ok=True)

    ui = None
    if args.ui is not None:
        # the live web frontend: pause / resume / terminate / capture go
        # through the same interrupt system as Ctrl-C
        from wave_tracer_tpu_torch.util.ui import RenderUI
        ui = RenderUI()
        log(f"live UI at http://127.0.0.1:{ui.serve(args.ui)}/")
        ui.set_scene_info(dict(
            scene=os.path.basename(args.scene), shapes=len(scene.shapes),
            emitters=len(scene.emitters),
            sensors=[s.id for s in scene.sensors], triangles=int(ntris),
            integrator=scene.integrator.type))

    # SIGINT → terminate after the chunk in flight (a UI pause too),
    # develop and write the completed work and a resumable checkpoint; a
    # second Ctrl-C aborts. A distributed render cannot stop part-way: its
    # ranks share every chunk, so Ctrl-C aborts it at once
    sigint = {"count": 0}
    prev_handler = signal.getsignal(signal.SIGINT)

    def on_sigint(signum, frame):
        sigint["count"] += 1
        if args.distributed:
            print(f"\n[{PROG}] interrupt: aborting the distributed render; "
                  "nothing is written and no checkpoint is kept", flush=True)
            signal.signal(signal.SIGINT, prev_handler)
            raise KeyboardInterrupt
        if sigint["count"] >= 2:
            signal.signal(signal.SIGINT, prev_handler)
            raise KeyboardInterrupt
        if ui is not None:
            ui.terminate()
        print(f"\n[{PROG}] interrupt: finishing current batch, writing "
              "completed work (Ctrl-C again to abort)", flush=True)

    def poll_interrupt():
        if sigint["count"]:
            return "terminate"
        return ui.interrupt() if ui is not None else None

    signal.signal(signal.SIGINT, on_sigint)
    stats_all = []
    try:
        for si, sensor in enumerate(scene.sensors):
            name = sensor.id or f"sensor{si}"
            base = os.path.join(outdir, name)
            spp = args.spp or sensor.samples
            resp = sensor.response
            M = resp.develop_matrix()
            meta = {"renderer": f"{PROG} {__version__}",
                    "scene": os.path.basename(args.scene),
                    "sensor": sensor.id, "spp": str(spp)}
            if ui is not None:
                ui.set_sensor(name)

            def progress(done, total):
                print(f"\r[{PROG}] sensor {si} ({sensor.id}): "
                      f"{done}/{total} spp", end="", flush=True)
                if ui is not None:
                    ui.progress(done, total)

            def on_capture(img, spp_done):
                # an intermediate image of the render in flight
                img = img[..., 0::4] \
                    if getattr(sensor, "polarimetric", False) else img
                rgb = img @ M.T if M is not None else img
                write_exr(base + "_capture.exr", rgb.astype(np.float32),
                          half=False, metadata=dict(meta, spp=str(spp_done)))
                if ui is not None:
                    ui.on_capture(rgb, spp_done)

            if args.distributed:
                from wave_tracer_tpu_torch.parallel.dist import \
                    render_distributed
                img, stats = render_distributed(
                    built, sensor_index=si, spp=spp, seed=args.seed,
                    progress=progress, device=device,
                    **({"lanes_per_device": args.batch_lanes}
                       if args.batch_lanes else {}))
                if main_rank:
                    print()
            else:
                init_film, spp_start = None, 0
                ckpt_path = base + ".ckpt.npz"
                if args.resume and os.path.isfile(ckpt_path):
                    init_film, spp_start, ck_seed, _ = load_checkpoint(
                        ckpt_path)
                    if ck_seed != args.seed:
                        log(f"checkpoint seed {ck_seed} != --seed "
                            f"{args.seed}; using checkpoint seed")
                        args.seed = ck_seed
                    log(f"resuming from {ckpt_path} ({spp_start}/{spp} spp "
                        f"done)")
                img, stats, rend = render_scene(
                    built, sensor_index=si, spp=spp, seed=args.seed,
                    device=device, pool_lanes=args.batch_lanes,
                    progress=progress, interrupt=poll_interrupt,
                    on_capture=on_capture, init_film=init_film,
                    spp_start=spp_start, return_renderer=True)
                print()
                if stats.get("interrupted") or args.checkpoint:
                    save_checkpoint(ckpt_path, rend.last_film,
                                    int(rend.last_spp_done), args.seed,
                                    sensor.id or "")
                if stats.get("interrupted"):
                    log(f"interrupted at {stats['spp_done']}/{spp} spp; "
                        f"checkpoint: {ckpt_path} (resume with --resume)")
            stats_all.append(stats)
            if not main_rank:
                continue

            if getattr(sensor, "polarimetric", False):
                # channels are (C response channels × 4 Stokes): the
                # I/Q/U/V set, then the intensity as the image
                st4 = img.reshape(img.shape[0], img.shape[1],
                                  resp.channels, 4)
                for ci, comp in enumerate("IQUV"):
                    plane = st4[..., ci]
                    if M is not None:
                        plane = plane @ M.T
                    write_exr(f"{base}_{comp}.exr",
                              plane.astype(np.float32), half=False,
                              metadata=meta)
                img = st4[..., 0]

            rgb = img @ M.T if M is not None else img
            write_exr(base + ".exr", rgb.astype(np.float32), half=False,
                      metadata=meta)
            tm = resp.tonemap or Tonemap(type="sRGB")
            if tm.type in ("linear", "sRGB", "gamma") and rgb.shape[-1] == 3:
                scale = 1.0 / max(np.percentile(rgb, 99.9), 1e-30)
                png = srgb_encode(np.clip(rgb * scale, 0, 1))
            else:
                png = tm.apply(rgb)
            write_png(base + ".png", png)

            if args.mask:
                from wave_tracer_tpu_torch.render.mask import render_mask
                write_png(base + "_mask.png", render_mask(built, sensor))
            if args.tev:
                from wave_tracer_tpu_torch.util.tev import TevPreview
                try:
                    pv = TevPreview(args.tev, name, rgb.shape[1],
                                    rgb.shape[0])
                    pv.update(np.clip(
                        rgb / max(np.percentile(rgb, 99.9), 1e-30), 0, 1))
                except OSError as e:
                    log(f"tev preview unavailable: {e}")
            log(f"wrote {base}.exr / .png  ({stats['paths']} paths, "
                f"{stats['paths_per_sec']:.0f} paths/s)")
    finally:
        signal.signal(signal.SIGINT, prev_handler)
        if ui is not None:
            ui.shutdown()
    if args.write_stats and main_rank:
        with open(os.path.join(outdir, "perf_stats.json"), "w") as f:
            json.dump(stats_all, f, indent=2)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog=PROG,
        description="wave-optical path tracer on PyTorch and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("version", help="print version")

    rp = sub.add_parser("render", help="render a scene XML")
    rp.add_argument("scene")
    rp.add_argument("-o", "--output", help="output directory")
    rp.add_argument("-D", "--define", action="append",
                    help="scene define name=value[,name=value...]")
    rp.add_argument("--spp", type=int, help="override samples per pixel")
    rp.add_argument("--mesh_scale", type=float, default=1.0)
    rp.add_argument("--batch_lanes", type=int, default=None,
                    help="lanes per launch (the pool or batch width; "
                         "default: the renderer's for the device)")
    rp.add_argument("--seed", type=int, default=0)
    rp.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; cpu "
                         "must be asked for)")
    rp.add_argument("--write-stats", action="store_true",
                    help="write perf_stats.json into the output directory")
    rp.add_argument("--mask", action="store_true",
                    help="also write sensor-visibility alpha masks")
    rp.add_argument("--tev", help="tev viewer host:port for live preview")
    rp.add_argument("--checkpoint", action="store_true",
                    help="write a resume checkpoint next to outputs")
    rp.add_argument("--resume", action="store_true",
                    help="resume from a sensor checkpoint in the output "
                         "dir (written on interrupt or --checkpoint)")
    rp.add_argument("--ui", type=int, nargs="?", const=0, default=None,
                    metavar="PORT",
                    help="serve the live web UI on this port (no value: "
                         "any free port)")
    rp.add_argument("--distributed", action="store_true",
                    help="multi-process render, one rank per device; run "
                         "the same command for every rank (or torchrun); "
                         "rank 0 writes the outputs")
    rp.add_argument("--coordinator", default=None,
                    help="rendezvous host:port, or an init URL; without "
                         "it torchrun's environment (env://)")
    rp.add_argument("--num-processes", type=int, default=None)
    rp.add_argument("--process-id", type=int, default=None)
    rp.add_argument("--ray-tracing", action="store_true",
                    help="force classical ray tracing (disable wave "
                         "transport / FSD)")

    args = ap.parse_args(argv)
    if args.cmd == "version":
        print(f"{PROG} {__version__}")
        return 0
    if args.cmd == "render":
        return cmd_render(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
