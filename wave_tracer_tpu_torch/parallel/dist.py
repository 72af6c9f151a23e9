"""Distributed rendering: lanes split over the ranks of a process group.

Port of wave_tracer_tpu/parallel/dist.py. The JAX package shards the lane
dimension over a data-parallel mesh axis with shard_map and merges the
per-device partial films with a `psum`; here each rank of the
torch.distributed process group (one rank per device, parallel/launch.py)
traces its own slice of the lanes through the port's integrators, splats
them into a zero film and all-reduces (sums) value, weight and light
image, which every rank then adds to its film. The scene tables are
replicated: every rank builds them.

Every draw of the classical, wave and bdpt paths is keyed by (pixel,
sample), and forward transport's by (global lane id, sample), so the
number of ranks changes only the order of the film's sums.

The mode, FSD and eps come from the renderer's own decision
(render/renderer.py::render_mode), so a distributed render traces what
`Renderer` traces. (The JAX package's render_distributed decides apart
and renders a plt_bdpt scene without FSD by the classical path.)
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from wave_tracer_tpu_torch.integrator.path import trace_paths
from wave_tracer_tpu_torch.integrator.plt_bdpt import trace_bdpt
from wave_tracer_tpu_torch.integrator.plt_path import trace_paths_wave
from wave_tracer_tpu_torch.integrator.plt_path_forward import trace_forward
from wave_tracer_tpu_torch.parallel import launch as launch_mod
from wave_tracer_tpu_torch.render.renderer import film_channels, render_mode
from wave_tracer_tpu_torch.sampling import rng
from wave_tracer_tpu_torch.sensor import film as film_mod
from wave_tracer_tpu_torch.util.device import card


def _zero_like_film(film):
    return film_mod.Film(value=torch.zeros_like(film.value),
                         weight=torch.zeros_like(film.weight),
                         direct=torch.zeros_like(film.direct),
                         rfilter_sigma=film.rfilter_sigma, radius=film.radius)


def _merge(film, local):
    """Add the sum over the ranks of the partial films `local` to `film`
    (in place; the all-reduce takes the psum's place)."""
    for total, part in ((film.value, local.value),
                        (film.weight, local.weight),
                        (film.direct, local.direct)):
        if dist.is_initialized():
            dist.all_reduce(part)
        total += part
    return film


def sharded_render_step(sensor, max_depth: int, eps: float,
                        mis: bool = True):
    """The classical plt_path step: step(data, film, base_key, pxy,
    jitter, sids, live) traces this rank's lanes (`live` masks padding
    lanes), splats them and adds the merged partial films to `film`,
    which it returns."""

    def step(data, film, base_key, pxy, jitter, sids, live):
        pos, values, ok = trace_paths(data, pxy, jitter, base_key, sids,
                                      sensor=sensor, max_depth=max_depth,
                                      eps=eps, mis=mis)
        local = film_mod.splat(_zero_like_film(film), pos, values, ok & live)
        return _merge(film, local)
    return step


def sharded_wave_step(sensor, max_depth: int, eps: float, mis: bool = True,
                      fsd: bool = True):
    """The wave-transport plt_path step (trace_paths_wave), as
    `sharded_render_step`."""

    def step(data, film, base_key, pxy, jitter, sids, live):
        pos, values, ok = trace_paths_wave(
            data, pxy, jitter, base_key, sids, sensor=sensor,
            edge_table=data.edges, max_depth=max_depth, eps=eps, mis=mis,
            fsd=fsd)
        local = film_mod.splat(_zero_like_film(film), pos, values, ok & live)
        return _merge(film, local)
    return step


def sharded_forward_step(sensor, max_depth: int, eps: float,
                         fsd: bool = True, fsd_mode: str = "utd"):
    """Forward light tracing onto a virtual-plane sensor: step(data, film,
    base_key, lane_ids, sids, live); the crossings splat as Gaussian beams
    and the FSD-NEE connections as points into the light image."""

    def step(data, film, base_key, lane_ids, sids, live):
        pos, values, ok, sig, (nee_pos, nee_val, nee_ok) = trace_forward(
            data, lane_ids, base_key, sids, sensor=sensor,
            edge_table=data.edges, max_depth=max_depth, eps=eps, fsd=fsd,
            fsd_mode=fsd_mode)
        local = film_mod.splat_direct_gaussian(_zero_like_film(film), pos,
                                               sig, values, ok & live)
        rep = nee_ok.shape[0] // live.shape[0]
        film_mod.splat_direct(local, nee_pos, nee_val,
                              nee_ok & live.repeat_interleave(rep))
        return _merge(film, local)
    return step


def sharded_bdpt_step(sensor, max_depth: int, eps: float,
                      fsd: bool = True):
    """The bidirectional step: the camera strategies splat into the film,
    the t = 1 light-tracing splats into the light image."""

    def step(data, film, base_key, pxy, jitter, sids, live):
        pos, values, ok, (lt_pos, lt_val, lt_ok) = trace_bdpt(
            data, pxy, jitter, base_key, sids, sensor=sensor,
            max_depth=max_depth, eps=eps, fsd=fsd)
        local = film_mod.splat(_zero_like_film(film), pos, values, ok & live)
        rep = lt_ok.shape[0] // live.shape[0]
        film_mod.splat_direct(local, lt_pos, lt_val,
                              lt_ok & live.repeat_interleave(rep))
        return _merge(film, local)
    return step


def render_distributed(built, sensor_index: int = 0, spp: int | None = None,
                       lanes_per_device: int = 1 << 13, seed: int = 0,
                       progress=None, device=None):
    """The distributed render behind the CLI's `--distributed`.

    Every rank runs this after `launch.initialize_distributed()` (or
    alone, as a group of one). Global lane ids sweep the (pixel, sample)
    pairs in chunks of lanes_per_device·ranks (capped at the render,
    rounded up to a multiple of the ranks); each rank traces its
    contiguous slice of a chunk, on `device` (default: its
    `launch.local_device()`), padding lanes clamped to the chunk's first
    id and masked off. Every rank returns the merged image and the stats
    dict (image (H, W, C) numpy, stats), as `Renderer.render_sensor`."""
    rank, nproc = launch_mod.world()
    if device is None:
        device = launch_mod.local_device()
    device = card(device)
    if built.device != device:
        built = built.on(device)
    scene = built.scene
    sensor = scene.sensors[sensor_index]
    # the renderer's own decision (render/renderer.py::render_mode)
    mode, fsd_on, eps = render_mode(scene, sensor, built.data.edges.count)
    spp = spp or sensor.samples
    data = dataclasses.replace(
        built.data, spectral=built.spectral_per_sensor[sensor_index])
    cfg = scene.integrator
    W, H = sensor.width, sensor.height
    film = film_mod.make_film(W, H, film_channels(sensor),
                              sensor.rfilter_sigma, device=device)
    base_key = rng.make_base_key(seed)

    forward = mode == "forward"
    if forward:
        step = sharded_forward_step(
            sensor, cfg.max_depth, eps, fsd=fsd_on,
            fsd_mode="fraunhofer" if cfg.type == "plt_bdpt" else "utd")
    elif mode == "bdpt":
        step = sharded_bdpt_step(sensor, min(cfg.max_depth, 16), eps,
                                 fsd=fsd_on)
    elif mode == "wave":
        step = sharded_wave_step(sensor, cfg.max_depth, eps, mis=cfg.mis)
    else:
        step = sharded_render_step(sensor, cfg.max_depth, eps, mis=cfg.mis)

    total = W * H * spp
    chunk = min(lanes_per_device * nproc, -(-total // nproc) * nproc)
    per_rank = chunk // nproc
    t0 = time.perf_counter()
    done = 0
    for c0 in range(0, total, chunk):
        n_live = min(chunk, total - c0)
        lo = c0 + rank * per_rank
        gid = torch.arange(lo, lo + per_rank, dtype=torch.int64,
                           device=device)
        live = gid < c0 + n_live
        gid = torch.where(live, gid, c0)       # clamp padding lanes
        pix = gid % (W * H)
        sids = gid // (W * H)
        if forward:
            film = step(data, film, base_key, gid.to(torch.int32),
                        sids.to(torch.int32), live)
        else:
            pxy = torch.stack([pix % W, pix // W], dim=-1)
            jitter = rng.uniform(rng.sample_key(base_key, pix, sids),
                                 rng.D_PIXEL_JITTER, 2)
            film = step(data, film, base_key, pxy, jitter, sids, live)
        done += n_live
        if progress and launch_mod.is_main_process():
            progress(min(done // (W * H), spp), spp)
    direct_norm = {"bdpt": spp, "forward": done / float(W * H)}.get(mode,
                                                                   0.0)
    img = film_mod.develop(film, direct_norm).cpu().numpy()  # waits
    launch_mod.sync_hosts()
    dt = time.perf_counter() - t0
    stats = dict(seconds=dt, paths=done, paths_per_sec=done / max(dt, 1e-9),
                 mode=f"{mode}-dist", spp_done=spp, interrupted=False,
                 devices=nproc, processes=nproc)
    return img, stats
