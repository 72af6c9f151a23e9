"""Render orchestration: backward rendering of a perspective sensor, forward
rendering of a virtual-plane coverage sensor.

Port of wave_tracer_tpu/render/renderer.py. For a perspective sensor
(RGB or polarimetric, whose film holds I/Q/U/V per channel) the
integrator `plt_path` — with free-space diffraction on (the wave bounce,
when the scene has wedge edges) or off (the classical bounce), or in
ray-trace-only mode — runs through the compacted pool
(`Renderer._render_backward_compact` of the JAX package), or, with
`compact=False`, through the batched renderer (`Renderer._render_backward`):
lanes are pixel batch × spp batch, each batch one `trace_paths_wave` or
`trace_paths` call of max_depth bounces over fixed lanes whose values
splat into the film. `plt_bdpt` always runs the batched renderer, each
batch one `trace_bdpt` call whose camera values splat into the film and
whose light-tracing values splat into its light image, developed by the
samples per pixel. A virtual-plane sensor renders by forward light
tracing (`Renderer._render_forward` of the JAX package), whatever the
integrator: batches of `pool_lanes` lanes, lane ids 0..n−1 and sample id
= the batch index, each batch one `trace_forward` call (UTD FSD under
plt_path, Fraunhofer under plt_bdpt) whose crossings and FSD-NEE
connections splat into the light image, developed by the samples per
element. Other sensors raise NotImplementedError.

The interrupt system of the JAX renderer: `interrupt`, a callable polled
between chunks, returns None, "terminate" (stop after the chunk and
develop the completed work) or "capture" (develop mid-render and pass the
image and the samples done to `on_capture`). Only with an interrupt is
the render cut into chunks (the pool and the batched renderer: ⌈spp/8⌉
samples per pixel a chunk; forward rendering polls after each batch);
without one each path runs as one chunk. `last_film` and `last_spp_done`
keep the raw film and the samples done, and `init_film` with `spp_start`
continue a render from them (render/checkpoint.py): every path's streams
are keyed by (pixel, sample), so the remaining samples are the same.

The JAX package's two switches of its compacted render: WT_COMPACT_MODE
picks its single-dispatch `while` driver or its host-stepped one, which
it holds to the same film. The port has one driver, a host loop that
polls the pool's live lanes each step (the counterpart of `stepped`), so
both values select it and no result depends on the value.
WT_COMPACT_LANES (read at each render) takes the default's place, as in
the JAX renderer: min(pool_lanes or COMPACT_LANES_MAX, WT_COMPACT_LANES),
so it can raise the pool above the default as well as lower it; a value
below 1 raises. Unset, the default stays the port's own (POOL_LANES_*),
not the JAX package's 8k or 16k lanes of its drivers. Both apply to the
compacted render only.

Each `render_sensor` call is the span `wt.frame` (util/stats.py). The
stats of a pool render add `pool_steps`, `pool_lane_slots` (the pool's
width summed over its steps) and `pool_occupancy`, rays_cast over
pool_lane_slots: the share of the pool's lane slots that held a live lane
at a bounce.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from wave_tracer_tpu_torch.integrator import path as path_mod
from wave_tracer_tpu_torch.integrator.path_compact import render_pool
from wave_tracer_tpu_torch.integrator.plt_bdpt import trace_bdpt
from wave_tracer_tpu_torch.integrator.plt_path import trace_paths_wave
from wave_tracer_tpu_torch.integrator.plt_path_forward import trace_forward
from wave_tracer_tpu_torch.sampling import rng
from wave_tracer_tpu_torch.sensor import film as film_mod
from wave_tracer_tpu_torch.sensor.perspective import PerspectiveSensor
from wave_tracer_tpu_torch.sensor.virtual_plane import VirtualPlaneSensor
from wave_tracer_tpu_torch.util import stats as stats_mod
from wave_tracer_tpu_torch.util.device import card

# default lane-pool sizes. On the card a pool step costs a few thousand
# small torch launches whatever its width (most of them the int64 Sobol
# hashing), so wider pools amortize them (box,
# 256² × 16 spp on one H100: 0.49-0.57M paths/s at 2^16 lanes, 1.60-1.66M
# at 2^18), while at 82k triangles K1/K2 dominate and 2^16 ≈ 2^18. The
# wave box headline (256² × 8 spp) runs 2.1-2.7× faster at 2^18 than at
# 2^16; its 82k-triangle case runs 1.5× faster at 2^16, where fewer dead
# tail lanes go through K2/K3, and the headline decides. On the CPU the
# JAX package's own pool size. A pool never exceeds the number of paths:
# the kernels would trace the idle lanes too.
POOL_LANES_CUDA = 1 << 18
POOL_LANES_CPU = 1 << 13
# the ceiling on WT_COMPACT_LANES without pool_lanes: the JAX renderer's
# default batch_lanes, which bounds the variable there
COMPACT_LANES_MAX = 1 << 17
# default lanes per bdpt batch. A lane holds two stored subpaths of up to
# max_depth vertices, each with its Fraunhofer aperture slots (about 15 KB
# at depth 8); every draw is keyed by (pixel, sample), so the batch width
# changes no pixel. On the CPU the JAX package's test-sized batches. The
# forward renderer takes the same widths: there a draw is keyed by (lane,
# batch), so the width does change the image, as in the JAX package.
BDPT_LANES_CUDA = 1 << 18
BDPT_LANES_CPU = 1 << 12
# the JAX renderer's ceiling on the edge count for FSD. Above 2048 edges
# the integrators take the clustered edge sweep (accel/edges.py::
# edges_in_cone), as the JAX integrators do
MAX_FSD_EDGES = 1 << 20

def render_mode(scene, sensor, n_edges):
    """(mode, fsd_on, eps) as the JAX renderer decides them, for this
    renderer and parallel/dist.py alike: mode "forward" for a
    virtual-plane sensor, else "bdpt" (plt_bdpt, not ray-trace-only),
    "wave" (FSD on) or "ray"; FSD needs wedge edges, 1 to MAX_FSD_EDGES of
    them, so a scene without any renders classically; eps the rays'
    offset, 1e-4 of the world radius."""
    cfg = scene.integrator
    eps = 1e-4 * scene.world_radius()
    edges_ok = 0 < n_edges <= MAX_FSD_EDGES
    if isinstance(sensor, VirtualPlaneSensor):
        return "forward", bool(cfg.fsd and edges_ok), eps
    if not isinstance(sensor, PerspectiveSensor):
        raise NotImplementedError(
            f"{type(sensor).__name__} sensors are not ported yet")
    trace_only = sensor.ray_trace_only or cfg.ray_trace_only
    if cfg.type not in ("plt_path", "plt_bdpt") and not trace_only:
        raise NotImplementedError(f"{cfg.type} is not ported yet")
    fsd_on = bool(cfg.fsd and not trace_only and edges_ok)
    if cfg.type == "plt_bdpt" and not trace_only:
        return "bdpt", fsd_on, eps
    return ("wave" if fsd_on else "ray"), fsd_on, eps


def pool_width(pool_lanes, device):
    """The compacted render's pool width: pool_lanes or POOL_LANES_* for
    the device, or, under WT_COMPACT_LANES, min(pool_lanes or
    COMPACT_LANES_MAX, WT_COMPACT_LANES) as the JAX renderer computes it
    (the variable replaces the default). A value below 1 raises."""
    cap = os.environ.get("WT_COMPACT_LANES")
    if not cap:
        return pool_lanes or (POOL_LANES_CUDA if device.type == "cuda"
                              else POOL_LANES_CPU)
    if int(cap) < 1:
        raise ValueError(f"WT_COMPACT_LANES={cap}: the pool needs at least "
                         "one lane")
    return min(pool_lanes or COMPACT_LANES_MAX, int(cap))


_COUNTER_NAMES = {
    "rays_cast": path_mod.STAT_RAYS, "shadow_rays": path_mod.STAT_SHADOW,
    "surface_interactions": path_mod.STAT_SURFACE,
    "fsd_interactions": path_mod.STAT_FSD,
    "null_interactions": path_mod.STAT_NULL,
    "rr_terminations": path_mod.STAT_RR_KILL,
    "sum_path_depth": path_mod.STAT_DEPTH_SUM,
    "edge_sweep_hits": path_mod.STAT_EDGE_HIT,
    "ballistic_traversals": path_mod.STAT_BALLISTIC,
    "diffusive_traversals": path_mod.STAT_DIFFUSIVE,
    "ray_tri_tests": path_mod.STAT_TRI_TESTS,
    "cone_tri_tests": path_mod.STAT_CONE_TESTS,
}


@dataclasses.dataclass
class Renderer:
    built: object                  # scene.build.BuiltScene
    seed: int = 0
    device: str = "cuda"           # never falls back to the CPU by itself
    # lanes per launch: the pool width of plt_path, the batch width of
    # plt_bdpt, of the batched plt_path and of forward rendering. None:
    # POOL_LANES_* / BDPT_LANES_* for the device
    pool_lanes: int | None = None
    # plt_path through the compacted pool (True) or the batched renderer
    # over trace_paths / trace_paths_wave (False), as in the JAX package
    compact: bool = True
    # interrupt system: a callable polled between chunks returning None,
    # "terminate" or "capture"; on "capture", on_capture(img, spp_done)
    # gets the developed intermediate image
    interrupt: object = None
    on_capture: object = None
    # after render_sensor: the raw film and the samples per pixel done,
    # for checkpoint and resume
    last_film: object = None
    last_spp_done: float = 0

    def render_sensor(self, sensor_index: int = 0, spp: int | None = None,
                      progress=None, init_film=None, spp_start: int = 0):
        with stats_mod.span("wt.frame"):
            built = self.built
            device = card(self.device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            if built.device != device:
                built = built.on(device)
            scene = built.scene
            sensor = scene.sensors[sensor_index]
            mode, fsd_on, eps = render_mode(scene, sensor,
                                            built.data.edges.count)
            cfg = scene.integrator
            spp = spp or sensor.samples
            data = dataclasses.replace(
                built.data, spectral=built.spectral_per_sensor[sensor_index])
            film = _start_film(sensor, init_film, device)
            if mode == "forward":
                return self._render_forward(data, sensor, spp, film, cfg,
                                            eps, fsd_on, device, progress,
                                            spp_start)
            if mode == "bdpt" or not self.compact:
                return self._render_batched(data, sensor, spp, film, cfg, eps,
                                            fsd_on, device, mode, progress,
                                            spp_start)
            npix = sensor.width * sensor.height
            # chunk by spp only for interrupt granularity
            spp_chunk = max(1, -(-spp // 8)) if self.interrupt else spp
            width = pool_width(self.pool_lanes, device)
            base_key = rng.make_base_key(self.seed)
            stats = None
            lanes = paths = 0
            steps = stats_mod.registry.counter("pool/steps")
            lane_slots = stats_mod.registry.counter("pool/lane_slots")
            steps0, slots0 = steps.value, lane_slots.value
            spp_done = spp_start
            t0 = time.perf_counter()
            for s0 in range(spp_start, spp, spp_chunk):
                s1 = min(s0 + spp_chunk, spp)
                n = min((s1 - s0) * npix, width)
                film, st = render_pool(
                    data, film, base_key, (s0 * npix, s1 * npix), n,
                    sensor=sensor, max_depth=cfg.max_depth, eps=eps,
                    mis=cfg.mis, wave=fsd_on)
                # one chunk (no interrupt) adds no launch to the pool's own
                stats = st if stats is None else stats + st
                lanes = max(lanes, n)
                paths += (s1 - s0) * npix
                spp_done = s1
                if progress:
                    progress(s1, spp)
                if self._poll_interrupt(film, spp_done, 0.0):
                    break
            self.last_film, self.last_spp_done = film, spp_done
            # waits for the device
            img = film_mod.develop(film).cpu().numpy()
            dt = time.perf_counter() - t0
            if stats is None:                    # resumed with nothing left
                stats = torch.zeros((path_mod.N_STATS,), device=device)
            out = _stats(dt, paths, "wave-compact" if fsd_on
                         else "ray-compact", spp_done, spp, lanes, stats)
            slots = lane_slots.value - slots0
            out.update(pool_steps=steps.value - steps0, pool_lane_slots=slots,
                       pool_occupancy=out["device_counters"]["rays_cast"]
                       / max(slots, 1))
            return img, out

    def _poll_interrupt(self, film, spp_done, direct_norm):
        """True when the render should stop. direct_norm normalizes the
        light image of a capture (0: no light image in this mode)."""
        if self.interrupt is None:
            return False
        action = self.interrupt()
        if action == "capture" and self.on_capture is not None:
            self.on_capture(film_mod.develop(film, direct_norm).cpu().numpy(),
                            spp_done)
            return False
        return action == "terminate"

    def _render_batched(self, data, sensor, spp, film, cfg, eps, fsd,
                        device, mode, progress=None, spp_start=0):
        """The batched renderer: every (pixel, sample) pair once, in
        batches of about `pool_lanes` lanes laid out pixel batch × spp
        batch (pixel-major), with no padding lanes. mode "bdpt" traces
        each batch with `trace_bdpt`, "wave" with `trace_paths_wave`, "ray"
        with `trace_paths`."""
        W, H = sensor.width, sensor.height
        npix = W * H
        lanes = self.pool_lanes or (
            BDPT_LANES_CUDA if device.type == "cuda" else BDPT_LANES_CPU)
        pix_per_batch = min(max(lanes // max(spp, 1), 1), npix)
        spp_per_batch = min(max(lanes // pix_per_batch, 1), spp)
        if self.interrupt is not None:
            # interrupt-responsive chunking: ≥ ~8 poll points per render
            spp_per_batch = min(spp_per_batch, max(1, -(-spp // 8)))
            pix_per_batch = min(max(lanes // spp_per_batch, 1), npix)
        base_key = rng.make_base_key(self.seed)
        stats = torch.zeros((path_mod.N_STATS,), dtype=torch.float32,
                            device=device)
        spp_done = spp_start
        t0 = time.perf_counter()
        for s0 in range(spp_start, spp, spp_per_batch):
            sids = torch.arange(s0, min(s0 + spp_per_batch, spp),
                                device=device)
            for p0 in range(0, npix, pix_per_batch):
                pix = torch.arange(p0, min(p0 + pix_per_batch, npix),
                                   device=device)
                pid = pix[:, None].expand(-1, sids.shape[0]).reshape(-1)
                sid = sids[None, :].expand(pix.shape[0], -1).reshape(-1)
                pxy = torch.stack([pid % W, pid // W], dim=-1)
                jitter = rng.uniform(rng.sample_key(base_key, pid, sid),
                                     rng.D_PIXEL_JITTER, 2)
                args = (data, pxy, jitter, base_key, sid)
                if mode == "bdpt":
                    pos, values, ok, (lt_pos, lt_val, lt_ok), st = \
                        trace_bdpt(*args, sensor=sensor,
                                   max_depth=min(cfg.max_depth, 16),
                                   eps=eps, fsd=fsd, with_stats=True)
                    film_mod.splat_direct(film, lt_pos, lt_val, lt_ok)
                elif mode == "wave":
                    pos, values, ok, st = trace_paths_wave(
                        *args, sensor=sensor, edge_table=data.edges,
                        max_depth=cfg.max_depth, eps=eps, mis=cfg.mis,
                        with_stats=True)
                else:
                    pos, values, ok, st = path_mod.trace_paths(
                        *args, sensor=sensor, max_depth=cfg.max_depth,
                        eps=eps, mis=cfg.mis, with_stats=True)
                film_mod.splat(film, pos, values, ok)
                stats += st
            spp_done = s0 + sids.shape[0]
            if progress:
                progress(spp_done, spp)
            # bdpt's light-tracing splats are normalized per pixel sample
            if self._poll_interrupt(film, spp_done,
                                    spp_done if mode == "bdpt" else 0.0):
                break
        self.last_film, self.last_spp_done = film, spp_done
        img = film_mod.develop(film, spp_done if mode == "bdpt" else 0.0
                               ).cpu().numpy()   # waits for the device
        dt = time.perf_counter() - t0
        return img, _stats(dt, npix * (spp_done - spp_start), mode,
                           spp_done, spp, pix_per_batch * spp_per_batch,
                           stats)

    def _render_forward(self, data, sensor, spp, film, cfg, eps, wave,
                        device, progress=None, spp_start=0):
        """Forward light tracing onto a virtual-plane sensor: spp·W·H
        paths in batches of `pool_lanes` lanes (lane ids 0..n−1, sample
        id the batch index, as the JAX package's forward kernel draws
        them; its lanes past the end, masked off there, are not traced
        here). Crossings splat as Gaussian beams and FSD-NEE connections
        as points into the light image, developed by the samples per
        element. A resumed render starts at batch ⌈done/lanes⌉."""
        W, H = sensor.width, sensor.height
        fsd_mode = "fraunhofer" if cfg.type == "plt_bdpt" else "utd"
        lanes = self.pool_lanes or (
            BDPT_LANES_CUDA if device.type == "cuda" else BDPT_LANES_CPU)
        base_key = rng.make_base_key(self.seed)
        total = spp * W * H
        done = start = int(spp_start * W * H)
        batch = -(-done // lanes)
        t0 = time.perf_counter()
        while done < total:
            n = min(lanes, total - done)
            ids = torch.arange(n, dtype=torch.int32, device=device)
            pos, values, ok, sig, (nee_pos, nee_val, nee_ok) = trace_forward(
                data, ids, base_key, torch.full_like(ids, batch),
                sensor=sensor, edge_table=data.edges,
                max_depth=cfg.max_depth, eps=eps, fsd=wave,
                fsd_mode=fsd_mode)
            film_mod.splat_direct_gaussian(film, pos, sig, values, ok)
            film_mod.splat_direct(film, nee_pos, nee_val, nee_ok)
            done += n
            batch += 1
            if progress:
                progress(done, total)
            spe_now = done / float(W * H)
            if self._poll_interrupt(film, spe_now, spe_now):
                break
        spe = done / float(W * H)
        self.last_film, self.last_spp_done = film, spe
        img = film_mod.develop(film, spe).cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
        return img, dict(seconds=dt, paths=done - start,
                         paths_per_sec=(done - start) / max(dt, 1e-9),
                         mode="forward-wave" if wave else "forward",
                         spp_done=spe, interrupted=done < total,
                         pool_lanes=lanes, batches=batch)


def film_channels(sensor):
    """A polarimetric sensor's film holds I/Q/U/V per response channel."""
    return sensor.response.channels \
        * (4 if getattr(sensor, "polarimetric", False) else 1)


def _start_film(sensor, init_film, device):
    """A fresh film for `sensor` on `device`, or a copy of `init_film` (a
    resumed render; the splats then add to the copy)."""
    if init_film is None:
        return film_mod.make_film(sensor.width, sensor.height,
                                  film_channels(sensor),
                                  sensor.rfilter_sigma, device=device)
    shape = (sensor.height, sensor.width, film_channels(sensor))
    if tuple(init_film.value.shape) != shape:
        raise ValueError(f"init_film of shape {tuple(init_film.value.shape)}"
                         f" for a film of shape {shape}")

    def own(x):
        return x.to(device=device, dtype=torch.float32, copy=True)

    return film_mod.Film(value=own(init_film.value),
                         weight=own(init_film.weight),
                         direct=own(init_film.direct),
                         rfilter_sigma=init_film.rfilter_sigma,
                         radius=init_film.radius)


def _stats(dt, paths, mode, spp_done, spp, lanes, stats):
    """The stats dict of a backward render; its device counters are also
    recorded into util/stats.py's registry."""
    vec = stats.cpu().numpy()
    counters = {name: float(vec[i]) for name, i in _COUNTER_NAMES.items()}
    hist = [float(x) for x in vec[path_mod.STAT_TRI_HIST0:path_mod.N_STATS]]
    reg = stats_mod.registry
    for name, v in counters.items():
        reg.counter(f"integrator/{name}").add(v)
    if any(hist):
        h = reg.histogram("ads/tris_per_cone")
        for i, c in enumerate(hist):
            h.add_count(i, c)
    return dict(
        seconds=dt, paths=paths, paths_per_sec=paths / max(dt, 1e-9),
        mode=mode, spp_done=spp_done, interrupted=spp_done < spp,
        pool_lanes=lanes,
        device_counters=dict(counters, tris_per_cone_hist=hist))


def render_scene(built, sensor_index: int = 0, spp: int | None = None,
                 seed: int = 0, device: str = "cuda",
                 pool_lanes: int | None = None, compact: bool = True,
                 progress=None, interrupt=None, on_capture=None,
                 init_film=None, spp_start: int = 0,
                 return_renderer: bool = False):
    """Render one sensor → (img (H, W, C) numpy, stats dict), and the
    Renderer (its last_film, last_spp_done) with return_renderer."""
    r = Renderer(built, seed=seed, device=device, pool_lanes=pool_lanes,
                 compact=compact, interrupt=interrupt, on_capture=on_capture)
    out = r.render_sensor(sensor_index, spp, progress, init_film=init_film,
                          spp_start=spp_start)
    return out + (r,) if return_renderer else out
