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
"""

from __future__ import annotations

import dataclasses
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
# default lanes per bdpt batch. A lane holds two stored subpaths of up to
# max_depth vertices, each with its Fraunhofer aperture slots (about 15 KB
# at depth 8); every draw is keyed by (pixel, sample), so the batch width
# changes no pixel. On the CPU the JAX package's test-sized batches. The
# forward renderer takes the same widths: there a draw is keyed by (lane,
# batch), so the width does change the image, as in the JAX package.
BDPT_LANES_CUDA = 1 << 18
BDPT_LANES_CPU = 1 << 12
# the JAX renderer's ceiling on the edge count for FSD. Above 2048 edges
# the JAX integrators take the clustered edge sweep, which the port lacks:
# accel/edges.py raises there
MAX_FSD_EDGES = 1 << 20

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

    def render_sensor(self, sensor_index: int = 0, spp: int | None = None):
        built = self.built
        device = torch.device(self.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if built.device != device:
            built = built.on(device)
        scene = built.scene
        sensor = scene.sensors[sensor_index]
        if not isinstance(sensor, (PerspectiveSensor, VirtualPlaneSensor)):
            raise NotImplementedError(
                f"{type(sensor).__name__} sensors are not ported yet")
        cfg = scene.integrator
        spp = spp or sensor.samples
        data = dataclasses.replace(
            built.data, spectral=built.spectral_per_sensor[sensor_index])
        if isinstance(sensor, VirtualPlaneSensor):
            return self._render_forward(data, sensor, spp, cfg,
                                        1e-4 * scene.world_radius(), device)
        trace_only = sensor.ray_trace_only or cfg.ray_trace_only
        if cfg.type not in ("plt_path", "plt_bdpt") and not trace_only:
            raise NotImplementedError(f"{cfg.type} is not ported yet")
        # as the JAX renderer decides: FSD needs wedge edges; a scene
        # without any renders classically
        n_edges = built.data.edges.count
        fsd_on = (cfg.fsd and not trace_only
                  and 0 < n_edges <= MAX_FSD_EDGES)
        W, H = sensor.width, sensor.height
        film = film_mod.make_film(W, H, _film_channels(sensor),
                                  sensor.rfilter_sigma, device=device)
        eps = 1e-4 * scene.world_radius()
        if cfg.type == "plt_bdpt" and not trace_only:
            return self._render_batched(data, sensor, spp, film, cfg, eps,
                                        fsd_on, device, "bdpt")
        if not self.compact:
            return self._render_batched(data, sensor, spp, film, cfg, eps,
                                        fsd_on, device,
                                        "wave" if fsd_on else "ray")
        paths = spp * W * H
        lanes = min(paths, self.pool_lanes or (
            POOL_LANES_CUDA if device.type == "cuda" else POOL_LANES_CPU))

        t0 = time.perf_counter()
        film, stats = render_pool(
            data, film, rng.make_base_key(self.seed), (0, paths),
            lanes, sensor=sensor, max_depth=cfg.max_depth, eps=eps,
            mis=cfg.mis, wave=fsd_on)
        img = film_mod.develop(film).cpu().numpy()   # waits for the device
        dt = time.perf_counter() - t0
        return img, _stats(dt, paths, "wave-compact" if fsd_on
                           else "ray-compact", spp, lanes, stats)

    def _render_batched(self, data, sensor, spp, film, cfg, eps, fsd,
                        device, mode):
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
        base_key = rng.make_base_key(self.seed)
        stats = torch.zeros((path_mod.N_STATS,), dtype=torch.float32,
                            device=device)
        t0 = time.perf_counter()
        for s0 in range(0, spp, spp_per_batch):
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
        # bdpt's light-tracing splats are normalized per pixel sample
        img = film_mod.develop(film, spp if mode == "bdpt" else 0.0
                               ).cpu().numpy()   # waits for the device
        dt = time.perf_counter() - t0
        return img, _stats(dt, npix * spp, mode, spp,
                           pix_per_batch * spp_per_batch, stats)

    def _render_forward(self, data, sensor, spp, cfg, eps, device):
        """Forward light tracing onto a virtual-plane sensor: spp·W·H
        paths in batches of `pool_lanes` lanes (lane ids 0..n−1, sample
        id the batch index, as the JAX package's forward kernel draws
        them; its lanes past the end, masked off there, are not traced
        here). Crossings splat as Gaussian beams and FSD-NEE connections
        as points into the light image, developed by the samples per
        element."""
        W, H = sensor.width, sensor.height
        film = film_mod.make_film(W, H, _film_channels(sensor),
                                  sensor.rfilter_sigma, device=device)
        wave = cfg.fsd and 0 < data.edges.count <= MAX_FSD_EDGES
        fsd_mode = "fraunhofer" if cfg.type == "plt_bdpt" else "utd"
        lanes = self.pool_lanes or (
            BDPT_LANES_CUDA if device.type == "cuda" else BDPT_LANES_CPU)
        base_key = rng.make_base_key(self.seed)
        total = spp * W * H
        t0 = time.perf_counter()
        done = batch = 0
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
        spe = done / float(W * H)
        img = film_mod.develop(film, spe).cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
        return img, dict(seconds=dt, paths=done,
                         paths_per_sec=done / max(dt, 1e-9),
                         mode="forward-wave" if wave else "forward",
                         spp_done=spe, interrupted=False, pool_lanes=lanes,
                         batches=batch)


def _film_channels(sensor):
    """A polarimetric sensor's film holds I/Q/U/V per response channel."""
    return sensor.response.channels \
        * (4 if getattr(sensor, "polarimetric", False) else 1)


def _stats(dt, paths, mode, spp, lanes, stats):
    vec = stats.cpu().numpy()
    return dict(
        seconds=dt, paths=paths, paths_per_sec=paths / max(dt, 1e-9),
        mode=mode, spp_done=spp, interrupted=False, pool_lanes=lanes,
        device_counters=dict(
            {name: float(vec[i]) for name, i in _COUNTER_NAMES.items()},
            tris_per_cone_hist=[float(x) for x in vec[
                path_mod.STAT_TRI_HIST0:path_mod.N_STATS]]))


def render_scene(built, sensor_index: int = 0, spp: int | None = None,
                 seed: int = 0, device: str = "cuda",
                 pool_lanes: int | None = None, compact: bool = True):
    """Render one sensor → (img (H, W, C) numpy, stats dict)."""
    return Renderer(built, seed=seed, device=device, pool_lanes=pool_lanes,
                    compact=compact).render_sensor(sensor_index, spp)
