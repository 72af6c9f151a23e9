"""Render orchestration: the persistent compacted wavefront into a film.

Port of wave_tracer_tpu/render/renderer.py for the backward classical path
(`Renderer._render_backward_compact` with the classical bounce): the
integrator `plt_path` with free-space diffraction off (`fsd=False`) or in
ray-trace-only mode. Scenes that ask for the wave bounce (FSD), plt_bdpt
or a virtual-plane sensor raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from wave_tracer_tpu_torch.integrator import path as path_mod
from wave_tracer_tpu_torch.integrator.path_compact import render_pool
from wave_tracer_tpu_torch.sampling import rng
from wave_tracer_tpu_torch.sensor import film as film_mod
from wave_tracer_tpu_torch.sensor.perspective import PerspectiveSensor

# default lane-pool sizes. On the card a pool step costs a few thousand
# small torch launches whatever its width (most of them the int64 Sobol
# hashing), so wider pools amortize them (box,
# 256² × 16 spp on one H100: 0.49-0.57M paths/s at 2^16 lanes, 1.60-1.66M
# at 2^18), while at 82k triangles K1/K2 dominate and 2^16 ≈ 2^18; on the
# CPU the JAX package's own pool size. A pool never exceeds the number of
# paths: the kernels would trace the idle lanes too.
POOL_LANES_CUDA = 1 << 18
POOL_LANES_CPU = 1 << 13

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
    pool_lanes: int | None = None  # None: POOL_LANES_CUDA / POOL_LANES_CPU

    def render_sensor(self, sensor_index: int = 0, spp: int | None = None):
        built = self.built
        device = torch.device(self.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if built.device != device:
            built = built.on(device)
        scene = built.scene
        sensor = scene.sensors[sensor_index]
        if not isinstance(sensor, PerspectiveSensor):
            raise NotImplementedError(
                f"{type(sensor).__name__} sensors are not ported yet")
        cfg = scene.integrator
        trace_only = sensor.ray_trace_only or cfg.ray_trace_only
        if cfg.type != "plt_path" and not trace_only:
            raise NotImplementedError(f"{cfg.type} is not ported yet")
        if cfg.fsd and not trace_only:
            raise NotImplementedError(
                "the wave bounce (plt_path with fsd=True) is not ported "
                "yet; set integrator.fsd = False")
        spp = spp or sensor.samples
        data = dataclasses.replace(
            built.data, spectral=built.spectral_per_sensor[sensor_index])
        W, H = sensor.width, sensor.height
        film = film_mod.make_film(W, H, sensor.response.channels,
                                  sensor.rfilter_sigma, device=device)
        paths = spp * W * H
        lanes = min(paths, self.pool_lanes or (
            POOL_LANES_CUDA if device.type == "cuda" else POOL_LANES_CPU))
        eps = 1e-4 * scene.world_radius()

        t0 = time.perf_counter()
        film, stats = render_pool(
            data, film, rng.make_base_key(self.seed), (0, paths),
            lanes, sensor=sensor, max_depth=cfg.max_depth, eps=eps,
            mis=cfg.mis)
        img = film_mod.develop(film).cpu().numpy()   # waits for the device
        dt = time.perf_counter() - t0
        vec = stats.cpu().numpy()
        return img, dict(
            seconds=dt, paths=paths, paths_per_sec=paths / max(dt, 1e-9),
            mode="ray-compact", spp_done=spp, interrupted=False,
            pool_lanes=lanes,
            device_counters={name: float(vec[i])
                             for name, i in _COUNTER_NAMES.items()})


def render_scene(built, sensor_index: int = 0, spp: int | None = None,
                 seed: int = 0, device: str = "cuda",
                 pool_lanes: int | None = None):
    """Render one sensor → (img (H, W, C) numpy, stats dict)."""
    return Renderer(built, seed=seed, device=device,
                    pool_lanes=pool_lanes).render_sensor(sensor_index, spp)
