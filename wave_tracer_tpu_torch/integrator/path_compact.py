"""Compacted persistent-wavefront classical/wave renderer.

Port of wave_tracer_tpu/integrator/path_compact.py. A fixed pool of lanes
is kept saturated: a lane that dies splats its radiance into the film and
restarts as the next (pixel, sample) id of the launch's id range. The
pool loop is a host `while` over device tensors — splat the dead lanes,
refill them, bounce the pool (classical, or the wave bounce of
integrator/plt_path.py), then poll `alive`.

RNG streams are keyed by (pixel, sample, depth, use), never by the lane
slot, so the pool size does not change which paths are traced: images
from different pool sizes agree to splat-order rounding.

Each lane carries its last closest hit (hit_t, hit_tri) and whether its
ray is still the one that hit belongs to (hit_current): a refill and a
bounce that writes a new ray clear it, the trace sets it. The bounce
traces only the lanes without a current hit; the others (dead lanes,
which keep their ray) take the carried one, which is what tracing them
again would give.
"""

from __future__ import annotations

from dataclasses import fields, is_dataclass

import torch

from wave_tracer_tpu_torch.integrator.path import (N_STATS, camera_lanes,
                                                   classical_bounce,
                                                   sensor_values)
from wave_tracer_tpu_torch.integrator.plt_path import beam_state, wave_bounce
from wave_tracer_tpu_torch.sampling import rng
from wave_tracer_tpu_torch.sensor import film as film_mod

# aperture slots (edges) per lane of the wave bounce, as the JAX pool's
FSD_SLOTS = 8


def _put(dst, slots, val):
    """dst[slots] = val for a tensor or a dataclass of tensors."""
    if is_dataclass(dst):
        for f in fields(dst):
            getattr(dst, f.name)[slots] = getattr(val, f.name)
    else:
        dst[slots] = val


def _pool_parts(sensor, max_depth, eps, mis, rr_depth, rr_floor, wave,
                carry_hits=True):
    """Pool machinery: fresh-lane sourcing, develop-to-channels and the
    one-step body, over (data, base_key, id_end)."""
    W, H = sensor.width, sensor.height
    npix = W * H
    polarimetric = bool(getattr(sensor, "polarimetric", False))

    def fresh(data, base_key, ids):
        """Camera-ray lane state for (pixel, sample) ids (int64 (n,))."""
        n = ids.shape[0]
        dev = ids.device
        pix = ids % npix
        sid = ids // npix
        keys = rng.sample_key(base_key, pix, sid)
        jitter = rng.uniform(keys, rng.D_PIXEL_JITTER, 2)
        pxy = torch.stack([pix % W, pix // W], dim=-1)
        ps, k, w_spectral, pixel_tan_alpha = camera_lanes(
            data, sensor, pxy, jitter, keys)
        sens = sensor.response.sensitivities(k, data.tables.spectra, None)
        if wave:
            ps.update(beam_state(ps["ro"], ps["rd"], ps["M"],
                                 pixel_tan_alpha, FSD_SLOTS))
        if carry_hits:
            ps.update(hit_t=torch.zeros((n,), dtype=torch.float32,
                                        device=dev),
                      hit_tri=torch.full((n,), -1, dtype=torch.int32,
                                         device=dev),
                      hit_current=torch.zeros((n,), dtype=torch.bool,
                                              device=dev))
        meta = dict(idx=keys["idx"], strm=keys["strm"], k=k,
                    w_spectral=w_spectral, sens=sens,
                    splat_pos=pxy.to(torch.float32) + jitter,
                    depth=torch.zeros((n,), dtype=torch.int64, device=dev))
        if "key" in keys:               # the threefry sampler's lane keys
            meta["key"] = keys["key"]
        return ps, meta

    def to_values(ps, meta):
        return sensor_values(ps["L"], meta["w_spectral"], meta["sens"],
                             polarimetric)

    def init_state(data, film, base_key, id_start, N, device):
        """An empty pool (all dead, nothing pending); the first step
        fills it."""
        ps, meta = fresh(data, base_key,
                         torch.zeros((N,), dtype=torch.int64, device=device))
        ps["active"] = torch.zeros_like(ps["active"])
        ps["stats"] = torch.zeros((N_STATS,), dtype=torch.float32,
                                  device=device)
        return dict(ps=ps, meta=meta, film=film,
                    pending=torch.zeros_like(ps["active"]),
                    next_id=int(id_start))

    def body(data, base_key, id_end, c):
        """One pool step. Splats and refills update the state in place."""
        ps, meta = c["ps"], c["meta"]
        dead = ~ps["active"]
        # 1. splat finished lanes
        film_mod.splat(c["film"], meta["splat_pos"], to_values(ps, meta),
                       dead & c["pending"])
        pending = c["pending"] & ~dead
        # 2. refill dead lanes with the next ids
        next_id = c["next_id"]
        if next_id < id_end:
            ranks = torch.cumsum(dead, dim=0) - 1
            new_id = next_id + ranks
            take = dead & (new_id < id_end)
            slots = take.nonzero().squeeze(1)
            if slots.numel():
                f_ps, f_meta = fresh(data, base_key, new_id[slots])
                for key_, val in f_ps.items():
                    _put(ps[key_], slots, val)
                for key_, val in f_meta.items():
                    meta[key_][slots] = val
                pending = pending | take
                next_id += slots.numel()
        # 3. one bounce for the whole pool
        dkeys = rng.depth_key_v(
            {k: meta[k] for k in ("idx", "strm", "key") if k in meta},
            meta["depth"])
        if wave:
            ps = wave_bounce(data, data.edges, ps, dkeys, meta["k"],
                             meta["depth"], eps=eps, mis=mis, fsd=True,
                             K=FSD_SLOTS,
                             rr_depth=rr_depth, rr_floor=rr_floor,
                             with_stats=True)
        else:
            ps = classical_bounce(data, ps, dkeys, meta["k"],
                                  meta["depth"], eps=eps, mis=mis,
                                  rr_depth=rr_depth, rr_floor=rr_floor,
                                  with_stats=True)
        meta["depth"] = torch.where(ps["active"], meta["depth"] + 1,
                                    meta["depth"])
        # depth cap = the batched renderer's max_depth. The lanes it ends
        # hold the new ray the bounce wrote, which is not traced yet: the
        # bounce cleared their hit_current
        ps["active"] = ps["active"] & (meta["depth"] < max_depth)
        return dict(ps=ps, meta=meta, film=c["film"], pending=pending,
                    next_id=next_id)

    def final_splat(c):
        film_mod.splat(c["film"], c["meta"]["splat_pos"],
                       to_values(c["ps"], c["meta"]), c["pending"])
        return c["film"]

    return fresh, to_values, init_state, body, final_splat


def render_pool(data, film, base_key, id_bounds, lanes, *, sensor,
                max_depth, eps, mis, rr_depth=3, rr_floor=0.5, wave=False,
                carry_hits=True):
    """Run the pool over ids [id_bounds[0], id_bounds[1]) with `lanes`
    lanes. Ids enumerate (pixel, sample) pairs as id = sid·npixels + pixel.
    wave=True runs the wave-optical bounce (hybrid cone traversal +
    deferred coherent FSD with FSD_SLOTS aperture slots). carry_hits=False
    traces every lane at every step instead of only the lanes whose ray
    changed (the same image and counters). Returns (film, stats (N_STATS,)
    f32); the film is updated in place."""
    _, _, init_state, body, final_splat = _pool_parts(
        sensor, max_depth, eps, mis, rr_depth, rr_floor, wave, carry_hits)
    id_start, id_end = int(id_bounds[0]), int(id_bounds[1])
    c = init_state(data, film, base_key, id_start, lanes,
                   film.value.device)
    while True:
        c = body(data, base_key, id_end, c)
        # host poll of the device-side liveness
        if c["next_id"] >= id_end and not bool(c["ps"]["active"].any()):
            break
    return final_splat(c), c["ps"]["stats"]
