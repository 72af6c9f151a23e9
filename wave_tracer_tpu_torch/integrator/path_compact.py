"""Compacted persistent-wavefront classical renderer.

Port of wave_tracer_tpu/integrator/path_compact.py (classical bounce). A
fixed pool of lanes is kept saturated: a lane that dies splats its
radiance into the film and restarts as the next (pixel, sample) id of the
launch's id range. The pool loop is a host `while` over device tensors —
splat the dead lanes, refill them, bounce the pool, then poll `alive`.

RNG streams are keyed by (pixel, sample, depth, use), never by the lane
slot, so the pool size does not change which paths are traced: images
from different pool sizes agree to splat-order rounding.
"""

from __future__ import annotations

import torch

from wave_tracer_tpu_torch.integrator.path import (N_STATS, _perp_axis,
                                                   classical_bounce)
from wave_tracer_tpu_torch.sampling import rng
from wave_tracer_tpu_torch.sensor import film as film_mod


def _pool_parts(sensor, max_depth, eps, mis, rr_depth, rr_floor):
    """Pool machinery: fresh-lane sourcing, develop-to-channels and the
    one-step body, over (data, base_key, id_end)."""
    W, H = sensor.width, sensor.height
    npix = W * H
    if getattr(sensor, "polarimetric", False):
        raise NotImplementedError("polarimetric sensors are not ported yet")

    def fresh(data, base_key, ids):
        """Camera-ray lane state for (pixel, sample) ids (int64 (n,))."""
        tables = data.tables
        sp = data.spectral
        n = ids.shape[0]
        dev = ids.device
        pix = ids % npix
        sid = ids // npix
        keys = rng.sample_key(base_key, pix, sid)
        jitter = rng.uniform(keys, rng.D_PIXEL_JITTER, 2)
        u_spec = rng.uniform(keys, rng.D_SPECTRUM, 2)
        e0, _ = sp.sample_emitter(u_spec[:, 0])
        k, _ = sp.sample_k(e0, u_spec[:, 1])
        p_k = sp.joint_spectral_density(k)
        w_spectral = 1.0 / p_k.clamp_min(1e-30)
        pxy = torch.stack([pix % W, pix // W], dim=-1)
        ro, rd, _ = sensor.generate_rays(pxy, jitter)
        M0 = torch.eye(4, dtype=torch.float32, device=dev).expand(
            n, 4, 4) * sensor.importance()
        sens = sensor.response.sensitivities(k, tables.spectra, None)
        ps = dict(ro=ro.contiguous(), rd=rd, M=M0.contiguous(),
                  xf=_perp_axis(-rd),
                  L=torch.zeros((n, 4), dtype=torch.float32, device=dev),
                  active=torch.ones((n,), dtype=torch.bool, device=dev),
                  exclude=torch.full((n,), -1, dtype=torch.int32,
                                     device=dev),
                  prev_pdf=torch.zeros((n,), dtype=torch.float32,
                                       device=dev),
                  prev_specular=torch.ones((n,), dtype=torch.bool,
                                           device=dev))
        meta = dict(idx=keys["idx"], strm=keys["strm"], k=k,
                    w_spectral=w_spectral, sens=sens,
                    splat_pos=pxy.to(torch.float32) + jitter,
                    depth=torch.zeros((n,), dtype=torch.int64, device=dev))
        return ps, meta

    def to_values(ps, meta):
        return (ps["L"] * meta["w_spectral"][:, None])[:, 0:1] * meta["sens"]

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
                    ps[key_][slots] = val
                for key_, val in f_meta.items():
                    meta[key_][slots] = val
                pending = pending | take
                next_id += slots.numel()
        # 3. one bounce for the whole pool
        dkeys = rng.depth_key_v(
            {"idx": meta["idx"], "strm": meta["strm"]}, meta["depth"])
        ps = classical_bounce(data, ps, dkeys, meta["k"], meta["depth"],
                              eps=eps, mis=mis, rr_depth=rr_depth,
                              rr_floor=rr_floor, with_stats=True)
        meta["depth"] = torch.where(ps["active"], meta["depth"] + 1,
                                    meta["depth"])
        # depth cap = the batched renderer's max_depth
        ps["active"] = ps["active"] & (meta["depth"] < max_depth)
        return dict(ps=ps, meta=meta, film=c["film"], pending=pending,
                    next_id=next_id)

    def final_splat(c):
        film_mod.splat(c["film"], c["meta"]["splat_pos"],
                       to_values(c["ps"], c["meta"]), c["pending"])
        return c["film"]

    return fresh, to_values, init_state, body, final_splat


def render_pool(data, film, base_key, id_bounds, lanes, *, sensor,
                max_depth, eps, mis, rr_depth=3, rr_floor=0.5):
    """Run the pool over ids [id_bounds[0], id_bounds[1]) with `lanes`
    lanes. Ids enumerate (pixel, sample) pairs as id = sid·npixels + pixel.
    Returns (film, stats (N_STATS,) f32); the film is updated in place."""
    _, _, init_state, body, final_splat = _pool_parts(
        sensor, max_depth, eps, mis, rr_depth, rr_floor)
    id_start, id_end = int(id_bounds[0]), int(id_bounds[1])
    c = init_state(data, film, base_key, id_start, lanes,
                   film.value.device)
    while True:
        c = body(data, base_key, id_end, c)
        # host poll of the device-side liveness
        if c["next_id"] >= id_end and not bool(c["ps"]["active"].any()):
            break
    return final_splat(c), c["ps"]["stats"]
