"""plt_path — wave-optical backward transport over beam lanes.

Port of `trace_paths_wave` and `wave_bounce` of
wave_tracer_tpu/integrator/plt_path.py. Each lane carries a full beam: an
elliptic-cone envelope, a Mueller throughput operator, one wavenumber,
and the deferred free-space-diffraction carry — the previous vertex's
aperture plus the pre-interaction Mueller operator, superposed one bounce
later.

Per bounce: trace (K1) → hybrid ballistic/diffusive traversal over the
exact cone–triangle sweep (K3) → edges inside the beam envelope →
deferred coherent UTD sum with per-edge shadow tests (K2, one batched
call over the 2K+1 legs of every lane, tracing only the legs that are
read) → emission MIS → NEE (K2, surface lanes only) →
interaction (surface | FSD | null) → the next deferred aperture → RR.

The cone query follows WT_CONE_QUERY, read per bounce as the JAX module
reads it: unset or "mxu", the per-boundary minima of
`accel.trace.cone_boundary_minz` (K3 on the card, its plain version on
the CPU); "topk", "2pass" or "clustered", a K-capped encounter set from
`tris_near_cone`, `tris_near_cone_2pass` or `tris_near_cone_clustered`
(plain torch; none reaches a Pallas kernel in the JAX package) fed to
`traversal.schedule`. The cone-test counter counts what each query
tests per lane, as in the JAX module.
"""

from __future__ import annotations

import math
import os

import torch

from wave_tracer_tpu_torch.accel import edges as edges_mod
from wave_tracer_tpu_torch.accel import trace as trace_mod
from wave_tracer_tpu_torch.bsdf import device as bsdf_dev
from wave_tracer_tpu_torch.emitter import table as etab
from wave_tracer_tpu_torch.integrator import traversal as traversal_mod
from wave_tracer_tpu_torch.integrator.path import (
    N_STATS, N_TRI_HIST, _contribution, _emitter_pmf, _perp_axis,
    _power_heuristic, _sample_emitter_by_power, bsdf_uniforms, camera_lanes,
    carried_hit, compose_scatter, next_carried_hit, sensor_values,
    tri_hist_bin)
from wave_tracer_tpu_torch.math import frame as frame_mod
from wave_tracer_tpu_torch.math import vec
from wave_tracer_tpu_torch.sampling import rng
from wave_tracer_tpu_torch.wave import envelope as env_mod
from wave_tracer_tpu_torch.wave import fsd as fsd_mod
from wave_tracer_tpu_torch.wave import sourcing

BIG = 1e30
# z-extent of the interaction region relative to the footprint major axis
Z_SCALE = 2.0


def _where_lanes(cond, new, old):
    """Per-lane select for tensors of any rank (lanes first)."""
    return torch.where(cond.view(cond.shape + (1,) * (new.dim() - 1)),
                       new, old)


def beam_state(ro, rd, M0, pixel_tan_alpha, K):
    """The wave bounce's beam state of fresh camera lanes: the elliptic
    envelope and the (empty) deferred FSD carry with K aperture slots."""
    n = ro.shape[0]
    dev = ro.device
    return dict(env=env_mod.initial(rd, 0.0, 0.5 * pixel_tan_alpha),
                fsd_ap=fsd_mod.empty_aperture(n, K, dev),
                fsd_valid=torch.zeros((n,), dtype=torch.bool, device=dev),
                sampled_fsd=torch.zeros((n,), dtype=torch.bool, device=dev),
                prev_vert=ro.clone(), M_prev=M0.clone())


def trace_paths_wave(data, pixel_xy, jitter, base_key, sample_ids, *, sensor,
                     edge_table, max_depth: int = 8, rr_depth: int = 3,
                     rr_floor: float = 0.5, eps: float = 1e-5,
                     mis: bool = True, fsd: bool = True, K: int = 8,
                     with_stats: bool = False):
    """Wave-mode path batch: `max_depth` wave bounces over fixed lanes
    (the JAX package's fori_loop, but a lane that died adds nothing
    more), differentiable as `integrator.path.trace_paths` is. The
    per-boundary minima of K3 carry no derivative, so a diffusive lane's
    interaction distance does not follow moving geometry; spectra,
    emitter and roughness derivatives are whole. Returns (splat_pos,
    values, valid), with the (N_STATS,) counters appended under
    with_stats."""
    N = pixel_xy.shape[0]
    pixel_id = pixel_xy[:, 1] * sensor.width + pixel_xy[:, 0]
    keys = rng.sample_key(base_key, pixel_id, sample_ids)
    st, k, w_spectral, pixel_tan_alpha = camera_lanes(data, sensor, pixel_xy,
                                                      jitter, keys)
    st.update(beam_state(st["ro"], st["rd"], st["M"], pixel_tan_alpha, K))
    st["stats"] = torch.zeros((N_STATS,), dtype=torch.float32,
                              device=pixel_xy.device)
    splat_pos = pixel_xy.to(torch.float32) + jitter
    for depth in range(max_depth):
        live, L = st["active"], st["L"]
        st = wave_bounce(data, edge_table, st, rng.depth_key(keys, depth), k,
                         depth, eps=eps, mis=mis, fsd=fsd, K=K,
                         rr_depth=rr_depth, rr_floor=rr_floor,
                         with_stats=with_stats)
        # the bounce adds emission and NEE wherever its ray meets a
        # surface, dead lanes included, and a dead lane keeps its last
        # ray: over fixed lanes it would add them again at every later
        # depth (the JAX package's trace_paths_wave does). A dead lane
        # keeps its L, as the pool, which splats it first, does
        st["L"] = torch.where(live[:, None], st["L"], L)
    sens = sensor.response.sensitivities(k, data.tables.spectra, None)
    values = sensor_values(st["L"], w_spectral, sens,
                           bool(getattr(sensor, "polarimetric", False)))
    valid = torch.ones((N,), dtype=torch.bool, device=pixel_xy.device)
    if with_stats:
        return splat_pos, values, valid, st["stats"]
    return splat_pos, values, valid


def wave_bounce(data, edge_table, st, dkeys, k, depth, *, eps, mis, fsd,
                K, rr_depth, rr_floor, with_stats=False):
    """One wave-optical bounce over the lane state dict (ro, rd, M, xf, L,
    active, exclude, prev_pdf, prev_specular, env, fsd_ap, fsd_valid,
    sampled_fsd, prev_vert, M_prev, stats, and optionally the carried hit
    hit_t, hit_tri, hit_current). `depth` is an int or a per-lane tensor.
    Returns the new state dict. Only fsd=True is ported: the renderer
    takes the classical bounce when FSD is off."""
    if not fsd:
        raise NotImplementedError("wave_bounce with fsd=False is not ported")
    geo = data.geo
    tables = data.tables
    et = data.emitters
    N = st["L"].shape[0]
    dev = st["L"].device
    f32 = torch.float32
    ro, rd = st["ro"], st["rd"]

    def full(n, val, dtype=f32):
        return torch.full((n,), val, dtype=dtype, device=dev)

    # every lane's hit is read below (zmax, and the surface, FSD and null
    # counters count the whole pool), so a lane that is not traced keeps
    # its carried hit rather than a miss
    t, tri, u, v = trace_mod.trace(geo, ro, rd, full(N, eps), full(N, BIG),
                                   st["exclude"], **carried_hit(st))
    hit = trace_mod.hit_attributes(geo, ro, rd, t, tri, u, v)
    lane = st["active"]

    env = st["env"]
    zmax = torch.where(hit.valid, hit.t * 1.02 + env.x0,
                       8.0 * et.scene_radius)

    # ---- hybrid ballistic/diffusive traversal: a closed-form schedule
    # over the cone–triangle encounters. By default (and "mxu") the
    # per-boundary earliest encounters (K3); WT_CONE_QUERY = topk, 2pass
    # or clustered takes a K-capped encounter set from the plain torch
    # queries instead (read per call, as the JAX bounce reads it)
    lam = (2.0 * math.pi) / k.clamp_min(1e-9)
    q_mode = os.environ.get("WT_CONE_QUERY", "")
    if q_mode in ("topk", "2pass", "clustered"):
        args = (ro, rd, env, zmax, K)
        if q_mode == "topk":
            _, tz, tcnt = trace_mod.tris_near_cone(
                geo, *args, exclude_tri=st["exclude"])
            cone_tests_per_lane = float(geo.num_tris)
        elif q_mode == "2pass":       # exact tests on J = 32 candidates
            _, tz, tcnt = trace_mod.tris_near_cone_2pass(
                geo, *args, exclude_tri=st["exclude"])
            cone_tests_per_lane = 32.0
        else:
            _, tz, tcnt = trace_mod.tris_near_cone_clustered(
                geo, data.tri_clusters, *args, exclude_tri=st["exclude"])
            cone_tests_per_lane = float(trace_mod.TRI_N_CLUSTERS
                                        * trace_mod.TRI_CAP)
        tr = traversal_mod.schedule(hit.t, hit.valid, tz, env, lam, zmax)
    else:
        bounds = traversal_mod.segment_boundaries(lam)
        zc, tcnt = trace_mod.cone_boundary_minz(
            geo, ro, rd, env, bounds, zmax, exclude_tri=st["exclude"])
        tr = traversal_mod.schedule_from_minz(hit.t, hit.valid, zc, env,
                                              lam, zmax)
        cone_tests_per_lane = float(geo.num_tris)

    # ---- edge sweep inside the beam envelope (FSD aperture feed)
    if edge_table.count > 0:
        eidx, _, ecnt = edges_mod.edges_in_cone(
            edge_table, data.edge_clusters, ro, rd, env, zmax, K)
    else:
        eidx = torch.full((N, K), -1, dtype=torch.int32, device=dev)
        ecnt = torch.zeros((N,), dtype=torch.int32, device=dev)
    have_edges = ecnt > 0

    # surface interaction: ballistic hits always; diffusive regions when
    # the central-ray hit falls inside the interaction region
    delta = traversal_mod.region_depth(env, tr.z_region)
    tol = (1e-3 * tr.z_region).clamp_min(4.0 * eps)
    in_region = hit.valid & (hit.t <= tr.z_region + delta + tol)
    surface = (tr.ballistic & hit.valid) | (tr.diffusive & in_region)
    # diffusive regions with no triangle under the central ray are
    # midflight interactions (FSD through the aperture, or null)
    midflight = tr.diffusive & ~surface
    z_int = torch.where(surface, hit.t, tr.z_region)
    has_interaction = lane & (surface | midflight)
    wp = ro + z_int[:, None] * rd
    fp_int = env.major(z_int)

    # ---- deferred FSD evaluation (modulation of the previous segment)
    M = st["M"]
    prev = st["prev_vert"]
    dst = torch.where(has_interaction[:, None], wp, ro + 4.0 * rd)
    ev = fsd_mod.fsd_eval(st["fsd_ap"], k, prev, dst)
    # per-edge shadow tests, both legs + the direct segment, batched
    # into one any-hit call; both legs touch the edge's Fermat point,
    # so its two faces are excluded, and the dst-side leg and the
    # direct segment exclude the hit triangle
    a_pts = torch.cat([prev[:, None, :].expand(N, K, 3).reshape(-1, 3),
                       ev["p"].reshape(-1, 3), prev])
    b_pts = torch.cat([ev["p"].reshape(-1, 3),
                       dst[:, None, :].expand(N, K, 3).reshape(-1, 3),
                       dst])
    et1, et2 = fsd_mod.aperture_face_tris(edge_table, st["fsd_ap"])
    none_n = full(N, -1, torch.int32)
    ex1 = torch.cat([et1.reshape(-1), et1.reshape(-1), none_n])
    ex2 = torch.cat([et2.reshape(-1), et2.reshape(-1), hit.tri])
    ex3 = torch.cat([full(N * K, -1, torch.int32),
                     hit.tri[:, None].expand(N, K).reshape(-1), none_n])
    seg = b_pts - a_pts
    seg_d = vec.safe_length(seg)
    seg_n = seg / seg_d.clamp_min(1e-20)[:, None]
    # only these legs are read: an edge leg where the carry is valid and
    # the edge term survives fsd_eval (coherent_sum masks with
    # ev["valid"], and f_mod is 1 where ~fsd_valid), the direct leg where
    # the carry is valid
    leg_need = (st["fsd_valid"][:, None] & ev["valid"]).reshape(-1)
    occ_all = trace_mod.occluded(geo, a_pts, seg_n,
                                 full(a_pts.shape[0], eps),
                                 seg_d - 2.0 * eps, ex1, ex2, ex3,
                                 need=torch.cat([leg_need, leg_need,
                                                 st["fsd_valid"]]))
    s1 = occ_all[:N * K].view(N, K)
    s2 = occ_all[N * K:2 * N * K].view(N, K)
    direct_vis = st["fsd_valid"] & ~occ_all[2 * N * K:]
    ts, th = fsd_mod.coherent_sum(ev, k, prev, dst, direct_vis,
                                  ~s1 & ~s2)
    f_mod = fsd_mod.fsd_intensity(ts, th)
    f_mod = torch.where(st["fsd_valid"] & torch.isfinite(f_mod),
                        f_mod, 1.0)[:, None, None]
    M_cur = torch.where(st["fsd_valid"][:, None, None],
                        torch.where(st["sampled_fsd"][:, None, None],
                                    M * f_mod, M + st["M_prev"] * f_mod),
                        M)

    # ---- shading frame at the surface
    sf = frame_mod.build_shading_frame(hit.ns, hit.dpdu)
    sf = bsdf_dev.apply_normalmap(tables, hit.mat_id, hit.uv, k, sf)
    wi = -rd
    wi_l = sf.to_local(wi)
    one = torch.ones_like(k)
    zero4 = torch.zeros_like(st["L"])

    # ---- emission MIS
    cos_out = vec.dot(wi, hit.geo_n)
    Le = etab.emission_radiance(et, tables.spectra, hit.emitter_id, k,
                                cos_out)
    d2 = hit.t.clamp_min(1e-9) ** 2
    pdf_nee_same = etab.pdf_direct_solid_angle(
        et, hit.emitter_id, d2, cos_out) * _emitter_pmf(et, hit.emitter_id)
    w_mis_e = one if not mis else torch.where(
        st["prev_specular"], one,
        _power_heuristic(st["prev_pdf"], pdf_nee_same))
    L = st["L"] + torch.where((surface & (Le > 0))[:, None],
                              w_mis_e[:, None] * _contribution(M_cur, Le),
                              zero4)

    # ---- NEE (surface lanes)
    u_pick = rng.uniform(dkeys, rng.D_EMITTER_PICK)
    e_n, pmf_n = _sample_emitter_by_power(et, u_pick)
    u_nee = rng.uniform(dkeys, rng.D_NEE, 3)
    nee = etab.sample_direct(et, geo, tables.spectra, e_n, hit.p, k, u_nee)
    wo_nee_l = sf.to_local(nee["wo"])
    # uv-space footprint diameter of the beam for mip-filtered bitmap
    # lookups (read by bitmap rows only)
    duv = 2.0 * fp_int / vec.length(hit.dpdu).clamp_min(1e-9) \
        if tables.textures.has_bitmap else None
    f_nee, pdf_b_nee = bsdf_dev.eval_f(tables, hit.mat_id, wi_l, wo_nee_l,
                                       hit.uv, k, duv)
    # read only through ok_nee
    occ = trace_mod.occluded(geo, hit.p, nee["wo"], full(N, eps),
                             nee["dist"] - 2.0 * eps, hit.tri, nee["tri"],
                             need=surface & nee["valid"])
    pdf_nee = pmf_n * nee["pdf_sa"]
    w_mis_n = one if not mis else torch.where(
        nee["delta_dir"], one, _power_heuristic(pdf_nee, pdf_b_nee))
    M_nee, _ = compose_scatter(M_cur, st["xf"], -rd, f_nee, -nee["wo"])
    c_nee = _contribution(M_nee, nee["Li"]) \
        / pdf_nee.clamp_min(1e-30)[:, None]
    ok_nee = surface & nee["valid"] & ~occ & (pdf_nee > 0) \
        & (f_nee[:, 0, 0] > 0)
    L = L + torch.where(ok_nee[:, None], w_mis_n[:, None] * c_nee, zero4)

    # ---- surface interaction
    u_dir = rng.uniform(dkeys, rng.D_BSDF_DIR, 2)
    bs = bsdf_dev.sample(tables, hit.mat_id, wi_l, hit.uv, k,
                         bsdf_uniforms(tables, dkeys, u_dir), duv)
    wo_surface = sf.to_world(bs.wo)
    M_surf, xf_surf = compose_scatter(M_cur, st["xf"], -rd, bs.Mw,
                                      -wo_surface)
    env_surf, _ = env_mod.surface_scatter(env, rd, z_int, hit.geo_n,
                                          wo_surface, bs.specular, k)

    # ---- FSD interaction (midflight lanes)
    ap_now = fsd_mod.build_aperture(edge_table, eidx, wp, -rd,
                                    Z_SCALE * fp_int)
    u_fsd = torch.cat([rng.uniform(dkeys, rng.D_FSD, 2), u_dir], dim=-1)
    fsmp = fsd_mod.fsd_sample(ap_now, k, ro, wp, u_fsd)
    # sampled-FSD weight: 1/pdf enters the beam scale
    w_fsd = torch.where(fsmp["is_direct"],
                        (ap_now.count() + 1).to(f32),
                        1.0 / fsmp["pdf"].clamp_min(1e-20))
    fsd_lane = midflight & fsmp["valid"]
    null_lane = midflight & ~fsd_lane

    # ---- combine interaction outcomes
    surf3, fsd3 = surface[:, None], fsd_lane[:, None]
    ro_new = torch.where(surf3, hit.p, torch.where(fsd3, fsmp["p"], wp))
    rd_new = torch.where(surf3, wo_surface, torch.where(fsd3, fsmp["wo"], rd))
    M_new = torch.where(surface[:, None, None], M_surf,
                        M_cur * torch.where(fsd_lane, w_fsd, 1.0)[:, None,
                                                                  None])
    xf_new = torch.where(surf3, xf_surf, _perp_axis(-rd_new))
    exclude_new = torch.where(surface, hit.tri, st["exclude"])
    # FSD lanes restart as a near-point MUB source at the aperture; null
    # lanes carry the envelope forward re-anchored at wp
    env_fsd = sourcing.restart_envelope(rd_new, fp_int, k)
    env_null = env_mod.EnvState(x=env.x, x0=fp_int, ta=env.ta, e=env.e)
    env_new = env_mod.select(surface, env_surf,
                             env_mod.select(fsd_lane, env_fsd, env_null))
    pdf_new = torch.where(surface, bs.pdf, 1.0)
    spec_new = torch.where(surface, bs.specular, True)
    fsd_valid_new = has_interaction & ap_now.any_valid()

    # ---- russian roulette (not on null continuation)
    u_rr = rng.uniform(dkeys, rng.D_RR)
    beta = M_new[:, 0, 0].abs()
    q = beta.clamp(rr_floor, 1.0)
    do_rr = (torch.as_tensor(depth, device=dev) >= rr_depth) & ~null_lane
    survive = torch.where(do_rr, u_rr < q, True)
    M_new = M_new / torch.where(do_rr, q, 1.0)[:, None, None]

    cont = (surface & bs.valid) | fsd_lane | null_lane
    active = lane & cont & survive & (beta > 1e-12)

    stats = st["stats"]
    if with_stats:
        def cnt(m):
            return m.sum(dtype=f32)
        nlane = cnt(lane)
        shadow_legs = float(2 * K + 1)
        add = torch.stack([                              # STAT_* order
            nlane,                                       # rays
            cnt(surface) + shadow_legs * nlane,          # shadow rays
            cnt(surface), cnt(fsd_lane), cnt(null_lane),
            cnt(lane & cont & ~survive),                 # rr kills
            cnt(active),                                 # depth sum
            cnt(lane & have_edges),
            cnt(lane & tr.ballistic), cnt(lane & tr.diffusive),
            torch.full((), (2.0 + shadow_legs) * N
                       * trace_mod.ray_tests_per_lane(geo), device=dev),
            torch.full((), N * cone_tests_per_lane, device=dev)])
        hist = torch.bincount(tri_hist_bin(tcnt), weights=lane.to(f32),
                              minlength=N_TRI_HIST)
        stats = stats + torch.cat([add, hist.to(f32)])

    return dict(
        ro=_where_lanes(active, ro_new, ro),
        rd=_where_lanes(active, rd_new, rd),
        M=_where_lanes(active, M_new, M),
        xf=_where_lanes(active, xf_new, st["xf"]),
        L=L, active=active,
        exclude=_where_lanes(active, exclude_new, st["exclude"]),
        prev_pdf=_where_lanes(active, pdf_new, st["prev_pdf"]),
        prev_specular=_where_lanes(active, spec_new, st["prev_specular"]),
        env=env_mod.select(active, env_new, env),
        fsd_ap=fsd_mod.FsdAperture(**{
            name: _where_lanes(active, new, old) for (name, new), (_, old)
            in zip(ap_now.items(), st["fsd_ap"].items())}),
        fsd_valid=active & fsd_valid_new,
        sampled_fsd=_where_lanes(active, fsd_lane, st["sampled_fsd"]),
        # the deferred coherent sum runs from the segment origin
        prev_vert=_where_lanes(active, ro, st["prev_vert"]),
        M_prev=_where_lanes(active, M_cur, st["M_prev"]),
        stats=stats,
        **next_carried_hit(st, t, tri, active),
    )
