"""plt_path forward transport — light tracing onto virtual sensors.

Port of wave_tracer_tpu/integrator/plt_path_forward.py. Beams start at
emitters; when a segment crosses a virtual coverage sensor the beam is
connected directly onto the sensor element, and every free-space-
diffraction aperture also makes an explicit FSD-NEE connection to a
sampled sensor point. The deferred free-space-diffraction carry modulates
each connection with the coherent per-edge UTD sum: this is where
interference fringes and multipath fading (coverage maps) appear.

Transport is polarimetric: a forward beam carries a Stokes vector with
its transverse frame, and surface scatters apply the frame-aware Mueller
operator of the BSDF. The deferred coherent UTD sum is a scalar intensity
factor on the Stokes vector.

The JAX module's fori_loop over depth is a Python loop over a static
count here, with no host sync inside it. Every lane is computed at every
step, as in the JAX module; the ray queries trace only the rows they
read: the closest hit (K1) the lanes still walking, and the one batched
any-hit call of a step (K2, 3·(2K+1) segments per lane: the crossing,
continuation and FSD-NEE coherent sums) only the legs whose sum is read
(`need=`). In the Fraunhofer mode the ASF block runs in lane chunks of
FR_CHUNK, which bounds its (lanes × RIS proposals × aperture slots)
temporaries.
"""

from __future__ import annotations

import torch

from wave_tracer_tpu_torch.accel import edges as edges_mod
from wave_tracer_tpu_torch.accel import trace as trace_mod
from wave_tracer_tpu_torch.bsdf import device as bsdf_dev
from wave_tracer_tpu_torch.emitter import table as etab
from wave_tracer_tpu_torch.integrator.path import _perp_axis
from wave_tracer_tpu_torch.integrator.plt_bdpt import _blocked_flux
from wave_tracer_tpu_torch.integrator.plt_path import _where_lanes
from wave_tracer_tpu_torch.math import frame as frame_mod
from wave_tracer_tpu_torch.math import vec
from wave_tracer_tpu_torch.polarization import mueller, stokes
from wave_tracer_tpu_torch.sampling import rng
from wave_tracer_tpu_torch.util.stats import span
from wave_tracer_tpu_torch.wave import beam as beam_geo
from wave_tracer_tpu_torch.wave import envelope as env_mod
from wave_tracer_tpu_torch.wave import fraunhofer as fr
from wave_tracer_tpu_torch.wave import fsd as fsd_mod
from wave_tracer_tpu_torch.wave import sourcing

BIG = 1e30
Z_SCALE = 2.0
# RIS proposals of the Fraunhofer interaction: more than the bdpt walks
# use, since the t = 0 crossings are the image here and the winner must
# resolve the ASF's fringes
M_RIS_FORWARD = 32
# lanes per chunk of the Fraunhofer ASF block
FR_CHUNK = 1 << 16


def forward_scatter(S, xf, d_in, d_out, Mw):
    """Apply a BSDF Mueller operator to a forward Stokes vector.

    Mw is expressed in the S/P basis of the scattering plane (d_in,
    d_out); S is given w.r.t. transverse axis xf ⊥ d_in. Returns (S', xf')
    with xf' the scattering-plane s-axis (⊥ d_out too)."""
    s_axis = vec.cross(d_in, d_out)
    slen = torch.linalg.vector_norm(s_axis, dim=-1, keepdim=True)
    degen = slen[..., 0] < 1e-7
    s_axis = torch.where(degen[..., None], _perp_axis(d_in),
                         s_axis / slen.clamp_min(1e-12))
    S_in = stokes.reorient(S, xf, s_axis, d_in)
    return mueller.apply(Mw, S_in), s_axis


def _fsd_legs(edge_table, ap, ev, src, dst, hit_tri, src_tri):
    """The shadow segments of one coherent-sum evaluation: (a, b, ex1,
    ex2, ex3) of 2K+1 segments per lane (K src → edge legs, K edge → dst
    legs, the direct src → dst). Both edge legs exclude the edge's
    adjacent faces (they start or end on the edge); dst-side legs exclude
    the hit triangle and src-side legs the surface the segment starts on."""
    N, K = ap.valid.shape
    a = torch.cat([src[:, None, :].expand(N, K, 3).reshape(-1, 3),
                   ev["p"].reshape(-1, 3), src])
    b = torch.cat([ev["p"].reshape(-1, 3),
                   dst[:, None, :].expand(N, K, 3).reshape(-1, 3), dst])
    et1, et2 = fsd_mod.aperture_face_tris(edge_table, ap)
    none = torch.full_like(hit_tri, -1)
    ex1 = torch.cat([et1.reshape(-1), et1.reshape(-1), src_tri])
    ex2 = torch.cat([et2.reshape(-1), et2.reshape(-1), hit_tri])
    ex3 = torch.cat([src_tri[:, None].expand(N, K).reshape(-1),
                     hit_tri[:, None].expand(N, K).reshape(-1), none])
    return a, b, ex1, ex2, ex3


def _leg_need(ev, read):
    """The rows of one evaluation's 2K+1 legs whose result is read: the
    edge legs of surviving edge terms (coherent_sum masks with
    ev["valid"]) and the direct leg, on the lanes whose sum is `read`."""
    edge = (read[:, None] & ev["valid"]).reshape(-1)
    return torch.cat([edge, edge, read])


def _coherent_f(ev, occ, k, src, dst, ap_valid):
    """Coherent UTD intensity of one evaluation from its 2K+1 occlusion
    results; 1 where the aperture is empty or the sum is not finite."""
    N, K = ev["valid"].shape
    s1 = occ[:N * K].view(N, K)
    s2 = occ[N * K:2 * N * K].view(N, K)
    direct_vis = ap_valid & ~occ[2 * N * K:]
    ts, th = fsd_mod.coherent_sum(ev, k, src, dst, direct_vis, ~s1 & ~s2)
    f = fsd_mod.fsd_intensity(ts, th)
    return torch.where(ap_valid & torch.isfinite(f), f, 1.0)


def _fraunhofer(data, dkeys, k, ro, rd, env, eidx, z_int, fp_int, dist_src,
                tpl, inside, eps):
    """The Fraunhofer ASF interaction of every lane at z_int (the
    plt_bdpt t = 0 strategy): the aperture of the swept edges with the
    incident and detector-distance wavefront curvature, the blocked
    wavefront fraction and an RIS draw of the redirect (M_RIS_FORWARD
    proposals), in lane chunks of FR_CHUNK. Returns (wo (N, 3) world,
    valid, blocked, u_branch)."""
    N = ro.shape[0]
    M = M_RIS_FORWARD
    uR = rng.uniform(dkeys, rng.D_FSD, 4 * M + 2)
    out = []
    for s in range(0, N, FR_CHUNK):
        c = slice(s, s + FR_CHUNK)
        n = ro[c].shape[0]
        fpc = fp_int[c].clamp_min(1e-9)
        sigma = fpc / beam_geo.ENVELOPE
        fx = _perp_axis(rd[c])
        fy = vec.cross(rd[c], fx)
        wp = ro[c] + z_int[c, None] * rd[c]
        # wavefront quadratic phase: the incident spherical curvature
        # (R = path length since the last real scatter) plus the finite
        # sensing-plane distance L (the lens-less Fourier configuration)
        R_src = torch.maximum(dist_src[c] + z_int[c], 4.0 * fpc)
        L_det = tpl[c] - z_int[c]
        inv_L = torch.where(inside[c] & (L_det > 1e-6), 1.0 / L_det, 0.0)
        curv = 0.5 * k[c] * (1.0 / R_src + inv_L)
        fap, scale = fr.build_aperture_3d(data.edges, eidx[c], wp, rd[c], fx,
                                          fy, sigma, fpc, k[c], curv=curv)
        blocked = _blocked_flux(data.geo, ro[c], rd[c], fx, fy, z_int[c],
                                (Z_SCALE * fp_int[c]).clamp_min(4.0 * eps),
                                env.x0[c], env.ta[c], sigma,
                                tri_clusters=data.tri_clusters)
        xi, _, _, vs = fr.sample_xi_sir(
            fap, uR[c, :4 * M].reshape(n, M, 4), uR[c, 4 * M])
        wo_l, ok_wo = fr.xi_to_wo(xi, scale)
        out.append((wo_l[:, 0:1] * fx + wo_l[:, 1:2] * fy
                    + wo_l[:, 2:3] * rd[c],
                    fap.valid.any(1) & vs & ok_wo, blocked))
    return (torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out]),
            torch.cat([o[2] for o in out]), uR[:, 4 * M + 1])


def trace_forward(data, lane_ids, base_key, sample_ids, *, sensor,
                  edge_table, max_depth: int = 8, rr_depth: int = 3,
                  rr_floor: float = 0.5, eps: float = 1e-5,
                  fsd: bool = True, K: int = 8, fsd_mode: str = "utd",
                  debug: bool = False):
    """Forward light-trace batch.

    Each lane emits one beam and records its first virtual-plane crossing
    plus one FSD-NEE connection per bounce. Returns (splat_pos (N, 2),
    values (N, C), valid, sig (N,), (nee_pos (N·D, 2), nee_val (N·D, C),
    nee_ok (N·D,))) for the direct-splat film path; with debug, the final
    lane state too.

    fsd_mode selects the diffraction model: "utd", the plt_path deferred
    coherent UTD carry; "fraunhofer", the plt_bdpt Fraunhofer ASF
    interaction, whose coherent interference is in the sampled scatter
    directions, so crossings splat the plain beam weight (no any-hit
    call) and no FSD-NEE connection is made.

    Each depth step runs under the span wt.forward.step, its edge sweep
    under wt.forward.edges (util/stats.py).
    """
    geo = data.geo
    tables = data.tables
    et = data.emitters
    sp = data.spectral
    N = lane_ids.shape[0]
    dev = lane_ids.device
    f32 = torch.float32
    utd = fsd_mode != "fraunhofer"
    wave_utd = fsd and utd
    polarimetric = bool(getattr(sensor, "polarimetric", False))

    def full(val, dtype=f32, shape=()):
        return torch.full((N,) + shape, val, dtype=dtype, device=dev)

    keys = rng.sample_key(base_key, lane_ids, sample_ids)

    # spectral + emitter sampling (joint; a forward sample keeps the
    # emitter it drew)
    u_spec = rng.uniform(keys, rng.D_SPECTRUM, 2)
    e0, pmf_e = sp.sample_emitter(u_spec[:, 0])
    k, pdf_k = sp.sample_k(e0, u_spec[:, 1])
    w_spectral = 1.0 / (pmf_e * pdf_k).clamp_min(1e-30)

    # emission beam
    u_em = torch.cat([rng.uniform(keys, rng.D_EMITTER_POS, 3),
                      rng.uniform(keys, rng.D_EMITTER_DIR, 1)], dim=-1)
    em = etab.sample_emission(et, geo, tables.spectra, e0, k, u_em)
    W_sens = sensor.importance()
    plane_o, plane_xa, plane_ya, plane_n = sensor._basis_on(dev)
    plane_area = float(sensor.extent[0] * sensor.extent[1])
    elem_m = sensor.extent[0] / sensor.width
    scene_radius = et.scene_radius

    # beam envelope sourced from the emitter's phase-space scale
    se_mub, ta_mub = sourcing.source_emitter_mub(et, e0, k)
    D = max_depth
    st = dict(
        ro=em["y"], rd=em["wo"],
        S=stokes.unpolarized(em["weight"] * w_spectral),  # (N, 4)
        xf=_perp_axis(em["wo"]),
        acc=full(0.0, shape=(4,)),     # crossing Stokes splat
        pos=full(0.0, shape=(2,)),     # splat element position
        sig=full(0.25),                # splat σ in elements
        hit_plane=full(False, torch.bool),
        active=em["valid"],
        exclude=full(-1, torch.int32),
        env=env_mod.EnvState(x=_perp_axis(em["wo"]),
                             x0=torch.sqrt(se_mub.clamp_min(0.0)),
                             ta=ta_mub, e=full(1.0)),
        fsd_ap=fsd_mod.empty_aperture(N, K, device=dev),
        fsd_valid=full(False, torch.bool),
        sampled_fsd=full(False, torch.bool),
        # path length since the last real scatter (null restarts move the
        # origin without a physical event): the incident wavefront
        # curvature radius at the next interaction
        dist_src=full(0.0),
        prev_vert=em["y"],
        S_prev=full(0.0, shape=(4,)),
    )
    # FSD-NEE records, one per depth
    nee_pos = full(0.0, shape=(D, 2))
    nee_val = full(0.0, shape=(D, 4))
    nee_ok = full(False, torch.bool, (D,))
    none = full(-1, torch.int32)

    for depth in range(D):
        with span("wt.forward.step"):
            dkeys = rng.depth_key(keys, depth)
            ro, rd, env = st["ro"], st["rd"], st["env"]
            lane = st["active"]

            # lanes that ended keep a miss: nothing below reads their hit
            t, tri, u, v = trace_mod.trace(geo, ro, rd, full(eps), full(BIG),
                                           st["exclude"], need=lane)
            hit = trace_mod.hit_attributes(geo, ro, rd, t, tri, u, v)
            seg_end = torch.where(hit.valid, hit.t, BIG)

            # ---- edge sweep (conservative major-axis radius)
            zmax = torch.where(hit.valid, hit.t * 1.02 + env.x0,
                               8.0 * scene_radius)
            with span("wt.forward.edges"):
                if fsd and edge_table.count > 0:
                    eidx, ez, ecnt = edges_mod.edges_in_cone(
                        edge_table, data.edge_clusters, ro, rd, env, zmax,
                        K)
                else:
                    eidx = full(-1, torch.int32, (K,))
                    ez = full(torch.inf, shape=(K,))
                    ecnt = full(0, torch.int32)
            have_edges = ecnt > 0
            z_first = torch.where(have_edges, ez.min(1).values, BIG)
            fp_hit = env.major(torch.where(hit.valid, hit.t, 0.0))
            delta_hit = (Z_SCALE * fp_hit).clamp_min(4.0 * eps)
            midflight = have_edges & (z_first < torch.where(
                hit.valid, hit.t - delta_hit, BIG))
            surface = lane & hit.valid & ~midflight
            z_int = torch.where(surface, hit.t, z_first)
            has_interaction = lane & (surface | midflight)
            wp = ro + z_int[:, None] * rd
            fp_int = env.major(z_int)

            # ---- sensing geometry: does this segment cross the plane?
            tpl, pxy, inside, cos_in = sensor.intersect(ro, rd)
            crosses = lane & inside & (tpl > eps) \
                & (tpl < torch.minimum(seg_end, z_int + delta_hit)) \
                & (cos_in > 0)
            newly = crosses & ~st["hit_plane"]
            plane_p = ro + tpl[:, None] * rd

            # ---- aperture of this interaction (read by FSD-NEE below)
            if wave_utd:
                ap_now = fsd_mod.build_aperture(edge_table, eidx, wp, -rd,
                                                Z_SCALE * fp_int)
            else:
                ap_now = fsd_mod.empty_aperture(N, K, device=dev)
            ap_nee_ok = ap_now.any_valid()

            # ---- FSD-NEE target: a sampled sensor point
            sp_pt, sp_pxy, _, _ = sensor.sample_point(
                rng.uniform(dkeys, rng.D_SENSOR, 2))
            nee_dir = sp_pt - wp
            nee_dist = vec.safe_length(nee_dir)
            nee_dirn = nee_dir / nee_dist.clamp_min(1e-20)[:, None]
            nee_cos = -(nee_dirn * plane_n).sum(-1)

            # ---- all coherent-sum shadow segments in ONE any-hit call: (a)
            # the crossing modulation, (b) the continuing-beam modulation,
            # (c) FSD-NEE through the new aperture
            fsd_valid = st["fsd_valid"]
            if wave_utd:
                prev = st["prev_vert"]
                dst_seg = torch.where(has_interaction[:, None], wp,
                                      ro + (4.0 * scene_radius) * rd)
                ev_cross = fsd_mod.fsd_eval(st["fsd_ap"], k, prev, plane_p)
                ev_cont = fsd_mod.fsd_eval(st["fsd_ap"], k, prev, dst_seg)
                ev_nee = fsd_mod.fsd_eval(ap_now, k, ro, sp_pt)
                nee_read = has_interaction & ap_nee_ok & (nee_cos > 0)
                blocks = [
                    _fsd_legs(edge_table, st["fsd_ap"], ev_cross, prev,
                              plane_p, hit.tri, none),
                    _fsd_legs(edge_table, st["fsd_ap"], ev_cont, prev, dst_seg,
                              hit.tri, none),
                    _fsd_legs(edge_table, ap_now, ev_nee, ro, sp_pt, none,
                              st["exclude"])]
                a_all, b_all, ex1, ex2, ex3 = (torch.cat(x)
                                               for x in zip(*blocks))
                seg = b_all - a_all
                seg_d = vec.safe_length(seg)
                occ = trace_mod.occluded(
                    geo, a_all, seg / seg_d.clamp_min(1e-20)[:, None],
                    torch.full_like(seg_d, eps), seg_d - 2.0 * eps,
                    ex1, ex2, ex3,
                    need=torch.cat([_leg_need(ev_cross, newly & fsd_valid),
                                    _leg_need(ev_cont, fsd_valid),
                                    _leg_need(ev_nee, nee_read)]))
                Mseg = N * (2 * K + 1)
                f_cross = _coherent_f(ev_cross, occ[:Mseg], k, prev, plane_p,
                                      fsd_valid)
                f_cont = _coherent_f(ev_cont, occ[Mseg:2 * Mseg], k, prev,
                                     dst_seg, fsd_valid)
                f_nee = _coherent_f(ev_nee, occ[2 * Mseg:], k, ro, sp_pt,
                                    ap_nee_ok)
                ap_w_max = torch.where(ap_now.valid, ap_now.w,
                                       0.0).max(1).values
            else:
                f_cross = f_cont = full(1.0)
                f_nee = ap_w_max = full(0.0)

            def deferred(Scur, f):
                """Two-beam deferred superposition."""
                return torch.where(
                    fsd_valid[:, None],
                    torch.where(st["sampled_fsd"][:, None], Scur * f[:, None],
                                Scur + st["S_prev"] * f[:, None]), Scur)

            # ---- crossing splat (first crossing per lane), in the plane's
            # transverse frame for Q/U consistency
            px_perp = vec.normalize(
                plane_xa - (plane_xa * rd).sum(-1)[:, None] * rd, eps=1e-12)
            S_cross = stokes.reorient(deferred(st["S"], f_cross), st["xf"],
                                      px_perp, rd)
            # anisotropy-aware: isotropic-equivalent radius sqrt(major·minor)
            sig_el = (env.area_radius(tpl) / 3.0) / elem_m
            acc = torch.where(newly[:, None], S_cross * W_sens, st["acc"])
            pos = torch.where(newly[:, None], pxy, st["pos"])
            sig = torch.where(newly, sig_el, st["sig"])
            hit_plane = st["hit_plane"] | crosses

            # ---- FSD-NEE splat: connection weight W·f·A/dist², visibility
            # inside the coherent sum, faded by the aperture's strongest
            # boundary window
            S_int = deferred(st["S"], f_cont)
            nee_w = f_nee * W_sens * plane_area * ap_w_max.clamp_max(1.0) \
                / (nee_dist * nee_dist).clamp_min(1e-12)
            nx_perp = vec.normalize(
                plane_xa - (plane_xa * nee_dirn).sum(-1)[:, None] * nee_dirn,
                eps=1e-12)
            S_nee = stokes.reorient(S_int, st["xf"], nx_perp, nee_dirn) \
                * nee_w[:, None]
            ok_nee = has_interaction & ap_nee_ok & (nee_cos > 0) \
                & (f_nee > 0) & torch.isfinite(nee_w)
            if not wave_utd:
                ok_nee = torch.zeros_like(ok_nee)
            nee_pos[:, depth] = sp_pxy
            nee_val[:, depth] = torch.where(ok_nee[:, None], S_nee, 0.0)
            nee_ok[:, depth] = ok_nee

            # ---- surface interaction (frame-aware Mueller on the Stokes)
            sf = frame_mod.build_shading_frame(hit.ns, hit.dpdu)
            sf = bsdf_dev.apply_normalmap(tables, hit.mat_id, hit.uv, k, sf)
            wi_l = sf.to_local(-rd)
            u_b = torch.cat([rng.uniform(dkeys, rng.D_BSDF_LOBE, 2),
                             rng.uniform(dkeys, rng.D_BSDF_DIR, 2)], dim=-1)
            bs = bsdf_dev.sample(tables, hit.mat_id, wi_l, hit.uv, k, u_b)
            wo_surface = sf.to_world(bs.wo)
            S_surf, xf_surf = forward_scatter(S_int, st["xf"], rd, wo_surface,
                                              bs.Mw)
            env_surf, _ = env_mod.surface_scatter(env, rd, z_int, hit.geo_n,
                                                  wo_surface, bs.specular, k)

            # ---- FSD interaction
            if wave_utd:
                u_fsd = torch.cat([rng.uniform(dkeys, rng.D_FSD, 2),
                                   rng.uniform(dkeys, rng.D_PHASE, 2)], dim=-1)
                fsmp = fsd_mod.fsd_sample(ap_now, k, ro, wp, u_fsd)
                wo_fsd, p_fsd = fsmp["wo"], fsmp["p"]
                w_fsd = torch.where(fsmp["is_direct"],
                                    (ap_now.count() + 1).to(f32),
                                    1.0 / fsmp["pdf"].clamp_min(1e-20))
                fsd_lane = midflight & fsmp["valid"]
            elif fsd:
                # Fraunhofer: the direction follows the coherent ASF, and the
                # continuation carries only the unobstructed wavefront
                # fraction (1 − blocked), deterministically; a lane whose
                # central ray hits a region triangle redirects through the
                # same ASF at full weight with probability (1 − blocked),
                # else takes the surface event (the flux-consistent
                # partition of the JAX module)
                wo_fsd, ok_fr, blocked, u_branch = _fraunhofer(
                    data, dkeys, k, ro, rd, env, eidx, z_int, fp_int,
                    st["dist_src"], tpl, inside, eps)
                p_fsd = wp
                redirect_surf = surface & have_edges & ok_fr \
                    & (u_branch >= blocked)
                w_fsd = torch.where(redirect_surf, 1.0, 1.0 - blocked)
                fsd_lane = (midflight & ok_fr) | redirect_surf
            else:
                wo_fsd, p_fsd = rd, wp
                w_fsd = full(1.0)
                fsd_lane = full(False, torch.bool)

            null_lane = midflight & ~fsd_lane
            # surface lanes redirected through the aperture leave the surface
            # partition entirely
            surface_eff = surface & ~fsd_lane
            surf3, fsd3 = surface_eff[:, None], fsd_lane[:, None]
            ro_new = torch.where(surf3, hit.p, torch.where(fsd3, p_fsd, wp))
            rd_new = torch.where(surf3, wo_surface,
                                 torch.where(fsd3, wo_fsd, rd))
            S_new = torch.where(surf3, S_surf, S_int * torch.where(
                fsd_lane, w_fsd, 1.0)[:, None])
            xf_new = torch.where(surf3, xf_surf, torch.where(
                fsd3, _perp_axis(rd_new), st["xf"]))
            exclude_new = torch.where(surface, hit.tri, st["exclude"])
            env_fsd = sourcing.restart_envelope(rd_new, fp_int, k)
            env_null = env_mod.EnvState(x=env.x, x0=fp_int, ta=env.ta, e=env.e)
            env_new = env_mod.select(
                surface_eff, env_surf,
                env_mod.select(fsd_lane, env_fsd, env_null))

            # ---- russian roulette (not on null continuation)
            u_rr = rng.uniform(dkeys, rng.D_RR)
            q = (S_new[:, 0].abs() / st["S"][:, 0].abs().clamp_min(1e-30)
                 ).clamp(rr_floor, 1.0)
            do_rr = ~null_lane if depth >= rr_depth else torch.zeros_like(lane)
            survive = torch.where(do_rr, u_rr < q, True)
            S_new = S_new / torch.where(do_rr, q, 1.0)[:, None]

            cont = (surface_eff & bs.valid) | fsd_lane | null_lane
            active = lane & cont & survive & (S_new[:, 0].abs() > 1e-25) \
                & torch.isfinite(S_new[:, 0])

            def sel(new, old):
                return _where_lanes(active, new, old)

            st = dict(
                ro=sel(ro_new, ro), rd=sel(rd_new, rd), S=sel(S_new, st["S"]),
                xf=sel(xf_new, st["xf"]), acc=acc, pos=pos, sig=sig,
                hit_plane=hit_plane, active=active,
                exclude=sel(exclude_new, st["exclude"]),
                env=env_mod.select(active, env_new, env),
                fsd_ap=fsd_mod.FsdAperture(**{
                    name: sel(new, old) for (name, new), (_, old)
                    in zip(ap_now.items(), st["fsd_ap"].items())}),
                fsd_valid=active & (fsd & has_interaction & ap_nee_ok),
                sampled_fsd=sel(fsd_lane, st["sampled_fsd"]),
                dist_src=sel(torch.where(null_lane, st["dist_src"] + z_int,
                                         0.0), st["dist_src"]),
                # the deferred coherent sum runs from the segment origin
                prev_vert=sel(ro, st["prev_vert"]),
                S_prev=sel(S_int, st["S_prev"]),
            )

    sens = sensor.response.sensitivities(k, tables.spectra, None)

    def to_channels(S4):
        """Stokes (N, ..., 4) → film channels (N, ..., C or C·4);
        polarimetric films interleave I/Q/U/V per channel."""
        s = sens
        while s.dim() < S4.dim():
            s = s[:, None]
        if polarimetric:
            out = S4[..., None, :] * s[..., None]       # (..., C, 4)
            return out.reshape(S4.shape[:-1] + (-1,))
        return S4[..., 0:1] * s

    out = (st["pos"], to_channels(st["acc"]), st["hit_plane"], st["sig"],
           (nee_pos.reshape(N * D, 2),
            to_channels(nee_val).reshape(N * D, -1), nee_ok.reshape(N * D)))
    if debug:
        return out + (dict(st, nee_pos=nee_pos, nee_val=nee_val,
                           nee_ok=nee_ok),)
    return out
