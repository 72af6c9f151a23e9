"""Backward unidirectional path integrator over fixed lanes.

Port of wave_tracer_tpu/integrator/path.py (trace_paths, classical_bounce
and their helpers, plus the device-counter layout). Every lane carries a
full Mueller throughput operator, one sampled wavenumber and MIS
bookkeeping; all control flow is masked lane arithmetic. One bounce:
trace (K1) → emission MIS → NEE with one shadow ray (K2, power-heuristic
MIS) → BSDF sample → russian roulette.

`trace_paths` runs the bounce max_depth times over one batch of lanes,
as the JAX package's fori_loop does; it is differentiable: make a float
table of the SceneData require grad (reverse mode) or give it a tangent
(`torch.autograd.forward_ad`), and the pixel values carry the
derivative. Discrete decisions (hits, lobe, emitter and RR picks) and
sampled directions carry none; the hit distance carries the
Möller–Trumbore derivative of the winning triangle
(`accel.ray_kernels.trace_rays`).
"""

from __future__ import annotations

import torch

from wave_tracer_tpu_torch.accel import trace as trace_mod
from wave_tracer_tpu_torch.bsdf import device as bsdf_dev
from wave_tracer_tpu_torch.emitter import table as etab
from wave_tracer_tpu_torch.math import frame as frame_mod
from wave_tracer_tpu_torch.math import vec
from wave_tracer_tpu_torch.polarization import mueller, stokes
from wave_tracer_tpu_torch.sampling import rng
from wave_tracer_tpu_torch.util.stats import span

BIG = 1e30

# device-counter layout (the JAX package's N_STATS vector)
STAT_RAYS = 0          # primary/bounce traces issued
STAT_SHADOW = 1        # shadow rays issued
STAT_SURFACE = 2       # surface interactions
STAT_FSD = 3           # free-space-diffraction interactions
STAT_NULL = 4          # null interactions (region restarts)
STAT_RR_KILL = 5       # lanes terminated by russian roulette
STAT_DEPTH_SUM = 6     # Σ completed path depths (mean = /paths)
STAT_EDGE_HIT = 7      # lanes whose envelope swept ≥1 edge
STAT_BALLISTIC = 8     # hybrid traversal: ballistic interactions
STAT_DIFFUSIVE = 9     # hybrid traversal: diffusive (cone) interactions
STAT_TRI_TESTS = 10    # ray-triangle pair tests issued
STAT_CONE_TESTS = 11   # exact cone-triangle tests issued
STAT_TRI_HIST0 = 12    # tris-per-cone log2 histogram, 8 bins
N_TRI_HIST = 8
N_STATS = STAT_TRI_HIST0 + N_TRI_HIST


def tri_hist_bin(count):
    """Log2 bin index of a tris-per-cone count (0 for none)."""
    c = count.clamp_min(0)
    b = 1 + torch.ceil(torch.log2(c.to(torch.float32).clamp_min(1.0))
                       ).to(torch.int64)
    return torch.where(c == 0, 0, b).clamp_max(N_TRI_HIST - 1)


def _power_heuristic(a, b):
    a2 = a * a
    return a2 / (a2 + b * b).clamp_min(1e-30)


def _perp_axis(d):
    """Any unit vector ⊥ d (for degenerate scattering planes)."""
    return frame_mod.build_orthogonal_frame(d).t


def compose_scatter(M_old, x_old, d_out, M_b, d_in):
    """Frame-aware Mueller composition at a scatter vertex.

    M_b is expressed in the S/P basis of the scattering plane spanned by
    the incoming light direction d_in and outgoing d_out (light flows
    d_in → d_out toward the sensor). M_old expects its input Stokes with
    transverse x-axis x_old ⊥ d_out. Returns (M_new, x_new): the composed
    operator and its input frame axis (⊥ d_in)."""
    s_axis = vec.cross(d_in, d_out)
    slen = torch.linalg.vector_norm(s_axis, dim=-1, keepdim=True)
    degen = slen[..., 0] < 1e-7
    s_axis = torch.where(degen[..., None], _perp_axis(d_out),
                         s_axis / slen.clamp_min(1e-12))
    theta = stokes.rotation_angle(s_axis, x_old, d_out)
    R = mueller.rotation(theta)
    return M_old @ R @ M_b, s_axis


def _contribution(M, Li):
    """Stokes vector reaching the sensor for unpolarized light Li: M @
    (Li, 0, 0, 0)."""
    return M[..., 0] * Li[..., None]


def _emitter_pmf(et, emitter_id):
    tot = et.power.sum().clamp_min(1e-30)
    p = et.power[emitter_id.clamp_min(0).long()] / tot
    return torch.where(emitter_id >= 0, p, torch.zeros_like(p))


def _sample_emitter_by_power(et, u):
    cdf = torch.cumsum(et.power, dim=0)
    tot = cdf[-1].clamp_min(1e-30)
    e = torch.searchsorted(cdf / tot, u.contiguous(), right=True)
    e = e.clamp(0, et.count - 1)
    return e.to(torch.int32), et.power[e] / tot


def bsdf_uniforms(tables, dkeys, u_dir):
    """The four uniforms of `bsdf.sample`: the lobe pair (D_BSDF_LOBE),
    then the direction pair. The lobe pair is drawn only for a table whose
    rows read it (dielectric, surface_spm or masked rows): the diffuse and
    null lobes read only the direction pair, and the sampler is stateless
    per dimension, so leaving it undrawn shifts no other draw."""
    mat = tables.materials
    if mat.has_dielectric or mat.has_spm or mat.has_mask:
        lobe = rng.uniform(dkeys, rng.D_BSDF_LOBE, 2)
    else:
        lobe = torch.zeros_like(u_dir)
    return torch.cat([lobe, u_dir], dim=-1)


def camera_lanes(data, sensor, pixel_xy, jitter, keys):
    """Fresh camera-ray lanes for the (pixel, sample) streams `keys`:
    the spectral sample, the camera ray and the lane state a bounce
    reads. Returns (state, k, w_spectral, pixel_tan_alpha)."""
    sp = data.spectral
    n = pixel_xy.shape[0]
    dev = pixel_xy.device
    u_spec = rng.uniform(keys, rng.D_SPECTRUM, 2)
    e0, _ = sp.sample_emitter(u_spec[:, 0])
    k, _ = sp.sample_k(e0, u_spec[:, 1])
    w_spectral = 1.0 / sp.joint_spectral_density(k).clamp_min(1e-30)
    ro, rd, pixel_tan_alpha = sensor.generate_rays(pixel_xy, jitter)
    M0 = torch.eye(4, dtype=torch.float32, device=dev).expand(
        n, 4, 4) * sensor.importance()
    state = dict(ro=ro.contiguous(), rd=rd, M=M0.contiguous(),
                 xf=_perp_axis(-rd),
                 L=torch.zeros((n, 4), dtype=torch.float32, device=dev),
                 active=torch.ones((n,), dtype=torch.bool, device=dev),
                 exclude=torch.full((n,), -1, dtype=torch.int32,
                                    device=dev),
                 prev_pdf=torch.zeros((n,), dtype=torch.float32, device=dev),
                 prev_specular=torch.ones((n,), dtype=torch.bool,
                                          device=dev))
    return state, k, w_spectral, pixel_tan_alpha


def sensor_values(L, w_spectral, sens, polarimetric):
    """Response-weighted channel values of the accumulated Stokes vectors
    L (N, 4); a polarimetric sensor gets all four Stokes components per
    channel (I/Q/U/V interleaved)."""
    Lw = L * w_spectral[:, None]
    if polarimetric:
        return (Lw[:, None, :] * sens[..., None]).reshape(Lw.shape[0], -1)
    return Lw[:, 0:1] * sens


def trace_paths(data, pixel_xy, jitter, base_key, sample_ids, *, sensor,
                max_depth: int = 8, rr_depth: int = 3,
                rr_floor: float = 0.5, eps: float = 1e-5, mis: bool = True,
                with_stats: bool = False):
    """Trace one batch of backward paths: `max_depth` classical bounces
    over fixed lanes. pixel_xy (N, 2) int, jitter (N, 2), sample_ids
    (N,). Returns (pos (N, 2) splat positions, values (N, C), valid
    (N,)); with_stats appends the (N_STATS,) f32 counter vector."""
    N = pixel_xy.shape[0]
    pixel_id = pixel_xy[:, 1] * sensor.width + pixel_xy[:, 0]
    keys = rng.sample_key(base_key, pixel_id, sample_ids)
    st, k, w_spectral, _ = camera_lanes(data, sensor, pixel_xy, jitter,
                                        keys)
    st["stats"] = torch.zeros((N_STATS,), dtype=torch.float32,
                              device=pixel_xy.device)
    splat_pos = pixel_xy.to(torch.float32) + jitter
    for depth in range(max_depth):
        st = classical_bounce(data, st, rng.depth_key(keys, depth), k,
                              depth, eps=eps, mis=mis, rr_depth=rr_depth,
                              rr_floor=rr_floor, with_stats=with_stats)
    sens = sensor.response.sensitivities(k, data.tables.spectra, None)
    values = sensor_values(st["L"], w_spectral, sens,
                           bool(getattr(sensor, "polarimetric", False)))
    valid = torch.ones((N,), dtype=torch.bool, device=pixel_xy.device)
    if with_stats:
        return splat_pos, values, valid, st["stats"]
    return splat_pos, values, valid


def carried_hit(st):
    """The need/carry arguments of a bounce's trace: a lane whose ray is
    still the one its carried hit (hit_t, hit_tri) was traced for
    (hit_current) keeps that hit untraced. {} (trace every lane) for a
    state that carries no hit."""
    if "hit_current" not in st:
        return {}
    return dict(need=~st["hit_current"], carry=(st["hit_t"], st["hit_tri"]))


def next_carried_hit(st, t, tri, active):
    """The carried hit after a bounce that traced (t, tri): the bounce
    writes a new ray (ro, rd, exclude) on the lanes it keeps `active`, so
    their hit goes stale; every other lane keeps its ray and this hit."""
    if "hit_current" not in st:
        return {}
    return dict(hit_t=t, hit_tri=tri, hit_current=~active)


def classical_bounce(data, st, dkeys, k, depth, *, eps, mis, rr_depth,
                     rr_floor, with_stats=False):
    """One classical bounce over the lane state dict (ro, rd, M, xf, L,
    active, exclude, prev_pdf, prev_specular, stats, and optionally the
    carried hit hit_t, hit_tri, hit_current). `depth` is an int or a
    per-lane tensor. Returns the new state dict. Its stages run, in turn,
    under the spans wt.bounce.trace, .nee and .scatter (util/stats.py)."""
    geo = data.geo
    tables = data.tables
    et = data.emitters
    N = st["L"].shape[0]
    dev = st["L"].device
    eps_v = torch.full((N,), eps, dtype=torch.float32, device=dev)

    with span("wt.bounce.trace"):
        t, tri, u, v = trace_mod.trace(
            geo, st["ro"], st["rd"], eps_v,
            torch.full((N,), BIG, dtype=torch.float32, device=dev),
            st["exclude"], **carried_hit(st))
        hit = trace_mod.hit_attributes(geo, st["ro"], st["rd"], t, tri, u, v)
        lane = st["active"] & hit.valid

    with span("wt.bounce.nee"):
        sf = frame_mod.build_shading_frame(hit.ns, hit.dpdu)
        sf = bsdf_dev.apply_normalmap(tables, hit.mat_id, hit.uv, k, sf)
        wi = -st["rd"]
        wi_l = sf.to_local(wi)
        one = torch.ones_like(k)
        zero4 = torch.zeros_like(st["L"])

        # --- emission (hit an area emitter from the front)
        cos_out = vec.dot(wi, hit.geo_n)
        Le = etab.emission_radiance(et, tables.spectra, hit.emitter_id, k,
                                    cos_out)
        d2 = hit.t.clamp_min(1e-9) ** 2
        pdf_nee_same = etab.pdf_direct_solid_angle(
            et, hit.emitter_id, d2, cos_out) * _emitter_pmf(et, hit.emitter_id)
        w_mis_e = one if not mis else torch.where(
            st["prev_specular"], one,
            _power_heuristic(st["prev_pdf"], pdf_nee_same))
        dL_e = torch.where((lane & (Le > 0))[:, None],
                           w_mis_e[:, None] * _contribution(st["M"], Le),
                           zero4)
        L = st["L"] + dL_e

        # --- NEE
        u_pick = rng.uniform(dkeys, rng.D_EMITTER_PICK)
        e_n, pmf_n = _sample_emitter_by_power(et, u_pick)
        u_nee = rng.uniform(dkeys, rng.D_NEE, 3)
        nee = etab.sample_direct(et, geo, tables.spectra, e_n, hit.p, k, u_nee)
        wo_nee_l = sf.to_local(nee["wo"])
        f_nee, pdf_b_nee = bsdf_dev.eval_f(tables, hit.mat_id, wi_l, wo_nee_l,
                                           hit.uv, k)
        occ = trace_mod.occluded(geo, hit.p, nee["wo"], eps_v,
                                 nee["dist"] - 2.0 * eps, hit.tri, nee["tri"])
        pdf_nee = pmf_n * nee["pdf_sa"]
        w_mis_n = one if not mis else torch.where(
            nee["delta_dir"], one, _power_heuristic(pdf_nee, pdf_b_nee))
        M_nee, _ = compose_scatter(st["M"], st["xf"], -st["rd"], f_nee,
                                   -nee["wo"])
        c_nee = _contribution(M_nee, nee["Li"]) \
            / pdf_nee.clamp_min(1e-30)[:, None]
        ok_nee = lane & nee["valid"] & ~occ & (pdf_nee > 0) \
            & (f_nee[:, 0, 0] > 0)
        L = L + torch.where(ok_nee[:, None], w_mis_n[:, None] * c_nee, zero4)

    with span("wt.bounce.scatter"):
        # --- BSDF sampling / continuation
        u_b = bsdf_uniforms(tables, dkeys,
                            rng.uniform(dkeys, rng.D_BSDF_DIR, 2))
        bs = bsdf_dev.sample(tables, hit.mat_id, wi_l, hit.uv, k, u_b)
        wo_w = sf.to_world(bs.wo)
        M_next, xf_next = compose_scatter(st["M"], st["xf"], -st["rd"], bs.Mw,
                                          -wo_w)

        # --- russian roulette (floor .5)
        u_rr = rng.uniform(dkeys, rng.D_RR)
        beta = M_next[:, 0, 0].abs()
        q = beta.clamp(rr_floor, 1.0)
        do_rr = torch.as_tensor(depth, device=dev) >= rr_depth
        survive = torch.where(do_rr, u_rr < q, torch.ones_like(lane))
        M_next = M_next / torch.where(do_rr, q, one)[:, None, None]

        active = lane & bs.valid & survive & (beta > 1e-9)
        stats = st["stats"]
        if with_stats:
            f32 = torch.float32
            nlane = lane.sum(dtype=f32)
            add = torch.zeros((N_STATS,), dtype=f32, device=dev)
            add[STAT_RAYS] = st["active"].sum(dtype=f32)
            add[STAT_SHADOW] = nlane
            add[STAT_SURFACE] = nlane
            add[STAT_RR_KILL] = (lane & bs.valid & ~survive).sum(dtype=f32)
            add[STAT_DEPTH_SUM] = active.sum(dtype=f32)
            add[STAT_TRI_TESTS] = 2.0 * N * trace_mod.ray_tests_per_lane(geo)
            stats = stats + add
        act3 = active[:, None]
        return dict(
            ro=torch.where(act3, hit.p, st["ro"]),
            rd=torch.where(act3, wo_w, st["rd"]),
            M=torch.where(active[:, None, None], M_next, st["M"]),
            xf=torch.where(act3, xf_next, st["xf"]),
            L=L,
            active=active,
            exclude=torch.where(active, hit.tri, st["exclude"]),
            prev_pdf=torch.where(active, bs.pdf, st["prev_pdf"]),
            prev_specular=torch.where(active, bs.specular,
                                      st["prev_specular"]),
            stats=stats,
            **next_carried_hit(st, t, tri, active),
        )
