"""plt_bdpt — bidirectional path tracing over lane-stacked subpath vertex
arrays, with Fraunhofer free-space diffraction.

Port of wave_tracer_tpu/integrator/plt_bdpt.py. Per lane a camera subpath
and an emitter subpath are walked and stored as fixed-capacity (N, V, ...)
vertex arrays (position, normals, throughput, forward/reverse area pdfs,
delta flags, and each FSD vertex's aperture); every (s, t) strategy is
then connected with one shadow ray and weighted by the balance heuristic
from per-lane MIS chain tables.

The walks carry a beam envelope and diffract at mid-flight interaction
regions: the edges inside the swept envelope form a Fraunhofer aperture
(wave/fraunhofer.py), the un-blocked beam power normalizes the ASF, and an
unbiased RIS draw redirects the beam. FSD vertices serve as connection
endpoints through their stored aperture. The camera subpath composes
frame-aware Mueller operators, the light subpath carries Stokes vectors;
light-tracing (t = 1) splats are returned separately for the light image.
A polarimetric sensor's values are all four Stokes components per
response channel (I/Q/U/V interleaved).

The JAX module's fori_loops over walk steps, s = 0 strategies, the
S·(T+1) connections and the t = 1 splats are Python loops over static
counts here, so a slot index is a Python int. Every ray query goes
through accel.trace: the walk's closest hits (K1) trace only the lanes
still walking, and every shadow ray (K2) only the rows whose strategy
reads it (`need=`); the other rows' results are never read. In the same
way the FSD interaction is formed only for the lanes of a walk step that
reach a mid-flight region, and an FSD vertex's ASF only for the lanes
whose vertex it is. The JAX module's `debug_buckets` output is not
ported.
"""

from __future__ import annotations

import math

import torch

from wave_tracer_tpu_torch.accel import edges as edges_mod
from wave_tracer_tpu_torch.accel import trace as trace_mod
from wave_tracer_tpu_torch.bsdf import device as bsdf_dev
from wave_tracer_tpu_torch.emitter import table as etab
from wave_tracer_tpu_torch.integrator.path import (
    N_STATS, STAT_DEPTH_SUM, STAT_EDGE_HIT, STAT_FSD, STAT_NULL, STAT_RAYS,
    STAT_SHADOW, STAT_SURFACE, _perp_axis, _sample_emitter_by_power,
    bsdf_uniforms, compose_scatter)
from wave_tracer_tpu_torch.math import frame as frame_mod
from wave_tracer_tpu_torch.math import gaussian2d as g2d
from wave_tracer_tpu_torch.math import vec
from wave_tracer_tpu_torch.polarization import stokes as stokes_mod
from wave_tracer_tpu_torch.sampling import rng
from wave_tracer_tpu_torch.wave import beam as beam_geo
from wave_tracer_tpu_torch.wave import envelope as env_mod
from wave_tracer_tpu_torch.wave import fraunhofer as fr
from wave_tracer_tpu_torch.wave import sourcing

BIG = 1e30
Z_SCALE = 2.0          # interaction-region half-depth / footprint
M_RIS = 8              # RIS proposals per FSD interaction
K_TRI = 8              # region triangles for the blocked-flux integral
SUBDIV = 3             # aperture segments per swept edge


def _emit_at(arr, cur, val, do, rows=None):
    """arr[n, cur[n]] = val[n] where do[n] and cur[n] < V: a per-lane slot
    write of (N, V, ...) storage (one gather, one scatter). With `rows`,
    val and do hold only those lanes."""
    V = arr.shape[1]
    if rows is None:
        rows = torch.arange(arr.shape[0], device=arr.device)
    else:
        cur = cur[rows]
    slot = cur.clamp(0, V - 1).long()
    sel = (do & (cur < V)).view(do.shape + (1,) * (val.dim() - 1))
    arr[rows, slot] = torch.where(sel, val, arr[rows, slot])


def _safe_cross(a, b):
    s = vec.cross(a, b)
    ln = torch.linalg.vector_norm(s, dim=-1, keepdim=True)
    return torch.where(ln < 1e-7, _perp_axis(a), s / ln.clamp_min(1e-12))


def _tangent_of(n):
    return frame_mod.build_orthogonal_frame(n).t


def _select(cond, a, b):
    """Per-lane select for tensors of any rank (lanes first)."""
    return torch.where(cond.view(cond.shape + (1,) * (a.dim() - 1)), a, b)


def _blocked_flux(geo, ro, rd, fx, fy, z_int, dz, x0, ta, sigma,
                  tri_clusters=None):
    """Fraction of beam power blocked by geometry inside the interaction
    region: ball-query triangles (through `tri_clusters` above
    `trace.tri_cluster_min()` triangles, as the JAX integrators route it),
    clip them to the z-slab in beam coordinates, cone-project onto the
    cross-section, and integrate the Gaussian wavefront over each clipped
    polygon."""
    N = ro.shape[0]
    r_env = x0 + ta * z_int
    r_ball = torch.sqrt(r_env ** 2 + dz ** 2) * 1.05
    wp = ro + z_int[:, None] * rd
    if tri_clusters is not None \
            and geo.num_tris > trace_mod.tri_cluster_min(wp.device):
        idx, _, _ = trace_mod.tris_in_ball_clustered(geo, tri_clusters, wp,
                                                     r_ball, K_TRI)
    else:
        idx, _, _ = trace_mod.tris_in_ball(geo, wp, r_ball, K_TRI)
    i = idx.clamp_min(0).long()
    ok = idx >= 0

    def to_local(v):
        w = v - ro[:, None, :]
        return torch.stack([(w * fx[:, None, :]).sum(-1),
                            (w * fy[:, None, :]).sum(-1),
                            (w * rd[:, None, :]).sum(-1)], dim=-1)

    p0 = geo.p0[i]
    va = to_local(p0)
    vb = to_local(p0 + geo.e1[i])
    vc = to_local(p0 + geo.e2[i])
    z0 = (z_int - dz)[:, None].expand(N, K_TRI)
    z1 = (z_int + dz)[:, None].expand(N, K_TRI)
    verts, nv = g2d.clip_triangle_z(va, vb, vc, z0, z1)
    # cone projection onto the cross-section at z_int along the
    # envelope's expansion lines
    rz = x0[:, None, None] + ta[:, None, None] * verts[..., 2]
    factor = r_env[:, None, None] / rz.clamp_min(1e-12)
    xy = verts[..., :2] * factor[..., None]
    sig = sigma[:, None].expand(N, K_TRI)
    mass = g2d.polygon_gaussian_mass(
        torch.cat([xy, verts[..., 2:]], dim=-1), nv, sig, sig)
    blocked = torch.where(ok, mass, 0.0).sum(1)
    return blocked.clamp(0.0, 0.95)


def _fsd_interaction(data, dkeys, k, ro, rd, env, eidx, z_int, eps):
    """The Fraunhofer FSD interaction of mid-flight lanes at the region
    z_int along their beams: the aperture of the swept edges, the
    un-blocked power, an RIS draw of the redirect. Returns dict: ap,
    scale, recp_I, wo (world), pdf, fsd (the lane redirects), null (its
    aperture is empty: it continues unchanged)."""
    n = ro.shape[0]
    fp_int = env.major(z_int)
    wp = ro + z_int[:, None] * rd
    # wavefront sigma from the isotropic-equivalent radius
    sigma = env.area_radius(z_int).clamp_min(1e-9) / beam_geo.ENVELOPE
    fx = _perp_axis(rd)
    fy = vec.cross(rd, fx)
    ap, scale = fr.build_aperture_3d(data.edges, eidx, wp, rd, fx, fy, sigma,
                                     fp_int.clamp_min(1e-9), k, subdiv=SUBDIV)
    dz = (Z_SCALE * fp_int).clamp_min(4.0 * eps)
    blocked = _blocked_flux(data.geo, ro, rd, fx, fy, z_int, dz, env.x0,
                            env.ta, sigma, tri_clusters=data.tri_clusters)
    recp_I = 1.0 / (1.0 - blocked).clamp_min(0.05)
    uR = rng.uniform(dkeys, rng.D_FSD, 4 * M_RIS + 1)
    xi, asf_v, _, vs = fr.sample_xi_sir(
        ap, uR[:, :4 * M_RIS].reshape(n, M_RIS, 4), uR[:, 4 * M_RIS])
    wo_l, ok_wo = fr.xi_to_wo(xi, scale)
    pdf = asf_v * recp_I
    ap_any = ap.valid.any(1)
    # weight-1 convention: the surface/redirect classification is the
    # flux partition (see the JAX module's regime note); a non-empty
    # aperture with an invalid draw ends the lane
    return dict(ap=ap, scale=scale, recp_I=recp_I, pdf=pdf,
                wo=wo_l[:, 0:1] * fx + wo_l[:, 1:2] * fy + wo_l[:, 2:3] * rd,
                fsd=ap_any & vs & ok_wo & torch.isfinite(pdf) & (pdf > 0),
                null=~ap_any)


def _walk(data, keys, k, ro, rd, beta0, pdf_dir0, max_verts, eps,
          salt_base, *, ta0, polar, use_fsd, K):
    """Random walk storing up to max_verts vertices (surface + FSD).

    polar: "mueller" composes frame-aware Mueller operators (camera
    subpath), "stokes" propagates a Stokes vector (light subpath).
    Returns a dict of (N, V, ...) arrays: p, ns, gn, uv, mat, emitter, wi
    (toward the previous vertex), beta_v, pol_v (Mueller (N,V,4,4) or
    Stokes (N,V,4) INTO the vertex), pax_v, pdf_fwd, pdf_rev, delta_v,
    fsd_v, valid, the FSD vertices' ap_v / scale_v / recpI_v, and the
    walk's counters `stats`."""
    geo = data.geo
    tables = data.tables
    et = data.emitters
    edge_table = data.edges
    N = ro.shape[0]
    V = max_verts
    dev = ro.device
    f32 = torch.float32
    mueller = polar == "mueller"

    def full(val, dtype=f32, shape=()):
        return torch.full((N,) + shape, val, dtype=dtype, device=dev)

    def zeros(*shape, dtype=f32):
        return torch.zeros((N,) + shape, dtype=dtype, device=dev)

    if mueller:
        pol = torch.eye(4, dtype=f32, device=dev).expand(N, 4, 4) \
            * beta0[:, None, None]
        pol_store = zeros(V, 4, 4)
        pax = _perp_axis(-rd)
    else:
        pol = stokes_mod.unpolarized(beta0)
        pol_store = zeros(V, 4)
        pax = _perp_axis(rd)
    st = dict(
        p=zeros(V, 3), ns=zeros(V, 3), gn=zeros(V, 3), uv=zeros(V, 2),
        mat=full(-1, torch.int32, (V,)), emitter=full(-1, torch.int32, (V,)),
        wi=zeros(V, 3), beta_v=zeros(V), pol_v=pol_store, pax_v=zeros(V, 3),
        pdf_fwd=zeros(V), pdf_rev=zeros(V),
        delta_v=zeros(V, dtype=torch.bool), fsd_v=zeros(V, dtype=torch.bool),
        valid=zeros(V, dtype=torch.bool),
        ap_v=fr.empty_fr_aperture(N, K * SUBDIV, dev).map(
            lambda a: a[:, None].repeat((1, V) + (1,) * (a.dim() - 1))),
        scale_v=zeros(V), recpI_v=zeros(V))
    beta, pdf_dir = beta0, pdf_dir0
    active = full(True, torch.bool)
    exclude = full(-1, torch.int32)
    delta = full(False, torch.bool)
    env = env_mod.EnvState(x=_perp_axis(rd), x0=zeros(),
                           ta=torch.as_tensor(ta0, dtype=f32, device=dev)
                           * torch.ones((N,), dtype=f32, device=dev),
                           e=torch.ones((N,), dtype=f32, device=dev))
    cur = full(0, torch.int32)
    counts = []

    for i in range(V + 2):
        dkeys = rng.depth_key(keys, salt_base + i)
        lane = active & (cur < V)
        # only walking lanes read their hit
        t, tri, u, v = trace_mod.trace(geo, ro, rd, full(eps), full(BIG),
                                       exclude, need=lane)
        hit = trace_mod.hit_attributes(geo, ro, rd, t, tri, u, v)

        # ---- edge sweep inside the beam envelope (major-axis radius)
        if use_fsd:
            zmax = torch.where(hit.valid, hit.t * 1.02 + env.x0,
                               8.0 * et.scene_radius)
            eidx, ez, ecnt = edges_mod.edges_in_cone(
                edge_table, data.edge_clusters, ro, rd, env, zmax, K)
            have_edges = ecnt > 0
            z_first = torch.where(have_edges, ez.min(1).values, BIG)
            fp_hit = env.major(torch.where(hit.valid, hit.t, 0.0))
            delta_hit = (Z_SCALE * fp_hit).clamp_min(4.0 * eps)
            midflight = have_edges & (z_first < torch.where(
                hit.valid, hit.t - delta_hit, BIG))
        else:
            midflight = zeros(dtype=torch.bool)
            z_first = full(BIG)

        surface = lane & hit.valid & ~midflight
        midflight = lane & midflight

        # solid-angle → area pdf at the hit
        cos_hit = vec.dot(rd, hit.geo_n).abs()
        d2 = hit.t.clamp_min(1e-9) ** 2
        pdf_area = pdf_dir * cos_hit / d2

        sf = frame_mod.build_shading_frame(hit.ns, hit.dpdu)
        sf = bsdf_dev.apply_normalmap(tables, hit.mat_id, hit.uv, k, sf)
        wi_l = sf.to_local(-rd)

        # ---- Fraunhofer FSD interaction at the mid-flight region, formed
        # for the mid-flight lanes only (every other lane's FSD terms are
        # never read)
        z_int = z_first
        wo_fsd = rd
        pdf_fsd = torch.ones_like(beta)
        fsd_lane = zeros(dtype=torch.bool)
        null_lane = zeros(dtype=torch.bool)
        if use_fsd:
            fp_int = env.major(z_int)
            wp = ro + z_int[:, None] * rd
            mid = midflight.nonzero().squeeze(1)
            if mid.numel():
                fi = _fsd_interaction(
                    data, {key: val[mid] for key, val in dkeys.items()},
                    k[mid], ro[mid], rd[mid], env_mod.EnvState(
                        x=env.x[mid], x0=env.x0[mid], ta=env.ta[mid],
                        e=env.e[mid]), eidx[mid], z_int[mid], eps)
                fsd_lane[mid] = fi["fsd"]
                null_lane[mid] = fi["null"]
                wo_fsd = rd.clone()
                wo_fsd[mid] = fi["wo"]
                pdf_fsd[mid] = fi["pdf"]
                for (_, s_arr), (_, a_val) in zip(st["ap_v"].items(),
                                                  fi["ap"].items()):
                    _emit_at(s_arr, cur, a_val, fi["fsd"], rows=mid)
                _emit_at(st["scale_v"], cur, fi["scale"], fi["fsd"], rows=mid)
                _emit_at(st["recpI_v"], cur, fi["recp_I"], fi["fsd"],
                         rows=mid)
        else:
            wp = ro
            fp_int = zeros()

        # ---- store the vertex (surface or FSD; null takes no slot)
        surface_eff = surface & ~fsd_lane
        store = surface_eff | fsd_lane
        s3 = surface_eff[:, None]
        pdf_fwd_v = torch.where(surface_eff, pdf_area,
                                pdf_dir / z_int.clamp_min(1e-9) ** 2)
        _emit_at(st["p"], cur, torch.where(s3, hit.p, wp), store)
        _emit_at(st["ns"], cur, torch.where(s3, sf.n, rd), store)
        _emit_at(st["gn"], cur, torch.where(s3, hit.geo_n, rd), store)
        _emit_at(st["uv"], cur, hit.uv, store)
        _emit_at(st["mat"], cur, torch.where(surface_eff, hit.mat_id, -1),
                 store)
        _emit_at(st["emitter"], cur,
                 torch.where(surface_eff, hit.emitter_id, -1), store)
        _emit_at(st["wi"], cur, -rd, store)
        _emit_at(st["beta_v"], cur, beta, store)
        _emit_at(st["pol_v"], cur, pol, store)
        _emit_at(st["pax_v"], cur, pax, store)
        _emit_at(st["pdf_fwd"], cur, pdf_fwd_v, store)
        _emit_at(st["delta_v"], cur, delta, store)
        _emit_at(st["fsd_v"], cur, fsd_lane, store)
        _emit_at(st["valid"], cur, store, store)

        # ---- continue the walk
        bs = bsdf_dev.sample(tables, hit.mat_id, wi_l, hit.uv, k,
                             bsdf_uniforms(tables, dkeys, rng.uniform(
                                 dkeys, rng.D_BSDF_DIR, 2)))
        wo_w = sf.to_world(bs.wo)

        # reverse pdf of the PREVIOUS vertex from here (for MIS)
        _, pdf_rev_dir = bsdf_dev.eval_f(tables, hit.mat_id, bs.wo, wi_l,
                                         hit.uv, k)
        prev_c = (cur - 1).clamp_min(0)
        rows = torch.arange(N, device=dev)
        prev_gn = st["gn"][rows, prev_c.long()]
        prev_cos = vec.dot(rd, prev_gn).abs()
        pdf_rev_prev = torch.where(bs.specular, 0.0,
                                   pdf_rev_dir * prev_cos / d2)
        pdf_rev_prev = torch.where(
            fsd_lane, pdf_fsd * prev_cos / z_int.clamp_min(1e-9) ** 2,
            pdf_rev_prev)
        _emit_at(st["pdf_rev"], prev_c, pdf_rev_prev, store & (cur > 0))

        # envelope updates: the cone through the projected footprint
        env_surf, _ = env_mod.surface_scatter(env, rd, hit.t, hit.geo_n,
                                              wo_w, bs.specular, k)
        ta_fsd = beam_geo.minimum_uncertainty_tan_alpha(
            fp_int.clamp_min(1e-9) ** 2, k)

        # FSD redirects (the weight-1 convention) and null continuations
        # keep their throughput
        beta_next = torch.where(surface_eff, beta * bs.Mw[:, 0, 0].abs(),
                                beta)
        if mueller:
            pol_surf, pax_surf = compose_scatter(pol, pax, -rd, bs.Mw, -wo_w)
        else:
            s_ax = _safe_cross(rd, wo_w)
            S_rot = stokes_mod.reorient(pol, pax, s_ax, rd)
            pol_surf = torch.einsum("nij,nj->ni", bs.Mw, S_rot)
            pax_surf = s_ax

        cont = (surface_eff & bs.valid) | fsd_lane | null_lane
        active_new = lane & cont & (beta_next > 1e-25)
        ro_new = torch.where(s3, hit.p, wp)
        rd_new = torch.where(s3, wo_w,
                             torch.where(fsd_lane[:, None], wo_fsd, rd))
        # FSD turns parallel-transport the transverse axis onto the new
        # direction (Gram–Schmidt); null continuation keeps it
        gs = pax - rd_new * vec.vdot(pax, rd_new)
        gl = torch.linalg.vector_norm(gs, dim=-1, keepdim=True)
        pax_pt = torch.where(gl < 1e-6, _perp_axis(rd_new),
                             gs / gl.clamp_min(1e-12))
        pax_mid = torch.where(fsd_lane[:, None], pax_pt, pax)
        pol_new = _select(surface_eff, pol_surf, pol)
        pax_new = torch.where(s3, pax_surf, pax_mid)
        pol = _select(active_new, pol_new, pol)
        pax = _select(active_new, pax_new, pax)
        ro = _select(active_new, ro_new, ro)
        rd = _select(active_new, rd_new, rd)
        beta = torch.where(active_new, beta_next, beta)
        pdf_dir = torch.where(
            active_new,
            torch.where(surface_eff, torch.where(bs.specular, 1.0, bs.pdf),
                        torch.where(fsd_lane, pdf_fsd, pdf_dir)), pdf_dir)
        exclude = torch.where(active_new & surface, hit.tri,
                              torch.where(active_new, -1, exclude))
        delta = torch.where(active_new, surface_eff & bs.specular, delta)
        ones = torch.ones_like(beta)
        env_fsd = env_mod.EnvState(x=_perp_axis(rd_new), x0=ones * 1e-6,
                                   ta=ta_fsd.clamp_max(0.3), e=ones)
        env_null = env_mod.EnvState(x=env.x, x0=fp_int, ta=env.ta, e=env.e)
        env_new = env_mod.select(surface_eff, env_surf, env_mod.select(
            fsd_lane, env_fsd, env_null))
        env = env_mod.select(active_new, env_new, env)
        cur = cur + store.to(torch.int32)
        active = active_new
        counts.append(torch.stack([
            lane.sum(dtype=f32), surface_eff.sum(dtype=f32),
            fsd_lane.sum(dtype=f32), null_lane.sum(dtype=f32),
            active.sum(dtype=f32), midflight.sum(dtype=f32)]))

    c = torch.stack(counts).sum(0)
    stats = torch.zeros((N_STATS,), dtype=f32, device=dev)
    for j, slot in enumerate((STAT_RAYS, STAT_SURFACE, STAT_FSD, STAT_NULL,
                              STAT_DEPTH_SUM, STAT_EDGE_HIT)):
        stats[slot] = c[j]
    st["stats"] = stats
    return st


def _connection(pa, pb):
    """Unit direction pa → pb and its length (the JAX module's
    `_geometry_term` without the G term, which no strategy reads)."""
    d = pb - pa
    d2 = vec.length2(d).clamp_min(1e-18)
    return d / torch.sqrt(d2)[..., None], torch.sqrt(d2)


def _chain_tables(pdf_fwd, pdf_rev, delta_v):
    """Per-lane MIS chain tables over a stored subpath (the iterative form
    of the balance-heuristic pdf-ratio recursion), so each strategy's
    weight is O(1). r[j] = pdf_rev[j+1]/pdf_fwd[j]. Returns
      S_tab[:, tau] = Σ_{j≤tau−2} (Π_{m=j}^{tau−2} r[m])·mask_j,
      F_tab[:, tau] = Π_{m=0}^{tau−2} r[m]."""
    N, V = pdf_fwd.shape
    r = pdf_rev[:, 1:] / pdf_fwd[:, :-1].clamp_min(1e-30)
    mb = ((~delta_v[:, :-1]) & (pdf_rev[:, 1:] > 0)).to(torch.float32)
    z = torch.zeros((N,), dtype=torch.float32, device=pdf_fwd.device)
    S = [z, z]
    F = [z + 1.0, z + 1.0]
    for tau in range(2, V + 1):
        S.append(r[:, tau - 2] * (S[tau - 1] + mb[:, tau - 2]))
        F.append(r[:, tau - 2] * F[tau - 1])
    return torch.stack(S, dim=1), torch.stack(F, dim=1)


def _dyn(arr, i):
    """arr (N, V, ...) at slot i (a Python int), clamped into range."""
    return arr[:, min(max(i, 0), arr.shape[1] - 1)]


def _side_sum(tau, pconn, r_end_num, pdf_fwd, delta_v, S_tab, F_tab=None,
              bottom=None):
    """Sum of pdf ratios for the alternatives that re-sample one side's
    chain of `tau` stored vertices from the other side: the top two
    transitions use the strategy's connection pdfs (pconn: area pdf of the
    endpoint from across; r_end_num: area pdf of vertex tau−2 from the
    endpoint), interior ones the stored walk pdfs. bottom: extra
    alternatives below vertex 0 (emitter NEE / emission hit), excluding
    the chain product factor."""
    pf_top = _dyn(pdf_fwd, tau - 1)
    d_top = _dyn(delta_v, tau - 1)
    ri0 = torch.where(pf_top > 0, pconn / pf_top.clamp_min(1e-30), 0.0)
    ssum = torch.where(d_top, 0.0, ri0)
    if tau >= 2:
        pf_2 = _dyn(pdf_fwd, tau - 2)
        d_2 = _dyn(delta_v, tau - 2)
        r_end = r_end_num / pf_2.clamp_min(1e-30)
        m_end = ((~d_2) & (r_end_num > 0)).to(torch.float32)
        ssum = ssum + ri0 * r_end * (m_end + _dyn(S_tab, tau - 1))
    if bottom is not None:
        full = ri0 * r_end * _dyn(F_tab, tau - 1) if tau >= 2 else ri0
        ssum = ssum + full * bottom
    return ssum


def _emitter_area_pdf(et, emitter_id):
    eid = emitter_id.clamp_min(0).long()
    tot = et.power.sum().clamp_min(1e-30)
    pmf = et.power[eid] / tot
    pdf_a = 1.0 / et.area_total[eid].clamp_min(1e-30)
    return torch.where((emitter_id >= 0) & (et.etype[eid] == etab.ET_AREA),
                       pmf * pdf_a, 0.0)


def _contrib4(M, Sv):
    return torch.einsum("nij,nj->ni", M, Sv)


def trace_bdpt(data, pixel_xy, jitter, base_key, sample_ids, *, sensor,
               max_depth: int = 4, eps: float = 1e-5, fsd: bool = False,
               K: int = 8, with_stats: bool = False):
    """One bdpt batch. Returns (pos (N, 2), values (N, C), ok (N,),
    light_splats) and, with_stats, the counter vector (N_STATS,):
    light_splats = (pos_lt (N·T, 2), values_lt (N·T, C), ok_lt (N·T,)) —
    every stored light vertex splats once (t = 1), flattened per lane for
    film.splat_direct."""
    geo = data.geo
    tables = data.tables
    et = data.emitters
    sp = data.spectral
    N = pixel_xy.shape[0]
    dev = pixel_xy.device
    S = max_depth          # camera subpath vertices
    T = max_depth          # light subpath vertices
    use_fsd = bool(fsd) and data.edges.count > 0
    f32 = torch.float32

    def full(val, dtype=f32):
        return torch.full((N,), val, dtype=dtype, device=dev)

    pixel_id = pixel_xy[:, 1] * sensor.width + pixel_xy[:, 0]
    keys = rng.sample_key(base_key, pixel_id, sample_ids)

    u_spec = rng.uniform(keys, rng.D_SPECTRUM, 2)
    e0, _ = sp.sample_emitter(u_spec[:, 0])
    k, _ = sp.sample_k(e0, u_spec[:, 1])
    w_spectral = 1.0 / sp.joint_spectral_density(k).clamp_min(1e-30)

    # camera directional pdf (solid angle) of a pinhole with uniform
    # film-area sampling: p(w) = 1/(A_img cos³), used for the camera
    # chain bottom and the t = 1 splat MIS alike
    tan_half = math.tan(0.5 * sensor.fov)
    A_img = (2 * tan_half) * (2 * tan_half * sensor.height / sensor.width)
    o_cam, _, _, f_cam = sensor.camera_basis()
    cam_fwd = torch.tensor(f_cam, dtype=f32, device=dev)

    # ---- camera subpath
    ro_c, rd_c, pixel_tan_alpha = sensor.generate_rays(pixel_xy, jitter)
    ro_c = ro_c.contiguous()
    cosz0 = vec.dot(rd_c, cam_fwd[None, :]).clamp_min(1e-3)
    p_camdir0 = 1.0 / (A_img * cosz0 ** 3)
    walk = dict(use_fsd=use_fsd, K=K)
    cam = _walk(data, keys, k, ro_c, rd_c, full(sensor.importance()),
                p_camdir0, S, eps, 0, polar="mueller",
                ta0=0.5 * pixel_tan_alpha, **walk)

    # ---- light subpath (vertex 0 on the emitter)
    u_em = torch.cat([rng.uniform(keys, rng.D_EMITTER_POS, 3),
                      rng.uniform(keys, rng.D_EMITTER_DIR, 1)], dim=-1)
    em = etab.sample_emission(et, geo, tables.spectra, e0, k, u_em)
    pmf_e = sp.pmf_emitter(e0)
    beta_l0 = em["weight"] / pmf_e.clamp_min(1e-30)
    _, ta_l = sourcing.source_emitter_mub(et, e0, k)
    lgt = _walk(data, keys, k, em["y"], em["wo"], beta_l0, em["pdf_dir"], T,
                eps, 32, ta0=ta_l, polar="stokes", **walk)

    sens = sensor.response.sensitivities(k, tables.spectra, None)
    eye4 = torch.eye(4, dtype=f32, device=dev)

    # the lanes whose stored vertex i is an FSD vertex, per slot: only
    # their FSD values are read (fsd_mat and its pdf twins select them)
    for vs in (cam, lgt):
        vs["fsd_rows"] = [vs["fsd_v"][:, i].nonzero().squeeze(1)
                          if use_fsd else None for i in range(S)]

    def fsd_f_at(vs, idx, dn):
        """Scalar Fraunhofer FSD BSDF value (= its pdf) at stored vertex
        idx for outgoing direction dn, from the per-vertex aperture, on
        the lanes where that vertex is an FSD vertex (zero elsewhere)."""
        out = torch.zeros_like(dn[:, 0])
        rows = vs["fsd_rows"][min(max(idx, 0), S - 1)]
        if rows is None or not rows.numel():
            return out
        ap_i = vs["ap_v"].map(lambda a: _dyn(a, idx)[rows])
        rd_v = -_dyn(vs["wi"], idx)[rows]    # beam direction INTO vertex
        dn = dn[rows]
        fx = _perp_axis(rd_v)
        fy = vec.cross(rd_v, fx)
        wol = torch.stack([vec.dot(dn, fx), vec.dot(dn, fy),
                           vec.dot(dn, rd_v)], dim=-1)
        xi, okx = fr.wo_to_xi(wol, _dyn(vs["scale_v"], idx)[rows])
        f = fr.asf(ap_i, xi) * _dyn(vs["recpI_v"], idx)[rows]
        ok = okx & torch.isfinite(f) & (f >= 0)
        return out.index_put((rows,), torch.where(ok, f, 0.0))

    def fsd_mat(is_fsd, f_fsd, f):
        """The surface BSDF f (N, 4, 4) with FSD vertices' scalar ASF."""
        return torch.where(is_fsd[:, None, None], eye4 * f_fsd[:, None, None],
                           f)

    # ---- MIS chain tables
    S_cam, _ = _chain_tables(cam["pdf_fwd"], cam["pdf_rev"], cam["delta_v"])
    S_lgt, F_lgt = _chain_tables(lgt["pdf_fwd"], lgt["pdf_rev"],
                                 lgt["delta_v"])

    # light-chain bottom alternative (below stored vertex 0): the
    # emission-hit strategy, from the stored incoming at lgt[0]
    dir0 = em["y"] - lgt["p"][:, 0]
    d0_2 = vec.length2(dir0).clamp_min(1e-18)
    dir0 = dir0 / torch.sqrt(d0_2)[:, None]
    cos_e0 = vec.dot(em["ln"], -dir0).abs()
    # each light vertex's material and shading frame, read by every
    # strategy through it
    at_lgt = [bsdf_dev.material_at(tables, lgt["mat"][:, lv],
                                   lgt["uv"][:, lv], k) for lv in range(T)]
    sf_lgt = [frame_mod.build_shading_frame(
        lgt["ns"][:, lv], _tangent_of(lgt["ns"][:, lv])) for lv in range(T)]
    in0 = torch.where(lgt["valid"][:, 1:2], -lgt["wi"][:, 1], dir0) \
        if T >= 2 else dir0
    _, pdf_lv0_to_em = bsdf_dev.eval_f(
        tables, lgt["mat"][:, 0], sf_lgt[0].to_local(in0),
        sf_lgt[0].to_local(dir0), lgt["uv"][:, 0], k, at=at_lgt[0])
    pdf_nee_sa0 = etab.pdf_direct_solid_angle(et, e0, d0_2, cos_e0) \
        * sp.pmf_emitter(e0)
    hit0_ok = (et.etype[e0.clamp_min(0).long()] == etab.ET_AREA) \
        & (cos_e0 > 1e-6) & (pdf_nee_sa0 > 0)
    r_hit0 = torch.where(hit0_ok,
                         pdf_lv0_to_em / pdf_nee_sa0.clamp_min(1e-30), 0.0)
    bot_light = (pdf_lv0_to_em > 0).to(f32) * r_hit0

    L = torch.zeros((N, 4), dtype=f32, device=dev)

    # ---- strategy s = 0: the camera path hits an emitter
    for t in range(1, S + 1):
        v = t - 1
        p_v = _dyn(cam["p"], v)
        gn_v = _dyn(cam["gn"], v)
        em_v = _dyn(cam["emitter"], v)
        Le = etab.emission_radiance(et, tables.spectra, em_v, k,
                                    vec.dot(_dyn(cam["wi"], v), gn_v))
        ok = _dyn(cam["valid"], v) & (Le > 0)
        if t == 1:
            w = torch.ones_like(Le)
        else:
            pdf_as_light = torch.where(ok, _emitter_area_pdf(et, em_v), 0.0)
            # endpoint remap: emission DIRECTION pdf toward cam[t-2]
            Gd = _dyn(cam["p"], v - 1) - p_v
            dd2 = vec.length2(Gd).clamp_min(1e-18)
            Gd = Gd / torch.sqrt(dd2)[:, None]
            pdf_edir = etab.pdf_emission_dir(et, em_v, gn_v, Gd)
            r_end_num = pdf_edir * vec.dot(Gd, _dyn(cam["ns"], v - 1)).abs() \
                / dd2
            ssum = _side_sum(t, pdf_as_light, r_end_num, cam["pdf_fwd"],
                             cam["delta_v"], S_cam)
            w = 1.0 / (1.0 + ssum).clamp_min(1.0)
        c_emit = _contrib4(_dyn(cam["pol_v"], v), stokes_mod.unpolarized(Le))
        L = L + torch.where(ok[:, None], w[:, None] * c_emit, 0.0)

    # ---- strategies s = 1 (NEE) and s >= 2 (vertex connections)
    for t in range(1, S + 1):
        cv = t - 1
        cam_fsd = _dyn(cam["fsd_v"], cv)
        cam_ok = _dyn(cam["valid"], cv) & ~_dyn(cam["delta_v"], cv)
        p_c = _dyn(cam["p"], cv)
        ns_c = _dyn(cam["ns"], cv)
        wi_c_w = _dyn(cam["wi"], cv)
        uv_c = _dyn(cam["uv"], cv)
        mat_c = _dyn(cam["mat"], cv)
        pol_c = _dyn(cam["pol_v"], cv)
        pax_c = _dyn(cam["pax_v"], cv)
        sfc = frame_mod.build_shading_frame(ns_c, _tangent_of(ns_c))
        wi_c = sfc.to_local(wi_c_w)
        at_c = bsdf_dev.material_at(tables, mat_c, uv_c, k)
        # camera-side chain: pdf of cam[cv-1] from cv given incoming dn
        segc = _dyn(cam["p"], cv - 1) - p_c
        dc2 = vec.length2(segc).clamp_min(1e-18)
        segc = segc / torch.sqrt(dc2)[:, None]
        cos_cprev = vec.dot(segc, _dyn(cam["ns"], cv - 1)).abs()
        f_fsd_segc = fsd_f_at(cam, cv, segc)

        def cam_r_end(dn):
            """Area pdf of cam[cv-1] from cv, incoming dn (cv → light)."""
            _, pdf = bsdf_dev.eval_f(tables, mat_c, sfc.to_local(dn), wi_c,
                                     uv_c, k, at=at_c)
            return torch.where(cam_fsd, f_fsd_segc, pdf) * cos_cprev / dc2

        for j in range(T + 1):
            dkeys = rng.depth_key(keys, 64 + cv * (T + 1) + j)
            if j == 0:
                # ---------- s = 1: a fresh NEE sample
                u_nee = rng.uniform(dkeys, rng.D_NEE, 3)
                e_n, pmf_n = _sample_emitter_by_power(et, u_nee[:, 0] * 0.9999)
                nee = etab.sample_direct(et, geo, tables.spectra, e_n, p_c, k,
                                         u_nee)
                f_c, pdf_c = bsdf_dev.eval_f(tables, mat_c, wi_c,
                                             sfc.to_local(nee["wo"]), uv_c, k,
                                             at=at_c)
                f_fsd_c = fsd_f_at(cam, cv, nee["wo"])
                f_c = fsd_mat(cam_fsd, f_fsd_c, f_c)
                pdf_c = torch.where(cam_fsd, f_fsd_c, pdf_c)
                pdf_nee = pmf_n * nee["pdf_sa"]
                ok = cam_ok & nee["valid"] & (pdf_nee > 0) \
                    & (f_c[:, 0, 0] > 0)
                occ = trace_mod.occluded(geo, p_c, nee["wo"], full(eps),
                                         nee["dist"] - 2 * eps, None,
                                         nee["tri"], need=ok)
                M_nee, _ = compose_scatter(pol_c, pax_c, wi_c_w, f_c,
                                           -nee["wo"])
                c = _contrib4(M_nee, stokes_mod.unpolarized(nee["Li"])) \
                    / pdf_nee.clamp_min(1e-30)[:, None]
                # light side: a single emitter vertex
                ssum_l = torch.where(nee["delta_dir"], 0.0,
                                     pdf_c / pdf_nee.clamp_min(1e-30))
                # camera side: re-sample cv (and below) from the light
                pdf_edir = etab.pdf_emission_dir(et, e_n, nee["ln"],
                                                 -nee["wo"])
                dist2 = nee["dist"].clamp_min(1e-9) ** 2
                pconn_cam = pdf_edir * vec.dot(nee["wo"], ns_c).abs() / dist2
                ssum_c = _side_sum(t, pconn_cam, cam_r_end(nee["wo"]),
                                   cam["pdf_fwd"], cam["delta_v"], S_cam)
                w = 1.0 / (1.0 + ssum_l + ssum_c).clamp_min(1.0)
                ok = ok & ~occ
            else:
                # ---------- s >= 2: connect to stored light vertex j-1
                lv = j - 1
                l_fsd = _dyn(lgt["fsd_v"], lv)
                l_ok = _dyn(lgt["valid"], lv) & ~_dyn(lgt["delta_v"], lv)
                p_l = _dyn(lgt["p"], lv)
                ns_l = _dyn(lgt["ns"], lv)
                wi_l_w = _dyn(lgt["wi"], lv)
                uv_l = _dyn(lgt["uv"], lv)
                mat_l = _dyn(lgt["mat"], lv)
                dn, dist = _connection(p_c, p_l)
                sfl = sf_lgt[lv]
                f_cam, pdf_cam_dir = bsdf_dev.eval_f(
                    tables, mat_c, wi_c, sfc.to_local(dn), uv_c, k, at=at_c)
                f_lgt, pdf_lgt_dir = bsdf_dev.eval_f(
                    tables, mat_l, sfl.to_local(wi_l_w), sfl.to_local(-dn),
                    uv_l, k, at=at_lgt[lv])
                # FSD endpoints: the scalar ASF in place of the BSDF
                f_fsd_c = fsd_f_at(cam, cv, dn)
                f_cam = fsd_mat(cam_fsd, f_fsd_c, f_cam)
                pdf_cam_dir = torch.where(cam_fsd, f_fsd_c, pdf_cam_dir)
                f_fsd_l = fsd_f_at(lgt, lv, -dn)
                f_lgt = fsd_mat(l_fsd, f_fsd_l, f_lgt)
                pdf_lgt_dir = torch.where(l_fsd, f_fsd_l, pdf_lgt_dir)
                cos_c = torch.where(cam_fsd, 1.0, vec.dot(dn, ns_c).abs()
                                    .clamp_min(1e-7))
                cos_l = torch.where(l_fsd, 1.0, vec.dot(dn, ns_l).abs()
                                    .clamp_min(1e-7))
                d_in_l = -wi_l_w
                s_ax_l = _safe_cross(d_in_l, -dn)
                S_rot = stokes_mod.reorient(_dyn(lgt["pol_v"], lv),
                                            _dyn(lgt["pax_v"], lv), s_ax_l,
                                            d_in_l)
                S1 = torch.einsum("nij,nj->ni", f_lgt, S_rot)
                M_conn, x_in = compose_scatter(pol_c, pax_c, wi_c_w, f_cam,
                                               -dn)
                S2 = stokes_mod.reorient(S1, s_ax_l, x_in, -dn)
                d2 = dist.clamp_min(1e-9) ** 2
                # the Mueller-valued BSDFs carry their own cosines: the
                # connection geometry reduces to 1/d²
                c = _contrib4(M_conn, S2) * (1.0 / d2)[:, None]
                ok = cam_ok & l_ok & (c[:, 0] > 0)
                occ = trace_mod.occluded(geo, p_c, dn, full(eps),
                                         dist - 2 * eps, need=ok)
                pconn_cam = pdf_lgt_dir * cos_c / d2
                pconn_lgt = pdf_cam_dir * cos_l / d2
                # light-side endpoint remap: pdf of lgt[lv-1] from lv
                # given incoming -dn
                segl = _dyn(lgt["p"], lv - 1) - p_l
                dl2 = vec.length2(segl).clamp_min(1e-18)
                segl = segl / torch.sqrt(dl2)[:, None]
                _, pdf_l_rev = bsdf_dev.eval_f(tables, mat_l,
                                               sfl.to_local(-dn),
                                               sfl.to_local(wi_l_w), uv_l, k,
                                               at=at_lgt[lv])
                pdf_l_rev = torch.where(l_fsd, fsd_f_at(lgt, lv, segl),
                                        pdf_l_rev)
                r_end_l = pdf_l_rev * vec.dot(
                    segl, _dyn(lgt["ns"], lv - 1)).abs() / dl2
                ssum_c = _side_sum(t, pconn_cam, cam_r_end(dn),
                                   cam["pdf_fwd"], cam["delta_v"], S_cam)
                ssum_l = _side_sum(j, pconn_lgt, r_end_l, lgt["pdf_fwd"],
                                   lgt["delta_v"], S_lgt, F_lgt, bot_light)
                w = 1.0 / (1.0 + ssum_c + ssum_l).clamp_min(1.0)
                ok = ok & ~occ
            L = L + torch.where(ok[:, None], w[:, None] * c, 0.0)

    # ---- t = 1: light tracing onto the sensor — every stored light
    # vertex splats, weighted by the full MIS (the camera subpath is the
    # bare pinhole; the alternatives live on the light chain)
    ro_cam = torch.tensor(o_cam, dtype=f32, device=dev).expand(N, 3)
    lt_pos, lt_val, lt_ok = [], [], []
    for lv in range(T):
        p_l = _dyn(lgt["p"], lv)
        ns_l = _dyn(lgt["ns"], lv)
        wi_l_w = _dyn(lgt["wi"], lv)
        uv_l = _dyn(lgt["uv"], lv)
        mat_l = _dyn(lgt["mat"], lv)
        l_fsd = _dyn(lgt["fsd_v"], lv)
        pxy_l, visible, cosz, dn_cam, dist_c = sensor.project(p_l)
        sfl = sf_lgt[lv]
        f_l, _ = bsdf_dev.eval_f(tables, mat_l, sfl.to_local(wi_l_w),
                                 sfl.to_local(-dn_cam), uv_l, k,
                                 at=at_lgt[lv])
        f_l = fsd_mat(l_fsd, fsd_f_at(lgt, lv, -dn_cam), f_l)
        # importance with the pixel choice folded into the direction pdf:
        # the splat value is β·f/(A_img·cosz³·d²), developed by /spp
        W_cam = 1.0 / (A_img * cosz.clamp_min(1e-3) ** 3)
        d_in_l = -wi_l_w
        s_ax_l = _safe_cross(d_in_l, -dn_cam)
        S_rot = stokes_mod.reorient(_dyn(lgt["pol_v"], lv),
                                    _dyn(lgt["pax_v"], lv), s_ax_l, d_in_l)
        S1 = torch.einsum("nij,nj->ni", f_l, S_rot)
        d2c = dist_c.clamp_min(1e-9) ** 2
        val = S1 * (W_cam / d2c)[:, None]
        ok = _dyn(lgt["valid"], lv) & ~_dyn(lgt["delta_v"], lv) & visible \
            & (val[:, 0] > 0)
        occ = trace_mod.occluded(geo, ro_cam, dn_cam, full(eps),
                                 dist_c - 2 * eps, need=ok)
        # endpoint-remapped bottom alternative of the one-vertex chain:
        # "camera → v0 → BSDF-hits the emitter" arrives along the camera
        # direction, not the stored chain's continuation
        _, pdf_em_cam = bsdf_dev.eval_f(tables, mat_l, sfl.to_local(-dn_cam),
                                        sfl.to_local(dir0), uv_l, k,
                                        at=at_lgt[lv])
        if lv == 0:
            r_hit_cam = torch.where(
                hit0_ok, pdf_em_cam / pdf_nee_sa0.clamp_min(1e-30), 0.0)
            bot_l = (pdf_em_cam > 0).to(f32) * r_hit_cam
        else:
            bot_l = bot_light
        # MIS: re-sample the light chain from the camera side
        cos_l = torch.where(l_fsd, 1.0, vec.dot(dn_cam, ns_l).abs()
                            .clamp_min(1e-7))
        pconn_lgt = W_cam * cos_l / d2c
        segl = _dyn(lgt["p"], lv - 1) - p_l
        dl2 = vec.length2(segl).clamp_min(1e-18)
        segl = segl / torch.sqrt(dl2)[:, None]
        _, pdf_l_rev = bsdf_dev.eval_f(tables, mat_l, sfl.to_local(-dn_cam),
                                       sfl.to_local(wi_l_w), uv_l, k,
                                       at=at_lgt[lv])
        pdf_l_rev = torch.where(l_fsd, fsd_f_at(lgt, lv, segl), pdf_l_rev)
        r_end_l = pdf_l_rev * vec.dot(segl, _dyn(lgt["ns"], lv - 1)).abs() \
            / dl2
        ssum_l = _side_sum(lv + 1, pconn_lgt, r_end_l, lgt["pdf_fwd"],
                           lgt["delta_v"], S_lgt, F_lgt, bot_l)
        w = 1.0 / (1.0 + ssum_l).clamp_min(1.0)
        lt_pos.append(pxy_l)
        lt_val.append(val * w[:, None])
        lt_ok.append(ok & ~occ)

    lt_pos = torch.stack(lt_pos, dim=1)                 # (N, T, 2)
    lt_val = torch.stack(lt_val, dim=1)                 # (N, T, 4)
    lt_ok = torch.stack(lt_ok, dim=1)
    splat_pos = pixel_xy.to(f32) + jitter
    Lw = L * w_spectral[:, None]
    ltw = lt_val * w_spectral[:, None, None]
    if getattr(sensor, "polarimetric", False):
        # all four Stokes components per channel (I/Q/U/V interleaved)
        values = (Lw[:, None, :] * sens[..., None]).reshape(N, -1)
        lt_values = (ltw[:, :, None, :]
                     * sens[:, None, :, None]).reshape(N, T, -1)
    else:
        values = Lw[:, 0:1] * sens
        lt_values = ltw[..., 0:1] * sens[:, None, :]
    C = lt_values.shape[-1]
    out = (splat_pos, values, torch.ones((N,), dtype=torch.bool, device=dev),
           (lt_pos.reshape(N * T, 2), lt_values.reshape(N * T, C),
            lt_ok.reshape(N * T)))
    if with_stats:
        # both walks' counters + the connection/NEE/t=1 shadow rays: every
        # (s, t) pair and every stored light vertex casts one occlusion
        # segment per lane
        stats = cam["stats"] + lgt["stats"]
        stats[STAT_SHADOW] += float(S * (T + 1) + T) * N
        out = out + (stats,)
    return out
