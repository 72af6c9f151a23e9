"""Free-space diffraction (UTD flavour), batched apertures.

Port of wave_tracer_tpu/wave/fsd.py. An aperture is K wedge-edge slots
per lane, built from the edges found inside a beam's interaction
footprint; `fsd_eval` computes per-edge UTD coefficients at Fermat
points; `fsd_sample`/`fsd_pdf` implement the edge-or-direct importance
strategy with Gaussian Keller-cone azimuth proposals of
σ = sqrt(45/(k·ri)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch

from wave_tracer_tpu_torch.accel.edges import EdgeTable
from wave_tracer_tpu_torch.math import vec
from wave_tracer_tpu_torch.util.device import card
from wave_tracer_tpu_torch.wave import utd
from wave_tracer_tpu_torch.wave.utd import floor_mod

SIGMA_SCALE = 45.0
TWO_PI = 2.0 * math.pi


@dataclass
class FsdAperture:
    """K wedge-edge slots per lane (all (N, K, ...))."""
    v: torch.Tensor        # (N, K, 3) clipped segment midpoint
    half_l: torch.Tensor   # (N, K)
    nff: torch.Tensor      # (N, K, 3) front-face normal (toward light)
    tff: torch.Tensor      # (N, K, 3) front-face tangent
    nbf: torch.Tensor      # (N, K, 3) back-face normal
    alpha: torch.Tensor    # (N, K)
    edge_idx: torch.Tensor  # (N, K) i32 row into the EdgeTable (−1 empty)
    valid: torch.Tensor    # (N, K) bool
    w: torch.Tensor        # (N, K) boundary window (ramps a contribution
    #                        to 0 as its edge leaves the envelope)

    @property
    def e(self):
        """Edge direction = nff × tff."""
        return vec.cross(self.nff, self.tff)

    def any_valid(self):
        return self.valid.any(dim=1)

    def count(self):
        return self.valid.sum(dim=1)

    def items(self):
        return [(f.name, getattr(self, f.name)) for f in fields(self)]


def build_aperture(edges: EdgeTable, idx, wp, wi, region_radius
                   ) -> FsdAperture:
    """Per-lane apertures from the queried edge rows idx (N, K) (−1
    padding); wp (N, 3) interaction centre; wi (N, 3) direction toward the
    source side; region_radius (N,) clip radius."""
    row = edges.pack[idx.clamp_min(0).long()]     # one packed gather
    n1 = row[..., 6:9]
    n2 = row[..., 9:12]
    t1 = row[..., 12:15]
    t2 = row[..., 15:18]
    wi_e = wi[:, None, :]

    f1_front = ((wi_e * n1).sum(-1) > 0.0)[..., None]
    nff = torch.where(f1_front, n1, n2)
    tff = torch.where(f1_front, t1, t2)
    nbf = torch.where(f1_front, n2, n1)
    # light from inside the wedge → skip
    ok = (wi_e * nff).sum(-1) > 0.0

    # clip the segment to ball(wp, region_radius)
    p0 = row[..., 0:3]
    e_dir = row[..., 3:6]
    L = row[..., 19]
    wv = wp[:, None, :] - p0
    tproj = (wv * e_dir).sum(-1)
    d2 = (wv * wv).sum(-1) - tproj ** 2
    r = region_radius[:, None].clamp_min(1e-20)
    span = vec.safe_sqrt(r ** 2 - d2, 1e-30)
    tlo = torch.minimum(torch.clamp(tproj - span, min=0.0), L)
    thi = torch.minimum(torch.clamp(tproj + span, min=0.0), L)
    ok = ok & ((thi - tlo) > 1e-9)
    v = p0 + (0.5 * (tlo + thi))[..., None] * e_dir
    half_l = 0.5 * (thi - tlo)
    ok = ok & (idx >= 0)
    # boundary window over the outer 2% of the envelope radius and the
    # first 1%·r of clipped length, so set membership flips carry no
    # weight
    d = vec.safe_sqrt(d2.clamp_min(0.0), 0.0)
    w_env = ((1.0 - d / r) / 0.02).clamp(0.0, 1.0)
    w_len = ((thi - tlo) / (0.01 * r)).clamp(0.0, 1.0)
    win = torch.where(ok, w_env * w_len, 0.0)
    return FsdAperture(v=v, half_l=half_l, nff=nff, tff=tff, nbf=nbf,
                       alpha=row[..., 18], edge_idx=idx, valid=ok, w=win)


def aperture_face_tris(edges: EdgeTable, ap: FsdAperture):
    """The two triangles adjacent to each aperture edge ((N, K) i32 each,
    −1 for empty slots and boundary edges)."""
    i = ap.edge_idx.clamp_min(0).long()
    return (torch.where(ap.valid, edges.tri1[i], -1),
            torch.where(ap.valid, edges.tri2[i], -1))


def empty_aperture(N: int, K: int, device="cuda") -> FsdAperture:
    """All-invalid aperture with K slots on `device` (the card unless the
    CPU is asked for)."""
    device = card(device)
    z3 = torch.zeros((N, K, 3), dtype=torch.float32, device=device)
    z = torch.zeros((N, K), dtype=torch.float32, device=device)
    return FsdAperture(
        v=z3, half_l=z, nff=z3.clone(), tff=z3.clone(), nbf=z3.clone(),
        alpha=z.clone(),
        edge_idx=torch.full((N, K), -1, dtype=torch.int32, device=device),
        valid=torch.zeros((N, K), dtype=torch.bool, device=device),
        w=z.clone())


def fsd_eval(ap: FsdAperture, k, src, dst):
    """Per-edge UTD evaluation for the connection src → dst. Returns a
    dict of (N, K) tensors: Ds, Dh (complex64), p (N, K, 3), ri, ro,
    valid, wi, wo."""
    e = ap.e
    src_e = src[:, None, :]
    dst_e = dst[:, None, :]
    p, pvalid = utd.fermat_point_to(ap.v, e, ap.tff, ap.nff, ap.half_l,
                                    src_e, dst_e)
    ui = src_e - p
    uo = dst_e - p
    ri = vec.safe_length(ui)
    ro = vec.safe_length(uo)
    wi = ui / ri.clamp_min(1e-20)[..., None]
    wo = uo / ro.clamp_min(1e-20)[..., None]
    # ignore rays into the wedge
    side_i = ((wi * ap.nff).sum(-1) > 0) | ((wi * ap.nbf).sum(-1) > 0)
    side_o = ((wo * ap.nff).sum(-1) > 0) | ((wo * ap.nbf).sum(-1) > 0)
    Ds, Dh = utd.utd_coefficients(k[:, None], wi, wo, ro, e, ap.tff,
                                  ap.nff, ap.alpha)
    valid = ap.valid & pvalid & side_i & side_o
    zero = torch.zeros((), dtype=Ds.dtype, device=Ds.device)
    w = ap.w.to(Ds.dtype)
    return dict(Ds=torch.where(valid, Ds * w, zero),
                Dh=torch.where(valid, Dh * w, zero), p=p, ri=ri, ro=ro,
                valid=valid, wi=wi, wo=wo)


def coherent_sum(ev, k, src, dst, direct_visible, edge_unshadowed=None):
    """Σ_edges e^{-ik·d}·D + direct term, with phases relative to the
    direct path length (in f32, as the JAX package takes them). Returns
    (ts, th) complex64 (N,)."""
    d_ref = vec.safe_length(dst - src)
    d_e = ev["ri"] + ev["ro"]
    dphase = (d_e - d_ref[:, None]) * k[:, None]
    ok = ev["valid"]
    if edge_unshadowed is not None:
        ok = ok & edge_unshadowed
    zero = torch.zeros((), dtype=torch.complex64, device=dphase.device)
    one = torch.ones((), dtype=torch.complex64, device=dphase.device)
    phase = torch.where(ok, torch.exp(-1j * dphase.to(torch.complex64)),
                        zero)
    ts = (phase * ev["Ds"]).sum(1) + torch.where(direct_visible, one, zero)
    th = (phase * ev["Dh"]).sum(1) + torch.where(direct_visible, one, zero)
    return ts, th


def fsd_intensity(ts, th):
    """Unpolarized FSD intensity factor (|ts|² + |th|²)/2."""
    return 0.5 * (ts.abs() ** 2 + th.abs() ** 2)


def fsd_sample(ap: FsdAperture, k, src, wp, u4):
    """Sample an outgoing diffracted direction or the direct term.

    src: previous vertex; wp: interaction centre; u4 (N, 4) uniforms (edge
    pick, point-on-edge, branch pick, gaussian via inverse-normal).
    Returns dict: wo (N,3), p (N,3), is_direct (N,), pdf (N,), valid (N,).
    """
    N, K = ap.valid.shape
    cnt = ap.count()
    total = cnt + 1                           # + direct term
    pick = torch.floor(u4[:, 0] * total.to(torch.float32)).to(torch.int32)
    pick = pick.clamp(0, K)
    is_direct = pick >= cnt

    # map pick to the pick-th valid slot (first match, as jnp.argmax)
    order = torch.cumsum(ap.valid.to(torch.int32), dim=1) - 1
    slot_match = (order == pick[:, None]) & ap.valid
    slot = slot_match.to(torch.int32).argmax(dim=1)
    rows = torch.arange(N, device=slot.device)

    v = ap.v[rows, slot]
    e = ap.e[rows, slot]
    nff = ap.nff[rows, slot]
    tff = ap.tff[rows, slot]
    nbf = ap.nbf[rows, slot]
    hl = ap.half_l[rows, slot]

    p = v + ((u4[:, 1] - 0.5) * 2.0 * hl)[:, None] * e
    ui = src - p
    okside = (vec.dot(ui, nff) > 0) | (vec.dot(ui, nbf) > 0)
    ri = vec.safe_length(ui)
    wi = ui / ri.clamp_min(1e-20)[:, None]

    phii = torch.atan2(vec.dot(nff, wi), vec.dot(tff, wi))
    sigma = torch.sqrt(SIGMA_SCALE / (k * ri).clamp_min(1e-9))
    gauss = math.sqrt(2.0) * torch.erfinv(
        (2.0 * u4[:, 3] - 1.0).clamp(-0.999999, 0.999999))
    mean_phi = torch.where(u4[:, 2] < 0.5, math.pi + phii, math.pi - phii)
    phio = mean_phi + sigma * gauss

    cos_beta = vec.dot(wi, e)
    sin_beta = vec.safe_sqrt(1.0 - cos_beta ** 2, 1e-24)
    wo = (sin_beta * torch.cos(phio))[:, None] * tff \
        + (sin_beta * torch.sin(phio))[:, None] * nff \
        - cos_beta[:, None] * e
    ok = okside & (sin_beta >= utd.UTD_MIN_SIN_BETA) \
        & ((vec.dot(wo, nff) > 0) | (vec.dot(wo, nbf) > 0))
    pdf = fsd_pdf(ap, k, src, wo)
    ok = ok & (pdf > 0)

    # direct branch
    wo_direct = vec.normalize(wp - src, eps=1e-24)
    pdf_direct = 1.0 / total.to(torch.float32)
    return dict(wo=torch.where(is_direct[:, None], wo_direct, wo),
                p=torch.where(is_direct[:, None], wp, p),
                is_direct=is_direct,
                pdf=torch.where(is_direct, pdf_direct, pdf),
                valid=torch.where(is_direct, total > 0, ok))


def fsd_pdf(ap: FsdAperture, k, src, wo):
    """Density of fsd_sample for direction wo."""
    e = ap.e
    src_e = src[:, None, :]
    wo_e = wo[:, None, :]
    p, pvalid = utd.fermat_point_dir(ap.v, e, ap.tff, ap.nff, ap.half_l,
                                     src_e, wo_e)
    ui = src_e - p
    side = (((wo_e * ap.nff).sum(-1) > 0) | ((wo_e * ap.nbf).sum(-1) > 0)) \
        & (((ui * ap.nff).sum(-1) > 0) | ((ui * ap.nbf).sum(-1) > 0))
    ri = vec.safe_length(ui)
    wi = ui / ri.clamp_min(1e-20)[..., None]
    phii = torch.atan2((ap.nff * wi).sum(-1), (ap.tff * wi).sum(-1))
    phio = torch.atan2((ap.nff * wo_e).sum(-1), (ap.tff * wo_e).sum(-1))
    sigma = torch.sqrt(SIGMA_SCALE / (k[:, None] * ri).clamp_min(1e-9))

    def wrap(x):
        y = floor_mod(x.abs(), TWO_PI)
        return torch.where(y > math.pi, y - TWO_PI, y)

    x1 = wrap(phio - (math.pi + phii))
    x2 = wrap(phio - (math.pi - phii))
    apd = (1.0 / math.sqrt(TWO_PI)) / sigma * 0.5 * (
        torch.exp(-0.5 * (x1 / sigma) ** 2)
        + torch.exp(-0.5 * (x2 / sigma) ** 2))
    ok = ap.valid & pvalid & side
    total = ap.count().to(torch.float32) + 1.0
    return torch.where(ok, apd, 0.0).sum(1) / total
