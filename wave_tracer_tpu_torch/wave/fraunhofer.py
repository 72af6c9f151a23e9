"""Fraunhofer free-space diffraction — the plt_bdpt FSD flavour.

Port of wave_tracer_tpu/wave/fraunhofer.py. The aperture is the set of
2D-projected edge segments clipped to the beam cross-section, each
carrying complex amplitudes a_b = a(v1)−a(v2) and iab/2 = i(a(v1)+a(v2))/2
from the Gaussian wavefront; the angular scattering function (ASF) is the
coherent |Σ_b Ψ_b(ξ)|² over the analytic lobes α1/α2 with the mask χe,
plus a 0th-order Gaussian lobe χ0.

ξ is sampled from inverse-CDF tables of the masked lobes on a tan-warped
grid, built here by the port's own numpy copy of the JAX module's
`_build_luts` and held in memory (built once per process, well under a
second). The conditional CDF is searched by a fixed 11-step binary
search per draw, which gives the same index as the JAX module's count of
`cdf < u` over the gathered row without gathering it.

Every function takes ξ of shape (N, 2) or (N, M, 2) against an aperture
of (N, B) edge slots: the (N, M) form evaluates M draws per lane without
copying the aperture M times.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

INV_TWO_PI = 1.0 / (2.0 * math.pi)

# Published lobe-power constants: ∫ χe·|α1|² and ∫ χe·|α2|²
PA1 = 0.0049361075794549872500
PA2 = 0.21899789398059305541
P0_SIGMA = 0.288675134594813 / 4.0
CHI = 0.830092714835359
WO2_CUTOFF = 0.85
FSD_UNIT_M = 1e-3     # canonical space is mm-based (fsd_unit = 1 mm)

_LUT_RES = 1024
_LUT_WARP = 4.0       # ζ = s·tan(θ): covers the full plane, fine near 0
_SEARCH_STEPS = (_LUT_RES + 1).bit_length()     # 11: 2^11 > R + 1


def _sinc(x):
    return torch.sinc(x / math.pi)      # sin(x)/x


def alpha1(zx, zy):
    """(1/2π)·y/(x(x²+y²))·(cos(x/2) − sinc(x/2)), continuous at x = 0."""
    x = torch.where(zx.abs() < 1e-9, 1e-9, zx)
    r2 = x * x + zy * zy
    return INV_TWO_PI * zy / (x * r2.clamp_min(1e-30)) \
        * (torch.cos(0.5 * x) - _sinc(0.5 * x))


def alpha2(zx, zy):
    """(1/2π)·y/(x²+y²)·sinc(x/2), continuous at x = 0."""
    x = torch.where(zx.abs() < 1e-9, 1e-9, zx)
    r2 = x * x + zy * zy
    return INV_TWO_PI * zy / r2.clamp_min(1e-30) * _sinc(0.5 * x)


def _chi(r2):
    """χe at squared radius r2. The numerator 3 is a tensor: torch turns
    `3.0 / x` into 3·(1/x), which rounds twice, and the mask is a
    difference of O(1) terms near 0."""
    t = 1.0 + CHI * r2
    return (1.0 - (t.new_tensor(3.0) / (t * t) - 2.0 / (t * t * t))
            ).clamp_min(0.0)


def chi_e(xi):
    """Diffracted-lobe mask."""
    return _chi((xi * xi).sum(-1))


def chi_0(xi):
    """0th-order-lobe mask."""
    xi2 = (xi * xi).sum(-1) / (P0_SIGMA * P0_SIGMA)
    return torch.exp(-0.5 * xi2)


@dataclasses.dataclass
class FraunhoferAperture:
    """(N, B) edge slots in the beam's cross-section frame (canonical fsd
    units: lengths premultiplied so ξ is dimensionless)."""
    e: torch.Tensor         # (N, B, 2) edge vector
    v: torch.Tensor         # (N, B, 2) midpoint
    a_b: torch.Tensor       # (N, B) complex64
    iab_2: torch.Tensor     # (N, B) complex64
    valid: torch.Tensor     # (N, B) bool
    edge_pdf: torch.Tensor  # (N, B) normalized lobe-power pdfs
    P0: torch.Tensor        # (N,)
    P0_pdf: torch.Tensor    # (N,)
    psi02: torch.Tensor     # (N,)
    total: torch.Tensor     # (N,) unnormalized ∫ASF dξ (edge powers + P0)

    def items(self):
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)]

    def map(self, fn):
        """A new aperture with fn applied to every field."""
        return FraunhoferAperture(**{k: fn(v) for k, v in self.items()})


def _per_draw(a, xi):
    """An aperture field (N, ...) aligned with draws xi (N, [M,] 2): a
    draw axis is inserted after the lanes for the (N, M) form."""
    return a.unsqueeze(1) if xi.dim() == 3 else a


def _zeta(ap: FraunhoferAperture, xi):
    """ζ = ξ·Ξ with Ξ = [e, m], m = (e.y, −e.x): per-edge (..., B)."""
    e = _per_draw(ap.e, xi)
    ex, ey = e[..., 0], e[..., 1]
    xix = xi[..., 0:1]
    xiy = xi[..., 1:2]
    return xix * ex + xiy * ey, xix * ey - xiy * ex


def psi(ap: FraunhoferAperture, xi):
    """Per-edge complex amplitude Ψ_b(ξ) (..., B)."""
    zx, zy = _zeta(ap, xi)
    a_b, iab_2 = _per_draw(ap.a_b, xi), _per_draw(ap.iab_2, xi)
    e, v = _per_draw(ap.e, xi), _per_draw(ap.v, xi)
    a1 = a_b * alpha1(zx, zy).to(torch.complex64)
    a2 = iab_2 * alpha2(zx, zy).to(torch.complex64)
    ee2 = (e * e).sum(-1)
    vxi = v[..., 0] * xi[..., 0:1] + v[..., 1] * xi[..., 1:2]
    phase = torch.polar(torch.ones_like(vxi), -vxi)
    out = ee2.to(torch.complex64) * phase * (a1 + a2)
    return torch.where(_per_draw(ap.valid, xi), out, 0.0)


def asf_unclamped(ap: FraunhoferAperture, xi):
    """|Σ_b Ψ_b|² → (...,)."""
    return psi(ap, xi).sum(-1).abs() ** 2


def asf(ap: FraunhoferAperture, xi):
    """Full ASF with masking and the 0th-order lobe P0·χ0/(2π·σ0²), in
    the ξ-measure of the edge-lobe powers, so ∫ASF dξ = total."""
    return asf_unclamped(ap, xi) * chi_e(xi) \
        + _per_draw(ap.P0, xi) * INV_TWO_PI / P0_SIGMA ** 2 * chi_0(xi)


def sampling_density(ap: FraunhoferAperture, xi):
    """Incoherent per-edge |Ψ|² + 0th lobe."""
    zx, zy = _zeta(ap, xi)
    a1 = _per_draw(ap.a_b, xi).abs() * alpha1(zx, zy).abs()
    a2v = _per_draw(ap.iab_2, xi).abs() * alpha2(zx, zy).abs()
    e = _per_draw(ap.e, xi)
    ee2 = (e * e).sum(-1)
    psi2 = ee2 ** 2 * (a1 ** 2 + a2v ** 2)
    diff = torch.where(_per_draw(ap.valid, xi), psi2, 0.0).sum(-1)
    return diff * chi_e(xi) + _per_draw(ap.P0, xi) * INV_TWO_PI \
        / P0_SIGMA ** 2 * chi_0(xi)


def edge_powers(e, a_b, iab_2):
    """Per-edge lobe powers Pa1 + Pa2."""
    ee2 = (e * e).sum(-1)
    return ee2 ** 2 * (PA1 * a_b.abs() ** 2 + PA2 * iab_2.abs() ** 2)


def empty_fr_aperture(N, B, device="cpu"):
    """All-invalid aperture with B slots."""
    z = dict(dtype=torch.float32, device=device)
    c = dict(dtype=torch.complex64, device=device)
    return FraunhoferAperture(
        e=torch.zeros((N, B, 2), **z), v=torch.zeros((N, B, 2), **z),
        a_b=torch.zeros((N, B), **c), iab_2=torch.zeros((N, B), **c),
        valid=torch.zeros((N, B), dtype=torch.bool, device=device),
        edge_pdf=torch.zeros((N, B), **z), P0=torch.zeros((N,), **z),
        P0_pdf=torch.zeros((N,), **z), psi02=torch.zeros((N,), **z),
        total=torch.zeros((N,), **z))


# the 0th-order power's 8-direction ASF ring probe, radius 3σ0
_RING = (3.0 * P0_SIGMA * np.stack([
    [-math.sqrt(0.5), -math.sqrt(0.5)], [-1, 0],
    [-math.sqrt(0.5), math.sqrt(0.5)], [0, 1],
    [math.sqrt(0.5), math.sqrt(0.5)], [1, 0],
    [math.sqrt(0.5), -math.sqrt(0.5)], [0, -1]]).astype(np.float32))


def build_aperture(seg_p1, seg_p2, amp1, amp2, valid, p0_scale):
    """Assemble an aperture from clipped projected segments: endpoints
    seg_p1/p2 (N, B, 2) in canonical coordinates, complex wavefront
    amplitudes amp1/amp2 (N, B) at them; p0_scale (N,) = k·fsd_unit
    divides the 0th-order lobe power by its square."""
    N = seg_p1.shape[0]
    e = seg_p2 - seg_p1
    v = 0.5 * (seg_p1 + seg_p2)
    a_b = (amp1 - amp2).to(torch.complex64)
    iab_2 = (0.5j) * (amp1 + amp2).to(torch.complex64)
    pj = edge_powers(e, a_b, iab_2)
    valid = valid & (pj > 0)
    pj = torch.where(valid, pj, 0.0)
    zero = torch.zeros((N,), dtype=torch.float32, device=e.device)
    ap = FraunhoferAperture(
        e=e, v=v, a_b=torch.where(valid, a_b, 0.0),
        iab_2=torch.where(valid, iab_2, 0.0), valid=valid, edge_pdf=pj,
        P0=zero, P0_pdf=zero, psi02=zero, total=zero)
    ring = asf_unclamped(ap, torch.as_tensor(_RING, device=e.device)
                         .expand(N, 8, 2))           # (N, 8), one batch
    acc = zero
    for i in range(8):
        acc = acc + ring[:, i]
    psi02 = acc / 8.0
    P0 = 2.0 * math.pi * P0_SIGMA ** 2 * psi02 \
        / (p0_scale ** 2).clamp_min(1e-30)
    total = pj.sum(1) + P0
    tot = total.clamp_min(1e-30)
    return dataclasses.replace(
        ap, psi02=psi02, P0=P0, P0_pdf=torch.where(total > 0, P0 / tot, 1.0),
        edge_pdf=pj / tot[:, None], total=total)


# ---------------------------------------------------------------------------
# sampling: inverse-CDF tables over the canonical lobes
# ---------------------------------------------------------------------------

def _build_luts():
    """Marginal/conditional CDFs of χe·|α1|², χe·|α2|² on the tan-warped
    grid ζ = 4·tan(θ) (the numpy twin of the JAX module's tables)."""
    th = np.linspace(-np.pi / 2 + 1e-6, np.pi / 2 - 1e-6, _LUT_RES + 1)
    z = _LUT_WARP * np.tan(th)                       # cell boundaries
    zc = 0.5 * (z[1:] + z[:-1])                      # cell centres
    dz = np.diff(z)
    X, Y = np.meshgrid(zc, zc, indexing="ij")

    def np_sinc(v):
        return np.sinc(v / np.pi)

    xs = np.where(np.abs(X) < 1e-9, 1e-9, X)
    r2 = xs * xs + Y * Y
    a1 = INV_TWO_PI * Y / (xs * r2) * (np.cos(0.5 * xs)
                                       - np_sinc(0.5 * xs))
    a2 = INV_TWO_PI * Y / r2 * np_sinc(0.5 * xs)
    t = 1.0 + CHI * r2
    chie = np.maximum(0.0, 1.0 - (3.0 / t ** 2 - 2.0 / t ** 3))
    cell = np.outer(dz, dz)                          # cell areas
    out = {}
    for name, a in (("a1", a1), ("a2", a2)):
        d = a * a * chie * cell                      # per-cell mass
        out[f"{name}_z"] = np.float32(d.sum())       # true lobe integral
        px = d.sum(axis=1)
        cx = np.concatenate([[0], np.cumsum(px)])
        cx = cx / cx[-1]
        cy = np.concatenate([np.zeros((_LUT_RES, 1)),
                             np.cumsum(d, axis=1)], axis=1)
        cy = cy / np.maximum(cy[:, -1:], 1e-300)
        out[f"{name}_cx"] = cx.astype(np.float32)    # (R+1,)
        out[f"{name}_cy"] = cy.astype(np.float32)    # (R, R+1)
    out["grid"] = z.astype(np.float32)               # boundaries (R+1,)
    return out


@functools.lru_cache(maxsize=1)
def _host_luts():
    return _build_luts()


@functools.lru_cache(maxsize=4)
def luts(device):
    """The tables as tensors on `device`, and the two lobe integrals."""
    h = _host_luts()
    t = {k: torch.from_numpy(np.asarray(v)).to(device)
         for k, v in h.items() if k.endswith(("_cx", "_cy")) or k == "grid"}
    t["a1_cy"] = t["a1_cy"].reshape(-1)
    t["a2_cy"] = t["a2_cy"].reshape(-1)
    return t, float(h["a1_z"]), float(h["a2_z"])


def _interp(bounds_at, i, u):
    """Fractional cell index from cell i's bounds (linear inside)."""
    c0 = bounds_at(i)
    c1 = bounds_at(i + 1)
    frac = (u - c0) / (c1 - c0).clamp_min(1e-30)
    return i.to(torch.float32) + frac.clamp(0.0, 1.0)


def _inv_cdf_marginal(cx, u):
    """Inverse of the shared marginal CDF cx (R+1,): the count of
    cx < u, as a left search, minus one."""
    cnt = torch.searchsorted(cx, u.contiguous(), side="left")
    i = (cnt - 1).clamp(0, _LUT_RES - 1)
    return _interp(lambda j: cx[j], i, u)


def _inv_cdf_rows(cy_flat, row, u):
    """Inverse of the conditional CDFs cy (R, R+1) (flattened) at each
    draw's row: a fixed-step binary search for the count of entries < u,
    then as `_inv_cdf_marginal`."""
    W = _LUT_RES + 1
    base = row * W
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, W)
    for _ in range(_SEARCH_STEPS):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        open_ = lo < hi
        go = open_ & (cy_flat[base + mid.clamp_max(W - 1)] < u)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(open_ & ~go, mid, hi)
    i = (lo - 1).clamp(0, _LUT_RES - 1)
    return _interp(lambda j: cy_flat[base + j], i, u)


def _grid_at(grid, fidx):
    i = fidx.to(torch.int64).clamp(0, _LUT_RES - 1)
    f = fidx - i
    return grid[i] * (1.0 - f) + grid[i + 1] * f


def _sample_lobe(tabs, name, u1, u2):
    """Inverse-CDF sample of a canonical lobe → ζ (..., 2)."""
    fx = _inv_cdf_marginal(tabs[f"{name}_cx"], u1)
    zx = _grid_at(tabs["grid"], fx)
    row = fx.to(torch.int64).clamp(0, _LUT_RES - 1)
    fy = _inv_cdf_rows(tabs[f"{name}_cy"], row, u2)
    zy = _grid_at(tabs["grid"], fy)
    return torch.stack([zx, zy], dim=-1)




def proposal_density(ap: FraunhoferAperture, xi):
    """Exact density of the mixture `sample_xi` draws from (0th-order
    Gaussian + per-edge masked-lobe draws mapped by Ξ⁻¹)."""
    _, z1, z2 = luts(xi.device)
    zx, zy = _zeta(ap, xi)
    e = _per_draw(ap.e, xi)
    ee2 = (e * e).sum(-1)
    p1 = ee2 ** 2 * PA1 * _per_draw(ap.a_b, xi).abs() ** 2
    p2 = ee2 ** 2 * PA2 * _per_draw(ap.iab_2, xi).abs() ** 2
    w1 = p1 / (p1 + p2).clamp_min(1e-30)
    chie = _chi(zx * zx + zy * zy)
    l1 = chie * alpha1(zx, zy) ** 2 / z1
    l2 = chie * alpha2(zx, zy) ** 2 / z2
    per_edge = _per_draw(ap.edge_pdf, xi) * ee2 * (w1 * l1 + (1.0 - w1) * l2)
    g_edges = torch.where(_per_draw(ap.valid, xi), per_edge, 0.0).sum(-1)
    xi2 = (xi * xi).sum(-1)
    g0 = _per_draw(ap.P0_pdf, xi) * torch.exp(-0.5 * xi2 / P0_SIGMA ** 2) \
        * INV_TWO_PI / P0_SIGMA ** 2
    return g_edges + g0


def _gather_b(a, bi):
    """a (N, B, ...) at per-draw slots bi (N, M) → (N, M, ...)."""
    idx = bi.reshape(bi.shape + (1,) * (a.dim() - 2))
    return torch.gather(a, 1, idx.expand(bi.shape + a.shape[2:]))


def sample_xi(ap: FraunhoferAperture, u4):
    """Sample ξ from the aperture's lobe mixture. u4 (N, M, 4): lobe
    pick, edge pick, 2 for the shape. Returns (xi (N, M, 2), proposal
    density (N, M), is_zero_order (N, M))."""
    tabs, _, _ = luts(u4.device)
    pick0 = u4[..., 0] < ap.P0_pdf[:, None]
    # 0th order: gaussian of σ = P0_SIGMA (Box-Muller from u[2], u[3])
    r = P0_SIGMA * torch.sqrt(-2.0 * torch.log(u4[..., 2].clamp_min(1e-12)))
    th = 2.0 * math.pi * u4[..., 3]
    xi0 = torch.stack([r * torch.cos(th), r * torch.sin(th)], dim=-1)

    # edge pick proportional to edge_pdf
    cdf = torch.cumsum(ap.edge_pdf, dim=1)               # (N, B)
    tot = cdf[:, -1:].clamp_min(1e-30)
    tgt = u4[..., 1] * tot                               # (N, M)
    bi = (cdf[:, None, :] < tgt[..., None]).sum(-1)
    bi = bi.clamp(0, ap.e.shape[1] - 1)
    e_sel = _gather_b(ap.e, bi)
    a_b = _gather_b(ap.a_b, bi)
    iab = _gather_b(ap.iab_2, bi)
    # choose α1 vs α2 sub-lobe by power share
    ee2 = (e_sel * e_sel).sum(-1)
    p1 = ee2 ** 2 * PA1 * a_b.abs() ** 2
    p2 = ee2 ** 2 * PA2 * iab.abs() ** 2
    ptot = (p1 + p2).clamp_min(1e-30)
    use1 = u4[..., 2] * ptot < p1
    # conditional rescale: u[2] stays uniform given the branch it selected
    u_cond = torch.where(use1, u4[..., 2] * ptot / p1.clamp_min(1e-30),
                         (u4[..., 2] * ptot - p1) / p2.clamp_min(1e-30))
    u_cond = u_cond.clamp(0.0, 1.0 - 1e-7)
    z1 = _sample_lobe(tabs, "a1", u4[..., 3], u_cond)
    z2 = _sample_lobe(tabs, "a2", u4[..., 3], u_cond)
    zeta = torch.where(use1[..., None], z1, z2)
    # ξ = ζ·Ξ⁻¹; Ξ = [e, m] with |det| = ee2
    ex, ey = e_sel[..., 0], e_sel[..., 1]
    det = ee2.clamp_min(1e-20)
    xi_e = torch.stack([(zeta[..., 0] * ex + zeta[..., 1] * ey) / det,
                        (zeta[..., 0] * ey - zeta[..., 1] * ex) / det],
                       dim=-1)
    xi = torch.where(pick0[..., None], xi0, xi_e)
    return xi, proposal_density(ap, xi), pick0


def sample_xi_sir(ap: FraunhoferAperture, uM4, u_pick):
    """Unbiased resampled-importance-sampling draw of ξ ~ ASF: M
    proposals from the exact mixture density g, one picked ∝ w = ASF/g.
    uM4 (N, M, 4): per-proposal uniforms; u_pick (N,). Returns (xi (N, 2),
    asf (N,) at the winner, w_ris (N,) = (1/M)·Σ_k w_k, valid)."""
    M = uM4.shape[1]
    xi_m, dens_m, _ = sample_xi(ap, uM4)                 # (N, M, ...)
    asf_m = asf(ap, xi_m)
    w = torch.where(dens_m > 0, asf_m / dens_m.clamp_min(1e-30), 0.0)
    w = torch.where(torch.isfinite(w), w, 0.0)
    W = w.sum(1)
    cdf = torch.cumsum(w, dim=1)
    tgt = u_pick * W
    pick = (cdf < tgt[:, None]).sum(1).clamp(0, M - 1)
    xi = _gather_b(xi_m, pick[:, None])[:, 0]
    asf_v = torch.gather(asf_m, 1, pick[:, None])[:, 0]
    valid = (W > 0) & torch.isfinite(asf_v)
    return xi, asf_v, W / M, valid


def xi_to_wo(xi, scale):
    """Canonical ξ → local direction (tan → sin per component, cutoff).
    Returns (wo (N, 3) in the beam frame, valid)."""
    zeta = xi / scale[..., None]
    wol = zeta / torch.sqrt(1.0 + zeta * zeta)
    wo2 = (wol * wol).sum(-1)
    ok = wo2 < WO2_CUTOFF
    z = torch.sqrt((1.0 - wo2).clamp_min(1e-6))
    return torch.cat([wol, z[..., None]], dim=-1), ok


def wo_to_xi(wol, scale):
    """Local direction → canonical ξ (sin → tan). Returns (xi, valid)."""
    w2 = wol[..., :2]
    wo2 = (w2 * w2).sum(-1)
    ok = (wol[..., 2] > 0) & (wo2 < WO2_CUTOFF)
    zeta = w2 / torch.sqrt((1.0 - w2 * w2).clamp_min(1e-6))
    return zeta * scale[..., None], ok


# ---------------------------------------------------------------------------
# 3D aperture construction from swept edge queries
# ---------------------------------------------------------------------------

def build_aperture_3d(edges, idx, origin, rd, fx, fy, sigma_m, r_env, k,
                      subdiv: int = 4, curv=None):
    """Project queried edges into the beam cross-section and assemble the
    canonical aperture.

    edges: EdgeTable; idx (N, K) rows (−1 padding); origin (N, 3) on the
    beam axis in the cross-section plane; rd (N, 3) beam direction; fx/fy
    (N, 3) cross-section axes; sigma_m (N,) wavefront σ [m]; r_env (N,)
    envelope radius [m]; k (N,) wavenumber [rad/m]. Per edge: silhouette
    filter dot(d,n1)·dot(d,n2) < 0 → projection onto the cross-section →
    clip to the envelope circle → `subdiv` segments with Gaussian-
    wavefront amplitudes at the split points → canonical mm units.
    curv (N,) optional [rad/m²]: a quadratic wavefront phase, the
    amplitudes gain e^{i·curv·|u|²} with u the cross-section offset [m]
    (k/2·(1/R_src + 1/L_det) pins the fringes of every beam of a source
    cone to one place on a detector at distance L_det).
    Returns (aperture with K·subdiv slots, scale = k·fsd_unit)."""
    N, K = idx.shape
    ok = idx >= 0
    row = edges.pack[idx.clamp_min(0).long()]   # ONE packed gather

    d_n1 = (rd[:, None, :] * row[..., 6:9]).sum(-1)
    d_n2 = (rd[:, None, :] * row[..., 9:12]).sum(-1)
    ok = ok & ((d_n1 * d_n2) < 0.0)

    p0 = row[..., 0:3]
    p1 = p0 + row[..., 3:6] * row[..., 19:20]
    w0 = p0 - origin[:, None, :]
    w1 = p1 - origin[:, None, :]
    u1 = torch.stack([(w0 * fx[:, None, :]).sum(-1),
                      (w0 * fy[:, None, :]).sum(-1)], dim=-1)
    u2 = torch.stack([(w1 * fx[:, None, :]).sum(-1),
                      (w1 * fy[:, None, :]).sum(-1)], dim=-1)

    # clip the 2D segment to the envelope circle |u| ≤ r_env
    dseg = u2 - u1
    aa = (dseg * dseg).sum(-1).clamp_min(1e-30)
    bb = (u1 * dseg).sum(-1)
    cc = (u1 * u1).sum(-1) - r_env[:, None] ** 2
    disc = bb * bb - aa * cc
    ok = ok & (disc > 0.0)
    sq = torch.sqrt(disc.clamp_min(0.0))
    t1 = ((-bb - sq) / aa).clamp(0.0, 1.0)
    t2 = ((-bb + sq) / aa).clamp(0.0, 1.0)
    ok = ok & ((t2 - t1) > 1e-9)

    lin = torch.as_tensor(np.linspace(0.0, 1.0, subdiv + 1,
                                      dtype=np.float32), device=idx.device)
    ts = t1[..., None] + (t2 - t1)[..., None] * lin       # (N, K, S+1)
    pts = u1[..., None, :] + ts[..., None] * dseg[..., None, :]
    uu = (pts * pts).sum(-1)
    s2 = sigma_m[:, None, None] ** 2
    q = uu / s2.clamp_min(1e-30)
    dens = torch.exp(-0.5 * q) / (2.0 * math.pi * s2).clamp_min(1e-30)
    amp = torch.sqrt(dens).to(torch.complex64)
    if curv is not None:
        amp = amp * torch.exp(1j * (curv[:, None, None] * uu).to(
            torch.complex64))

    seg_p1 = pts[..., :-1, :].reshape(N, K * subdiv, 2) / FSD_UNIT_M
    seg_p2 = pts[..., 1:, :].reshape(N, K * subdiv, 2) / FSD_UNIT_M
    amp1 = amp[..., :-1].reshape(N, K * subdiv)
    amp2 = amp[..., 1:].reshape(N, K * subdiv)
    valid = ok[..., None].expand(N, K, subdiv).reshape(N, K * subdiv)
    scale = k * FSD_UNIT_M
    return build_aperture(seg_p1, seg_p2, amp1, amp2, valid,
                          p0_scale=scale), scale
