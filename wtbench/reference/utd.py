"""The coherent UTD sum of the plain reference (NumPy and SciPy).

For a connection src → dst past K wedge slots (centre v, half length,
front-face normal nff and tangent tff, edge e = nff × tff, back-face
normal nbf, interior angle α, boundary window w), each slot diffracts at
its Fermat point on the edge line,
    t = e·(src − v) + e·(dst − src) · s / (s + d),
s and d the distances of src and dst from the line, when |t| ≤ half
length. With n = 2 − α/π, φ = atan2(nff·ŵ, tff·ŵ) of the unit directions
toward the source (φi) and the observer (φo), β the angle between the
incident direction and the edge, L = r_o sin²β and the transition
function F(x) = (1 + i)·√(π/2)·√x·w(√x·e^{i3π/4}) (w the Faddeeva
function, scipy's `wofz`; F(−x) = conj F(x)), the soft and hard
coefficients are (Kouyoumjian and Pathak 1974)
    D = e^{−iπ/4} / (2n √(2π) √(k r_o) max(sin β, 1e-3)),
    D_{s,h} = D·[T(+, Δ) + T(−, Δ) ∓ (T(+, Σ) + T(−, Σ))],
    T(±, β) = cot((π ± β)/2n) F(kL a^±(β)),
Δ = φi − φo, Σ = φi + φo, a^±(β) = 2 cos²(π n N − β/2) with
N = round((±π + β)/(2πn)); zero on a shadow or reflection boundary
(Δ or Σ within 1e-5 above a multiple of π/2). A slot counts where the incident and outgoing rays
both lie outside the wedge and its shadow legs are clear; the sum is
    ts = Σ w·D_s·e^{−ik(r_i + r_o − |dst − src|)} + [direct path clear],
and th alike with D_h.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import wofz

MIN_SIN_BETA = 1e-3


def _F(x):
    sq = np.sqrt(np.abs(x))
    F = (1 + 1j) * math.sqrt(math.pi / 2) * sq \
        * wofz(sq * np.exp(1j * 3 * math.pi / 4))
    F = np.where(x < 0, np.conj(F), F)
    return F.astype(np.complex64) if x.dtype == np.float32 else F


def _a(sgn, b, n):
    N = np.round((sgn * math.pi + b) / (2 * math.pi * n))
    return 2.0 * np.cos(math.pi * n * N - 0.5 * b) ** 2


def _cot(x):
    s = np.sin(x)
    return np.cos(x) / np.where(np.abs(s) < 1e-9, 1e-9, s)


def _dot(a, b):
    return (a * b).sum(-1)


def coherent_sum(ap, k, src, dst, direct_visible, edge_unshadowed,
                 dtype=np.float64):
    # empty slots may hold anything: their NaNs are masked out below
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        return _coherent_sum(ap, k, src, dst, direct_visible,
                             edge_unshadowed, dtype)


def _coherent_sum(ap, k, src, dst, direct_visible, edge_unshadowed, dtype):
    """ap: dict of numpy arrays (n, K, ...) v, half_l, nff, tff, nbf,
    alpha, w, valid; k (n,) or a float; src, dst (n, 3); direct_visible
    (n,) bool; edge_unshadowed (n, K) bool → (ts, th) (n,) and the sum
    of the terms' magnitudes, computed in `dtype` (float64, or float32
    with complex64 for the control)."""
    f = dtype
    v, nff, tff, nbf = (np.asarray(ap[x], f) for x in
                        ("v", "nff", "tff", "nbf"))
    half, alpha, w = (np.asarray(ap[x], f) for x in ("half_l", "alpha", "w"))
    k = np.broadcast_to(np.asarray(k, f), (v.shape[0],))[:, None]
    src = np.asarray(src, f)[:, None, :]
    dst = np.asarray(dst, f)[:, None, :]
    e = np.cross(nff, tff)
    sv, dv = src - v, dst - v
    sl = np.sqrt(_dot(sv, tff) ** 2 + _dot(sv, nff) ** 2)
    dl = np.sqrt(_dot(dv, tff) ** 2 + _dot(dv, nff) ** 2)
    t = _dot(e, sv) + _dot(dst - src, e) * sl / np.maximum(sl + dl, 1e-30)
    p = v + e * t[..., None]
    ok = np.asarray(ap["valid"], bool) & (np.abs(t) <= half) \
        & (_dot(p - src, p - src) > 1e-24) & (_dot(p - dst, p - dst) > 1e-24)
    ui, uo = src - p, dst - p
    ri = np.sqrt(_dot(ui, ui))
    ro = np.sqrt(_dot(uo, uo))
    wi = ui / np.maximum(ri, 1e-20)[..., None]
    wo = uo / np.maximum(ro, 1e-20)[..., None]
    ok &= (_dot(wi, nff) > 0) | (_dot(wi, nbf) > 0)
    ok &= (_dot(wo, nff) > 0) | (_dot(wo, nbf) > 0)

    n = 2.0 - alpha / math.pi
    cos_b = _dot(wi, e)
    sin2 = np.maximum(1.0 - cos_b ** 2, 0.0)
    sin_b = np.sqrt(sin2)
    phi_i = np.arctan2(_dot(nff, wi), _dot(tff, wi))
    phi_o = np.arctan2(_dot(nff, wo), _dot(tff, wo))
    kL = k * ro * sin2
    dphi, sphi = phi_i - phi_o, phi_i + phi_o
    inv2n = 1.0 / (2.0 * n)
    T1 = _cot((math.pi + dphi) * inv2n) * _F(kL * _a(+1, dphi, n))
    T2 = _cot((math.pi - dphi) * inv2n) * _F(kL * _a(-1, dphi, n))
    T3 = _cot((math.pi + sphi) * inv2n) * _F(kL * _a(+1, sphi, n))
    T4 = _cot((math.pi - sphi) * inv2n) * _F(kL * _a(-1, sphi, n))
    D = np.exp(-1j * math.pi / 4) / (
        2.0 * n * math.sqrt(2 * math.pi) * np.sqrt(np.maximum(k * ro, 1e-20))
        * np.maximum(sin_b, MIN_SIN_BETA))
    q = math.pi / 2
    degen = (np.mod(sphi, q) < 1e-5) | (np.mod(dphi, q) < 1e-5)
    Ds = np.where(degen, 0, D * (T1 + T2 - (T3 + T4)))
    Dh = np.where(degen, 0, D * (T1 + T2 + (T3 + T4)))
    keep = ok & np.asarray(edge_unshadowed, bool)
    d_ref = np.sqrt(_dot(dst - src, dst - src))
    phase = np.exp(-1j * k * (ri + ro - d_ref))
    direct = np.asarray(direct_visible, bool).astype(f)
    ts_e = np.where(keep, w * Ds, 0)     # empty slots may hold anything
    th_e = np.where(keep, w * Dh, 0)
    ts = np.where(keep, phase * ts_e, 0).sum(1) + direct
    th = np.where(keep, phase * th_e, 0).sum(1) + direct
    scale = (np.abs(ts_e).sum(1) + np.abs(th_e).sum(1)) / 2 + direct
    return ts, th, scale
