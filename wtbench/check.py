"""The comparison that decides `correct`: what the timed window's calls
returned, against the plain reference (wtbench/reference/).

Each check judges one layer on the samples a `Recorder` kept and gives
one number, which `correct` holds to the cell's limit:
  k1_bad, k2_bad   share of sampled ray rows whose answer the reference
                   rejects;
  k3_bad           share of sampled cones whose 16 minima or count it
                   rejects;
  edges_bad        share of sampled edge-sweep lanes it rejects;
  utd_bad          share of sampled coherent sums further than UTD_TOL
                   (relative to the sum of the terms' magnitudes) from it;
  film_gap         the largest pixel gap of the checked frame's image
                   against the reference's splat and develop of the
                   frame's own samples, over the pixel's scale (the same
                   develop of the samples' magnitudes) + 1e-3 of its mean;
  work_gap         how far the samples that reached the checked frame's
                   film fall short of (or exceed) the frame's work, as a
                   share of it: distinct camera samples splatted, or
                   beams traced to the coverage plane, against resolution²
                   × samples a frame. The film check develops whatever was
                   splatted, so this is what holds a frame to its work.
A float32 answer is accepted where some answer within TOL (1e-5 of the
scene's radius: distances, positions, cone radii) of the exact one gives
it: the reference brackets each query between a narrower and a wider
version of it. `control=True` puts the reference itself, computed in TF32
(wtbench/reference/__init__.py), in the program's place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from wtbench.reference import cones, edges, film, rays, tf32, utd

TOL_SHARE = 1e-5
UTD_TOL = 1e-2
BIG_T = 1e30               # the kernels' miss distance is above this


class Geometry:
    """The reference's scene: triangles (T, 3, 3) f64 on `device`, its
    radius, and (lazily) its wedge edges and their clusters."""

    def __init__(self, tris, device):
        self.tris32 = np.asarray(tris, np.float32)
        self.tris = torch.as_tensor(self.tris32, device=device).double()
        lo = self.tris32.reshape(-1, 3).min(0).astype(np.float64)
        hi = self.tris32.reshape(-1, 3).max(0).astype(np.float64)
        self.radius = 0.5 * float(np.linalg.norm(hi - lo))
        self.tol = TOL_SHARE * self.radius
        self._wedges = None

    @property
    def wedges(self):
        if self._wedges is None:
            w = edges.wedges(self.tris32)
            self._wedges = (w, edges.clusters(w))
        return self._wedges


def _cat(samples):
    keys = samples[0].keys()
    out = {}
    for k in keys:
        v = [s[k] for s in samples]
        if isinstance(v[0], torch.Tensor):
            out[k] = torch.cat(v)
        elif isinstance(v[0], tuple):
            out[k] = tuple(torch.cat([x[j] for x in v]) for j in range(2))
        else:
            out[k] = v
    return out


def _rows(samples, block):
    """The samples in blocks of about `block` rows, concatenated."""
    group, n = [], 0
    for s in samples:
        group.append(s)
        n += next(iter(s.values())).shape[0]
        if n >= block:
            yield _cat(group)
            group, n = [], 0
    if group:
        yield _cat(group)


def k1(samples, geo, control=False):
    bad = total = 0
    for s in _rows(samples, 256):
        tol = geo.tol
        need = s["need"]
        q = rays.queries(geo.tris, s["ro"], s["rd"], s["tmin"], s["tmax"],
                         s["ex"], "f64", tol)
        if control:
            c = rays.queries(geo.tris, s["ro"], s["rd"], s["tmin"],
                             s["tmax"], s["ex"], "tf32")
            t_p, tri_p = c["t"].double(), c["tri"]
        else:
            t_p, tri_p = s["t"].double(), s["tri"].long()
        miss_p = (tri_p < 0) | (t_p >= BIG_T)
        tmin, tmax = s["tmin"].double(), s["tmax"].double()
        tt, m_p = rays.pair(geo.tris, s["ro"], s["rd"], tri_p.clamp_min(0))
        tol_t = tol + 1e-6 * t_p.abs().clamp_max(1e6)
        excluded = (tri_p[:, None] == s["ex"].long()).any(1)
        claim = ~miss_p & ~excluded & (m_p >= -tol) \
            & ((tt - t_p).abs() <= tol_t) \
            & (t_p > tmin - tol) & (t_p <= tmax + tol)
        closest = (t_p <= q["t"] + tol_t) | (q["margin"] < tol)
        near_end = ((q["t"] - tmin).abs() < tol) \
            | ((tmax - q["t"]).abs() < tol)
        miss_ok = miss_p & (~torch.isfinite(q["t"]) | (q["margin"] < tol)
                            | near_end)
        ok = (claim & closest) | miss_ok
        ct, ctri = s["carry"]
        carried = (t_p == ct.double()) & (tri_p == ctri.long())
        ok = torch.where(need, ok, carried)
        bad += int((~ok).sum())
        total += ok.numel()
    return bad, total


def k2(samples, geo, control=False):
    bad = total = 0
    for s in _rows(samples, 256):
        need = s["need"]
        q = rays.queries(geo.tris, s["ro"], s["rd"], s["tmin"], s["tmax"],
                         s["ex"], "f64", geo.tol)
        if control:
            occ = rays.queries(geo.tris, s["ro"], s["rd"], s["tmin"],
                               s["tmax"], s["ex"], "tf32")["possible"]
        else:
            occ = s["occ"].bool()
        ok = torch.where(occ, q["possible"], ~q["robust"])
        ok = torch.where(need, ok, ~occ)
        bad += int((~ok).sum())
        total += ok.numel()
    return bad, total


def _exclude(z, exclude):
    ids = torch.arange(z.shape[1], device=z.device)
    return torch.where(ids[None] == exclude.long()[:, None],
                       torch.full_like(z, math.inf), z)


def k3(samples, geo, control=False):
    bad = total = 0
    for s in _rows(samples, 32):
        tol = geo.tol
        z_lo = _exclude(cones.triangle_entries(geo.tris, s, "f64", tol),
                        s["exclude"])
        z_hi = _exclude(cones.triangle_entries(geo.tris, s, "f64", -tol),
                        s["exclude"])
        if control:
            z = _exclude(cones.triangle_entries(geo.tris, s, "tf32"),
                         s["exclude"])
            zc = torch.stack([torch.where(z >= tf32(s["bnd"][:, j:j + 1]),
                                          z, math.inf).min(1).values
                              for j in range(s["bnd"].shape[1])], 1)
            cnt = torch.isfinite(z).sum(1)
        else:
            zc, cnt = s["zc"].double(), s["cnt"].long()
        zmax = s["zmax"].double()[:, None]
        ok = (torch.isfinite(z_hi).sum(1) <= cnt) \
            & (cnt <= torch.isfinite(z_lo).sum(1))
        for j in range(s["bnd"].shape[1]):
            b = s["bnd"][:, j:j + 1].double()
            may = torch.isfinite(z_lo) & (z_hi >= b - tol) \
                & (b - tol <= zmax + tol)
            lo = torch.where(may, torch.maximum(z_lo, b - tol),
                             math.inf).min(1).values
            sure = torch.isfinite(z_hi) & (z_lo >= b + tol)
            hi = torch.where(sure, z_hi, math.inf).min(1).values
            m = zc[:, j].double()
            fin = torch.isfinite(m)
            ok &= torch.where(fin, (m >= lo - tol) & (m <= hi + tol),
                              ~torch.isfinite(hi))
        bad += int((~ok).sum())
        total += ok.numel()
    return bad, total


def _edges_answer_tf32(w, cl, s, K):
    cand, z = edges.sweep(w, cl, s, "tf32")
    zs, order = torch.sort(z, dim=1, stable=True)
    zs, order = zs[:, :K], order[:, :K]
    idx = torch.where(torch.isfinite(zs), cand.gather(1, order), -1)
    return idx, zs, torch.isfinite(zs).sum(1)


def edge_sweep(samples, geo, control=False):
    """A lane's answer is accepted where each edge it returns is one of
    its candidates that the cone meets, at an entry z within the
    bracket, the count lies between the robust and the possible
    entries', and no robust candidate it leaves out enters before the
    last it returns. Robust: the narrower cone, its window narrowed by
    TOL at both ends, still meets the edge."""
    bad = total = 0
    w, cl = geo.wedges
    for s in _rows(samples, 64):
        K = s["K"][0]
        tol = geo.tol
        cand, z_lo = edges.sweep(w, cl, s, "f64", tol)
        _, z_hi = edges.sweep(w, cl, s, "f64", -tol)
        if control:
            idx, zp, cnt = _edges_answer_tf32(w, cl, s, K)
        else:
            idx, zp, cnt = s["idx"].long(), s["z"].double(), s["cnt"].long()
        zp = zp.double()
        slot = torch.arange(K, device=idx.device)[None]
        used = slot < cnt[:, None]
        match = (idx[:, :, None] == cand[:, None, :]) & used[:, :, None]
        found = match.any(2)
        pos = match.to(torch.int8).argmax(2)
        zlo_p = z_lo.gather(1, pos)
        zhi_p = z_hi.gather(1, pos)
        slot_ok = torch.where(
            used, found & torch.isfinite(zlo_p) & (zp >= zlo_p - tol)
            & (zp <= zhi_p + tol),
            (idx == -1) & ~torch.isfinite(zp))
        ok = slot_ok.all(1)
        robust = torch.isfinite(z_hi)
        n_rob = robust.sum(1).clamp_max(K)
        n_pos = torch.isfinite(z_lo).sum(1).clamp_max(K)
        ok &= (n_rob <= cnt) & (cnt <= n_pos)
        returned = match.any(1)
        zlast = torch.where(used, zp, -math.inf).max(1).values
        missing = robust & ~returned & (cand >= 0)
        full = cnt >= K
        ok &= torch.where(full, ~(missing & (z_lo < zlast[:, None] - tol))
                          .any(1), ~missing.any(1))
        bad += int((~ok).sum())
        total += ok.numel()
    return bad, total


def _np(x):
    return x.detach().cpu().numpy()


def _tf32_np(x):
    return _np(tf32(torch.as_tensor(x)))


def utd_sums(samples, k0, control=False):
    bad = total = 0
    for s in samples:
        ap = {k: _np(s[k]) for k in ("v", "half_l", "nff", "tff", "nbf",
                                     "alpha", "w", "valid")}
        args = (ap, k0, _np(s["src"]), _np(s["dst"]), _np(s["direct"]),
                _np(s["unshadowed"]))
        ts_r, th_r, scale = utd.coherent_sum(*args)
        if control:
            apc = {k: (_tf32_np(v) if v.dtype != bool else v)
                   for k, v in ap.items()}
            ts_p, th_p, _ = utd.coherent_sum(
                apc, float(_tf32_np(np.float32(k0))), _tf32_np(args[2]),
                _tf32_np(args[3]), args[4], args[5], dtype=np.float32)
        else:
            ts_p, th_p = _np(s["ts"]), _np(s["th"])
        gap = 0.5 * (np.abs(ts_p - ts_r) + np.abs(th_p - th_r)) \
            / np.maximum(scale, 1e-30)
        gap = np.where(scale > 0, gap, np.abs(ts_p) + np.abs(th_p))
        bad += int((~(gap <= UTD_TOL)).sum())
        total += gap.size
    return bad, total


def film_gap(img_p, ref, scale):
    """The largest pixel gap over the pixel's scale (the developed image
    of the samples' magnitudes) plus 1e-3 of its mean: a float32 sum of
    terms of either sign errs relative to the sum of their magnitudes."""
    ref, scale = ref.detach().cpu().double(), scale.detach().cpu().double()
    img_p = torch.as_tensor(np.asarray(img_p)).double()
    den = scale + 1e-3 * scale.mean()
    return float(((img_p - ref).abs() / den.clamp_min(1e-300)).max())


def _magnitudes(splats, at):
    return [tuple(x.abs() if i == at else x for i, x in enumerate(s))
            for s in splats]


def camera_film(splats, img_p, shape, sigma, control=False):
    H, W, C = shape
    ref = film.camera_image(splats, H, W, C, sigma, "f64")
    scale = film.camera_image(_magnitudes(splats, 1), H, W, C, sigma, "f64")
    if control:
        img_p = film.camera_image(splats, H, W, C, sigma, "tf32").cpu()
    return film_gap(img_p, ref, scale)


def coverage_film(beams, points, img_p, shape, spe, control=False):
    H, W, C = shape
    ref = film.coverage_map(beams, points, H, W, C, spe, "f64")
    scale = film.coverage_map(_magnitudes(beams, 2), _magnitudes(points, 1),
                              H, W, C, spe, "f64")
    if control:
        img_p = film.coverage_map(beams, points, H, W, C, spe, "tf32").cpu()
    return film_gap(img_p, ref, scale)


def camera_work(splats, shape, spp):
    """(missing or surplus samples, the frame's work): the distinct film
    positions of the camera samples splatted (mask on) in the frame,
    against resolution² × spp. Each (pixel, sample) pair is one path that
    splats once, at its pixel plus its own jitter."""
    H, W, _ = shape
    keys = [pos[mask].float().contiguous().view(torch.int32).long()
            for pos, _, mask in splats]
    keys = torch.cat(keys) if keys else torch.zeros((0, 2), dtype=torch.long)
    seen = torch.unique((keys[:, 0] << 32) | (keys[:, 1] & 0xFFFFFFFF)
                        ).numel()
    want = H * W * spp
    return abs(seen - want), want


def coverage_work(beams, shape, spe):
    """(missing or surplus beams, the frame's work): the beams traced and
    handed to the coverage plane's splat (one row a beam, whether or not
    it reached the plane), against resolution² × samples an element."""
    H, W, _ = shape
    seen = sum(int(b[0].shape[0]) for b in beams)
    want = H * W * spe
    return abs(seen - want), want
