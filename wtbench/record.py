"""Spans of the benchmark around the program's calls into its layers.

`Recorder.install` wraps the program's public entries (module attributes,
so every caller goes through the wrapper) and `uninstall` restores them:
  - the ray kernels' `closest_hit` (K1) and `any_hit` (K2) and the cone
    kernel's `cone_minz` (K3);
  - the edge sweep `edges_in_cone`, and the per-edge UTD evaluation
    `fsd_eval` with the coherent sum `coherent_sum` that reads it;
  - the film's `splat`, `splat_direct` and `splat_direct_gaussian`.
While `checking` is set, each call keeps a sample of its rows, drawn on
the card from the run's seed (rows the call asks for first), with the
inputs and the answers; while `film` is set, the film's splats are kept
whole. With `count_calls` each kernel call also keeps the rows it asks
for and the triangles it reads, for the roofline. Nothing here waits for
the card: what is kept is copied to host memory without a wait
(`_keep`), so that it adds nothing to the card's peak memory, and is
read once the window has closed.
"""

from __future__ import annotations

import torch


def _keep(x):
    """A copy of x that the card fills in host memory in stream order."""
    if x is None or not x.is_cuda:
        return None if x is None else x.clone()
    return x.to("cpu", non_blocking=True)


def _kept(d):
    return {k: (_keep(v) if isinstance(v, torch.Tensor) else
                tuple(_keep(x) for x in v) if isinstance(v, tuple) else v)
            for k, v in d.items()}


def _need(need, n, like):
    if need is None:
        return torch.ones((n,), dtype=torch.bool, device=like.device)
    return need


class Recorder:
    def __init__(self, rows, seed, device, checks, count_calls=False):
        self.rows = rows                 # {"k1": n, ...} rows per call
        self.checks = set(checks)
        self.count_calls = count_calls
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 63))
        self.checking = False
        self.film = False
        self.samples = {k: [] for k in ("k1", "k2", "k3", "edges", "utd")}
        self.splats = {"camera": [], "beam": [], "point": []}
        self.calls = {"k1": [], "k2": [], "k3": []}
        self._evals = {}
        self._saved = []

    # -- sampling ---------------------------------------------------------
    def _pick(self, kind, n, need=None):
        score = torch.rand(n, generator=self.gen, device=self.gen.device)
        if need is not None:
            score = score + need.to(score.dtype)
        return torch.topk(score, min(self.rows[kind], n), sorted=False).indices

    def _on(self, kind):
        return self.checking and kind in self.checks

    # -- wrappers ---------------------------------------------------------
    def _closest_hit(self, orig):
        def closest_hit(tri_feat, center, ro, rd, tmin, tmax, ex, need=None,
                        carry=None, *, table):
            t, tri = orig(tri_feat, center, ro, rd, tmin, tmax, ex, need,
                          carry, table=table)
            n = ro.shape[0]
            if self.count_calls:
                self.calls["k1"].append((n if need is None else need.sum(),
                                         tri_feat.shape[0]))
            if self._on("k1") and n:
                i = self._pick("k1", n, need)
                if carry is None:       # the kernel's miss
                    carry = (torch.full_like(t, 3.4e38),
                             torch.full_like(tri, -1))
                self.samples["k1"].append(_kept(dict(
                    ro=ro[i], rd=rd[i], tmin=tmin[i], tmax=tmax[i], ex=ex[i],
                    need=_need(need, n, ro)[i],
                    carry=(carry[0][i], carry[1][i]), t=t[i], tri=tri[i])))
            return t, tri
        return closest_hit

    def _any_hit(self, orig):
        def any_hit(tri_feat, center, ro, rd, tmin, tmax, ex, need=None, *,
                    table):
            occ = orig(tri_feat, center, ro, rd, tmin, tmax, ex, need,
                       table=table)
            n = ro.shape[0]
            if self.count_calls:
                self.calls["k2"].append((n if need is None else need.sum(),
                                         tri_feat.shape[0]))
            if self._on("k2") and n:
                i = self._pick("k2", n, need)
                self.samples["k2"].append(_kept(dict(
                    ro=ro[i], rd=rd[i], tmin=tmin[i], tmax=tmax[i], ex=ex[i],
                    need=_need(need, n, ro)[i], occ=occ[i])))
            return occ
        return any_hit

    def _cone_minz(self, orig):
        def cone_minz(tri, ro, rd, xh, e, x0, ta, zmax, exclude, bnd,
                      zmin=1e-7, *, table, stats=None, winners=False):
            out = orig(tri, ro, rd, xh, e, x0, ta, zmax, exclude, bnd, zmin,
                       table=table, stats=stats, winners=winners)
            n = ro.shape[0]
            if self.count_calls:
                self.calls["k3"].append((n, tri.shape[0]))
            if self._on("k3") and n:
                i = self._pick("k3", n)
                self.samples["k3"].append(_kept(dict(
                    ro=ro[i], rd=rd[i], xh=xh[i], e=e[i], x0=x0[i],
                    ta=ta[i], zmax=zmax[i], exclude=exclude[i], bnd=bnd[i],
                    zmin=float(zmin), zc=out[0][i], cnt=out[1][i])))
            return out
        return cone_minz

    def _edges_in_cone(self, orig):
        def edges_in_cone(edges, clusters, ro, rd, env, zmax, K):
            idx, z, cnt = orig(edges, clusters, ro, rd, env, zmax, K)
            if self._on("edges") and ro.shape[0]:
                i = self._pick("edges", ro.shape[0])
                self.samples["edges"].append(_kept(dict(
                    ro=ro[i], rd=rd[i], xh=env.x[i], e=env.e[i],
                    x0=env.x0[i], ta=env.ta[i], zmax=zmax[i], zmin=1e-7,
                    K=int(K), idx=idx[i], z=z[i], cnt=cnt[i])))
            return idx, z, cnt
        return edges_in_cone

    def _fsd_eval(self, orig):
        def fsd_eval(ap, k, src, dst):
            ev = orig(ap, k, src, dst)
            if self._on("utd") and src.shape[0]:
                i = self._pick("utd", src.shape[0], ap.valid.any(1))
                self._evals[id(ev)] = (ev, dict(
                    i=i, v=ap.v[i], half_l=ap.half_l[i], nff=ap.nff[i],
                    tff=ap.tff[i], nbf=ap.nbf[i], alpha=ap.alpha[i],
                    w=ap.w[i], valid=ap.valid[i], src=src[i], dst=dst[i]))
            return ev
        return fsd_eval

    def _coherent_sum(self, orig):
        def coherent_sum(ev, k, src, dst, direct_visible,
                         edge_unshadowed=None):
            ts, th = orig(ev, k, src, dst, direct_visible, edge_unshadowed)
            held = self._evals.pop(id(ev), None)
            if held is not None:
                rec = held[1]
                i = rec.pop("i")
                unsh = (torch.ones_like(rec["valid"]) if edge_unshadowed
                        is None else edge_unshadowed[i])
                rec.update(direct=direct_visible[i], unshadowed=unsh,
                           ts=ts[i], th=th[i])
                self.samples["utd"].append(_kept(rec))
            return ts, th
        return coherent_sum

    def _splat(self, orig, kind):
        def splat(film, *args, **kw):
            if self.film:
                self.splats[kind].append(tuple(_keep(a) for a in args))
            return orig(film, *args, **kw)
        return splat

    # -- install ----------------------------------------------------------
    def install(self):
        from wave_tracer_tpu_torch.accel import cone_kernels, ray_kernels
        from wave_tracer_tpu_torch.accel import edges as edges_mod
        from wave_tracer_tpu_torch.sensor import film as film_mod
        from wave_tracer_tpu_torch.wave import fsd as fsd_mod
        for mod, name, make in (
                (ray_kernels, "closest_hit", self._closest_hit),
                (ray_kernels, "any_hit", self._any_hit),
                (cone_kernels, "cone_minz", self._cone_minz),
                (edges_mod, "edges_in_cone", self._edges_in_cone),
                (fsd_mod, "fsd_eval", self._fsd_eval),
                (fsd_mod, "coherent_sum", self._coherent_sum),
                (film_mod, "splat", lambda o: self._splat(o, "camera")),
                (film_mod, "splat_direct_gaussian",
                 lambda o: self._splat(o, "beam")),
                (film_mod, "splat_direct", lambda o: self._splat(o, "point"))):
            orig = getattr(mod, name)
            self._saved.append((mod, name, orig))
            setattr(mod, name, make(orig))

    def uninstall(self):
        while self._saved:
            mod, name, orig = self._saved.pop()
            setattr(mod, name, orig)
        self._evals.clear()
