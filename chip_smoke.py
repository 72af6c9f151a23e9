"""On-card smoke test of the PyTorch/CUDA port (wave_tracer_tpu_torch).

Drives the port's three main paths through the entry points a user calls
(`scene.build_scene`, `render.render_scene`) on one CUDA card — the
classical plt_path renderer (fsd=False) and the wave-optical plt_path
(fsd=True: hybrid cone traversal + deferred coherent FSD), both through
the persistent compacted wavefront, and plt_bdpt with Fraunhofer FSD
through its batched renderer — and holds every hand-written kernel of those
paths against its plain torch version.

    python3 chip_smoke.py                # needs one card

Phases (each raises on failure; nothing is caught):
  1. a CUDA card is required: without one the script exits nonzero and
     prints no result; prints the card's name and power limit
  2. builds the kernels (nvcc, sm_90a; one nvcc per source, in parallel)
     from csrc/ and prints the build time
  3. K1 (closest hit) and K2 (any hit) against their plain versions at the
     shapes phases 4, 6, 8 and 10 give them: as many seeded random rays
     as the renderer's lane pool (262,144), a third with exclusions, on
     the box (12 triangles) and on the box + icosphere (81,932): ids agree
     on >= 99.9% of rays, t within rtol 1e-4 / atol 1e-5 where ids agree,
     occlusion agrees on >= 99.9%; K1's words also equal, bit for bit,
     those of its launch with the culls off (every pair of every tile),
     timed; times from CUDA events after a warm-up.
     K2 also at the width of the wave bounce's batched FSD-leg call,
     (2K+1)·262,144 = 4,456,448 segments, on both scenes, against its
     plain version run in ray chunks of 262,144, with the same bar; and,
     after phase 10 (phase 3b), at that width with a need mask of the
     share the scale render showed and with an empty one: needed rows
     agree with the plain version on >= 99.9%, unneeded rows are False.
     Phase 3b also runs K1 at 262,144 rays on both scenes with a need
     mask at the live share of the scale render's K1 calls and with an
     empty one, and a carried hit for every row: needed rows hold the
     words of tracing every row and agree with the plain version under
     the bars above, the other rows their carried hit bit for bit
  4. render_scene: box, plt_path, fsd=False, 256x256, 16 spp, max_depth 8
     (the benchmark's classical configuration); launch counters are zeroed
     just before and read just after, and must both have grown
  5. the classical box at 64x64, 4 spp, max_depth 5 on the card and on the
     CPU (plain versions): image mean per channel within 1%, >= 98% of
     pixels within 1e-3·max(|ref|, mean|ref|), device counters within 0.5%
  6. classical box + 81,920-triangle icosphere at 256x256, 8 spp, depth 8
     (bench.py's cell; two fills of the 2^18-lane pool)
  7. K3 (cone-triangle boundary sweep) against its plain version at the
     wave pool's width (262,144 seeded random cones inside the scene's
     bounds: ta 0.01-0.2, e 0.6-1.0, x0 0.01-0.3, boundaries of visible
     wavelengths, zmax = the scene radius, a third with an excluded id) on
     the box and on the box + icosphere, and 262,144 narrow render-like
     cones on the box + icosphere (camera beams, and FSD restart beams
     from surface points at visible wavelengths); the plain version runs
     in lane chunks of 16,384, on all lanes of the random cones and on
     the first 16,384 narrow ones. Bar: minima and counts bit-equal (the
     kernel's culls skip only pairs the body rejects); times from CUDA
     events after a warm-up
  8. the wave main path: box, plt_path, fsd=True, 256x256, 8 spp,
     max_depth 8 (the benchmark's timed headline); counters zeroed just
     before and read just after: K1, K2 and K3 must all have launched, the
     mode is "wave-compact", and FSD interactions, diffusive traversals and
     edge-sweep hits all occurred
  9. the wave box at 32x32, 4 spp, max_depth 5 on the card and on the CPU:
     channel means within 2%, Pearson correlation >= 0.999, >= 90% of
     pixels within 1e-2·max(|ref|, mean|ref|), device counters within 2%;
     then (phase 9b) that scene and the classical box + icosphere at
     32x32, 4 spp, depth 8, with a pool of 1,024 lanes (so that lanes
     refill and hit the depth cap) rendered on the card with every K1
     call that carries hits traced again over all rows: the carried rows
     equal that trace bit for bit; and once without the carry: every
     counter equal, the image within splat-order rounding
 10. wave box + icosphere at 256x256, 4 spp, max_depth 8; then once more
     with CUDA events around every K1, K2 and K3 call, printing each call
     kind's time per launch, the needed-row share of K1 (per pool step)
     and of each K2 call kind (FSD legs, NEE), K3's culled-pair shares
     (counted by a launch of its counting build on the same inputs,
     outside the events) and each kind's bound
 12. the bdpt main path: box, plt_bdpt, fsd=True, 256x256, 4 spp,
     max_depth 8 (bench.py's bdpt cell), after a warm-up; counters zeroed
     just before and read just after: K1 and K2 must have launched, the
     mode is "bdpt", the image finite and FSD interactions occurred; its
     paths/s is the median of three renders if one takes under 30 s, else
     that one render (the line says which); then once more with CUDA
     events around every K1 and K2 call: launches, ms per launch, needed-
     row share and bound by the rule below
 13. bdpt at 32x32, 4 spp, max_depth 5, FSD on, on the card and on the
     CPU, at the CPU test's bars (tests/test_torch_bdpt_render.py):
     channel means within 2%, Pearson >= 0.999, >= 90% of pixels within
     1e-2·max(|ref|, mean|ref|), rays, surface and FSD interactions,
     depth sum and shadow rays within 2%, edge-sweep hits within 8%,
     null interactions within 18%
 14. the coverage main path: make_coverage_scene(256) (256x256 elements
     × 8 samples = 524,288 paths, depth 4, 14 triangles, ITU concrete
     SPM, a 10 GHz point transmitter), plt_path with FSD on, after a
     warm-up, in batches of 2^18 lanes; counters zeroed just before and
     read just after: K1 and K2 must have launched; the mode is
     "forward-wave", the map finite, more than 20% of the elements lit,
     and the building's shadow shows (tests/test_coverage.py's bar); its
     paths/s as phase 12's; then once more with CUDA events around every
     K1 and K2 call (launches, ms per launch, needed-row share, bound);
     then the same scene as plt_bdpt (the Fraunhofer forward mode, the
     t = 0 strategy) with the same checks: it launches K1 only, since the
     Fraunhofer mode makes no shadow test (neither does the JAX module)
 14b. K2 against its plain version on the K2 call of phase 14's render
     with the most needed rows: the forward's own width, 3·(2K+1) = 51
     segments per lane × 2^18 lanes, its three exclusions and the
     live-lane need mask that the render gave it; needed rows agree on
     >= 99.9%, unneeded rows are False
 15. make_coverage_scene(32) at 4 samples per element, in batches of
     4,096 lanes, plt_path and plt_bdpt, on the card and on the CPU
     (plain versions), at the CPU tests' film-level bars
     (tests/test_torch_coverage_render.py::film_stats): the median ratio
     of the elements lit in both within 1e-3 of 1, the Pearson
     correlation of the dB maps >= 0.95, >= 90% of the elements within
     0.1 dB (the means' ratio is printed: single FSD-NEE splats of huge
     weight dominate it)
 11. (last) prints the kernels' JSON line (each kernel's launches on the
     wave main path, per path under "launches_by_path", and K1's and K2's
     timings in the bdpt and coverage renders under "in_bdpt_render" and
     "in_coverage_render") and, last, the result JSON line

Each paths/s reading (phases 4, 6, 8, 10, and 12 and 14 where a render
takes under 30 s) is the median of three renders, the one whose launches
are counted first; all three are printed.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

POOL = 1 << 18              # the renderer's CUDA lane pool
REF_CHUNK = 16384           # lanes per chunk of K3's plain version
# renders per paths/s reading, the median reported: on a shared host one
# render of a host-bound cell moves 10-40% between readings
RATE_RENDERS = 3
# H100 SXM peaks (NVIDIA data sheet, at 700 W): fp32 outside the tensor
# cores and HBM bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per pair that every pair does whatever its data (adds,
# subtractions, multiplications, divisions and square roots count one
# each; compares, selects, abs, min and max are not counted), counted from
# csrc/ray_kernels.cu (three 6-term Plücker sides and their sum) and
# csrc/cone_kernels.cu (57 local transform, 18 vertex tests, 3 × 75 edge
# quadratics, 42 axis hit, 45 conic point; 17 divisions, 4 square roots)
FLOP_PER_PAIR = {"closest": 35, "anyhit": 35, "cone_minz": 387}
# K3's test of a cone against a bounding sphere, a tile's or a triangle's
# (csrc/cone_kernels.cu::sphere_may_enter): the local transform of the
# centre (19), the scaled radius and the magnitude (3), the radius bound
# (4), the margin (7) and the shifted bounds of its four compares (6)
FLOP_CULL = 39
# K2's test of a segment against a tile's padded box
# (csrc/ray_kernels.cu::seg_may_hit): the pad (3), |d| (6), its quotient
# (1), the widened range (2), three reciprocals and six slab distances of
# three operations each
FLOP_SLAB = 33
# The kernels' bounds count what each lane's own data needs, by one rule:
# the lane's test of every tile; each triangle of the tiles that test
# keeps (the plain twins `_tile_box_may_hit` and `_sphere_cull`, on the
# same inputs) at its pair test (K1, K2: the hit test, K3: the sphere
# test); and, for K3, each pair that its pair culls let into the body (the
# counting build's count) at the body. K1's tile test is asked with its
# segment [tmin, the closest t] (a miss: [tmin, tmax]). An occluded ray
# needs one pair after its tile tests (a hit ends its loop), so it counts
# one. Only the rows a call traces count. Bytes: each traced row in and
# out once, and the triangle rows once.
TWIN_LANES = 65536          # lanes per chunk of the twins' counts


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps):
    """Mean ms per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the fp32
    peak and the bytes over the memory rate."""
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tile_sizes(ntiles, T, tile, device):
    sizes = torch.full((ntiles,), float(tile), device=device)
    sizes[-1] = T - tile * (ntiles - 1)
    return sizes


def kept_pairs(rk, table, center, ro, rd, tmin, tmax):
    """(N,) f64: the triangles of the tiles whose padded box each segment
    meets (the twin `_tile_box_may_hit`)."""
    sizes = tile_sizes(table.boxes.shape[0], table.feat.shape[0], rk.TILE,
                       ro.device)
    return torch.cat([ro.new_zeros((0,), dtype=torch.float64)] + [
        (rk._tile_box_may_hit(
            table.boxes, center, ro[s:s + TWIN_LANES], rd[s:s + TWIN_LANES],
            tmin[s:s + TWIN_LANES], tmax[s:s + TWIN_LANES]).float() @ sizes
         ).double() for s in range(0, ro.shape[0], TWIN_LANES)])


def anyhit_need(rk, table, args, occ, need=None):
    """(operations, pairs) K2's data needs (the bounds' rule) for its
    arguments `args` and result `occ`, over the rows of `need` (all if
    None)."""
    center, ro, rd, tmin, tmax = args[1:6]
    if need is not None:
        ro, rd, tmin, tmax, occ = (x[need] for x in (ro, rd, tmin, tmax, occ))
    kept = kept_pairs(rk, table, center, ro, rd, tmin, tmax)
    pairs = torch.where(occ, 1.0, kept).sum().item()
    n_tests = ro.shape[0] * table.boxes.shape[0]
    return n_tests * FLOP_SLAB + pairs * FLOP_PER_PAIR["anyhit"], pairs


def closest_need(rk, table, args, t, need=None):
    """(operations, pairs) K1's data needs (the bounds' rule) for its
    arguments `args` and closest t `t` (BIG on a miss), over the rows of
    `need` (all if None)."""
    center, ro, rd, tmin, tmax = args[1:6]
    t_hi = torch.minimum(t, tmax)
    if need is not None:
        ro, rd, tmin, t_hi = (x[need] for x in (ro, rd, tmin, t_hi))
    pairs = kept_pairs(rk, table, center, ro, rd, tmin, t_hi).sum().item()
    n_tests = ro.shape[0] * table.boxes.shape[0]
    return n_tests * FLOP_SLAB + pairs * FLOP_PER_PAIR["closest"], pairs


def cone_need(ck, table, args, entered):
    """(operations, pairs kept by the tile test) K3's data needs (the
    bounds' rule) for its arguments `args`, with `entered` pairs let into
    the body (the counting build's count)."""
    ro, rd, xh, e, x0, ta, zmax = args[1:8]
    N, tiles = ro.shape[0], table.tiles
    sizes = tile_sizes(tiles.shape[0], table.ids.shape[0], ck.TILE,
                       ro.device)
    kept = 0.0
    for s in range(0, N, TWIN_LANES // 4):
        c = slice(s, s + TWIN_LANES // 4)
        kept += (ck._sphere_cull(tiles, ro[c], rd[c], xh[c], e[c], x0[c],
                                 ta[c], zmax[c], args[-1]).float()
                 @ sizes).double().sum().item()
    return ((N * tiles.shape[0] + kept) * FLOP_CULL
            + entered * FLOP_PER_PAIR["cone_minz"], kept)


def box_scene(res, spp, depth, icosphere=False, fsd=False):
    from wave_tracer_tpu_torch.scene.procedural import make_box_scene
    scene = make_box_scene(res=res, spp=spp, icosphere=icosphere)
    scene.integrator.type = "plt_path"
    scene.integrator.fsd = fsd
    scene.integrator.max_depth = depth
    return scene


def bdpt_scene(res, spp, depth):
    scene = box_scene(res, spp, depth, fsd=True)
    scene.integrator.type = "plt_bdpt"
    return scene


def rate_line(built, st):
    """The paths/s of the render whose stats are `st` and of
    RATE_RENDERS - 1 more renders of `built`, as printed: the median,
    then every reading."""
    from wave_tracer_tpu_torch.render import render_scene
    r = [st["paths_per_sec"]] + [
        render_scene(built, device="cuda")[1]["paths_per_sec"]
        for _ in range(RATE_RENDERS - 1)]
    return (f"{float(np.median(r)):.1f} paths/s (median of {len(r)} "
            f"renders: {', '.join(f'{x:.1f}' for x in r)}; the first "
            f"{st['seconds']:.3f} s")


def check_render(img, stats, shape, tag):
    check(img.shape == shape, f"{tag}: image shape {img.shape}")
    check(np.isfinite(img).all(), f"{tag}: non-finite pixels")
    check(img.mean() > 0, f"{tag}: black image")
    dc = stats["device_counters"]
    check(dc["rays_cast"] > 0 and dc["shadow_rays"] > 0,
          f"{tag}: device counters {dc}")


def check_wave_render(img, stats, shape, tag):
    check_render(img, stats, shape, tag)
    check(stats["mode"] == "wave-compact", f"{tag}: mode {stats['mode']}")
    dc = stats["device_counters"]
    for k in ("fsd_interactions", "diffusive_traversals", "edge_sweep_hits"):
        check(dc[k] > 0, f"{tag}: no {k} ({dc})")


def random_rays(geo, N, r):
    lo = geo.p0.min(0).values.cpu().numpy() - 0.2
    hi = geo.p0.max(0).values.cpu().numpy() + 0.2
    ro = r.uniform(lo, hi, (N, 3)).astype(np.float32)
    rd = r.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def check_ray_kernels(rk, geo, N, seed):
    """K1/K2 vs their plain versions on N seeded random rays through geo."""
    T = geo.num_tris
    r = np.random.default_rng(seed)
    ro, rd = random_rays(geo, N, r)
    dev = geo.p0.device
    ro_t, rd_t = torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev)
    tmin = torch.full((N,), 1e-4, device=dev)
    tmax = torch.full((N,), 1e30, device=dev)
    args = (geo.tri_feat, geo.mxu_center, ro_t, rd_t, tmin, tmax)
    none3 = torch.full((N, 3), -1, dtype=torch.int32, device=dev)
    t0, i0 = rk._closest_ref(*args, none3)
    # a third of the rays exclude their own first hit (and two random ids)
    ex = none3.clone()
    sel = torch.from_numpy(r.random(N) < 1 / 3).to(dev)
    ex[:, 0] = torch.where(sel, i0, ex[:, 0])
    ex[:, 1:] = torch.where(sel[:, None], torch.from_numpy(
        r.integers(0, T, (N, 2)).astype(np.int32)).to(dev), ex[:, 1:])

    table = geo.ray_table
    tk, ik = rk.closest_hit(*args, ex, table=table)
    tr, ir = rk._closest_ref(*args, ex)
    agree = (ik == ir)
    frac_id = agree.float().mean().item()
    both = agree & (ir >= 0)
    check(both.any().item(), "K1: no hits at all")
    err_t = (tk[both] - tr[both]).abs()
    check(bool((err_t <= 1e-5 + 1e-4 * tr[both].abs()).all()),
          f"K1: t disagrees (max abs {err_t.max().item()})")
    check(frac_id >= 0.999, f"K1: ids agree on {frac_id:.5f} of rays")
    # the walk near to far and the culls skip only pairs that cannot win:
    # the same words as every pair of every tile
    def words(every_pair):
        return rk._launch_closest(geo.tri_feat, table, *args[1:], ex,
                                  every_pair=every_pair)
    check(torch.equal(words(False), words(True)),
          "K1: the culls change a result")
    ops1, kept1 = closest_need(rk, table, (*args, ex), tk)

    tmax_s = torch.from_numpy(r.uniform(0.05, 4.0, N).astype(np.float32)
                              ).to(dev)
    sargs = (geo.tri_feat, geo.mxu_center, ro_t, rd_t, tmin, tmax_s, ex)
    ok_k = rk.any_hit(*sargs, table=table)
    ops2, kept = anyhit_need(rk, table, sargs, ok_k)
    ok_r = rk._anyhit_ref(*sargs)
    frac_occ = (ok_k == ok_r).float().mean().item()
    check(frac_occ >= 0.999, f"K2: occlusion agrees on {frac_occ:.5f}")
    torch.cuda.synchronize()

    ms_k1 = cuda_ms(lambda: rk.closest_hit(*args, ex, table=table), 5)
    ms_t1 = cuda_ms(lambda: rk._closest_ref(*args, ex), 1)
    ms_k1_all = cuda_ms(lambda: words(True), 1)
    ms_k2 = cuda_ms(lambda: rk.any_hit(*sargs, table=table), 5)
    ms_t2 = cuda_ms(lambda: rk._anyhit_ref(*sargs), 1)
    print(f"phase 3: N={N} T={T}: K1 ids agree {frac_id:.6f}, max |dt| "
          f"{err_t.max().item():.3e}, hits {both.float().mean().item():.3f},"
          f" words bit-equal with the culls off, pairs "
          f"its data needs "
          f"{kept1 / (N * T):.6f}; "
          f"K2 agree {frac_occ:.6f}, occluded "
          f"{ok_r.float().mean().item():.3f}, pairs its data needs "
          f"{kept / (N * T):.6f}", flush=True)
    # bytes: the triangle rows, per ray ro/rd/tmin/tmax/3 exclusions in
    # and one 8-byte word (K1) or byte (K2) out
    tri_bytes = T * rk.NF * 4
    k1 = bound(ops1, tri_bytes + N * (44 + 8))
    k1_all = bound(N * T * FLOP_PER_PAIR["closest"], tri_bytes + N * (44 + 8))
    k2 = bound(ops2, tri_bytes + N * (44 + 1))
    print(f"phase 3: N={N} T={T}: K1 {ms_k1:.3f} ms (plain {ms_t1:.3f} ms, "
          f"culls off {ms_k1_all:.3f} ms, bound {k1[0]:.3f} ms ({k1[1]}), "
          f"every pair {k1_all[0]:.3f} ms), K2 {ms_k2:.3f} ms (plain "
          f"{ms_t2:.3f} ms, bound {k2[0]:.3f} ms)", flush=True)
    return dict(
        closest=dict(max_abs_err=err_t.max().item(), ms=ms_k1,
                     plain_ms=ms_t1, bound=k1, culls_off_ms=ms_k1_all,
                     all_pairs_bound_ms=k1_all[0]),
        anyhit=dict(max_abs_err=float((ok_k != ok_r).float().max().item()),
                    ms=ms_k2, plain_ms=ms_t2, bound=k2))


def leg_args(geo, N, seed):
    """N seeded random segments through geo, a third with three excluded
    ids: K2's arguments at the width of the batched FSD-leg call."""
    T = geo.num_tris
    r = np.random.default_rng(seed)
    ro, rd = random_rays(geo, N, r)
    dev = geo.p0.device
    ex = np.where((r.random(N) < 1 / 3)[:, None],
                  r.integers(0, T, (N, 3)), -1).astype(np.int32)
    return (geo.tri_feat, geo.mxu_center, torch.from_numpy(ro).to(dev),
            torch.from_numpy(rd).to(dev), torch.full((N,), 1e-4, device=dev),
            torch.from_numpy(r.uniform(0.05, 4.0, N).astype(np.float32)
                             ).to(dev),
            torch.from_numpy(ex).to(dev))


def anyhit_ref_chunked(rk, args, need=None):
    """K2's plain version in ray chunks of POOL (its (N, 5·512)
    temporaries would not fit at full width)."""
    N = args[2].shape[0]
    return torch.cat([rk._anyhit_ref(*args[:2], *(
        x[s:s + POOL] for x in args[2:]),
        None if need is None else need[s:s + POOL])
        for s in range(0, N, POOL)])


def check_anyhit_legs(rk, geo, N, seed):
    """K2 vs its plain version at the width of the wave bounce's batched
    FSD-leg call, every row needed."""
    T = geo.num_tris
    args = leg_args(geo, N, seed)
    ok_k = rk.any_hit(*args, table=geo.ray_table)
    ops, kept = anyhit_need(rk, geo.ray_table, args, ok_k)
    # the plain version at these chunk shapes is warm from check_ray_kernels
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ok_r = anyhit_ref_chunked(rk, args)
    b.record()
    torch.cuda.synchronize()
    ms_plain = a.elapsed_time(b)
    frac_occ = (ok_k == ok_r).float().mean().item()
    check(frac_occ >= 0.999, f"K2 N={N} T={T}: occlusion agrees on "
          f"{frac_occ:.5f}")
    ms = cuda_ms(lambda: rk.any_hit(*args, table=geo.ray_table), 3)
    b = bound(ops, T * rk.NF * 4 + N * (44 + 1))
    print(f"phase 3: N={N} T={T}: K2 agree {frac_occ:.6f}, occluded "
          f"{ok_r.float().mean().item():.3f}, pairs its data needs "
          f"{kept / (N * T):.6f}; K2 {ms:.3f} ms (plain {ms_plain:.3f} "
          f"ms, ray chunks of {POOL}), bound {b[0]:.3f} ms", flush=True)
    return dict(max_abs_err=float((ok_k != ok_r).float().max().item()),
                ms=ms, plain_ms=ms_plain, bound=b)


def check_anyhit_need(rk, geo, N, seed, share):
    """K2 at the leg-call width with a seeded need mask of `share` and
    with an empty one: needed rows against the plain version, unneeded
    rows False. Returns (ms masked, ms empty, needed rows)."""
    T = geo.num_tris
    args = leg_args(geo, N, seed)
    dev = geo.p0.device
    need = torch.from_numpy(np.random.default_rng(seed + 1).random(N)
                            < share).to(dev)
    empty = torch.zeros_like(need)
    ok_k = rk.any_hit(*args, need, table=geo.ray_table)
    ok_r = anyhit_ref_chunked(rk, args, need)
    check(not ok_k[~need].any().item(), "K2 need mask: an unneeded row "
          "is occluded")
    frac = (ok_k[need] == ok_r[need]).float().mean().item()
    check(frac >= 0.999, f"K2 need mask: needed rows agree on {frac:.5f}")
    check(not rk.any_hit(*args, empty, table=geo.ray_table).any().item(),
          "K2 empty need mask: a row is occluded")
    ms = cuda_ms(lambda: rk.any_hit(*args, need, table=geo.ray_table), 3)
    ms0 = cuda_ms(lambda: rk.any_hit(*args, empty, table=geo.ray_table), 3)
    n_need = int(need.sum().item())
    print(f"phase 3b: N={N} T={T}: K2 with a need mask of {n_need} rows "
          f"({n_need / N:.4f}): needed rows agree {frac:.6f}, unneeded "
          f"rows all False; {ms:.3f} ms; empty mask {ms0:.3f} ms",
          flush=True)
    return ms, ms0, n_need


def check_closest_need(rk, geo, N, seed, share):
    """K1 on N seeded random rays (a third with exclusions) with a seeded
    need mask of `share` and with an empty one, every row carrying a
    random hit: needed rows hold the words of tracing every row and agree
    with the plain version (given the same mask and carry) under phase
    3's bars, the rest hold their carried hit bit for bit. Returns (ms
    masked, ms empty, needed rows)."""
    T = geo.num_tris
    r = np.random.default_rng(seed)
    ro, rd = random_rays(geo, N, r)
    dev = geo.p0.device
    ex = np.where((r.random(N) < 1 / 3)[:, None],
                  r.integers(0, T, (N, 3)), -1).astype(np.int32)
    args = (geo.tri_feat, geo.mxu_center, torch.from_numpy(ro).to(dev),
            torch.from_numpy(rd).to(dev), torch.full((N,), 1e-4, device=dev),
            torch.full((N,), 1e30, device=dev), torch.from_numpy(ex).to(dev))
    table = geo.ray_table
    need = torch.from_numpy(r.random(N) < share).to(dev)
    empty = torch.zeros_like(need)
    carry = (torch.from_numpy(r.uniform(0.0, 9.0, N).astype(np.float32)
                              ).to(dev),
             torch.from_numpy(r.integers(-1, T, N).astype(np.int32)).to(dev))
    t_all, i_all = rk.closest_hit(*args, table=table)
    tn, i_n = rk.closest_hit(*args, need, carry, table=table)

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    check(same(tn[need], t_all[need]) and torch.equal(i_n[need], i_all[need]),
          "K1 need mask: a needed row differs from tracing every row")
    check(same(tn[~need], carry[0][~need])
          and torch.equal(i_n[~need], carry[1][~need]),
          "K1 need mask: an unneeded row lost its carried hit")
    tr, ir = rk._closest_ref(*args, need, carry)
    agree = i_n[need] == ir[need]
    check(agree.float().mean().item() >= 0.999,
          f"K1 need mask: ids agree with the plain version on "
          f"{agree.float().mean().item():.5f} of the needed rows")
    both = need & (i_n == ir) & (ir >= 0)
    check(bool(((tn[both] - tr[both]).abs()
                <= 1e-5 + 1e-4 * tr[both].abs()).all()),
          "K1 need mask: t disagrees with the plain version")
    t0, i0 = rk.closest_hit(*args, empty, carry, table=table)
    check(same(t0, carry[0]) and torch.equal(i0, carry[1]),
          "K1 empty need mask: a row lost its carried hit")
    ms = cuda_ms(lambda: rk.closest_hit(*args, need, carry, table=table), 3)
    ms0 = cuda_ms(lambda: rk.closest_hit(*args, empty, carry, table=table), 3)
    n_need = int(need.sum().item())
    print(f"phase 3b: N={N} T={T}: K1 with a need mask of {n_need} rows "
          f"({n_need / N:.4f}): needed rows equal tracing every row and "
          f"agree with the plain version, "
          f"unneeded rows keep their carried hit; {ms:.3f} ms; empty mask "
          f"{ms0:.3f} ms", flush=True)
    return ms, ms0, n_need


def check_carry(rk, built, tag, lanes):
    """`built` rendered on the card with a pool of `lanes`, every K1 call
    that carries hits traced again over all rows: the carried rows must
    equal that trace bit for bit. Then rendered without the carry: every
    counter equal, the image within splat-order rounding (index_add_ on
    the card sums in no fixed order). Returns the needed-row shares."""
    import functools

    from wave_tracer_tpu_torch.integrator import path_compact
    from wave_tracer_tpu_torch.render import render_scene
    from wave_tracer_tpu_torch.render import renderer as renderer_mod
    real, pool = rk.closest_hit, renderer_mod.render_pool
    shares = []

    def checked(*args, **kw):
        out = real(*args, **kw)
        need = args[7] if len(args) > 7 else kw.get("need")
        if need is not None:
            full = real(*args[:7], table=kw["table"])
            check(torch.equal(out[0].view(torch.int32),
                              full[0].view(torch.int32))
                  and torch.equal(out[1], full[1]),
                  f"{tag}: a carried hit differs from its retrace")
            shares.append(need.float().mean().item())
        return out

    rk.closest_hit = checked
    try:
        img, st = render_scene(built, device="cuda", pool_lanes=lanes)
    finally:
        rk.closest_hit = real
    check(shares and min(shares) < 1.0, f"{tag}: no hits carried {shares}")
    renderer_mod.render_pool = functools.partial(path_compact.render_pool,
                                                 carry_hits=False)
    try:
        img0, st0 = render_scene(built, device="cuda", pool_lanes=lanes)
    finally:
        renderer_mod.render_pool = pool
    check(st["device_counters"] == st0["device_counters"],
          f"{tag}: counters differ without the carry")
    check(np.allclose(img, img0, rtol=1e-5, atol=1e-12),
          f"{tag}: the image differs without the carry")
    print(f"phase 9b: {tag}: carried hits equal their retrace in "
          f"{len(shares)} K1 calls (needed shares {min(shares):.4f}-"
          f"{max(shares):.4f}); without the carry every counter equal",
          flush=True)
    return shares


def minz_ref_chunked(ck, args, lanes=None):
    """K3's plain version in lane chunks of REF_CHUNK (its (N, 512)
    temporaries would not fit at full width), over the first `lanes`
    lanes (all if None)."""
    tri, lane, zmin = args[0], args[1:-1], args[-1]
    n = lane[0].shape[0] if lanes is None else lanes
    outs = [ck._minz_ref(tri, *(a[s:min(s + REF_CHUNK, n)] for a in lane),
                         zmin) for s in range(0, n, REF_CHUNK)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def cone_vs_plain(ck, geo, args, tag, lanes=None):
    """K3 against its plain version (over the first `lanes` lanes):
    minima and counts bit-equal. Returns (kernel ms, plain ms, cull stats
    of one launch, mean count, share of finite minima)."""
    N = args[1].shape[0]
    n = N if lanes is None else lanes
    zc, cnt = ck.cone_minz(*args, table=geo.cone_table)
    cull = cone_cull(ck, args, geo.cone_table, (zc, cnt))
    ck._minz_ref(args[0], *(a[:256] for a in args[1:-1]), args[-1])
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    zr, cr = minz_ref_chunked(ck, args, lanes)
    b.record()
    torch.cuda.synchronize()
    ms_plain = a.elapsed_time(b)
    finite = torch.isfinite(zr)
    check(finite.any().item(), f"K3 {tag}: no encounters at all")
    same_z = torch.equal(zc[:n], zr)
    same_c = torch.equal(cnt[:n], cr)
    if not (same_z and same_c):
        both = finite & torch.isfinite(zc[:n])
        fail(f"K3 {tag}: not bit-equal to the plain version (finite masks "
             f"differ on {(torch.isfinite(zc[:n]) != finite).sum().item()} "
             f"entries, max |dz| {(zc[:n][both] - zr[both]).abs().max()}, "
             f"counts differ on {(cnt[:n] != cr).sum().item()} lanes)")
    ms = cuda_ms(lambda: ck.cone_minz(*args, table=geo.cone_table), 3)
    return ms, ms_plain, cull, cr.float().mean().item(), \
        finite.float().mean().item()


def cone_cull(ck, args, table, out):
    """One launch of K3's counting build → its four cull counters (pairs
    tested after the tile cull, pairs that entered the body, warp-
    iterations, those with a candidate). Its result must equal `out`, the
    main build's."""
    stats = torch.zeros((4,), dtype=torch.int64, device=args[1].device)
    zc, cnt = ck.cone_minz(*args, table=table, stats=stats)
    check(torch.equal(zc, out[0]) and torch.equal(cnt, out[1]),
          "K3: the counting build disagrees with the main build")
    return stats


def cull_line(cull, N, T, kept):
    """K3's cull shares: from its counting build's counters `cull` and
    the pairs its lanes' own tile tests keep (`kept`, from the twin)."""
    tested, entered, witer, witer_in = (int(x) for x in cull.tolist())
    return (f"pairs culled {1 - entered / (N * T):.6f} (by the tile test "
            f"{1 - tested / (N * T):.6f} per warp, {1 - kept / (N * T):.6f}"
            f" per lane), warp-iterations entering the body "
            f"{witer_in / max(witer, 1):.6f}")


def check_cone_kernel(ck, geo, scene_radius, N, seed):
    """K3 vs its plain version on N seeded random cones inside geo's
    bounds (the manner of tests/test_mxu_cone.py)."""
    from wave_tracer_tpu_torch.integrator.traversal import segment_boundaries
    T = geo.num_tris
    r = np.random.default_rng(seed)
    ro, rd = random_rays(geo, N, r)
    xh = np.cross(rd, r.normal(size=(N, 3))).astype(np.float32)
    xh /= np.linalg.norm(xh, axis=-1, keepdims=True)
    dev = geo.p0.device

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.asarray(x)).to(dev, dtype)

    lam = t(r.uniform(380e-9, 720e-9, N))
    exclude = np.where(r.random(N) < 1 / 3, r.integers(0, T, N), -1)
    args = (geo.cone_tris, t(ro), t(rd), t(xh), t(r.uniform(0.6, 1.0, N)),
            t(r.uniform(0.01, 0.3, N)), t(r.uniform(0.01, 0.2, N)),
            torch.full((N,), float(scene_radius), device=dev),
            t(exclude, torch.int32), segment_boundaries(lam), 1e-7)
    ms, ms_plain, cull, mean_cnt, fin = cone_vs_plain(ck, geo, args,
                                                      f"T={T}")
    ops, kept = cone_need(ck, geo.cone_table, args, int(cull[1]))
    b = bound(ops, cone_bytes(N, T))
    print(f"phase 7: N={N} T={T} random cones: K3 bit-equal to its plain "
          f"version, mean count {mean_cnt:.2f}, finite minima {fin:.3f}; "
          f"{cull_line(cull, N, T, kept)}", flush=True)
    print(f"phase 7: N={N} T={T}: K3 {ms:.3f} ms (plain {ms_plain:.3f} ms, "
          f"lane chunks of {REF_CHUNK}), bound {b[0]:.3f} ms ({b[1]})",
          flush=True)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=ms_plain, bound=b)


def cone_bytes(N, T):
    """Triangle rows (36 B), per lane 16 floats + exclusion + 16
    boundaries in, 16 minima + count out."""
    return T * 36 + N * (64 + 4 + 64 + 64 + 4)


def check_cone_narrow(ck, built, N, seed):
    """K3 on N narrow render-like cones on built's scene: a third camera
    beams (the sensor's eye, x0 = 0, ta = half a pixel's tan), the rest
    FSD restart beams (sourcing.restart_envelope at 380-720 nm of a
    1e-4..1e-2 footprint) from points on random triangles, half of them
    the box's; zmax as the bounce sets it (hit distance · 1.02 + x0, or 8
    scene radii), each lane excluding the triangle it starts on. The
    plain version runs on the first REF_CHUNK lanes."""
    import math
    from wave_tracer_tpu_torch.integrator.traversal import segment_boundaries
    from wave_tracer_tpu_torch.wave import envelope as env_mod
    from wave_tracer_tpu_torch.wave import sourcing
    geo = built.data.geo
    radius = built.scene.world_radius()
    T = geo.num_tris
    dev = geo.p0.device
    r = np.random.default_rng(seed)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.asarray(x)).to(dev, dtype)

    cam = r.random(N) < 1 / 3
    pick = np.where(r.random(N) < 0.5, r.integers(0, 12, N),
                    r.integers(0, T, N))
    tg = geo.tri_geom.cpu().numpy()
    u = r.random((N, 2))
    u = np.where(u.sum(1, keepdims=True) > 1, 1 - u, u)
    ro = tg[pick, 0:3] + u[:, :1] * tg[pick, 3:6] + u[:, 1:] * tg[pick, 6:9]
    rd = r.normal(size=(N, 3))
    ro[cam] = [0.0, 1.0, 3.2]
    rd[cam, 2] = -np.abs(rd[cam, 2]) - 1.0
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro_t, rd_t = t(ro.astype(np.float32)), t(rd.astype(np.float32))
    lam = t(r.uniform(380e-9, 720e-9, N))
    env = env_mod.select(
        t(cam, torch.bool),
        env_mod.initial(rd_t, 0.0, 0.5 * math.tan(math.radians(30)) / 128),
        sourcing.restart_envelope(rd_t, t(10 ** r.uniform(-4, -2, N)),
                                  2 * math.pi / lam))
    zmax = t(np.where(r.random(N) < 0.5, r.uniform(0.05, 4.0, N) * 1.02,
                      8 * radius)) + env.x0
    exclude = t(np.where(cam, -1, pick), torch.int32)
    args = (geo.cone_tris, ro_t, rd_t, env.x.contiguous(), env.e, env.x0,
            env.ta, zmax, exclude, segment_boundaries(lam), 1e-7)
    ms, ms_plain, cull, mean_cnt, fin = cone_vs_plain(
        ck, geo, args, f"T={T} narrow cones", lanes=REF_CHUNK)
    entered = int(cull[1].item())
    ops, kept = cone_need(ck, geo.cone_table, args, entered)
    b = bound(ops, cone_bytes(N, T))
    print(f"phase 7: N={N} T={T} narrow render-like cones: K3 bit-equal to "
          f"its plain version on the first {REF_CHUNK} lanes, mean count "
          f"{mean_cnt:.2f}, finite minima {fin:.3f}; "
          f"{cull_line(cull, N, T, kept)}; K3 {ms:.3f} ms (plain "
          f"{ms_plain:.3f} ms on {REF_CHUNK} lanes), bound {b[0]:.3f} ms "
          f"({b[1]})", flush=True)
    return dict(ms=ms, plain_ms_subset=ms_plain, bound_ms=b[0],
                bound_by=b[1], pairs_culled=1 - entered / (N * T))


def timed_render(rk, ck, built, anyhit_kind=None):
    """One render of `built` with CUDA events around every K1, K2 and K3 call
    (wrapping the module functions the accel layer calls), each followed,
    outside its events, by the count of what its data needs (the bounds'
    rule; for K3 with a launch of its counting build on the same inputs).
    Returns ({kind: [(ms, rows, needed rows, operations needed)]}, K3's
    cull counters and its tile-kept pairs, summed over the render); kinds:
    closest, cone_minz and, by default, anyhit_legs (the batched FSD-leg
    call) and anyhit_nee; `anyhit_kind(rows)` names K2's kinds instead."""
    from wave_tracer_tpu_torch.render import render_scene
    rec = []
    closest_hit, any_hit, cone_minz = rk.closest_hit, rk.any_hit, ck.cone_minz
    dev = built.data.geo.p0.device
    cull = torch.zeros((4,), dtype=torch.int64, device=dev)
    kept3 = []

    def timed(kind_of, fn):
        def wrapper(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            if fn is closest_hit or fn is any_hit:
                need = args[7] if len(args) > 7 else kw.get("need")
                n = args[2].shape[0]
                n_need = n if need is None else int(need.sum())
                if fn is any_hit:
                    ops, _ = anyhit_need(rk, kw["table"], args, out, need)
                else:
                    ops, _ = closest_need(rk, kw["table"], args, out[0],
                                          need)
            else:
                n = n_need = args[1].shape[0]
                stats = torch.zeros((4,), dtype=torch.int64, device=dev)
                zc, cnt = fn(*args, **kw, stats=stats)
                check(torch.equal(zc, out[0]) and torch.equal(cnt, out[1]),
                      "K3: the counting build disagrees with the main build")
                cull.add_(stats)
                ops, kept = cone_need(ck, kw["table"], args, int(stats[1]))
                kept3.append(kept)
            rec.append((kind_of(n), a, b, n, n_need, ops))
            return out
        return wrapper

    rk.closest_hit = timed(lambda n: "closest", closest_hit)
    rk.any_hit = timed(anyhit_kind or (
        lambda n: "anyhit_legs" if n > POOL else "anyhit_nee"), any_hit)
    ck.cone_minz = timed(lambda n: "cone_minz", cone_minz)
    try:
        render_scene(built, device="cuda")
    finally:
        rk.closest_hit, rk.any_hit, ck.cone_minz = (closest_hit, any_hit,
                                                    cone_minz)
    torch.cuda.synchronize()
    calls = {}
    for kind, a, b, n, n_need, ops in rec:
        calls.setdefault(kind, []).append((a.elapsed_time(b), n, n_need,
                                           ops))
    return calls, cull, sum(kept3)


def summarize_calls(rk, calls, T, phase):
    """Per call kind of a timed render: launches, ms per launch, needed-row
    share and bound per launch (the shared rule), printed and returned."""
    out = {}
    for kind, rows in calls.items():
        ms = [c[0] for c in rows]
        n_rows = sum(c[1] for c in rows)
        n_need = sum(c[2] for c in rows)
        out[kind] = dict(launches=len(rows), ms_per_launch=sum(ms) / len(ms),
                         ms_max=max(ms), needed_share=n_need / max(n_rows, 1),
                         needed_rows=n_need, rows=n_rows)
        if kind == "cone_minz":
            nbytes = len(rows) * cone_bytes(POOL, T)
        else:
            nbytes = len(rows) * T * rk.NF * 4 + n_need * (
                52 if kind == "closest" else 45)
        b = bound(sum(c[3] for c in rows), nbytes)
        out[kind].update(bound_ms_per_launch=b[0] / len(rows), bound_by=b[1])
        print(f"{phase}: in the render, {kind}: {len(rows)} launches, "
              f"{sum(ms) / len(ms):.3f} ms per launch (max {max(ms):.3f}), "
              f"needed rows {n_need} of {n_rows} "
              f"({n_need / max(n_rows, 1):.4f}), bound "
              f"{b[0] / len(rows):.3f} ms per launch ({b[1]})", flush=True)
    return out


def compare_images(img, ref, st, st_ref, tag, *, mean_rtol, px_tol, px_frac,
                   counters, counter_rtol, corr=None):
    mean, mref = img.mean((0, 1)), ref.mean((0, 1))
    rel = np.abs(mean - mref) / np.abs(mref)
    check((rel <= mean_rtol).all(), f"{tag}: channel means {mean} vs {mref}")
    scale = np.maximum(np.abs(ref), np.abs(ref).mean())
    frac = (np.abs(img - ref) <= px_tol * scale).all(-1).mean()
    check(frac >= px_frac, f"{tag}: {frac:.4f} of pixels within the bar")
    if corr is not None:
        c = np.corrcoef(img.ravel(), ref.ravel())[0, 1]
        check(c >= corr, f"{tag}: Pearson correlation {c:.6f}")
    for k in counters:
        a, b = st["device_counters"][k], st_ref["device_counters"][k]
        check(abs(a - b) <= counter_rtol * max(abs(b), 1.0),
              f"{tag}: counter {k} {a} vs {b}")
    return frac


def coverage_scene(res, integrator="plt_path"):
    from wave_tracer_tpu_torch.scene.procedural import make_coverage_scene
    scene = make_coverage_scene(res)
    scene.integrator.type = integrator
    return scene


def check_coverage(img, st, res, tag):
    """tests/test_coverage.py's bar on the port's own map: finite, more
    than 20% of the elements lit, the building's shadow over the far
    third. Returns (lit share, mean near, mean far)."""
    check(st["mode"] == "forward-wave", f"{tag}: mode {st['mode']}")
    check(img.shape == (res, res, 1), f"{tag}: map shape {img.shape}")
    cov = img[..., 0]
    check(np.isfinite(cov).all(), f"{tag}: non-finite elements")
    lit = (cov > 0).mean()
    check(lit > 0.2, f"{tag}: {lit:.3f} of the elements lit")
    H = cov.shape[0]
    near, far = cov[: H // 3], cov[2 * H // 3:]
    m_near = near[near > 0].mean() if (near > 0).any() else 0.0
    m_far = far[far > 0].mean() if (far > 0).any() else m_near
    check(m_far < 0.75 * m_near or (far > 0).mean() < 0.6 * (near > 0).mean(),
          f"{tag}: no shadowing (near {m_near}, far {m_far})")
    return lit, m_near, m_far


def compare_maps(img, ref, tag):
    """Coverage maps at the CPU tests' film-level bars
    (tests/test_torch_coverage_render.py::film_stats): the median ratio
    of the elements lit in both within 1e-3 of 1, the Pearson correlation
    of the dB maps >= 0.95, >= 90% of the elements within 0.1 dB (a few
    FSD-NEE point splats of huge weight dominate the mean, so it is
    printed, not held). Returns the three numbers and the means' ratio."""
    a, b = img[..., 0], ref[..., 0]
    la = 10.0 * np.log10(np.maximum(a, 1e-30))
    lb = 10.0 * np.log10(np.maximum(b, 1e-30))
    both = (a > 0) & (b > 0)
    median = float(np.median(a[both] / b[both]))
    corr = np.corrcoef(la.ravel(), lb.ravel())[0, 1]
    share = (np.abs(la - lb) <= 0.1).mean()
    check(abs(median - 1.0) <= 1e-3, f"{tag}: median ratio {median}")
    check(corr >= 0.95, f"{tag}: dB Pearson correlation {corr:.4f}")
    check(share >= 0.90, f"{tag}: {share:.4f} of elements within 0.1 dB")
    return median, corr, share, a.mean() / b.mean()


def capture_anyhit(rk, built):
    """One render of `built` on the card, keeping a copy of the arguments
    of the K2 call with the most needed rows."""
    from wave_tracer_tpu_torch.render import render_scene
    real = rk.any_hit
    best = {"n": -1}

    def spy(*args, **kw):
        out = real(*args, **kw)
        need = args[7] if len(args) > 7 else kw.get("need")
        n = args[2].shape[0] if need is None else int(need.sum())
        if n > best["n"]:
            best.update(n=n, args=[a.clone() for a in args[:7]],
                        need=None if need is None else need.clone(),
                        table=kw["table"])
        return out

    rk.any_hit = spy
    try:
        render_scene(built, device="cuda")
    finally:
        rk.any_hit = real
    check(best["n"] > 0, "phase 14b: no K2 call with a needed row")
    return best


def check_anyhit_forward(rk, cap):
    """K2 against its plain version on a captured forward call: needed
    rows agree on >= 99.9%, unneeded rows are False."""
    args, need, table = cap["args"], cap["need"], cap["table"]
    N, T = args[2].shape[0], args[0].shape[0]
    ok_k = rk.any_hit(*args, need, table=table)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ok_r = anyhit_ref_chunked(rk, args, need)
    b.record()
    torch.cuda.synchronize()
    ms_plain = a.elapsed_time(b)
    if need is not None:
        check(not ok_k[~need].any().item(),
              "phase 14b: an unneeded row is occluded")
        rows = need
    else:
        rows = torch.ones_like(ok_k)
    frac = (ok_k[rows] == ok_r[rows]).float().mean().item()
    check(frac >= 0.999, f"phase 14b: needed rows agree on {frac:.5f}")
    ms = cuda_ms(lambda: rk.any_hit(*args, need, table=table), 3)
    ops, kept = anyhit_need(rk, table, args, ok_k, need)
    n_need = int(rows.sum().item())
    bnd = bound(ops, T * rk.NF * 4 + n_need * 45)
    print(f"phase 14b: N={N} T={T} (the forward's 51 segments per lane): "
          f"K2 with the render's need mask of {n_need} rows "
          f"({n_need / N:.4f}): needed rows agree {frac:.6f}, unneeded rows "
          f"all False, occluded {ok_r[rows].float().mean().item():.4f}; "
          f"{ms:.3f} ms (plain {ms_plain:.3f} ms, ray chunks of {POOL}), "
          f"bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    return dict(rows=N, needed_rows=n_need,
                max_abs_err=float((ok_k != ok_r)[rows].float().max().item()),
                ms=ms, plain_ms=ms_plain, bound_ms=bnd[0], bound_by=bnd[1])


def zero(*counts):
    for c in counts:
        for k in c:
            c[k] = 0


def main():
    # ---- phase 1
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from wave_tracer_tpu_torch.accel import cone_kernels as ck
    from wave_tracer_tpu_torch.accel import nvcc_build
    from wave_tracer_tpu_torch.accel import ray_kernels as rk
    from wave_tracer_tpu_torch.integrator.path_compact import FSD_SLOTS
    from wave_tracer_tpu_torch.render import render_scene
    from wave_tracer_tpu_torch.render.renderer import POOL_LANES_CUDA
    from wave_tracer_tpu_torch.scene import build_scene
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: n/a"
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    check(POOL_LANES_CUDA == POOL, f"pool {POOL_LANES_CUDA}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 2
    t0 = time.perf_counter()
    nvcc_build.build("ray_kernels", "cone_kernels")
    rk.build()
    ck.build()
    print(f"phase 2: kernels built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, info in nvcc_build.BUILD_INFO.items():
        print(f"  {name}: nvcc {info.get('seconds', 0.0):.2f} s", flush=True)
        for line in info.get("ptxas", "").splitlines():
            entry = re.search(
                r"entry function '[^']*?([a-z][a-z_]*_kernel)(?:ILb(\d)E|E)",
                line)
            if entry:
                flag = f"<{entry.group(2)}>" if entry.group(2) else ""
                print(f"    ptxas: {entry.group(1)}{flag}", flush=True)
            elif "registers" in line or "spill" in line:
                print("    ptxas:", line.strip(), flush=True)

    # ---- phase 3: K1/K2 at the shapes of the renders
    lanes4 = min(256 * 256 * 16, POOL)
    lanes6 = min(256 * 256 * 4, POOL)
    built = build_scene(box_scene(256, 16, 8), device="cuda")
    big = build_scene(box_scene(256, 8, 8, icosphere=True), device="cuda")
    check(built.data.geo.num_tris == 12,
          f"box has {built.data.geo.num_tris} triangles")
    check(big.data.geo.num_tris == 81932,
          f"box + icosphere has {big.data.geo.num_tris} triangles")
    ks_box = check_ray_kernels(rk, built.data.geo, lanes4, 1234)
    kstats = check_ray_kernels(rk, big.data.geo, lanes6, 1235)
    # the wave bounce's batched FSD-leg call: 2K+1 segments per lane
    n_legs = (2 * FSD_SLOTS + 1) * POOL
    legs_box = check_anyhit_legs(rk, built.data.geo, n_legs, 1236)
    legs = check_anyhit_legs(rk, big.data.geo, n_legs, 1237)
    for k in kstats:
        kstats[k]["max_abs_err"] = max(kstats[k]["max_abs_err"],
                                       ks_box[k]["max_abs_err"])
    # K2's row reports its largest launch on the wave path, the leg call
    legs["max_abs_err"] = max(kstats["anyhit"]["max_abs_err"],
                              legs["max_abs_err"], legs_box["max_abs_err"])
    kstats["anyhit"] = legs

    # ---- phase 4: the classical main path
    render_scene(built, spp=1, device="cuda")          # warm-up
    zero(rk.LAUNCHES, ck.LAUNCHES)
    img, st = render_scene(built, device="cuda")
    torch.cuda.synchronize()
    classical_launches = dict(rk.LAUNCHES, **ck.LAUNCHES)
    check(classical_launches["closest"] > 0
          and classical_launches["anyhit"] > 0,
          f"classical main path launched {classical_launches}")
    check_render(img, st, (256, 256, 3), "phase 4")
    check(st["mode"] == "ray-compact", f"phase 4: mode {st['mode']}")
    check(st["pool_lanes"] == lanes4, f"phase 4 pool {st['pool_lanes']}")
    print(f"phase 4: classical box 256x256 16 spp depth 8: "
          f"{rate_line(built, st)}, "
          f"pool {st['pool_lanes']}), launches {classical_launches}",
          flush=True)

    # ---- phase 5: classical, card vs CPU
    small = build_scene(box_scene(64, 4, 5), device="cuda")
    img_c, st_c = render_scene(small, device="cuda")
    img_h, st_h = render_scene(small, device="cpu")
    frac = compare_images(
        img_c, img_h, st_c, st_h, "phase 5", mean_rtol=0.01, px_tol=1e-3,
        px_frac=0.98, counter_rtol=0.005,
        counters=("rays_cast", "shadow_rays", "surface_interactions",
                  "rr_terminations", "sum_path_depth"))
    print(f"phase 5: 64x64 4 spp depth 5: cuda vs cpu: {frac:.4f} of "
          f"pixels within the bar", flush=True)

    # ---- phase 6: classical scale case
    render_scene(big, spp=1, device="cuda")            # warm-up
    before = dict(rk.LAUNCHES)
    img6, st6 = render_scene(big, device="cuda")
    torch.cuda.synchronize()
    check(all(rk.LAUNCHES[k] > before[k] for k in before),
          f"phase 6 launched {rk.LAUNCHES} after {before}")
    check_render(img6, st6, (256, 256, 3), "phase 6")
    check(st6["pool_lanes"] == lanes6, f"phase 6 pool {st6['pool_lanes']}")
    print(f"phase 6: classical box + icosphere ({big.data.geo.num_tris} "
          f"tris) 256x256 8 spp depth 8: {rate_line(big, st6)})", flush=True)

    # ---- phase 7: K3 at the wave pool's width
    wbox = build_scene(box_scene(256, 8, 8, fsd=True), device="cuda")
    wbig = build_scene(box_scene(256, 4, 8, icosphere=True, fsd=True),
                       device="cuda")
    k3_box = check_cone_kernel(ck, wbox.data.geo, wbox.scene.world_radius(),
                               POOL, 4321)
    k3 = check_cone_kernel(ck, wbig.data.geo, wbig.scene.world_radius(),
                           POOL, 4322)
    k3_narrow = check_cone_narrow(ck, wbig, POOL, 4323)

    # ---- phase 8: the wave main path
    render_scene(wbox, spp=1, device="cuda")           # warm-up
    zero(rk.LAUNCHES, ck.LAUNCHES)
    img8, st8 = render_scene(wbox, device="cuda")
    torch.cuda.synchronize()
    wave_launches = dict(rk.LAUNCHES, **ck.LAUNCHES)
    check(all(v > 0 for v in wave_launches.values()),
          f"wave main path launched {wave_launches}")
    check_wave_render(img8, st8, (256, 256, 3), "phase 8")
    check(st8["pool_lanes"] == POOL, f"phase 8 pool {st8['pool_lanes']}")
    dc = st8["device_counters"]
    print(f"phase 8: wave box 256x256 8 spp depth 8: "
          f"{rate_line(wbox, st8)}, "
          f"pool {st8['pool_lanes']}), launches {wave_launches}, fsd "
          f"{dc['fsd_interactions']:.0f}, diffusive "
          f"{dc['diffusive_traversals']:.0f}, edge hits "
          f"{dc['edge_sweep_hits']:.0f}", flush=True)

    # ---- phase 9: wave, card vs CPU
    wsmall = build_scene(box_scene(32, 4, 5, fsd=True), device="cuda")
    img_c, st_c = render_scene(wsmall, device="cuda")
    img_h, st_h = render_scene(wsmall, device="cpu")
    check(st_c["mode"] == st_h["mode"] == "wave-compact", "phase 9: mode")
    frac = compare_images(
        img_c, img_h, st_c, st_h, "phase 9", mean_rtol=0.02, px_tol=1e-2,
        px_frac=0.90, counter_rtol=0.02, corr=0.999,
        counters=("rays_cast", "surface_interactions", "fsd_interactions",
                  "diffusive_traversals", "sum_path_depth"))
    print(f"phase 9: wave 32x32 4 spp depth 5: cuda vs cpu: {frac:.4f} of "
          f"pixels within the bar", flush=True)

    # ---- phase 9b: carried hits on the card
    check_carry(rk, wsmall, "wave box 32x32 4 spp depth 5, pool 1024", 1024)
    check_carry(rk, build_scene(box_scene(32, 4, 8, icosphere=True),
                                device="cuda"),
                "classical box + icosphere 32x32 4 spp depth 8, pool 1024",
                1024)

    # ---- phase 10: wave scale case
    render_scene(wbig, spp=1, device="cuda")           # warm-up
    before = dict(rk.LAUNCHES, **ck.LAUNCHES)
    img10, st10 = render_scene(wbig, device="cuda")
    torch.cuda.synchronize()
    after = dict(rk.LAUNCHES, **ck.LAUNCHES)
    check(all(after[k] > before[k] for k in before),
          f"phase 10 launched {after} after {before}")
    check_wave_render(img10, st10, (256, 256, 3), "phase 10")
    print(f"phase 10: wave box + icosphere ({wbig.data.geo.num_tris} tris) "
          f"256x256 4 spp depth 8: {rate_line(wbig, st10)})", flush=True)
    calls, cull10, kept10 = timed_render(rk, ck, wbig)
    T10 = wbig.data.geo.num_tris
    in_render = summarize_calls(rk, calls, T10, "phase 10")
    print("phase 10: in the render, closest: needed-row share per pool "
          "step: " + ", ".join(f"{c[2] / c[1]:.4f}" for c in calls["closest"])
          + "; ms per step: " + ", ".join(f"{c[0]:.3f}"
                                         for c in calls["closest"]),
          flush=True)
    print(f"phase 10: in the render, K3: "
          f"{cull_line(cull10, in_render['cone_minz']['rows'], T10, kept10)}"
          f" (over {len(calls['cone_minz'])} launches)", flush=True)

    # ---- phase 3b: K2's need masks at the leg width, at the leg share the
    # scale render showed
    legs_need = check_anyhit_need(
        rk, big.data.geo, n_legs, 1238,
        max(in_render["anyhit_legs"]["needed_share"], 1e-3))
    k1_share = in_render["closest"]["needed_share"]
    check_closest_need(rk, built.data.geo, lanes4, 1239, k1_share)
    k1_need = check_closest_need(rk, big.data.geo, lanes6, 1240, k1_share)

    # ---- phase 12: the bdpt main path
    bdpt = build_scene(bdpt_scene(256, 4, 8), device="cuda")
    render_scene(bdpt, spp=1, device="cuda")           # warm-up
    zero(rk.LAUNCHES, ck.LAUNCHES)
    img12, st12 = render_scene(bdpt, device="cuda")
    torch.cuda.synchronize()
    bdpt_launches = dict(rk.LAUNCHES, **ck.LAUNCHES)
    check(bdpt_launches["closest"] > 0 and bdpt_launches["anyhit"] > 0,
          f"bdpt main path launched {bdpt_launches}")
    check_render(img12, st12, (256, 256, 3), "phase 12")
    check(st12["mode"] == "bdpt", f"phase 12: mode {st12['mode']}")
    dc = st12["device_counters"]
    check(dc["fsd_interactions"] > 0, f"phase 12: no FSD interactions {dc}")
    rate12 = (rate_line(bdpt, st12) if st12["seconds"] < 30 else
              f"{st12['paths_per_sec']:.1f} paths/s (one render of "
              f"{st12['seconds']:.3f} s")
    print(f"phase 12: bdpt box 256x256 4 spp depth 8: {rate12}, batch "
          f"{st12['pool_lanes']}), launches {bdpt_launches}, fsd "
          f"{dc['fsd_interactions']:.0f}, null {dc['null_interactions']:.0f}"
          f", edge hits {dc['edge_sweep_hits']:.0f}", flush=True)
    calls12, _, _ = timed_render(rk, ck, bdpt, anyhit_kind=lambda n: "anyhit")
    in_bdpt = summarize_calls(rk, calls12, bdpt.data.geo.num_tris,
                              "phase 12")

    # ---- phase 13: bdpt, card vs CPU
    bsmall = build_scene(bdpt_scene(32, 4, 5), device="cuda")
    img_c, st_c = render_scene(bsmall, device="cuda")
    img_h, st_h = render_scene(bsmall, device="cpu")
    check(st_c["mode"] == st_h["mode"] == "bdpt", "phase 13: mode")
    frac = compare_images(
        img_c, img_h, st_c, st_h, "phase 13", mean_rtol=0.02, px_tol=1e-2,
        px_frac=0.90, counter_rtol=0.02, corr=0.999,
        counters=("rays_cast", "surface_interactions", "fsd_interactions",
                  "sum_path_depth", "shadow_rays"))
    for k, rtol in (("edge_sweep_hits", 0.08), ("null_interactions", 0.18)):
        a, b = st_c["device_counters"][k], st_h["device_counters"][k]
        check(abs(a - b) <= rtol * max(b, 1.0),
              f"phase 13: counter {k} {a} vs {b}")
    print(f"phase 13: bdpt 32x32 4 spp depth 5: cuda vs cpu: {frac:.4f} of "
          f"pixels within the bar", flush=True)

    # ---- phase 14: the coverage main path (forward transport, UTD FSD)
    cov = build_scene(coverage_scene(256), device="cuda")
    check(cov.data.geo.num_tris == 14,
          f"coverage scene has {cov.data.geo.num_tris} triangles")
    render_scene(cov, spp=1, device="cuda")            # warm-up
    torch.cuda.reset_peak_memory_stats()
    zero(rk.LAUNCHES, ck.LAUNCHES)
    img14, st14 = render_scene(cov, device="cuda")
    torch.cuda.synchronize()
    cov_launches = dict(rk.LAUNCHES, **ck.LAUNCHES)
    check(cov_launches["closest"] > 0 and cov_launches["anyhit"] > 0,
          f"coverage main path launched {cov_launches}")
    check(st14["paths"] == 256 * 256 * 8 and st14["pool_lanes"] == POOL,
          f"phase 14: {st14['paths']} paths, batch {st14['pool_lanes']}")
    lit, m_near, m_far = check_coverage(img14, st14, 256, "phase 14")
    peak14 = torch.cuda.max_memory_allocated() / 2 ** 30
    rate14 = (rate_line(cov, st14) if st14["seconds"] < 30 else
              f"{st14['paths_per_sec']:.1f} paths/s (one render of "
              f"{st14['seconds']:.3f} s")
    print(f"phase 14: coverage 256x256 8 spe depth 4 plt_path (UTD): "
          f"{rate14}, batch {st14['pool_lanes']} x {st14['batches']}), "
          f"launches {cov_launches}, lit {lit:.3f}, mean near {m_near:.4g} "
          f"far {m_far:.4g}, peak memory {peak14:.2f} GiB", flush=True)
    calls14, _, _ = timed_render(rk, ck, cov, anyhit_kind=lambda n: "anyhit")
    in_cov = summarize_calls(rk, calls14, cov.data.geo.num_tris, "phase 14")
    print("phase 14: in the render, anyhit: rows per call: " + ", ".join(
        f"{c[2]}/{c[1]}" for c in calls14["anyhit"]), flush=True)

    covb = build_scene(coverage_scene(256, "plt_bdpt"), device="cuda")
    render_scene(covb, spp=1, device="cuda")           # warm-up
    zero(rk.LAUNCHES, ck.LAUNCHES)
    img14f, st14f = render_scene(covb, device="cuda")
    torch.cuda.synchronize()
    fr_launches = dict(rk.LAUNCHES, **ck.LAUNCHES)
    check(fr_launches["closest"] > 0 and fr_launches["anyhit"] == 0
          and fr_launches["cone_minz"] == 0,
          f"Fraunhofer forward launched {fr_launches}")
    lit, m_near, m_far = check_coverage(img14f, st14f, 256, "phase 14 bdpt")
    rate14f = (rate_line(covb, st14f) if st14f["seconds"] < 30 else
               f"{st14f['paths_per_sec']:.1f} paths/s (one render of "
               f"{st14f['seconds']:.3f} s")
    print(f"phase 14: coverage 256x256 8 spe depth 4 plt_bdpt (Fraunhofer "
          f"forward): {rate14f}, batch {st14f['pool_lanes']}), launches "
          f"{fr_launches}, lit {lit:.3f}, mean near {m_near:.4g} far "
          f"{m_far:.4g}", flush=True)
    calls14f, _, _ = timed_render(rk, ck, covb)
    in_cov_fr = summarize_calls(rk, calls14f, covb.data.geo.num_tris,
                                "phase 14 bdpt")

    # ---- phase 14b: K2 at the forward's own width and need mask
    k2_fwd = check_anyhit_forward(rk, capture_anyhit(rk, cov))
    kstats["anyhit"]["max_abs_err"] = max(kstats["anyhit"]["max_abs_err"],
                                          k2_fwd["max_abs_err"])

    # ---- phase 15: coverage, card vs CPU
    for integrator in ("plt_path", "plt_bdpt"):
        csmall = build_scene(coverage_scene(32, integrator), device="cuda")
        img_c, st_c = render_scene(csmall, spp=4, device="cuda",
                                   pool_lanes=4096)
        img_h, st_h = render_scene(csmall, spp=4, device="cpu",
                                   pool_lanes=4096)
        check(st_c["mode"] == st_h["mode"] == "forward-wave",
              f"phase 15 {integrator}: mode")
        m, c, f, r = compare_maps(img_c, img_h, f"phase 15 {integrator}")
        print(f"phase 15: coverage 32x32 4 spe depth 4 {integrator}: cuda vs "
              f"cpu: median ratio {m:.6f}, dB Pearson {c:.5f}, {f:.4f} of "
              f"elements within 0.1 dB, means' ratio {r:.4f}", flush=True)

    # ---- phase 11
    def row(name, src, replaces, key, stats, **extra):
        bound_ms, bound_by = stats["bound"]
        return dict(name=name, route="cuda",
                    source=f"wave_tracer_tpu_torch/csrc/{src}",
                    replaces=replaces, launches=wave_launches[key],
                    launches_by_path={"wave": wave_launches[key],
                                      "classical": classical_launches[key],
                                      "bdpt": bdpt_launches[key],
                                      "coverage": cov_launches[key],
                                      "coverage_fraunhofer":
                                          fr_launches[key]},
                    max_abs_err=stats["max_abs_err"], ms=stats["ms"],
                    plain_ms=stats["plain_ms"], bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None, **extra)

    kernels = [
        row("closest_hit", "ray_kernels.cu",
            "wave_tracer_tpu/accel/mxu_trace.py:155", "closest",
            kstats["closest"], in_scale_render=in_render["closest"],
            need_mask_ms=k1_need[0], empty_mask_ms=k1_need[1],
            in_bdpt_render=in_bdpt["closest"],
            in_coverage_render=in_cov["closest"],
            in_coverage_fraunhofer_render=in_cov_fr["closest"],
            culls_off_ms=kstats["closest"]["culls_off_ms"],
            all_pairs_bound_ms=kstats["closest"]["all_pairs_bound_ms"]),
        row("any_hit", "ray_kernels.cu",
            "wave_tracer_tpu/accel/mxu_trace.py:185", "anyhit",
            kstats["anyhit"],
            in_scale_render={k: in_render[k]
                             for k in ("anyhit_legs", "anyhit_nee")},
            in_bdpt_render=in_bdpt["anyhit"],
            in_coverage_render=in_cov["anyhit"], at_forward_width=k2_fwd,
            need_mask_ms=legs_need[0], empty_mask_ms=legs_need[1]),
        row("cone_minz", "cone_kernels.cu",
            "wave_tracer_tpu/accel/mxu_cone.py:309", "cone_minz", k3,
            narrow_cones=k3_narrow,
            in_scale_render=in_render["cone_minz"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
