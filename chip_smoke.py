"""On-card smoke test of the PyTorch/CUDA port (wave_tracer_tpu_torch).

Drives the port's two main paths through the entry points a user calls
(`scene.build_scene`, `render.render_scene`) on one CUDA card — the
classical plt_path renderer (fsd=False) and the wave-optical plt_path
(fsd=True: hybrid cone traversal + deferred coherent FSD), both through
the persistent compacted wavefront — and holds every hand-written kernel
of those paths against its plain torch version.

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
     occlusion agrees on >= 99.9%; times from CUDA events after a warm-up.
     K2 also at the width of the wave bounce's batched FSD-leg call,
     (2K+1)·262,144 = 4,456,448 segments, on both scenes, against its
     plain version run in ray chunks of 262,144, with the same bar
  4. render_scene: box, plt_path, fsd=False, 256x256, 16 spp, max_depth 8
     (the benchmark's classical configuration); launch counters are zeroed
     just before and read just after, and must both have grown
  5. the classical box at 64x64, 4 spp, max_depth 5 on the card and on the
     CPU (plain versions): image mean per channel within 1%, >= 98% of
     pixels within 1e-3·max(|ref|, mean|ref|), device counters within 0.5%
  6. classical box + 81,920-triangle icosphere at 256x256, 4 spp, depth 8
  7. K3 (cone-triangle boundary sweep) against its plain version at the
     wave pool's width (262,144 seeded random cones inside the scene's
     bounds: ta 0.01-0.2, e 0.6-1.0, x0 0.01-0.3, boundaries of visible
     wavelengths, zmax = the scene radius, a third with an excluded id) on
     the box and on the box + icosphere; the plain version runs in lane
     chunks of 16,384. Bars: finite masks agree on > 99.9% of entries,
     minima within rtol/atol 2e-4, counts within max(2, 2%) on > 97% of
     lanes; times from CUDA events after a warm-up
  8. the wave main path: box, plt_path, fsd=True, 256x256, 8 spp,
     max_depth 8 (the benchmark's timed headline); counters zeroed just
     before and read just after: K1, K2 and K3 must all have launched, the
     mode is "wave-compact", and FSD interactions, diffusive traversals and
     edge-sweep hits all occurred
  9. the wave box at 32x32, 4 spp, max_depth 5 on the card and on the CPU:
     channel means within 2%, Pearson correlation >= 0.999, >= 90% of
     pixels within 1e-2·max(|ref|, mean|ref|), device counters within 2%
 10. wave box + icosphere at 256x256, 4 spp, max_depth 8
 11. prints the kernels' JSON line (each kernel's launches on the wave
     main path, and per path under "launches_by_path") and, last, the
     result JSON line
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

POOL = 1 << 18              # the renderer's CUDA lane pool
REF_CHUNK = 16384           # lanes per chunk of K3's plain version
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


def bound(pairs, flop_per_pair, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the fp32
    peak and the bytes over the memory rate."""
    t_ops = pairs * flop_per_pair / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def box_scene(res, spp, depth, icosphere=False, fsd=False):
    from wave_tracer_tpu_torch.scene.procedural import make_box_scene
    scene = make_box_scene(res=res, spp=spp, icosphere=icosphere)
    scene.integrator.type = "plt_path"
    scene.integrator.fsd = fsd
    scene.integrator.max_depth = depth
    return scene


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

    tk, ik = rk.closest_hit(*args, ex)
    tr, ir = rk._closest_ref(*args, ex)
    agree = (ik == ir)
    frac_id = agree.float().mean().item()
    both = agree & (ir >= 0)
    check(both.any().item(), "K1: no hits at all")
    err_t = (tk[both] - tr[both]).abs()
    check(bool((err_t <= 1e-5 + 1e-4 * tr[both].abs()).all()),
          f"K1: t disagrees (max abs {err_t.max().item()})")
    check(frac_id >= 0.999, f"K1: ids agree on {frac_id:.5f} of rays")

    tmax_s = torch.from_numpy(r.uniform(0.05, 4.0, N).astype(np.float32)
                              ).to(dev)
    sargs = (geo.tri_feat, geo.mxu_center, ro_t, rd_t, tmin, tmax_s, ex)
    ok_k = rk.any_hit(*sargs)
    ok_r = rk._anyhit_ref(*sargs)
    frac_occ = (ok_k == ok_r).float().mean().item()
    check(frac_occ >= 0.999, f"K2: occlusion agrees on {frac_occ:.5f}")
    torch.cuda.synchronize()

    ms_k1 = cuda_ms(lambda: rk.closest_hit(*args, ex), 5)
    ms_t1 = cuda_ms(lambda: rk._closest_ref(*args, ex), 1)
    ms_k2 = cuda_ms(lambda: rk.any_hit(*sargs), 5)
    ms_t2 = cuda_ms(lambda: rk._anyhit_ref(*sargs), 1)
    print(f"phase 3: N={N} T={T}: K1 ids agree {frac_id:.6f}, max |dt| "
          f"{err_t.max().item():.3e}, hits {both.float().mean().item():.3f}; "
          f"K2 agree {frac_occ:.6f}, occluded "
          f"{ok_r.float().mean().item():.3f}", flush=True)
    print(f"phase 3: N={N} T={T}: K1 {ms_k1:.3f} ms (plain {ms_t1:.3f} ms),"
          f" K2 {ms_k2:.3f} ms (plain {ms_t2:.3f} ms)", flush=True)
    # bytes: the triangle rows, per ray ro/rd/tmin/tmax/3 exclusions in
    # and one 8-byte word (K1) or byte (K2) out
    tri_bytes = T * rk.NF * 4
    k1 = bound(N * T, FLOP_PER_PAIR["closest"], tri_bytes + N * (44 + 8))
    k2 = bound(N * T, FLOP_PER_PAIR["anyhit"], tri_bytes + N * (44 + 1))
    return dict(
        closest=dict(max_abs_err=err_t.max().item(), ms=ms_k1,
                     plain_ms=ms_t1, bound=k1),
        anyhit=dict(max_abs_err=float((ok_k != ok_r).float().max().item()),
                    ms=ms_k2, plain_ms=ms_t2, bound=k2))


def check_anyhit_legs(rk, geo, N, seed):
    """K2 vs its plain version at the width of the wave bounce's batched
    FSD-leg call: N seeded random segments through geo, a third with three
    excluded ids. The plain version runs in ray chunks of POOL (its
    (N, 5·512) temporaries would not fit at full width)."""
    T = geo.num_tris
    r = np.random.default_rng(seed)
    ro, rd = random_rays(geo, N, r)
    dev = geo.p0.device
    ex = np.where((r.random(N) < 1 / 3)[:, None],
                  r.integers(0, T, (N, 3)), -1).astype(np.int32)
    args = (geo.tri_feat, geo.mxu_center, torch.from_numpy(ro).to(dev),
            torch.from_numpy(rd).to(dev), torch.full((N,), 1e-4, device=dev),
            torch.from_numpy(r.uniform(0.05, 4.0, N).astype(np.float32)
                             ).to(dev),
            torch.from_numpy(ex).to(dev))
    ok_k = rk.any_hit(*args)
    # the plain version at these chunk shapes is warm from check_ray_kernels
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ok_r = torch.cat([rk._anyhit_ref(*args[:2], *(
        x[s:s + POOL] for x in args[2:])) for s in range(0, N, POOL)])
    b.record()
    torch.cuda.synchronize()
    ms_plain = a.elapsed_time(b)
    frac_occ = (ok_k == ok_r).float().mean().item()
    check(frac_occ >= 0.999, f"K2 N={N} T={T}: occlusion agrees on "
          f"{frac_occ:.5f}")
    ms = cuda_ms(lambda: rk.any_hit(*args), 3)
    print(f"phase 3: N={N} T={T}: K2 agree {frac_occ:.6f}, occluded "
          f"{ok_r.float().mean().item():.3f}; K2 {ms:.3f} ms (plain "
          f"{ms_plain:.3f} ms, ray chunks of {POOL})", flush=True)
    return dict(max_abs_err=float((ok_k != ok_r).float().max().item()),
                ms=ms, plain_ms=ms_plain,
                bound=bound(N * T, FLOP_PER_PAIR["anyhit"],
                            T * rk.NF * 4 + N * (44 + 1)))


def minz_ref_chunked(ck, args):
    """K3's plain version in lane chunks (its (N, 512) temporaries would
    not fit at full width)."""
    tri, lane, zmin = args[0], args[1:-1], args[-1]
    outs = [ck._minz_ref(tri, *(a[s:s + REF_CHUNK] for a in lane), zmin)
            for s in range(0, lane[0].shape[0], REF_CHUNK)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


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
    zc, cnt = ck.cone_minz(*args)
    ck._minz_ref(args[0], *(a[:256] for a in args[1:-1]), args[-1])
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    zr, cr = minz_ref_chunked(ck, args)
    b.record()
    torch.cuda.synchronize()
    ms_plain = a.elapsed_time(b)
    finite = torch.isfinite(zr)
    check(finite.any().item(), f"K3 T={T}: no encounters at all")
    frac_fin = (torch.isfinite(zc) == finite).float().mean().item()
    check(frac_fin > 0.999, f"K3 T={T}: finite masks agree on {frac_fin}")
    both = finite & torch.isfinite(zc)
    err = (zc[both] - zr[both]).abs()
    check(bool((err <= 2e-4 + 2e-4 * zr[both].abs()).all()),
          f"K3 T={T}: minima disagree (max abs {err.max().item()})")
    frac_cnt = ((cnt - cr).abs() <= torch.clamp(0.02 * cr, min=2)
                ).float().mean().item()
    check(frac_cnt > 0.97, f"K3 T={T}: counts agree on {frac_cnt}")
    ms = cuda_ms(lambda: ck.cone_minz(*args), 3)
    print(f"phase 7: N={N} T={T}: K3 finite masks agree {frac_fin:.6f}, "
          f"max |dz| {err.max().item():.3e}, counts agree {frac_cnt:.6f}, "
          f"mean count {cr.float().mean().item():.2f}, finite minima "
          f"{finite.float().mean().item():.3f}", flush=True)
    print(f"phase 7: N={N} T={T}: K3 {ms:.3f} ms (plain {ms_plain:.3f} ms, "
          f"lane chunks of {REF_CHUNK})", flush=True)
    # bytes: triangle rows (36 B), per lane 16 floats + exclusion + 16
    # boundaries in, 16 minima + count out
    nbytes = T * 36 + N * (64 + 4 + 64 + 64 + 4)
    return dict(max_abs_err=err.max().item(), ms=ms, plain_ms=ms_plain,
                bound=bound(N * T, FLOP_PER_PAIR["cone_minz"], nbytes))


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
            if "registers" in line:
                print("    ptxas:", line.strip(), flush=True)

    # ---- phase 3: K1/K2 at the shapes of the renders
    lanes4 = min(256 * 256 * 16, POOL)
    lanes6 = min(256 * 256 * 4, POOL)
    built = build_scene(box_scene(256, 16, 8), device="cuda")
    big = build_scene(box_scene(256, 4, 8, icosphere=True), device="cuda")
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
          f"{st['paths_per_sec']:.1f} paths/s ({st['seconds']:.3f} s, "
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
          f"tris) 256x256 4 spp depth 8: {st6['paths_per_sec']:.1f} paths/s "
          f"({st6['seconds']:.3f} s)", flush=True)

    # ---- phase 7: K3 at the wave pool's width
    wbox = build_scene(box_scene(256, 8, 8, fsd=True), device="cuda")
    wbig = build_scene(box_scene(256, 4, 8, icosphere=True, fsd=True),
                       device="cuda")
    k3_box = check_cone_kernel(ck, wbox.data.geo, wbox.scene.world_radius(),
                               POOL, 4321)
    k3 = check_cone_kernel(ck, wbig.data.geo, wbig.scene.world_radius(),
                           POOL, 4322)
    k3["max_abs_err"] = max(k3["max_abs_err"], k3_box["max_abs_err"])

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
          f"{st8['paths_per_sec']:.1f} paths/s ({st8['seconds']:.3f} s, "
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
          f"256x256 4 spp depth 8: {st10['paths_per_sec']:.1f} paths/s "
          f"({st10['seconds']:.3f} s)", flush=True)

    # ---- phase 11
    def row(name, src, replaces, key, stats):
        bound_ms, bound_by = stats["bound"]
        return dict(name=name, route="cuda",
                    source=f"wave_tracer_tpu_torch/csrc/{src}",
                    replaces=replaces, launches=wave_launches[key],
                    launches_by_path={"wave": wave_launches[key],
                                      "classical": classical_launches[key]},
                    max_abs_err=stats["max_abs_err"], ms=stats["ms"],
                    plain_ms=stats["plain_ms"], bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None)

    kernels = [
        row("closest_hit", "ray_kernels.cu",
            "wave_tracer_tpu/accel/mxu_trace.py:155", "closest",
            kstats["closest"]),
        row("any_hit", "ray_kernels.cu",
            "wave_tracer_tpu/accel/mxu_trace.py:185", "anyhit",
            kstats["anyhit"]),
        row("cone_minz", "cone_kernels.cu",
            "wave_tracer_tpu/accel/mxu_cone.py:309", "cone_minz", k3),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
