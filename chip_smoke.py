"""On-card smoke test of the PyTorch/CUDA port (wave_tracer_tpu_torch).

Drives the port's main path — the classical plt_path renderer (fsd=False)
through the persistent compacted wavefront — on one CUDA card, through the
entry points a user calls (`scene.build_scene`, `render.render_scene`), and
holds every hand-written kernel of that path against its plain torch twin.

    python3 chip_smoke.py                # needs one card

Phases (each raises on failure; nothing is caught):
  1. a CUDA card is required: without one the script exits nonzero and
     prints no result; prints the card's name and power limit
  2. builds the kernels (nvcc, sm_90a) from csrc/ and prints the build time
  3. K1 (closest hit) and K2 (any hit) against their torch twins at the
     shapes phases 4 and 6 give them: as many seeded random rays as the
     renderer's lane pool (262,144), a third with exclusions, on the box
     (12 triangles) and on the box + icosphere (81,932): ids agree on
     >= 99.9% of rays, t within rtol 1e-4 / atol 1e-5 where ids agree,
     occlusion agrees on >= 99.9%; times from CUDA events after a warm-up
  4. render_scene: box, plt_path, fsd=False, 256x256, 16 spp, max_depth 8
     (the benchmark's classical configuration); launch counters are zeroed
     just before and read just after, and must both have grown
  5. the box at 64x64, 4 spp, max_depth 5 on the card and on the CPU (plain
     twins): image mean per channel within 1%, >= 98% of pixels within
     1e-3·max(|ref|, mean|ref|), device counters within 0.5%
  6. box + 81,920-triangle icosphere at 256x256, 4 spp, max_depth 8
  7. prints the kernels' JSON line and, last, the result JSON line
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch


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


def box_scene(res, spp, depth, icosphere=False):
    from wave_tracer_tpu_torch.scene.procedural import make_box_scene
    scene = make_box_scene(res=res, spp=spp, icosphere=icosphere)
    scene.integrator.type = "plt_path"
    scene.integrator.fsd = False
    scene.integrator.max_depth = depth
    return scene


def check_render(img, stats, shape, tag):
    check(img.shape == shape, f"{tag}: image shape {img.shape}")
    check(np.isfinite(img).all(), f"{tag}: non-finite pixels")
    check(img.mean() > 0, f"{tag}: black image")
    dc = stats["device_counters"]
    check(dc["rays_cast"] > 0 and dc["shadow_rays"] > 0,
          f"{tag}: device counters {dc}")


def check_kernels(rk, geo, N, seed):
    """K1/K2 vs their twins on N seeded random rays through `geo`."""
    T = geo.num_tris
    r = np.random.default_rng(seed)
    lo = geo.p0.min(0).values.cpu().numpy() - 0.2
    hi = geo.p0.max(0).values.cpu().numpy() + 0.2
    ro = r.uniform(lo, hi, (N, 3)).astype(np.float32)
    rd = r.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    dev = torch.device("cuda")
    ro_t, rd_t = torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev)
    tmin = torch.full((N,), 1e-4, device=dev)
    tmax = torch.full((N,), 1e30, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    print(f"phase 3: N={N} T={T}: K1 {ms_k1:.3f} ms (twin {ms_t1:.3f} ms), "
          f"K2 {ms_k2:.3f} ms (twin {ms_t2:.3f} ms)", flush=True)
    return dict(
        closest=dict(max_abs_err=err_t.max().item(), ms=ms_k1,
                     plain_ms=ms_t1, agree=frac_id),
        anyhit=dict(max_abs_err=float((ok_k != ok_r).float().max().item()),
                    ms=ms_k2, plain_ms=ms_t2, agree=frac_occ))


def compare_images(img, ref, st, st_ref, tag):
    mean, mref = img.mean((0, 1)), ref.mean((0, 1))
    rel = np.abs(mean - mref) / np.abs(mref)
    check((rel <= 0.01).all(), f"{tag}: channel means {mean} vs {mref}")
    scale = np.maximum(np.abs(ref), np.abs(ref).mean())
    frac = (np.abs(img - ref) <= 1e-3 * scale).all(-1).mean()
    check(frac >= 0.98, f"{tag}: {frac:.4f} of pixels within the bar")
    for k in ("rays_cast", "shadow_rays", "surface_interactions",
              "rr_terminations", "sum_path_depth"):
        a, b = st["device_counters"][k], st_ref["device_counters"][k]
        check(abs(a - b) <= 0.005 * max(abs(b), 1.0),
              f"{tag}: counter {k} {a} vs {b}")
    return frac


def main():
    # ---- phase 1
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from wave_tracer_tpu_torch.accel import ray_kernels as rk
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

    # ---- phase 2
    t0 = time.perf_counter()
    rk.build()
    print(f"phase 2: kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {rk.BUILD_INFO.get('seconds', 0.0):.2f} s)", flush=True)
    for line in rk.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip(), flush=True)

    # ---- phase 3: the kernels at the shapes of phases 4 and 6
    lanes4 = min(256 * 256 * 16, POOL_LANES_CUDA)
    lanes6 = min(256 * 256 * 4, POOL_LANES_CUDA)
    built = build_scene(box_scene(256, 16, 8), device="cuda")
    big = build_scene(box_scene(256, 4, 8, icosphere=True), device="cuda")
    check(built.data.geo.num_tris == 12,
          f"box has {built.data.geo.num_tris} triangles")
    check(big.data.geo.num_tris == 81932,
          f"box + icosphere has {big.data.geo.num_tris} triangles")
    ks_box = check_kernels(rk, built.data.geo, lanes4, 1234)
    kstats = check_kernels(rk, big.data.geo, lanes6, 1235)
    for k in kstats:
        kstats[k]["max_abs_err"] = max(kstats[k]["max_abs_err"],
                                       ks_box[k]["max_abs_err"])

    # ---- phase 4: the main path
    render_scene(built, spp=1, device="cuda")          # warm-up
    for k in rk.LAUNCHES:
        rk.LAUNCHES[k] = 0
    img, st = render_scene(built, device="cuda")
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES)
    check(launches["closest"] > 0 and launches["anyhit"] > 0,
          f"main path launched {launches}")
    check_render(img, st, (256, 256, 3), "phase 4")
    check(st["pool_lanes"] == lanes4, f"phase 4 pool {st['pool_lanes']}")
    print(f"phase 4: box 256x256 16 spp depth 8: "
          f"{st['paths_per_sec']:.1f} paths/s ({st['seconds']:.3f} s, "
          f"pool {st['pool_lanes']}), launches {launches}, counters "
          f"{st['device_counters']}", flush=True)

    # ---- phase 5: card vs CPU twins
    small = build_scene(box_scene(64, 4, 5), device="cuda")
    img_c, st_c = render_scene(small, device="cuda")
    img_h, st_h = render_scene(small, device="cpu")
    frac = compare_images(img_c, img_h, st_c, st_h, "phase 5")
    print(f"phase 5: 64x64 4 spp depth 5: cuda vs cpu: {frac:.4f} of "
          f"pixels within the bar", flush=True)

    # ---- phase 6: scale case
    render_scene(big, spp=1, device="cuda")            # warm-up
    before = dict(rk.LAUNCHES)
    img6, st6 = render_scene(big, device="cuda")
    torch.cuda.synchronize()
    check(all(rk.LAUNCHES[k] > before[k] for k in before),
          f"phase 6 launched {rk.LAUNCHES} after {before}")
    check_render(img6, st6, (256, 256, 3), "phase 6")
    check(st6["pool_lanes"] == lanes6, f"phase 6 pool {st6['pool_lanes']}")
    print(f"phase 6: box + icosphere ({big.data.geo.num_tris} tris) "
          f"256x256 4 spp depth 8: {st6['paths_per_sec']:.1f} paths/s "
          f"({st6['seconds']:.3f} s)", flush=True)

    # ---- phase 7
    src = "wave_tracer_tpu_torch/csrc/ray_kernels.cu"
    kernels = [
        dict(name="closest_hit", route="cuda", source=src,
             replaces="wave_tracer_tpu/accel/mxu_trace.py:155",
             launches=launches["closest"],
             max_abs_err=kstats["closest"]["max_abs_err"],
             ms=kstats["closest"]["ms"],
             plain_ms=kstats["closest"]["plain_ms"]),
        dict(name="any_hit", route="cuda", source=src,
             replaces="wave_tracer_tpu/accel/mxu_trace.py:185",
             launches=launches["anyhit"],
             max_abs_err=kstats["anyhit"]["max_abs_err"],
             ms=kstats["anyhit"]["ms"],
             plain_ms=kstats["anyhit"]["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
