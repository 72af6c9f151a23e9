"""On-card smoke test of the PyTorch/CUDA port (wave_tracer_tpu_torch).

Drives the port's main paths through the entry points a user calls
(`scene.build_scene`, `render.render_scene`, for pixel gradients
`integrator.path.trace_paths` / `integrator.plt_path.trace_paths_wave`
/ `integrator.plt_bdpt.trace_bdpt` /
`integrator.plt_path_forward.trace_forward`,
for scene files `python -m wave_tracer_tpu_torch render scene.xml`, and
across processes `parallel.dist.render_distributed` and the CLI's
`--distributed`; scenes above 2^17 triangles through the BVH route and a
city above 2048 wedge edges through the clustered edge sweep; the wave
path under each WT_CONE_QUERY mode, the threefry sampler and the
clustered ball query; the ray routes of WT_TRACE_BACKEND below 2^17
triangles, WT_COMPACT_MODE and WT_COMPACT_LANES)
on one CUDA card — the
classical plt_path renderer (fsd=False) and the wave-optical plt_path
(fsd=True: hybrid cone traversal + deferred coherent FSD), both through
the persistent compacted wavefront, plt_bdpt with Fraunhofer FSD through
its batched renderer, forward coverage, and the materials box under the
wave path and polarimetric bdpt — and holds every hand-written kernel of
those paths against its plain torch version.

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
     events after a warm-up. Then K3's winner build on the same cones:
     minima and counts bit-equal to the main build's, and minima and
     winner ids equal to the plain version's (on all lanes of the box, on
     the first 16,384 of the others); its time beside the main build's
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
 16. the materials box (make_materials_box_scene: glass and rough-
     conductor spheres, bitmap, checkerboard, composite, normal-mapped and
     masked surfaces, an area lamp and a spot light; 10,254 triangles,
     its classified edge count printed) through the wave main path at
     256x256, 8 spp, depth 8, after a warm-up; counters zeroed just
     before and read just after: K1, K2 and K3 must all have launched,
     with the checks of phase 8; its paths/s as phase 4's; then once
     more with CUDA events around every K1, K2 and K3 call (launches, ms
     per launch, needed-row share, bound)
 16b. one more render of the materials box keeping each kernel's call
     with the most needed rows (K1: of those that carry some rows), held
     against its plain version on the
     same inputs: K1's ids on >= 99.9% of the needed rows (t within rtol
     1e-4 / atol 1e-5 where they agree) and its other rows' carried hits
     bit for bit, K2's needed rows on >= 99.9% (the others False), K3's
     minima and counts bit-equal
 17. the materials box through plt_bdpt (Fraunhofer FSD) with a
     polarimetric sensor at 256x256, 4 spp, depth 8 (bench.py's bdpt
     width); counters zeroed just before and read just after: K1 and K2
     must have launched; a (256, 256, 12) film of finite values whose
     every Stokes vector is physical; its paths/s as phase 12's; then
     timed per K1/K2 call as phase 12
 18. the materials box at 32x32, 4 spp, on the card and on the CPU, at
     the bars of tests/test_torch_materials_render.py: classical (depth
     5) per pixel, the wave path (depth 5) and polarimetric bdpt (depth
     4, the intensity planes, Stokes physicality on the card)
 19. pixel gradients at full width through trace_paths_wave and
     trace_paths (`torch.autograd.forward_ad` and `.backward()`), counters
     zeroed just before each mode and read just after: K1, K2 and K3 must
     have launched under each. (a) The bench wave box (256x256 lanes, 1
     spp, depth 8, FSD on): the forward-mode pixel map w.r.t. the
     emitters' spectra scale equals the image (the image is linear in
     it) within rtol 1e-4; (b) the gradient of the image mean w.r.t.
     every spectra row by reverse mode in lane batches of GRAD_BATCH,
     the two largest against central differences (h 0.05) at rtol 0.2;
     (c) the classical box (depth 2): the forward-mode map w.r.t. a
     back-wall translation against central differences (h 5e-3), > 97%
     of pixels at rtol 0.15, atol 0.03·max|fd|. Prints each mode's
     paths/s against the plain forward's, the batch width and the peak
     memory
 20. the maps of phase 19 (spectra rows classical and wave, the wall
     translation) at 16x16, depth 3, on the card and on the CPU (plain
     versions) at the image bars: classical >= 98% of pixels within
     1e-3·max(|ref|, mean|ref|), wave Pearson >= 0.999 and >= 90% within
     1e-2·max
 21. the batched renderer (`Renderer(compact=False)`: trace_paths_wave /
     trace_paths over pixel batch × spp batch lanes) renders the wave box
     of phase 8 and the classical box of phase 4, each held against the
     pool's image at the wave and classical bars; its paths/s and
     launches
 22. scene files and the command line: the bench wave box (256x256, 8 spp,
     depth 8, FSD on) and its scale variant (+ the 81,920-triangle
     icosphere, 4 spp) written as XML by `box_scene_xml`; each file's
     `load_scene_xml` + bake equals `make_box_scene`'s bake table for
     table (the uniform spectra's grid ranges excepted; load and bake
     timed); `python -m wave_tracer_tpu_torch render box.xml -o <dir>
     --write-stats --mask` as a subprocess exits 0 and writes camera.exr,
     camera.png, camera_mask.png and perf_stats.json; its EXR against the
     in-process render_scene of the file (the same seed), developed by the
     response's develop_matrix, at the wave bars of phase 9; its mask PNG
     is the in-process mask, which is equal on the card and on the CPU;
     the mask's K1 launches timed; `cli.main` in-process on the scale file
     with its K1/K2/K3 calls captured (launches counted from zero) and the
     calls with the most needed rows held against their plain versions
     (K3 on its first 16,384 lanes); then an interrupt that terminates at
     the second poll, a resume from `last_film` / `last_spp_done` and one
     from a `.ckpt.npz` written on the card, each within 1e-4·max(|ref|,
     mean|ref|) of the uninterrupted render on every pixel. Prints the
     CLI's paths/s (its perf_stats.json) beside the in-process render's,
     with the card's name and power limit
 23. pixel gradients at full width through trace_bdpt (the bench bdpt
     box, 256x256 lanes at 1 spp, depth 8, FSD on), counters zeroed just
     before each mode and read just after (K1 and K2 must launch): (a)
     the forward-mode map w.r.t. the emitters' scale equals the developed
     image within 1e-4 of max|image| (bdpt has no roulette and
     radiance-free MIS weights); (b) the gradient of the lane sum w.r.t.
     every spectra row by reverse mode in lane batches of GRAD_BATCH, the
     two largest against central differences (h 0.05) at rtol 0.05. Prints
     each mode's paths/s against the plain forward's and the peak memory
     of a batch
 24. the same through trace_forward at 2^18 lanes, depth 4: (a) the
     coverage scene (256² elements, UTD), the forward-mode map w.r.t. the
     emitter's scale, FSD-NEE splats included, equals the image within
     1e-4 of max|image|; (b) reverse mode over every spectra row and the
     concrete row's n and κ in lane batches of COV_GRAD_BATCH: the
     emitter's row against central differences at rtol 0.05, n and κ
     against forward mode at rtol 1e-3 (their central differences are
     printed: they flip lobe picks, which carry no derivative); (c) the
     slit screen of `slit_screen_xml` (256², Fraunhofer): the map w.r.t.
     a translation of the screen along x, against central differences (h
     4 µm) on >= 95% of the pixels at rtol 0.15, atol 0.03·max|fd|, in
     lane batches of SLIT_FD_BATCH (the JAX test's density of lanes per
     pixel; the full batch's share is printed)
 25. the maps of phases 23-24 at 16x16 on the card and on the CPU (plain
     versions), at the bars of check_gradient_paths_vs_cpu
 26. geometry derivatives through K3's winners: the wave box (64x64
     lanes, 1 spp, depth 8, FSD on) through trace_paths_wave in forward
     mode w.r.t. the back wall moved along +z and the left wall slid
     along z in its own plane (a map made wholly of the winners' entry
     derivative); counters zeroed just before each and read just after:
     K1, K2 and K3 launch, every K3 launch through the winner build, as
     many as the plain forward's; paths/s beside the plain forward's.
     (a) Every cone query of those runs (the main path's own inputs, their
     tangents included) again on the CPU through the plain version, on
     the card's triangles: minima and counts bit-equal, the minima's
     tangents at phase 20's wave bars (Pearson >= 0.999, >= 90% within
     1e-2·max(|ref|, mean|ref|)) and each within 1e-5 of its own size
     plus 1e-6 of the largest. (b) The maps, card against CPU: finite,
     not zero, >= 90% of pixels within 1e-2·max(|ref|, mean|ref|); their
     Pearson correlation is printed beside the CPU's own map against
     itself with the wall moved one ulp (2^-23) either way, not held to
     0.999: the FSD phase k·(d_edge − d_direct), k ~ 1e7 per metre, is
     resolved to O(1) rad in float32, so a lane's derivative through it
     changes sign under a one-ulp change of its inputs (PERF.md §6)
 27. rendering across processes (parallel/): (a) render_distributed in
     an NCCL group of one rank, the wave box at 256x256 x 1 spp, depth 8,
     against Renderer(compact=False)'s image of the same lanes within
     1e-5 of max, paths/s of both; (b) two ranks spawned on the one card
     with gloo (and, with two cards or more, two NCCL ranks on two cards)
     render it again: each merged film within 1e-5 of max of (a)'s, each
     rank's K1/K2/K3 launches counted from zero around its render; (c)
     `python -m wave_tracer_tpu_torch render box.xml --distributed` as
     two processes (WT_DIST_BACKEND=gloo on one card): exit 0, rank 0
     alone writes, its EXR at the wave bars of phase 22's one-process
     CLI EXR, its paths/s
 28. large scenes. (a) K4 (BVH closest hit) and K5 (any hit) against
     their lock-step twins on the card, over the wave box with bench.py's
     sphere at tessellation 384 (327,692 triangles: the BVH route, its
     tree built by the C++ builder): 262,144 seeded random rays, a third
     excluding their first hit; K5 also on 262,144 and on 4,456,448 (the
     FSD-leg width) random segments with one to three exclusions; words
     bit-equal; times from CUDA events, bounds from the twins' counts of
     the nodes and triangles each ray visits. (b) The scale cell's 81,932
     triangles through the BVH (baked under WT_TRACE_BACKEND=bvh; phase
     30 renders it), against K1/K2 on
     262,144 rays and segments: ids on >= 99.9%, t within rtol 1e-4 /
     atol 1e-5 where they agree, occlusion on >= 99.9%. (c) render_scene
     of the large scene at 256x256 x 4 spp, depth 8: K4, K5 and K3 launch,
     K1/K2 do not; paths/s beside the scale cell's (phase 10); each
     kernel's ms per launch in the render; K3 on 262,144 random cones at
     327,692 triangles (bit-equal to its plain version on the first
     4,096 lanes); then the BVH route at 32x32 x 4 spp, depth 5, on the
     card and on the CPU at phase 9's wave bars, with MXU_MAX_TRIS lowered
     to 1,024 and the sphere at 1,280 triangles (the plain K3 at 327,692
     triangles would keep the CPU busy for many minutes). (d) The city
     coverage map (make_city_coverage_scene: 2,354 triangles, 2,356 wedge
     edges) at 256x256 x 8, depth 4, UTD: every edge sweep clustered, K1
     and K2 launch, K4/K5 do not; paths/s; at 32x32 x 4 on the card and on
     the CPU at phase 15's coverage bars
 29. the JAX package's other cone queries (WT_CONE_QUERY), the triangle
     clusters and the threefry sampler, with the variables set in-process
     and restored: the triangle-cluster bake's seconds at 81,932 and
     327,692 triangles; (a) tris_near_cone ("topk"),
     tris_near_cone_2pass and tris_near_cone_clustered on 4,096 seeded
     cones about the scale scene's icosphere, and tris_in_ball_clustered
     on 4,096 balls near it, CUDA-event ms per call beside K3's minima
     on the same cones; card vs the port's CPU (topk on the first 64
     cones, 2pass on 512, the others on all): slots equal on >= 99.5%, z
     within 1e-5 relative; (b) the wave box at 256x256 x 8 spp, depth 8,
     under topk, 2pass, clustered and mxu: paths/s (one render each), K3
     launched under mxu only; at 64x64 x 1 spp, depth 5, card vs CPU at
     the wave bars; (c) the scale scene at 256x256 x 1 spp, depth 8,
     under the default (K3), clustered and 2pass: paths/s; (d)
     WT_SAMPLER=uniform: 262,144 lanes' threefry keys and uniform draws
     bit-equal card vs CPU, the wave box at 32x32 x 4 spp, depth 5, card
     vs CPU at the wave bars, and at full width; (e) the bdpt box with a
     1,280-triangle icosphere at 32x32 x 4 spp, depth 5, with
     WT_TRI_CLUSTER_MIN=1024: the blocked-flux ball query takes the
     clustered index on both devices, card vs CPU at phase 13's bars.
     Launches of (b)-(e) under "launches_by_path"; readings under the K3
     row's "cone_queries"
 30. the JAX package's last switches, set in-process and restored: (a)
     the classical box + icosphere (81,932 triangles) at 256x256 x 8 spp,
     depth 8, with WT_TRACE_BACKEND unset (K1/K2, the default bake) and
     with the bake and the render under WT_TRACE_BACKEND=bvh (a BVH of the
     same triangles, K4/K5): each one's paths/s (median of three),
     launches and the CUDA-event ms per launch of every ray kernel in its
     render; the bvh image at the classical bars of phase 5 against the
     default route's render of the same bake (its triangle order sets
     the NEE draws); the bvh bake at 64x64 x 4 spp on the card and on the
     CPU (the twins) at those bars. (b) The wave scale scene at 256x256 x
     1 spp, depth 8, under bvh: K3's launches equal the default's, K4/K5
     launch as K1/K2 do by default; paths/s of both. (c) The wave box (12
     triangles) under brute at 256x256 x 8 spp, depth 8: K1, K2, K4 and
     K5 launch 0 times, K3 as in phase 8; paths/s (median of three); at
     64x64 x 1 spp, depth 5, card vs CPU at the wave bars; the same for
     the wave box with the 1,280-triangle icosphere (1,292 triangles, the
     brute queries' row slices at the FSD legs' full width: one render,
     its paths/s and peak memory). (d) WT_COMPACT_LANES=16384 on the wave
     box at 64x64 x 8 spp: the stats report 16,384 lanes, the image at
     the wave bars of the default width's (the counters a width cannot
     move). WT_COMPACT_MODE is read by no code of the port (one driver
     for both values), so no phase renders under it. Launches under
     "launches_by_path" ("route_*", "compact_*"); readings under the K4
     row's "route_switch"
 11. (last) prints the kernels' JSON line (each kernel's launches on the
     wave main path, per path under "launches_by_path" (the gradient
     modes of phases 19, 23 and 24, the batched renders of phase 21 and
     cli_wave_scale and cli_mask of phase 22 included), phase 22's
     readings under "cli", the gradient phases' readings under
     "gradients" of the K1 row
     of the K1 row, and K1's and K2's timings in the bdpt, coverage and
     materials renders under "in_bdpt_render", "in_coverage_render",
     "in_materials_render" and "in_materials_bdpt_render", and the
     materials calls' agreement with the plain versions under
     "materials_call_vs_plain"; the K3 row's winner build ms, its
     launches in phase 26 and phases 26-27's readings; the launches of
     phases 26-28 under "launches_by_path"; K3 at 327,692 triangles under
     "at_327692_tris"; rows for K4 and K5, whose "launches" are the large
     scene's, with phase 28's readings and phase 30's under
     "route_switch"; the script fails if K4 or K5 launched on any path
     below 2^17 triangles but phase 30's bvh override paths, by name)
     and, last, the result JSON line

Each paths/s reading (phases 4, 6, 8, 10 and 16, and 12, 14 and 17 where
a render takes under 30 s) is the median of three renders, the one whose launches
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


def box_scene(res, spp, depth, icosphere=False, fsd=False,
              tessellation=192):
    from wave_tracer_tpu_torch.scene.procedural import make_box_scene
    scene = make_box_scene(res=res, spp=spp, icosphere=icosphere,
                           tessellation=tessellation)
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
    lanes = None if T <= 12 else REF_CHUNK
    ms_w, share_w = cone_winners(ck, geo, args, f"T={T}", lanes)
    print(f"phase 7: N={N} T={T} random cones: K3 bit-equal to its plain "
          f"version, mean count {mean_cnt:.2f}, finite minima {fin:.3f}; "
          f"{cull_line(cull, N, T, kept)}", flush=True)
    print(f"phase 7: N={N} T={T}: K3 {ms:.3f} ms (plain {ms_plain:.3f} ms, "
          f"lane chunks of {REF_CHUNK}), bound {b[0]:.3f} ms ({b[1]}); the "
          f"winner build {ms_w:.3f} ms, its minima bit-equal and its ids "
          f"equal to the plain version's on "
          f"{'all' if lanes is None else f'the first {lanes}'} lanes "
          f"({share_w:.3f} of the minima have one)", flush=True)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=ms_plain, bound=b,
                winner_ms=ms_w)


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
    ms_w, share_w = cone_winners(ck, geo, args, f"T={T} narrow cones",
                                 REF_CHUNK)
    print(f"phase 7: N={N} T={T} narrow render-like cones: K3 bit-equal to "
          f"its plain version on the first {REF_CHUNK} lanes, mean count "
          f"{mean_cnt:.2f}, finite minima {fin:.3f}; "
          f"{cull_line(cull, N, T, kept)}; K3 {ms:.3f} ms (plain "
          f"{ms_plain:.3f} ms on {REF_CHUNK} lanes), bound {b[0]:.3f} ms "
          f"({b[1]}); the winner build {ms_w:.3f} ms, ids equal to the "
          f"plain version's on the first {REF_CHUNK} lanes ({share_w:.3f} "
          f"of the minima have one)", flush=True)
    return dict(ms=ms, plain_ms_subset=ms_plain, bound_ms=b[0],
                bound_by=b[1], pairs_culled=1 - entered / (N * T),
                winner_ms=ms_w)


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


def materials_scene(res, spp, depth, integrator="plt_path",
                    polarimetric=False):
    from wave_tracer_tpu_torch.scene.procedural import \
        make_materials_box_scene
    scene = make_materials_box_scene(res=res, spp=spp)
    scene.integrator.type = integrator
    scene.integrator.fsd = True
    scene.integrator.max_depth = depth
    scene.sensors[0].polarimetric = polarimetric
    return scene


def check_stokes(img, tag):
    """Every pixel's Stokes vector is physical: |(Q, U, V)| <= I (to
    rounding), and some light is polarized."""
    s = img.reshape(img.shape[0], img.shape[1], -1, 4)
    pol = np.linalg.norm(s[..., 1:], axis=-1)
    excess = (pol - s[..., 0] * (1 + 1e-5)).max() / s[..., 0].max()
    check(excess <= 1e-6, f"{tag}: unphysical Stokes vectors ({excess})")
    check(pol.max() > 0, f"{tag}: no polarized light")
    return float((pol.sum() / s[..., 0].sum()))


def capture_calls(rk, ck, run, phase="phase 16b"):
    """`run()` (a render on the card), keeping per kernel (closest,
    anyhit, cone_minz) a copy of the arguments and the result of its call
    with the most needed rows (K1: of those that carry some rows, if
    any)."""
    real = {"closest": rk.closest_hit, "anyhit": rk.any_hit,
            "cone_minz": ck.cone_minz}
    best = {}

    def copy(x):
        if torch.is_tensor(x):
            return x.clone()
        if isinstance(x, tuple):
            return tuple(copy(y) for y in x)
        return x

    def spy(kind):
        fn = real[kind]

        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            if kind == "cone_minz":
                n = args[1].shape[0]
                score = (True, n)
            else:
                need = args[7] if len(args) > 7 else kw.get("need")
                n = args[2].shape[0] if need is None else int(need.sum())
                # K1: a call that carries some rows first, so that the
                # carry is held too
                score = (kind == "anyhit" or n < args[2].shape[0], n)
            if score > best.get(kind, {"score": (False, -1)})["score"]:
                best[kind] = dict(n=n, score=score, args=copy(args),
                                  out=copy(out),
                                  kw={k: copy(v) for k, v in kw.items()})
            return out
        return wrapper

    rk.closest_hit, rk.any_hit = spy("closest"), spy("anyhit")
    ck.cone_minz = spy("cone_minz")
    try:
        run()
    finally:
        rk.closest_hit, rk.any_hit = real["closest"], real["anyhit"]
        ck.cone_minz = real["cone_minz"]
    torch.cuda.synchronize()
    for kind in real:
        check(best.get(kind, {"n": 0})["n"] > 0,
              f"{phase}: no {kind} call with a needed row")
    return best


def check_calls_vs_plain(rk, ck, cap, phase="phase 16b", k3_lanes=None):
    """Each kernel's captured render call against its plain version on
    the same inputs, at the bars of phases 3, 3b and 7: K1's ids agree on
    >= 99.9% of the needed rows and t within rtol 1e-4 / atol 1e-5 where
    they agree, the other rows hold their carried hit bit for bit; K2's
    needed rows agree on >= 99.9% and the others are False; K3's minima
    and counts are bit-equal (over its first `k3_lanes` lanes if given).
    Returns per kernel (rows, needed rows, share of needed rows that
    disagree)."""
    out = {}
    c = cap["closest"]
    args, kw = c["args"], c["kw"]
    need = args[7] if len(args) > 7 else kw.get("need")
    carry = args[8] if len(args) > 8 else kw.get("carry")
    t_k, i_k = c["out"]
    t_r, i_r = rk._closest_ref(*args[:7], need, carry)
    rows = torch.ones_like(i_k, dtype=torch.bool) if need is None else need
    agree = (i_k == i_r)[rows].float().mean().item()
    check(agree >= 0.999, f"{phase}: K1 ids agree on {agree:.6f}")
    both = rows & (i_k == i_r) & (i_r >= 0)
    check(bool(((t_k - t_r).abs() <= 1e-5 + 1e-4 * t_r.abs())[both].all()),
          f"{phase}: K1 t beyond rtol 1e-4 / atol 1e-5")
    if need is not None and carry is not None:
        check(torch.equal(t_k[~need], carry[0][~need])
              and torch.equal(i_k[~need], carry[1][~need]),
              f"{phase}: K1 rows off the need mask lost their carried hit")
    out["closest"] = (i_k.shape[0], int(rows.sum()), 1.0 - agree)
    c = cap["anyhit"]
    args, kw = c["args"], c["kw"]
    need = args[7] if len(args) > 7 else kw.get("need")
    occ_r = anyhit_ref_chunked(rk, args[:7], need)
    rows = torch.ones_like(occ_r) if need is None else need
    agree = (c["out"] == occ_r)[rows].float().mean().item()
    check(agree >= 0.999, f"{phase}: K2 needed rows agree on {agree:.6f}")
    if need is not None:
        check(not c["out"][~need].any().item(),
              f"{phase}: K2 occluded a row off its need mask")
    out["anyhit"] = (occ_r.shape[0], int(rows.sum()), 1.0 - agree)
    c = cap["cone_minz"]
    zr, cr = minz_ref_chunked(ck, c["args"], k3_lanes)
    n3 = cr.shape[0]
    check(torch.equal(c["out"][0][:n3], zr)
          and torch.equal(c["out"][1][:n3], cr),
          f"{phase}: K3 not bit-equal to its plain version")
    out["cone_minz"] = (c["out"][1].shape[0], n3, 0.0)
    for kind, (n, n_need, bad) in out.items():
        print(f"{phase}: {kind}: the render's call of {n_need} needed "
              f"rows of {n} against its plain version: "
              f"{'bit-equal' if kind == 'cone_minz' else f'disagree on {bad:.6f} of the needed rows'}",
              flush=True)
    return out

GRAD_BATCH = 1 << 14        # lanes per reverse-mode batch (phase 19b)


def grad_lanes(res, dev):
    """One lane per pixel of a res² film at sample 0, jittered as the
    renderers jitter it: (pixel_xy, jitter, sample ids)."""
    from wave_tracer_tpu_torch.sampling import rng
    pix = torch.arange(res * res, device=dev)
    sid = torch.zeros_like(pix)
    jit = rng.uniform(rng.sample_key(0, pix, sid), rng.D_PIXEL_JITTER, 2)
    return torch.stack([pix % res, pix // res], -1), jit, sid


def scaled_rows(data, rs):
    """data with every spectra row i scaled by rs[i]."""
    import dataclasses
    st = data.tables.spectra
    return dataclasses.replace(data, tables=dataclasses.replace(
        data.tables, spectra=dataclasses.replace(
            st, vals=st.vals * rs[:, None])))


def translated(data, shape_id, delta):
    """data with one shape moved rigidly by delta (3,): p0 and the packed
    tri_geom rows, as the JAX package's gradient tests move a wall."""
    import dataclasses
    mask = (data.geo.tri_attr[:, 22] == shape_id).float()[:, None]
    d3 = mask * delta[None, :]
    geo = dataclasses.replace(
        data.geo, p0=data.geo.p0 + d3,
        tri_geom=data.geo.tri_geom + torch.nn.functional.pad(d3, (0, 9)))
    return dataclasses.replace(data, geo=geo)


def path_values(data, sensor, lanes, wave, depth, sl=slice(None)):
    """The (lanes, C) values of trace_paths_wave (wave) or trace_paths over
    the lanes `sl` of `lanes` (pixel_xy, jitter, sample ids), seed 0."""
    from wave_tracer_tpu_torch.integrator.path import trace_paths
    from wave_tracer_tpu_torch.integrator.plt_path import trace_paths_wave
    pxy, jit, sid = (x[sl] for x in lanes)
    if wave:
        return trace_paths_wave(data, pxy, jit, 0, sid, sensor=sensor,
                                edge_table=data.edges, max_depth=depth,
                                eps=1e-4)[1]
    return trace_paths(data, pxy, jit, 0, sid, sensor=sensor,
                       max_depth=depth, eps=1e-4)[1]


def forward_map(f, x, dx):
    """(f(x), the forward-mode derivative of f along dx)."""
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        primal, tangent = fwAD.unpack_dual(f(fwAD.make_dual(x, dx)))
    return primal, tangent


def synced(fn):
    """(fn(), its wall seconds with the card's queue drained on both
    sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def emitter_mask(data):
    S = data.tables.spectra.vals.shape[0]
    mask = torch.zeros(S, device=data.tables.spectra.vals.device)
    ids = data.emitters.spec_id
    mask[ids[ids >= 0].long()] = 1.0
    check(bool(mask.any()), "no emitter spectra rows")
    return mask


def fd_share(g, fd, rtol, atol_frac):
    """Share of entries where AD matches central differences (np.isclose,
    atol a fraction of max|fd|)."""
    scale = max(float(np.abs(fd).max()), 1e-30)
    return float(np.isclose(g, fd, rtol=rtol, atol=atol_frac * scale).mean())


def image_bars(a, ref, wave):
    """Classical: the share of pixels within 1e-3·max(|ref|, mean|ref|);
    wave: (Pearson, the share within 1e-2·max(|ref|, mean|ref|))."""
    scale = np.maximum(np.abs(ref), np.abs(ref).mean())
    share = float((np.abs(a - ref) <= (1e-2 if wave else 1e-3) * scale)
                  .all(-1).mean())
    if not wave:
        return share
    return float(np.corrcoef(a.ravel(), ref.ravel())[0, 1]), share


def check_gradients_full(rk, ck, built_wave, built_classical):
    """Phase 19: both AD modes at full width on the card, through
    trace_paths_wave (the bench wave box, 256² lanes at 1 spp, depth 8)
    and trace_paths (the classical box, depth 2). Returns ({mode: K1/K2/K3
    launches}, printed summary dict)."""
    out, launches = {}, {}
    data = built_wave.data
    sensor = built_wave.scene.sensors[0]
    dev = data.geo.p0.device
    lanes = grad_lanes(sensor.width, dev)
    N = lanes[0].shape[0]
    S = data.tables.spectra.vals.shape[0]
    ones = torch.ones(S, device=dev)
    mask = emitter_mask(data)

    def wave_values(rs, sl=slice(None)):
        return path_values(scaled_rows(data, rs), sensor, lanes, True, 8, sl)

    # warm-ups: each mode's first call pays one-time host costs (forward
    # mode's first call takes seconds)
    warm = slice(0, 4096)
    with torch.no_grad():
        wave_values(ones, warm)
    forward_map(lambda th: wave_values(1.0 + mask * (th - 1.0), warm),
                ones[0], ones[0])
    wave_values(ones.clone().requires_grad_(), warm).sum().backward()
    with torch.no_grad():
        img, dt_plain = synced(lambda: wave_values(ones))
    out["plain_paths_per_sec"] = N / dt_plain
    # (a) forward mode w.r.t. the emitters' scale: linear, so map == image
    zero_counts()
    (p, g), dt = synced(lambda: forward_map(
        lambda th: wave_values(1.0 + mask * (th - 1.0)),
        torch.tensor(1.0, device=dev), torch.tensor(1.0, device=dev)))
    launches["gradient_wave_forward"] = launch_counts()
    check(each_launched(launches["gradient_wave_forward"]),
          f"phase 19a launched {launches['gradient_wave_forward']}")
    check(torch.isfinite(g).all() and torch.allclose(p, img, rtol=1e-5,
                                                     atol=0.0),
          "phase 19a: non-finite map, or the primal is not the image")
    err = float((g - img).abs().max())
    tol = 1e-4 * float(img.abs().max())
    check(torch.allclose(g, img, rtol=1e-4, atol=tol),
          f"phase 19a: emitter-scale map vs image, max |diff| {err:.3e}")
    out["forward_paths_per_sec"] = N / dt
    out["forward_map_vs_image_max_abs"] = err
    res = sensor.width
    print(f"phase 19a: wave box {res}x{res} 1 spp depth 8, forward mode "
          f"w.r.t. the emitters' scale: map == image within {err:.3e} (max "
          f"|image| {float(img.abs().max()):.3e}); {N / dt:.1f} fwd+tangent "
          f"paths/s ({dt:.3f} s) against {N / dt_plain:.1f} plain; "
          f"launches {launches['gradient_wave_forward']}", flush=True)
    # (b) reverse mode: d mean(image) / d(row scale), every row, in lane
    # batches (the loss is a sum over lanes)
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    rs = torch.ones(S, device=dev, requires_grad=True)

    def reverse():
        for b in range(0, N, GRAD_BATCH):
            (wave_values(rs, slice(b, b + GRAD_BATCH)).sum()
             / (N * img.shape[1])).backward()
        return rs.grad

    grad, dt = synced(reverse)
    peak = torch.cuda.max_memory_allocated(dev)
    launches["gradient_wave_reverse"] = launch_counts()
    check(each_launched(launches["gradient_wave_reverse"]),
          f"phase 19b launched {launches['gradient_wave_reverse']}")
    check(torch.isfinite(grad).all(), f"phase 19b: gradient {grad}")
    h = 0.05
    rows = grad.abs().argsort(descending=True)[:2].tolist()
    fds = []
    with torch.no_grad():
        for r in rows:
            e = torch.zeros(S, device=dev)
            e[r] = h
            fds.append(float(wave_values(ones + e).mean()
                             - wave_values(ones - e).mean()) / (2 * h))
    for r, fd in zip(rows, fds):
        check(abs(float(grad[r]) - fd) <= 0.2 * abs(fd),
              f"phase 19b: row {r}: AD {float(grad[r]):.6e} vs FD {fd:.6e}")
    out.update(reverse_paths_per_sec=N / dt, batch=GRAD_BATCH,
               peak_gib=peak / 2**30, rows=rows,
               ad=[float(grad[r]) for r in rows], fd=fds)
    print(f"phase 19b: reverse mode, d mean / d(row scale) for {S} rows in "
          f"lane batches of {GRAD_BATCH}: {N / dt:.1f} fwd+bwd paths/s "
          f"({dt:.3f} s), peak memory {peak / 2**30:.2f} GiB; rows {rows}: "
          f"AD {[f'{float(grad[r]):.6e}' for r in rows]} vs central "
          f"differences {[f'{x:.6e}' for x in fds]}; launches "
          f"{launches['gradient_wave_reverse']}", flush=True)
    # (c) the classical box, depth 2: a back-wall translation along +z
    cdata = built_classical.data
    csensor = built_classical.scene.sensors[0]
    zhat = torch.tensor([0.0, 0.0, 1.0], device=dev)

    def wall(th):
        return path_values(translated(cdata, 2, th * zhat), csensor, lanes,
                           False, 2)

    zero_counts()
    (_, g), dt = synced(lambda: forward_map(
        wall, torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev)))
    launches["gradient_classical_forward"] = launch_counts()
    with torch.no_grad():
        _, dt_wall = synced(lambda: wall(torch.tensor(0.0, device=dev)))
    check(launches["gradient_classical_forward"]["closest"] > 0
          and launches["gradient_classical_forward"]["anyhit"] > 0,
          f"phase 19c launched {launches['gradient_classical_forward']}")
    h = 5e-3
    with torch.no_grad():
        fd = ((wall(torch.tensor(h, device=dev))
               - wall(torch.tensor(-h, device=dev))) / (2 * h)).cpu().numpy()
    g = g.cpu().numpy()
    check(np.isfinite(g).all() and (g != 0).any(), "phase 19c: map")
    share = fd_share(g, fd, 0.15, 0.03)
    check(share > 0.97, f"phase 19c: {share:.4f} of pixels match FD")
    out.update(wall_forward_paths_per_sec=N / dt,
               wall_plain_paths_per_sec=N / dt_wall, wall_fd_share=share)
    print(f"phase 19c: classical box {res}x{res} 1 spp depth 2, forward mode "
          f"w.r.t. a back-wall translation: {share:.4f} of pixels match "
          f"central differences (rtol 0.15, atol 0.03 max|fd|); "
          f"{N / dt:.1f} fwd+tangent paths/s against {N / dt_wall:.1f} "
          f"plain; launches "
          f"{launches['gradient_classical_forward']}", flush=True)
    return launches, out


def check_gradients_vs_cpu(build_scene, card="cuda"):
    """Phase 20: the gradient maps of phase 19 at 16x16, depth 3, on the
    card and on the CPU (plain versions), at the image bars."""
    maps = {}
    for dev in (torch.device(card), torch.device("cpu")):
        built = build_scene(box_scene(16, 1, 3, fsd=True), device=dev)
        data, sensor = built.data, built.scene.sensors[0]
        lanes = grad_lanes(16, dev)
        S = data.tables.spectra.vals.shape[0]
        one = torch.tensor(1.0, device=dev)
        m = {}
        for wave in (False, True):
            m["wave" if wave else "classical"] = forward_map(
                lambda th: path_values(scaled_rows(
                    data, torch.ones(S, device=dev) * th), sensor, lanes,
                    wave, 3), one, one)[1]
        m["wall"] = forward_map(lambda th: path_values(translated(
            data, 2, th * torch.tensor([0.0, 0.0, 1.0], device=dev)),
            sensor, lanes, False, 3), one * 0, one)[1]
        maps[dev.type] = {k: v.cpu().numpy() for k, v in m.items()}
    res = {}
    for k in ("classical", "wall", "wave"):
        a, b = maps[torch.device(card).type][k], maps["cpu"][k]
        check(np.isfinite(a).all() and (a != 0).any(), f"phase 20 {k}: map")
        res[k] = image_bars(a, b, k == "wave")
        if k == "wave":
            check(res[k][0] >= 0.999 and res[k][1] >= 0.90,
                  f"phase 20 {k}: Pearson, share {res[k]}")
        else:
            check(res[k] >= 0.98, f"phase 20 {k}: share {res[k]:.4f}")
    print(f"phase 20: 16x16 depth 3 gradient maps, cuda vs cpu: spectra "
          f"rows classical {res['classical']:.4f} of pixels within 1e-3, "
          f"wall translation {res['wall']:.4f}, wave Pearson "
          f"{res['wave'][0]:.6f} and {res['wave'][1]:.4f} within 1e-2",
          flush=True)
    return res


# ---- phases 23-25: pixel gradients through plt_bdpt and forward transport

def bdpt_outputs(data, sensor, lanes, depth, sl=slice(None)):
    """trace_bdpt (FSD on, seed 0) over the lanes `sl` of `lanes`: (pos,
    camera values, ok, (light-splat pos, values, ok))."""
    from wave_tracer_tpu_torch.integrator.plt_bdpt import trace_bdpt
    pxy, jit, sid = (x[sl] for x in lanes)
    return trace_bdpt(data, pxy, jit, 0, sid, sensor=sensor,
                      max_depth=depth, eps=1e-4, fsd=True)


def bdpt_image(out, sensor):
    """The developed film of one bdpt batch: camera splats and light
    splats, as the JAX package's TestBdptGradients splats them."""
    from wave_tracer_tpu_torch.sensor import film as film_mod
    pos, values, ok, (lp, lv, lo) = out
    film = film_mod.make_film(sensor.width, sensor.height, values.shape[-1],
                              sensor.rfilter_sigma, device=values.device)
    film_mod.splat(film, pos, values, ok)
    film_mod.splat_direct(film, lp, lv, lo)
    return film_mod.develop(film, 1.0)


def bdpt_lane_sum(out):
    """Σ of every lane's camera value and live light splat: a sum over
    lanes, so lane batches add up (the developed film is not: its filter
    weights normalize across neighbouring lanes)."""
    _, values, _, (_, lv, lo) = out
    return values.sum() + torch.where(lo[:, None], lv, 0.0).sum()


def forward_params(data, p):
    """data with spectra row i scaled by p[i] and the complex-IOR row's n
    and κ by p[S] and p[S + 1] (the coverage scene's one ITU concrete
    row)."""
    import dataclasses
    S = data.tables.spectra.vals.shape[0]
    st, cs = data.tables.spectra, data.tables.cspectra
    return dataclasses.replace(data, tables=dataclasses.replace(
        data.tables,
        spectra=dataclasses.replace(st, vals=st.vals * p[:S, None]),
        cspectra=dataclasses.replace(cs, n=cs.n * p[S],
                                     kappa=cs.kappa * p[S + 1])))


def forward_outputs(data, sensor, ids, fsd_mode, eps=1e-4):
    """trace_forward over the lane ids `ids` (sample 0, seed 0, depth 4)."""
    from wave_tracer_tpu_torch.integrator.plt_path_forward import \
        trace_forward
    return trace_forward(data, ids, 0, torch.zeros_like(ids), sensor=sensor,
                         edge_table=data.edges, max_depth=4, eps=eps,
                         fsd_mode=fsd_mode)


def forward_image(out, sensor, nee=True):
    """The developed film of one forward batch: the first crossings'
    Gaussian splats and (nee) the FSD-NEE point splats."""
    from wave_tracer_tpu_torch.sensor import film as film_mod
    pos, values, ok, sig, (npos, nval, nok) = out
    film = film_mod.make_film(sensor.width, sensor.height, values.shape[-1],
                              sensor.rfilter_sigma, device=values.device)
    film_mod.splat_direct_gaussian(film, pos, sig, values, ok)
    if nee:
        film_mod.splat_direct(film, npos, nval, nok)
    return film_mod.develop(film, 1.0)


def crossing_sum(out):
    """Σ over lanes of the recorded first crossings (no FSD-NEE splats)."""
    return torch.where(out[2][:, None], out[1], 0.0).sum()


def slit_shift(data, theta, ids=(0, 1, 2)):
    """data with the slit screen's strips (shape ids) moved along x by θ:
    the triangles (p0, e1, e2, tri_geom) and their edges (p0, p1, center),
    through dataclasses.replace (the kernel and packed tables are derived
    anew), as the JAX package's TestApertureGeometryGradients moves it."""
    import dataclasses
    geo, ed = data.geo, data.edges
    sid = geo.tri_attr[:, 22]
    tmask = torch.stack([sid == s for s in ids]).any(0).float()
    esid = sid[ed.tri1.clamp_min(0).long()]
    emask = (torch.stack([esid == s for s in ids]).any(0)
             & (ed.tri1 >= 0)).float()
    xhat = torch.tensor([1.0, 0.0, 0.0], device=sid.device)
    dt = (theta * tmask)[:, None] * xhat
    de = (theta * emask)[:, None] * xhat
    geo = dataclasses.replace(
        geo, p0=geo.p0 + dt,
        tri_geom=geo.tri_geom + torch.nn.functional.pad(dt, (0, 9)))
    ed = dataclasses.replace(ed, p0=ed.p0 + de, p1=ed.p1 + de,
                             center=ed.center + de)
    return dataclasses.replace(data, geo=geo, edges=ed)


def slit_built(res, build_scene, device):
    """The double slit of scene/procedural.py::slit_screen_xml through the
    scene loader and the bake."""
    import os
    import tempfile
    from wave_tracer_tpu_torch.scene.procedural import slit_screen_xml
    from wave_tracer_tpu_torch.scene.xml import load_scene_xml
    fd, path = tempfile.mkstemp(suffix=".xml", dir=os.getcwd())
    try:
        with os.fdopen(fd, "w") as f:
            f.write(slit_screen_xml(res, 1, 4))
        scene = load_scene_xml(path)
    finally:
        os.remove(path)
    return build_scene(scene, device=device)


def check_gradients_bdpt(rk, ck, built):
    """Phase 23: both AD modes at full width through trace_bdpt (the bench
    bdpt box, 256² lanes at 1 spp, depth 8, FSD on). Returns ({mode:
    launches}, summary dict)."""
    launches, out = {}, {}
    data, sensor = built.data, built.scene.sensors[0]
    dev = data.geo.p0.device
    lanes = grad_lanes(sensor.width, dev)
    N = lanes[0].shape[0]
    S = data.tables.spectra.vals.shape[0]
    ones = torch.ones(S, device=dev)
    mask = emitter_mask(data)

    def run(rs, sl=slice(None)):
        return bdpt_outputs(scaled_rows(data, rs), sensor, lanes, 8, sl)

    warm = slice(0, 4096)
    with torch.no_grad():
        run(ones, warm)
    forward_map(lambda th: bdpt_lane_sum(run(1.0 + mask * (th - 1.0), warm)),
                ones[0], ones[0])
    bdpt_lane_sum(run(ones.clone().requires_grad_(), warm)).backward()
    with torch.no_grad():
        img, dt_plain = synced(lambda: bdpt_image(run(ones), sensor))
    # (a) forward mode w.r.t. the emitters' scale: bdpt has no roulette and
    # its MIS weights are radiance-free, so map == image
    zero_counts()
    (p, g), dt = synced(lambda: forward_map(
        lambda th: bdpt_image(run(1.0 + mask * (th - 1.0)), sensor),
        torch.tensor(1.0, device=dev), torch.tensor(1.0, device=dev)))
    launches["gradient_bdpt_forward"] = launch_counts()
    check(launches["gradient_bdpt_forward"]["closest"] > 0
          and launches["gradient_bdpt_forward"]["anyhit"] > 0,
          f"phase 23a launched {launches['gradient_bdpt_forward']}")
    scale = float(img.abs().max())
    err = float((g - img).abs().max()) / scale
    check(torch.isfinite(g).all() and torch.allclose(
        p, img, rtol=1e-5, atol=1e-6 * scale),
        "phase 23a: non-finite map, or the primal is not the image")
    check(err <= 1e-4, f"phase 23a: max |map - image| / max|image| {err:.3e}")
    out.update(plain_paths_per_sec=N / dt_plain,
               forward_paths_per_sec=N / dt, map_vs_image_rel=err)
    print(f"phase 23a: bdpt box {sensor.width}x{sensor.height} 1 spp depth "
          f"8 FSD on, forward mode w.r.t. the emitters' scale: max |map - "
          f"image| / max|image| {err:.3e}; {N / dt:.1f} fwd+tangent paths/s "
          f"({dt:.3f} s) against {N / dt_plain:.1f} plain ({dt_plain:.3f} "
          f"s); launches {launches['gradient_bdpt_forward']}", flush=True)
    # (b) reverse mode: d(lane sum / N) / d(row scale), every row, in lane
    # batches of GRAD_BATCH
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    rs = torch.ones(S, device=dev, requires_grad=True)

    def reverse():
        for b in range(0, N, GRAD_BATCH):
            (bdpt_lane_sum(run(rs, slice(b, b + GRAD_BATCH))) / N).backward()
        return rs.grad

    grad, dt = synced(reverse)
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    launches["gradient_bdpt_reverse"] = launch_counts()
    check(launches["gradient_bdpt_reverse"]["closest"] > 0
          and launches["gradient_bdpt_reverse"]["anyhit"] > 0,
          f"phase 23b launched {launches['gradient_bdpt_reverse']}")
    check(torch.isfinite(grad).all(), f"phase 23b: gradient {grad}")
    h = 0.05
    rows = grad.abs().argsort(descending=True)[:2].tolist()
    fds = []
    with torch.no_grad():
        for r in rows:
            e = torch.zeros(S, device=dev)
            e[r] = h
            fds.append(float(bdpt_lane_sum(run(ones + e))
                             - bdpt_lane_sum(run(ones - e))) / (2 * h * N))
    for r, fd in zip(rows, fds):
        check(abs(float(grad[r]) - fd) <= 0.05 * abs(fd),
              f"phase 23b: row {r}: AD {float(grad[r]):.6e} vs FD {fd:.6e}")
    out.update(reverse_paths_per_sec=N / dt, batch=GRAD_BATCH,
               batch_peak_gib=peak, rows=rows,
               ad=[float(grad[r]) for r in rows], fd=fds)
    print(f"phase 23b: reverse mode, d(lane sum / N) / d(row scale) for {S} "
          f"rows in lane batches of {GRAD_BATCH}: {N / dt:.1f} fwd+bwd "
          f"paths/s ({dt:.3f} s), peak memory of a batch {peak:.2f} GiB; "
          f"rows {rows}: AD {[f'{float(grad[r]):.6e}' for r in rows]} vs "
          f"central differences {[f'{x:.6e}' for x in fds]} (rtol 0.05); "
          f"launches {launches['gradient_bdpt_reverse']}", flush=True)
    return launches, out


COV_GRAD_BATCH = 1 << 16    # lanes per reverse-mode batch (phase 24b)
SLIT_FD_BATCH = 1 << 14     # lanes per map held against FD (phase 24c)


def check_gradients_forward(rk, ck, built_cov, built_slits, N=1 << 18):
    """Phase 24: forward transport at full width: the coverage scene (256²
    elements, N = 2^18 lanes, depth 4, UTD) in both AD modes, and the slit
    screen (256², N lanes, depth 4, Fraunhofer) w.r.t. a translation of
    the screen. Returns ({mode: launches}, summary dict)."""
    launches, out = {}, {}
    data, sensor = built_cov.data, built_cov.scene.sensors[0]
    dev = data.geo.p0.device
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    S = data.tables.spectra.vals.shape[0]
    P = S + 2
    ones = torch.ones(P, device=dev)
    emit = torch.cat([emitter_mask(data), torch.zeros(2, device=dev)])

    def run(p, sl=slice(None)):
        return forward_outputs(forward_params(data, p), sensor, ids[sl],
                               "utd")

    warm = slice(0, 4096)
    with torch.no_grad():
        run(ones, warm)
    forward_map(lambda th: crossing_sum(run(1.0 + emit * (th - 1.0), warm)),
                ones[0], ones[0])
    crossing_sum(run(ones.clone().requires_grad_(), warm)).backward()
    with torch.no_grad():
        img, dt_plain = synced(lambda: forward_image(run(ones), sensor))
    # (a) forward mode w.r.t. the emitter's scale, FSD-NEE splats included:
    # the carry's roulette ratio and the coherent sums are radiance-free,
    # so map == image
    zero_counts()
    (p, g), dt = synced(lambda: forward_map(
        lambda th: forward_image(run(1.0 + emit * (th - 1.0)), sensor),
        torch.tensor(1.0, device=dev), torch.tensor(1.0, device=dev)))
    launches["gradient_coverage_forward"] = launch_counts()
    check(launches["gradient_coverage_forward"]["closest"] > 0
          and launches["gradient_coverage_forward"]["anyhit"] > 0,
          f"phase 24a launched {launches['gradient_coverage_forward']}")
    scale = float(img.abs().max())
    err = float((g - img).abs().max()) / scale
    check(torch.isfinite(g).all() and torch.allclose(
        p, img, rtol=1e-5, atol=1e-6 * scale),
        "phase 24a: non-finite map, or the primal is not the image")
    check(err <= 1e-4, f"phase 24a: max |map - image| / max|image| {err:.3e}")
    out.update(plain_paths_per_sec=N / dt_plain,
               forward_paths_per_sec=N / dt, map_vs_image_rel=err)
    print(f"phase 24a: coverage {sensor.width}x{sensor.height}, {N} lanes, "
          f"depth 4, UTD, forward mode w.r.t. the emitter's scale: max |map "
          f"- image| / max|image| {err:.3e}; {N / dt:.1f} fwd+tangent paths/s "
          f"({dt:.3f} s) against {N / dt_plain:.1f} plain; launches "
          f"{launches['gradient_coverage_forward']}", flush=True)
    # (b) reverse mode: d(crossing sum / N) / d(scale) of every parameter
    # (the spectra rows, the concrete row's n and κ), in lane batches
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    pr = torch.ones(P, device=dev, requires_grad=True)

    def reverse():
        for b in range(0, N, COV_GRAD_BATCH):
            (crossing_sum(run(pr, slice(b, b + COV_GRAD_BATCH)))
             / N).backward()
        return pr.grad

    grad, dt = synced(reverse)
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    launches["gradient_coverage_reverse"] = launch_counts()
    check(launches["gradient_coverage_reverse"]["closest"] > 0
          and launches["gradient_coverage_reverse"]["anyhit"] > 0,
          f"phase 24b launched {launches['gradient_coverage_reverse']}")
    check(torch.isfinite(grad).all(), f"phase 24b: gradient {grad}")
    # the emitter's row: the crossings are linear in it, so central
    # differences are its oracle (rtol 0.05); n and κ move the SPM lobe
    # picks (u < α(θ)), which carry no derivative (the sampled lobe and
    # direction are detached, as in JAX), so central differences are no
    # oracle there: each is held against forward mode along it (rtol
    # 1e-3), and its central difference is printed
    h = 0.05
    er = int(emit.argmax())
    fds = []
    with torch.no_grad():
        for r in (er, S, S + 1):
            e = torch.zeros(P, device=dev)
            e[r] = h
            fds.append(float(crossing_sum(run(ones + e))
                             - crossing_sum(run(ones - e))) / (2 * h * N))
    check(abs(float(grad[er]) - fds[0]) <= 0.05 * abs(fds[0]),
          f"phase 24b: emitter row: AD {float(grad[er]):.6e} vs FD "
          f"{fds[0]:.6e}")
    fwd = []
    for r in (S, S + 1):
        e = torch.zeros(P, device=dev)
        e[r] = 1.0
        fwd.append(float(forward_map(lambda x: crossing_sum(run(x)) / N,
                                     ones, e)[1]))
        check(abs(float(grad[r]) - fwd[-1]) <= 1e-3 * abs(fwd[-1]),
              f"phase 24b: row {r}: reverse {float(grad[r]):.6e} vs "
              f"forward {fwd[-1]:.6e}")
    out.update(reverse_paths_per_sec=N / dt, batch=COV_GRAD_BATCH,
               batch_peak_gib=peak,
               reverse=[float(grad[r]) for r in (er, S, S + 1)],
               forward_n_kappa=fwd, fd=fds)
    print(f"phase 24b: reverse mode, d(crossing sum / N) / d(scale) of {P} "
          f"parameters in lane batches of {COV_GRAD_BATCH}: {N / dt:.1f} "
          f"fwd+bwd paths/s ({dt:.3f} s), peak memory of a batch "
          f"{peak:.2f} GiB; emitter row AD {float(grad[er]):.6e} vs central "
          f"differences {fds[0]:.6e} (rtol 0.05); concrete n, κ reverse "
          f"{[f'{float(grad[r]):.6e}' for r in (S, S + 1)]} vs forward "
          f"{[f'{x:.6e}' for x in fwd]} (rtol 1e-3), central differences "
          f"{[f'{x:.6e}' for x in fds[1:]]} (lobe picks flip); launches "
          f"{launches['gradient_coverage_reverse']}", flush=True)
    # (c) the slit screen, Fraunhofer: the map w.r.t. a translation of the
    # screen along x at full width, then against central differences (h 4
    # µm) in lane batches of SLIT_FD_BATCH: a lane whose discrete picks
    # (edge set, RIS winner, the surface/redirect partition) flip inside
    # [−h, h] moves its whole splat window, so the JAX test's pixel oracle
    # (>= 95% of pixels) holds at its density of lanes per pixel (512 on
    # 64²), not at 4 lanes a pixel; the full batch's share is printed
    sdata, ssensor = built_slits.data, built_slits.scene.sensors[0]

    def slits(th, sl=slice(None)):
        return forward_image(forward_outputs(
            slit_shift(sdata, th), ssensor, ids[sl], "fraunhofer", eps=1e-5),
            ssensor, nee=False)

    zero_t = torch.tensor(0.0, device=dev)
    one_t = torch.tensor(1.0, device=dev)
    with torch.no_grad():
        simg, dt_splain = synced(lambda: slits(zero_t))
    zero_counts()
    (_, gs), dt = synced(lambda: forward_map(slits, zero_t, one_t))
    launches["gradient_slits_forward"] = launch_counts()
    check(launches["gradient_slits_forward"]["closest"] > 0,
          f"phase 24c launched {launches['gradient_slits_forward']}")
    gs = gs.cpu().numpy()
    check(np.isfinite(gs).all() and (gs != 0).any(), "phase 24c: map")
    h = 4e-6
    hp, hm = torch.tensor(h, device=dev), torch.tensor(-h, device=dev)

    def fd_of(sl=slice(None)):
        with torch.no_grad():
            return ((slits(hp, sl) - slits(hm, sl)) / (2 * h)).cpu().numpy()

    share_full = fd_share(gs, fd_of(), 0.15, 0.03)
    shares = []
    for b in range(0, N, SLIT_FD_BATCH):
        sl = slice(b, b + SLIT_FD_BATCH)
        g_b = forward_map(lambda th: slits(th, sl), zero_t, one_t)[1]
        shares.append(fd_share(g_b.cpu().numpy(), fd_of(sl), 0.15, 0.03))
    share = float(np.mean(shares))
    check(share >= 0.95, f"phase 24c: {share:.4f} of pixels match FD "
          f"(batches {min(shares):.4f}-{max(shares):.4f})")
    lit = float((simg > 0).float().mean())
    out.update(slits_forward_paths_per_sec=N / dt,
               slits_plain_paths_per_sec=N / dt_splain,
               slits_fd_share=share, slits_fd_share_min=min(shares),
               slits_fd_share_full_batch=share_full, slits_lit=lit)
    print(f"phase 24c: slit screen {ssensor.width}x{ssensor.height}, {N} "
          f"lanes, depth 4, Fraunhofer, forward mode w.r.t. the screen's "
          f"x translation: {N / dt:.1f} fwd+tangent paths/s against "
          f"{N / dt_splain:.1f} plain, {lit:.4f} of pixels lit; against "
          f"central differences (h 4 um; rtol 0.15, atol 0.03 max|fd|) "
          f"{share:.4f} of pixels match in batches of {SLIT_FD_BATCH} lanes "
          f"(min {min(shares):.4f}), {share_full:.4f} in the full batch; "
          f"launches {launches['gradient_slits_forward']}", flush=True)
    return launches, out


def check_gradient_paths_vs_cpu(build_scene, card="cuda"):
    """Phase 25: the maps of phases 23-24 at 16x16 on the card and on the
    CPU (plain versions): the bdpt emitter-scale map (16x16 x 4 spp lanes,
    depth 4, FSD on) at the bdpt image bars (means within 2%, Pearson >=
    0.999, >= 90% of pixels within 1e-2·max(|ref|, mean|ref|)); the
    coverage emitter-scale map (1,024 lanes, FSD-NEE splats included) on
    >= 94% of the pixels within rtol 0.12, atol 0.02·max; the slit
    screen's translation map (1,024 lanes) on >= 90% within rtol 0.15,
    atol 0.03·max."""
    maps = {}
    for dev in (torch.device(card), torch.device("cpu")):
        m = {}
        built = build_scene(bdpt_scene(16, 4, 4), device=dev)
        data, sensor = built.data, built.scene.sensors[0]
        pix = torch.arange(16 * 16, device=dev).repeat(4)
        sid = torch.arange(4, device=dev).repeat_interleave(256)
        from wave_tracer_tpu_torch.sampling import rng
        jit = rng.uniform(rng.sample_key(0, pix, sid), rng.D_PIXEL_JITTER, 2)
        lanes = (torch.stack([pix % 16, pix // 16], -1), jit, sid)
        mask = emitter_mask(data)
        one = torch.tensor(1.0, device=dev)
        m["bdpt"] = forward_map(lambda th: bdpt_image(bdpt_outputs(
            scaled_rows(data, 1.0 + mask * (th - 1.0)), sensor, lanes, 4),
            sensor), one, one)[1]
        cov = build_scene(coverage_scene(16), device=dev)
        cdata, csensor = cov.data, cov.scene.sensors[0]
        ids = torch.arange(1024, dtype=torch.int32, device=dev)
        emit = torch.cat([emitter_mask(cdata), torch.zeros(2, device=dev)])
        m["coverage"] = forward_map(lambda th: forward_image(forward_outputs(
            forward_params(cdata, 1.0 + emit * (th - 1.0)), csensor, ids,
            "utd"), csensor), one, one)[1]
        sl = slit_built(16, build_scene, dev)
        m["slits"] = forward_map(lambda th: forward_image(forward_outputs(
            slit_shift(sl.data, th), sl.scene.sensors[0], ids, "fraunhofer",
            eps=1e-5), sl.scene.sensors[0], nee=False), one * 0, one)[1]
        maps[dev.type] = {k: v.cpu().numpy() for k, v in m.items()}
    a, b = (maps[t]["bdpt"] for t in (torch.device(card).type, "cpu"))
    check(np.isfinite(a).all() and (a != 0).any(), "phase 25 bdpt: map")
    means = float(np.abs(a.mean((0, 1)) / b.mean((0, 1)) - 1.0).max())
    pearson, share = image_bars(a, b, True)
    check(means <= 0.02 and pearson >= 0.999 and share >= 0.90,
          f"phase 25 bdpt: means {means:.4f}, Pearson {pearson:.6f}, "
          f"share {share:.4f}")
    res = dict(bdpt=(means, pearson, share))
    for k, rtol, atol, bar in (("coverage", 0.12, 0.02, 0.94),
                               ("slits", 0.15, 0.03, 0.90)):
        a, b = (maps[t][k] for t in (torch.device(card).type, "cpu"))
        check(np.isfinite(a).all() and (a != 0).any(), f"phase 25 {k}: map")
        res[k] = fd_share(a, b, rtol, atol)
        check(res[k] >= bar, f"phase 25 {k}: share {res[k]:.4f}")
    print(f"phase 25: 16x16 gradient maps, cuda vs cpu: bdpt emitter scale "
          f"means within {res['bdpt'][0]:.4f}, Pearson {res['bdpt'][1]:.6f}, "
          f"{res['bdpt'][2]:.4f} of pixels within 1e-2; coverage emitter "
          f"scale {res['coverage']:.4f} of pixels within rtol 0.12; slit "
          f"translation {res['slits']:.4f} within rtol 0.15", flush=True)
    return res


def cli_box_files(tmp):
    """The bench wave box and its scale variant as scene files in tmp:
    {name: (path, icosphere, spp)}."""
    import os

    from wave_tracer_tpu_torch.scene.procedural import box_scene_xml
    files = {}
    for name, ico, spp in (("box", False, 8), ("box_scale", True, 4)):
        path = os.path.join(tmp, f"{name}.xml")
        with open(path, "w") as f:
            f.write(box_scene_xml(256, spp, 8, True, icosphere=ico))
        files[name] = (path, ico, spp)
    return files


def check_xml_bake(path, icosphere, spp, tag):
    """The file's load + bake against make_box_scene's bake: every table
    equal but the two uniform spectra's grid ranges (the dialect's uniform
    spectrum spans other wavenumbers; the values are equal). Returns (load
    s, bake s, triangles)."""
    from wave_tracer_tpu_torch.scene.build import bake_scene_arrays
    from wave_tracer_tpu_torch.scene.procedural import make_box_scene
    from wave_tracer_tpu_torch.scene.xml import load_scene_xml
    t0 = time.perf_counter()
    scene = load_scene_xml(path)
    t1 = time.perf_counter()
    arrays, spectral = bake_scene_arrays(scene)
    t2 = time.perf_counter()
    ref = make_box_scene(256, spp, icosphere=icosphere)
    ref.integrator.max_depth, ref.integrator.fsd = 8, True
    ref_arrays, ref_spectral = bake_scene_arrays(ref)
    for key, b in ref_arrays.items():
        if key in ("tables.spectra.log_kmin", "tables.spectra.log_kmax"):
            continue
        a = arrays[key]
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"{tag}: {key} differs from make_box_scene's bake")
    for key, b in ref_spectral[0].items():
        check(np.array_equal(spectral[0][key], b),
              f"{tag}: spectral.{key} differs from make_box_scene's bake")
    check(np.array_equal(scene.sensors[0].to_world, ref.sensors[0].to_world)
          and scene.sensors[0].fov == ref.sensors[0].fov
          and scene.integrator.max_depth == 8 and scene.integrator.fsd,
          f"{tag}: sensor or integrator differs from make_box_scene's")
    return t1 - t0, t2 - t1, len(arrays["geo.p0"])


def check_cli(rk, ck, card):
    """Phase 22 (module doc). Returns (the kernels' launches in cli.main's
    render of the scale file, in its mask, its captured calls against
    their plain versions, the phase's readings, the CLI's EXR of the box
    file as RGB)."""
    import json as json_mod
    import os
    import shutil
    import tempfile

    from wave_tracer_tpu_torch import cli
    from wave_tracer_tpu_torch.render import render_scene
    from wave_tracer_tpu_torch.render.checkpoint import (load_checkpoint,
                                                         save_checkpoint)
    from wave_tracer_tpu_torch.render.mask import render_mask
    from wave_tracer_tpu_torch.render.output import read_exr, read_png
    from wave_tracer_tpu_torch.scene import build_scene
    from wave_tracer_tpu_torch.scene.xml import load_scene_xml

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="wt_cli_")
    out = {}
    try:
        files = cli_box_files(tmp)
        for name, (path, ico, spp) in files.items():
            t_load, t_bake, T = check_xml_bake(path, ico, spp,
                                               f"phase 22 {name}")
            out[f"{name}_load_s"], out[f"{name}_bake_s"] = t_load, t_bake
            print(f"phase 22: {name}.xml ({T} triangles): load "
                  f"{t_load:.3f} s, bake {t_bake:.3f} s, tables equal to "
                  f"make_box_scene's [{card}]", flush=True)
        check(out["box_scale_bake_s"] > 0, "phase 22: no bake time")

        # the real entry point, as a process of its own
        box, _, _ = files["box"]
        odir = os.path.join(tmp, "out")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "wave_tracer_tpu_torch", "render", box,
             "-o", odir, "--write-stats", "--mask"], cwd=root, env=env,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"phase 22: the CLI exited "
              f"{proc.returncode}:\n{proc.stdout[-2000:]}"
              f"{proc.stderr[-4000:]}")
        for f in ("camera.exr", "camera.png", "camera_mask.png",
                  "perf_stats.json"):
            check(os.path.isfile(os.path.join(odir, f)),
                  f"phase 22: the CLI wrote no {f}")
        with open(os.path.join(odir, "perf_stats.json")) as f:
            (cli_st,) = json_mod.load(f)
        check(cli_st["mode"] == "wave-compact" and cli_st["paths"] == 524288,
              f"phase 22: CLI stats {cli_st}")
        exr, names = read_exr(os.path.join(odir, "camera.exr"))
        exr = np.stack([exr[..., names.index(c)] for c in "RGB"], -1)

        built = build_scene(load_scene_xml(box), device="cuda")
        sensor = built.scene.sensors[0]
        M = sensor.response.develop_matrix()
        render_scene(built, spp=1, device="cuda")           # warm-up
        img, st = render_scene(built, device="cuda")
        chunked = [render_scene(built, device="cuda",
                                interrupt=lambda: None)[1]["paths_per_sec"]
                   for _ in range(RATE_RENDERS)]
        rgb = (img @ M.T).astype(np.float32)
        frac = compare_images(exr, rgb, st, st, "phase 22 CLI vs render",
                              mean_rtol=0.02, px_tol=1e-2, px_frac=0.90,
                              counters=(), counter_rtol=0.0, corr=0.999)
        out.update(cli_paths_per_sec=cli_st["paths_per_sec"],
                   cli_process_s=wall,
                   chunked_paths_per_sec=float(np.median(chunked)))
        print(f"phase 22: python -m wave_tracer_tpu_torch render box.xml "
              f"(256x256 8 spp depth 8): exit 0 in {wall:.2f} s, "
              f"{cli_st['paths_per_sec']:.1f} paths/s in its render "
              f"({cli_st['seconds']:.3f} s, pool {cli_st['pool_lanes']}); "
              f"in-process render_scene {rate_line(built, st)}); the same "
              f"in-process with an interrupt callback (the CLI's chunks of "
              f"1 spp): {float(np.median(chunked)):.1f} paths/s (median of "
              f"{', '.join(f'{x:.1f}' for x in chunked)}); EXR vs "
              f"in-process develop: {frac:.4f} of pixels within the wave "
              f"bar [{card}]", flush=True)

        alpha = read_png(os.path.join(odir, "camera_mask.png"))[..., 0]
        m_card = render_mask(built, sensor)
        m_cpu = render_mask(built.on("cpu"), sensor)
        check(np.array_equal(m_card, m_cpu),
              f"phase 22: mask differs on the card and the CPU on "
              f"{int((m_card != m_cpu).sum())} pixels")
        check(np.array_equal(alpha, np.clip(m_card * 255.0 + 0.5, 0, 255)
                             .astype(np.uint8)),
              "phase 22: the CLI's mask PNG is not the in-process mask")
        # the mask's K1 launches, timed
        events = []
        closest_hit = rk.closest_hit

        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            r = closest_hit(*a, **kw)
            e1.record()
            events.append((e0, e1))
            return r
        rk.closest_hit = timed
        try:
            render_mask(built, sensor)
        finally:
            rk.closest_hit = closest_hit
        torch.cuda.synchronize()
        mask_ms = [a.elapsed_time(b) for a, b in events]
        out["mask_k1_ms_per_launch"] = float(np.mean(mask_ms))
        print(f"phase 22: mask 256x256 x 4 subsamples: card equals CPU, "
              f"{float(m_card.mean()):.4f} covered; K1 {len(mask_ms)} "
              f"launches, {np.mean(mask_ms):.3f} ms per launch [{card}]",
              flush=True)

        # cli.main in-process on the scale file, its kernel calls held
        # against their plain versions
        scale, _, _ = files["box_scale"]
        sdir = os.path.join(tmp, "scale")
        zero_counts()
        cap = capture_calls(rk, ck, lambda: check(cli.main(
            ["render", scale, "-o", sdir, "--write-stats"]) == 0,
            "phase 22: cli.main failed"), phase="phase 22")
        torch.cuda.synchronize()
        cli_launches = launch_counts()
        check(plain_launched(cli_launches),
              f"phase 22: the CLI's scale render launched {cli_launches}")
        with open(os.path.join(sdir, "perf_stats.json")) as f:
            (scale_st,) = json_mod.load(f)
        zero_counts()
        sbuilt = build_scene(load_scene_xml(scale), device="cuda")
        render_mask(sbuilt, sbuilt.scene.sensors[0])
        torch.cuda.synchronize()
        mask_launches = launch_counts()
        check(mask_launches["closest"] > 0 and mask_launches["anyhit"] == 0
              and mask_launches["cone_minz"] == 0,
              f"phase 22: the mask launched {mask_launches}")
        render_scene(sbuilt, spp=1, device="cuda")         # warm-up
        img_s, st_s = render_scene(sbuilt, device="cuda")
        calls = check_calls_vs_plain(rk, ck, cap, phase="phase 22",
                                     k3_lanes=REF_CHUNK)
        out.update(scale_cli_paths_per_sec=scale_st["paths_per_sec"],
                   scale_paths_per_sec=st_s["paths_per_sec"])
        print(f"phase 22: cli.main render box_scale.xml (81932 tris, "
              f"256x256 4 spp depth 8): {scale_st['paths_per_sec']:.1f} "
              f"paths/s ({scale_st['seconds']:.3f} s, pool "
              f"{scale_st['pool_lanes']}), launches {cli_launches}; "
              f"in-process render_scene {st_s['paths_per_sec']:.1f} paths/s "
              f"({st_s['seconds']:.3f} s, pool {st_s['pool_lanes']}); its "
              f"mask launches {mask_launches} [{card}]", flush=True)

        # interrupt after two polls, resume; then through a checkpoint
        polls = {"n": 0}

        def stop_after_two():
            polls["n"] += 1
            return "terminate" if polls["n"] >= 2 else None

        part, pst, rend = render_scene(built, device="cuda",
                                       interrupt=stop_after_two,
                                       return_renderer=True)
        check(pst["interrupted"] and 0 < pst["spp_done"] < 8,
              f"phase 22: the interrupt left {pst['spp_done']} spp")
        resumed, rst = render_scene(built, device="cuda",
                                    init_film=rend.last_film,
                                    spp_start=int(rend.last_spp_done))
        ckpt = os.path.join(tmp, "camera.ckpt.npz")
        save_checkpoint(ckpt, rend.last_film, int(rend.last_spp_done), 0,
                        sensor.id)
        film, done, seed, sid = load_checkpoint(ckpt, device="cuda")
        check((done, seed, sid) == (pst["spp_done"], 0, "camera"),
              f"phase 22: checkpoint holds {(done, seed, sid)}")
        from_ckpt, _ = render_scene(built, device="cuda", init_film=film,
                                    spp_start=done)
        scale_ref = np.maximum(np.abs(img), np.abs(img).mean())
        for tag, x in (("resumed", resumed), ("from the checkpoint",
                                              from_ckpt)):
            err = float((np.abs(x - img) / scale_ref).max())
            check(not rst["interrupted"] and err <= 1e-4,
                  f"phase 22: {tag} render vs uninterrupted: max "
                  f"|diff|/max(|ref|, mean|ref|) {err:.3e}")
            out[f"resume_{tag.split()[0]}_max_rel"] = err
        print(f"phase 22: interrupted after 2 polls at {pst['spp_done']} spp, "
              f"resumed and resumed from a card checkpoint: max "
              f"|diff|/max(|ref|, mean|ref|) against the uninterrupted render "
              f"{out['resume_resumed_max_rel']:.3e} and "
              f"{out['resume_from_max_rel']:.3e}", flush=True)
        return cli_launches, mask_launches, calls, out, exr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 7 (winners), 26 and 27: K3's winner build, geometry
# derivatives through it, rendering across processes

def cone_winners(ck, geo, args, tag, lanes=None):
    """K3's winner build against its main build (minima and counts bit-
    equal: the main build is bit-equal to the plain version) and against
    the plain version's winners over the first `lanes` lanes (all if
    None): ids equal, minima bit-equal. Returns (ms of the winner build,
    its share of lanes x boundaries with a winner)."""
    table = geo.cone_table
    zc, cnt = ck.cone_minz(*args, table=table)
    zw, cw, win = ck.cone_minz(*args, table=table, winners=True)
    check(torch.equal(zw, zc) and torch.equal(cw, cnt),
          f"K3 winners {tag}: minima or counts differ from the main build")
    n = args[1].shape[0] if lanes is None else lanes
    refs = [ck._minz_ref(args[0], *(a[s:min(s + REF_CHUNK, n)]
                                    for a in args[1:-1]), args[-1],
                         winners=True) for s in range(0, n, REF_CHUNK)]
    zr = torch.cat([r[0] for r in refs])
    wr = torch.cat([r[2] for r in refs])
    check(torch.equal(zw[:n], zr), f"K3 winners {tag}: minima not "
          "bit-equal to the plain version")
    if not torch.equal(win[:n], wr):
        fail(f"K3 winners {tag}: ids differ from the plain version's on "
             f"{int((win[:n] != wr).sum())} of {wr.numel()} entries")
    ms = cuda_ms(lambda: ck.cone_minz(*args, table=table, winners=True), 3)
    return ms, float((win >= 0).float().mean())


def to_device(x, dev):
    """x (a tensor, dual tensors included, a dict or a dataclass of them)
    on `dev`; a dataclass is made anew from its init fields, so derived
    tables (GeoArrays') are derived there."""
    import dataclasses
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: to_device(getattr(x, f.name), dev)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    return x


GEOMETRY_MOVES = {"back_wall": (2, (0.0, 0.0, 1.0)),
                  "left_wall_slide": (3, (0.0, 0.0, 1.0))}
ULP = 2.0 ** -23        # one ulp of the walls' coordinates, |x| = 1


def geometry_map(data, sensor, lanes, depth, move, at=0.0):
    """The wave box's forward-mode map w.r.t. `move` at th = at."""
    shape, d = GEOMETRY_MOVES[move]
    dev = data.geo.p0.device
    delta = torch.tensor(d, device=dev)
    return forward_map(lambda th: path_values(translated(
        data, shape, th * delta), sensor, lanes, True, depth),
        torch.tensor(at, device=dev), torch.tensor(1.0, device=dev))[1]


def replay_cone_queries(data, sensor, lanes, depth, move, card):
    """Phase 26(a): the forward-mode run w.r.t. `move` on the card, every
    cone query of it again on the CPU on the same (dual) inputs and the
    card's moved triangles → (queries, minima entries that differ, count
    entries that differ, card tangents, CPU tangents)."""
    import torch.autograd.forward_ad as fwAD
    from wave_tracer_tpu_torch.integrator import plt_path
    tr = plt_path.trace_mod
    real = tr.cone_boundary_minz
    shape, d = GEOMETRY_MOVES[move]
    cpu = torch.device("cpu")
    rec = []
    with fwAD.dual_level():
        th = fwAD.make_dual(torch.tensor(0.0, device=card),
                            torch.tensor(1.0, device=card))
        moved = translated(data, shape, th * torch.tensor(d, device=card))
        geo_cpu = to_device(moved.geo, cpu)

        def split(z):
            p, t = fwAD.unpack_dual(z)
            return p.cpu(), (torch.zeros_like(p) if t is None else t).cpu()

        def replay(geo, *args, **kw):
            out = real(geo, *args, **kw)
            ref = real(geo_cpu, *[to_device(a, cpu) for a in args],
                       **to_device(kw, cpu))
            rec.append((split(out[0]), split(ref[0]), out[1].cpu(), ref[1]))
            return out
        tr.cone_boundary_minz = replay
        try:
            path_values(moved, sensor, lanes, True, depth)
        finally:
            tr.cone_boundary_minz = real
    zdiff = cdiff = 0
    tc, tp = [], []
    for (zc, zt), (rc, rt), cc, rcnt in rec:
        both_inf = torch.isinf(zc) & torch.isinf(rc)
        zdiff += int((~(both_inf | (zc == rc))).sum())
        cdiff += int((cc != rcnt).sum())
        fin = torch.isfinite(rc)
        tc.append(zt[fin])
        tp.append(rt[fin])
    return len(rec), zdiff, cdiff, torch.cat(tc).numpy(), \
        torch.cat(tp).numpy()


def check_geometry_gradients(rk, ck, build_scene, card):
    """Phase 26 (module doc). Returns its readings and launches."""
    res, depth = 64, 8
    dev = torch.device(card)
    built = build_scene(box_scene(res, 1, depth, fsd=True), device=dev)
    data, sensor = built.data, built.scene.sensors[0]
    lanes = grad_lanes(res, dev)
    cpu_built = build_scene(box_scene(res, 1, depth, fsd=True),
                            device="cpu")
    cpu_lanes = grad_lanes(res, torch.device("cpu"))
    # warm-ups: the plain forward, and forward mode (its first call pays
    # one-off costs of the dual tensors' kernels)
    path_values(data, sensor, lanes, True, depth)
    geometry_map(data, sensor, lanes, depth, "back_wall")
    zero_counts()
    _, sec = synced(lambda: path_values(data, sensor, lanes, True, depth))
    out = {"plain": dict(launch_counts(),
                         paths_per_sec=res * res / sec)}
    check(plain_launched(out["plain"]),
          f"phase 26: the plain forward launched {out['plain']}")
    for name in GEOMETRY_MOVES:
        zero_counts()
        g, sec = synced(lambda: geometry_map(data, sensor, lanes, depth,
                                             name))
        r = out[name] = dict(launch_counts(),
                             paths_per_sec=res * res / sec)
        check(each_launched(r) and r["cone_minz_winners"]
              == r["cone_minz"] == out["plain"]["cone_minz"],
              f"phase 26 {name}: launched {r} against the plain forward's "
              f"{out['plain']}")
        # (a) the path's own cone queries, card against the plain version
        n, zdiff, cdiff, tc, tp = replay_cone_queries(data, sensor, lanes,
                                                      depth, name, card)
        t_pearson, t_share = image_bars(tc, tp, True)
        t_err = float(np.abs(tc - tp).max() / max(np.abs(tp).max(), 1e-30))
        check(zdiff == 0 and cdiff == 0, f"phase 26 {name}: K3 against the "
              f"plain version on the path's cone queries: {zdiff} minima, "
              f"{cdiff} counts differ")
        check(np.any(tp != 0) and t_pearson >= 0.999 and t_share >= 0.90
              and np.all(np.abs(tc - tp) <= 1e-5 * np.abs(tp)
                         + 1e-6 * np.abs(tp).max()),
              f"phase 26 {name}: the minima's tangents, card against the "
              f"plain version: Pearson {t_pearson}, share {t_share}, max "
              f"error {t_err:.3e} of the largest")
        # (b) the maps, card against CPU, beside the CPU's one-ulp spread
        a = g.cpu().numpy()
        b = geometry_map(cpu_built.data, sensor, cpu_lanes, depth,
                         name).numpy()
        check(np.isfinite(a).all() and (a != 0).any(),
              f"phase 26 {name}: map not finite or zero")
        pearson, share = image_bars(a, b, True)
        check(share >= 0.90, f"phase 26 {name}: {share:.4f} of pixels "
              "within 1e-2")
        ulp = [image_bars(geometry_map(cpu_built.data, sensor, cpu_lanes,
                                       depth, name, at).numpy(), b, True)[0]
               for at in (ULP, -ULP)]
        r.update(k3_queries=n, tangent_pearson=t_pearson,
                 tangent_share=t_share, tangent_max_err=t_err,
                 pearson=pearson, share=share, cpu_ulp_pearson=ulp)
        print(f"phase 26: wave box {res}x{res} 1 spp depth {depth}, forward "
              f"mode w.r.t. {name}: (a) {n} cone queries of the path, card "
              f"against the plain version: minima and counts bit-equal, "
              f"tangents Pearson {t_pearson:.9f}, {t_share:.4f} within "
              f"1e-2, max error {t_err:.3e} of the largest; (b) maps cuda vs"
              f" cpu {share:.4f} of pixels within 1e-2, Pearson "
              f"{pearson:.6f} (the CPU's own map against it moved +-1 ulp: "
              f"{ulp[0]:.6f}, {ulp[1]:.6f}); {r['paths_per_sec']:.1f} paths/"
              f"s against the plain forward's "
              f"{out['plain']['paths_per_sec']:.1f}; launches K1 "
              f"{r['closest']} K2 {r['anyhit']} K3 {r['cone_minz']} (winner "
              f"build {r['cone_minz_winners']}) [{card}]", flush=True)
    return out


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


DIST_LANES = 1 << 15        # lanes per rank in phase 27 (2 ranks: 2^16)


def dist_rank(rank, world, init, out, backend):
    """One rank of phase 27(b): the wave box at 256x256 x 1 spp, depth 8,
    through render_distributed on this rank's card; saves its image, its
    stats and its K1/K2/K3 launches (counted from zero around the
    render)."""
    import json as json_mod

    from wave_tracer_tpu_torch.accel import cone_kernels as ck
    from wave_tracer_tpu_torch.accel import ray_kernels as rk
    from wave_tracer_tpu_torch.parallel import launch
    from wave_tracer_tpu_torch.parallel.dist import render_distributed
    from wave_tracer_tpu_torch.scene import build_scene
    launch.initialize_distributed(init, world, rank, backend=backend,
                                  device="cuda", timeout_s=300.0)
    try:
        built = build_scene(box_scene(256, 1, 8, fsd=True),
                            device=launch.local_device())
        zero_counts()
        img, st = render_distributed(built, lanes_per_device=DIST_LANES)
        torch.cuda.synchronize()
        np.save(f"{out}/img_{backend}_{rank}.npy", img)
        with open(f"{out}/run_{backend}_{rank}.json", "w") as f:
            json_mod.dump(dict(st, launches=launch_counts(),
                               device=str(launch.local_device())), f)
    finally:
        launch.shutdown()


def spawn_ranks(fn, world, *args, deadline_s=300.0):
    """fn(rank, world, *args) in `world` spawned processes, each joined
    within deadline_s (else killed and the phase fails)."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=(world, *args), nprocs=world, join=False,
        start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                fail(f"ranks not done in {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def check_distributed(rk, ck, build_scene, cli_exr, card):
    """Phase 27 (module doc). Returns its readings and launches."""
    import json as json_mod
    import os
    import shutil
    import tempfile

    from wave_tracer_tpu_torch.parallel import launch
    from wave_tracer_tpu_torch.parallel.dist import render_distributed
    from wave_tracer_tpu_torch.render import render_scene

    out = {}
    # (a) one rank of an NCCL group against the batched renderer
    check(launch.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                        device="cuda"), "phase 27a: init")
    try:
        built = build_scene(box_scene(256, 1, 8, fsd=True), device="cuda")
        render_distributed(built, lanes_per_device=2 * DIST_LANES)  # warm-up
        zero_counts()
        img_a, st_a = render_distributed(built,
                                         lanes_per_device=2 * DIST_LANES)
        out["launches_world1"] = launch_counts()
        check(st_a["mode"] == "wave-dist" and st_a["processes"] == 1
              and plain_launched(out["launches_world1"]),
              f"phase 27a: {st_a}, launches {out['launches_world1']}")
    finally:
        launch.shutdown()
    img_b, st_b = render_scene(built, device="cuda", compact=False,
                               pool_lanes=2 * DIST_LANES)
    err = float(np.abs(img_a - img_b).max() / np.abs(img_b).max())
    check(np.isfinite(img_a).all() and err <= 1e-5,
          f"phase 27a: against Renderer(compact=False) {err:.3e} of max")
    out.update(world1_paths_per_sec=st_a["paths_per_sec"],
               batched_paths_per_sec=st_b["paths_per_sec"],
               world1_max_err=err)
    print(f"phase 27a: render_distributed, one NCCL rank, wave box 256x256 "
          f"1 spp depth 8: {st_a['paths_per_sec']:.1f} paths/s "
          f"({st_a['seconds']:.3f} s), Renderer(compact=False) "
          f"{st_b['paths_per_sec']:.1f} paths/s; max |diff| {err:.3e} of "
          f"max; launches {out['launches_world1']} [{card}]", flush=True)

    # (b) two ranks: gloo on the one card, NCCL over two cards if present
    tmp = tempfile.mkdtemp(prefix="wt_dist_")
    try:
        backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2
                               else [])
        for backend in backends:
            t0 = time.perf_counter()
            spawn_ranks(dist_rank, 2, f"tcp://127.0.0.1:{free_port()}", tmp,
                        backend)
            wall = time.perf_counter() - t0
            for rank in (0, 1):
                img = np.load(f"{tmp}/img_{backend}_{rank}.npy")
                with open(f"{tmp}/run_{backend}_{rank}.json") as f:
                    run = json_mod.load(f)
                e = float(np.abs(img - img_a).max() / np.abs(img_a).max())
                check(e <= 1e-5, f"phase 27b {backend} rank {rank}: merged "
                      f"film {e:.3e} of max from 27a's")
                check(plain_launched(run["launches"])
                      and run["processes"] == 2,
                      f"phase 27b {backend} rank {rank}: {run}")
                out[f"{backend}_rank{rank}"] = dict(
                    launches=run["launches"], device=run["device"],
                    paths_per_sec=run["paths_per_sec"], max_err=e)
            print(f"phase 27b: two {backend} ranks "
                  f"({out[f'{backend}_rank0']['device']}, "
                  f"{out[f'{backend}_rank1']['device']}), wave box 256x256 "
                  f"1 spp depth 8: merged films within "
                  f"{max(out[f'{backend}_rank{r}']['max_err'] for r in (0, 1)):.3e}"
                  f" of max of 27a's; {out[f'{backend}_rank0']['paths_per_sec']:.1f}"
                  f" paths/s (its render, cold); launches rank 0 "
                  f"{out[f'{backend}_rank0']['launches']}, rank 1 "
                  f"{out[f'{backend}_rank1']['launches']}; {wall:.1f} s with "
                  f"process start [{card}]", flush=True)

        # (c) the CLI's --distributed with two processes
        root = os.path.dirname(os.path.abspath(__file__))
        box = cli_box_files(tmp)["box"][0]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        if torch.cuda.device_count() < 2:
            env["WT_DIST_BACKEND"] = "gloo"      # two ranks on one card
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "wave_tracer_tpu_torch", "render", box,
             "-o", os.path.join(tmp, f"cli{r}"), "--write-stats",
             "--distributed", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(r),
             "--batch_lanes", str(1 << 17)], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in (0, 1)]
        try:
            res = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        wall = time.perf_counter() - t0
        for r, (p, (so, se)) in enumerate(zip(procs, res)):
            check(p.returncode == 0, f"phase 27c: rank {r} exited "
                  f"{p.returncode}:\n{so[-2000:]}{se[-4000:]}")
        check(not os.path.exists(os.path.join(tmp, "cli1")),
              "phase 27c: rank 1 wrote outputs")
        from wave_tracer_tpu_torch.render.output import read_exr
        with open(os.path.join(tmp, "cli0", "perf_stats.json")) as f:
            (cst,) = json_mod.load(f)
        check(cst["mode"] == "wave-dist" and cst["processes"] == 2
              and cst["paths"] == 524288, f"phase 27c: stats {cst}")
        exr, names = read_exr(os.path.join(tmp, "cli0", "camera.exr"))
        exr = np.stack([exr[..., names.index(c)] for c in "RGB"], -1)
        frac = compare_images(exr, cli_exr, cst, cst,
                              "phase 27c CLI --distributed vs the CLI",
                              mean_rtol=0.02, px_tol=1e-2, px_frac=0.90,
                              counters=(), counter_rtol=0.0, corr=0.999)
        out.update(cli_paths_per_sec=cst["paths_per_sec"],
                   cli_process_s=wall, cli_share=frac,
                   cli_backend=env.get("WT_DIST_BACKEND", "nccl"))
        print(f"phase 27c: python -m wave_tracer_tpu_torch render box.xml "
              f"--distributed, two processes ({out['cli_backend']}): exit 0 "
              f"in {wall:.2f} s, one EXR (rank 0's), "
              f"{cst['paths_per_sec']:.1f} paths/s in its render "
              f"({cst['seconds']:.3f} s); {frac:.4f} of pixels within the "
              f"wave bar of the one-process CLI's EXR [{card}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---- phase 28: large scenes: the BVH route (K4/K5) above MXU_MAX_TRIS
# triangles and the clustered edge sweep above 2048 edges

LARGE_TESSELLATION = 384    # bench.py's sphere at 327,680 triangles
LARGE_TRIS = 327692
SMALL_TESSELLATION = 24     # 1,280: the card-against-CPU check's sphere
SMALL_LIMIT = 1024          # MXU_MAX_TRIS in that check
# fp32 operations of the traversal kernels (csrc/bvh_kernels.cu, counted
# as FLOP_PER_PAIR is): an internal node's two slab tests (3 subtractions
# and 3 multiplications per slab pair, twice per child); a leaf
# triangle's Möller–Trumbore test (two cross products of 9, three dot
# products of 5 and their scalings, the determinant's 5 and its
# reciprocal, the origin's offset of 3, u + v); a ray's three reciprocals
FLOP_BVH_NODE = 24
FLOP_MT = 46
FLOP_BVH_RAY = 3


def bvh_bound(stats, N, ex_cols, out_bytes):
    """(bound_ms, bound_by) of a K4/K5 launch from its twin's counts on the
    same inputs (the bounds' rule): operations over the nodes and
    triangles each ray visits; bytes: each ray in (origin, direction,
    range, exclusions) and out once, and each node and triangle row that
    some ray reads once."""
    ops = (stats["internal"] * FLOP_BVH_NODE + stats["tri_tests"] * FLOP_MT
           + N * FLOP_BVH_RAY)
    nbytes = (N * (32 + 4 * ex_cols + out_bytes)
              + int(stats["nodes_seen"].sum()) * 64
              + int(stats["tris_seen"].sum()) * 48)
    return bound(ops, nbytes)


def timed_twin(fn):
    """(result, ms) of one call of a twin on the card, host clock around
    synchronised work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bvh_segments(geo, N, r, first=None):
    """N seeded random segments through geo (tmax 0.05-4), a third with
    one to three excluded ids (the first the ray's closest hit if
    `first` is given)."""
    T = geo.num_tris
    dev = geo.p0.device
    ro, rd = random_rays(geo, N, r)
    some = r.random(N) < 1 / 3
    ex = np.where(some[:, None], r.integers(0, T, (N, 3)), -1)
    ex[:, 1:] = np.where(r.random((N, 2)) < 0.5, ex[:, 1:], -1)
    if first is not None:
        ex[:, 0] = np.where(some, first, -1)
    t = [torch.from_numpy(x).to(dev) for x in (ro, rd)]
    return (t[0], t[1], torch.full((N,), 1e-4, device=dev),
            torch.from_numpy(r.uniform(0.05, 4.0, N).astype(np.float32)
                             ).to(dev),
            torch.from_numpy(ex.astype(np.int32)).to(dev))


def check_bvh_kernels(bk, geo, N, n_legs, seed):
    """28a: K4 and K5 against their twins on the card, words bit-equal:
    N seeded random rays through geo (a third excluding the triangle they
    hit first), K5 on N and on n_legs random segments. Returns the rows'
    readings."""
    T = geo.num_tris
    r = np.random.default_rng(seed)
    dev = geo.p0.device
    nodes, tris = geo.node_pack, geo.tri_geom
    ro, rd = (torch.from_numpy(x).to(dev) for x in random_rays(geo, N, r))
    tmin = torch.full((N,), 1e-4, device=dev)
    tmax = torch.full((N,), 1e30, device=dev)
    none = torch.full((N,), -1, dtype=torch.int32, device=dev)
    _, first = bk.closest_hit(nodes, tris, ro, rd, tmin, tmax, none)
    ex = torch.where(torch.from_numpy(r.random(N) < 1 / 3).to(dev), first,
                     -1).to(torch.int32)
    args = (nodes, tris, ro, rd, tmin, tmax, ex)
    t_k, i_k = bk.closest_hit(*args)
    stats = {}
    (t_r, i_r), ms_plain = timed_twin(
        lambda: bk._closest_ref(*args, stats=stats))
    check(torch.equal(t_k.view(torch.int32), t_r.view(torch.int32))
          and torch.equal(i_k, i_r),
          f"K4 N={N} T={T}: not bit-equal to its twin (ids differ on "
          f"{(i_k != i_r).sum().item()} rays)")
    ms = cuda_ms(lambda: bk.closest_hit(*args), 3)
    b = bvh_bound(stats, N, 1, 8)
    hits = (i_k >= 0).float().mean().item()
    print(f"phase 28a: N={N} T={T}: K4 bit-equal to its twin, hits "
          f"{hits:.3f}, per ray {stats['internal'] / N:.1f} internal nodes "
          f"and {stats['tri_tests'] / N:.1f} triangle tests; K4 {ms:.3f} ms "
          f"(twin {ms_plain:.1f} ms), bound {b[0]:.4f} ms ({b[1]})",
          flush=True)
    k4 = dict(max_abs_err=0.0, ms=ms, plain_ms=ms_plain, bound=b,
              hit_share=hits, nodes_per_ray=stats["internal"] / N,
              tri_tests_per_ray=stats["tri_tests"] / N)
    k5 = {}
    for tag, n in (("rays", N), ("fsd_legs", n_legs)):
        seg = bvh_segments(geo, n, r, first.cpu().numpy() if n == N
                           else None)
        a5 = (nodes, tris) + seg
        o_k = bk.any_hit(*a5)
        st5 = {}
        o_r, ms5_plain = timed_twin(lambda: bk._anyhit_ref(*a5,
                                                           stats=st5))
        check(torch.equal(o_k, o_r), f"K5 N={n} T={T}: occlusion differs "
              f"from its twin on {(o_k != o_r).sum().item()} rays")
        ms5 = cuda_ms(lambda: bk.any_hit(*a5), 3)
        b5 = bvh_bound(st5, n, 3, 1)
        occ = o_k.float().mean().item()
        print(f"phase 28a: N={n} T={T} segments ({tag}): K5 equal to its "
              f"twin, occluded {occ:.3f}, per ray "
              f"{st5['internal'] / n:.1f} internal nodes and "
              f"{st5['tri_tests'] / n:.1f} triangle tests; K5 {ms5:.3f} ms "
              f"(twin {ms5_plain:.1f} ms), bound {b5[0]:.4f} ms ({b5[1]})",
              flush=True)
        k5[tag] = dict(max_abs_err=0.0, ms=ms5, plain_ms=ms5_plain,
                       bound=b5, rows=n, occluded_share=occ,
                       nodes_per_ray=st5["internal"] / n,
                       tri_tests_per_ray=st5["tri_tests"] / n)
    # the row reports K5's largest launch on the wave path, the leg call
    return k4, dict(k5["fsd_legs"], at_pool_width=k5["rays"])


def check_bvh_vs_all_pairs(bk, rk, soup_geo, bvh_geo, tri_order, N, seed):
    """28b: the scale cell's triangles through the BVH route (bvh_geo, in
    leaf order; tri_order maps its rows to soup_geo's) against K1/K2 on
    soup_geo: N seeded random rays, ids on >= 99.9%, t within rtol 1e-4 /
    atol 1e-5 where they agree; N random segments (a third with
    exclusions), occlusion on >= 99.9%."""
    T = soup_geo.num_tris
    r = np.random.default_rng(seed)
    dev = soup_geo.p0.device
    ro, rd = (torch.from_numpy(x).to(dev)
              for x in random_rays(soup_geo, N, r))
    tmin = torch.full((N,), 1e-4, device=dev)
    tmax = torch.full((N,), 1e30, device=dev)
    order = torch.as_tensor(np.asarray(tri_order), device=dev).long()
    ex1 = torch.full((N, 3), -1, dtype=torch.int32, device=dev)
    k1_args = (soup_geo.tri_feat, soup_geo.mxu_center, ro, rd, tmin, tmax,
               ex1)
    t1, i1 = rk.closest_hit(*k1_args, table=soup_geo.ray_table)
    k4_args = (bvh_geo.node_pack, bvh_geo.tri_geom, ro, rd, tmin, tmax,
               ex1[:, 0].contiguous())
    t4, i4 = bk.closest_hit(*k4_args)
    i4s = torch.where(i4 >= 0, order[i4.clamp_min(0)], -1).to(torch.int32)
    same = i4s == i1
    agree = same.float().mean().item()
    check(agree >= 0.999, f"K4 vs K1 T={T}: ids agree on {agree:.5f}")
    hit = same & (i1 >= 0)
    t_ok = ((t4 - t1).abs() <= 1e-4 * t1.abs() + 1e-5)[hit]
    check(bool(t_ok.all()), f"K4 vs K1 T={T}: t off on "
          f"{(~t_ok).sum().item()} rays")
    ms4 = cuda_ms(lambda: bk.closest_hit(*k4_args), 3)
    ms1 = cuda_ms(lambda: rk.closest_hit(*k1_args,
                                         table=soup_geo.ray_table), 3)
    seg = bvh_segments(soup_geo, N, r)
    exs = seg[4]
    ex_bvh = torch.where(exs >= 0, torch.argsort(order).to(torch.int32)[
        exs.clamp_min(0).long()], -1).to(torch.int32)
    o2 = rk.any_hit(soup_geo.tri_feat, soup_geo.mxu_center, *seg,
                    table=soup_geo.ray_table)
    a5 = (bvh_geo.node_pack, bvh_geo.tri_geom) + seg[:4] + (ex_bvh,)
    o5 = bk.any_hit(*a5)
    occ_agree = (o2 == o5).float().mean().item()
    check(occ_agree >= 0.999, f"K5 vs K2 T={T}: occlusion agrees on "
          f"{occ_agree:.5f}")
    ms5 = cuda_ms(lambda: bk.any_hit(*a5), 3)
    ms2 = cuda_ms(lambda: rk.any_hit(soup_geo.tri_feat, soup_geo.mxu_center,
                                     *seg, table=soup_geo.ray_table), 3)
    print(f"phase 28b: N={N} T={T} through the BVH for this check: K4 vs K1 "
          f"ids agree {agree:.6f} (hits {(i1 >= 0).float().mean().item():.3f}"
          f"), K5 vs K2 occlusion {occ_agree:.6f}; K4 {ms4:.3f} ms vs K1 "
          f"{ms1:.3f} ms, K5 {ms5:.3f} ms vs K2 {ms2:.3f} ms", flush=True)
    return dict(ids_agree=agree, occlusion_agrees=occ_agree, k4_ms=ms4,
                k1_ms=ms1, k5_ms=ms5, k2_ms=ms2)


def timed_bvh_render(bk, ck, built):
    """One render of `built` with CUDA events around every K4, K5 and K3
    call → {kind: [ms]} (kinds: bvh_closest, bvh_any_legs for the batched
    FSD-leg call, bvh_any_nee, cone_minz)."""
    from wave_tracer_tpu_torch.render import render_scene
    rec = []
    fns = dict(closest_hit=bk.closest_hit, any_hit=bk.any_hit)
    cone_minz = ck.cone_minz

    def timed(kind_of, fn):
        def wrapper(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            rec.append((kind_of(args), a, b))
            return out
        return wrapper

    bk.closest_hit = timed(lambda a: "bvh_closest", fns["closest_hit"])
    bk.any_hit = timed(lambda a: "bvh_any_legs" if a[2].shape[0] > POOL
                       else "bvh_any_nee", fns["any_hit"])
    ck.cone_minz = timed(lambda a: "cone_minz", cone_minz)
    try:
        render_scene(built, device="cuda")
    finally:
        bk.closest_hit, bk.any_hit = fns["closest_hit"], fns["any_hit"]
        ck.cone_minz = cone_minz
    torch.cuda.synchronize()
    calls = {}
    for kind, a, b in rec:
        calls.setdefault(kind, []).append(a.elapsed_time(b))
    return calls


def check_large_scene(bk, ck, build_scene, large, bake_s, scale_rate):
    """28c: the wave box + the 327,680-triangle sphere through
    render_scene at 256x256 x 4 spp, depth 8: K4, K5 and K3 launch, K1
    and K2 do not; paths/s beside the scale cell's; each kernel's ms per
    launch in the render; K3 standalone at this triangle count on POOL
    random cones (its plain version on the first REF_CHUNK // 4). Then the
    same route at a small size on the card and on the CPU, at the wave
    bars: MXU_MAX_TRIS lowered to SMALL_LIMIT and the sphere to 1,280
    triangles (the plain K3 at 327,692 triangles would take the CPU
    side well past two minutes; at 5,120 the CPU side took about a
    minute)."""
    from wave_tracer_tpu_torch.accel import trace as trace_mod
    from wave_tracer_tpu_torch.accel.bvh import tree_depth
    from wave_tracer_tpu_torch.render import render_scene
    geo = large.data.geo
    n_nodes = int(large.arrays["geo.node_left"].shape[0])
    depth = tree_depth(large.arrays["geo.node_left"],
                       large.arrays["geo.node_count"])
    render_scene(large, spp=1, device="cuda")          # warm-up
    zero_counts()
    img, st = render_scene(large, device="cuda")
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches["bvh_closest"] > 0 and launches["bvh_any"] > 0
          and launches["cone_minz"] > 0 and launches["closest"] == 0
          and launches["anyhit"] == 0
          and launches["cone_minz_winners"] == 0,
          f"phase 28c: the large scene launched {launches}")
    check_wave_render(img, st, (256, 256, 3), "phase 28c")
    rate = (rate_line(large, st) if st["seconds"] < 30 else
            f"{st['paths_per_sec']:.1f} paths/s (one render of "
            f"{st['seconds']:.3f} s")
    print(f"phase 28c: wave box + sphere ({geo.num_tris} tris, BVH of "
          f"{n_nodes} nodes, depth {depth}, bake {bake_s:.1f} s) 256x256 4 "
          f"spp depth 8: "
          f"{rate}), launches {launches}; the scale cell (81,932 tris, "
          f"phase 10): {scale_rate}", flush=True)
    calls = timed_bvh_render(bk, ck, large)
    in_render = {k: dict(launches=len(v), ms_per_launch=sum(v) / len(v),
                         ms_max=max(v)) for k, v in calls.items()}
    print("phase 28c: in the render: " + "; ".join(
        f"{k} {v['launches']} launches, {v['ms_per_launch']:.3f} ms per "
        f"launch (max {v['ms_max']:.3f})" for k, v in in_render.items()),
        flush=True)
    # K3 standalone at this triangle count
    from wave_tracer_tpu_torch.integrator.traversal import segment_boundaries
    r = np.random.default_rng(2801)
    N = POOL
    ro, rd = random_rays(geo, N, r)
    xh = np.cross(rd, r.normal(size=(N, 3))).astype(np.float32)
    xh /= np.linalg.norm(xh, axis=-1, keepdims=True)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.asarray(x)).to(geo.p0.device, dtype)

    lam = t(r.uniform(380e-9, 720e-9, N))
    exclude = np.where(r.random(N) < 1 / 3,
                       r.integers(0, geo.num_tris, N), -1)
    args = (geo.cone_tris, t(ro), t(rd), t(xh), t(r.uniform(0.6, 1.0, N)),
            t(r.uniform(0.01, 0.3, N)), t(r.uniform(0.01, 0.2, N)),
            torch.full((N,), float(large.scene.world_radius()),
                       device=geo.p0.device),
            t(exclude, torch.int32), segment_boundaries(lam), 1e-7)
    lanes = REF_CHUNK // 4
    ms3, ms3_plain, cull, _, fin = cone_vs_plain(
        ck, geo, args, f"T={geo.num_tris}", lanes=lanes)
    ops, kept = cone_need(ck, geo.cone_table, args, int(cull[1]))
    b3 = bound(ops, cone_bytes(N, geo.num_tris))
    print(f"phase 28c: N={N} T={geo.num_tris} random cones: K3 bit-equal to "
          f"its plain version on the first {lanes} lanes, finite minima "
          f"{fin:.3f}; {cull_line(cull, N, geo.num_tris, kept)}; K3 "
          f"{ms3:.3f} ms (plain {ms3_plain:.3f} ms on {lanes} lanes), bound "
          f"{b3[0]:.3f} ms ({b3[1]})", flush=True)
    k3 = dict(ms=ms3, plain_ms_subset=ms3_plain, bound_ms=b3[0],
              bound_by=b3[1], in_render=in_render.get("cone_minz"))
    # the route at a small size, card against CPU
    limit = trace_mod.MXU_MAX_TRIS
    trace_mod.MXU_MAX_TRIS = SMALL_LIMIT
    try:
        scene = box_scene(32, 4, 5, icosphere=True, fsd=True,
                          tessellation=SMALL_TESSELLATION)
        small = build_scene(scene, device="cuda")
        check(small.data.geo.num_tris > SMALL_LIMIT
              and small.data.geo.node_pack is not None,
              f"phase 28c: the small scene ({small.data.geo.num_tris} tris) "
              "is not on the BVH route")
        zero_counts()
        img_c, st_c = render_scene(small, device="cuda")
        torch.cuda.synchronize()
        small_launches = launch_counts()
        img_h, st_h = render_scene(small.on("cpu"), device="cpu")
    finally:
        trace_mod.MXU_MAX_TRIS = limit
    check(small_launches["bvh_closest"] > 0 and small_launches["bvh_any"] > 0
          and small_launches["closest"] == 0 and small_launches["anyhit"] == 0,
          f"phase 28c: the small scene launched {small_launches}")
    check(st_c["mode"] == st_h["mode"] == "wave-compact", "phase 28c: mode")
    frac = compare_images(
        img_c, img_h, st_c, st_h, "phase 28c small", mean_rtol=0.02,
        px_tol=1e-2, px_frac=0.90, counter_rtol=0.02, corr=0.999,
        counters=("rays_cast", "surface_interactions", "fsd_interactions",
                  "diffusive_traversals", "sum_path_depth"))
    print(f"phase 28c: wave box + sphere ({small.data.geo.num_tris} tris, "
          f"MXU_MAX_TRIS lowered to {SMALL_LIMIT}) 32x32 4 spp depth 5: cuda "
          f"vs cpu: {frac:.4f} of pixels within the bar", flush=True)
    return dict(launches=launches, paths_per_sec=st["paths_per_sec"],
                seconds=st["seconds"], in_render=in_render, k3=k3,
                bake_s=bake_s, bvh_nodes=n_nodes, bvh_depth=depth,
                small_vs_cpu=frac, small_launches=small_launches)


def check_city(build_scene):
    """28d: the city coverage map (make_city_coverage_scene: 14 x 14
    buildings, more than 2048 wedge edges) at 256x256 x 8, depth 4, UTD:
    every edge sweep of the render takes the clustered sweep; K1 and K2
    launch (2,354 triangles), K4/K5 do not; paths/s; then 32x32 x 4 on
    the card and on the CPU at the coverage bars (phase 15's)."""
    from wave_tracer_tpu_torch.accel import edges as edges_mod
    from wave_tracer_tpu_torch.render import render_scene
    from wave_tracer_tpu_torch.scene.procedural import \
        make_city_coverage_scene
    city = build_scene(make_city_coverage_scene(256), device="cuda")
    E = city.data.edges.count
    check(E > edges_mod.MAX_UNCLUSTERED_EDGES, f"city: {E} edges")
    sweeps = {"clustered": 0, "all_edges": 0}
    fns = (edges_mod.edges_near_cone_clustered, edges_mod.edges_near_cone)

    def counted(fn, key):
        def wrapper(*a, **k):
            sweeps[key] += 1
            return fn(*a, **k)
        return wrapper

    edges_mod.edges_near_cone_clustered = counted(fns[0], "clustered")
    edges_mod.edges_near_cone = counted(fns[1], "all_edges")
    try:
        render_scene(city, spp=1, device="cuda")       # warm-up
        zero_counts()
        sweeps.update(clustered=0, all_edges=0)
        img, st = render_scene(city, device="cuda")
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        (edges_mod.edges_near_cone_clustered,
         edges_mod.edges_near_cone) = fns
    check(launches["closest"] > 0 and launches["anyhit"] > 0
          and launches["bvh_closest"] == 0 and launches["bvh_any"] == 0,
          f"phase 28d: the city launched {launches}")
    check(sweeps["clustered"] > 0 and sweeps["all_edges"] == 0,
          f"phase 28d: edge sweeps {sweeps}")
    sensor = city.scene.sensors[0]
    check(st["mode"] == "forward-wave"
          and img.shape == (sensor.height, sensor.width, 1)
          and np.isfinite(img).all(), f"phase 28d: {st['mode']} {img.shape}")
    lit = (img > 0).mean()
    check(lit > 0.2, f"phase 28d: {lit:.3f} of the elements lit")
    rate = (rate_line(city, st) if st["seconds"] < 30 else
            f"{st['paths_per_sec']:.1f} paths/s (one render of "
            f"{st['seconds']:.3f} s")
    print(f"phase 28d: city coverage ({city.data.geo.num_tris} tris, {E} "
          f"edges, {city.data.edge_clusters.num_clusters} clusters) 256x256 "
          f"8 spe depth 4 plt_path (UTD): {rate}, batch {st['pool_lanes']} x "
          f"{st['batches']}), launches {launches}, clustered sweeps "
          f"{sweeps['clustered']}, lit {lit:.3f}", flush=True)
    small = build_scene(make_city_coverage_scene(32), device="cuda")
    img_c, _ = render_scene(small, spp=4, device="cuda", pool_lanes=4096)
    img_h, _ = render_scene(small.on("cpu"), spp=4, device="cpu",
                            pool_lanes=4096)
    m, c, f, r = compare_maps(img_c, img_h, "phase 28d")
    print(f"phase 28d: city 32x32 4 spe depth 4: cuda vs cpu: median ratio "
          f"{m:.6f}, dB Pearson {c:.5f}, {f:.4f} of elements within 0.1 dB, "
          f"means' ratio {r:.4f}", flush=True)
    return dict(launches=launches, paths_per_sec=st["paths_per_sec"],
                edges=E, clustered_sweeps=sweeps["clustered"],
                vs_cpu=dict(median_ratio=m, db_pearson=c, share=f))


KERNELS = ("closest", "anyhit", "cone_minz")    # K1, K2, K3's counts


# ---- phase 29: the JAX package's other cone queries (WT_CONE_QUERY), the
# triangle clusters, the clustered ball query and the threefry sampler

CONE_QUERIES = ("topk", "2pass", "clustered")
QUERY_CONES = 4096
# cones the CPU side checks per query: the exact all-triangles test of
# topk takes about 18 s for 128 cones there, the 2-pass pretest about 1 s
# for 512
CPU_CONES = {"topk": 64, "2pass": 512, "clustered": QUERY_CONES}
CLUSTER_MIN_LOW = 1024      # WT_TRI_CLUSTER_MIN of the clustered-ball check


class env_var:
    """Set (value) or unset (None) an environment variable for a block,
    restoring it after."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        import os
        self.prev = os.environ.get(self.name)
        if self.value is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.value

    def __exit__(self, *exc):
        import os
        if self.prev is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.prev


def query_cones(N, seed, center, radius):
    """tests/test_trace.py's cone generator about a sphere (center,
    radius): origins at 3 radii, aimed within half a radius of its
    centre, x0 in [0.005, 0.05]·radius, ta in [0, 0.08]."""
    r = np.random.default_rng(seed)
    ro = r.normal(size=(N, 3))
    ro = center + 3.0 * radius * ro / np.linalg.norm(ro, axis=1,
                                                     keepdims=True)
    rd = center + 0.5 * radius * r.normal(size=(N, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    x = np.cross(rd, [0.0, 0.57, 0.8])
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cols = (ro, rd, x, r.uniform(0.005, 0.05, N) * radius,
            r.uniform(0.0, 0.08, N), np.ones(N))
    return [np.asarray(c, np.float32) for c in cols]


def run_query(name, data, cols, dev, K):
    from wave_tracer_tpu_torch.accel import trace as trace_mod
    from wave_tracer_tpu_torch.wave.envelope import EnvState
    ro, rd, x, x0, ta, e = (torch.from_numpy(c).to(dev) for c in cols)
    env = EnvState(x=x, x0=x0, ta=ta, e=e)
    zmax = torch.full((ro.shape[0],), 10.0, device=dev)
    if name == "clustered":
        return trace_mod.tris_near_cone_clustered(
            data.geo, data.tri_clusters, ro, rd, env, zmax, K)
    fn = {"topk": trace_mod.tris_near_cone,
          "2pass": trace_mod.tris_near_cone_2pass}[name]
    return fn(data.geo, ro, rd, env, zmax, K)


def check_query_vs_cpu(name, got, want, tag):
    """Slots equal on >= 99.5%, z within 1e-5 relative where they do."""
    gi, gz, gc = (x.cpu().numpy() for x in got)
    wi, wz, wc = (x.numpy() for x in want)
    slots = (gi == wi).mean()
    check(slots >= 0.995 and (gc == wc).mean() >= 0.995,
          f"{tag} {name}: slots {slots:.5f}, counts "
          f"{(gc == wc).mean():.5f}")
    same = (gi == wi) & (wi >= 0)
    rel = np.abs(gz[same] - wz[same]) / np.maximum(np.abs(wz[same]), 1e-30)
    check(rel.size == 0 or rel.max() <= 1e-5,
          f"{tag} {name}: z rel {rel.max() if rel.size else 0:.3g}")
    return float(slots), float(rel.max()) if rel.size else 0.0


def check_queries(wbig, cpu):
    """29a: the three cone set queries and the clustered ball query over
    the scale scene (81,932 triangles) on QUERY_CONES seeded cones about
    the icosphere, card against the port's CPU (CPU_CONES of them), with
    CUDA-event ms per call beside K3's minima on the same cones."""
    from wave_tracer_tpu_torch.accel import trace as trace_mod
    from wave_tracer_tpu_torch.integrator.path_compact import FSD_SLOTS
    from wave_tracer_tpu_torch.integrator.traversal import segment_boundaries
    from wave_tracer_tpu_torch.wave.envelope import EnvState
    center, radius = np.array([2.78, 1.2, 2.78]), 0.9
    cols = query_cones(QUERY_CONES, 2900, center, radius)
    data = wbig.data
    out = {}
    for name in CONE_QUERIES:
        got = run_query(name, data, cols, "cuda", FSD_SLOTS)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: run_query(name, data, cols, "cuda", FSD_SLOTS),
                     3)
        n = CPU_CONES[name]
        t0 = time.perf_counter()
        want = run_query(name, cpu, [c[:n] for c in cols], "cpu", FSD_SLOTS)
        cpu_s = time.perf_counter() - t0
        slots, rel = check_query_vs_cpu(
            name, [x[:n] for x in got], want, "phase 29a")
        hits = int(got[2].sum().item())
        check(hits > QUERY_CONES, f"phase 29a {name}: {hits} encounters")
        out[name] = dict(ms=ms, cpu_cones=n, cpu_s=cpu_s, slots_equal=slots,
                         z_rel_max=rel, encounters=hits)
    # K3's per-boundary minima on the same cones (the default query)
    ro, rd, x, x0, ta, e = (torch.from_numpy(c).cuda() for c in cols)
    env = EnvState(x=x, x0=x0, ta=ta, e=e)
    zmax = torch.full((QUERY_CONES,), 10.0, device="cuda")
    bounds = segment_boundaries(torch.full((QUERY_CONES,), 5e-7,
                                           device="cuda"))
    out["k3_minima_ms"] = cuda_ms(lambda: trace_mod.cone_boundary_minz(
        data.geo, ro, rd, env, bounds, zmax), 3)
    # the clustered ball query: balls about points near the icosphere
    r = np.random.default_rng(2901)
    u = r.normal(size=(QUERY_CONES, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    c = (center + radius * u * r.uniform(0.9, 1.1, (QUERY_CONES, 1))
         ).astype(np.float32)
    rad = (radius * r.uniform(0.02, 0.3, QUERY_CONES)).astype(np.float32)

    def ball(d, dev):
        return trace_mod.tris_in_ball_clustered(
            d.geo, d.tri_clusters, torch.from_numpy(c).to(dev),
            torch.from_numpy(rad).to(dev), 8)
    got = ball(data, "cuda")
    ms = cuda_ms(lambda: ball(data, "cuda"), 3)
    want = ball(cpu, "cpu")
    gi, gd, gc = (x.cpu().numpy() for x in got)
    wi, wd, wc = (x.numpy() for x in want)
    check((gi == wi).mean() >= 0.995 and (gc == wc).mean() >= 0.995
          and wc.sum() > QUERY_CONES,
          f"phase 29a ball: ids {(gi == wi).mean():.5f}, counts "
          f"{(gc == wc).mean():.5f}, {wc.sum()} found")
    out["ball_clustered"] = dict(ms=ms, ids_equal=float((gi == wi).mean()),
                                 found=int(wc.sum()))
    print(f"phase 29a: N={QUERY_CONES} cones over {data.geo.num_tris} tris "
          f"({data.tri_clusters.num_clusters} clusters), ms per call: "
          + ", ".join(f"{k} {out[k]['ms']:.3f}" for k in CONE_QUERIES)
          + f"; K3 minima {out['k3_minima_ms']:.3f}; ball (clustered) "
          f"{out['ball_clustered']['ms']:.3f}. Card vs CPU: "
          + ", ".join(f"{k} on {out[k]['cpu_cones']} cones slots "
                      f"{out[k]['slots_equal']:.4f} (z rel "
                      f"{out[k]['z_rel_max']:.2g}, CPU {out[k]['cpu_s']:.1f} s)"
                      for k in CONE_QUERIES)
          + f"; ball ids {out['ball_clustered']['ids_equal']:.4f}",
          flush=True)
    return out


def mode_render(built, mode, spp=None, device="cuda"):
    """render_scene under WT_CONE_QUERY=mode, its launches counted."""
    from wave_tracer_tpu_torch.render import render_scene
    with env_var("WT_CONE_QUERY", mode or None):
        zero_counts()
        img, st = render_scene(built, spp=spp, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return img, st, launch_counts()


def check_mode_launches(mode, launches, tag):
    set_query = mode in CONE_QUERIES
    check(launches["closest"] > 0 and launches["anyhit"] > 0
          and (launches["cone_minz"] == 0) == set_query
          and launches["cone_minz_winners"] == 0
          and launches["bvh_closest"] == launches["bvh_any"] == 0,
          f"{tag} {mode or 'default'}: launched {launches}")


WAVE_BARS = dict(mean_rtol=0.02, px_tol=1e-2, px_frac=0.90,
                 counter_rtol=0.02, corr=0.999,
                 counters=("rays_cast", "surface_interactions",
                           "fsd_interactions", "diffusive_traversals",
                           "sum_path_depth", "cone_tri_tests"))


def check_mode_renders(build_scene, wbox, wbig):
    """29b: the full-width wave box (256x256 x 8 spp, depth 8) under each
    mode (one render each), and at 64x64 x 1 spp, depth 5, card vs CPU at
    the wave bars; 29c: the scale scene at 256x256 x 1 spp, depth 8,
    under clustered and 2pass beside K3's default render of the same
    lanes."""
    out, launches = {}, {}
    small = build_scene(box_scene(64, 1, 5, fsd=True), device="cuda")
    small_cpu = small.on("cpu")
    for mode in CONE_QUERIES + ("mxu",):
        img, st, n = mode_render(wbox, mode)
        check_wave_render(img, st, (256, 256, 3), f"phase 29b {mode}")
        check_mode_launches(mode, n, "phase 29b")
        img_c, st_c, _ = mode_render(small, mode)
        img_h, st_h, _ = mode_render(small_cpu, mode, device="cpu")
        frac = compare_images(img_c, img_h, st_c, st_h, f"phase 29b {mode}",
                              **WAVE_BARS)
        out[f"wave_{mode}"] = dict(paths_per_sec=st["paths_per_sec"],
                                   seconds=st["seconds"],
                                   vs_cpu_64=float(frac))
        launches[f"wave_{mode}"] = n
    print("phase 29b: wave box 256x256 8 spp depth 8 (one render each): "
          + ", ".join(f"{k[5:]} {v['paths_per_sec']:.1f} paths/s"
                      for k, v in out.items())
          + "; 64x64 1 spp depth 5 cuda vs cpu within the wave bars: "
          + ", ".join(f"{k[5:]} {v['vs_cpu_64']:.4f}"
                      for k, v in out.items()), flush=True)
    for mode in ("", "clustered", "2pass"):
        img, st, n = mode_render(wbig, mode, spp=1)
        check_wave_render(img, st, (256, 256, 3), f"phase 29c {mode}")
        check_mode_launches(mode, n, "phase 29c")
        key = f"scale_{mode or 'k3'}"
        out[key] = dict(paths_per_sec=st["paths_per_sec"],
                        seconds=st["seconds"],
                        diffusive=st["device_counters"][
                            "diffusive_traversals"])
        launches[key] = n
    print("phase 29c: wave box + icosphere (81,932 tris) 256x256 1 spp "
          "depth 8: " + ", ".join(
              f"{k[6:]} {out[k]['paths_per_sec']:.1f} paths/s "
              f"({out[k]['seconds']:.3f} s, diffusive "
              f"{out[k]['diffusive']:.0f})"
              for k in ("scale_k3", "scale_clustered", "scale_2pass")),
          flush=True)
    return out, launches


def check_threefry(build_scene, wbox):
    """29d: WT_SAMPLER=uniform: the threefry words and uniform draws of
    POOL lanes bit-equal card vs CPU, the wave box at 32x32 x 4 spp,
    depth 5, card vs CPU at the wave bars, and at full width (one
    render)."""
    from wave_tracer_tpu_torch.sampling import rng
    with env_var("WT_SAMPLER", "uniform"):
        r = np.random.default_rng(2910)
        pix = torch.from_numpy(r.integers(0, 65536, POOL))
        sid = torch.from_numpy(r.integers(0, 8, POOL))
        depth = torch.from_numpy(r.integers(0, 8, POOL))
        base = rng.make_base_key(0)
        check(isinstance(base, tuple), f"phase 29d: base key {base}")
        draws = {}
        for dev in ("cuda", "cpu"):
            s = rng.depth_key_v(rng.sample_key(base, pix.to(dev),
                                               sid.to(dev)), depth.to(dev))
            draws[dev] = [s["key"].cpu(), rng.uniform(s, rng.D_RR).cpu(),
                          rng.uniform(s, rng.D_FSD, 34).cpu()]
        for a, b in zip(draws["cuda"], draws["cpu"]):
            check(torch.equal(a, b), "phase 29d: threefry draws differ "
                  "card vs CPU")
        small = build_scene(box_scene(32, 4, 5, fsd=True), device="cuda")
        img_c, st_c, _ = mode_render(small, None)
        img_h, st_h, _ = mode_render(small.on("cpu"), None, device="cpu")
        frac = compare_images(img_c, img_h, st_c, st_h, "phase 29d",
                              **WAVE_BARS)
        img, st, n = mode_render(wbox, None)
    check_wave_render(img, st, (256, 256, 3), "phase 29d")
    check_mode_launches("", n, "phase 29d")
    out = dict(paths_per_sec=st["paths_per_sec"], seconds=st["seconds"],
               vs_cpu_32=float(frac))
    print(f"phase 29d: WT_SAMPLER=uniform: {POOL} lanes' keys and draws "
          f"bit-equal card vs CPU; wave box 32x32 4 spp depth 5 cuda vs "
          f"cpu {frac:.4f} of pixels within the bar; 256x256 8 spp depth "
          f"8: {st['paths_per_sec']:.1f} paths/s (one render)", flush=True)
    return out, n


def check_clustered_ball(build_scene):
    """29e: the bdpt box with a 1,280-triangle icosphere inside it at
    32x32 x 4 spp, depth 5, with WT_TRI_CLUSTER_MIN lowered to 1,024: the
    blocked-flux ball query takes the clustered index on the card and on
    the CPU (its calls counted), card vs CPU at phase 13's bdpt bars."""
    from wave_tracer_tpu_torch.accel import trace as trace_mod
    from wave_tracer_tpu_torch.geometry import mesh
    from wave_tracer_tpu_torch.scene.model import Shape
    scene = bdpt_scene(32, 4, 5)
    scene.shapes.append(Shape(mesh.sphere([0.3, 0.6, -0.2], 0.4,
                                          tessellation=24),
                              scene.shapes[0].material))
    built = build_scene(scene, device="cuda")
    check(built.data.geo.num_tris == 1292,
          f"phase 29e: {built.data.geo.num_tris} tris")
    calls = {"cuda": 0, "cpu": 0}
    real = trace_mod.tris_in_ball_clustered

    def spy(geo, *a, **kw):
        calls[geo.p0.device.type] += 1
        return real(geo, *a, **kw)

    trace_mod.tris_in_ball_clustered = spy
    try:
        with env_var("WT_TRI_CLUSTER_MIN", str(CLUSTER_MIN_LOW)):
            img_c, st_c, n = mode_render(built, None)
            img_h, st_h, _ = mode_render(built.on("cpu"), None,
                                         device="cpu")
    finally:
        trace_mod.tris_in_ball_clustered = real
    check(calls["cuda"] > 0 and calls["cpu"] > 0,
          f"phase 29e: clustered ball calls {calls}")
    check(st_c["mode"] == st_h["mode"] == "bdpt", "phase 29e: mode")
    frac = compare_images(
        img_c, img_h, st_c, st_h, "phase 29e", mean_rtol=0.02, px_tol=1e-2,
        px_frac=0.90, counter_rtol=0.02, corr=0.999,
        counters=("rays_cast", "surface_interactions", "fsd_interactions",
                  "sum_path_depth", "shadow_rays"))
    for k, rtol in (("edge_sweep_hits", 0.08), ("null_interactions", 0.18)):
        a, b = st_c["device_counters"][k], st_h["device_counters"][k]
        check(abs(a - b) <= rtol * max(b, 1.0),
              f"phase 29e: counter {k} {a} vs {b}")
    print(f"phase 29e: bdpt box + icosphere (1,292 tris) 32x32 4 spp depth "
          f"5, WT_TRI_CLUSTER_MIN={CLUSTER_MIN_LOW}: clustered ball calls "
          f"{calls}; cuda vs cpu {frac:.4f} of pixels within the bar; "
          f"launches {n}", flush=True)
    return dict(vs_cpu_32=float(frac), clustered_calls=calls), n


def tri_cluster_bake_s(built):
    """Host seconds of the triangle-cluster bake of `built`'s tables."""
    from wave_tracer_tpu_torch.accel import trace as trace_mod
    a = built.arrays
    t0 = time.perf_counter()
    trace_mod.build_tri_clusters(a["geo.p0"], a["geo.e1"], a["geo.e2"],
                                 cap=trace_mod.TRI_CAP)
    return time.perf_counter() - t0


def check_phase29(build_scene, wbox, wbig, large):
    """Phase 29 (a)-(e); returns (readings, launches by path)."""
    t0 = time.perf_counter()
    bake = {"scale_81932": tri_cluster_bake_s(wbig),
            "large_327692": tri_cluster_bake_s(large)}
    print(f"phase 29: the triangle-cluster bake: "
          f"{bake['scale_81932']:.2f} s at 81,932 tris, "
          f"{bake['large_327692']:.2f} s at 327,692", flush=True)
    cpu = wbig.on("cpu").data
    out = dict(tri_cluster_bake_s=bake, queries=check_queries(wbig, cpu))
    del cpu
    renders, launches = check_mode_renders(build_scene, wbox, wbig)
    out["renders"] = renders
    out["threefry"], launches["wave_threefry"] = check_threefry(build_scene,
                                                                wbox)
    out["clustered_ball"], launches["bdpt_clustered_ball"] = \
        check_clustered_ball(build_scene)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 29: {out['seconds']:.1f} s", flush=True)
    return out, launches


# ---- phase 30: the JAX package's last switches: WT_TRACE_BACKEND's brute
# and BVH routes below 2^17 triangles (K4/K5 at any size), WT_COMPACT_MODE
# and WT_COMPACT_LANES

CLASSICAL_BARS = dict(mean_rtol=0.01, px_tol=1e-3, px_frac=0.98,
                      counter_rtol=0.005,
                      counters=("rays_cast", "shadow_rays",
                                "surface_interactions", "rr_terminations",
                                "sum_path_depth"))
# the route switch's override paths: the only ones on which K4/K5 may
# launch below 2^17 triangles
BVH_OVERRIDE_PATHS = ("route_classical_scale_bvh", "route_classical_64_bvh",
                      "route_wave_scale_bvh")
LANES_CAP = 16384           # WT_COMPACT_LANES of 30d
# 30d's bars: the wave bars over the counters a pool's width cannot move
# (the wave bounce counts surface and FSD interactions and cone tests over
# every lane of the pool, idle ones included)
LANE_BARS = dict(WAVE_BARS, counters=("rays_cast", "rr_terminations",
                                      "sum_path_depth", "edge_sweep_hits",
                                      "diffusive_traversals"))


def route_render(built, backend, spp=None, device="cuda", **kw):
    """render_scene's outputs under WT_TRACE_BACKEND=backend (None:
    unset), then its launches counted from zero."""
    from wave_tracer_tpu_torch.render import render_scene
    with env_var("WT_TRACE_BACKEND", backend):
        zero_counts()
        out = render_scene(built, spp=spp, device=device, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        return (*out, launch_counts())


def route_rate(built, backend, st):
    """rate_line under WT_TRACE_BACKEND=backend."""
    with env_var("WT_TRACE_BACKEND", backend):
        return rate_line(built, st)


def check_routes(rk, bk, ck, build_scene, big, bbig, bake_s, wbig, card):
    """30a: the classical scale scene (81,932 triangles) at 256x256 x 8
    spp, depth 8, with the variable unset (K1/K2, the default bake: the
    user's path) and with the bake and the render under
    WT_TRACE_BACKEND=bvh (K4/K5 over a BVH of the same triangles); each
    one's paths/s (median of three), launches and the CUDA-event ms per
    launch of each ray kernel in its render. The bvh render's image is
    held at the classical bars against the default route's render of the
    same bake (the tree's leaf order is a triangle order of its own, and
    NEE picks a lamp triangle by its row, so only one bake gives the same
    draws); then the bvh bake at 64x64 x 4 spp, card against CPU (the
    twins), at the classical bars. 30b: the wave scale scene at 256x256 x
    1 spp, depth 8, under bvh beside the default: K3's launches equal,
    K4/K5 in place of K1/K2. `bbig` is the classical scale cell baked
    under bvh (phase 28b), in `bake_s` seconds."""
    out, launches = {}, {}
    img_d, st_d, n = route_render(big, None)
    check(n["closest"] > 0 and n["anyhit"] > 0 and n["bvh_closest"] == 0
          and n["bvh_any"] == 0, f"phase 30a default: launched {n}")
    check_render(img_d, st_d, (256, 256, 3), "phase 30a default")
    launches["route_classical_scale_default"] = n
    rate_d = route_rate(big, None, st_d)
    calls = summarize_calls(rk, timed_render(rk, ck, big)[0], 81932,
                            "phase 30a default")
    geo = bbig.data.geo
    check(geo.num_tris == 81932 and geo.node_pack is not None
          and geo.ray_table is not None,
          "phase 30a: the bvh bake has no tree or no K1/K2 tables")
    route_render(bbig, "bvh", spp=1)                   # warm-up
    img_b, st_b, n = route_render(bbig, "bvh")
    check(n["bvh_closest"] > 0 and n["bvh_any"] > 0 and n["closest"] == 0
          and n["anyhit"] == 0 and n["cone_minz"] == 0,
          f"phase 30a bvh: launched {n}")
    check_render(img_b, st_b, (256, 256, 3), "phase 30a bvh")
    launches["route_classical_scale_bvh"] = n
    rate_b = route_rate(bbig, "bvh", st_b)
    with env_var("WT_TRACE_BACKEND", "bvh"):
        bcalls = timed_bvh_render(bk, ck, bbig)
    in_bvh = {k: dict(launches=len(v), ms_per_launch=sum(v) / len(v),
                      ms_max=max(v)) for k, v in bcalls.items()}
    img_s, st_s, n = route_render(bbig, None)
    launches["route_classical_scale_bvh_bake_default"] = n
    frac = compare_images(img_b, img_s, st_b, st_s, "phase 30a bvh vs K1",
                          **CLASSICAL_BARS)
    mean_rel = float(np.abs(img_b.mean() / img_d.mean() - 1.0))
    print(f"phase 30a: classical box + icosphere (81,932 tris) 256x256 8 "
          f"spp depth 8 [{card}]: default (K1/K2) {rate_d}); bvh (K4/K5, "
          f"bake {bake_s:.2f} s, {geo.node_pack.shape[0]} nodes) {rate_b}); "
          f"bvh vs K1/K2 on the same bake: {frac:.4f} of pixels within the "
          f"classical bar; image mean vs the default bake's {mean_rel:.4f}",
          flush=True)
    print("phase 30a: ms per launch in the render: default "
          + "; ".join(f"{k} {v['launches']} x {v['ms_per_launch']:.3f}"
                      for k, v in calls.items())
          + "; bvh " + "; ".join(
              f"{k} {v['launches']} x {v['ms_per_launch']:.3f}"
              for k, v in in_bvh.items()), flush=True)
    out["classical_scale"] = dict(
        default=dict(paths_per_sec=st_d["paths_per_sec"], rate=rate_d,
                     in_render=calls),
        bvh=dict(paths_per_sec=st_b["paths_per_sec"], rate=rate_b,
                 in_render=in_bvh, bake_s=bake_s,
                 bvh_nodes=int(geo.node_pack.shape[0])),
        bvh_vs_k1_same_bake=float(frac), mean_vs_default_bake=mean_rel)
    with env_var("WT_TRACE_BACKEND", "bvh"):
        small = build_scene(box_scene(64, 4, 8, icosphere=True),
                            device="cuda")
    img_c, st_c, n = route_render(small, "bvh")
    check(n["bvh_closest"] > 0 and n["closest"] == 0,
          f"phase 30a 64x64: launched {n}")
    launches["route_classical_64_bvh"] = n
    t0 = time.perf_counter()
    img_h, st_h, _ = route_render(small.on("cpu"), "bvh", device="cpu")
    cpu_s = time.perf_counter() - t0
    frac = compare_images(img_c, img_h, st_c, st_h, "phase 30a 64x64",
                          **CLASSICAL_BARS)
    out["classical_64_vs_cpu"] = float(frac)
    print(f"phase 30a: bvh 64x64 4 spp depth 8: cuda vs cpu (the twins, "
          f"{cpu_s:.1f} s): {frac:.4f} of pixels within the bar", flush=True)
    # 30b: the wave scale scene at 1 spp
    img_d, st_d, nd = route_render(wbig, None, spp=1)
    with env_var("WT_TRACE_BACKEND", "bvh"):
        bwbig = build_scene(box_scene(256, 4, 8, icosphere=True, fsd=True),
                            device="cuda")
    route_render(bwbig, "bvh", spp=1)                  # warm-up
    img_b, st_b, nb = route_render(bwbig, "bvh", spp=1)
    check_wave_render(img_b, st_b, (256, 256, 3), "phase 30b bvh")
    check(nb["cone_minz"] == nd["cone_minz"] > 0 and nb["closest"] == 0
          and nb["anyhit"] == 0 and nb["bvh_closest"] > 0
          and nb["bvh_any"] > 0 and nd["closest"] > 0 and nd["anyhit"] > 0
          and nd["bvh_closest"] == nd["bvh_any"] == 0,
          f"phase 30b: launched {nb}, by default {nd}")
    launches["route_wave_scale_default"] = nd
    launches["route_wave_scale_bvh"] = nb
    out["wave_scale_1spp"] = dict(
        default=st_d["paths_per_sec"], bvh=st_b["paths_per_sec"])
    print(f"phase 30b: wave box + icosphere (81,932 tris) 256x256 1 spp "
          f"depth 8 [{card}]: default {st_d['paths_per_sec']:.1f} paths/s, "
          f"bvh {st_b['paths_per_sec']:.1f} paths/s (one render each); "
          f"launches {nb}", flush=True)
    return out, launches


def check_brute_sphere(build_scene, card):
    """30c, the brute route at its width: the wave box with the
    1,280-triangle icosphere (1,292 triangles, bench.py's sphere) under
    WT_TRACE_BACKEND=brute at 256x256 x 8 spp, depth 8 (two fills of the
    2^18-lane pool; the FSD legs' any-hit queries test millions of
    segments against every triangle, in row slices): K1, K2, K4 and K5
    launch 0 times, K3 does; paths/s of one render; at 64x64 x 1 spp,
    depth 5, card vs CPU at the wave bars."""
    out, launches = {}, {}
    sphere = build_scene(box_scene(256, 8, 8, icosphere=True, fsd=True,
                                   tessellation=SMALL_TESSELLATION),
                         device="cuda")
    check(sphere.data.geo.num_tris == 1292,
          f"phase 30c sphere: {sphere.data.geo.num_tris} triangles")
    torch.cuda.reset_peak_memory_stats()
    img, st, n = route_render(sphere, "brute")
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_wave_render(img, st, (256, 256, 3), "phase 30c sphere")
    check(n["closest"] == n["anyhit"] == n["bvh_closest"] == n["bvh_any"]
          == 0 and n["cone_minz"] > 0, f"phase 30c sphere: launched {n}")
    launches["route_wave_sphere_brute"] = n
    small = build_scene(box_scene(64, 1, 5, icosphere=True, fsd=True,
                                  tessellation=SMALL_TESSELLATION),
                        device="cuda")
    img_c, st_c, n = route_render(small, "brute")
    launches["route_wave_sphere_64_brute"] = n
    t0 = time.perf_counter()
    img_h, st_h, _ = route_render(small.on("cpu"), "brute", device="cpu")
    cpu_s = time.perf_counter() - t0
    frac = compare_images(img_c, img_h, st_c, st_h, "phase 30c sphere 64x64",
                          **WAVE_BARS)
    out["wave_sphere_brute"] = dict(
        paths_per_sec=st["paths_per_sec"], seconds=st["seconds"],
        peak_gib=peak, vs_cpu_64=float(frac), cpu_64_s=cpu_s)
    print(f"phase 30c: wave box + icosphere (1,292 tris) 256x256 8 spp "
          f"depth 8 under brute [{card}]: {st['paths_per_sec']:.1f} paths/s "
          f"(one render, {st['seconds']:.3f} s, peak {peak:.2f} GiB "
          f"allocated); 64x64 1 spp depth 5 cuda vs cpu ({cpu_s:.1f} s): "
          f"{frac:.4f} of pixels within the wave bar", flush=True)
    return out, launches


def check_brute_and_pool(build_scene, wbox, wave_launches, card):
    """30c: the wave box (12 triangles) under WT_TRACE_BACKEND=brute at
    256x256 x 8 spp, depth 8: K1, K2, K4 and K5 launch 0 times, K3 as by
    default; paths/s (median of three); at 64x64 x 1 spp, depth 5, card
    vs CPU at the wave bars; then check_brute_sphere. 30d:
    WT_COMPACT_LANES=LANES_CAP on the wave box at 64x64 x 8 spp: the stats
    report the capped width, the image within the wave bars of the
    default width's (LANE_BARS)."""
    out, launches = {}, {}
    img, st, n = route_render(wbox, "brute")
    check_wave_render(img, st, (256, 256, 3), "phase 30c")
    check(n["closest"] == n["anyhit"] == n["bvh_closest"] == n["bvh_any"]
          == n["cone_minz_winners"] == 0
          and n["cone_minz"] == wave_launches["cone_minz"],
          f"phase 30c: launched {n}")
    launches["route_wave_box_brute"] = n
    rate = route_rate(wbox, "brute", st)
    small = build_scene(box_scene(64, 1, 5, fsd=True), device="cuda")
    img_c, st_c, n = route_render(small, "brute")
    launches["route_wave_64_brute"] = n
    img_h, st_h, _ = route_render(small.on("cpu"), "brute", device="cpu")
    frac = compare_images(img_c, img_h, st_c, st_h, "phase 30c 64x64",
                          **WAVE_BARS)
    out["wave_box_brute"] = dict(paths_per_sec=st["paths_per_sec"],
                                 rate=rate, vs_cpu_64=float(frac))
    print(f"phase 30c: wave box 256x256 8 spp depth 8 under brute "
          f"[{card}]: {rate}); 64x64 1 spp depth 5 cuda vs cpu: {frac:.4f} "
          f"of pixels within the wave bar", flush=True)
    more, l2 = check_brute_sphere(build_scene, card)
    out.update(more)
    launches.update(l2)
    lanes = build_scene(box_scene(64, 8, 8, fsd=True), device="cuda")
    img_d, st_d, _ = route_render(lanes, None)
    with env_var("WT_COMPACT_LANES", str(LANES_CAP)):
        img_l, st_l, n = route_render(lanes, None)
    launches["compact_lanes_16384"] = n
    check(st_d["pool_lanes"] == 64 * 64 * 8 and st_l["pool_lanes"]
          == LANES_CAP, f"phase 30d: pool {st_d['pool_lanes']} and "
          f"{st_l['pool_lanes']}")
    frac = compare_images(img_l, img_d, st_l, st_d, "phase 30d", **LANE_BARS)
    out["compact"] = dict(lanes_cap=LANES_CAP, lanes_vs_default=float(frac))
    print(f"phase 30d: WT_COMPACT_LANES={LANES_CAP}: pool "
          f"{st_l['pool_lanes']} (default {st_d['pool_lanes']}), "
          f"{frac:.4f} of pixels within the wave bar", flush=True)
    return out, launches


def check_phase30(rk, bk, ck, build_scene, big, bbig, bake_s, wbox, wbig,
                  wave_launches, card):
    """Phase 30 (a)-(d); returns (readings, launches by path)."""
    t0 = time.perf_counter()
    out, launches = check_routes(rk, bk, ck, build_scene, big, bbig, bake_s,
                                 wbig, card)
    more, l2 = check_brute_and_pool(build_scene, wbox, wave_launches, card)
    out.update(more)
    launches.update(l2)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 30: {out['seconds']:.1f} s", flush=True)
    return out, launches


def each_launched(counts):
    """K1, K2 and K3 each launched in the run that `counts` read (K3's
    winner build is counted apart as well, under cone_minz_winners)."""
    return all(counts[k] > 0 for k in KERNELS)


def plain_launched(counts):
    """each_launched, and K3 always through its build without winners:
    a render with no derivative in play."""
    return each_launched(counts) and counts["cone_minz_winners"] == 0


def zero(*counts):
    for c in counts:
        for k in c:
            c[k] = 0


def launch_counts():
    """Every kernel's launch count: K1/K2, K3 (and its winner build apart),
    K4/K5."""
    from wave_tracer_tpu_torch.accel import (bvh_kernels, cone_kernels,
                                             ray_kernels)
    return dict(ray_kernels.LAUNCHES, **cone_kernels.LAUNCHES,
                **bvh_kernels.LAUNCHES)


def zero_counts():
    """Every kernel's launch count set to 0."""
    from wave_tracer_tpu_torch.accel import (bvh_kernels, cone_kernels,
                                             ray_kernels)
    zero(ray_kernels.LAUNCHES, cone_kernels.LAUNCHES, bvh_kernels.LAUNCHES)


def main():
    t_start = time.perf_counter()
    # ---- phase 1
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from wave_tracer_tpu_torch.accel import bvh_kernels as bk
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
    nvcc_build.build("ray_kernels", "cone_kernels", "bvh_kernels")
    rk.build()
    ck.build()
    bk.build()
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
    zero_counts()
    img, st = render_scene(built, device="cuda")
    torch.cuda.synchronize()
    classical_launches = launch_counts()
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
    zero_counts()
    img8, st8 = render_scene(wbox, device="cuda")
    torch.cuda.synchronize()
    wave_launches = launch_counts()
    check(plain_launched(wave_launches),
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
    before = launch_counts()
    img10, st10 = render_scene(wbig, device="cuda")
    torch.cuda.synchronize()
    after = launch_counts()
    check(all(after[k] > before[k] for k in KERNELS)
          and after["cone_minz_winners"] == before["cone_minz_winners"],
          f"phase 10 launched {after} after {before}")
    check_wave_render(img10, st10, (256, 256, 3), "phase 10")
    rate10 = rate_line(wbig, st10)
    print(f"phase 10: wave box + icosphere ({wbig.data.geo.num_tris} tris) "
          f"256x256 4 spp depth 8: {rate10})", flush=True)
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
    zero_counts()
    img12, st12 = render_scene(bdpt, device="cuda")
    torch.cuda.synchronize()
    bdpt_launches = launch_counts()
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
    zero_counts()
    img14, st14 = render_scene(cov, device="cuda")
    torch.cuda.synchronize()
    cov_launches = launch_counts()
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
    zero_counts()
    img14f, st14f = render_scene(covb, device="cuda")
    torch.cuda.synchronize()
    fr_launches = launch_counts()
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

    # ---- phase 16: the materials box through the wave main path
    mat = build_scene(materials_scene(256, 8, 8), device="cuda")
    n_edges = mat.data.edges.count
    check(mat.data.geo.num_tris == 10254,
          f"materials box has {mat.data.geo.num_tris} triangles")
    check(0 < n_edges <= 2048, f"materials box has {n_edges} edges")
    render_scene(mat, spp=1, device="cuda")            # warm-up
    zero_counts()
    img16, st16 = render_scene(mat, device="cuda")
    torch.cuda.synchronize()
    mat_launches = launch_counts()
    check(plain_launched(mat_launches),
          f"materials wave path launched {mat_launches}")
    check_wave_render(img16, st16, (256, 256, 3), "phase 16")
    check(st16["pool_lanes"] == POOL, f"phase 16 pool {st16['pool_lanes']}")
    dc = st16["device_counters"]
    print(f"phase 16: materials box ({mat.data.geo.num_tris} tris, "
          f"{n_edges} classified edges) 256x256 8 spp depth 8 wave: "
          f"{rate_line(mat, st16)}, pool {st16['pool_lanes']}), launches "
          f"{mat_launches}, fsd {dc['fsd_interactions']:.0f}, diffusive "
          f"{dc['diffusive_traversals']:.0f}, edge hits "
          f"{dc['edge_sweep_hits']:.0f}", flush=True)
    calls16, cull16, kept16 = timed_render(rk, ck, mat)
    T16 = mat.data.geo.num_tris
    in_mat = summarize_calls(rk, calls16, T16, "phase 16")
    print(f"phase 16: in the render, K3: "
          f"{cull_line(cull16, in_mat['cone_minz']['rows'], T16, kept16)}"
          f" (over {len(calls16['cone_minz'])} launches)", flush=True)

    # ---- phase 16b: K1, K2 and K3 on the materials render's own calls
    mat_calls = check_calls_vs_plain(rk, ck, capture_calls(
        rk, ck, lambda: render_scene(mat, device="cuda")))

    # ---- phase 17: polarimetric plt_bdpt over the materials box
    matb = build_scene(materials_scene(256, 4, 8, "plt_bdpt", True),
                       device="cuda")
    render_scene(matb, spp=1, device="cuda")           # warm-up
    zero_counts()
    img17, st17 = render_scene(matb, device="cuda")
    torch.cuda.synchronize()
    matb_launches = launch_counts()
    check(matb_launches["closest"] > 0 and matb_launches["anyhit"] > 0,
          f"materials bdpt launched {matb_launches}")
    check_render(img17, st17, (256, 256, 12), "phase 17")
    check(st17["mode"] == "bdpt", f"phase 17: mode {st17['mode']}")
    dop = check_stokes(img17, "phase 17")
    dc = st17["device_counters"]
    check(dc["fsd_interactions"] > 0, f"phase 17: no FSD interactions {dc}")
    rate17 = (rate_line(matb, st17) if st17["seconds"] < 30 else
              f"{st17['paths_per_sec']:.1f} paths/s (one render of "
              f"{st17['seconds']:.3f} s")
    print(f"phase 17: materials box 256x256 4 spp depth 8 polarimetric "
          f"bdpt: {rate17}, batch {st17['pool_lanes']}), launches "
          f"{matb_launches}, fsd {dc['fsd_interactions']:.0f}, polarized "
          f"share |(Q,U,V)|/I {dop:.4f}", flush=True)
    calls17, _, _ = timed_render(rk, ck, matb,
                                 anyhit_kind=lambda n: "anyhit")
    in_matb = summarize_calls(rk, calls17, matb.data.geo.num_tris,
                              "phase 17")

    # ---- phase 18: the materials box, card vs CPU, at the CPU tests' bars
    for integrator, fsd, depth, pol in (("plt_path", False, 5, False),
                                        ("plt_path", True, 5, False),
                                        ("plt_bdpt", True, 4, True)):
        scene = materials_scene(32, 4, depth, integrator, pol)
        scene.integrator.fsd = fsd
        msmall = build_scene(scene, device="cuda")
        img_c, st_c = render_scene(msmall, device="cuda")
        img_h, st_h = render_scene(msmall, device="cpu")
        tag = f"phase 18 {integrator} fsd={fsd}"
        check(st_c["mode"] == st_h["mode"], f"{tag}: mode")
        if not fsd:
            frac = compare_images(
                img_c, img_h, st_c, st_h, tag, mean_rtol=0.01, px_tol=1e-3,
                px_frac=0.98, counter_rtol=0.005,
                counters=("rays_cast", "shadow_rays", "surface_interactions",
                          "rr_terminations", "sum_path_depth"))
        elif integrator == "plt_path":
            frac = compare_images(
                img_c, img_h, st_c, st_h, tag, mean_rtol=0.02, px_tol=1e-2,
                px_frac=0.90, counter_rtol=0.02, corr=0.999,
                counters=("rays_cast", "rr_terminations", "sum_path_depth",
                          "ballistic_traversals", "diffusive_traversals"))
        else:
            check_stokes(img_c, tag)
            frac = compare_images(
                img_c[..., 0::4], img_h[..., 0::4], st_c, st_h, tag,
                mean_rtol=0.02, px_tol=1e-2, px_frac=0.90, counter_rtol=0.02,
                corr=0.999, counters=("rays_cast", "surface_interactions",
                                      "fsd_interactions", "sum_path_depth",
                                      "shadow_rays"))
        print(f"{tag}: 32x32 4 spp depth {depth}: cuda vs cpu: {frac:.4f} "
              f"of pixels within the bar", flush=True)

    # ---- phase 19: both AD modes at full width through K1/K2/K3
    grad_launches, g19 = check_gradients_full(
        rk, ck, build_scene(box_scene(256, 1, 8, fsd=True), device="cuda"),
        build_scene(box_scene(256, 1, 2), device="cuda"))

    # ---- phase 20: the gradient maps, card vs CPU
    check_gradients_vs_cpu(build_scene)

    # ---- phase 21: the batched renderer against the pool's images
    batched = {}
    for tag, b, ref, st_ref, wave in (("wave", wbox, img8, st8, True),
                                      ("classical", built, img, st, False)):
        zero_counts()
        img21, st21 = render_scene(b, device="cuda", compact=False)
        torch.cuda.synchronize()
        batched[tag] = launch_counts()
        check(st21["mode"] == ("wave" if wave else "ray"),
              f"phase 21 {tag}: mode {st21['mode']}")
        check(batched[tag]["closest"] > 0 and batched[tag]["anyhit"] > 0
              and (batched[tag]["cone_minz"] > 0) == wave,
              f"phase 21 {tag}: launched {batched[tag]}")
        if wave:
            frac = compare_images(
                img21, ref, st21, st_ref, "phase 21 wave", mean_rtol=0.02,
                px_tol=1e-2, px_frac=0.90, counter_rtol=0.02, corr=0.999,
                counters=("rays_cast", "rr_terminations", "sum_path_depth",
                          "ballistic_traversals", "diffusive_traversals"))
        else:
            frac = compare_images(
                img21, ref, st21, st_ref, "phase 21 classical",
                mean_rtol=0.01, px_tol=1e-3, px_frac=0.98,
                counter_rtol=0.005,
                counters=("rays_cast", "shadow_rays", "surface_interactions",
                          "rr_terminations", "sum_path_depth"))
        print(f"phase 21: Renderer(compact=False), {tag} box 256x256 "
              f"{st21['paths'] // 65536} spp depth 8: "
              f"{st21['paths_per_sec']:.1f} paths/s ({st21['seconds']:.3f} "
              f"s, batch {st21['pool_lanes']}), {frac:.4f} of pixels within "
              f"the bar of the pool's image; launches {batched[tag]}",
              flush=True)

    # ---- phase 22: scene files and the command line
    cli_launches, mask_launches, cli_calls, cli_out, cli_exr = check_cli(
        rk, ck, card)

    # ---- phase 23: gradients through plt_bdpt at full width
    launches23, g23 = check_gradients_bdpt(
        rk, ck, build_scene(bdpt_scene(256, 1, 8), device="cuda"))
    grad_launches.update(launches23)

    # ---- phase 24: gradients through forward transport at full width
    launches24, g24 = check_gradients_forward(
        rk, ck, build_scene(coverage_scene(256), device="cuda"),
        slit_built(256, build_scene, "cuda"))
    grad_launches.update(launches24)

    # ---- phase 25: the maps of phases 23-24, card vs CPU
    g25 = check_gradient_paths_vs_cpu(build_scene)

    # ---- phase 26: geometry derivatives through K3's winners
    g26 = check_geometry_gradients(rk, ck, build_scene, "cuda")

    # ---- phase 27: rendering across processes
    d27 = check_distributed(rk, ck, build_scene, cli_exr, card)
    extra_launches = {
        "geometry_plain_forward": g26["plain"],
        "geometry_back_wall": g26["back_wall"],
        "geometry_left_wall_slide": g26["left_wall_slide"],
        "distributed_world1": d27["launches_world1"],
        **{f"distributed_{k}": v["launches"] for k, v in d27.items()
           if k.startswith(("gloo_", "nccl_"))}}

    # ---- phase 28: large scenes
    t0 = time.perf_counter()
    large = build_scene(box_scene(256, 4, 8, icosphere=True, fsd=True,
                                  tessellation=LARGE_TESSELLATION),
                        device="cuda")
    bake_s = time.perf_counter() - t0
    check(large.data.geo.num_tris == LARGE_TRIS
          and large.data.geo.node_pack is not None
          and large.data.geo.ray_table is None,
          f"large scene: {large.data.geo.num_tris} tris, not baked for the "
          "BVH route")
    k4, k5 = check_bvh_kernels(bk, large.data.geo, POOL, n_legs, 2800)
    t0 = time.perf_counter()
    with env_var("WT_TRACE_BACKEND", "bvh"):   # the scale cell's BVH bake
        big_bvh = build_scene(box_scene(256, 8, 8, icosphere=True),
                              device="cuda")
    big_bvh_s = time.perf_counter() - t0
    vs_all_pairs = check_bvh_vs_all_pairs(
        bk, rk, big.data.geo, big_bvh.data.geo,
        big_bvh.arrays["geo.tri_order"], POOL, 2802)
    large_out = check_large_scene(bk, ck, build_scene, large, bake_s,
                                  rate10)
    city = check_city(build_scene)
    large_launches = large_out["launches"]

    # ---- phase 29: the other cone queries, the clustered ball query and
    # the threefry sampler
    p29, l29 = check_phase29(build_scene, wbox, wbig, large)
    extra_launches.update(l29)

    # ---- phase 30: WT_TRACE_BACKEND's routes below 2^17 triangles,
    # WT_COMPACT_MODE and WT_COMPACT_LANES
    p30, l30 = check_phase30(rk, bk, ck, build_scene, big, big_bvh,
                             big_bvh_s, wbox, wbig, wave_launches, card)
    extra_launches.update(l30)

    # ---- phase 11
    def row(name, src, replaces, key, stats, main=None, **extra):
        bound_ms, bound_by = stats["bound"]
        return dict(name=name, route="cuda",
                    source=f"wave_tracer_tpu_torch/csrc/{src}",
                    replaces=replaces,
                    launches=(main or wave_launches)[key],
                    launches_by_path={"wave": wave_launches[key],
                                      "classical": classical_launches[key],
                                      "bdpt": bdpt_launches[key],
                                      "coverage": cov_launches[key],
                                      "coverage_fraunhofer":
                                          fr_launches[key],
                                      "materials_wave": mat_launches[key],
                                      "materials_bdpt_pol":
                                          matb_launches[key],
                                      **{k: v[key] for k, v in
                                         grad_launches.items()},
                                      "batched_wave": batched["wave"][key],
                                      "batched_classical":
                                          batched["classical"][key],
                                      "cli_wave_scale": cli_launches[key],
                                      "cli_mask": mask_launches[key],
                                      **{k: v[key] for k, v in
                                         extra_launches.items()},
                                      "large_scene_wave": large_launches[key],
                                      "large_scene_small_card":
                                          large_out["small_launches"][key],
                                      "city_coverage":
                                          city["launches"][key]},
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
            in_materials_render=in_mat["closest"],
            in_materials_bdpt_render=in_matb["closest"],
            materials_call_vs_plain=mat_calls["closest"],
            cli_scale_call_vs_plain=cli_calls["closest"],
            mask_ms_per_launch=cli_out["mask_k1_ms_per_launch"],
            cli=cli_out,
            gradients=dict(wave_and_classical=g19, bdpt=g23,
                           forward=g24, paths_vs_cpu=g25),
            culls_off_ms=kstats["closest"]["culls_off_ms"],
            all_pairs_bound_ms=kstats["closest"]["all_pairs_bound_ms"]),
        row("any_hit", "ray_kernels.cu",
            "wave_tracer_tpu/accel/mxu_trace.py:185", "anyhit",
            kstats["anyhit"],
            in_scale_render={k: in_render[k]
                             for k in ("anyhit_legs", "anyhit_nee")},
            in_bdpt_render=in_bdpt["anyhit"],
            in_coverage_render=in_cov["anyhit"], at_forward_width=k2_fwd,
            in_materials_render={k: in_mat[k]
                                 for k in ("anyhit_legs", "anyhit_nee")},
            in_materials_bdpt_render=in_matb["anyhit"],
            materials_call_vs_plain=mat_calls["anyhit"],
            cli_scale_call_vs_plain=cli_calls["anyhit"],
            need_mask_ms=legs_need[0], empty_mask_ms=legs_need[1]),
        row("cone_minz", "cone_kernels.cu",
            "wave_tracer_tpu/accel/mxu_cone.py:309", "cone_minz", k3,
            narrow_cones=k3_narrow,
            in_scale_render=in_render["cone_minz"],
            in_materials_render=in_mat["cone_minz"],
            materials_call_vs_plain=mat_calls["cone_minz"],
            cli_scale_call_vs_plain=cli_calls["cone_minz"],
            winner_ms=k3["winner_ms"], winner_ms_box=k3_box["winner_ms"],
            winner_launches_by_path={
                k: g26[k]["cone_minz_winners"] for k in GEOMETRY_MOVES},
            geometry_gradients=g26,
            distributed={k: v for k, v in d27.items()
                         if not k.startswith("launches")},
            at_327692_tris=large_out["k3"], cone_queries=p29),
        row("bvh_closest_hit", "bvh_kernels.cu",
            "wave_tracer_tpu/accel/trace.py:250", "bvh_closest", k4,
            main=large_launches, tpu_kernel=None,
            vs_k1_at_81932_tris=vs_all_pairs,
            in_large_render=large_out["in_render"].get("bvh_closest"),
            large_render=dict(paths_per_sec=large_out["paths_per_sec"],
                              seconds=large_out["seconds"],
                              bake_s=large_out["bake_s"],
                              bvh_nodes=large_out["bvh_nodes"],
                              bvh_depth=large_out["bvh_depth"],
                              small_vs_cpu=large_out["small_vs_cpu"]),
            city=city, route_switch=p30),
        row("bvh_any_hit", "bvh_kernels.cu",
            "wave_tracer_tpu/accel/trace.py:392", "bvh_any", k5,
            main=large_launches, tpu_kernel=None,
            in_large_render={k: large_out["in_render"].get(k) for k in
                             ("bvh_any_legs", "bvh_any_nee")}),
    ]
    # below 2^17 triangles no default path takes the BVH route: only the
    # large scene and phase 30's override paths, by name
    for r in kernels[3:]:
        moved = {k: v for k, v in r["launches_by_path"].items()
                 if v and k not in ("large_scene_wave",
                                    "large_scene_small_card")
                 + BVH_OVERRIDE_PATHS}
        check(not moved, f"{r['name']} launched on {moved}")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}, default=float), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
