// Cone-triangle boundary sweep for Hopper (sm_90a): K3.
//
// Replaces: wave_tracer_tpu/accel/mxu_cone.py::_minz_kernel (the Pallas
//   kernel behind cone_boundary_minz_mxu). What is ported is what it
//   computes, not its MXU blocking. Per (lane, triangle) pair: the exact
//   minimal entry z of the elliptic cone r = x0 + ta·z (local scaled
//   frame: x along the major axis, y scaled by the eccentricity e, z along
//   the ray) into the triangle — the least of vertex containment, the
//   three edge quadratics, the central-axis hit and the conic near point
//   inside the triangle (mxu_cone.py::_minz_block), with one excluded
//   triangle id. Per lane it keeps the 16 masked minima
//   min{z : z >= bnd_j} and the number of triangles the cone meets.
//
// What bounds it on the card: the pair body is 387 fp32 operations
//   (among them 4 square roots and 17 IEEE divisions, each many
//   instructions, besides many data-dependent compares and selects) over
//   N·T pairs: a 262,144-lane pool × 81,932 triangles is 2.1e10 pairs at
//   the main path's largest shape. Run on every pair, that is compute
//   bound at ~1,300 issued instructions per pair. But almost every pair
//   of a narrow beam against a large scene misses, and that shows before
//   any quadratic: the triangle lies wholly beyond zmax, before the
//   apex, or off to one side of the cone.
//
// What the design does about it:
//   * two conservative culls in front of the pair body, over K3's own
//     copy of the triangles, sorted so that each 256-triangle tile is
//     compact (accel/ray_kernels.py::tile_order; min and count do not
//     depend on the order, and the exclusion compares the rows'
//     bake-order ids). (a) Per warp and tile: each tile has a bounding
//     sphere (accel/cone_kernels.py::tile_spheres); a warp skips it when
//     __any_sync says none of its 32 cones can reach the sphere. (b) Per
//     pair: first against the triangle's bounding sphere (tri_spheres: one
//     point to transform, not three), then, where some lane of the warp is
//     still in, on the three local vertices: the body is skipped when all
//     three local z lie above zmax, or all below the apex/zmin, or all x
//     or all y lie beyond the cone. The margin is 4·R + 2e-3·(|x0| +
//     |ta|·mag) + 1e-2·mag, R the cone radius an entry there may see and
//     mag the largest local coordinate of the triangle (or of the sphere,
//     which bounds every triangle's inside); why it holds is set out
//     below. A culled pair is one the body would not accept, so the
//     outputs equal the all-pairs plain version bit for bit;
//     tests/test_torch_cull.py holds the plain twins of the predicates
//     against _minz_block;
//   * the pair body runs for few, scattered lanes of a warp, so run where
//     it is found it would idle most of the warp. Instead each warp queues
//     its surviving (lane, triangle) candidates in a shared-memory ring and
//     drains them 32 at a time, one per thread: the lane's cone comes by
//     __shfl_sync, and the 16 minima and the count of each lane live in
//     shared memory and merge with shared atomicMin/atomicAdd (min and sum
//     do not depend on the order);
//   * one thread per lane, 128 lanes per block; the boundaries are read
//     through L1 only for accepted pairs, so the hot loop (the culls)
//     holds few registers (__launch_bounds__(128, 6): <= 85 registers;
//     36 KB of shared memory per block, so 6 blocks, 24 warps per SM,
//     against 16 before);
//   * triangle tiles (256 × 9 floats and 256 spheres, 13 KB) stream
//     through a 2-stage shared-memory ring with cp.async, so the next
//     tile's load overlaps the current tile's tests; every thread reads
//     the same word (broadcast);
//   * local coordinates subtract first: u = V − ro, then (xh·u, e·(yh·u),
//     rd·u) with yh = rd × xh (the MXU kernel's bilinear [v, 1]
//     contraction cancels badly for small triangles far from the origin);
//     the normal is recomputed from the local edges, as _minz_block does;
//   * the triangle range is split across blockIdx.y into many short
//     blocks (~48 per SM in all), so that the card fills and blocks that
//     finish early (their cones cull more tiles) leave no long tail; the
//     partial results merge with atomicMin on the float bits and
//     atomicAdd on the count. Every accepted z is
//     >= zlo_eff >= zmin > 0 (the wrapper refuses zmin <= 0), and the
//     minima start at BIG or +inf, so the bits of all values compared are
//     those of non-negative floats, which order like the floats themselves;
//   * a second build of the kernel (kStats), launched only to measure,
//     adds to four counters (pairs tested after the tile cull, pairs that
//     entered the body, warp-iterations, warp-iterations in which some
//     lane had a candidate), one atomic per warp; the main path's build
//     does not count;
//   * a build that also returns each minimum's triangle (kWin), launched
//     only where a derivative is in play (accel/trace.py recomputes the
//     winning pair's z differentiably): each minimum merges as one 64-bit
//     key (z bits << 32 | bake-order id), in shared memory and across
//     blocks, as K1 merges its hits; z >= zmin > 0, so the keys order by z
//     and then by the least id. Its 16 keys a lane take 16 KB of shared
//     memory where the minima take 8 KB. Plain renders launch the build
//     without it.
//
// Why the cull margin holds. An accepted entry lies in the triangle at a z
//   in [zlo_eff, zmax] and within r = |x0 + ta·z| of the axis (vertex,
//   edge and axis entries, up to the tolerance below), with two
//   exceptions, both from the conic near point p = (s·r/ρ·(lnx, lny),
//   z_c), z_c = max(lo1, lo2, zlo_eff):
//   * where the plane cuts the disk at z_c rather than touching it, p is
//     on the rim but off the plane, and the body accepts it when its
//     projection along the normal's largest axis falls in the triangle's.
//     The triangle point t with that projection lies within √3·r(z_c) of
//     (0, 0, z_c). Dropping z: t_xy = p_xy, |p_xy| = r, and the plane
//     climbs at most ρ/|lnz| <= √2 per unit across the <= r from its
//     line's nearest point to p, so |t_z − z_c| <= √2·r. Dropping x (or
//     y): t_z = z_c, |t_y| <= r and |t_x| <= r·(|n̂x| + |n̂y|) <= √2·r.
//     So every side needs at most √3·R, R the largest |r| over [zlo_eff,
//     zmax]; the margin's 4·R is more than twice that. With x0 >= 0 and
//     0 <= ta < 0.5 the radius is also held by the triangle's highest z,
//     zh: z_c <= zh + √3·r gives r <= (x0 + ta·zh) / (1 − √3·ta) <= (x0 +
//     ta·zh) / (1 − 1.8·ta) (radius_bound);
//   * a plane ⊥ the axis (ρ <= 1e-12) enters on the axis at z >= zmin,
//     which may lie below the apex when x0 < 0, so the low-z test
//     compares with zmin, not zlo_eff (the two differ only for x0 < 0).
//   The tolerance q <= 1e-6·max(r0², 1) admits points sqrt(tol) =
//   1e-3·max(|r0|, 1) beyond the rim; 2e-3·(|x0| + |ta|·mag) + 1e-2·mag
//   covers that twice. fp32 rounding of q, a difference of squares of
//   coordinates up to mag, moves the rim by about sqrt(k·2^-24)·mag for k
//   rounded operations: 1e-2·mag covers k up to ~1,700.
//   tests/test_torch_cull.py checks that the body rejects every triangle
//   beyond half the margin, on each side.
//
// Precision: fp32 throughout, no tensor cores, no TF32. Build WITHOUT
//   --use_fast_math: sqrtf and the divisions must be IEEE and denormals
//   must not flush. The membership tests (q <= tol, the clipped
//   candidates, the conic `perp` branch) keep the JAX order of operations,
//   and the source is built with -fmad=false: a multiply-add contracted
//   into one FMA rounds once where the plain torch version rounds twice,
//   and a pair at a membership threshold then flips.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;       // lanes per block = threads
constexpr int TT = 256;       // triangles per tile (= the bound tiles)
constexpr int NF = 9;         // floats per triangle: A, B, C
constexpr int TILE_F4 = TT * NF / 4;
constexpr int NB = 16;        // schedule boundaries
constexpr int LF = 16;        // floats per lane row
constexpr float BIG = 1e30f;
constexpr float EPS = 1e-12f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a / b with |b| < EPS replaced by -EPS (b < 0) or +EPS (b >= 0, so b = 0
// maps to +EPS), as mxu_cone._safe_div
__device__ __forceinline__ float safe_div(float a, float b) {
  const float bb = fabsf(b) < EPS ? (b < 0.f ? -EPS : EPS) : b;
  return a / bb;
}

// jnp.sign: -1, 0 or +1 (NaN stays NaN)
__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : (x == 0.f ? 0.f : x));
}

// jnp.maximum / jnp.minimum / jnp.clip(x, 0, 1): NaN propagates
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float clip01(float s) {
  return s < 0.f ? 0.f : (s > 1.f ? 1.f : s);
}

__device__ __forceinline__ bool in_tri_2d(float px, float py, float ax,
                                          float ay, float bx, float by,
                                          float cx, float cy) {
  const float e0 = (bx - ax) * (py - ay) - (by - ay) * (px - ax);
  const float e1 = (cx - bx) * (py - by) - (cy - by) * (px - bx);
  const float e2 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx);
  const bool pos = (e0 >= 0.f) & (e1 >= 0.f) & (e2 >= 0.f);
  const bool neg = (e0 <= 0.f) & (e1 <= 0.f) & (e2 <= 0.f);
  return pos | neg;
}

// minimal z of segment AB inside the circular cone r = x0 + ta z
// (mxu_cone._edge_entry_z); BIG if none
__device__ __forceinline__ float edge_entry_z(
    float Ax, float Ay, float Az, float Bx, float By, float Bz, float x0,
    float ta, float zlo_eff, float zmin, float zmax) {
  const float Ex = Bx - Ax, Ey = By - Ay, Ez = Bz - Az;
  const float r0 = x0 + ta * Az;
  const float tEz = ta * Ez;
  const float a = Ex * Ex + Ey * Ey - tEz * tEz;
  const float b = 2.f * (Ax * Ex + Ay * Ey - ta * Ez * r0);
  const float c = Ax * Ax + Ay * Ay - r0 * r0;
  const float disc = b * b - 4.f * a * c;
  const float sq = sqrtf(jmax(disc, 0.f));
  const float qq = -0.5f * (b + sgn(b) * sq);
  const bool lin = fabsf(a) < EPS;
  float s_r1, s_r2;
  if (lin) {
    s_r1 = s_r2 = safe_div(-c, b);
  } else {
    s_r1 = safe_div(qq, a);
    s_r2 = safe_div(c, qq);
  }
  const bool roots_ok = lin ? (fabsf(b) >= EPS) : (disc >= 0.f);
  const float s_zlo = safe_div(zmin - Az, Ez);
  const float s_zhi = safe_div(zmax - Az, Ez);
  const float tol = 1e-6f * jmax(r0 * r0, 1.f);

  float best = BIG;
  const float cand[6] = {s_r1, s_r2, 0.f, 1.f, s_zlo, s_zhi};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float s = clip01(cand[k]);
    const float q = (a * s + b) * s + c;
    const float z = Az + s * Ez;
    bool ok = (q <= tol) & (z >= zlo_eff) & (z <= zmax);
    if (k < 2) ok &= roots_ok;
    if (ok && z < best) best = z;
  }
  return best;
}

// exact minimal entry z of the cone into triangle ABC (local scaled
// coordinates), mxu_cone._minz_block per pair; BIG if none
__device__ __forceinline__ float minz_pair(
    float Ax, float Ay, float Az, float Bx, float By, float Bz, float Cx,
    float Cy, float Cz, float x0, float ta, float zlo_eff, float zmin,
    float zmax) {
  float best = BIG;
  // 1. vertices inside the cone
  {
    float r = x0 + ta * Az;
    if ((Az >= zlo_eff) & (Az <= zmax) & (Ax * Ax + Ay * Ay <= r * r) &
        (Az < best))
      best = Az;
    r = x0 + ta * Bz;
    if ((Bz >= zlo_eff) & (Bz <= zmax) & (Bx * Bx + By * By <= r * r) &
        (Bz < best))
      best = Bz;
    r = x0 + ta * Cz;
    if ((Cz >= zlo_eff) & (Cz <= zmax) & (Cx * Cx + Cy * Cy <= r * r) &
        (Cz < best))
      best = Cz;
  }
  // 2. edge entries
  best = jmin(best, edge_entry_z(Ax, Ay, Az, Bx, By, Bz, x0, ta, zlo_eff,
                                 zmin, zmax));
  best = jmin(best, edge_entry_z(Ax, Ay, Az, Cx, Cy, Cz, x0, ta, zlo_eff,
                                 zmin, zmax));
  best = jmin(best, edge_entry_z(Bx, By, Bz, Cx, Cy, Cz, x0, ta, zlo_eff,
                                 zmin, zmax));
  // 3. central-axis hit; the normal from the local edges
  const float e1x = Bx - Ax, e1y = By - Ay, e1z = Bz - Az;
  const float e2x = Cx - Ax, e2y = Cy - Ay, e2z = Cz - Az;
  const float lnx = e1y * e2z - e1z * e2y;
  const float lny = e1z * e2x - e1x * e2z;
  const float lnz = e1x * e2y - e1y * e2x;
  const float d = lnx * Ax + lny * Ay + lnz * Az;
  const float z_ax = safe_div(d, lnz);
  if (in_tri_2d(0.f, 0.f, Ax, Ay, Bx, By, Cx, Cy) & (fabsf(lnz) > EPS) &
      (z_ax >= zmin) & (z_ax <= zmax) & (z_ax >= zlo_eff) & (z_ax < best))
    best = z_ax;
  // 4. conic near point inside the triangle (cone_plane_entry)
  const float rho = sqrtf(lnx * lnx + lny * lny);
  const float a1 = rho * ta + lnz, b1 = d - rho * x0;
  const float a2 = rho * ta - lnz, b2 = -d - rho * x0;
  float lo1 = a1 > EPS ? b1 / jmax(a1, EPS) : -BIG;
  float hi1 = a1 < -EPS ? b1 / jmin(a1, -EPS) : BIG;
  if ((fabsf(a1) <= EPS) & (b1 > 0.f)) { lo1 = BIG; hi1 = -BIG; }
  float lo2 = a2 > EPS ? b2 / jmax(a2, EPS) : -BIG;
  float hi2 = a2 < -EPS ? b2 / jmin(a2, -EPS) : BIG;
  if ((fabsf(a2) <= EPS) & (b2 > 0.f)) { lo2 = BIG; hi2 = -BIG; }
  const float z_lo = jmax(jmax(lo1, lo2), zlo_eff);
  const float z_hi = jmin(jmin(hi1, hi2), zmax);
  bool ok_c = z_lo <= z_hi;
  float z_c = z_lo;
  const float r = x0 + ta * z_c;
  float s = sgn(d - lnz * z_c);
  if (s == 0.f) s = 1.f;
  const float safe_rho = jmax(rho, EPS);
  float px = s * r / safe_rho * lnx;
  float py = s * r / safe_rho * lny;
  if (rho <= EPS) {                       // plane ⊥ axis
    const float z_perp = safe_div(d, lnz);
    z_c = z_perp;
    px = 0.f;
    py = 0.f;
    ok_c = (z_perp >= zmin) & (z_perp <= zmax);
  }
  // in-triangle test: project along the largest local-normal axis
  const float anx = fabsf(lnx), any_ = fabsf(lny), anz = fabsf(lnz);
  const bool use_x = (anx >= any_) & (anx >= anz);
  const bool use_y = !use_x & (any_ >= anz);
  const bool keep_z = use_x | use_y;
  const bool in_c = in_tri_2d(
      use_x ? py : px, keep_z ? z_c : py,
      use_x ? Ay : Ax, keep_z ? Az : Ay,
      use_x ? By : Bx, keep_z ? Bz : By,
      use_x ? Cy : Cx, keep_z ? Cz : Cy);
  return jmin(best, (ok_c & in_c) ? z_c : BIG);
}

// cull margin for coordinates of magnitude `mag` (see the header);
// accel/cone_kernels.py::_cull_pad is its plain twin
__device__ __forceinline__ float cull_pad(float R, float x0, float ta,
                                          float mag) {
  return 4.f * R + 2e-3f * (fabsf(x0) + fabsf(ta) * mag) + 1e-2f * mag;
}

// The cone radius an entry into a triangle (or tile) whose highest local z
// is zh may see: the vertices and edge points lie at z <= zh and the conic
// near point at z_c <= zh + √3·r(z_c), so r <= (x0 + ta·zh) / (1 −
// 1.8·ta) for x0 >= 0 and 0 <= ta < 0.5; never above the lane's bound R,
// the largest |r| over [zlo_eff, zmax]. rinv = 1 / (1 − 1.8·ta). Twin:
// cone_kernels.py::_radius_bound.
__device__ __forceinline__ float radius_bound(float R, float x0, float ta,
                                              float rinv, float zlo_eff,
                                              float zh) {
  return (x0 >= 0.f) & (ta >= 0.f) & (ta < 0.5f)
             ? fminf(R, (x0 + ta * fmaxf(zh, zlo_eff)) * rinv)
             : R;
}

// (b) may the body accept the pair? loc = local A, B, C (x, y, z each);
// twin: accel/cone_kernels.py::_pair_may_enter. fmaxf/fminf drop NaN, so
// a NaN coordinate never culls.
__device__ __forceinline__ bool pair_may_enter(const float* loc, float x0,
                                               float ta, float zlo_eff,
                                               float zmin, float zmax,
                                               float R, float rinv) {
  float mag = 1.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) mag = fmaxf(mag, fabsf(loc[k]));
  const float zl = fminf(fminf(loc[2], loc[5]), loc[8]);
  const float zh = fmaxf(fmaxf(loc[2], loc[5]), loc[8]);
  const float pad =
      cull_pad(radius_bound(R, x0, ta, rinv, zlo_eff, zh), x0, ta, mag);
  const float xl = fminf(fminf(loc[0], loc[3]), loc[6]);
  const float xh = fmaxf(fmaxf(loc[0], loc[3]), loc[6]);
  const float yl = fminf(fminf(loc[1], loc[4]), loc[7]);
  const float yh = fmaxf(fmaxf(loc[1], loc[4]), loc[7]);
  return !((zl > zmax + pad) | (zh < zmin - pad) | (xl > pad) |
           (xh < -pad) | (yl > pad) | (yh < -pad));
}

// may the cone reach a bounding sphere (world centre, radius), a tile's
// in (a) and a triangle's in (b)? The margin comes from the sphere's
// largest local coordinate (inflated by 1e-5 for the rounding of the two
// transforms) and its highest z, so it is at least that of every triangle
// inside. Twin: accel/cone_kernels.py::_sphere_cull
__device__ __forceinline__ bool sphere_may_enter(
    float4 sph, float rox, float roy, float roz, float rdx, float rdy,
    float rdz, float xhx, float xhy, float xhz, float yhx, float yhy,
    float yhz, float ecc, float x0, float ta, float zlo_eff, float zmin,
    float zmax, float R, float rinv) {
  const float ux = sph.x - rox, uy = sph.y - roy, uz = sph.z - roz;
  const float cx = xhx * ux + xhy * uy + xhz * uz;
  const float cy = ecc * (yhx * ux + yhy * uy + yhz * uz);
  const float cz = rdx * ux + rdy * uy + rdz * uz;
  const float rad = sph.w * fmaxf(1.f, fabsf(ecc));
  const float mag = fmaxf(
      1.f, (fmaxf(fmaxf(fabsf(cx), fabsf(cy)), fabsf(cz)) + rad) * 1.00001f);
  const float pad = cull_pad(
      radius_bound(R, x0, ta, rinv, zlo_eff, cz + rad), x0, ta, mag);
  return !((cz - rad > zmax + pad) | (cz + rad < zmin - pad) |
           (fabsf(cx) - rad > pad) | (fabsf(cy) - rad > pad));
}

// local scaled coordinates of triangle v (9 floats) for one cone
__device__ __forceinline__ void to_local(const float* v, float* loc,
                                         float rox, float roy, float roz,
                                         float rdx, float rdy, float rdz,
                                         float xhx, float xhy, float xhz,
                                         float yhx, float yhy, float yhz,
                                         float ecc) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float ux = v[3 * p] - rox;
    const float uy = v[3 * p + 1] - roy;
    const float uz = v[3 * p + 2] - roz;
    loc[3 * p] = xhx * ux + xhy * uy + xhz * uz;
    loc[3 * p + 1] = ecc * (yhx * ux + yhy * uy + yhz * uz);
    loc[3 * p + 2] = rdx * ux + rdy * uy + rdz * uz;
  }
}

constexpr int WARPS = BN / 32;
constexpr int QCAP = 64;      // candidate ring per warp (a power of 2)

template <bool kStats, bool kWin>
__global__ void __launch_bounds__(BN, 6) cone_minz_kernel(
    const float* __restrict__ tri, const int* __restrict__ ids,
    const float4* __restrict__ tiles,
    const float4* __restrict__ spheres, int T,
    int tiles_per_chunk, const float* __restrict__ lane,
    const int* __restrict__ ex, const float* __restrict__ bnd, int N,
    float zmin, float* __restrict__ zc, int* __restrict__ cnt,
    unsigned long long* __restrict__ stats,
    unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) float4 sh[2][TILE_F4];
  __shared__ float4 ssph[2][TT];
  // the minima (kWin: the (z, id) keys instead)
  __shared__ float smin[kWin ? 1 : NB][BN];
  __shared__ unsigned long long skey[kWin ? NB : 1][kWin ? BN : 1];
  __shared__ int scnt[BN];
  __shared__ int squeue[WARPS][QCAP];
  const int tid = threadIdx.x;
  const int lid = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * BN + tid;
  const bool live = i < N;

  // lane row: ro(0:3) rd(3:6) xh(6:9) e x0 ta zmax pad3
  float L[LF];
#pragma unroll
  for (int k = 0; k < LF; ++k) L[k] = live ? lane[(size_t)i * LF + k] : 0.f;
  const int exc = live ? ex[i] : -1;
  const float rox = L[0], roy = L[1], roz = L[2];
  const float rdx = L[3], rdy = L[4], rdz = L[5];
  const float xhx = L[6], xhy = L[7], xhz = L[8];
  const float ecc = L[9], x0 = L[10], ta = L[11], zmax = L[12];
  // yh = rd × xh
  const float yhx = rdy * xhz - rdz * xhy;
  const float yhy = rdz * xhx - rdx * xhz;
  const float yhz = rdx * xhy - rdy * xhx;
  const float apex = -safe_div(x0, jmax(ta, EPS));
  const float zlo_eff = jmax(zmin, ta > 0.f ? apex : -BIG);
  // the cone's radius bound over the z range an accepted pair lies in
  const float R = fmaxf(fabsf(x0 + ta * zlo_eff), fabsf(x0 + ta * zmax));
  const float rinv = 1.f / (1.f - 1.8f * ta);

#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if constexpr (kWin)
      skey[k][tid] = ~0ull;
    else
      smin[k][tid] = BIG;
  }
  scnt[tid] = 0;
  unsigned tested = 0, entered = 0, witer = 0, witer_in = 0;  // kStats
  unsigned qhead = 0, qtail = 0;        // warp-uniform ring positions

  // the pair body for the m oldest queued candidates (lane, triangle),
  // one per thread: the lane's cone comes by shuffle; the minima and the
  // count merge with shared-memory atomics (min and sum do not depend on
  // the order, so the result is that of the all-pairs loop)
  auto drain = [&](unsigned m, const float* v0, int base) {
    __syncwarp();
    const int e = lid < (int)m ? squeue[warp][(qhead + lid) & (QCAP - 1)]
                               : 0;
    const int src = e >> 8, j = e & 255;
    const float qrox = __shfl_sync(FULL, rox, src);
    const float qroy = __shfl_sync(FULL, roy, src);
    const float qroz = __shfl_sync(FULL, roz, src);
    const float qrdx = __shfl_sync(FULL, rdx, src);
    const float qrdy = __shfl_sync(FULL, rdy, src);
    const float qrdz = __shfl_sync(FULL, rdz, src);
    const float qxhx = __shfl_sync(FULL, xhx, src);
    const float qxhy = __shfl_sync(FULL, xhy, src);
    const float qxhz = __shfl_sync(FULL, xhz, src);
    const float qyhx = __shfl_sync(FULL, yhx, src);
    const float qyhy = __shfl_sync(FULL, yhy, src);
    const float qyhz = __shfl_sync(FULL, yhz, src);
    const float qecc = __shfl_sync(FULL, ecc, src);
    const float qx0 = __shfl_sync(FULL, x0, src);
    const float qta = __shfl_sync(FULL, ta, src);
    const float qzmax = __shfl_sync(FULL, zmax, src);
    const float qzlo = __shfl_sync(FULL, zlo_eff, src);
    const int qexc = __shfl_sync(FULL, exc, src);
    if (lid < (int)m) {
      float loc[9];
      to_local(v0 + j * NF, loc, qrox, qroy, qroz, qrdx, qrdy, qrdz, qxhx,
               qxhy, qxhz, qyhx, qyhy, qyhz, qecc);
      const float z = minz_pair(loc[0], loc[1], loc[2], loc[3], loc[4],
                                loc[5], loc[6], loc[7], loc[8], qx0, qta,
                                qzlo, zmin, qzmax);
      if ((z < BIG) && __ldg(ids + base + j) != qexc) {
        const int slot = warp * 32 + src;
        const size_t row = (size_t)(blockIdx.x * BN + slot) * NB;
        atomicAdd(&scnt[slot], 1);
        if constexpr (kWin) {
          const unsigned long long key =
              ((unsigned long long)__float_as_uint(z) << 32) |
              (unsigned)__ldg(ids + base + j);
#pragma unroll
          for (int k = 0; k < NB; ++k)
            if (z >= __ldg(bnd + row + k)) atomicMin(&skey[k][slot], key);
        } else {
#pragma unroll
          for (int k = 0; k < NB; ++k)
            if (z >= __ldg(bnd + row + k))
              atomicMin(reinterpret_cast<int*>(&smin[k][slot]),
                        __float_as_int(z));
        }
      }
    }
    qhead += m;
    __syncwarp();
  };

  const int t_first = blockIdx.y * tiles_per_chunk;
  const int t_end = min((T + TT - 1) / TT, t_first + tiles_per_chunk);
  // cone_table pads tri to a multiple of 4 rows, so every tile is a whole
  // number of 16-byte words
  auto load_tile = [&](int t, int stage) {
    const int n = min(TT, T - t * TT);
    const int nf4 = (n * NF + 3) / 4;
    const float4* src =
        reinterpret_cast<const float4*>(tri + (size_t)t * TT * NF);
    for (int k = tid; k < nf4; k += BN) cp_async16(&sh[stage][k], src + k);
    for (int k = tid; k < n; k += BN)
      cp_async16(&ssph[stage][k], spheres + t * TT + k);
    cp_async_commit();
  };
  if (t_first < t_end) load_tile(t_first, 0);
  for (int t = t_first; t < t_end; ++t) {
    const int stage = (t - t_first) & 1;
    if (t + 1 < t_end) {
      load_tile(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool may =
        live && sphere_may_enter(__ldg(tiles + t), rox, roy, roz, rdx, rdy,
                                 rdz, xhx, xhy, xhz, yhx, yhy, yhz, ecc, x0,
                                 ta, zlo_eff, zmin, zmax, R, rinv);
    if (__any_sync(FULL, may)) {
      const int base = t * TT;
      const int n = min(TT, T - base);
      const float* v0 = reinterpret_cast<const float*>(sh[stage]);
      for (int j = 0; j < n; ++j) {
        // (b) the pair cull: the triangle's bounding sphere (one point
        // to transform), then, where some lane of the warp is still in,
        // the three vertices
        bool pass =
            may && sphere_may_enter(ssph[stage][j], rox, roy, roz, rdx, rdy,
                                    rdz, xhx, xhy, xhz, yhx, yhy, yhz, ecc,
                                    x0, ta, zlo_eff, zmin, zmax, R, rinv);
        if (__any_sync(FULL, pass)) {
          float loc[9];
          to_local(v0 + j * NF, loc, rox, roy, roz, rdx, rdy, rdz, xhx, xhy,
                   xhz, yhx, yhy, yhz, ecc);
          pass &= pair_may_enter(loc, x0, ta, zlo_eff, zmin, zmax, R,
                                 rinv);
        }
        const unsigned bal = __ballot_sync(FULL, pass);
        if (pass)
          squeue[warp][(qtail + __popc(bal & ((1u << lid) - 1u))) &
                       (QCAP - 1)] = (lid << 8) | j;
        qtail += __popc(bal);
        if constexpr (kStats) {
          tested += live;
          entered += pass;
          ++witer;
          witer_in += bal != 0u;
        }
        if (qtail - qhead >= 32u) drain(32u, v0, base);
      }
      // the tile leaves shared memory: drain what is left
      if (qtail != qhead) drain(qtail - qhead, v0, base);
    }
    __syncthreads();           // the stage is refilled next iteration
  }
  if constexpr (kStats) {
    tested = __reduce_add_sync(FULL, tested);
    entered = __reduce_add_sync(FULL, entered);
    if (lid == 0) {
      atomicAdd(stats + 0, (unsigned long long)tested);
      atomicAdd(stats + 1, (unsigned long long)entered);
      atomicAdd(stats + 2, (unsigned long long)witer);
      atomicAdd(stats + 3, (unsigned long long)witer_in);
    }
  }
  const int count = scnt[tid];
  if (!live || !count) return;
  atomicAdd(cnt + i, count);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if constexpr (kWin) {
      if (skey[k][tid] != ~0ull)
        atomicMin(keys + (size_t)i * NB + k, skey[k][tid]);
    } else if (smin[k][tid] < BIG) {
      atomicMin(reinterpret_cast<int*>(zc) + (size_t)i * NB + k,
                __float_as_int(smin[k][tid]));
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers;
// `stream` is a cudaStream_t. tri (≥ T rows, a multiple of 4, × 9) f32,
// 16-byte aligned, in tile order, and ids (T,) i32 their bake-order ids
// (the exclusion compares these); tiles (ceil(T / 256), 4) f32 tile
// spheres; spheres
// (T, 4) f32 triangle spheres, 16-byte aligned; lane (N, 16)
// f32; ex (N,) i32; bnd (N, 16) f32 (BIG-padded); zc (N, 16) f32 must hold
// +inf and cnt (N,) i32 zeros before the launch; stats, if not null, (4,)
// u64 counters to which the counting build adds; keys, if not null, (N,
// 16) u64 holding ~0 before the launch: the winner build then writes each
// minimum there as (z bits << 32 | its triangle's bake-order id) and
// leaves zc as it was. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int wt_cone_minz(const float* tri, const int* ids,
                            const float* tiles,
                            const float* spheres, int T,
                            int chunks, const float* lane, const int* ex,
                            const float* bnd, int N, float zmin, float* zc,
                            int* cnt, unsigned long long* stats,
                            unsigned long long* keys, void* stream) {
  if (N <= 0 || T <= 0) return 0;
  const int ntiles = (T + TT - 1) / TT;
  if (chunks < 1) chunks = 1;
  if (chunks > ntiles) chunks = ntiles;
  const int per = (ntiles + chunks - 1) / chunks;
  chunks = (ntiles + per - 1) / per;
  dim3 grid((N + BN - 1) / BN, chunks);
  auto kernel = keys ? (stats ? cone_minz_kernel<true, true>
                              : cone_minz_kernel<false, true>)
                     : (stats ? cone_minz_kernel<true, false>
                              : cone_minz_kernel<false, false>);
  kernel<<<grid, BN, 0, (cudaStream_t)stream>>>(
      tri, ids, reinterpret_cast<const float4*>(tiles),
      reinterpret_cast<const float4*>(spheres), T, per, lane, ex, bnd, N,
      zmin, zc, cnt, stats, keys);
  return (int)cudaGetLastError();
}
