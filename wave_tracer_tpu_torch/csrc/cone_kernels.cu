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
// What bounds it on the card: 387 fp32 operations per pair (among them
//   4 square roots and 17 divisions, besides many data-dependent
//   compares and selects), over N·T pairs: a 262,144-lane pool × 81,932 triangles is
//   2.1e10 pairs at the main path's largest shape. Compute bound; the
//   triangle table (T × 36 bytes) is read once per block through L2, the
//   lane state (N × 140 bytes) once per lane.
//
// What the design does about it:
//   * one thread per lane (cone); a block stages tiles of 256 triangles ×
//     9 floats (A, B, C world coordinates, 9 KB) in shared memory, where
//     every thread reads the same word (broadcast); the loop over tiles
//     takes the place of the Pallas grid's sequential triangle axis;
//   * local coordinates subtract first: u = V − ro, then (xh·u, e·(yh·u),
//     rd·u) with yh = rd × xh. The MXU kernel's bilinear [v, 1]
//     contraction cancels badly for small triangles far from the origin;
//     the subtraction does not, and at ~57 operations per pair it is small
//     beside the entry math, so no tensor cores are used;
//   * the normal channels of the MXU features are dropped: the normal is
//     recomputed from the local edges, as _minz_block does;
//   * the 16 running minima, the 16 boundaries and the count live in
//     registers; the per-boundary update runs only for pairs that meet;
//   * for small N the triangle range is split across blockIdx.y so that
//     the card fills; the partial results merge with atomicMin on the
//     float bits and atomicAdd on the count. Every accepted z is
//     >= zlo_eff >= zmin > 0 (the wrapper refuses zmin <= 0), and the
//     outputs start at +inf, so the bits of all values compared are those
//     of non-negative floats, which order like the floats themselves.
//
// Precision: fp32 throughout, no tensor cores, no TF32. Build WITHOUT
//   --use_fast_math: sqrtf and the divisions must be IEEE and denormals
//   must not flush. The membership tests (q <= tol, the clipped
//   candidates, the conic `perp` branch) keep the JAX order of operations,
//   and the source is built with -fmad=false: a multiply-add contracted
//   into one FMA rounds once where the plain torch version rounds twice,
//   and a pair at a membership threshold then flips (seen once in 4,717
//   minima against the plain version before the flag).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 256;       // lanes per block = threads
constexpr int TT = 256;       // triangles per shared-memory tile
constexpr int NF = 9;         // floats per triangle: A, B, C
constexpr int NB = 16;        // schedule boundaries
constexpr int LF = 16;        // floats per lane row
constexpr float BIG = 1e30f;
constexpr float EPS = 1e-12f;

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

__global__ void __launch_bounds__(BN) cone_minz_kernel(
    const float* __restrict__ tri, int T, int tiles_per_chunk,
    const float* __restrict__ lane, const int* __restrict__ ex,
    const float* __restrict__ bnd, int N, float zmin,
    float* __restrict__ zc, int* __restrict__ cnt) {
  __shared__ float sh[TT * NF];
  const int i = blockIdx.x * BN + threadIdx.x;
  const bool live = i < N;

  // lane row: ro(0:3) rd(3:6) xh(6:9) e x0 ta zmax pad3
  float L[LF];
  float bd[NB];
  int exc = -1;
#pragma unroll
  for (int k = 0; k < LF; ++k) L[k] = live ? lane[(size_t)i * LF + k] : 0.f;
#pragma unroll
  for (int k = 0; k < NB; ++k) bd[k] = live ? bnd[(size_t)i * NB + k] : BIG;
  if (live) exc = ex[i];
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

  float mins[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) mins[k] = BIG;
  int count = 0;

  const int first = blockIdx.y * tiles_per_chunk * TT;
  const int last = min(T, first + tiles_per_chunk * TT);
  for (int base = first; base < last; base += TT) {
    const int n = min(TT, last - base);
    __syncthreads();
    const float* src = tri + (size_t)base * NF;
    for (int k = threadIdx.x; k < n * NF; k += BN) sh[k] = src[k];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float* v = sh + j * NF;
      float loc[9];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const float ux = v[3 * p] - rox;
        const float uy = v[3 * p + 1] - roy;
        const float uz = v[3 * p + 2] - roz;
        loc[3 * p] = xhx * ux + xhy * uy + xhz * uz;
        loc[3 * p + 1] = ecc * (yhx * ux + yhy * uy + yhz * uz);
        loc[3 * p + 2] = rdx * ux + rdy * uy + rdz * uz;
      }
      const float z = minz_pair(loc[0], loc[1], loc[2], loc[3], loc[4],
                                loc[5], loc[6], loc[7], loc[8], x0, ta,
                                zlo_eff, zmin, zmax);
      if ((z < BIG) & (base + j != exc)) {
        ++count;
#pragma unroll
        for (int k = 0; k < NB; ++k)
          if (z >= bd[k]) mins[k] = fminf(mins[k], z);
      }
    }
  }
  if (!live) return;
  if (count) {
    atomicAdd(cnt + i, count);
#pragma unroll
    for (int k = 0; k < NB; ++k)
      if (mins[k] < BIG)
        atomicMin(reinterpret_cast<int*>(zc) + (size_t)i * NB + k,
                  __float_as_int(mins[k]));
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers;
// `stream` is a cudaStream_t. tri (T, 9) f32; lane (N, 16) f32; ex (N,)
// i32; bnd (N, 16) f32 (BIG-padded); zc (N, 16) f32 must hold +inf and
// cnt (N,) i32 zeros before the launch. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int wt_cone_minz(const float* tri, int T, int chunks,
                            const float* lane, const int* ex,
                            const float* bnd, int N, float zmin, float* zc,
                            int* cnt, void* stream) {
  if (N <= 0 || T <= 0) return 0;
  const int ntiles = (T + TT - 1) / TT;
  if (chunks < 1) chunks = 1;
  if (chunks > ntiles) chunks = ntiles;
  const int per = (ntiles + chunks - 1) / chunks;
  chunks = (ntiles + per - 1) / per;
  dim3 grid((N + BN - 1) / BN, chunks);
  cone_minz_kernel<<<grid, BN, 0, (cudaStream_t)stream>>>(
      tri, T, per, lane, ex, bnd, N, zmin, zc, cnt);
  return (int)cudaGetLastError();
}
