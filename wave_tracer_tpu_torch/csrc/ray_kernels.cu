// All-pairs ray-triangle kernels for Hopper (sm_90a): closest hit (K1) and
// any hit (K2).
//
// Replaces: wave_tracer_tpu/accel/mxu_trace.py::_closest_kernel and
//   ::_anyhit_kernel (the Pallas kernels behind trace_mxu / occluded_mxu).
//   What is ported is what they compute, not their MXU blocking: per (ray,
//   triangle) pair the three Plücker edge sides s_k = d·(P×Q) + (o×d)·(Q−P)
//   and the plane numerator tn = N·A − N·o, both with o and the vertices
//   translated by the scene's mxu_center; a hit is all three sides of one
//   sign with |s0+s1+s2| > 1e-12 and t = tn/(d·N) in (tmin, tmax],
//   with up to three excluded triangle ids. Closest hit keeps the least
//   (t, id) — ties go to the smaller id; any hit keeps "some hit".
//
// What bounds it on the card: about 25 fp32 FMAs plus ~10 compares per
//   pair, over N·T pairs (a 262,144-lane pool × 81,932 triangles = 2.1e10
//   pairs at the main path's largest shape) — compute bound; the triangle
//   table (T × 96 bytes) is read once per block from L2. Each pair costs
//   ~35 issued instructions (six broadcast shared-memory loads, the
//   sides, the sign tests), so instruction issue sets the pace. On the
//   wave bounce most of K2's rows are never read (the FSD legs of invalid
//   aperture slots, NEE of lanes off a surface), so K2's redesign starts
//   with not tracing them.
//
// K1 (closest_hit_kernel): one thread per ray; a block stages tiles of
//   256 triangles × 24 floats (24 KB) in shared memory, where every thread
//   reads the same word (broadcast); the triangle range is split across
//   blockIdx.y so that small ray batches still fill all SMs; partial
//   results merge with one 64-bit atomicMin on (key(t) << 32 | id), where
//   key(t) is an unsigned key that orders like t for either sign, so the
//   merge orders exactly like the sequential (t, then id) minimum for any
//   tmin. The IEEE division runs only for pairs that pass the sign test.
//
// K2 (any_hit_kernel), redesigned for the card:
//   * a need list: the rows to trace are a device-side list (int32 row
//     ids and their count, made by a cumsum on the device), so a caller
//     that reads only some rows (the wave bounce's FSD legs of valid
//     aperture slots, NEE of surface lanes) never traces the rest and
//     never syncs with the host; rows off the list stay "not occluded";
//   * a persistent grid of 4 blocks per SM walks (ray-block × triangle-
//     chunk) work items up to the count the kernel reads itself, so a
//     short list still fills every SM;
//   * two rays per thread (register blocking): each broadcast load of a
//     triangle row serves two pairs;
//   * a per-warp tile cull over K2's own copy of the triangles, sorted so
//     that each 256-triangle tile is compact (accel/ray_kernels.py::
//     tile_order; exclusions compare the rows' bake-order ids): each tile
//     has a world box (tile_boxes); a warp skips the tile when
//     __any_sync says none of its segments [tmin, tmax] meets the box,
//     padded by 2e-3·(|o − c|∞ + the tile's |v − c|∞) so that it never
//     drops a pair the Plücker test would accept (the sides' rounding
//     grows with those magnitudes);
//   * tiles stream through a 2-stage shared-memory ring with cp.async;
//   * a block stops once every ray of its item is occluded (here or by
//     another chunk's block).
//
// Precision: full fp32, no tensor cores, no TF32. Build WITHOUT
//   --use_fast_math: the division must be IEEE and denormals must not
//   flush, or edge-on rays flip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;   // triangles per shared-memory tile = threads
constexpr int NF = 24;      // floats per triangle row
constexpr float BIG = 3.4e38f;
constexpr float DEN_EPS = 1e-12f;

// unsigned key that orders like the float: negatives have all bits flipped,
// the rest only the sign bit
__device__ __forceinline__ unsigned int order_key(float x) {
  const unsigned int b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(TILE) closest_hit_kernel(
    const float* __restrict__ tri, int T, int tiles_per_chunk,
    const float* __restrict__ center,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const int* __restrict__ ex, int N,
    unsigned long long* __restrict__ best) {
  __shared__ float4 sh[TILE * NF / 4];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const bool live = i < N;

  float dx = 0.f, dy = 0.f, dz = 0.f, ox = 0.f, oy = 0.f, oz = 0.f;
  float t_lo = 0.f, t_hi = -1.f;
  int e0 = -1, e1 = -1, e2 = -1;
  if (live) {
    dx = rd[3 * i]; dy = rd[3 * i + 1]; dz = rd[3 * i + 2];
    ox = ro[3 * i] - center[0];
    oy = ro[3 * i + 1] - center[1];
    oz = ro[3 * i + 2] - center[2];
    t_lo = tmin[i]; t_hi = tmax[i];
    e0 = ex[3 * i]; e1 = ex[3 * i + 1]; e2 = ex[3 * i + 2];
  }
  // ray moment m = o × d
  const float mx = oy * dz - oz * dy;
  const float my = oz * dx - ox * dz;
  const float mz = ox * dy - oy * dx;

  float best_t = BIG;
  int best_i = -1;

  const int first = blockIdx.y * tiles_per_chunk * TILE;
  const int last = min(T, first + tiles_per_chunk * TILE);
  for (int base = first; base < last; base += TILE) {
    const int n = min(TILE, last - base);
    __syncthreads();
    const float4* src = reinterpret_cast<const float4*>(tri + (size_t)base * NF);
    for (int k = threadIdx.x; k < n * (NF / 4); k += TILE) sh[k] = src[k];
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        const float4* f = sh + j * (NF / 4);
        const float4 a = f[0], b = f[1], c = f[2], d = f[3], e = f[4],
                     g = f[5];
        // rows: [A×B | B−A | B×C | C−B | C×A | A−C | −N | N·A | pad2]
        const float s0 = dx * a.x + dy * a.y + dz * a.z
                       + mx * a.w + my * b.x + mz * b.y;
        const float s1 = dx * b.z + dy * b.w + dz * c.x
                       + mx * c.y + my * c.z + mz * c.w;
        const float s2 = dx * d.x + dy * d.y + dz * d.z
                       + mx * d.w + my * e.x + mz * e.y;
        const bool pos = (s0 >= 0.f) & (s1 >= 0.f) & (s2 >= 0.f);
        const bool neg = (s0 <= 0.f) & (s1 <= 0.f) & (s2 <= 0.f);
        const float den = s0 + s1 + s2;
        if ((pos | neg) && fabsf(den) > DEN_EPS) {
          // t = (N·A − N·o) / (d·N). d·N equals den (the sum of the
          // sides) but is taken directly: for small triangles far from
          // mxu_center the sides cancel and den carries ~1e-4 relative
          // error, while d·N does not.
          const float tn = ox * e.z + oy * e.w + oz * g.x + g.y;
          const float dn = -(dx * e.z + dy * e.w + dz * g.x);
          const float t = tn / dn;
          const int id = base + j;
          if (t > t_lo && t <= t_hi && id != e0 && id != e1 && id != e2 &&
              t < best_t) {
            best_t = t;
            best_i = id;
          }
        }
      }
    }
  }
  if (live && best_i >= 0) {
    const unsigned long long packed =
        ((unsigned long long)order_key(best_t) << 32) |
        (unsigned long long)(unsigned int)best_i;
    atomicMin(best + i, packed);
  }
}

constexpr int RPT = 2;                  // rays per thread (K2)
constexpr int RB = TILE * RPT;          // rays per K2 work item
constexpr int TILE_F4 = TILE * NF / 4;  // float4 per triangle tile
constexpr unsigned FULL = 0xffffffffu;

// One ray of K2, in registers.
struct Seg {
  float ox, oy, oz;      // origin − center
  float dx, dy, dz;
  float mx, my, mz;      // (o − center) × d
  float t_lo, t_hi;
  int e0, e1, e2, row;
  bool todo;             // live and not yet occluded
};

__device__ __forceinline__ void load_seg(Seg& s, int row, const float* ro,
                                         const float* rd, const float* tmin,
                                         const float* tmax, const int* ex,
                                         float cx, float cy, float cz) {
  s.row = row;
  s.todo = row >= 0;
  const int r = s.todo ? row : 0;
  s.dx = rd[3 * r]; s.dy = rd[3 * r + 1]; s.dz = rd[3 * r + 2];
  s.ox = ro[3 * r] - cx; s.oy = ro[3 * r + 1] - cy; s.oz = ro[3 * r + 2] - cz;
  s.t_lo = tmin[r]; s.t_hi = tmax[r];
  s.e0 = ex[3 * r]; s.e1 = ex[3 * r + 1]; s.e2 = ex[3 * r + 2];
  s.mx = s.oy * s.dz - s.oz * s.dy;
  s.my = s.oz * s.dx - s.ox * s.dz;
  s.mz = s.ox * s.dy - s.oy * s.dx;
}

// may the segment o + t·d, t in [tmin, tmax], meet the tile's box? Box
// rows (centred at mxu_center): lo.xyz, lo.w = the tile's |v − c|∞;
// hi.xyz. Runs once per tile and ray, so its divisions are cheap.
// Twin: accel/ray_kernels.py::_tile_box_may_hit. fminf/fmaxf drop the
// NaN of 0·inf, which then never culls.
__device__ __forceinline__ bool seg_may_hit(const Seg& s, float4 lo,
                                            float4 hi) {
  const float omax = fmaxf(fmaxf(fabsf(s.ox), fabsf(s.oy)), fabsf(s.oz));
  const float pad = 2e-3f * (omax + lo.w) + 1e-6f;
  const float dlen =
      sqrtf(fmaxf(s.dx * s.dx + s.dy * s.dy + s.dz * s.dz, 1e-30f));
  const float dt = pad / dlen;
  float tn = s.t_lo - dt, tf = s.t_hi + dt;
  const float ix = 1.f / s.dx, iy = 1.f / s.dy, iz = 1.f / s.dz;
  float a = (lo.x - pad - s.ox) * ix, b = (hi.x + pad - s.ox) * ix;
  tn = fmaxf(tn, fminf(a, b)); tf = fminf(tf, fmaxf(a, b));
  a = (lo.y - pad - s.oy) * iy; b = (hi.y + pad - s.oy) * iy;
  tn = fmaxf(tn, fminf(a, b)); tf = fminf(tf, fmaxf(a, b));
  a = (lo.z - pad - s.oz) * iz; b = (hi.z + pad - s.oz) * iz;
  tn = fmaxf(tn, fminf(a, b)); tf = fminf(tf, fmaxf(a, b));
  return tn <= tf;
}

// the pair test of K1 for any hit; ids[row] is the triangle's bake-order
// id, read only for a pair that hits
__device__ __forceinline__ bool pair_hits(const Seg& s, const float4* f,
                                          const int* ids, int row) {
  const float4 a = f[0], b = f[1], c = f[2], d = f[3], e = f[4], g = f[5];
  const float s0 = s.dx * a.x + s.dy * a.y + s.dz * a.z
                 + s.mx * a.w + s.my * b.x + s.mz * b.y;
  const float s1 = s.dx * b.z + s.dy * b.w + s.dz * c.x
                 + s.mx * c.y + s.my * c.z + s.mz * c.w;
  const float s2 = s.dx * d.x + s.dy * d.y + s.dz * d.z
                 + s.mx * d.w + s.my * e.x + s.mz * e.y;
  const bool pos = (s0 >= 0.f) & (s1 >= 0.f) & (s2 >= 0.f);
  const bool neg = (s0 <= 0.f) & (s1 <= 0.f) & (s2 <= 0.f);
  const float den = s0 + s1 + s2;
  if ((pos | neg) && fabsf(den) > DEN_EPS) {
    const float tn = s.ox * e.z + s.oy * e.w + s.oz * g.x + g.y;
    const float dn = -(s.dx * e.z + s.dy * e.w + s.dz * g.x);
    const float t = tn / dn;
    if (t > s.t_lo && t <= s.t_hi) {
      const int id = __ldg(ids + row);
      return id != s.e0 && id != s.e1 && id != s.e2;
    }
  }
  return false;
}

__global__ void __launch_bounds__(TILE, 4) any_hit_kernel(
    const float* __restrict__ tri, const int* __restrict__ ids,
    const float4* __restrict__ box, int T,
    const float* __restrict__ center, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ tmin,
    const float* __restrict__ tmax, const int* __restrict__ ex,
    const int* __restrict__ rows, const int* __restrict__ count_ptr,
    int n_rows, uint8_t* occ) {
  extern __shared__ float4 sh[];          // [2][TILE_F4]
  const int tid = threadIdx.x;
  const int count = count_ptr ? *count_ptr : n_rows;
  const int ntiles = (T + TILE - 1) / TILE;
  const int nrb = (count + RB - 1) / RB;
  if (nrb == 0) return;
  // split the triangle range so that there are ~2 items per block
  int chunks = min(ntiles, max(1, (2 * (int)gridDim.x + nrb - 1) / nrb));
  const int per = (ntiles + chunks - 1) / chunks;
  chunks = (ntiles + per - 1) / per;
  const int items = nrb * chunks;
  const float cx = center[0], cy = center[1], cz = center[2];

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int rb = item % nrb, chunk = item / nrb;
    Seg s[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = rb * RB + k * TILE + tid;
      const int row = r < count ? (rows ? rows[r] : r) : -1;
      load_seg(s[k], row, ro, rd, tmin, tmax, ex, cx, cy, cz);
    }
    const int t_first = chunk * per;
    const int t_end = min(ntiles, t_first + per);
    auto load_tile = [&](int t, int stage) {
      const int n = min(TILE, T - t * TILE);
      const float4* src =
          reinterpret_cast<const float4*>(tri + (size_t)t * TILE * NF);
      float4* dst = sh + stage * TILE_F4;
      for (int k = tid; k < n * (NF / 4); k += TILE)
        cp_async16(dst + k, src + k);
      cp_async_commit();
    };
    load_tile(t_first, 0);
    for (int t = t_first; t < t_end; ++t) {
      const int stage = (t - t_first) & 1;
      if (t + 1 < t_end) {
        load_tile(t + 1, stage ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float4 lo = __ldg(box + 2 * t), hi = __ldg(box + 2 * t + 1);
      bool may = false;
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        may |= s[k].todo && seg_may_hit(s[k], lo, hi);
      if (__any_sync(FULL, may)) {
        const int base = t * TILE;
        const int n = min(TILE, T - base);
        const float4* tile = sh + stage * TILE_F4;
        for (int j = 0; j < n; ++j) {
          const float4* f = tile + j * (NF / 4);
          bool left = false;
#pragma unroll
          for (int k = 0; k < RPT; ++k) {
            if (s[k].todo && pair_hits(s[k], f, ids, base + j))
              s[k].todo = false;
            left |= s[k].todo;
          }
          if (!left) break;
        }
      }
      // stop once every ray of the item is known occluded (here or by
      // another chunk's block); the barrier also frees the stage
      bool done = true;
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        done &= !s[k].todo || *((volatile uint8_t*)occ + s[k].row) != 0;
      if (__syncthreads_and(done)) break;
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      if (s[k].row >= 0 && !s[k].todo) occ[s[k].row] = 1;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers;
// `stream` is a cudaStream_t. Each returns cudaGetLastError() after the
// launch (0 = launched).
//
// K1: `best` must hold (order_key(3.4e38f) << 32 | 0xFFFFFFFF) per ray
// before the launch.
extern "C" int wt_closest_hit(const float* tri, int T, int chunks,
                              const float* center, const float* ro,
                              const float* rd, const float* tmin,
                              const float* tmax, const int* ex, int N,
                              unsigned long long* best, void* stream) {
  if (N <= 0 || T <= 0) return 0;
  const int ntiles = (T + TILE - 1) / TILE;
  if (chunks < 1) chunks = 1;
  if (chunks > ntiles) chunks = ntiles;
  const int per = (ntiles + chunks - 1) / chunks;
  chunks = (ntiles + per - 1) / per;
  dim3 grid((N + TILE - 1) / TILE, chunks);
  closest_hit_kernel<<<grid, TILE, 0, (cudaStream_t)stream>>>(
      tri, T, per, center, ro, rd, tmin, tmax, ex, N, best);
  return (int)cudaGetLastError();
}

// K2: traces the rows rows[0 .. *count) of a need list, or, when rows and
// count are null, all rows 0 .. n_rows; tri (T, 24) rows in tile order,
// ids (T,) their bake-order ids, box (ceil(T / 256), 8) f32 tile boxes;
// `occ` (N,) u8 must be zeroed before the launch; `blocks` is the
// persistent grid size.
extern "C" int wt_any_hit(const float* tri, const int* ids, const float* box,
                          int T,
                          const float* center, const float* ro,
                          const float* rd, const float* tmin,
                          const float* tmax, const int* ex, const int* rows,
                          const int* count, int n_rows, uint8_t* occ,
                          int blocks, void* stream) {
  if (T <= 0 || blocks <= 0) return 0;
  any_hit_kernel<<<blocks, TILE, 2 * TILE_F4 * sizeof(float4),
                   (cudaStream_t)stream>>>(
      tri, ids, reinterpret_cast<const float4*>(box), T, center, ro, rd,
      tmin, tmax, ex, rows, count, n_rows, occ);
  return (int)cudaGetLastError();
}
