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
//   pair (~35 issued instructions: six broadcast shared-memory loads, the
//   sides, the sign tests), so instruction issue sets the pace, over the
//   pairs a ray cannot rule out. All pairs of a 262,144-lane pool × 81,932
//   triangles are 2.1e10, but a ray needs only the tiles its segment
//   meets: a ray inside the box meets its wall's tile and, at most, the
//   few tiles of the icosphere in front of that wall. Both kernels read
//   the same copy of the triangles (`RayTable`, accel/ray_kernels.py):
//   sorted by tile_order so that each 256-triangle tile is compact, with
//   each row's bake-order id (exclusions and ties compare it) and each
//   tile's world box (tile_boxes); and both take a need list, the rows to
//   trace as a device-side list (int32 row ids and their count, made by a
//   cumsum on the device), so that a caller never traces rows whose
//   result it has or does not read and never syncs with the host.
//
// K1 (closest_hit_kernel), redesigned for the card:
//   * rows off the need list keep the word the caller put in `best` (the
//     pool carries each lane's last hit, which stays exact while the
//     lane's ray does not change);
//   * a persistent grid of 3 blocks per SM takes work items (512 listed
//     rays × a chunk of the tiles) from an atomic queue, the chunk that
//     holds the last tiles first: tile_order puts the big triangles last,
//     and they give most rays their closest hit;
//   * per item, each tile's entry key: the least entry, over the item's
//     rays, into the tile's padded box (seg_range, the range of K2's
//     cull); a bitonic sort in shared memory orders the tiles near to far,
//     and the block walks them in that order, so that t_hi shrinks early;
//   * per tile, a warp skips it when __any_sync finds no segment
//     [tmin, best t] that meets the padded box (seg_may_hit, K2's cull,
//     which never drops a pair the pair test accepts; the range is closed,
//     so a tile whose entry equals the best t is still tested and a tie
//     still goes to the smaller id);
//   * the block stops when the next tile's key lies beyond every ray's
//     best t + 2·dt_max (dt_max: the pad over |d| with the chunk's largest
//     tile extent; one dt covers the cull's own pad, the second rounding
//     between the two evaluations of the range);
//   * in-thread, the running minimum compares the packed word
//     (order_key(t) << 32 | id): in tile order ids do not rise with the
//     loop; the words merge across chunks with a 64-bit atomicMin, and a
//     chunk's block shrinks t_hi from the global word after each tile;
//   * two rays per thread, tiles through a 2-stage cp.async ring, as K2.
//
// K2 (any_hit_kernel), redesigned for the card:
//   * rows off the need list stay "not occluded";
//   * a persistent grid of 4 blocks per SM walks (ray-block × triangle-
//     chunk) work items up to the count the kernel reads itself, so a
//     short list still fills every SM;
//   * two rays per thread (register blocking): each broadcast load of a
//     triangle row serves two pairs;
//   * a per-warp tile cull: a warp skips the tile when __any_sync says
//     none of its segments [tmin, tmax] meets the box, padded by
//     2e-3·(|o − c|∞ + the tile's |v − c|∞) so that it never drops a pair
//     the Plücker test would accept (the sides' rounding grows with those
//     magnitudes);
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
constexpr float DEN_EPS = 1e-12f;

// unsigned key that orders like the float: negatives have all bits flipped,
// the rest only the sign bit
__device__ __forceinline__ unsigned int order_key(float x) {
  const unsigned int b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the float of an order_key
__device__ __forceinline__ float key_float(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
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

constexpr int RPT = 2;                  // rays per thread
constexpr int RB = TILE * RPT;          // rays per work item
constexpr int TILE_F4 = TILE * NF / 4;  // float4 per triangle tile
constexpr unsigned FULL = 0xffffffffu;

// One ray, in registers.
struct Seg {
  float ox, oy, oz;      // origin − center
  float dx, dy, dz;
  float mx, my, mz;      // (o − center) × d
  float t_lo, t_hi;
  int e0, e1, e2, row;
  bool todo;             // K2: live and not yet occluded; K1: live
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

__device__ __forceinline__ float seg_omax(const Seg& s) {
  return fmaxf(fmaxf(fabsf(s.ox), fabsf(s.oy)), fabsf(s.oz));
}
__device__ __forceinline__ float seg_dlen(const Seg& s) {
  return sqrtf(fmaxf(s.dx * s.dx + s.dy * s.dy + s.dz * s.dz, 1e-30f));
}

// the range [tn, tf] of t on which the segment o + t·d, t in [tmin, tmax],
// lies in the tile's padded box (empty when tn > tf). Box rows (centred at
// mxu_center): lo.xyz, lo.w = the tile's |v − c|∞; hi.xyz. Runs once per
// tile and ray, so its divisions are cheap. tn does not depend on tmax.
// fminf/fmaxf drop the NaN of 0·inf, which then never culls.
__device__ __forceinline__ void seg_range(const Seg& s, float4 lo, float4 hi,
                                          float& tn, float& tf) {
  const float pad = 2e-3f * (seg_omax(s) + lo.w) + 1e-6f;
  const float dt = pad / seg_dlen(s);
  tn = s.t_lo - dt; tf = s.t_hi + dt;
  const float ix = 1.f / s.dx, iy = 1.f / s.dy, iz = 1.f / s.dz;
  float a = (lo.x - pad - s.ox) * ix, b = (hi.x + pad - s.ox) * ix;
  tn = fmaxf(tn, fminf(a, b)); tf = fminf(tf, fmaxf(a, b));
  a = (lo.y - pad - s.oy) * iy; b = (hi.y + pad - s.oy) * iy;
  tn = fmaxf(tn, fminf(a, b)); tf = fminf(tf, fmaxf(a, b));
  a = (lo.z - pad - s.oz) * iz; b = (hi.z + pad - s.oz) * iz;
  tn = fmaxf(tn, fminf(a, b)); tf = fminf(tf, fmaxf(a, b));
}

// may the segment meet the tile's box? Twin:
// accel/ray_kernels.py::_tile_box_may_hit.
__device__ __forceinline__ bool seg_may_hit(const Seg& s, float4 lo,
                                            float4 hi) {
  float tn, tf;
  seg_range(s, lo, hi, tn, tf);
  return tn <= tf;
}

// the Plücker pair test: true, with t = tn / (d·N), when the three sides
// share a sign and |their sum| > DEN_EPS. d·N equals the sum of the sides
// but is taken directly: for small triangles far from mxu_center the
// sides cancel and their sum carries ~1e-4 relative error, while d·N does
// not. The IEEE division runs only for pairs that pass the sign test.
__device__ __forceinline__ bool pair_t(const Seg& s, const float4* f,
                                       float& t) {
  const float4 a = f[0], b = f[1], c = f[2], d = f[3], e = f[4], g = f[5];
  // rows: [A×B | B−A | B×C | C−B | C×A | A−C | −N | N·A | pad2]
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
    t = tn / dn;
    return true;
  }
  return false;
}

// the pair test for any hit; ids[row] is the triangle's bake-order id,
// read only for a pair that hits
__device__ __forceinline__ bool pair_hits(const Seg& s, const float4* f,
                                          const int* ids, int row) {
  float t;
  if (pair_t(s, f, t) && t > s.t_lo && t <= s.t_hi) {
    const int id = __ldg(ids + row);
    return id != s.e0 && id != s.e1 && id != s.e2;
  }
  return false;
}

// stage tile t (its n rows) into ring stage `stage` with cp.async
__device__ __forceinline__ void stage_tile(float4* sh, const float* tri,
                                          int T, int t, int stage, int tid) {
  const int n = min(TILE, T - t * TILE);
  const float4* src =
      reinterpret_cast<const float4*>(tri + (size_t)t * TILE * NF);
  float4* dst = sh + stage * TILE_F4;
  for (int k = tid; k < n * (NF / 4); k += TILE) cp_async16(dst + k, src + k);
  cp_async_commit();
}

constexpr int K1_BLOCKS = 3;            // K1's blocks per SM
constexpr int K1_MAX_TILES = 512;       // tiles per K1 chunk (T ≤ 2^17)
constexpr int K1_MAX_CHUNKS = 4;        // K1's split of the tiles
constexpr unsigned NO_KEY = 0xffffffffu;   // a tile no ray of the item meets
constexpr unsigned long long NO_HIT =
    0xff7fc99effffffffull;              // order_key(BIG) << 32 | 0xFFFFFFFF

__global__ void __launch_bounds__(TILE, K1_BLOCKS) closest_hit_kernel(
    const float* __restrict__ tri, const int* __restrict__ ids,
    const float4* __restrict__ box, int T, int every_pair,
    const float* __restrict__ center, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ tmin,
    const float* __restrict__ tmax, const int* __restrict__ ex,
    const int* __restrict__ rows, const int* __restrict__ count_ptr,
    int n_rows, unsigned long long* best, int* queue) {
  extern __shared__ float4 sh[];  // [2][TILE_F4] ring | keys | sorted keys
  unsigned* skey = reinterpret_cast<unsigned*>(sh + 2 * TILE_F4);
  unsigned long long* sorted =
      reinterpret_cast<unsigned long long*>(skey + K1_MAX_TILES);
  __shared__ int s_item;
  const int tid = threadIdx.x, lane = tid & 31;
  // every_pair: keep tile order (every key 0), never stop early and never
  // cull: the reference the near-to-far walk and its culls are held to
  const bool cull = !every_pair;
  const int count = count_ptr ? *count_ptr : n_rows;
  const int ntiles = (T + TILE - 1) / TILE;
  const int nrb = (count + RB - 1) / RB;
  if (nrb == 0) return;
  // split the tiles only when there are fewer ray blocks than blocks
  int chunks = min(min(K1_MAX_CHUNKS, ntiles),
                   max(1, ((int)gridDim.x + nrb - 1) / nrb));
  const int per = (ntiles + chunks - 1) / chunks;
  chunks = (ntiles + per - 1) / per;
  const int items = nrb * chunks;
  const float cx = center[0], cy = center[1], cz = center[2];

  for (;;) {
    if (tid == 0) s_item = atomicAdd(queue, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= items) return;
    const int chunk = chunks - 1 - item / nrb, rb = item % nrb;
    const int c0 = chunk * per, nt = min(ntiles, c0 + per) - c0;
    Seg s[RPT];
    unsigned long long w[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = rb * RB + k * TILE + tid;
      load_seg(s[k], r < count ? (rows ? rows[r] : r) : -1, ro, rd, tmin,
               tmax, ex, cx, cy, cz);
      w[k] = NO_HIT;
    }
    for (int i = tid; i < nt; i += TILE) skey[i] = cull ? NO_KEY : 0u;
    __syncthreads();
    // each tile's key: the least entry of the item's rays into its box
    float smax = 0.f;
    for (int i = 0; i < nt; ++i) {
      const float4 lo = __ldg(box + 2 * (c0 + i));
      smax = fmaxf(smax, lo.w);
      if (!cull) continue;
      const float4 hi = __ldg(box + 2 * (c0 + i) + 1);
      unsigned m = NO_KEY;
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        if (!s[k].todo) continue;
        float tn, tf;
        seg_range(s[k], lo, hi, tn, tf);
        if (tn <= tf) m = min(m, order_key(tn));
      }
      m = __reduce_min_sync(FULL, m);
      if (lane == 0 && m != NO_KEY) atomicMin(skey + i, m);
    }
    float reach[RPT];   // 2·dt_max: how far past its best t a ray reaches
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      reach[k] = 2.f * ((2e-3f * (seg_omax(s[k]) + smax) + 1e-6f) /
                        seg_dlen(s[k]));
    __syncthreads();
    // sort (key << 32 | tile) ascending: near to far, tiles no ray meets
    // last
    int P = 1;
    while (P < nt) P <<= 1;
    for (int i = tid; i < P; i += TILE)
      sorted[i] = i < nt ? ((unsigned long long)skey[i] << 32) | (unsigned)i
                         : ~0ull;
    __syncthreads();
    for (int size = 2; size <= P; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < P; i += TILE) {
          const int j = i ^ stride;
          if (j > i) {
            const unsigned long long a = sorted[i], b = sorted[j];
            if ((a > b) == ((i & size) == 0)) {
              sorted[i] = b;
              sorted[j] = a;
            }
          }
        }
        __syncthreads();
      }
    // walk the tiles near to far
    if ((unsigned)(sorted[0] >> 32) != NO_KEY)
      stage_tile(sh, tri, T, c0 + (int)(sorted[0] & 0xffffu), 0, tid);
    for (int p = 0; p < nt; ++p) {
      const unsigned long long e = sorted[p];
      if ((unsigned)(e >> 32) == NO_KEY) break;
      // stop once no ray of the block reaches the tile's entry key; the
      // barrier also frees the stage the next load overwrites
      bool go = !cull;
      const float kf = key_float((unsigned)(e >> 32));
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        go |= s[k].todo && s[k].t_hi + reach[k] >= kf;
      if (!__syncthreads_or(go)) break;
      const int t = c0 + (int)(e & 0xffffu), stage = p & 1;
      if (p + 1 < nt && (unsigned)(sorted[p + 1] >> 32) != NO_KEY) {
        stage_tile(sh, tri, T, c0 + (int)(sorted[p + 1] & 0xffffu),
                  stage ^ 1, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float4 lo = __ldg(box + 2 * t), hi = __ldg(box + 2 * t + 1);
      bool may = !cull;
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        may |= s[k].todo && seg_may_hit(s[k], lo, hi);
      if (__any_sync(FULL, may)) {
        const int base = t * TILE;
        const int n = min(TILE, T - base);
        const float4* tile = sh + stage * TILE_F4;
        for (int j = 0; j < n; ++j) {
          const float4* f = tile + j * (NF / 4);
#pragma unroll
          for (int k = 0; k < RPT; ++k) {
            float th;
            if (s[k].todo && pair_t(s[k], f, th) && th > s[k].t_lo &&
                th <= s[k].t_hi) {
              const int id = __ldg(ids + base + j);
              const unsigned long long word =
                  ((unsigned long long)order_key(th) << 32) | (unsigned)id;
              if (id != s[k].e0 && id != s[k].e1 && id != s[k].e2 &&
                  word < w[k]) {
                w[k] = word;
                s[k].t_hi = th;
              }
            }
          }
        }
      }
      if (chunks > 1) {
        // share the best so far with the other chunks' blocks of these
        // rows, and take theirs: t_hi shrinks to the global word's t (a
        // tie with a smaller id here still passes t <= t_hi)
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          if (!s[k].todo) continue;
          if (w[k] != NO_HIT) atomicMin(best + s[k].row, w[k]);
          const unsigned long long g =
              *((volatile unsigned long long*)best + s[k].row);
          if (g != NO_HIT)
            s[k].t_hi = fminf(s[k].t_hi, key_float((unsigned)(g >> 32)));
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      if (s[k].todo && w[k] != NO_HIT) atomicMin(best + s[k].row, w[k]);
    __syncthreads();
  }
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
    stage_tile(sh, tri, T, t_first, 0, tid);
    for (int t = t_first; t < t_end; ++t) {
      const int stage = (t - t_first) & 1;
      if (t + 1 < t_end) {
        stage_tile(sh, tri, T, t + 1, stage ^ 1, tid);
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
// K1: traces the rows rows[0 .. *count) of a need list, or, when rows and
// count are null, all rows 0 .. n_rows, over tri (T, 24) rows in tile
// order, ids (T,) their bake-order ids, box (ceil(T / 256), 8) f32 tile
// boxes; `best` (N,) holds each row's initial word: (order_key(3.4e38f) <<
// 32 | 0xFFFFFFFF) for a listed row, the word it keeps for the rest.
// `queue` (1,) i32 must be zeroed before the launch; `blocks` is the
// persistent grid size; every_pair != 0 tests every pair of every tile
// (the reference of the walk and its culls: the same words, slower).
// The dynamic shared memory (above the 48 KB default) is allowed on every
// launch, so that any card of the process may run it.
extern "C" int wt_closest_hit(const float* tri, const int* ids,
                              const float* box, int T, int every_pair,
                              const float* center, const float* ro,
                              const float* rd, const float* tmin,
                              const float* tmax, const int* ex,
                              const int* rows, const int* count, int n_rows,
                              unsigned long long* best, int* queue,
                              int blocks, void* stream) {
  if (T <= 0 || blocks <= 0) return 0;
  if ((T + TILE - 1) / TILE > K1_MAX_TILES) return (int)cudaErrorInvalidValue;
  const int smem = 2 * TILE_F4 * sizeof(float4) +
                   K1_MAX_TILES * (sizeof(unsigned) + sizeof(uint64_t));
  const cudaError_t e = cudaFuncSetAttribute(
      closest_hit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  closest_hit_kernel<<<blocks, TILE, smem, (cudaStream_t)stream>>>(
      tri, ids, reinterpret_cast<const float4*>(box), T, every_pair,
      center, ro, rd, tmin, tmax, ex, rows, count, n_rows, best, queue);
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
