// All-pairs ray-triangle kernels for Hopper (sm_90a): closest hit (K1) and
// any hit (K2) from one templated body.
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
//   table (T × 96 bytes) is read once per block from L2.
//
// What the design does about it:
//   * one thread per ray; a block stages tiles of 256 triangles × 24 floats
//     (24 KB) in shared memory, where every thread reads the same word
//     (broadcast, no bank conflicts) — the loop over tiles takes the place
//     of the Pallas grid's sequential triangle axis;
//   * compact per-triangle rows (T, 24): only the 22 non-zero coefficients
//     of the 16-wide MXU contraction, evaluated as explicit fp32 FMAs;
//   * the IEEE division runs only for pairs that pass the sign test;
//   * the triangle range is split across blockIdx.y so that small ray
//     batches still fill all SMs; partial results merge with one 64-bit
//     atomicMin on (key(t) << 32 | id), where key(t) is an unsigned key
//     that orders like t for either sign, so the merge orders exactly like
//     the sequential (t, then id) minimum for any tmin;
//   * any hit stops a block once all its rays are occluded.
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

template <bool ANYHIT>
__global__ void __launch_bounds__(TILE) ray_tri_kernel(
    const float* __restrict__ tri, int T, int tiles_per_chunk,
    const float* __restrict__ center,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const int* __restrict__ ex, int N,
    unsigned long long* __restrict__ best, uint8_t* occ_out) {
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
  bool hit_any = false;

  const int first = blockIdx.y * tiles_per_chunk * TILE;
  const int last = min(T, first + tiles_per_chunk * TILE);
  for (int base = first; base < last; base += TILE) {
    const int n = min(TILE, last - base);
    __syncthreads();
    const float4* src = reinterpret_cast<const float4*>(tri + (size_t)base * NF);
    for (int k = threadIdx.x; k < n * (NF / 4); k += TILE) sh[k] = src[k];
    __syncthreads();
    if (live && !(ANYHIT && hit_any)) {
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
          if (t > t_lo && t <= t_hi && id != e0 && id != e1 && id != e2) {
            if (ANYHIT) {
              hit_any = true;
              break;
            }
            if (t < best_t) {
              best_t = t;
              best_i = id;
            }
          }
        }
      }
    }
    if (ANYHIT) {
      // stop once every ray of the block is known occluded (here or by
      // another chunk's block)
      const bool done = !live || hit_any ||
                        *((volatile uint8_t*)occ_out + i) != 0;
      if (__syncthreads_and(done)) break;
    }
  }
  if (!live) return;
  if (ANYHIT) {
    if (hit_any) occ_out[i] = 1;
  } else if (best_i >= 0) {
    const unsigned long long packed =
        ((unsigned long long)order_key(best_t) << 32) |
        (unsigned long long)(unsigned int)best_i;
    atomicMin(best + i, packed);
  }
}

template <bool ANYHIT>
int launch(const float* tri, int T, int chunks, const float* center,
           const float* ro, const float* rd, const float* tmin,
           const float* tmax, const int* ex, int N, unsigned long long* best,
           uint8_t* occ, cudaStream_t stream) {
  if (N <= 0 || T <= 0) return 0;
  const int ntiles = (T + TILE - 1) / TILE;
  if (chunks < 1) chunks = 1;
  if (chunks > ntiles) chunks = ntiles;
  const int per = (ntiles + chunks - 1) / chunks;
  chunks = (ntiles + per - 1) / per;
  dim3 grid((N + TILE - 1) / TILE, chunks);
  ray_tri_kernel<ANYHIT><<<grid, TILE, 0, stream>>>(
      tri, T, per, center, ro, rd, tmin, tmax, ex, N, best, occ);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers;
// `stream` is a cudaStream_t. Each returns cudaGetLastError() after the
// launch (0 = launched). `best` must hold (order_key(3.4e38f) << 32 |
// 0xFFFFFFFF) per ray before the closest-hit launch; `occ` must be zeroed
// before the any-hit launch.
extern "C" int wt_closest_hit(const float* tri, int T, int chunks,
                              const float* center, const float* ro,
                              const float* rd, const float* tmin,
                              const float* tmax, const int* ex, int N,
                              unsigned long long* best, void* stream) {
  return launch<false>(tri, T, chunks, center, ro, rd, tmin, tmax, ex, N,
                       best, nullptr, (cudaStream_t)stream);
}

extern "C" int wt_any_hit(const float* tri, int T, int chunks,
                          const float* center, const float* ro,
                          const float* rd, const float* tmin,
                          const float* tmax, const int* ex, int N,
                          uint8_t* occ, void* stream) {
  return launch<true>(tri, T, chunks, center, ro, rd, tmin, tmax, ex, N,
                      nullptr, occ, (cudaStream_t)stream);
}
