// BVH traversal kernels for Hopper (sm_90a): closest hit (K4) and any hit
// (K5) over the flat binary BVH of accel/bvh.py.
//
// Replaces no Pallas kernel. The JAX package traces a scene above
// MXU_MAX_TRIS = 2^17 triangles with a lock-step stack traversal
// (wave_tracer_tpu/accel/trace.py::trace_bvh, ::occluded_bvh), which runs
// on the device as one lax.while_loop. The same loop in eager torch is a
// Python loop of ~100 operations a step that syncs the host at every step
// (to ask whether any lane is still walking), over hundreds of steps, for
// each of the wave bounce's ray queries: these two kernels are the port's
// counterpart of that device loop. accel/bvh_kernels.py holds their plain
// twins (`_closest_ref`, `_anyhit_ref`), which are that lock-step loop.
//
// What each computes, per ray, exactly as its twin:
//   * a per-ray stack of MAX_DEPTH + 2 = 32 node ids, the root pre-pushed;
//     each step pops one node (row of node_pack: count, left, the two
//     children's boxes inline);
//   * K4, internal node: slab tests of both children against [tmin, best
//     t], the nearer entry (left on a tie) pushed last so that it pops
//     first; leaf: Möller–Trumbore on each of its (<= 4) triangles,
//     skipping the one excluded id, against [tmin, best t]; a strictly
//     smaller t wins. Out: the closest t (BIG on a miss) and its triangle
//     (−1);
//   * K5: slab tests against [tmin, tmax], the right child pushed first;
//     leaf triangles against three excluded ids; the walk ends at the
//     first hit. Out: occluded or not;
//   * rows off the `need` mask are neither read nor traced: K4 writes the
//     caller's carried (t, triangle) there (a miss if none), K5 "not
//     occluded".
//
// What bounds it on the card: per visited internal node 24 fp32
// operations (two slab tests), per tested triangle 46, so a ray costs a
// few thousand operations; at 262,144 rays over 327,692 triangles the
// bound is the bytes (the node and triangle rows once, each ray in and
// out once), some 0.02 ms. What it does about that: nothing yet. One
// thread per ray, a stack in local memory, the node and triangle rows
// read through the read-only cache as float4; the rays of a warp diverge
// in their walks, and the warp waits for its longest walk. A warp-
// coherent (packet) walk or a wider tree is later work.
//
// Precision: fp32, built with -fmad=false and without fast math (IEEE
// divisions): every operation rounds once, in the order of the twins'
// separate torch operations (ops/intersect.py), so the outputs equal the
// twins' bit for bit. min and max propagate NaN, as torch.minimum does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int STACK = 32;            // accel/bvh_kernels.py STACK
constexpr int LEAF_TILE = 4;         // accel/bvh.py LEAF_TILE
constexpr float BIGF = 3.4e38f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float nmin(float a, float b) {
  return a < b ? a : (b <= a ? b : NAN);
}

__device__ __forceinline__ float nmax(float a, float b) {
  return a > b ? a : (b >= a ? b : NAN);
}

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;    // ((x + y) + z)
}

__device__ __forceinline__ V3 safe_inverse(V3 d) {
  auto inv = [](float c) {
    const float tiny = c < 0.0f ? -1e-30f : 1e-30f;
    return 1.0f / (fabsf(c) < 1e-30f ? tiny : c);
  };
  return V3{inv(d.x), inv(d.y), inv(d.z)};
}

// Slab test of the ray against [lo, hi] over [tmin, tmax]: the entry t,
// and whether it does not pass the exit.
__device__ __forceinline__ bool slab(V3 o, V3 inv, V3 lo, V3 hi, float tmin,
                                     float tmax, float* t_enter) {
  const float ax = (lo.x - o.x) * inv.x, bx = (hi.x - o.x) * inv.x;
  const float ay = (lo.y - o.y) * inv.y, by = (hi.y - o.y) * inv.y;
  const float az = (lo.z - o.z) * inv.z, bz = (hi.z - o.z) * inv.z;
  const float te = nmax(nmax(nmax(nmin(ax, bx), nmin(ay, by)),
                             nmin(az, bz)), tmin);
  const float tx = nmin(nmin(nmin(nmax(ax, bx), nmax(ay, by)),
                             nmax(az, bz)), tmax);
  *t_enter = te;
  return te <= tx;
}

// Two-sided Möller–Trumbore against triangle row `tri` (p0, e1, e2 in the
// first 9 of its 12 floats); t of a hit in (tmin, tmax].
__device__ __forceinline__ bool ray_tri(V3 o, V3 d, const float4* tri,
                                        float tmin, float tmax, float* t_out) {
  const float4 a = __ldg(tri), b = __ldg(tri + 1), c = __ldg(tri + 2);
  const V3 p0{a.x, a.y, a.z}, e1{a.w, b.x, b.y}, e2{b.z, b.w, c.x};
  const V3 pvec = cross(d, e2);
  const float det = dot(e1, pvec);
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
  const V3 tvec = sub(o, p0);
  const float u = dot(tvec, pvec) * inv_det;
  const V3 qvec = cross(tvec, e1);
  const float v = dot(d, qvec) * inv_det;
  const float t = dot(e2, qvec) * inv_det;
  *t_out = t;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
         t <= tmax;
}

struct NodeRow {
  int count, left;
  V3 lmin, lmax, rmin, rmax;
};

__device__ __forceinline__ NodeRow load_node(const float4* nodes, int n) {
  const float4 a = __ldg(nodes + 4 * n), b = __ldg(nodes + 4 * n + 1);
  const float4 c = __ldg(nodes + 4 * n + 2), e = __ldg(nodes + 4 * n + 3);
  NodeRow r;
  r.count = (int)a.x;
  r.left = (int)a.y;
  r.lmin = V3{a.z, a.w, b.x};
  r.lmax = V3{b.y, b.z, b.w};
  r.rmin = V3{c.x, c.y, c.z};
  r.rmax = V3{c.w, e.x, e.y};
  return r;
}

__global__ void __launch_bounds__(BLOCK)
bvh_closest_kernel(const float4* __restrict__ nodes,
                   const float4* __restrict__ tris,
                   const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ tmin_,
                   const float* __restrict__ tmax_,
                   const int* __restrict__ ex, const uint8_t* __restrict__ need,
                   const float* __restrict__ carry_t,
                   const int* __restrict__ carry_i, int N,
                   float* __restrict__ out_t, int* __restrict__ out_i) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= N) return;
  if (need && !need[i]) {
    out_t[i] = carry_t ? carry_t[i] : BIGF;
    out_i[i] = carry_i ? carry_i[i] : -1;
    return;
  }
  const V3 o = load3(ro, i), d = load3(rd, i);
  const V3 inv = safe_inverse(d);
  const float tmin = tmin_[i];
  const int excl = ex[i];
  float best_t = nmin(tmax_[i], BIGF);
  int best_i = -1;
  int stack[STACK];
  stack[0] = 0;
  int sp = 1;
  while (sp > 0) {
    const NodeRow nd = load_node(nodes, stack[--sp]);
    if (nd.count == 0) {
      float lt, rt;
      const bool lhit = slab(o, inv, nd.lmin, nd.lmax, tmin, best_t, &lt);
      const bool rhit = slab(o, inv, nd.rmin, nd.rmax, tmin, best_t, &rt);
      const bool l_near = lt <= rt;
      const int first = l_near ? nd.left : nd.left + 1;
      const int second = l_near ? nd.left + 1 : nd.left;
      const bool first_hit = l_near ? lhit : rhit;
      const bool second_hit = l_near ? rhit : lhit;
      if (second_hit && sp < STACK) stack[sp++] = second;
      if (first_hit && sp < STACK) stack[sp++] = first;
    } else {
#pragma unroll
      for (int k = 0; k < LEAF_TILE; ++k) {
        const int ti = nd.left + k;
        if (k >= nd.count || ti == excl) continue;
        float t;
        if (ray_tri(o, d, tris + 3 * ti, tmin, best_t, &t) && t < best_t) {
          best_t = t;
          best_i = ti;
        }
      }
    }
  }
  out_t[i] = best_i >= 0 ? best_t : BIGF;
  out_i[i] = best_i;
}

__global__ void __launch_bounds__(BLOCK)
bvh_any_kernel(const float4* __restrict__ nodes,
               const float4* __restrict__ tris, const float* __restrict__ ro,
               const float* __restrict__ rd, const float* __restrict__ tmin_,
               const float* __restrict__ tmax_, const int* __restrict__ ex,
               const uint8_t* __restrict__ need, int N,
               uint8_t* __restrict__ occ) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= N) return;
  if (need && !need[i]) {
    occ[i] = 0;
    return;
  }
  const V3 o = load3(ro, i), d = load3(rd, i);
  const V3 inv = safe_inverse(d);
  const float tmin = tmin_[i], tmax = tmax_[i];
  const int x0 = ex[3 * i], x1 = ex[3 * i + 1], x2 = ex[3 * i + 2];
  int stack[STACK];
  stack[0] = 0;
  int sp = 1;
  bool hit = false;
  while (sp > 0 && !hit) {
    const NodeRow nd = load_node(nodes, stack[--sp]);
    if (nd.count == 0) {
      float te;
      const bool lhit = slab(o, inv, nd.lmin, nd.lmax, tmin, tmax, &te);
      const bool rhit = slab(o, inv, nd.rmin, nd.rmax, tmin, tmax, &te);
      if (rhit && sp < STACK) stack[sp++] = nd.left + 1;
      if (lhit && sp < STACK) stack[sp++] = nd.left;
    } else {
      for (int k = 0; k < LEAF_TILE && k < nd.count && !hit; ++k) {
        const int ti = nd.left + k;
        if (ti == x0 || ti == x1 || ti == x2) continue;
        float t;
        hit = ray_tri(o, d, tris + 3 * ti, tmin, tmax, &t);
      }
    }
  }
  occ[i] = hit ? 1 : 0;
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers;
// `stream` is a cudaStream_t. nodes (M, 16) f32 node_pack rows, tris (T,
// 12) f32 tri_geom rows, both 16-byte aligned; ro, rd (N, 3), tmin, tmax
// (N,) f32; need (N,) u8 or null (all rows). Each returns
// cudaGetLastError() after its launch (0 = launched).

// K4: ex (N,) i32 excluded ids (−1 none); carry_t (N,) f32 / carry_i (N,)
// i32 the rows off `need` return (null: a miss); out_t (N,) f32, out_i
// (N,) i32.
extern "C" int wt_bvh_closest(const float* nodes, const float* tris,
                              const float* ro, const float* rd,
                              const float* tmin, const float* tmax,
                              const int* ex, const uint8_t* need,
                              const float* carry_t, const int* carry_i,
                              int N, float* out_t, int* out_i,
                              void* stream) {
  if (N <= 0) return 0;
  bvh_closest_kernel<<<(N + BLOCK - 1) / BLOCK, BLOCK, 0,
                       (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), ro, rd, tmin, tmax, ex, need,
      carry_t, carry_i, N, out_t, out_i);
  return (int)cudaGetLastError();
}

// K5: ex (N, 3) i32 excluded ids (−1 none); occ (N,) u8.
extern "C" int wt_bvh_any(const float* nodes, const float* tris,
                          const float* ro, const float* rd, const float* tmin,
                          const float* tmax, const int* ex,
                          const uint8_t* need, int N, uint8_t* occ,
                          void* stream) {
  if (N <= 0) return 0;
  bvh_any_kernel<<<(N + BLOCK - 1) / BLOCK, BLOCK, 0,
                   (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), ro, rd, tmin, tmax, ex, need, N,
      occ);
  return (int)cudaGetLastError();
}
