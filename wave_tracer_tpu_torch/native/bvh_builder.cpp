// Native host-side BVH build: binned SAH, flattened to arrays.
//
// Copy of wave_tracer_tpu/native/bvh_builder.cpp (the C++ counterpart of
// the numpy builder in accel/bvh.py, the same algorithm and array layout:
// children adjacent (right = left + 1), leaves naming a contiguous range
// of the triangle permutation). accel/bvh.py takes it above
// NATIVE_THRESHOLD triangles. Plain C ABI, loaded with ctypes by
// wave_tracer_tpu_torch/native/__init__.py, which compiles it at first use:
//
//   g++ -O3 -shared -fPIC -o _build/libwt_bvh_<hash>.so bvh_builder.cpp

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kMaxDepth = 30;
constexpr int kNumBins = 16;

struct Vec3 {
    double x = 0, y = 0, z = 0;
    Vec3() = default;
    Vec3(double a, double b, double c) : x(a), y(b), z(c) {}
    Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
    Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
    Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
    double operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline double half_area(const Vec3& mn, const Vec3& mx) {
    const double dx = std::max(mx.x - mn.x, 0.0);
    const double dy = std::max(mx.y - mn.y, 0.0);
    const double dz = std::max(mx.z - mn.z, 0.0);
    return dx * dy + dy * dz + dz * dx;
}

struct Node {
    Vec3 mn, mx;
    int32_t left = 0;    // internal: left child; leaf: first tri
    int32_t count = 0;   // 0 internal, >0 leaf triangle count
};

struct BuildCtx {
    const float* positions;   // (T, 3, 3)
    std::vector<Vec3> tmin, tmax, cent;
    std::vector<int64_t> order;
    std::vector<Node> nodes;
    int max_leaf;
};

void build_range(BuildCtx& ctx, int node_idx, int64_t s, int64_t e,
                 int depth) {
    Vec3 bmin(1e300, 1e300, 1e300), bmax(-1e300, -1e300, -1e300);
    for (int64_t i = s; i < e; ++i) {
        bmin = vmin(bmin, ctx.tmin[ctx.order[i]]);
        bmax = vmax(bmax, ctx.tmax[ctx.order[i]]);
    }
    Node& node = ctx.nodes[node_idx];
    node.mn = bmin;
    node.mx = bmax;
    const int64_t n = e - s;
    if (n <= ctx.max_leaf || depth >= kMaxDepth) {
        node.left = static_cast<int32_t>(s);
        node.count = static_cast<int32_t>(n);
        return;
    }

    // centroid bounds, split axis
    Vec3 cmin(1e300, 1e300, 1e300), cmax(-1e300, -1e300, -1e300);
    for (int64_t i = s; i < e; ++i) {
        cmin = vmin(cmin, ctx.cent[ctx.order[i]]);
        cmax = vmax(cmax, ctx.cent[ctx.order[i]]);
    }
    const Vec3 ext = cmax - cmin;
    int axis = 0;
    if (ext.y > ext[axis]) axis = 1;
    if (ext.z > ext[axis]) axis = 2;

    int64_t mid;
    if (ext[axis] <= 1e-12) {
        mid = s + n / 2;
    } else {
        // binned SAH
        const double scale = kNumBins * (1.0 - 1e-7) / ext[axis];
        int64_t counts[kNumBins] = {};
        Vec3 bmn[kNumBins], bmx[kNumBins];
        for (int b = 0; b < kNumBins; ++b) {
            bmn[b] = Vec3(1e300, 1e300, 1e300);
            bmx[b] = Vec3(-1e300, -1e300, -1e300);
        }
        for (int64_t i = s; i < e; ++i) {
            const int64_t t = ctx.order[i];
            int b = static_cast<int>((ctx.cent[t][axis] - cmin[axis]) * scale);
            b = std::min(std::max(b, 0), kNumBins - 1);
            counts[b]++;
            bmn[b] = vmin(bmn[b], ctx.tmin[t]);
            bmx[b] = vmax(bmx[b], ctx.tmax[t]);
        }
        // prefix/suffix sweeps
        double larea[kNumBins], rarea[kNumBins];
        int64_t lcnt[kNumBins], rcnt[kNumBins];
        Vec3 mn = Vec3(1e300, 1e300, 1e300),
             mx = Vec3(-1e300, -1e300, -1e300);
        int64_t c = 0;
        for (int b = 0; b < kNumBins; ++b) {
            mn = vmin(mn, bmn[b]);
            mx = vmax(mx, bmx[b]);
            c += counts[b];
            larea[b] = half_area(mn, mx);
            lcnt[b] = c;
        }
        mn = Vec3(1e300, 1e300, 1e300);
        mx = Vec3(-1e300, -1e300, -1e300);
        c = 0;
        for (int b = kNumBins - 1; b >= 0; --b) {
            mn = vmin(mn, bmn[b]);
            mx = vmax(mx, bmx[b]);
            c += counts[b];
            rarea[b] = half_area(mn, mx);
            rcnt[b] = c;
        }
        double best_cost = std::numeric_limits<double>::infinity();
        int best_b = -1;
        for (int b = 0; b < kNumBins - 1; ++b) {
            if (lcnt[b] == 0 || rcnt[b + 1] == 0) continue;
            const double cost = larea[b] * lcnt[b] + rarea[b + 1] * rcnt[b + 1];
            if (cost < best_cost) {
                best_cost = cost;
                best_b = b;
            }
        }
        if (best_b < 0) {
            mid = s + n / 2;
        } else {
            // partition (stable)
            auto pred = [&](int64_t t) {
                int b = static_cast<int>((ctx.cent[t][axis] - cmin[axis]) * scale);
                b = std::min(std::max(b, 0), kNumBins - 1);
                return b <= best_b;
            };
            mid = std::stable_partition(ctx.order.begin() + s,
                                        ctx.order.begin() + e, pred) -
                  ctx.order.begin();
            if (mid == s || mid == e) mid = s + n / 2;
        }
    }

    const int li = static_cast<int>(ctx.nodes.size());
    ctx.nodes.emplace_back();
    ctx.nodes.emplace_back();
    ctx.nodes[node_idx].left = li;
    ctx.nodes[node_idx].count = 0;
    build_range(ctx, li, s, mid, depth + 1);
    build_range(ctx, li + 1, mid, e, depth + 1);
}

BuildCtx* g_last = nullptr;

}  // namespace

extern "C" {

// Build; returns number of nodes. Call wt_bvh_read to copy results out.
int64_t wt_bvh_build(const float* positions, int64_t T, int max_leaf) {
    delete g_last;
    auto* ctx = new BuildCtx();
    g_last = ctx;
    ctx->positions = positions;
    ctx->max_leaf = max_leaf;
    ctx->tmin.resize(T);
    ctx->tmax.resize(T);
    ctx->cent.resize(T);
    ctx->order.resize(T);
    for (int64_t t = 0; t < T; ++t) {
        const float* p = positions + t * 9;
        Vec3 a(p[0], p[1], p[2]), b(p[3], p[4], p[5]), c(p[6], p[7], p[8]);
        ctx->tmin[t] = vmin(a, vmin(b, c));
        ctx->tmax[t] = vmax(a, vmax(b, c));
        ctx->cent[t] = (ctx->tmin[t] + ctx->tmax[t]) * 0.5;
        ctx->order[t] = t;
    }
    ctx->nodes.reserve(2 * static_cast<size_t>(T) + 1);
    ctx->nodes.emplace_back();
    if (T > 0) build_range(*ctx, 0, 0, T, 0);
    return static_cast<int64_t>(ctx->nodes.size());
}

void wt_bvh_read(float* node_min, float* node_max, int32_t* node_left,
                 int32_t* node_count, int32_t* tri_order) {
    if (!g_last) return;
    const auto& nodes = g_last->nodes;
    for (size_t i = 0; i < nodes.size(); ++i) {
        node_min[i * 3 + 0] = static_cast<float>(nodes[i].mn.x);
        node_min[i * 3 + 1] = static_cast<float>(nodes[i].mn.y);
        node_min[i * 3 + 2] = static_cast<float>(nodes[i].mn.z);
        node_max[i * 3 + 0] = static_cast<float>(nodes[i].mx.x);
        node_max[i * 3 + 1] = static_cast<float>(nodes[i].mx.y);
        node_max[i * 3 + 2] = static_cast<float>(nodes[i].mx.z);
        node_left[i] = nodes[i].left;
        node_count[i] = nodes[i].count;
    }
    for (size_t i = 0; i < g_last->order.size(); ++i)
        tri_order[i] = static_cast<int32_t>(g_last->order[i]);
    delete g_last;
    g_last = nullptr;
}

}  // extern "C"
