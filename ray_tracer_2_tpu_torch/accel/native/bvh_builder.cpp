// Native SAH BVH builder — a copy of ray_tracer_2_tpu/accel/native's, the
// equivalent of the reference's rayon-parallel Rust builder
// (src/core/bvh.rs). Exposed to Python over a plain C ABI (ctypes);
// semantics identical to accel/bvh.py:
//   * binned SAH (32 bins) over the centroid extent of each axis,
//   * split accepted when cost < half_area(parent) * count (bvh.rs:352-370),
//   * leaves terminated at <= max_leaf triangles (one traversal chunk),
//   * median-index fallback when a forced split has no usable SAH plane,
//   * nodes appended in (parent, left, right) order — parents always have
//     smaller indices.
//
// Parallelism: large subtrees are handed to std::async tasks (the analog of
// the reference's rayon par_iter over meshes + our per-subtree split).
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <future>
#include <limits>
#include <mutex>
#include <vector>

namespace {

constexpr int kBins = 32;
constexpr int kMaxDepth = 32;      // SAH depth budget (bvh.rs:141)
constexpr int kHardDepth = 64;     // forced median splits may go deeper

struct V3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float half_area(const V3& lo, const V3& hi) {
  float ex = std::max(hi.x - lo.x, 0.f);
  float ey = std::max(hi.y - lo.y, 0.f);
  float ez = std::max(hi.z - lo.z, 0.f);
  return ex * ey + ey * ez + ex * ez;
}

struct Tri {
  V3 lo, hi, c;
};

struct Out {
  float* node_min;
  float* node_max;
  int32_t* left;
  int32_t* right;
  int32_t* first;
  int32_t* count;
  int32_t* axis;
  int64_t* order;
  int32_t max_nodes;
};

struct Builder {
  std::vector<Tri> tris;
  Out out;
  std::atomic<int32_t> n_nodes{0};
  std::atomic<bool> overflow{false};
  int max_leaf;
  int quality;  // 0 disabled, 1 low(midpoint), 2 high(binned)

  int32_t alloc_node(const V3& lo, const V3& hi, int32_t first, int32_t cnt) {
    int32_t idx = n_nodes.fetch_add(1);
    if (idx >= out.max_nodes) {
      overflow.store(true);
      return out.max_nodes - 1;
    }
    out.node_min[idx * 3 + 0] = lo.x;
    out.node_min[idx * 3 + 1] = lo.y;
    out.node_min[idx * 3 + 2] = lo.z;
    out.node_max[idx * 3 + 0] = hi.x;
    out.node_max[idx * 3 + 1] = hi.y;
    out.node_max[idx * 3 + 2] = hi.z;
    out.left[idx] = 0;
    out.right[idx] = 0;
    out.first[idx] = first;
    out.count[idx] = cnt;
    out.axis[idx] = 0;
    return idx;
  }

  // Find best binned-SAH split of order[start, start+count).
  // Returns cost; fills axis/threshold-bin classification via `is_left`.
  bool binned_split(int64_t* ord, int32_t start, int32_t count,
                    float parent_cost, bool must, int* out_axis,
                    float* out_pos) {
    V3 clo = {1e30f, 1e30f, 1e30f}, chi = {-1e30f, -1e30f, -1e30f};
    for (int32_t i = start; i < start + count; ++i) {
      clo = vmin(clo, tris[ord[i]].c);
      chi = vmax(chi, tris[ord[i]].c);
    }
    float best_cost = std::numeric_limits<float>::infinity();
    int best_axis = -1;
    float best_pos = 0.f;
    for (int a = 0; a < 3; ++a) {
      float lo = clo[a], hi = chi[a];
      float extent = hi - lo;
      if (extent <= 0.f) continue;
      float scale = kBins / extent;
      int32_t cnt[kBins];
      V3 blo[kBins], bhi[kBins];
      for (int b = 0; b < kBins; ++b) {
        cnt[b] = 0;
        blo[b] = {1e30f, 1e30f, 1e30f};
        bhi[b] = {-1e30f, -1e30f, -1e30f};
      }
      for (int32_t i = start; i < start + count; ++i) {
        const Tri& t = tris[ord[i]];
        int b = (int)((t.c[a] - lo) * scale);
        b = std::min(std::max(b, 0), kBins - 1);
        cnt[b]++;
        blo[b] = vmin(blo[b], t.lo);
        bhi[b] = vmax(bhi[b], t.hi);
      }
      // suffix sweep
      float rcost[kBins];
      V3 rlo = {1e30f, 1e30f, 1e30f}, rhi = {-1e30f, -1e30f, -1e30f};
      int32_t rc = 0;
      for (int b = kBins - 1; b >= 1; --b) {
        rlo = vmin(rlo, blo[b]);
        rhi = vmax(rhi, bhi[b]);
        rc += cnt[b];
        rcost[b] = rc ? rc * half_area(rlo, rhi)
                      : std::numeric_limits<float>::infinity();
      }
      // prefix sweep
      V3 llo = {1e30f, 1e30f, 1e30f}, lhi = {-1e30f, -1e30f, -1e30f};
      int32_t lc = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        llo = vmin(llo, blo[b]);
        lhi = vmax(lhi, bhi[b]);
        lc += cnt[b];
        if (lc == 0 || lc == count) continue;
        float cost = lc * half_area(llo, lhi) + rcost[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = a;
          best_pos = lo + extent * (float)(b + 1) / kBins;
        }
      }
    }
    if (best_axis < 0) return false;
    if (!must && best_cost >= parent_cost) return false;
    *out_axis = best_axis;
    *out_pos = best_pos;
    return true;
  }

  bool midpoint_split(const V3& lo, const V3& hi, int* out_axis,
                      float* out_pos) {
    V3 e = {hi.x - lo.x, hi.y - lo.y, hi.z - lo.z};
    int a = (e.x > e.y && e.x > e.z) ? 0 : (e.y > e.z ? 1 : 2);
    *out_axis = a;
    *out_pos = lo[a] + e[a] * 0.5f;
    return true;
  }

  void subdivide(int32_t node, int32_t start, int32_t count, int depth,
                 bool parallel) {
    if (overflow.load()) return;
    if (count <= max_leaf) return;  // leaf: already recorded by alloc
    int64_t* ord = out.order;

    V3 lo = {out.node_min[node * 3], out.node_min[node * 3 + 1],
             out.node_min[node * 3 + 2]};
    V3 hi = {out.node_max[node * 3], out.node_max[node * 3 + 1],
             out.node_max[node * 3 + 2]};
    float parent_cost = half_area(lo, hi) * count;

    int axis = 0;
    float pos = 0.f;
    bool must = depth < kHardDepth;  // count > max_leaf ⇒ forced
    bool have = false;
    if (quality == 2 && depth < kMaxDepth) {
      have = binned_split(ord, start, count, parent_cost, must, &axis, &pos);
    } else if (quality == 1 && depth < kMaxDepth) {
      have = midpoint_split(lo, hi, &axis, &pos);
    }
    int32_t mid;
    if (have) {
      int64_t* b = ord + start;
      int64_t* e = b + count;
      int64_t* m = std::partition(
          b, e, [&](int64_t t) { return tris[t].c[axis] < pos; });
      mid = (int32_t)(m - b);
      if (mid == 0 || mid == count) have = false;
    }
    if (!have) {
      if (!must) return;  // SAH refused and not forced: keep as leaf
      axis = 0;
      mid = count / 2;  // median-index fallback
      if (mid == 0) return;
    }

    // child bounds
    V3 llo = {1e30f, 1e30f, 1e30f}, lhi = {-1e30f, -1e30f, -1e30f};
    V3 rlo = {1e30f, 1e30f, 1e30f}, rhi = {-1e30f, -1e30f, -1e30f};
    for (int32_t i = start; i < start + mid; ++i) {
      llo = vmin(llo, tris[ord[i]].lo);
      lhi = vmax(lhi, tris[ord[i]].hi);
    }
    for (int32_t i = start + mid; i < start + count; ++i) {
      rlo = vmin(rlo, tris[ord[i]].lo);
      rhi = vmax(rhi, tris[ord[i]].hi);
    }

    int32_t li = alloc_node(llo, lhi, start, mid);
    int32_t ri = alloc_node(rlo, rhi, start + mid, count - mid);
    if (overflow.load()) return;
    out.left[node] = li;
    out.right[node] = ri;
    out.count[node] = 0;
    out.axis[node] = axis;

    if (parallel && count > 16384) {
      auto fut = std::async(std::launch::async, [=] {
        subdivide(li, start, mid, depth + 1, true);
      });
      subdivide(ri, start + mid, count - mid, depth + 1, true);
      fut.wait();
    } else {
      subdivide(li, start, mid, depth + 1, false);
      subdivide(ri, start + mid, count - mid, depth + 1, false);
    }
  }
};

}  // namespace

extern "C" {

// Returns node count, or -1 on node-buffer overflow.
int32_t rt2_build_bvh(const float* v0, const float* v1, const float* v2,
                      int32_t n_tris, int32_t max_leaf, int32_t quality,
                      float* node_min, float* node_max, int32_t* left,
                      int32_t* right, int32_t* first, int32_t* count,
                      int32_t* axis, int64_t* order, int32_t max_nodes,
                      int32_t parallel) {
  Builder b;
  b.out = {node_min, node_max, left, right, first, count, axis, order,
           max_nodes};
  b.max_leaf = max_leaf;
  b.quality = quality;
  b.tris.resize(n_tris);
  V3 rlo = {1e30f, 1e30f, 1e30f}, rhi = {-1e30f, -1e30f, -1e30f};
  for (int32_t i = 0; i < n_tris; ++i) {
    V3 a = {v0[i * 3], v0[i * 3 + 1], v0[i * 3 + 2]};
    V3 c = {v1[i * 3], v1[i * 3 + 1], v1[i * 3 + 2]};
    V3 d = {v2[i * 3], v2[i * 3 + 1], v2[i * 3 + 2]};
    Tri t;
    t.lo = vmin(a, vmin(c, d));
    t.hi = vmax(a, vmax(c, d));
    t.c = {(a.x + c.x + d.x) / 3.f, (a.y + c.y + d.y) / 3.f,
           (a.z + c.z + d.z) / 3.f};
    b.tris[i] = t;
    order[i] = i;
    rlo = vmin(rlo, t.lo);
    rhi = vmax(rhi, t.hi);
  }
  if (n_tris == 0) {
    b.alloc_node({0, 0, 0}, {0, 0, 0}, 0, 0);
    return b.n_nodes.load();
  }
  int32_t root = b.alloc_node(rlo, rhi, 0, n_tris);
  b.subdivide(root, 0, n_tris, 0, parallel != 0);
  if (b.overflow.load()) return -1;
  return b.n_nodes.load();
}

}  // extern "C"
