// Native BVH builder for the BDPT renderer.
//
// The one irreducibly-native host component of the reference is the DXR
// acceleration-structure build (RtModel::buildAccelerationStructure,
// RtModel.cpp:181-254; RtScene::createTlas, RtScene.cpp:220-308).  This is
// its stand-in: a binned-split BVH flattened with threaded hit/miss links in
// DFS pre-order, producing arrays identical in meaning to the numpy builder
// in accel/bvh.py (which remains the fallback).  Exposed via a C ABI and
// loaded with ctypes (accel/native.py).
//
// Build: make -C native   ->  native/libbvh_builder.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float get(const Vec3& v, int axis) {
  return axis == 0 ? v.x : (axis == 1 ? v.y : v.z);
}

struct BuildNode {
  Vec3 bb_min, bb_max;
  int32_t left = -1;    // child index or first-tri cursor for leaves
  int32_t right = -1;   // child index (-1 for leaf)
  int32_t first = 0, count = 0;
  int32_t size = 1;     // subtree node count
};

struct Builder {
  const float* pos;
  const int64_t* idx;
  int64_t n_tris;
  int64_t leaf_size;
  std::vector<Vec3> tri_min, tri_max, centroid;
  std::vector<BuildNode> nodes;
  std::vector<int32_t> tri_order;

  int32_t build(std::vector<int32_t>& tris) {
    BuildNode node;
    node.bb_min = {1e30f, 1e30f, 1e30f};
    node.bb_max = {-1e30f, -1e30f, -1e30f};
    Vec3 cmin = {1e30f, 1e30f, 1e30f}, cmax = {-1e30f, -1e30f, -1e30f};
    for (int32_t t : tris) {
      node.bb_min = vmin(node.bb_min, tri_min[t]);
      node.bb_max = vmax(node.bb_max, tri_max[t]);
      cmin = vmin(cmin, centroid[t]);
      cmax = vmax(cmax, centroid[t]);
    }
    int32_t me = (int32_t)nodes.size();
    nodes.push_back(node);

    if ((int64_t)tris.size() <= leaf_size) {
      nodes[me].first = (int32_t)tri_order.size();
      nodes[me].count = (int32_t)tris.size();
      for (int32_t t : tris) tri_order.push_back(t);
      return me;
    }

    // split along the largest centroid extent; 16-bin balance heuristic
    float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    std::vector<int32_t> lhs, rhs;
    if (ext[axis] > 1e-12f) {
      constexpr int kBins = 16;
      int counts[kBins] = {0};
      for (int32_t t : tris) {
        float rel = (get(centroid[t], axis) - get(cmin, axis)) / ext[axis];
        int b = std::min(kBins - 1, std::max(0, (int)(rel * kBins)));
        counts[b]++;
      }
      int total = (int)tris.size(), prefix = 0, best_b = -1;
      long best_balance = 1L << 60;
      for (int b = 1; b < kBins; ++b) {
        prefix += counts[b - 1];
        long balance = std::labs(2L * prefix - total);
        if (prefix > 0 && prefix < total && balance < best_balance) {
          best_balance = balance;
          best_b = b;
        }
      }
      if (best_b >= 0) {
        for (int32_t t : tris) {
          float rel = (get(centroid[t], axis) - get(cmin, axis)) / ext[axis];
          int b = std::min(15, std::max(0, (int)(rel * 16)));
          (b < best_b ? lhs : rhs).push_back(t);
        }
      }
    }
    if (lhs.empty() || rhs.empty()) {  // median fallback
      lhs.clear();
      rhs.clear();
      std::vector<int32_t> sorted = tris;
      std::stable_sort(sorted.begin(), sorted.end(), [&](int32_t a, int32_t b) {
        return get(centroid[a], axis) < get(centroid[b], axis);
      });
      size_t half = std::max<size_t>(1, sorted.size() / 2);
      lhs.assign(sorted.begin(), sorted.begin() + half);
      rhs.assign(sorted.begin() + half, sorted.end());
    }
    tris.clear();
    tris.shrink_to_fit();

    int32_t l = build(lhs);
    int32_t r = build(rhs);
    nodes[me].left = l;
    nodes[me].right = r;
    nodes[me].size = 1 + nodes[l].size + nodes[r].size;
    return me;
  }
};

// Emit DFS pre-order with threaded hit/miss links.
static void flatten(const std::vector<BuildNode>& nodes, int32_t root,
                    float* node_min, float* node_max, int32_t* node_left,
                    int32_t* node_count, int32_t* node_hit,
                    int32_t* node_miss) {
  struct Item {
    int32_t node;
    int32_t miss;
  };
  std::vector<Item> stack{{root, -1}};
  int32_t cursor = 0;
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    const BuildNode& n = nodes[it.node];
    int32_t i = cursor++;
    std::memcpy(node_min + 3 * i, &n.bb_min, 12);
    std::memcpy(node_max + 3 * i, &n.bb_max, 12);
    node_miss[i] = it.miss;
    if (n.right < 0) {  // leaf
      node_left[i] = n.first;
      node_count[i] = n.count;
      node_hit[i] = it.miss;
    } else {
      node_left[i] = 0;
      node_count[i] = 0;
      node_hit[i] = i + 1;
      int32_t right_index = i + 1 + nodes[n.left].size;
      stack.push_back({n.right, it.miss});
      stack.push_back({n.left, right_index});
    }
  }
}

}  // namespace

extern "C" int64_t bvh_build(const float* positions, int64_t n_verts,
                             const int64_t* indices, int64_t n_tris,
                             int64_t leaf_size, float* node_min,
                             float* node_max, int32_t* node_left,
                             int32_t* node_count, int32_t* node_hit,
                             int32_t* node_miss, int32_t* tri_order) {
  (void)n_verts;
  if (n_tris <= 0) return 0;
  Builder b;
  b.pos = positions;
  b.idx = indices;
  b.n_tris = n_tris;
  b.leaf_size = std::max<int64_t>(1, leaf_size);
  b.tri_min.resize(n_tris);
  b.tri_max.resize(n_tris);
  b.centroid.resize(n_tris);
  for (int64_t t = 0; t < n_tris; ++t) {
    Vec3 v[3];
    for (int k = 0; k < 3; ++k) {
      const float* p = positions + 3 * indices[3 * t + k];
      v[k] = {p[0], p[1], p[2]};
    }
    b.tri_min[t] = vmin(vmin(v[0], v[1]), v[2]);
    b.tri_max[t] = vmax(vmax(v[0], v[1]), v[2]);
    b.centroid[t] = {(b.tri_min[t].x + b.tri_max[t].x) * 0.5f,
                     (b.tri_min[t].y + b.tri_max[t].y) * 0.5f,
                     (b.tri_min[t].z + b.tri_max[t].z) * 0.5f};
  }
  b.nodes.reserve(2 * n_tris);
  b.tri_order.reserve(n_tris);
  std::vector<int32_t> all(n_tris);
  for (int64_t t = 0; t < n_tris; ++t) all[(size_t)t] = (int32_t)t;
  int32_t root = b.build(all);

  int64_t n_nodes = (int64_t)b.nodes.size();
  if (n_nodes > 2 * n_tris) return -1;  // caller capacity exceeded
  flatten(b.nodes, root, node_min, node_max, node_left, node_count, node_hit,
          node_miss);
  std::memcpy(tri_order, b.tri_order.data(), sizeof(int32_t) * n_tris);
  return n_nodes;
}
