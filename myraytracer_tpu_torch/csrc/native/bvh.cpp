// Native BVH builder: binned-SAH, 2-wide, flattened to skip-link arrays.
//
// Host-side preprocessing for the TPU renderer: the traversal on device is
// a lane-parallel stackless walk over these flat arrays (node i descends to
// i+1 on a bbox hit, jumps to skip[i] otherwise), so the builder emits
// nodes in depth-first order with escape links.
//
// This is the TPU-native analog slot of the reference's host-side scene
// preparation (raytracer/src/lib.rs:722-863): the reference flattens its
// scene into GPU textures and has NO acceleration structure (linear scan,
// shader.wgsl:314-329); this builder is the framework's extension for
// triangle-mesh scenes (BASELINE config 5). C ABI for ctypes binding; a
// pure-Python fallback with identical output semantics lives in
// myraytracer_tpu/native/bvh_py.py.
//
// Build: make -C native   (produces native/libmrt_native.so)

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Aabb {
  float mn[3];
  float mx[3];
  Aabb() {
    for (int k = 0; k < 3; ++k) {
      mn[k] = FLT_MAX;
      mx[k] = -FLT_MAX;
    }
  }
  void grow(const float* lo, const float* hi) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], lo[k]);
      mx[k] = std::max(mx[k], hi[k]);
    }
  }
  void grow_point(const float* p) { grow(p, p); }
  float half_area() const {
    float dx = std::max(0.0f, mx[0] - mn[0]);
    float dy = std::max(0.0f, mx[1] - mn[1]);
    float dz = std::max(0.0f, mx[2] - mn[2]);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Builder {
  const float* prim_min;   // [n, 3]
  const float* prim_max;   // [n, 3]
  int max_leaf;
  std::vector<int> order;  // permutation of prim ids, partitioned in place
  std::vector<float> cent; // [n, 3] centroids

  // flat output, depth-first
  std::vector<float> nodes_min, nodes_max;
  std::vector<int> node_first, node_count, node_skip;

  static constexpr int kBins = 16;

  int emit(const Aabb& box, int first, int count) {
    int id = static_cast<int>(node_count.size());
    for (int k = 0; k < 3; ++k) {
      nodes_min.push_back(box.mn[k]);
      nodes_max.push_back(box.mx[k]);
    }
    node_first.push_back(first);
    node_count.push_back(count);
    node_skip.push_back(-1);  // patched after the subtree is built
    return id;
  }

  Aabb range_bounds(int first, int count, Aabb* centroid_box) const {
    Aabb box;
    for (int i = first; i < first + count; ++i) {
      int p = order[i];
      box.grow(prim_min + 3 * p, prim_max + 3 * p);
      if (centroid_box) centroid_box->grow_point(&cent[3 * p]);
    }
    return box;
  }

  void build_range(int first, int count) {
    Aabb cbox;
    Aabb box = range_bounds(first, count, &cbox);
    int id = emit(box, first, count);

    if (count > max_leaf) {
      // Binned SAH over the widest centroid axis.
      int axis = 0;
      float ext[3];
      for (int k = 0; k < 3; ++k) ext[k] = cbox.mx[k] - cbox.mn[k];
      if (ext[1] > ext[axis]) axis = 1;
      if (ext[2] > ext[axis]) axis = 2;

      int split = -1;
      if (ext[axis] > 1e-12f) {
        float scale = kBins / ext[axis];
        Aabb bin_box[kBins];
        int bin_n[kBins] = {0};
        for (int i = first; i < first + count; ++i) {
          int p = order[i];
          int b = std::min(
              kBins - 1,
              static_cast<int>((cent[3 * p + axis] - cbox.mn[axis]) * scale));
          bin_box[b].grow(prim_min + 3 * p, prim_max + 3 * p);
          bin_n[b]++;
        }
        // Sweep for the best SAH split between bins.
        float right_area[kBins];
        Aabb acc;
        int right_n[kBins];
        int rn = 0;
        for (int b = kBins - 1; b > 0; --b) {
          acc.grow(bin_box[b].mn, bin_box[b].mx);
          rn += bin_n[b];
          right_area[b] = acc.half_area();
          right_n[b] = rn;
        }
        Aabb lacc;
        int ln = 0;
        float best = FLT_MAX;
        for (int b = 0; b < kBins - 1; ++b) {
          lacc.grow(bin_box[b].mn, bin_box[b].mx);
          ln += bin_n[b];
          if (ln == 0 || right_n[b + 1] == 0) continue;
          float cost = lacc.half_area() * ln + right_area[b + 1] * right_n[b + 1];
          if (cost < best) {
            best = cost;
            split = b;
          }
        }
        if (split >= 0) {
          float leaf_cost = box.half_area() * count;
          if (count <= max_leaf && best >= leaf_cost) split = -1;
        }
        if (split >= 0) {
          float cut = cbox.mn[axis] + (split + 1) / scale;
          auto mid_it = std::partition(
              order.begin() + first, order.begin() + first + count,
              [&](int p) { return cent[3 * p + axis] < cut; });
          int mid = static_cast<int>(mid_it - order.begin());
          if (mid == first || mid == first + count) split = -1;
          else {
            node_count[id] = 0;  // interior
            build_range(first, mid - first);
            build_range(mid, first + count - mid);
          }
        }
      }
      if (split < 0 && count > max_leaf) {
        // Degenerate centroids: median split keeps the tree balanced.
        int mid = first + count / 2;
        std::nth_element(
            order.begin() + first, order.begin() + mid,
            order.begin() + first + count,
            [&](int a, int b) { return cent[3 * a + axis_of(cbox)] <
                                        cent[3 * b + axis_of(cbox)]; });
        node_count[id] = 0;
        build_range(first, mid - first);
        build_range(mid, first + count - mid);
      }
    }
    node_skip[id] = static_cast<int>(node_count.size());
  }

  static int axis_of(const Aabb& cbox) {
    int axis = 0;
    float ext[3];
    for (int k = 0; k < 3; ++k) ext[k] = cbox.mx[k] - cbox.mn[k];
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    return axis;
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on error. Output buffers must
// hold at least 2*n_prims nodes (n_prims >= 1).
int mrt_build_bvh(const float* prim_min, const float* prim_max, int n_prims,
                  int max_leaf,
                  float* out_nodes_min, float* out_nodes_max,
                  int* out_first, int* out_count, int* out_skip,
                  int* out_order) {
  if (n_prims <= 0 || max_leaf <= 0) return -1;
  Builder b;
  b.prim_min = prim_min;
  b.prim_max = prim_max;
  b.max_leaf = max_leaf;
  b.order.resize(n_prims);
  b.cent.resize(3 * n_prims);
  for (int i = 0; i < n_prims; ++i) {
    b.order[i] = i;
    for (int k = 0; k < 3; ++k)
      b.cent[3 * i + k] = 0.5f * (prim_min[3 * i + k] + prim_max[3 * i + k]);
  }
  int cap = 2 * n_prims;
  b.nodes_min.reserve(3 * cap);
  b.nodes_max.reserve(3 * cap);
  b.build_range(0, n_prims);

  int m = static_cast<int>(b.node_count.size());
  if (m > cap) return -1;
  std::memcpy(out_nodes_min, b.nodes_min.data(), sizeof(float) * 3 * m);
  std::memcpy(out_nodes_max, b.nodes_max.data(), sizeof(float) * 3 * m);
  std::memcpy(out_first, b.node_first.data(), sizeof(int) * m);
  std::memcpy(out_count, b.node_count.data(), sizeof(int) * m);
  std::memcpy(out_skip, b.node_skip.data(), sizeof(int) * m);
  std::memcpy(out_order, b.order.data(), sizeof(int) * n_prims);
  return m;
}

}  // extern "C"
