// Native BVH builder: the port's copy of native/bvh_builder.cpp (the same
// source, so both packages build the same tree from the same flags).
//
// The analog of the reference's KD-tree construction (KDTree.cpp:87-151):
// where the reference builds a pointer tree with median-of-mins splits and
// straddler duplication, this builds a binned-SAH BVH (each triangle in
// exactly one leaf) and emits the flattened SoA arrays (preorder + skip
// links, fixed-width leaves) that the traversal kernel reads. Exposed via
// a C ABI and loaded with ctypes (tracer_torch/accel/native.py, which
// builds it with g++ at first use); the numpy builder in
// tracer_torch/accel/bvh.py is the fallback and the semantic spec.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Vec3f {
  float x, y, z;
};

static inline Vec3f vmin(const Vec3f &a, const Vec3f &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3f vmax(const Vec3f &a, const Vec3f &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  Vec3f lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3f hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const Box &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const Vec3f &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Builder {
  const float *tri_lo, *tri_hi;
  int leaf_width, max_depth;
  std::vector<Box> boxes;
  std::vector<Vec3f> centroids;
  std::vector<float> node_lo, node_hi;
  std::vector<int32_t> node_leaf_start, node_skip, leaf_tris;

  Box box_of(int id) const {
    Box b;
    b.lo = {tri_lo[3 * id], tri_lo[3 * id + 1], tri_lo[3 * id + 2]};
    b.hi = {tri_hi[3 * id], tri_hi[3 * id + 1], tri_hi[3 * id + 2]};
    return b;
  }

  int emit_leaf_chain(const Box &bb, std::vector<int> &ids) {
    // Leaf (or chain of full-width leaves when over-full at depth cap).
    size_t pos = 0;
    int last = -1;
    do {
      int idx = (int)node_leaf_start.size();
      node_lo.insert(node_lo.end(), {bb.lo.x, bb.lo.y, bb.lo.z});
      node_hi.insert(node_hi.end(), {bb.hi.x, bb.hi.y, bb.hi.z});
      node_leaf_start.push_back((int32_t)leaf_tris.size());
      for (int k = 0; k < leaf_width; k++) {
        leaf_tris.push_back(pos < ids.size() ? (int32_t)ids[pos++] : -1);
      }
      node_skip.push_back(idx + 1);
      last = idx;
    } while (pos < ids.size());
    return last + 1;
  }

  // Returns the end index of the subtree (skip target of the parent).
  int build(std::vector<int> &ids, int depth) {
    Box bb, cb;  // geometry bounds, centroid bounds
    for (int id : ids) {
      bb.grow(boxes[id]);
      cb.grow(centroids[id]);
    }
    if ((int)ids.size() <= leaf_width || depth >= max_depth) {
      return emit_leaf_chain(bb, ids);
    }

    // Binned SAH over the widest centroid axis; fall back to median split.
    constexpr int NBINS = 16;
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = ext[1] > ext[0] ? 1 : 0;
    if (ext[2] > ext[axis]) axis = 2;
    float lo_a = axis == 0 ? cb.lo.x : axis == 1 ? cb.lo.y : cb.lo.z;
    float extent = ext[axis];

    std::vector<int> left, right;
    left.reserve(ids.size());
    right.reserve(ids.size());

    bool did_split = false;
    if (extent > 1e-12f) {
      Box bins[NBINS];
      int counts[NBINS] = {0};
      float inv = NBINS / extent;
      auto bin_of = [&](int id) {
        const Vec3f &c = centroids[id];
        float v = axis == 0 ? c.x : axis == 1 ? c.y : c.z;
        int b = (int)((v - lo_a) * inv);
        return std::min(std::max(b, 0), NBINS - 1);
      };
      for (int id : ids) {
        int b = bin_of(id);
        bins[b].grow(boxes[id]);
        counts[b]++;
      }
      // sweep: best split between bins
      Box rbox[NBINS];
      Box acc;
      for (int i = NBINS - 1; i >= 0; i--) {
        if (counts[i]) acc.grow(bins[i]);
        rbox[i] = acc;
      }
      Box lacc;
      int lcount = 0;
      float best_cost = FLT_MAX;
      int best_bin = -1;
      for (int i = 0; i < NBINS - 1; i++) {
        if (counts[i]) lacc.grow(bins[i]);
        lcount += counts[i];
        int rcount = (int)ids.size() - lcount;
        if (lcount == 0 || rcount == 0) continue;
        float cost = lacc.half_area() * lcount + rbox[i + 1].half_area() * rcount;
        if (cost < best_cost) {
          best_cost = cost;
          best_bin = i;
        }
      }
      if (best_bin >= 0) {
        for (int id : ids) {
          (bin_of(id) <= best_bin ? left : right).push_back(id);
        }
        did_split = !left.empty() && !right.empty();
      }
    }
    if (!did_split) {
      // median split on the widest axis (stable order like the fallback
      // numpy builder)
      std::vector<int> order = ids;
      std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
        const Vec3f &ca = centroids[a], &cb2 = centroids[b];
        float va = axis == 0 ? ca.x : axis == 1 ? ca.y : ca.z;
        float vb = axis == 0 ? cb2.x : axis == 1 ? cb2.y : cb2.z;
        return va < vb;
      });
      size_t half = order.size() / 2;
      left.assign(order.begin(), order.begin() + half);
      right.assign(order.begin() + half, order.end());
      if (left.empty() || right.empty()) {
        return emit_leaf_chain(bb, ids);
      }
    }

    int idx = (int)node_leaf_start.size();
    node_lo.insert(node_lo.end(), {bb.lo.x, bb.lo.y, bb.lo.z});
    node_hi.insert(node_hi.end(), {bb.hi.x, bb.hi.y, bb.hi.z});
    node_leaf_start.push_back(-1);
    node_skip.push_back(-1);  // patched below
    ids.clear();
    ids.shrink_to_fit();
    build(left, depth + 1);
    int end = build(right, depth + 1);
    node_skip[idx] = end;
    return end;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. Output arrays are malloc'd; free with tracer_free.
int tracer_build_bvh(const float *tri_lo, const float *tri_hi, int n_tris,
                     int leaf_width, int max_depth, float **out_node_lo,
                     float **out_node_hi, int32_t **out_leaf_start,
                     int32_t **out_skip, int32_t **out_leaf_tris,
                     int32_t *out_n_nodes, int32_t *out_n_leaf_slots) {
  if (n_tris <= 0) {
    *out_n_nodes = 0;
    *out_n_leaf_slots = 0;
    *out_node_lo = *out_node_hi = nullptr;
    *out_leaf_start = *out_skip = *out_leaf_tris = nullptr;
    return 0;
  }
  Builder b;
  b.tri_lo = tri_lo;
  b.tri_hi = tri_hi;
  b.leaf_width = leaf_width;
  b.max_depth = max_depth;
  b.boxes.resize(n_tris);
  b.centroids.resize(n_tris);
  for (int i = 0; i < n_tris; i++) {
    b.boxes[i] = b.box_of(i);
    b.centroids[i] = {0.5f * (b.boxes[i].lo.x + b.boxes[i].hi.x),
                      0.5f * (b.boxes[i].lo.y + b.boxes[i].hi.y),
                      0.5f * (b.boxes[i].lo.z + b.boxes[i].hi.z)};
  }
  std::vector<int> ids(n_tris);
  for (int i = 0; i < n_tris; i++) ids[i] = i;
  b.build(ids, 0);

  auto copy_out = [](auto &vec, auto **out) {
    using T = typename std::remove_reference<decltype(vec)>::type::value_type;
    *out = (T *)malloc(vec.size() * sizeof(T));
    std::memcpy(*out, vec.data(), vec.size() * sizeof(T));
  };
  copy_out(b.node_lo, out_node_lo);
  copy_out(b.node_hi, out_node_hi);
  copy_out(b.node_leaf_start, out_leaf_start);
  copy_out(b.node_skip, out_skip);
  copy_out(b.leaf_tris, out_leaf_tris);
  *out_n_nodes = (int32_t)b.node_leaf_start.size();
  *out_n_leaf_slots = (int32_t)b.leaf_tris.size();
  return 0;
}

void tracer_free(void *p) { free(p); }

}  // extern "C"
