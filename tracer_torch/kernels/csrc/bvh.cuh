// The BVH walk shared by the BVH walk kernel (B5, traverse.cu) and the
// soft-shadow kernel (B6, shadow.cu): the stackless skip-link preorder walk
// of one mesh's node range with the leaf test of
// tracer/kernels/traverse.py:115-170 (the same expressions in the same
// order; built with --fmad=false, so it reproduces the plain version in
// tracer_torch/geometry/primitives.py::skip_walk bit for bit), cut into
// units of one node or one triangle slot, the meshes' roots and ranges,
// and the persistent-thread task queue both kernels' walks draw from.
//
// Tables (tracer_torch/kernels/traverse.py::traverse_tables), read through
// the read-only cache:
//   nodes_f [Bn, 8] f32 = lo(3), hi(3), n_real, 0   (two float4 per node)
//   nodes_i [Bn, 2] i32 = leaf row (-1 inner), skip (one int2 per node)
//   leaf [NL, LW*32] f32, slot s at cols s*32..: a(3), n(3), D, v0(3),
//     v1(3), d00, d01, d11, denom_safe, tid (five float4 per slot); the
//     n_real real triangles first, then padding
//
// A walk waits on one round of loads per unit, and the loads of the next
// unit are issued before this one is tested: a node's three loads
// together, a slot's five float4s together; the leaf's count of real
// triangles rides in the node (no load to find the padding), and the node
// after a leaf is loaded while the leaf's slots are tested.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace tt {

constexpr float INF = 3.0e38f;
constexpr int TRI_COLS = 32;
constexpr int SLOT4 = TRI_COLS / 4;  // float4s per leaf slot
constexpr unsigned FULL = 0xffffffffu;

struct Tree {
  const float4* nodes_f;
  const int2* nodes_i;
  const float4* leaf;
  int leaf_width;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, invx, invy, invz;  // inv = 1/d (hoisted)
};

struct Slot {
  float4 q0, q1, q2, q3, q4;
};

// A leaf slot's five float4s, issued together. Through L2 only (ld.cg):
// leaf rows are read once per ray and would push the node table, which
// every walk reads, out of L1.
__device__ __forceinline__ Slot load_slot(const float4* q) {
  return Slot{__ldcg(q), __ldcg(q + 1), __ldcg(q + 2), __ldcg(q + 3),
              __ldcg(q + 4)};
}

// Ray vs one triangle slot: a strictly closer hit replaces (bt, btri).
__device__ __forceinline__ void test_slot(const Slot& s, const Ray& r,
                                          float& bt, int& btri) {
  const float dotRN = r.dx * s.q0.w + r.dy * s.q1.x + r.dz * s.q1.y;
  if (!(dotRN < 0.0f)) return;  // backface cull (the test's ok)
  const float o_n = r.ox * s.q0.w + r.oy * s.q1.x + r.oz * s.q1.y;
  const float t = (s.q1.z - o_n) / dotRN;
  if (!(t >= 0.0f && t < bt)) return;
  const float v2x = (r.ox + t * r.dx) - s.q0.x;
  const float v2y = (r.oy + t * r.dy) - s.q0.y;
  const float v2z = (r.oz + t * r.dz) - s.q0.z;
  const float d20 = v2x * s.q1.w + v2y * s.q2.x + v2z * s.q2.y;
  const float d21 = v2x * s.q2.z + v2y * s.q2.w + v2z * s.q3.x;
  const float w1 = (s.q3.w * d20 - s.q3.z * d21) / s.q4.x;
  const float w2 = (s.q3.y * d21 - s.q3.z * d20) / s.q4.x;
  const float w0 = 1.0f - w1 - w2;
  if (w0 >= 0.0f && w0 <= 1.0f && w1 >= 0.0f && w1 <= 1.0f && w2 >= 0.0f &&
      w2 <= 1.0f) {
    bt = t;
    btri = (int)s.q4.y;
  }
}

// A node's data: the slab test's box, the leaf's count of real
// triangles, its leaf row and skip.
struct Node {
  float4 f0, f1;  // lo.xyz, hi.x; hi.yz, n_real, 0
  int2 ni;        // leaf row, skip
};

__device__ __forceinline__ Node load_node(const Tree& tr, int i) {
  return Node{__ldg(tr.nodes_f + 2 * i), __ldg(tr.nodes_f + 2 * i + 1),
              __ldg(tr.nodes_i + i)};
}

// The slab test of a node's box against (0, bt): min(bt, tfar) >
// max(0, tnear) with 1/d hoisted. jnp.minimum/maximum propagate a NaN
// (0 * inf at an axis-parallel ray) into the comparison, which then
// fails: test for it explicitly.
__device__ __forceinline__ bool slab(const Node& nd, const Ray& r,
                                     float bt) {
  const float4 f0 = nd.f0, f1 = nd.f1;
  const float t0x = (f0.x - r.ox) * r.invx, t1x = (f0.w - r.ox) * r.invx;
  const float t0y = (f0.y - r.oy) * r.invy, t1y = (f1.x - r.oy) * r.invy;
  const float t0z = (f0.z - r.oz) * r.invz, t1z = (f1.y - r.oz) * r.invz;
  const bool nan = isnan(t0x) || isnan(t1x) || isnan(t0y) || isnan(t1y) ||
                   isnan(t0z) || isnan(t1z);
  const float tn =
      fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tf =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return !nan && fminf(bt, tf) > fmaxf(0.0f, tn);
}

// The meshes' node ranges [Nm] (root, end) in global memory, and their
// root nodes: every walk of a mesh starts at its root. A block may keep
// the first `cached` roots in shared memory (cache_roots); the others are
// read through the read-only cache. So the kernels take any number of
// meshes.
constexpr int ROOT_CACHE = 16;  // the roots a block keeps (768 B)

struct Roots {
  const int2* range;  // [Nm]: mesh m's node range [root, end)
  Tree tr;
  const Node* s;      // the first `cached` roots
  int cached;

  __device__ __forceinline__ int2 span(int m) const {
    return __ldg(range + m);
  }
  // the root of mesh m, whose range is rg (rg.x < rg.y)
  __device__ __forceinline__ Node node(int m, int2 rg) const {
    return m < cached ? s[m] : load_node(tr, rg.x);
  }
};

// The roots with the first ROOT_CACHE of them copied into `smem`
// (ROOT_CACHE nodes); the caller synchronises the block before their
// first use.
__device__ __forceinline__ Roots cache_roots(const Tree& tr,
                                             const int2* range,
                                             int n_meshes, Node* smem) {
  const int cached = n_meshes < ROOT_CACHE ? n_meshes : ROOT_CACHE;
  for (int m = threadIdx.x; m < cached; m += blockDim.x) {
    const int2 rg = __ldg(range + m);
    if (rg.x < rg.y) smem[m] = load_node(tr, rg.x);
  }
  return Roots{range, tr, smem, cached};
}

// Where a walk goes on after the root's slab test: the next node to
// visit, end if the box is missed. A hit leaf root is visited again (its
// slab test passes again, the same value), so the walk tests its slots.
__device__ __forceinline__ int after_root(const Node& root, int i, int end,
                                          bool hit) {
  if (!hit) return end;
  return root.ni.x < 0 ? i + 1 : i;
}

// One ray's walk of one mesh's node range [node, end), one unit at a
// time: a node's slab test or one leaf slot, whose loads were issued
// before the previous unit was tested.
struct Walk {
  int node, end;  // the next node (its data in nd while left == 0)
  int left;       // real slots of the current leaf still to test
  const float4* slot;  // the first of them (its data in sl)
  Node nd;
  Slot sl;

  __device__ __forceinline__ bool done() const {
    return left == 0 && node >= end;
  }

  // Resume at node i of the range [i, end_).
  __device__ __forceinline__ void begin(const Tree& tr, int i, int end_) {
    node = i;
    end = end_;
    left = 0;
    if (node < end) nd = load_node(tr, node);
  }

  // One unit: the slab test of `node` against (0, bt), or the leaf's next
  // slot; a strictly closer hit replaces (bt, btri).
  __device__ __forceinline__ void unit(const Tree& tr, const Ray& r,
                                       float& bt, int& btri) {
    if (left > 0) {
      const Slot cur = sl;
      if (--left > 0) {
        slot += SLOT4;
        sl = load_slot(slot);
      }
      test_slot(cur, r, bt, btri);
      return;
    }
    const int2 ni = nd.ni;
    if (!slab(nd, r, bt)) {
      node = ni.y;
    } else if (ni.x < 0) {
      node = node + 1;
    } else {
      left = (int)nd.f1.z;
      slot = tr.leaf + (size_t)ni.x * tr.leaf_width * SLOT4;
      if (left > 0) sl = load_slot(slot);
      node = ni.y;
    }
    // the next node's loads, while the leaf's slots are tested
    if (node < end) nd = load_node(tr, node);
  }
};

// The first lanes' base index in a list that each lane of the warp
// appends `c` entries to, with one atomic on `count` for the warp. All 32
// lanes call it together.
__device__ __forceinline__ int warp_append(int c, int* count) {
  const int lane = threadIdx.x & 31;
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  int base = 0;
  if (lane == 31 && total > 0) base = atomicAdd(count, total);
  base = __shfl_sync(FULL, base, 31);
  return base + incl - c;
}

// Persistent threads with dynamic fetch (Aila & Laine, "Understanding the
// Efficiency of Ray Traversal on GPUs", HPG 2009): one wave of blocks,
// and every loop turn the lanes of a warp whose task has ended take the
// next tasks of the warp's chunk; the warp takes the next 32 tasks from
// the global counter when its chunk is spent. All 32 lanes call `take`
// together; a lane that finds no task idles until the warp's others end.
struct TaskQueue {
  int* counter;  // zeroed before the launch
  int total;
  int next, end;  // the warp's chunk [next, end), the same in every lane
  bool spent;     // the counter has passed total

  __device__ __forceinline__ TaskQueue(int* c, int n_tasks)
      : counter(c), total(n_tasks), next(0), end(0), spent(false) {}

  // true for a lane that wants a task and gets one (its index in `task`)
  __device__ __forceinline__ bool take(bool want, int& task) {
    const unsigned need = __ballot_sync(FULL, want);
    if (need == 0) return false;
    if (next >= end && !spent) {
      int base = 0;
      if ((threadIdx.x & 31) == 0) base = atomicAdd(counter, 32);
      base = __shfl_sync(FULL, base, 0);
      spent = base >= total;
      next = spent ? 0 : base;
      end = spent ? 0 : min(base + 32, total);
    }
    const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
    const int rank = __popc(need & lt);
    const int avail = end - next;
    const bool got = want && rank < avail;
    if (got) task = next + rank;
    next += min(__popc(need), avail);
    return got;
  }
};

}  // namespace tt
