// The per-ray BVH walk shared by the BVH walk kernel (B5, traverse.cu) and
// the soft-shadow kernel (B6, shadow.cu): the stackless skip-link preorder
// walk of one mesh's node range, one thread per ray, with the leaf test of
// tracer/kernels/traverse.py:115-170 (the same expressions in the same
// order; built with --fmad=false, so it reproduces the plain version in
// tracer_torch/geometry/primitives.py::skip_walk bit for bit).
//
// Tables (tracer_torch/kernels/traverse.py::traverse_tables), read through
// the read-only cache:
//   nodes_f [Bn, 8] f32 = lo(3), hi(3), 0, 0      (two float4 per node)
//   nodes_i [Bn, 2] i32 = leaf row (-1 inner), skip (one int2 per node)
//   leaf [NL, LW*32] f32, slot s at cols s*32..: a(3), n(3), D, v0(3),
//     v1(3), d00, d01, d11, denom_safe, tid (five float4 per slot)
#pragma once
#include <math.h>

namespace tt {

constexpr float INF = 3.0e38f;
constexpr int TRI_COLS = 32;

struct Tree {
  const float4* nodes_f;
  const int2* nodes_i;
  const float4* leaf;
  int leaf_width;
  int sentinel;  // the degenerate padding triangle's id: a leaf ends there
};

// Closest hit (t, tri) of the ray o + t d over the nodes [root, end),
// folded into (bt, btri): a strictly closer t replaces them. inv = 1/d.
__device__ __forceinline__ void walk(const Tree& tr, int root, int end,
                                     float ox, float oy, float oz, float dx,
                                     float dy, float dz, float invx,
                                     float invy, float invz, float* bt_io,
                                     int* btri_io) {
  float bt = *bt_io;
  int btri = *btri_io;
  const int slot4 = TRI_COLS / 4;
  int i = root;
  while (i < end) {
    const float4 f0 = __ldg(tr.nodes_f + 2 * i);      // lo.xyz, hi.x
    const float4 f1 = __ldg(tr.nodes_f + 2 * i + 1);  // hi.yz
    const int2 ni = __ldg(tr.nodes_i + i);
    const float t0x = (f0.x - ox) * invx, t1x = (f0.w - ox) * invx;
    const float t0y = (f0.y - oy) * invy, t1y = (f1.x - oy) * invy;
    const float t0z = (f0.z - oz) * invz, t1z = (f1.y - oz) * invz;
    // jnp.minimum/maximum propagate a NaN (0 * inf at an axis-parallel
    // ray) into the comparison, which then fails: test for it explicitly
    const bool nan = isnan(t0x) || isnan(t1x) || isnan(t0y) || isnan(t1y) ||
                     isnan(t0z) || isnan(t1z);
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fmaxf(t0z, t1z));
    const bool hit = !nan && fminf(bt, tf) > fmaxf(0.0f, tn);
    if (!hit) {
      i = ni.y;
      continue;
    }
    if (ni.x < 0) {
      ++i;
      continue;
    }
    const float4* row = tr.leaf + (size_t)ni.x * tr.leaf_width * slot4;
    for (int s = 0; s < tr.leaf_width; ++s) {
      const float4* q = row + s * slot4;
      const float4 q4 = __ldg(q + 4);  // denom_safe, tid
      const int tid = (int)q4.y;
      if (tid == tr.sentinel) break;   // padding slots come last
      const float4 q0 = __ldg(q);      // a.xyz, n.x
      const float4 q1 = __ldg(q + 1);  // n.yz, D, v0.x
      const float dotRN = dx * q0.w + dy * q1.x + dz * q1.y;
      if (!(dotRN < 0.0f)) continue;   // backface cull (the test's ok)
      const float o_n = ox * q0.w + oy * q1.x + oz * q1.y;
      const float t = (q1.z - o_n) / dotRN;
      if (!(t >= 0.0f && t < bt)) continue;
      const float4 q2 = __ldg(q + 2);  // v0.yz, v1.xy
      const float4 q3 = __ldg(q + 3);  // v1.z, d00, d01, d11
      const float v2x = (ox + t * dx) - q0.x;
      const float v2y = (oy + t * dy) - q0.y;
      const float v2z = (oz + t * dz) - q0.z;
      const float d20 = v2x * q1.w + v2y * q2.x + v2z * q2.y;
      const float d21 = v2x * q2.z + v2y * q2.w + v2z * q3.x;
      const float w1 = (q3.w * d20 - q3.z * d21) / q4.x;
      const float w2 = (q3.y * d21 - q3.z * d20) / q4.x;
      const float w0 = 1.0f - w1 - w2;
      if (w0 >= 0.0f && w0 <= 1.0f && w1 >= 0.0f && w1 <= 1.0f &&
          w2 >= 0.0f && w2 <= 1.0f) {
        bt = t;
        btri = tid;
      }
    }
    i = ni.y;
  }
  *bt_io = bt;
  *btri_io = btri;
}

}  // namespace tt
