// The hit detail on one selected triangle, shared by the first-hit kernel
// (B1, first_hits.cu: a mesh winner's hit point and normal) and the
// shade+scatter kernel (B2, shade_scatter.cu: its interpolated corner
// color): primitives.triangle_hit_detail_planar of the JAX package
// (tracer/geometry/primitives.py:435-456) on a row of the mesh pack
// (tracer_torch/kernels/intersect.py::mesh_tables: a, b, c, the three
// corner colors, has_col; 24 floats), with the same expressions in the
// same order as the plain version tracer_torch/geometry/primitives.py::
// triangle_hit_detail.
#pragma once
#include <math.h>

#include "common.cuh"

namespace tt {

constexpr int MESH_PACK_COLS = 24;

struct TriDetail {
  float px, py, pz, nx, ny, nz, w0, w1, w2;
};

__device__ __forceinline__ TriDetail triangle_detail(const float* r, float ox,
                                                     float oy, float oz,
                                                     float dx, float dy,
                                                     float dz) {
  const float ax = r[0], ay = r[1], az = r[2];
  const float v0x = r[3] - ax, v0y = r[4] - ay, v0z = r[5] - az;
  const float v1x = r[6] - ax, v1y = r[7] - ay, v1z = r[8] - az;
  const float cx = v0y * v1z - v0z * v1y;
  const float cy = v0z * v1x - v0x * v1z;
  const float cz = v0x * v1y - v0y * v1x;
  const float inv = 1.0f / maxf(sqrtf(cx * cx + cy * cy + cz * cz), 1e-20f);
  TriDetail o;
  o.nx = inv * cx;
  o.ny = inv * cy;
  o.nz = inv * cz;
  const float dotRN = dx * o.nx + dy * o.ny + dz * o.nz;
  const float t = ((ax * o.nx + ay * o.ny + az * o.nz) -
                   (ox * o.nx + oy * o.ny + oz * o.nz)) /
                  (dotRN == 0.0f ? 1e-30f : dotRN);
  o.px = t * dx + ox;
  o.py = t * dy + oy;
  o.pz = t * dz + oz;
  const float v2x = o.px - ax, v2y = o.py - ay, v2z = o.pz - az;
  const float d00 = v0x * v0x + v0y * v0y + v0z * v0z;
  const float d01 = v0x * v1x + v0y * v1y + v0z * v1z;
  const float d11 = v1x * v1x + v1y * v1y + v1z * v1z;
  const float d20 = v2x * v0x + v2y * v0y + v2z * v0z;
  const float d21 = v2x * v1x + v2y * v1y + v2z * v1z;
  const float raw = d00 * d11 - d01 * d01;
  const float denom = maxf(fabsf(raw), 1e-30f);
  const float sr = raw + 1e-38f;
  const float sign = sr > 0.0f ? 1.0f : (sr < 0.0f ? -1.0f : sr);
  o.w1 = sign * (d11 * d20 - d01 * d21) / denom;
  o.w2 = sign * (d00 * d21 - d01 * d20) / denom;
  o.w0 = 1.0f - o.w1 - o.w2;
  return o;
}

}  // namespace tt
