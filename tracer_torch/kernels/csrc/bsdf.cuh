// Scatter-sampling device code shared by the shade+scatter kernel (B2,
// shade_scatter.cu) and the bounce-adjoint kernel (B3, bounce_bwd.cu). B3
// redraws the glass Bernoulli and the diffuse direction that B2 drew, so
// both take them from this one source: the same expressions in the same
// order, built with --fmad=false, give the same bits.
//
// Follows tracer/kernels/shade.py (the BSDF scatter, Material.cpp:26-60)
// and tracer/render/replay_bwd.py:303-339.
#pragma once
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "pcg.cuh"

namespace tt {

constexpr uint32_t SCATTER_DIR = 2;
constexpr uint32_t SCATTER_GLASS = 3;

// shading.trunc_mod2 for x >= 0: floor(x) mod 2, exact
__device__ __forceinline__ float trunc_mod2(float x) {
  float t = floorf(x);
  return t - 2.0f * floorf(t * 0.5f);
}

// vec3p.normalize: v * (1 / max(|v|, 1e-20))
__device__ __forceinline__ void normalize3(float* x, float* y, float* z) {
  float inv = 1.0f / maxf(sqrtf(*x * *x + *y * *y + *z * *z), 1e-20f);
  *x = *x * inv;
  *y = *y * inv;
  *z = *z * inv;
}

// The glass lobe's choice between reflection and refraction for a ray
// with d.n = ddn: the refraction ratio, the total-internal-reflection test
// and the Schlick Bernoulli on the SCATTER_GLASS stream of `bk`.
struct GlassLobe {
  bool going_out;  // ddn > 0
  float ior_inv;   // 1 / (ior > 1e-12 ? ior : 1)
  float ri;        // the refraction ratio
  bool reflect;
};

__device__ __forceinline__ GlassLobe glass_lobe(float ddn, float ior, bool ref,
                                                uint32_t bk) {
  GlassLobe g;
  g.going_out = ddn > 0.0f;
  g.ior_inv = 1.0f / (ior > 1e-12f ? ior : 1.0f);
  if (ref)
    g.ri = g.going_out ? g.ior_inv : ior;  // inverted-eta quirk
  else
    g.ri = g.going_out ? ior : g.ior_inv;
  const float ri = g.ri;
  const float cos_t = minf(-ddn, 1.0f);
  const float sin_t = sqrtf(maxf(1.0f - cos_t * cos_t, 0.0f));
  const bool cannot = ref ? (ri * sin_t - 0.6f) > 1.0f  // -0.6 fudge quirk
                          : (ri * sin_t) > 1.0f;
  const float u_glass = to_unit(pcg(mix(mix(bk, SCATTER_GLASS), 0u)));
  float r0 = (1.0f - ri) / (1.0f + ri);
  r0 = r0 * r0;
  const float mm = maxf(1.0f - cos_t, 0.0f);
  const float m2 = mm * mm;
  const float schlick = r0 + (1.0f - r0) * (m2 * m2 * mm);
  g.reflect = cannot || (schlick > u_glass);
  return g;
}

// Lane 0 of the diffuse scatter sample on the SCATTER_DIR stream of `bk`:
// the normalized cube sample (Functions.cpp:14-18) under compat=reference,
// uniform on the sphere under compat=physical.
__device__ __forceinline__ void scatter_sample(uint32_t bk, bool ref, float* x,
                                               float* y, float* z) {
  const uint32_t skey = mix(bk, SCATTER_DIR);
  float rux, ruy, ruz;
  if (ref) {
    rux = -1.0f + 2.0f * lane_uniform(skey, 0u);
    ruy = -1.0f + 2.0f * lane_uniform(skey, 1u);
    ruz = -1.0f + 2.0f * lane_uniform(skey, 2u);
    float nr = maxf(sqrtf(rux * rux + ruy * ruy + ruz * ruz), 1e-20f);
    rux = rux / nr;
    ruy = ruy / nr;
    ruz = ruz / nr;
  } else {
    float u0 = lane_uniform(skey, 0u);
    float u1 = lane_uniform(skey, 1u);
    ruz = 1.0f - 2.0f * u0;
    float r = sqrtf(maxf(1.0f - ruz * ruz, 0.0f));
    float phi = 6.2831855f * u1;  // f32(2*pi)
    rux = r * cosf(phi);
    ruy = r * sinf(phi);
  }
  *x = rux;
  *y = ruy;
  *z = ruz;
}

}  // namespace tt
