// The counter-based RNG of tracer_torch/core/rng.py (and of the JAX
// package's tracer/core/rng.py and tracer/kernels/common.py) in uint32_t:
// the PCG output hash pcg_output_rxs_m_xs_32_32, sub-streams by
// key ^ (salt * golden + 1), uniforms from the top 24 bits. Unsigned
// arithmetic wraps and shifts logically, exactly as the reference's
// uint32 / int32-with-logical-shift chains do, so every draw is bit-identical.
#pragma once
#include <stdint.h>

namespace tt {

__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  uint32_t w = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (w >> 22u) ^ w;
}

__device__ __forceinline__ uint32_t mix(uint32_t key, uint32_t salt) {
  return pcg(key ^ (salt * 0x9E3779B9u + 1u));
}

// top 24 bits -> [0, 1): exact in f32
__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(bits >> 8u) * (1.0f / 16777216.0f);
}

// flat lane `lane` of uniform(key, (K,)): key mix(key, lane + 2)
__device__ __forceinline__ float lane_uniform(uint32_t key, uint32_t lane) {
  return to_unit(pcg(mix(key, lane + 2u)));
}

}  // namespace tt
