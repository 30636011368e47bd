// Small float helpers shared by the kernels. max/min propagate a NaN in
// the first operand, as torch.clamp_min/clamp_max and jnp.maximum do
// (fmaxf would drop it).
#pragma once

namespace tt {

__device__ __forceinline__ float maxf(float x, float m) {
  return x < m ? m : x;
}

__device__ __forceinline__ float minf(float x, float m) {
  return x > m ? m : x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

}  // namespace tt
