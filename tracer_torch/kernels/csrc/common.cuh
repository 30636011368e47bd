// Small helpers shared by the kernels: float helpers whose max/min
// propagate a NaN in the first operand, as torch.clamp_min/clamp_max and
// jnp.maximum do (fmaxf would drop it), and the launch plan of a kernel
// whose tables sit in dynamic shared memory when they fit.
#pragma once
#include <cuda_runtime.h>

#include <initializer_list>

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

// One wave of blocks of `threads` threads with `smem` dynamic bytes each.
template <typename K>
int persistent_blocks(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// Where a call's tables sit: in dynamic shared memory when `bytes` of them
// fit beside the static shared memory of each of the call's shared-table
// kernels in a block's opt-in limit (227 KB on an H100), after raising
// their dynamic limits past the default 48 KB; else each kernel's L2
// instance reads them through the read-only cache. `blocks` is one wave of
// the call's persistent kernel, the instance taken. Memoised per kernel for
// the last device and size (the queries cost more host time than a launch).
struct SharedFit {
  int dev = -1;
  size_t bytes = 0;
  bool fits = false;
  int blocks = 0;
};

// `ps` and `pg`: the persistent kernel's shared-table and L2 instances, of
// `threads` threads; `others`: the call's other shared-table kernels.
template <typename P, typename... K>
const SharedFit& fit_shared(SharedFit& memo, size_t bytes, int threads, P ps,
                            P pg, K... others) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev == memo.dev && bytes == memo.bytes) return memo;
  int optin = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const std::initializer_list<const void*> shared = {
      (const void*)ps, (const void*)others...};
  size_t stat = 0;
  for (const void* k : shared) {
    cudaFuncAttributes fa;
    cudaFuncGetAttributes(&fa, k);
    if (fa.sharedSizeBytes > stat) stat = fa.sharedSizeBytes;
  }
  memo.fits = stat + bytes <= (size_t)optin;
  if (memo.fits)
    for (const void* k : shared)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  memo.blocks = memo.fits ? persistent_blocks(ps, threads, bytes)
                          : persistent_blocks(pg, threads, 0);
  memo.dev = dev;
  memo.bytes = bytes;
  return memo;
}

}  // namespace tt
