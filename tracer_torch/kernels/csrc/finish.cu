// The frame's finish for Hopper: out[i] = the image's value of the film's
// sum s[i] over `count` samples, as `tracer_torch/render/film.py::to_image`
// computes it on the host after `film / np.float32(nsamples)`:
//   x = s / count                     (IEEE division, float32)
//   x = np.clip(x, 0, None)           (NaN kept)
//   x = np.power(x, 1/2.2)            (when gamma; the exponent in float32)
//   x = np.clip(x, 0, 1)              (NaN kept)
// over the flat [pixels * 3] floats. The clamps keep a NaN in x, as
// numpy's clip does (tt::maxf, tt::minf; fmaxf and fminf drop it), and a
// -0 too, as numpy 2.3's clip does (2.0's returns +0; the power makes
// every zero +0, so an image never holds -0).
//
// Replaces no Pallas kernel: the JAX package finishes its image with jnp
// ops after the jitted frame. The port finished it with numpy on the host,
// which left the card idle for the copy of the sum and the host's power
// (numpy's float32 power is slow on zeros, and a black channel is common):
// 13-23 ms of a 56 ms Cornell frame. The kernel finishes on the card, so
// only the finished image crosses to the host.
//
// Bound: memory. A pass reads 4 B and writes 4 B a float: 9.8 MB for an
// 850x480 film, ~2.9 us at 3.35 TB/s; powf's ~30 float operations a
// float are under a tenth of that at 67 TFLOP/s. One thread a float, in
// order, so a warp's loads and stores are 128 B lines; nothing to keep.
// powf is CUDA's, built without fast math. Over every float32 in [0, 1]
// it is within 1 ulp of numpy 2.3.5's float32 power on an H100's host,
// and each of the two within 1 ulp of the correctly rounded power; nothing
// else in the chain rounds differently.
#include <cuda_runtime.h>

#include "common.cuh"

// Mirror of _Args in tracer_torch/kernels/finish.py (same order).
struct FinishArgs {
  const float* sum;  // [n] the film's sum over `count` samples, flat
  float* out;        // [n] the image, flat
  float count;       // the samples, as numpy's np.float32(nsamples)
  int n;             // pixels * 3
  int gamma;         // 1: the power 1/2.2 between the clamps
};

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) finish_kernel(FinishArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  float x = tt::maxf(a.sum[i] / a.count, 0.0f);
  if (a.gamma) x = powf(x, (float)(1.0 / 2.2));
  a.out[i] = tt::minf(x, 1.0f);
}

}  // namespace

extern "C" int tt_finish(const FinishArgs* args, void* stream) {
  const FinishArgs a = *args;
  if (a.n == 0) return 0;
  finish_kernel<<<(a.n + THREADS - 1) / THREADS, THREADS, 0,
                  (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
