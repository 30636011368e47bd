// Texel-cotangent fold for Hopper: out[t] = data_g[t] + the sum of the
// cotangents of every update whose texel id is t.
//
// Replaces the TPU kernel tracer/kernels/fold.py::sorted_fold (Pallas;
// body _kernel at fold.py:67-117: per-window one-hot MXU contractions over
// the sorted update stream). As there, the stream is sorted by texel id
// outside the kernel (torch.sort, stable, plus the payload gather; the TPU
// path's lax.sort). The accumulation is two passes with no float atomics,
// so the same record folds to the same bits on every run:
//   1. one block per chunk of CHUNK sorted updates: a segmented inclusive
//      scan (Hillis-Steele, keyed by texel id) in shared memory; at the
//      last position of each run's piece inside the chunk it writes the
//      piece's sum to `part`;
//   2. one thread per texel t: it binary-searches its run
//      [lower_bound(t), lower_bound(t + 1)) in the sorted ids and adds the
//      sums of the run's pieces, one per chunk the run touches, in order.
// A hot texel (Cornell's record sends every untextured lane's zero
// cotangent to texel 0: ~3/4 of the stream) thus costs one load per
// CHUNK updates instead of one per update. The plain PyTorch version is
// tracer_torch/kernels/fold.py::sorted_fold_plain (the flat scatter-add);
// the two agree to f32 summation order.
//
// Bound: memory. The function reads the sorted stream once (4 B id + 12 B
// payload per update) and the atlas gradient once, and writes the result
// once: Cornell's 2.04M updates onto a 2.1M-texel atlas move ~83 MB,
// ~25 us at 3.35 TB/s. The passes move about twice that (the piece sums
// go through `part`), and the binary searches touch ~2 x 21 ids per
// texel, mostly from cache.
//
// Layout: ids [m] int32 sorted ascending, each in [0, p); g and part
// [3, m] f32 (planar channels, g permuted with the ids); data and out
// [p, 3] f32.
#include <cuda_runtime.h>
#include <stdint.h>

// Mirror of _Args in tracer_torch/kernels/fold.py (same order).
struct FoldArgs {
  const int* ids;
  const float* g;
  const float* data;
  float* part;
  float* out;
  int p, m;
};

namespace {

constexpr int CHUNK = 1024;  // sorted updates per pass-1 block
constexpr int THREADS = 256;
constexpr int NO_ID = 0x7fffffff;  // past every real id

__global__ void __launch_bounds__(CHUNK) sorted_fold_pieces(FoldArgs a) {
  __shared__ int sid[CHUNK];
  __shared__ float sx[CHUNK], sy[CHUNK], sz[CHUNK];
  const int t = threadIdx.x;
  const int k = blockIdx.x * CHUNK + t;
  const bool in = k < a.m;
  const int id = in ? a.ids[k] : NO_ID;
  float x = in ? a.g[k] : 0.0f;
  float y = in ? a.g[(size_t)a.m + k] : 0.0f;
  float z = in ? a.g[2 * (size_t)a.m + k] : 0.0f;
  sid[t] = id;
  sx[t] = x;
  sy[t] = y;
  sz[t] = z;
  __syncthreads();
  // after the step with offset `off`, position t holds the sum of its
  // run's elements in (t - 2*off, t]; ids are sorted, so t - off is in
  // t's run exactly when its id is t's
  for (int off = 1; off < CHUNK; off <<= 1) {
    const bool add = t >= off && sid[t - off] == id;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (add) {
      px = sx[t - off];
      py = sy[t - off];
      pz = sz[t - off];
    }
    __syncthreads();
    if (add) {
      x = px + x;
      y = py + y;
      z = pz + z;
      sx[t] = x;
      sy[t] = y;
      sz[t] = z;
    }
    __syncthreads();
  }
  if (in && (t == CHUNK - 1 || sid[t + 1] != id)) {
    a.part[k] = x;
    a.part[(size_t)a.m + k] = y;
    a.part[2 * (size_t)a.m + k] = z;
  }
}

// first k in [0, m) with ids[k] >= t, or m
__device__ __forceinline__ int lower_bound(const int* ids, int m, int t) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) < t)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS) sorted_fold_runs(FoldArgs a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.p) return;
  const int lo = lower_bound(a.ids, a.m, t);
  const int hi = lower_bound(a.ids, a.m, t + 1);
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  if (lo < hi) {
    // the run's piece in each chunk it touches ends at the chunk's last
    // position or at the run's own last one
    for (int c = lo / CHUNK; c <= (hi - 1) / CHUNK; ++c) {
      const int e = min(hi - 1, c * CHUNK + CHUNK - 1);
      sx = sx + a.part[e];
      sy = sy + a.part[(size_t)a.m + e];
      sz = sz + a.part[2 * (size_t)a.m + e];
    }
  }
  const size_t r = 3 * (size_t)t;
  a.out[r] = a.data[r] + sx;
  a.out[r + 1] = a.data[r + 1] + sy;
  a.out[r + 2] = a.data[r + 2] + sz;
}

}  // namespace

extern "C" int tt_sorted_fold(const FoldArgs* args, void* stream) {
  const FoldArgs a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.m > 0) {
    sorted_fold_pieces<<<(a.m + CHUNK - 1) / CHUNK, CHUNK, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sorted_fold_runs<<<(a.p + THREADS - 1) / THREADS, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
