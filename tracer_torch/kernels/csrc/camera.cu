// One sample's camera rays for a batch of pixels, on the card: what
// tracer_torch/render/renderer.py::camera_batch computes with torch ops —
// the per-ray keys of the PCG chain, the pixel jitter, the ray time, the
// screen position and the pinhole ray (render/camera.py::generate_rays) —
// in one pass, one thread a ray:
//   key    = mix(pcg(word ^ (id * golden + 1)), sample)   (rng.ray_keys,
//            rng.salted by the sample index)
//   jitter = lane_uniform(mix(key, PIXEL_JITTER), 0 | 1)
//   time   = to_unit(pcg(mix(mix(key, RAY_TIME), 0)))
//   u, v   = (id % width + jitter0) * inv_w, (id / width + jitter1) * inv_h
//   o, d   = the camera's position; the normalised direction of
//            ((2u - 1) aspect tan(fov/2), (1 - 2v) tan(fov/2), -1) turned
//            by the normalised pose quaternion's matrix.
// The float operations are generate_rays' in the same order, each rounded
// on its own (--fmad=false), the quaternion's norm summed as torch.sum sums
// four floats on the card; tanf, sqrtf and the divisions are CUDA's
// correctly rounded or torch's own (torch's CUDA tan calls tanf), so the
// rays are the torch chain's on the card bit for bit.
//
// Replaces no Pallas kernel: the JAX package makes its camera rays with
// jnp ops that XLA fuses into the frame. The port's torch chain was ~220
// launches a sample of int64 and float elementwise ops over the batch (each
// PCG hash ~10 of them) and of tiny ops on the 4-element quaternion; in the
// one-sample graph they took more of a Cornell frame than B1 and B2. The
// seed word and the sample index are read from device memory where the
// caller gives tensors (a compiled frame's argument and carry), so a
// replay with a new seed, first sample or camera needs nothing from the
// host; python ints come as arguments.
//
// Bound: memory. A ray reads its id (4 or 8 B) and writes its key (8 B) and
// 7 floats (28 B): ~40 B, 16.3 MB for 408,000 rays, ~4.9 us at 3.35 TB/s;
// its ~60 integer operations of four hashes and ~40 float operations are
// far below the card's rates. Nothing to keep between rays.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "pcg.cuh"

// Mirror of _Args in tracer_torch/kernels/camera.py (same order).
struct CameraArgs {
  const void* ids;          // [n] pixel ids y * width + x, int32 or int64
  const long long* word;    // the seed word (0-d int64), or null: word_value
  const long long* sample;  // the sample index (0-d int64), or null
  const float *position, *quaternion, *fov_deg, *aspect;  // [3], [4], 1, 1
  long long* keys;          // [n] out: the sample's keys (uint32 values)
  float* rays;              // [7, n] out: o(3), d(3), time
  float* jitter;            // [2, n] out, or null
  int n, width, ids64;
  unsigned word_value, sample_value;
  float inv_w, inv_h;       // f32(1) / f32(width), f32(1) / f32(height)
};

namespace {

constexpr int THREADS = 256;
constexpr uint32_t PIXEL_JITTER = 0;
constexpr uint32_t RAY_TIME = 1;
// np.float32(np.pi / 180.0), generate_rays' deg2rad
constexpr float DEG2RAD = (float)(3.141592653589793 / 180.0);

__global__ void __launch_bounds__(THREADS) camera_kernel(CameraArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const long long id = a.ids64 ? ((const long long*)a.ids)[i]
                               : (long long)((const int*)a.ids)[i];
  const uint32_t word = a.word ? (uint32_t)*a.word : a.word_value;
  const uint32_t sample = a.sample ? (uint32_t)*a.sample : a.sample_value;
  const uint32_t key =
      tt::mix(tt::pcg(word ^ ((uint32_t)id * 0x9E3779B9u + 1u)), sample);
  const uint32_t jkey = tt::mix(key, PIXEL_JITTER);
  const float j0 = tt::lane_uniform(jkey, 0);
  const float j1 = tt::lane_uniform(jkey, 1);
  const float time = tt::to_unit(tt::pcg(tt::mix(tt::mix(key, RAY_TIME), 0)));
  const float u = ((float)(id % a.width) + j0) * a.inv_w;
  const float v = ((float)(id / a.width) + j1) * a.inv_h;

  // generate_rays
  const float th = tanf(a.fov_deg[0] * DEG2RAD * 0.5f);
  const float xc = (2.0f * u - 1.0f) * a.aspect[0] * th;
  const float yc = (1.0f - 2.0f * v) * th;
  const float zc = -1.0f;
  // quat_to_matrix: q / max(|q|, 1e-20), then the rotation's rows
  const float* q = a.quaternion;
  // torch.sum of the four squares on the card: (0 + 2) + (1 + 3)
  const float ss = (q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3]);
  const float qn = tt::maxf(sqrtf(ss), 1e-20f);
  const float w = q[0] / qn, x = q[1] / qn, y = q[2] / qn, z = q[3] / qn;
  const float r[3][3] = {
      {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - w * z),
       2.0f * (x * z + w * y)},
      {2.0f * (x * y + w * z), 1.0f - 2.0f * (x * x + z * z),
       2.0f * (y * z - w * x)},
      {2.0f * (x * z - w * y), 2.0f * (y * z + w * x),
       1.0f - 2.0f * (x * x + y * y)}};
  float dw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    dw[k] = xc * r[k][0] + yc * r[k][1] + zc * r[k][2];
  const float dn =
      tt::maxf(sqrtf(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2]), 1e-20f);
  const size_t n = (size_t)a.n;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.rays[k * n + i] = a.position[k];
    a.rays[(3 + k) * n + i] = dw[k] / dn;
  }
  a.rays[6 * n + i] = time;
  a.keys[i] = (long long)key;
  if (a.jitter) {
    a.jitter[i] = j0;
    a.jitter[n + i] = j1;
  }
}

}  // namespace

extern "C" int tt_camera(const CameraArgs* args, void* stream) {
  const CameraArgs a = *args;
  if (a.n == 0) return 0;
  camera_kernel<<<(a.n + THREADS - 1) / THREADS, THREADS, 0,
                  (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
