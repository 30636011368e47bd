// Soft-shadow kernel for Hopper: per light, K jittered shadow rays from a
// hit point, each tested against every sphere, quad and mesh with one
// stochastic-transparency Bernoulli draw per occluder; the factor is
// 1 - mean_k(blocked). One thread per hit point.
//
// Replaces the TPU kernel tracer/kernels/shadow.py::shadow_factors (Pallas;
// body _kernel at shadow.py:213-463). Its semantics are the JAX package's
// jnp path (integrator._shadow_factor_jnp and _shadow_blocked_p), whose
// plain PyTorch port is tracer_torch/kernels/shadow.py::shadow_factors_plain:
// the same expressions in the same order, built with --fmad=false.
//
// The TPU kernel shares one packet walk among a light's K samples (a union
// walk around the central ray). A thread here walks each sample's own ray
// (bvh.cuh), so no bound on the samples' union is needed. It skips a
// mesh's walk only where the walk cannot change the result: the sample is
// already blocked (the blocked OR does not depend on the order of the
// tests, since every occluder's draw has its own key), or the mesh's draw
// is at most its transparency (then the mesh cannot block this sample).
//
// Bound: operations and the walks. Per light a hit point traces K rays,
// each against every sphere and quad (tables in shared memory) and through
// every mesh's BVH (tree tables through the read-only cache); it reads 24 B
// and writes 4 B per light.
//
// Tables (tracer_torch/kernels/shadow.py::shadow_tables): light [L, 4] =
// pos(3), radius/2; sph [S, 9] = c(3), r^2, mb(3), valid, transparency;
// quad [Q, 20] = n(3), er(3), eu(3), v0.n, mb.n, v0.er, mb.er, v0.eu,
// mb.eu, er.er, eu.eu, glass, valid, transparency; mesh [Nm] =
// transparency. Output: out [L, n]; lanes with live false get 1.0.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bvh.cuh"
#include "common.cuh"
#include "pcg.cuh"

constexpr int MAX_MESHES = 16;

// Mirror of _Args in tracer_torch/kernels/shadow.py (same order).
struct ShadowArgs {
  const float *px, *py, *pz, *tm;
  const int* key;  // uint32 key bits
  const unsigned char* live;
  const float *light, *sph, *quad, *mesh;
  const float* nodes_f;
  const int* nodes_i;
  const float* leaf;
  float* out;
  int n, n_meshes, leaf_width, sentinel;
  int root[MAX_MESHES], end[MAX_MESHES];
  int L, S, S_real, Q, Q_real, K, ref;
  float eps;         // the scene's candidate cut (t >= eps)
  float offset_eps;  // the shadow ray's origin offset (cfg.epsilon)
};

namespace {

constexpr int THREADS = 128;
constexpr uint32_t SHADOW_LIGHT_POS = 4;
constexpr uint32_t SHADOW_BERNOULLI = 5;

__global__ void __launch_bounds__(THREADS) shadow_kernel(ShadowArgs a) {
  extern __shared__ float smem[];
  float* slight = smem;
  float* ssph = slight + a.L * 4;
  float* squad = ssph + a.S_real * 9;
  float* smesh = squad + a.Q_real * 20;
  for (int k = threadIdx.x; k < a.L * 4; k += blockDim.x) slight[k] = a.light[k];
  for (int k = threadIdx.x; k < a.S_real * 9; k += blockDim.x) ssph[k] = a.sph[k];
  for (int k = threadIdx.x; k < a.Q_real * 20; k += blockDim.x)
    squad[k] = a.quad[k];
  for (int k = threadIdx.x; k < a.n_meshes; k += blockDim.x)
    smesh[k] = a.mesh[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  if (!a.live[i]) {
    for (int l = 0; l < a.L; ++l) a.out[(size_t)l * a.n + i] = 1.0f;
    return;
  }
  const float px = a.px[i], py = a.py[i], pz = a.pz[i], tm = a.tm[i];
  const uint32_t key = (uint32_t)a.key[i];
  const float eps = a.eps;
  const tt::Tree tr{reinterpret_cast<const float4*>(a.nodes_f),
                    reinterpret_cast<const int2*>(a.nodes_i),
                    reinterpret_cast<const float4*>(a.leaf), a.leaf_width,
                    a.sentinel};

  for (int l = 0; l < a.L; ++l) {
    const float* lt = slight + l * 4;
    const float delta = lt[3];
    const uint32_t skey = tt::mix(tt::mix(key, SHADOW_LIGHT_POS), l);
    const uint32_t bkey = tt::mix(tt::mix(key, SHADOW_BERNOULLI), l);
    float acc = 0.0f;
    for (int k = 0; k < a.K; ++k) {
      // ---- sample k's ray (integrator._shadow_factor_jnp) -------------
      float rx, ry, rz;
      if (a.ref) {  // normalized cube sample, lanes k*3+a
        rx = -1.0f + 2.0f * tt::lane_uniform(skey, k * 3 + 0);
        ry = -1.0f + 2.0f * tt::lane_uniform(skey, k * 3 + 1);
        rz = -1.0f + 2.0f * tt::lane_uniform(skey, k * 3 + 2);
        const float rn = tt::maxf(sqrtf(rx * rx + ry * ry + rz * rz), 1e-20f);
        rx = rx / rn;
        ry = ry / rn;
        rz = rz / rn;
      } else {      // uniform on the sphere, lanes k*2+a
        const float u0 = tt::lane_uniform(skey, k * 2 + 0);
        const float u1 = tt::lane_uniform(skey, k * 2 + 1);
        rz = 1.0f - 2.0f * u0;
        const float r = sqrtf(tt::maxf(1.0f - rz * rz, 0.0f));
        const float phi = 6.2831855f * u1;  // f32(2*pi)
        rx = r * cosf(phi);
        ry = r * sinf(phi);
      }
      const float offx = (delta * rx + lt[0]) - px;
      const float offy = (delta * ry + lt[1]) - py;
      const float offz = (delta * rz + lt[2]) - pz;
      const float tl = sqrtf(offx * offx + offy * offy + offz * offz);
      const float inv = 1.0f / tt::maxf(tl, 1e-20f);
      const float sdx = inv * offx, sdy = inv * offy, sdz = inv * offz;
      const float sox = a.offset_eps * sdx + px;
      const float soy = a.offset_eps * sdy + py;
      const float soz = a.offset_eps * sdz + pz;
      const uint32_t bk = tt::mix(bkey, k + 2);
      const float a2 = sdx * sdx + sdy * sdy + sdz * sdz;
      bool blocked = false;

      // ---- spheres (the jnp candidate pass; Scene.h:236-243) -----------
      for (int s = 0; s < a.S_real && !blocked; ++s) {
        const float* r = ssph + s * 9;
        const float ocx = sox - (r[0] + tm * r[4]);
        const float ocy = soy - (r[1] + tm * r[5]);
        const float ocz = soz - (r[2] + tm * r[6]);
        const float b = 2.0f * (sdx * ocx + sdy * ocy + sdz * ocz);
        const float cc = ocx * ocx + ocy * ocy + ocz * ocz - r[3];
        const float dl = b * b - 4.0f * a2 * cc;
        const float t = (-b - sqrtf(tt::maxf(dl, 0.0f))) / (2.0f * a2);
        if (dl >= 0.0f && t >= eps && r[7] > 0.5f && t < tl)
          blocked = tt::lane_uniform(bk, s) > r[8];
      }
      // ---- quads --------------------------------------------------------
      for (int q = 0; q < a.Q_real && !blocked; ++q) {
        const float* r = squad + q * 20;
        const float dotRN = sdx * r[0] + sdy * r[1] + sdz * r[2];
        const float o_n = sox * r[0] + soy * r[1] + soz * r[2];
        const float D = r[9] + tm * r[10];
        const float t = (D - o_n) / (dotRN == 0.0f ? 1e-30f : dotRN);
        const float o_er = sox * r[3] + soy * r[4] + soz * r[5];
        const float d_er = sdx * r[3] + sdy * r[4] + sdz * r[5];
        const float s1 = o_er + t * d_er - (r[11] + tm * r[12]);
        const float o_eu = sox * r[6] + soy * r[7] + soz * r[8];
        const float d_eu = sdx * r[6] + sdy * r[7] + sdz * r[8];
        const float s2 = o_eu + t * d_eu - (r[13] + tm * r[14]);
        const bool front = dotRN < 0.0f;
        const bool two_sided = r[17] > 0.5f;
        const bool ok = (dotRN != 0.0f) && (front || two_sided) &&
                        (t >= eps) && (s1 >= 0.0f) && (s1 <= r[15]) &&
                        (s2 >= 0.0f) && (s2 <= r[16]) && (r[18] > 0.5f);
        if (ok && t < tl) blocked = tt::lane_uniform(bk, a.S + q) > r[19];
      }
      // ---- meshes: closest raw hit in [eps, t_light) --------------------
      if (a.n_meshes > 0 && !blocked) {
        const float invx = 1.0f / sdx, invy = 1.0f / sdy, invz = 1.0f / sdz;
        for (int m = 0; m < a.n_meshes && !blocked; ++m) {
          if (!(tt::lane_uniform(bk, a.S + a.Q + m) > smesh[m])) continue;
          float bt = tt::INF;
          int btri = -1;
          tt::walk(tr, a.root[m], a.end[m], sox, soy, soz, sdx, sdy, sdz,
                   invx, invy, invz, &bt, &btri);
          blocked = bt >= eps && bt < tl;
        }
      }
      acc += blocked ? 1.0f : 0.0f;
    }
    // 1 - mean_k: the sum times f32(1/K), as jnp.mean compiles
    a.out[(size_t)l * a.n + i] = 1.0f - acc * (1.0f / (float)a.K);
  }
}

}  // namespace

extern "C" int tt_shadow(const ShadowArgs* args, void* stream) {
  const ShadowArgs& a = *args;
  const int blocks = (a.n + THREADS - 1) / THREADS;
  const size_t smem =
      sizeof(float) * (size_t)(a.L * 4 + a.S_real * 9 + a.Q_real * 20 +
                               a.n_meshes);
  shadow_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
