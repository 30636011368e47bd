// Soft-shadow kernel for Hopper: per light, K jittered shadow rays from a
// hit point, each tested against every sphere, quad and mesh with one
// stochastic-transparency Bernoulli draw per occluder; the factor is
// 1 - mean_k(blocked). One work item per (hit point, light, sample).
//
// Replaces the TPU kernel tracer/kernels/shadow.py::shadow_factors (Pallas;
// body _kernel at shadow.py:213-463). Its semantics are the JAX package's
// jnp path (integrator._shadow_factor_jnp and _shadow_blocked_p), whose
// plain PyTorch port is tracer_torch/kernels/shadow.py::shadow_factors_plain:
// the same expressions in the same order, built with --fmad=false.
//
// The TPU kernel shares one packet walk among a light's K samples (a union
// walk around the central ray). Here each sample's ray walks on its own
// (bvh.cuh), so no bound on the samples' union is needed. A mesh's walk is
// skipped only where it cannot change the result: the sample is already
// blocked (the blocked OR does not depend on the order of the tests, since
// every occluder's draw has its own key), or the mesh's draw is at most
// its transparency (then the mesh cannot block this sample).
//
// Bound: the walks' chains of dependent L2 loads, above all the longest
// ones. With one thread per hit point running its L x K walks one after
// another, a thread near the mesh chained twenty walks and its warp waited
// for it; and a warp whose lanes mix starting samples with walking ones
// runs both paths each turn (measured: the walks cost ~9x the rest). The
// design, two kernels per call:
// - shadow_setup, one thread per sample: its ray, the sphere and quad
//   tables, and the meshes' root boxes (nodes that every sample reads, so
//   they stay in L1: a copy in shared memory was no faster on an H100). Most
//   samples end here and are counted. A sample that enters a root box
//   becomes a task (one atomic per warp appends a warp's tasks).
// - shadow_walk, one wave of persistent blocks whose lanes take the next
//   task from a work counter as soon as their sample ends (tt::TaskQueue),
//   so warps stay full until the list drains. A task's ray is drawn again
//   (the same expressions, the same value); each loop turn a lane takes
//   one unit, a node or a leaf slot whose loads were issued a turn ahead
//   (tt::Walk), so no lane holds its warp through a whole leaf.
// - each walk starts with its best t at t_light, the TPU walk's tmax
//   (tracer/kernels/traverse.py:97-99): boxes entered at or beyond the
//   light are pruned, and blocked = bt >= eps && bt < t_light is
//   unchanged, since a hit at or beyond t_light never blocked. The closest
//   hit still decides (a hit in [0, eps) unblocks the sample even with
//   another in [eps, t_light): the reference's eps quirk), so there is no
//   any-hit exit;
// - the count is exact: each ended sample adds 1 + 65536 * blocked to an
//   int32 word per (light, hit point) (the lanes of a warp that share a
//   word add together), and the sample that brings the done count to K
//   writes 1 - blocked_count * f32(1/K), the plain version's sum times
//   f32(1/K), bit for bit, in any order. No float atomics.
//
// The tables sit in each block's dynamic shared memory, or, when they
// exceed a block's 227 KB, are read through L2 by the kernels' second
// instances; the meshes' node ranges come as a device array [n_meshes]
// (root, end), and their root nodes are read through the read-only cache.
// So any table size and any number of meshes run on the card, as on the
// TPU.
//
// Tables (tracer_torch/kernels/shadow.py::shadow_tables):
// light [L, 4] = pos(3), radius/2; sph [S, 9] = c(3), r^2, mb(3), valid,
// transparency; quad [Q, 20] = n(3), er(3), eu(3), v0.n, mb.n, v0.er,
// mb.er, v0.eu, mb.eu, er.er, eu.eu, glass, valid, transparency; mesh [Nm]
// = transparency. Output: out [L, n]; lanes with live false get 1.0.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bvh.cuh"
#include "common.cuh"
#include "pcg.cuh"

// Mirror of _Args in tracer_torch/kernels/shadow.py (same order).
struct ShadowArgs {
  const float *px, *py, *pz, *tm;
  const long long* key;  // uint32 keys in int64 (the low word is read)
  const unsigned char* live;
  const float *light, *sph, *quad, *mesh;
  const float* nodes_f;
  const int* nodes_i;
  const float* leaf;
  float* out;
  unsigned* counts;  // [L * n], zeroed: done + 65536 * blocked
  int2* tasks;       // [L * n * K]: (l * n + i, k) of the samples to walk
  int* work;         // [2]: the task count and the walk's work counter
  const int2* ranges;  // [n_meshes]: mesh m's node range [root, end)
  int n, n_meshes, leaf_width;
  // written by the launcher: the walk's persistent blocks, tables shared
  int blocks, shared_tables;
  int L, S, S_real, Q, Q_real, K, ref;
  float eps;         // the scene's candidate cut (t >= eps)
  float offset_eps;  // the shadow ray's origin offset (cfg.epsilon)
  // >= 0: key holds the sample's keys, and this bounce's are
  // mix(key, salt) (the bounce index); -1: key holds this bounce's keys
  int salt;
};

namespace {

constexpr int THREADS = 128;
constexpr uint32_t SHADOW_LIGHT_POS = 4;
constexpr uint32_t SHADOW_BERNOULLI = 5;

// The tables: in dynamic shared memory (kShared), or the global ones read
// through L2 when they exceed a block's 227 KB; and the meshes' roots.
template <bool kShared>
struct Tables {
  const float *light, *sph, *quad, *mesh;
  tt::Roots roots;
};

// Floats of the tables in shared memory.
__host__ __device__ __forceinline__ int table_floats(const ShadowArgs& a) {
  return a.L * 4 + a.S_real * 9 + a.Q_real * 20 + a.n_meshes;
}

template <bool kShared>
__device__ __forceinline__ Tables<kShared> load_tables(const ShadowArgs& a,
                                                       float* smem) {
  const tt::Tree tr = {reinterpret_cast<const float4*>(a.nodes_f),
                       reinterpret_cast<const int2*>(a.nodes_i),
                       reinterpret_cast<const float4*>(a.leaf), a.leaf_width};
  const tt::Roots roots{a.ranges, tr, nullptr, 0};  // all through L1
  if (!kShared) return Tables<kShared>{a.light, a.sph, a.quad, a.mesh, roots};
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
  return Tables<kShared>{slight, ssph, squad, smesh, roots};
}

// Sample k toward light l of hit point i (integrator._shadow_factor_jnp):
// the ray from the offset origin, its distance to the jittered light
// point, its Bernoulli key and the ray time.
struct Sample {
  tt::Ray r;
  float tl, tm;
  uint32_t bk;
};

template <bool kShared>
__device__ __forceinline__ Sample make_sample(const ShadowArgs& a,
                                              const Tables<kShared>& tb,
                                              int i, int l, int k) {
  const float px = a.px[i], py = a.py[i], pz = a.pz[i];
  const uint32_t key = a.salt >= 0
                           ? tt::mix((uint32_t)a.key[i], (uint32_t)a.salt)
                           : (uint32_t)a.key[i];
  const float* lt = tb.light + l * 4;
  const float delta = lt[3];
  const uint32_t skey = tt::mix(tt::mix(key, SHADOW_LIGHT_POS), l);
  const uint32_t bkey = tt::mix(tt::mix(key, SHADOW_BERNOULLI), l);
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
    const float rr = sqrtf(tt::maxf(1.0f - rz * rz, 0.0f));
    const float phi = 6.2831855f * u1;  // f32(2*pi)
    rx = rr * cosf(phi);
    ry = rr * sinf(phi);
  }
  const float offx = (delta * rx + lt[0]) - px;
  const float offy = (delta * ry + lt[1]) - py;
  const float offz = (delta * rz + lt[2]) - pz;
  Sample s;
  s.tl = sqrtf(offx * offx + offy * offy + offz * offz);
  const float inv = 1.0f / tt::maxf(s.tl, 1e-20f);
  const float sdx = inv * offx, sdy = inv * offy, sdz = inv * offz;
  s.r = tt::Ray{a.offset_eps * sdx + px, a.offset_eps * sdy + py,
                a.offset_eps * sdz + pz, sdx, sdy, sdz, 1.0f / sdx,
                1.0f / sdy, 1.0f / sdz};
  s.bk = tt::mix(bkey, k + 2);
  s.tm = a.tm[i];
  return s;
}

// The sphere and quad tables (the jnp candidate pass; Scene.h:236-243),
// up to the first occluder that blocks the sample.
template <bool kShared>
__device__ __forceinline__ bool table_blocked(const ShadowArgs& a,
                                              const Tables<kShared>& tb,
                                              const Sample& s) {
  const float eps = a.eps, tl = s.tl, tm = s.tm;
  const float sox = s.r.ox, soy = s.r.oy, soz = s.r.oz;
  const float sdx = s.r.dx, sdy = s.r.dy, sdz = s.r.dz;
  const float a2 = sdx * sdx + sdy * sdy + sdz * sdz;
  bool blocked = false;
  for (int q = 0; q < a.S_real && !blocked; ++q) {
    const float* rw = tb.sph + q * 9;
    const float ocx = sox - (rw[0] + tm * rw[4]);
    const float ocy = soy - (rw[1] + tm * rw[5]);
    const float ocz = soz - (rw[2] + tm * rw[6]);
    const float b = 2.0f * (sdx * ocx + sdy * ocy + sdz * ocz);
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rw[3];
    const float dl = b * b - 4.0f * a2 * cc;
    const float t = (-b - sqrtf(tt::maxf(dl, 0.0f))) / (2.0f * a2);
    if (dl >= 0.0f && t >= eps && rw[7] > 0.5f && t < tl)
      blocked = tt::lane_uniform(s.bk, q) > rw[8];
  }
  for (int q = 0; q < a.Q_real && !blocked; ++q) {
    const float* rw = tb.quad + q * 20;
    const float dotRN = sdx * rw[0] + sdy * rw[1] + sdz * rw[2];
    const float o_n = sox * rw[0] + soy * rw[1] + soz * rw[2];
    const float D = rw[9] + tm * rw[10];
    const float t = (D - o_n) / (dotRN == 0.0f ? 1e-30f : dotRN);
    const float o_er = sox * rw[3] + soy * rw[4] + soz * rw[5];
    const float d_er = sdx * rw[3] + sdy * rw[4] + sdz * rw[5];
    const float s1 = o_er + t * d_er - (rw[11] + tm * rw[12]);
    const float o_eu = sox * rw[6] + soy * rw[7] + soz * rw[8];
    const float d_eu = sdx * rw[6] + sdy * rw[7] + sdz * rw[8];
    const float s2 = o_eu + t * d_eu - (rw[13] + tm * rw[14]);
    const bool front = dotRN < 0.0f;
    const bool two_sided = rw[17] > 0.5f;
    const bool ok = (dotRN != 0.0f) && (front || two_sided) && (t >= eps) &&
                    (s1 >= 0.0f) && (s1 <= rw[15]) && (s2 >= 0.0f) &&
                    (s2 <= rw[16]) && (rw[18] > 0.5f);
    if (ok && t < tl) blocked = tt::lane_uniform(s.bk, a.S + q) > rw[19];
  }
  return blocked;
}

// The first mesh from m on (m included) whose draw exceeds its
// transparency (a mesh's draw is lane S + Q + m of the sample's key) and
// whose root box the ray enters below t_light, and the node its walk goes
// on at; n_meshes if none: no further mesh can block the sample.
template <bool kShared>
__device__ __forceinline__ int enter_mesh(const ShadowArgs& a,
                                          const Tables<kShared>& tb,
                                          const Sample& s, int m, int& node) {
  for (; m < a.n_meshes; ++m) {
    if (!(tt::lane_uniform(s.bk, a.S + a.Q + m) > tb.mesh[m])) continue;
    const int2 rg = tb.roots.span(m);
    if (!(rg.x < rg.y)) continue;  // an empty mesh
    const tt::Node root = tb.roots.node(m, rg);
    node = tt::after_root(root, rg.x, rg.y, tt::slab(root, s.r, s.tl));
    if (node < rg.y) return m;
  }
  return a.n_meshes;
}

// 1 - mean_k(blocked): the sum times f32(1/K), as jnp.mean compiles.
__device__ __forceinline__ float factor(unsigned n_blocked, int K) {
  return 1.0f - (float)n_blocked * (1.0f / (float)K);
}

// Count the samples that lanes end (`fin`) into their (light, point) words
// (done + 65536 * blocked): one atomic for the lanes of a warp that share
// a word; the one that brings the done count to K writes the factor. All
// 32 lanes call it together.
__device__ __forceinline__ void count(const ShadowArgs& a, bool fin,
                                      int cell, bool blocked) {
  if (__ballot_sync(tt::FULL, fin) == 0) return;
  const int lane = threadIdx.x & 31;
  const unsigned grp = __match_any_sync(tt::FULL, fin ? cell : -1 - lane);
  const unsigned bm = __ballot_sync(tt::FULL, fin && blocked);
  if (fin && __ffs(grp) - 1 == lane) {
    const unsigned nd = __popc(grp), nb = __popc(grp & bm);
    const unsigned old = atomicAdd(a.counts + cell, nd + (nb << 16));
    if ((old & 0xffffu) + nd == (unsigned)a.K)
      a.out[cell] = factor((old >> 16) + nb, a.K);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(THREADS) shadow_setup(ShadowArgs a) {
  extern __shared__ float4 smem4[];  // the tables (kShared)
  const Tables<kShared> tb =
      load_tables<kShared>(a, reinterpret_cast<float*>(smem4));
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = t < (long long)a.L * a.n * a.K;
  const int cell = valid ? (int)(t / a.K) : 0;  // l * n + i
  const int k = valid ? (int)(t - (long long)cell * a.K) : 0;
  const int l = cell / a.n;
  const int i = cell - l * a.n;
  bool fin = false, blocked = false, walk = false;
  if (valid && !a.live[i]) {
    if (k == 0) a.out[cell] = 1.0f;
  } else if (valid) {
    const Sample s = make_sample(a, tb, i, l, k);
    blocked = table_blocked(a, tb, s);
    int node = 0;
    walk = !blocked && enter_mesh(a, tb, s, 0, node) < a.n_meshes;
    fin = !walk;
  }
  count(a, fin, cell, blocked);
  const int at = tt::warp_append(walk ? 1 : 0, a.work);
  if (walk) a.tasks[at] = make_int2(cell, k);
}

template <bool kShared>
__global__ void __launch_bounds__(THREADS) shadow_walk(ShadowArgs a) {
  extern __shared__ float4 smem4[];  // the tables (kShared)
  const Tables<kShared> tb =
      load_tables<kShared>(a, reinterpret_cast<float*>(smem4));
  const tt::Tree tr = {reinterpret_cast<const float4*>(a.nodes_f),
                       reinterpret_cast<const int2*>(a.nodes_i),
                       reinterpret_cast<const float4*>(a.leaf), a.leaf_width};
  tt::TaskQueue q(a.work + 1, *(volatile int*)a.work);
  bool busy = false;
  int cell = 0, m = 0;
  Sample s;
  float bt = 0.0f;
  int btri = -1;
  tt::Walk w;
  for (;;) {
    int task = 0;
    const bool fresh = q.take(!busy, task);
    if (__ballot_sync(tt::FULL, busy || fresh) == 0) break;
    bool fin = false, blocked = false;
    if (fresh) {  // the sample again, and the first mesh it enters
      const int2 tk = a.tasks[task];
      cell = tk.x;
      const int l = cell / a.n;
      s = make_sample(a, tb, cell - l * a.n, l, tk.y);
      int node = 0;
      m = enter_mesh(a, tb, s, 0, node);
      busy = true;
      if (m < a.n_meshes) {
        w.begin(tr, node, tb.roots.span(m).y);
        bt = s.tl;
      } else {
        busy = false;
        fin = true;
      }
    } else if (busy) {
      // the closest raw hit below t_light decides: blocked at or beyond eps
      w.unit(tr, s.r, bt, btri);
      if (w.done()) {
        blocked = bt >= a.eps && bt < s.tl;
        int node = 0;
        m = blocked ? a.n_meshes : enter_mesh(a, tb, s, m + 1, node);
        if (m < a.n_meshes) {
          w.begin(tr, node, tb.roots.span(m).y);
          bt = s.tl;
        } else {
          busy = false;
          fin = true;
        }
      }
    }
    count(a, fin, cell, blocked);
  }
}

tt::SharedFit g_fit;

}  // namespace

extern "C" int tt_shadow(ShadowArgs* args, void* stream) {
  const ShadowArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = sizeof(float) * (size_t)table_floats(a);
  const tt::SharedFit& fit =
      tt::fit_shared(g_fit, smem, THREADS, shadow_walk<true>,
                     shadow_walk<false>, shadow_setup<true>);
  args->shared_tables = fit.fits ? 1 : 0;
  const long long samples = (long long)a.L * a.n * a.K;
  const int grid = (int)((samples + THREADS - 1) / THREADS);
  // with no mesh every sample ends in the setup
  args->blocks = a.n_meshes > 0 ? fit.blocks : 0;
  if (fit.fits) {
    shadow_setup<true><<<grid, THREADS, smem, st>>>(a);
    if (args->blocks > 0)
      shadow_walk<true><<<args->blocks, THREADS, smem, st>>>(a);
  } else {
    shadow_setup<false><<<grid, THREADS, 0, st>>>(a);
    if (args->blocks > 0)
      shadow_walk<false><<<args->blocks, THREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
