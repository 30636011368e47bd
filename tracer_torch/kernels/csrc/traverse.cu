// BVH walk kernel for Hopper: the closest triangle hit (t, tri) of every
// ray in every mesh. Each (live ray, mesh) is a work item that one thread
// walks alone through the mesh's stackless skip-link preorder (bvh.cuh).
//
// Replaces the TPU kernel tracer/kernels/traverse.py::mesh_closest_hits
// (Pallas; body _kernel at traverse.py:185-206, walk packet_walk at
// :88-182). The TPU kernel walks a 32x128-ray packet through one preorder
// to amortise its scalar control flow; a GPU thread has its own program
// counter, so each ray takes only its own path. The plain PyTorch version
// is tracer_torch/kernels/traverse.py::mesh_closest_hits_plain.
//
// Bound: the longest walks, not the bytes. A ray reads 28 B and writes 8 B
// per mesh, and the tree stays in L2, but every step of a walk waits on
// L2 loads, and a few rays (those near the mesh, in a few screen rows)
// walk 25-50x the mean. With one thread per ray over the whole batch, each
// wave of blocks lasted as long as its longest warp, and a lane at a leaf
// held its warp through up to 16 dependent slot loads. The design, two
// kernels per call:
// - traverse_roots, one thread per (ray, mesh): the slab test of the
//   mesh's root box (for the first 16 meshes from shared memory, no
//   load). A miss, most rays, is written at once; a hit is appended to a
//   task list (one atomic per warp).
// - traverse_walk, one wave of persistent blocks whose lanes take the next
//   task from a work counter as soon as their walk ends (tt::TaskQueue),
//   so warps stay full until the list drains and the stacked tails become
//   one: the longest single walk. Each loop turn a lane takes one unit, a
//   node or a leaf slot whose loads were issued a turn ahead (tt::Walk),
//   so no lane holds its warp through a whole leaf.
//
// The meshes' node ranges come as a device array [n_meshes] (root, end):
// any number of meshes, as the TPU kernel takes. Each block keeps the
// first tt::ROOT_CACHE root nodes in shared memory and reads the others
// through the read-only cache (on an H100, reading every root through it
// made a call 3-8% slower on the stand-in flamingo scenes; PERF.md).
//
// Outputs: out_t [n_meshes, n] f32 (INF on a miss), out_tri [n_meshes, n]
// i32 (-1 on a miss); lanes with live false get (INF, -1).
#include <cuda_runtime.h>

#include "bvh.cuh"

// Mirror of _Args in tracer_torch/kernels/traverse.py (same order).
struct TraverseArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const unsigned char* live;
  const float* nodes_f;
  const int* nodes_i;
  const float* leaf;
  float* out_t;
  int* out_tri;
  int* tasks;  // [n_meshes * n] task list: m * n + i
  int* work;   // [2]: the task count and the walk's work counter, zeroed
  const int2* ranges;  // [n_meshes]: mesh m's node range [root, end)
  int n, n_meshes, leaf_width;
  int blocks;  // written by the launcher: the walk's persistent blocks
};

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ tt::Tree tree(const TraverseArgs& a) {
  return tt::Tree{reinterpret_cast<const float4*>(a.nodes_f),
                  reinterpret_cast<const int2*>(a.nodes_i),
                  reinterpret_cast<const float4*>(a.leaf), a.leaf_width};
}

__device__ __forceinline__ tt::Ray load_ray(const TraverseArgs& a, int i) {
  tt::Ray r;
  r.ox = a.ox[i]; r.oy = a.oy[i]; r.oz = a.oz[i];
  r.dx = a.dx[i]; r.dy = a.dy[i]; r.dz = a.dz[i];
  // the slab test's 1/d, hoisted out of the walk (the same value)
  r.invx = 1.0f / r.dx; r.invy = 1.0f / r.dy; r.invz = 1.0f / r.dz;
  return r;
}

__device__ __forceinline__ tt::Roots roots_of(const TraverseArgs& a,
                                              tt::Node* smem) {
  const tt::Roots rs = tt::cache_roots(tree(a), a.ranges, a.n_meshes, smem);
  __syncthreads();
  return rs;
}

__global__ void __launch_bounds__(THREADS) traverse_roots(TraverseArgs a) {
  __shared__ tt::Node sroots[tt::ROOT_CACHE];
  const tt::Roots roots = roots_of(a, sroots);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = t < (long long)a.n * a.n_meshes;
  const int m = valid ? (int)(t / a.n) : 0;
  const int i = valid ? (int)(t - (long long)m * a.n) : 0;
  bool task = false;
  if (valid) {
    if (a.live[i]) {
      const int2 rg = roots.span(m);
      if (rg.x < rg.y)
        task = tt::slab(roots.node(m, rg), load_ray(a, i), tt::INF);
    }
    if (!task) {
      a.out_t[t] = tt::INF;
      a.out_tri[t] = -1;
    }
  }
  const int at = tt::warp_append(task ? 1 : 0, a.work);
  if (task) a.tasks[at] = (int)t;
}

__global__ void __launch_bounds__(THREADS) traverse_walk(TraverseArgs a) {
  __shared__ tt::Node sroots[tt::ROOT_CACHE];
  const tt::Roots roots = roots_of(a, sroots);
  const tt::Tree tr = tree(a);
  tt::TaskQueue q(a.work + 1, *(volatile int*)a.work);
  bool busy = false;
  int out = 0;
  tt::Walk w;
  tt::Ray r;
  float bt = tt::INF;
  int btri = -1;
  for (;;) {
    int task = 0;
    const bool fresh = q.take(!busy, task);
    if (__ballot_sync(tt::FULL, busy || fresh) == 0) break;
    if (fresh) {  // the walk goes on past the root box the ray entered
      busy = true;
      out = a.tasks[task];
      const int m = out / a.n;
      r = load_ray(a, out - m * a.n);
      const int2 rg = roots.span(m);
      w.begin(tr, tt::after_root(roots.node(m, rg), rg.x, rg.y, true), rg.y);
      bt = tt::INF;
      btri = -1;
    }
    if (!busy) continue;
    if (!w.done()) w.unit(tr, r, bt, btri);
    if (w.done()) {
      a.out_t[out] = bt;
      a.out_tri[out] = btri;
      busy = false;
    }
  }
}

}  // namespace

extern "C" int tt_traverse(TraverseArgs* args, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long items = (long long)args->n * args->n_meshes;
  const int grid = (int)((items + THREADS - 1) / THREADS);
  traverse_roots<<<grid, THREADS, 0, st>>>(*args);
  args->blocks = tt::persistent_blocks(traverse_walk, THREADS, 0);
  traverse_walk<<<args->blocks, THREADS, 0, st>>>(*args);
  return (int)cudaGetLastError();
}
