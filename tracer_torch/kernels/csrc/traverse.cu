// BVH walk kernel for Hopper: the closest triangle hit (t, tri) of every
// ray in every mesh, one thread per ray, each walking its own stackless
// skip-link preorder (bvh.cuh) over each mesh's node range.
//
// Replaces the TPU kernel tracer/kernels/traverse.py::mesh_closest_hits
// (Pallas; body _kernel at traverse.py:185-206, walk packet_walk at
// :88-182). The TPU kernel walks a 32x128-ray packet through one preorder
// to amortise its scalar control flow; a GPU thread has its own program
// counter, so each ray takes only its own path. The plain PyTorch version
// is tracer_torch/kernels/traverse.py::mesh_closest_hits_plain.
//
// Bound: the walk. A ray reads 28 B and writes 8 B per mesh; each node
// visit is a dependent 40 B load (L2-resident: a 53k-triangle tree is
// ~7 MB) and a slab test, each leaf up to leaf_width triangle tests of
// 80 B each. Warps diverge where their rays take different paths; the
// leaf loop ends at the first padding slot and culls back faces before
// the barycentric test.
//
// Outputs: out_t [n_meshes, n] f32 (INF on a miss), out_tri [n_meshes, n]
// i32 (-1 on a miss); lanes with live false get (INF, -1).
#include <cuda_runtime.h>

#include "bvh.cuh"

constexpr int MAX_MESHES = 16;

// Mirror of _Args in tracer_torch/kernels/traverse.py (same order).
struct TraverseArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const unsigned char* live;
  const float* nodes_f;
  const int* nodes_i;
  const float* leaf;
  float* out_t;
  int* out_tri;
  int n, n_meshes, leaf_width, sentinel;
  int root[MAX_MESHES], end[MAX_MESHES];
};

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) traverse_kernel(TraverseArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const bool live = a.live[i] != 0;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  if (live) {
    ox = a.ox[i]; oy = a.oy[i]; oz = a.oz[i];
    dx = a.dx[i]; dy = a.dy[i]; dz = a.dz[i];
  }
  // the slab test's 1/d, hoisted out of the walk (the same value)
  const float invx = 1.0f / dx, invy = 1.0f / dy, invz = 1.0f / dz;
  const tt::Tree tr{reinterpret_cast<const float4*>(a.nodes_f),
                    reinterpret_cast<const int2*>(a.nodes_i),
                    reinterpret_cast<const float4*>(a.leaf), a.leaf_width,
                    a.sentinel};
  for (int m = 0; m < a.n_meshes; ++m) {
    float bt = tt::INF;
    int btri = -1;
    if (live)
      tt::walk(tr, a.root[m], a.end[m], ox, oy, oz, dx, dy, dz, invx, invy,
               invz, &bt, &btri);
    a.out_t[(size_t)m * a.n + i] = bt;
    a.out_tri[(size_t)m * a.n + i] = btri;
  }
}

}  // namespace

extern "C" int tt_traverse(const TraverseArgs* args, void* stream) {
  const int blocks = (args->n + THREADS - 1) / THREADS;
  traverse_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
