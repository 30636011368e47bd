// Deterministic row sums for Hopper: out[r, c] = the sum of g[k, c] over
// the lanes k whose row id idx[k] is r (every other row 0). It is the
// gradient of a row gather (`torch.index_select`), the replay's
// `integrator._take` and `_rows`.
//
// Replaces no Pallas kernel: the JAX package sums these rows by a one-hot
// product outside Pallas (tracer/render/integrator.py:154, `_rows`, whose
// vjp is onehot^T @ g on the MXU). On the card that product costs N * R
// * 4 bytes of one-hot matrix (4.9 GB at R = 3,000), and `index_add_`, the
// plain version (tracer_torch/kernels/rowsum.py::row_sum_plain), sums with
// float atomics in an order that changes from run to run. This kernel
// sums every row in one fixed order, so two runs give the same bits; it
// agrees with the plain version to f32 summation order.
//
// Bound: memory. The function reads each lane's row id (4 B) and its
// cotangent row (4 * C B) once and writes the table once: 32.6 MB, ~10 us
// at 3.35 TB/s, for 408,000 lanes of 19 columns. The design, one call,
// no float atomics, no search (the pieces of csrc/sorted_fold.cu):
// - A stable LSD radix sort of (row id, lane) pairs over the ceil(log2 R)
//   bits of the row id, 8 bits a pass (one pass for R <= 256), three
//   kernels a pass: per-tile digit counts (shared integer atomics: exact),
//   one block's exclusive scan of the counts in (digit, tile) order, and a
//   stable scatter (each warp ranks its 32 items by __match_any_sync, in
//   order). The first pass reads the row ids where they lie; the last
//   writes the sorted row ids and gathers each lane's cotangent row into
//   column-major sorted order, so that the fold reads both coalesced.
// - The fold, one column per grid row (blockIdx.y): per chunk of 1024
//   sorted lanes, the chunk's composed run map by a warp-shuffle scan; one
//   block per column scans the chunks' maps into each chunk's carry; each
//   chunk scans again from its carry, and the thread holding a run's last
//   lane writes out[row, c]. The run map of a stretch of sorted lanes is
//   x -> m ? x + t : u (m: the stretch continues the run before it), and
//   maps compose associatively, so a row of 400,000 lanes costs one carry.
#include <cuda_runtime.h>
#include <stdint.h>

// Mirror of _Args in tracer_torch/kernels/rowsum.py (same order).
struct RowSumArgs {
  const int* idx;   // [n] each lane's row id, in [0, r)
  const float* g;   // [n, c] each lane's cotangent row
  float* out;       // [r, c]
  int2* rec0;       // [n] (row id, lane) pairs, sort buffers
  int2* rec1;       // [n]
  int* hist;        // [BINS * tiles] digit counts, then offsets
  int* keys;        // [n] the sorted row ids
  float* vals;      // [c, n] the cotangents in sorted order
  float* maps;      // [c, chunks, 4] each chunk's run map
  float* carry;     // [c, chunks] each chunk's carry
  int n, r, c, passes;
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BINS = 256;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 4096;                // sort items per block
constexpr int STEPS = TILE / THREADS;     // 32-item steps per warp
constexpr int CHUNK = 1024;               // fold items per block
constexpr int PER = CHUNK / THREADS;      // consecutive items per thread
constexpr int SCAN_THREADS = 1024;

// Sort item k of a pass: the first pass reads the row ids in place.
__device__ __forceinline__ int2 item(const RowSumArgs& a, const int2* src,
                                     int k) {
  return src ? src[k] : make_int2(a.idx[k], k);
}

__global__ void __launch_bounds__(THREADS)
rs_digit_counts(RowSumArgs a, int shift, const int2* src) {
  __shared__ int h[BINS];
  const int b = blockIdx.x, nt = gridDim.x;
  const int hi = min(a.n, (b + 1) * TILE);
  for (int d = threadIdx.x; d < BINS; d += THREADS) h[d] = 0;
  __syncthreads();
  for (int k = b * TILE + threadIdx.x; k < hi; k += THREADS)
    atomicAdd(&h[(item(a, src, k).x >> shift) & (BINS - 1)], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < BINS; d += THREADS) a.hist[d * nt + b] = h[d];
}

// exclusive scan in place of hist[0 .. total), in (digit, tile) order, in
// one block: warp w takes a contiguous range in runs of 32
__global__ void __launch_bounds__(SCAN_THREADS)
rs_count_scan(RowSumArgs a, int total) {
  constexpr int U = 8;  // loads in flight per lane
  __shared__ int wsum[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int runs = (total + 31) / 32;
  const int per = 32 * ((runs + SCAN_THREADS / 32 - 1) / (SCAN_THREADS / 32));
  const int lo = min(total, w * per), hi = min(total, lo + per);
  int s = 0;
  for (int k0 = lo; k0 < hi; k0 += 32 * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * 32 + lane;
      s += k < hi ? a.hist[k] : 0;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) wsum[w] = s;
  __syncthreads();
  int carry = 0;
  for (int q = 0; q < w; ++q) carry += wsum[q];
  for (int k0 = lo; k0 < hi; k0 += 32 * U) {
    int v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * 32 + lane;
      v[u] = k < hi ? a.hist[k] : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int inc = v[u];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(FULL, inc, off);
        if (lane >= off) inc += o;
      }
      const int k = k0 + u * 32 + lane;
      if (k < hi) a.hist[k] = carry + inc - v[u];
      carry += __shfl_sync(FULL, inc, 31);
    }
  }
}

// The stable scatter of one pass; the last pass (last != 0) writes the
// sorted row ids and the lanes' cotangent rows instead of the pairs.
__global__ void __launch_bounds__(THREADS)
rs_scatter(RowSumArgs a, int shift, const int2* src, int2* dst, int last) {
  __shared__ int wh[WARPS][BINS];
  const int b = blockIdx.x, nt = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  for (int e = threadIdx.x; e < WARPS * BINS; e += THREADS)
    (&wh[0][0])[e] = 0;
  __syncthreads();
  const int base = b * TILE + warp * (TILE / WARPS);
  // each warp counts its part of the tile, per digit
  for (int st = 0; st < STEPS; ++st) {
    const int k = base + st * 32 + lane;
    const bool ok = k < a.n;
    const int d = ok ? (item(a, src, k).x >> shift) & (BINS - 1) : -1;
    const unsigned peers = __match_any_sync(FULL, d);
    if (ok && (peers & lt) == 0) wh[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // where each warp's items of each digit start: the tile's offset, then
  // the warps before it
  for (int d = threadIdx.x; d < BINS; d += THREADS) {
    int run = a.hist[d * nt + b];
    for (int w = 0; w < WARPS; ++w) {
      const int c = wh[w][d];
      wh[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int st = 0; st < STEPS; ++st) {
    const int k = base + st * 32 + lane;
    const bool ok = k < a.n;
    int2 r = make_int2(0, 0);
    if (ok) r = item(a, src, k);
    const int d = ok ? (r.x >> shift) & (BINS - 1) : -1;
    const unsigned peers = __match_any_sync(FULL, d);
    int pos = 0;
    if (ok) pos = wh[warp][d] + __popc(peers & lt);
    __syncwarp();
    if (ok) {
      if (last) {
        a.keys[pos] = r.x;
        const float* row = a.g + (size_t)r.y * a.c;
        for (int c = 0; c < a.c; ++c) a.vals[(size_t)c * a.n + pos] = row[c];
      } else {
        dst[pos] = r;
      }
      if ((peers & lt) == 0) wh[warp][d] = pos + __popc(peers);
    }
    __syncwarp();
  }
}

// ---- the fold over the sorted lanes, one column per grid row ------------

// x -> m ? x + t : u
struct Map {
  int m;
  float t, u;
};

__device__ __forceinline__ Map identity() { return {1, 0.0f, 0.0f}; }

// f then g (g after f)
__device__ __forceinline__ Map then(const Map& f, const Map& g) {
  if (!g.m) return g;
  return {f.m, f.t + g.t, f.u + g.t};
}

__device__ __forceinline__ Map shfl_up(const Map& f, int off) {
  return {__shfl_up_sync(FULL, f.m, off), __shfl_up_sync(FULL, f.t, off),
          __shfl_up_sync(FULL, f.u, off)};
}

// the map of sorted lane k: continue the run of lane k-1 or start one
__device__ __forceinline__ Map item_map(const RowSumArgs& a, int k, int key,
                                        float v) {
  return {k > 0 && a.keys[k - 1] == key, v, v};
}

__device__ __forceinline__ float apply(const Map& f, float x) {
  return f.m ? x + f.t : f.u;
}

// The maps of the threads before this one in the block (each thread's map
// covers its PER consecutive items), and the block's whole map.
__device__ __forceinline__ Map block_exclusive(const Map& mine, Map* whole) {
  __shared__ Map wtot[WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  Map inc = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Map o = shfl_up(inc, off);
    if (lane >= off) inc = then(o, inc);
  }
  Map exc = shfl_up(inc, 1);
  if (lane == 0) exc = identity();
  if (lane == 31) wtot[w] = inc;
  __syncthreads();
  Map pre = identity();
  for (int q = 0; q < w; ++q) pre = then(pre, wtot[q]);
  Map all = identity();
  for (int q = 0; q < WARPS; ++q) all = then(all, wtot[q]);
  *whole = all;
  __syncthreads();  // wtot is read before any thread leaves
  return lane == 0 ? pre : then(pre, exc);
}

__global__ void __launch_bounds__(THREADS) rs_chunk_maps(RowSumArgs a) {
  const int ch = blockIdx.x, c = blockIdx.y;
  const int nf = gridDim.x;
  const float* col = a.vals + (size_t)c * a.n;
  const int k0 = ch * CHUNK + threadIdx.x * PER;
  Map f = identity();
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int k = k0 + q;
    if (k < a.n) f = then(f, item_map(a, k, a.keys[k], col[k]));
  }
  Map whole;
  block_exclusive(f, &whole);
  if (threadIdx.x == 0) {
    float* o = a.maps + ((size_t)c * nf + ch) * 4;
    o[0] = whole.m ? 1.0f : 0.0f;
    o[1] = whole.t;
    o[2] = whole.u;
  }
}

__device__ __forceinline__ Map load_map(const float* maps) {
  return {maps[0] > 0.5f ? 1 : 0, maps[1], maps[2]};
}

// carry[c, ch] = the running run sum of column c after chunks 0..ch-1
// (the chunks' maps composed in order and applied to 0), a block a column
__global__ void __launch_bounds__(THREADS) rs_carries(RowSumArgs a, int nf) {
  const int c = blockIdx.x;
  const float* maps = a.maps + (size_t)c * nf * 4;
  const int per = (nf + THREADS - 1) / THREADS;
  const int lo = min(nf, (int)threadIdx.x * per), hi = min(nf, lo + per);
  Map f = identity();
  for (int ch = lo; ch < hi; ++ch) f = then(f, load_map(maps + 4 * ch));
  Map whole;
  Map pre = block_exclusive(f, &whole);
  for (int ch = lo; ch < hi; ++ch) {
    a.carry[(size_t)c * nf + ch] = apply(pre, 0.0f);
    pre = then(pre, load_map(maps + 4 * ch));
  }
}

__global__ void __launch_bounds__(THREADS) rs_runs(RowSumArgs a) {
  const int ch = blockIdx.x, c = blockIdx.y;
  const int nf = gridDim.x;
  const float* col = a.vals + (size_t)c * a.n;
  const int k0 = ch * CHUNK + threadIdx.x * PER;
  int key[PER];
  float v[PER];
  Map f = identity();
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int k = k0 + q;
    if (k < a.n) {
      key[q] = a.keys[k];
      v[q] = col[k];
      f = then(f, item_map(a, k, key[q], v[q]));
    }
  }
  Map whole;
  const Map pre = block_exclusive(f, &whole);
  float x = apply(pre, a.carry[(size_t)c * nf + ch]);
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int k = k0 + q;
    if (k >= a.n) break;
    x = apply(item_map(a, k, key[q], v[q]), x);
    if (k == a.n - 1 || a.keys[k + 1] != key[q])  // the run's last lane
      a.out[(size_t)key[q] * a.c + c] = 0.0f + x;
  }
}

}  // namespace

extern "C" int tt_row_sum(const RowSumArgs* args, void* stream) {
  const RowSumArgs a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      a.out, 0, sizeof(float) * (size_t)a.r * (size_t)a.c, s);
  if (err != cudaSuccess || a.n == 0 || a.c == 0) return (int)err;
  const int nt = (a.n + TILE - 1) / TILE, nf = (a.n + CHUNK - 1) / CHUNK;
  for (int pass = 0; pass < a.passes; ++pass) {
    // pass p writes rec[p & 1] and reads what pass p - 1 wrote
    const int2* src = pass == 0 ? nullptr : (pass & 1) ? a.rec0 : a.rec1;
    int2* dst = (pass & 1) ? a.rec1 : a.rec0;
    rs_digit_counts<<<nt, THREADS, 0, s>>>(a, 8 * pass, src);
    rs_count_scan<<<1, SCAN_THREADS, 0, s>>>(a, BINS * nt);
    rs_scatter<<<nt, THREADS, 0, s>>>(a, 8 * pass, src, dst,
                                      pass == a.passes - 1);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nf, a.c);
  rs_chunk_maps<<<grid, THREADS, 0, s>>>(a);
  rs_carries<<<a.c, THREADS, 0, s>>>(a, nf);
  rs_runs<<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
