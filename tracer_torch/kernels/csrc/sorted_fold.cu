// Texel-cotangent fold for Hopper: out[t] = data_g[t] + the sum of the
// cotangents of every update whose texel id is t.
//
// Replaces the TPU kernel tracer/kernels/fold.py::sorted_fold (Pallas;
// body _kernel at fold.py:67-117: per-window one-hot MXU contractions over
// the update stream that lax.sort ordered outside it). The TPU sorts every
// update; here most of the stream never reaches the sort: about 3/4 of a
// Cornell record's 2.04M updates are exact zeros sent to texel 0 (lanes
// with no texel), and adding +-0 to a texel sum changes no bit. The plain
// PyTorch version is tracer_torch/kernels/fold.py::sorted_fold_plain (the
// flat scatter-add); the two agree to f32 summation order, and a NaN or
// +-inf cotangent reaches its texel as it does there.
//
// Bound: memory. The function reads each update once (4 B id + 12 B
// cotangent) and the atlas gradient once, and writes the result once:
// Cornell's 2.04M updates onto a 2.1M-texel atlas move ~83 MB, ~25 us at
// 3.35 TB/s. The design, all passes deterministic (no float atomics, every
// sum in a fixed order), one call:
// - A stable compaction: per stream tile of 4096 updates, the count of
//   the updates whose three channels are not all +-0 (NaN is kept); then
//   each tile sums the counts of the tiles before it and writes its
//   survivors, packed as (id, gx, gy, gz), in stream order (warp ballots).
//   It reads the per-bounce record rows in place (up to MAX_SEG segments,
//   no concatenation); the survivor count stays on the device.
// - A stable LSD radix sort of the survivors over the ceil(log2 P) bits of
//   the texel id, 8 bits a pass, three kernels a pass: per-tile digit
//   counts (shared integer atomics: exact), one block's exclusive scan of
//   the counts in (digit, tile) order (each warp a contiguous range, eight
//   coalesced loads in flight), and a stable scatter (each warp ranks its
//   32 items by __match_any_sync, in order). Its kernels and the fold's
//   walk the tiles in use with one wave of blocks, the survivor count being
//   on the device.
// - The fold of the sorted survivors, with no search: one block per chunk
//   of 1024 computes the chunk's composed run map (below) by a warp-shuffle
//   scan; one block scans the chunks' maps in order into each chunk's
//   carry; then each chunk scans again from its carry, and the thread
//   that holds a run's last update writes out[id] = data[id] + the run's
//   sum. The other texels keep out = data (a device copy first).
// The run map of a stretch of sorted updates is x -> m ? x + t : u: the
// running sum of the current run after the stretch, given the one before
// (m: the stretch continues that run). Maps compose associatively, so a
// hot texel costs one carry, not a walk over the chunks.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_SEG = 16;

// Mirror of _Args in tracer_torch/kernels/fold.py (same order).
struct FoldArgs {
  const int* ids[MAX_SEG];  // segment s: ids[s][0..len[s]), gx/gy/gz alike
  const float* gx[MAX_SEG];
  const float* gy[MAX_SEG];
  const float* gz[MAX_SEG];
  int len[MAX_SEG];
  int blk[MAX_SEG + 1];  // first tile of each segment; blk[nseg] = NB
  int nseg;
  const float* data;     // [p, 3]
  float* out;            // [p, 3]
  int4* rec0;            // [m] packed (id, gx, gy, gz) survivors
  int4* rec1;            // [m]
  int* tcount;           // [NB] survivors of each stream tile
  int* hist;             // [BINS * tiles] digit counts, then offsets
  int* count;            // [1] survivors
  float* maps;           // [NF * 8] each chunk's run map
  float* carry;          // [NF * 4] each chunk's carry
  int p, m, passes;
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
constexpr int WAVE_PER_SM = 4;            // blocks per SM of the tile walks

struct Seg {
  const int* ids;
  const float *gx, *gy, *gz;
  int lo, hi;  // this tile's items in the segment
};

// The segment and item range of sort tile b of the first pass (selects
// with compile-time indices only: no dynamic indexing of the arguments).
__device__ __forceinline__ Seg stream_tile(const FoldArgs& a, int b) {
  Seg g = {a.ids[0], a.gx[0], a.gy[0], a.gz[0], 0, a.len[0]};
  int first = 0;
#pragma unroll
  for (int q = 1; q < MAX_SEG; ++q) {
    if (q < a.nseg && b >= a.blk[q]) {
      g = Seg{a.ids[q], a.gx[q], a.gy[q], a.gz[q], 0, a.len[q]};
      first = a.blk[q];
    }
  }
  g.lo = (b - first) * TILE;
  g.hi = min(g.hi, g.lo + TILE);
  return g;
}

// Stream update k of a tile: packed, and whether a channel is not +-0.
__device__ __forceinline__ bool stream_item(const Seg& g, int k, int4* r) {
  if (k >= g.hi) return false;
  const float x = g.gx[k], y = g.gy[k], z = g.gz[k];
  *r = make_int4(g.ids[k], __float_as_int(x), __float_as_int(y),
                 __float_as_int(z));
  return x != 0.0f || y != 0.0f || z != 0.0f;  // NaN != 0
}

// The sum of x over the block, in a fixed order (every thread gets it).
__device__ __forceinline__ int block_sum(int x) {
  __shared__ int part[WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  if (lane == 0) part[w] = x;
  __syncthreads();
  int s = 0;
  for (int q = 0; q < WARPS; ++q) s += part[q];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(THREADS) fold_keep_counts(FoldArgs a) {
  const Seg g = stream_tile(a, blockIdx.x);
  int c = 0;
  for (int k = g.lo + threadIdx.x; k < g.hi; k += THREADS) {
    int4 r;
    c += stream_item(g, k, &r) ? 1 : 0;
  }
  c = block_sum(c);
  if (threadIdx.x == 0) a.tcount[blockIdx.x] = c;
}

__global__ void __launch_bounds__(THREADS) fold_compact(FoldArgs a, int nb) {
  __shared__ int wtot[WARPS];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const Seg g = stream_tile(a, b);
  int before = 0;
  for (int q = threadIdx.x; q < b; q += THREADS) before += a.tcount[q];
  before = block_sum(before);
  const int base = g.lo + warp * (TILE / WARPS);
  int cnt = 0;
  for (int st = 0; st < STEPS; ++st) {
    int4 r;
    cnt += __popc(__ballot_sync(FULL,
                                stream_item(g, base + st * 32 + lane, &r)));
  }
  if (lane == 0) wtot[warp] = cnt;
  __syncthreads();
  int pos = before, all = before;
  for (int q = 0; q < WARPS; ++q) {
    pos += q < warp ? wtot[q] : 0;
    all += wtot[q];
  }
  for (int st = 0; st < STEPS; ++st) {
    int4 r;
    const bool ok = stream_item(g, base + st * 32 + lane, &r);
    const unsigned bal = __ballot_sync(FULL, ok);
    if (ok) a.rec0[pos + __popc(bal & lt)] = r;
    pos += __popc(bal);
  }
  if (b == nb - 1 && threadIdx.x == 0) *a.count = all;
}

// sort tiles holding survivors
__device__ __forceinline__ int used_tiles(const FoldArgs& a) {
  return (*a.count + TILE - 1) / TILE;
}

__global__ void __launch_bounds__(THREADS)
fold_digit_counts(FoldArgs a, int shift, const int4* src) {
  __shared__ int h[BINS];
  const int used = used_tiles(a);
  for (int b = blockIdx.x; b < used; b += gridDim.x) {
    const int hi = min(*a.count, (b + 1) * TILE);
    for (int d = threadIdx.x; d < BINS; d += THREADS) h[d] = 0;
    __syncthreads();
    for (int k = b * TILE + threadIdx.x; k < hi; k += THREADS)
      atomicAdd(&h[(src[k].x >> shift) & (BINS - 1)], 1);
    __syncthreads();
    for (int d = threadIdx.x; d < BINS; d += THREADS)
      a.hist[d * used + b] = h[d];
    __syncthreads();
  }
}

// exclusive scan in place of hist[0 .. BINS * used), in (digit, tile)
// order, in one block: warp w takes a contiguous range in runs of 32
__global__ void __launch_bounds__(SCAN_THREADS) fold_count_scan(FoldArgs a) {
  constexpr int U = 8;  // loads in flight per lane
  __shared__ int wsum[SCAN_THREADS / 32];
  const int total = BINS * used_tiles(a);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int runs = (total + 31) / 32;
  const int per = 32 * ((runs + SCAN_THREADS / 32 - 1) / (SCAN_THREADS / 32));
  const int lo = min(total, w * per), hi = min(total, lo + per);
  int s = 0;
  for (int k0 = lo; k0 < hi; k0 += 32 * U) {
    int v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * 32 + lane;
      v[u] = k < hi ? a.hist[k] : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) s += v[u];
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

__global__ void __launch_bounds__(THREADS)
fold_scatter(FoldArgs a, int shift, const int4* src, int4* dst) {
  __shared__ int wh[WARPS][BINS];
  const int used = used_tiles(a), n = *a.count;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  for (int b = blockIdx.x; b < used; b += gridDim.x) {
    for (int e = threadIdx.x; e < WARPS * BINS; e += THREADS)
      (&wh[0][0])[e] = 0;
    __syncthreads();
    const int base = b * TILE + warp * (TILE / WARPS);
    // each warp counts its part of the tile, per digit
    for (int st = 0; st < STEPS; ++st) {
      const int k = base + st * 32 + lane;
      const bool ok = k < n;
      const int d = ok ? (src[k].x >> shift) & (BINS - 1) : -1;
      const unsigned peers = __match_any_sync(FULL, d);
      if (ok && (peers & lt) == 0) wh[warp][d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // where each warp's items of each digit start: the tile's offset, then
    // the warps before it
    for (int d = threadIdx.x; d < BINS; d += THREADS) {
      int run = a.hist[d * used + b];
      for (int w = 0; w < WARPS; ++w) {
        const int c = wh[w][d];
        wh[w][d] = run;
        run += c;
      }
    }
    __syncthreads();
    for (int st = 0; st < STEPS; ++st) {
      const int k = base + st * 32 + lane;
      const bool ok = k < n;
      int4 r = make_int4(0, 0, 0, 0);
      if (ok) r = src[k];
      const int d = ok ? (r.x >> shift) & (BINS - 1) : -1;
      const unsigned peers = __match_any_sync(FULL, d);
      int pos = 0;
      if (ok) pos = wh[warp][d] + __popc(peers & lt);
      __syncwarp();
      if (ok) {
        dst[pos] = r;
        if ((peers & lt) == 0) wh[warp][d] = pos + __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

// ---- the fold over the sorted survivors ---------------------------------

// x -> m ? x + t : u, per channel
struct Map {
  bool m;
  float tx, ty, tz, ux, uy, uz;
};

__device__ __forceinline__ Map identity() {
  return {true, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
}

// f then g (g after f)
__device__ __forceinline__ Map then(const Map& f, const Map& g) {
  if (!g.m) return g;
  return {f.m, f.tx + g.tx, f.ty + g.ty, f.tz + g.tz,
          f.ux + g.tx, f.uy + g.ty, f.uz + g.tz};
}

__device__ __forceinline__ Map shfl_up(const Map& f, int off) {
  return {__shfl_up_sync(FULL, (int)f.m, off) != 0,
          __shfl_up_sync(FULL, f.tx, off), __shfl_up_sync(FULL, f.ty, off),
          __shfl_up_sync(FULL, f.tz, off), __shfl_up_sync(FULL, f.ux, off),
          __shfl_up_sync(FULL, f.uy, off), __shfl_up_sync(FULL, f.uz, off)};
}

// the map of sorted update k: continue the run of update k-1 or start one
__device__ __forceinline__ Map item_map(const int4* srt, int k, int4 r) {
  const float x = __int_as_float(r.y), y = __int_as_float(r.z),
              z = __int_as_float(r.w);
  return {k > 0 && srt[k - 1].x == r.x, x, y, z, x, y, z};
}

__device__ __forceinline__ float3 apply(const Map& f, float3 x) {
  return f.m ? make_float3(x.x + f.tx, x.y + f.ty, x.z + f.tz)
             : make_float3(f.ux, f.uy, f.uz);
}

// The maps of the threads before this one in the block (each thread's map
// covers its PER consecutive items), and the block's whole map.
__device__ __forceinline__ Map block_exclusive(const Map& mine,
                                               Map* whole) {
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
  return lane == 0 ? pre : then(pre, exc);
}

// the buffer the last pass wrote (passes alternate rec0 -> rec1 -> rec0)
__device__ __forceinline__ const int4* sorted_of(const FoldArgs& a) {
  return (a.passes & 1) ? a.rec1 : a.rec0;
}

__global__ void __launch_bounds__(THREADS) fold_chunk_maps(FoldArgs a) {
  const int4* srt = sorted_of(a);
  const int n = *a.count;
  for (int c = blockIdx.x; c * CHUNK < n; c += gridDim.x) {
    const int k0 = c * CHUNK + threadIdx.x * PER;
    Map f = identity();
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int k = k0 + q;
      if (k < n) f = then(f, item_map(srt, k, srt[k]));
    }
    Map whole;
    block_exclusive(f, &whole);
    if (threadIdx.x == 0) {
      float* o = a.maps + (size_t)c * 8;
      o[0] = whole.m ? 1.0f : 0.0f;
      o[1] = whole.tx; o[2] = whole.ty; o[3] = whole.tz;
      o[4] = whole.ux; o[5] = whole.uy; o[6] = whole.uz;
    }
    __syncthreads();  // the next chunk rewrites block_exclusive's totals
  }
}

__device__ __forceinline__ Map load_map(const float* maps, int c) {
  const float* o = maps + (size_t)c * 8;
  return {o[0] > 0.5f, o[1], o[2], o[3], o[4], o[5], o[6]};
}

// carry[c] = the running run sum after chunks 0..c-1 (the chunks' maps
// composed in order and applied to 0), in one block
__global__ void __launch_bounds__(THREADS) fold_carries(FoldArgs a, int nf) {
  nf = min(nf, (*a.count + CHUNK - 1) / CHUNK);  // the chunks in use
  const int per = (nf + THREADS - 1) / THREADS;
  const int lo = min(nf, (int)threadIdx.x * per), hi = min(nf, lo + per);
  Map f = identity();
  for (int c = lo; c < hi; ++c) f = then(f, load_map(a.maps, c));
  Map whole;
  Map pre = block_exclusive(f, &whole);
  for (int c = lo; c < hi; ++c) {
    const float3 x = apply(pre, make_float3(0.0f, 0.0f, 0.0f));
    float* o = a.carry + (size_t)c * 4;
    o[0] = x.x; o[1] = x.y; o[2] = x.z;
    pre = then(pre, load_map(a.maps, c));
  }
}

__global__ void __launch_bounds__(THREADS) fold_runs(FoldArgs a) {
  const int4* srt = sorted_of(a);
  const int n = *a.count;
  for (int c = blockIdx.x; c * CHUNK < n; c += gridDim.x) {
    const int k0 = c * CHUNK + threadIdx.x * PER;
    int4 r[PER];
    Map f = identity();
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int k = k0 + q;
      if (k < n) {
        r[q] = srt[k];
        f = then(f, item_map(srt, k, r[q]));
      }
    }
    Map whole;
    const Map pre = block_exclusive(f, &whole);
    const float* cy = a.carry + (size_t)c * 4;
    float3 x = apply(pre, make_float3(cy[0], cy[1], cy[2]));
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int k = k0 + q;
      if (k >= n) break;
      x = apply(item_map(srt, k, r[q]), x);
      if (k == n - 1 || srt[k + 1].x != r[q].x) {  // the run's last update
        const size_t t = 3 * (size_t)r[q].x;
        a.out[t] = a.data[t] + x.x;
        a.out[t + 1] = a.data[t + 1] + x.y;
        a.out[t + 2] = a.data[t + 2] + x.z;
      }
    }
    __syncthreads();  // the next chunk rewrites block_exclusive's totals
  }
}

}  // namespace

extern "C" int tt_sorted_fold(const FoldArgs* args, void* stream) {
  const FoldArgs a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(a.out, a.data, sizeof(float) * 3 *
                                    (size_t)a.p, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess || a.m == 0) return (int)err;
  const int nb = a.blk[a.nseg];
  fold_keep_counts<<<nb, THREADS, 0, s>>>(a);
  fold_compact<<<nb, THREADS, 0, s>>>(a, nb);
  // the sort and fold kernels walk the tiles in use (the survivor count
  // is on the device) with at most WAVE_PER_SM blocks per SM
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int wave = WAVE_PER_SM * (sms > 0 ? sms : 1);
  const int nt = (a.m + TILE - 1) / TILE, nf = (a.m + CHUNK - 1) / CHUNK;
  const int tiles = nt < wave ? nt : wave, chunks = nf < wave ? nf : wave;
  for (int pass = 0; pass < a.passes; ++pass) {
    const int4* src = (pass & 1) ? a.rec1 : a.rec0;
    int4* dst = (pass & 1) ? a.rec0 : a.rec1;
    fold_digit_counts<<<tiles, THREADS, 0, s>>>(a, 8 * pass, src);
    fold_count_scan<<<1, SCAN_THREADS, 0, s>>>(a);
    fold_scatter<<<tiles, THREADS, 0, s>>>(a, 8 * pass, src, dst);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fold_chunk_maps<<<chunks, THREADS, 0, s>>>(a);
  fold_carries<<<1, THREADS, 0, s>>>(a, nf);
  fold_runs<<<chunks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
