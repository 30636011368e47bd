// Persistent lane tiles with in-block compaction, shared by the first-hit
// kernel (B1, first_hits.cu) and the shade+scatter kernel (B2,
// shade_scatter.cu), and the number of persistent blocks they launch.
//
// A bounce's live lanes thin out (Cornell's last bounce: 15% live) and lie
// scattered over the ray batch, so with one thread per lane nearly every
// warp held a live lane and ran the whole chain. Here a block walks tiles
// of TILE lanes (blockIdx, blockIdx + grid, ...); in each tile it ballots
// the lanes' flags and lists the flagged lanes in lane order in shared
// memory, and its threads then take that list, so a warp runs 32 live
// lanes. B3 (bounce_bwd.cu) lists its active lanes the same way. A tile is
// kRounds x 256 lanes: larger tiles fill more warps on a sparse bounce,
// but each thread then takes up to kRounds lanes one after another, so
// fewer lanes are in flight on a dense one (B1 takes 1 round, B2 2).
#pragma once
#include <cuda_runtime.h>

namespace tt {

constexpr int LANE_THREADS = 256;  // threads per block
constexpr int LANE_WARPS = LANE_THREADS / 32;
constexpr int TILE_COUNTS = 33;    // the (round, warp) counts and the total

// List the lanes i of the tile [t0, t0 + nv) (nv <= kRounds x 256) whose
// flag(i) is true, in lane order, into list[0 .. count) and return the
// count; dead(i) is called on each lane of the tile whose flag is false.
// All threads of the block call it together; list and counts (TILE_COUNTS
// ints) are shared, and the caller synchronises before the next call
// rewrites them.
template <int kRounds, typename Flag, typename Dead>
__device__ __forceinline__ int list_tile(int t0, int nv, int* list,
                                         int* counts, Flag flag, Dead dead) {
  constexpr int kCounts = kRounds * LANE_WARPS;
  static_assert(kCounts <= 32, "one warp scans the counts");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bool on[kRounds];
  unsigned bal[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = r * LANE_THREADS + tid;
    on[r] = k < nv && flag(t0 + k);
    if (k < nv && !on[r]) dead(t0 + k);
    bal[r] = __ballot_sync(0xffffffffu, on[r]);
    if (lane == 0) counts[r * LANE_WARPS + warp] = __popc(bal[r]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the (round, warp) counts
    const int c = lane < kCounts ? counts[lane] : 0;
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane < kCounts) counts[lane] = incl - c;
    if (lane == 31) counts[32] = incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    if (on[r])
      list[counts[r * LANE_WARPS + warp] + __popc(bal[r] & below)] =
          t0 + r * LANE_THREADS + tid;
  __syncthreads();
  return counts[32];
}

// The persistent blocks for n lanes in tiles of `tile`: at most one wave
// (`wave`, from tt::fit_shared), each block walking as many tiles.
inline int lane_blocks(int wave, int n, int tile) {
  const int tiles = (n + tile - 1) / tile;
  const int per = (tiles + wave - 1) / wave;
  return per > 0 ? (tiles + per - 1) / per : 1;
}

}  // namespace tt
