// The device functions of the gather-form tile walk (pack_tiles.cuh says
// how the walk goes): the tile's shared-memory layout, the warp search of
// a sorted offset list, the heads and max-scan that give each position of
// a tile its request, and the element a position takes from it. Shared by
// pack_tiles_kernel (fused_sort_pack, pack) and route_spans_kernel
// (route_spans.cu).
#pragma once

#include "common.cuh"

namespace {

constexpr int kPackThreads = 256;
constexpr int kPackItems = repro::kTile / kPackThreads;   // 16 a thread

// Shared-memory index of tile position i, one pad word every 32, so that
// a thread's 16 consecutive positions and a warp's 32 consecutive ones
// both fall on distinct banks.
__device__ __forceinline__ int tile_slot(int i) { return i + (i >> 5); }

// The number of off[0, cap) (sorted) that are <= q, found by the calling
// warp: each round each lane tests one cut, a ballot keeps the range
// between the last cut still <= q and the first that is not.
__device__ __forceinline__ int count_le(const int* __restrict__ off,
                                        int cap, int q, int lane) {
  int lo = 0, hi = cap;   // the count lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const bool le = i < hi && __ldg(off + i) <= q;
    const int c = __popc(__ballot_sync(0xffffffffu, le));
    if (c == 0) {
      hi = lo;
    } else {
      const int next_hi = lo + c * step;
      lo += (c - 1) * step + 1;
      hi = next_hi < hi ? next_hi : hi;
    }
  }
  return lo;
}

// The window (and mask) element of position p from request r.
template <typename T>
__device__ __forceinline__ void pack_one(const int* __restrict__ off,
                                         const int* __restrict__ len,
                                         const int* __restrict__ st,
                                         const T* __restrict__ d,
                                         long long dcap, int p, int r, T one,
                                         T& v, T& c) {
  v = T(0);
  c = T(0);
  if (r >= 0) {
    // int32 as on the TPU: p - off[r] wraps
    const int within = static_cast<int>(
        static_cast<unsigned>(p) - static_cast<unsigned>(__ldg(off + r)));
    if (within < __ldg(len + r)) {
      long long src = static_cast<long long>(__ldg(st + r)) + within;
      src = src < 0 ? 0 : (src >= dcap ? dcap - 1 : src);
      v = d[src];
      c = one;
    }
  }
}

// Steps 2 and 3 of the walk, for the tile that starts at p_first: the
// heads of the run (r0, r_end] into s_r (every slot -1 before the call,
// and a __syncthreads() since), then the max-scan seeded with r0, which
// leaves each tile position's request in s_r. Called by every thread of
// the CTA; ends in a __syncthreads().
__device__ __forceinline__ void tile_requests(const int* __restrict__ off,
                                              int r0, int r_end,
                                              int p_first, int* s_r,
                                              int* s_warp, int lane,
                                              int warp) {
  // 2. heads: the last request of each offset inside the tile
  for (int i = r0 + 1 + threadIdx.x; i <= r_end; i += kPackThreads) {
    const int o = __ldg(off + i);
    if (i == r_end || __ldg(off + i + 1) != o)
      s_r[tile_slot(o - p_first)] = i;
  }
  __syncthreads();

  // 3. inclusive max-scan seeded with r0
  int h[kPackItems];
  int run = r0;
#pragma unroll
  for (int k = 0; k < kPackItems; ++k) {
    const int x = s_r[tile_slot(threadIdx.x * kPackItems + k)];
    run = x > run ? x : run;
    h[k] = run;
  }
  int x = run;
#pragma unroll
  for (int dd = 1; dd < 32; dd <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, dd);
    if (lane >= dd && y > x) x = y;
  }
  if (lane == 31) s_warp[warp] = x;
  int before = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) before = r0;
  __syncthreads();
  for (int k = 0; k < warp; ++k) before = s_warp[k] > before ? s_warp[k]
                                                             : before;
#pragma unroll
  for (int k = 0; k < kPackItems; ++k)
    s_r[tile_slot(threadIdx.x * kPackItems + k)] = h[k] > before ? h[k]
                                                              : before;
  __syncthreads();
}

}  // namespace
