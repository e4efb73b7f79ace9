// route_spans for Hopper: the round engine's element routing
// (core/exchange.py: repack_sorted, and bucket_by_dest's payload step).
//
// It replaces no TPU kernel. The reference routes payload elements with
// jnp (a searchsorted of every slot, gathers, a scatter), which XLA fuses;
// in PyTorch the same walk takes one pass of int64 indices over every
// padded slot for each of those steps. Both callers know, per request, the
// whole span it moves: where it lands in the output row, how long it is
// and where its payload starts. So each row arrives as a list of spans
// (int32 out offset, length, source start) sorted by out offset and
// disjoint, and
//   out[p] = data[clamp(src[r] + p - off[r], 0, dcap - 1)]
// where r is the last span with off[r] <= p and p - off[r] < len[r],
// else 0. That is the gather-form tile walk of pack_tiles.cuh (its
// device functions, tile_walk.cuh) at base 0 with no mask: one CTA per
// (tile of 4096 positions, row), two warp searches, the heads of the
// spans that start inside the tile, a max-scan. Positions are int32 (out_len <
// 2^31); the last tile of a row is ragged and writes only its own
// positions, so the caller gets [b, out_len] with no padded copy. A tile
// that no span reaches (the run is empty and the carry-in ends before the
// tile) writes zeros and reads nothing: most tiles of a bucket row are
// such, since each destination's payload fills only the front of its
// data_cap.
//
// What bounds it: device memory, one payload read per covered position
// and one write per output position.
#include <algorithm>

#include "tile_walk.cuh"

namespace {

constexpr long long kMaxGridRows = 65535;   // grid y

template <typename T>
__global__ void __launch_bounds__(kPackThreads)
route_spans_kernel(const int* __restrict__ s_off,
                   const int* __restrict__ s_len,
                   const int* __restrict__ s_src, const T* __restrict__ data,
                   T* out, int cap, long long dcap, long long out_len) {
  __shared__ int s_r[repro::kTile + repro::kTile / 32];  // heads, then r
  __shared__ int s_warp[kPackThreads / 32];
  __shared__ int s_cut[2];
  const long long row = blockIdx.y;
  const int* off = s_off + row * cap;
  const int* len = s_len + row * cap;
  const int* src = s_src + row * cap;
  const T* d = data + row * dcap;
  const long long tile0 = static_cast<long long>(blockIdx.x) * repro::kTile;
  T* w = out + row * out_len + tile0;
  const long long left = out_len - tile0;
  const int n = left < repro::kTile ? static_cast<int>(left) : repro::kTile;
  const int p_first = static_cast<int>(tile0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // 1. the carry-in and the end of the tile's run (its last position)
  if (warp < 2) {
    const int q = warp == 0 ? p_first : p_first + (n - 1);
    const int c = count_le(off, cap, q, lane);
    if (lane == 0) s_cut[warp] = c - 1;
  }
  for (int i = threadIdx.x; i < repro::kTile; i += kPackThreads)
    s_r[tile_slot(i)] = -1;
  __syncthreads();
  const int r0 = s_cut[0];
  const int r_end = s_cut[1];

  if (r0 == r_end &&
      (r0 < 0 || p_first - __ldg(off + r0) >= __ldg(len + r0))) {
    for (int i = threadIdx.x; i < n; i += kPackThreads) w[i] = T(0);
    return;   // no span reaches this tile
  }

  tile_requests(off, r0, r_end, p_first, s_r, s_warp, lane, warp);

  // 4. the row, neighbouring threads on neighbouring positions
#pragma unroll   // all 16 gathers in flight at once
  for (int k = 0; k < kPackItems; ++k) {
    const int i = k * kPackThreads + threadIdx.x;
    if (i < n) {
      T v, c;
      pack_one(off, len, src, d, dcap, p_first + i, s_r[tile_slot(i)], T(0),
               v, c);
      w[i] = v;
    }
  }
}

template <typename T>
cudaError_t launch_route(const int* off, const int* len, const int* src,
                         const void* data, void* out, long long b, int cap,
                         long long dcap, long long out_len,
                         cudaStream_t stream) {
  const unsigned tiles =
      static_cast<unsigned>((out_len + repro::kTile - 1) / repro::kTile);
  for (long long r = 0; r < b; r += kMaxGridRows) {
    const long long rows = std::min(b - r, kMaxGridRows);
    const dim3 grid(tiles, static_cast<unsigned>(rows));
    route_spans_kernel<T><<<grid, kPackThreads, 0, stream>>>(
        off + r * cap, len + r * cap, src + r * cap,
        static_cast<const T*>(data) + r * dcap, static_cast<T*>(out) +
        r * out_len, cap, dcap, out_len);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// offsets/lengths/sources: int32 [b, cap], each row's spans sorted by
// offset and disjoint, offsets in [0, out_len], lengths >= 0; data
// [b, dcap] of elem_bytes-wide elements (1, 2, 4 or 8), dcap > 0; out
// [b, out_len], 0 <= out_len < 2^31, every position written.
extern "C" int repro_route_spans(const int* offsets, const int* lengths,
                                 const int* sources, const void* data,
                                 void* out, int b, int cap, long long dcap,
                                 long long out_len, int elem_bytes,
                                 void* stream) {
  if (b == 0 || out_len == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (elem_bytes) {
    case 1:
      err = launch_route<uint8_t>(offsets, lengths, sources, data, out, b,
                                  cap, dcap, out_len, s);
      break;
    case 2:
      err = launch_route<uint16_t>(offsets, lengths, sources, data, out, b,
                                   cap, dcap, out_len, s);
      break;
    case 4:
      err = launch_route<uint32_t>(offsets, lengths, sources, data, out, b,
                                   cap, dcap, out_len, s);
      break;
    case 8:
      err = launch_route<uint64_t>(offsets, lengths, sources, data, out, b,
                                   cap, dcap, out_len, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
