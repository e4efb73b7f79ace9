// The gather-form pack tile, shared by fused_sort_pack (fused_round.cu)
// and pack (pack.cu); its device functions are in tile_walk.cuh, which
// route_spans (route_spans.cu) walks its tiles with too.
//
// Output position p of a window (p = position + base in int32, as the TPU
// computes iota + tile_start + base) takes r, the last request of the
// row's offset-sorted list with offset <= p, and from it the gathered
// payload and (when a mask buffer is given) the coverage mask: 1 where
// p - off[r] < len[r], else 0, in the payload's type, exactly as the TPU
// kernels' tile body (pack.py::_pack_tile) does. Only r decides coverage,
// not an earlier, longer request; zero-length requests and PAD_OFFSET
// padding take part like any other.
//
// One CTA per (tile of kTile positions, row) walks the sorted list once
// for its tile, in place of one binary search per position:
// 1. the carry-in: warps 0 and 1 find, by 32-ary searches in device
//    memory (3 rounds of one load a lane at cap 32768), r0 = the last
//    request with offset <= p_first and r_end = the last with offset <=
//    p_first + kTile - 1;
// 2. heads: each request of the run (r0, r_end], whose offsets fall inside
//    the tile, writes its index at head[off - p_first] in shared memory;
//    among equal offsets only the last (in the sort's stable order) writes;
// 3. an inclusive max-scan over the tile's heads, seeded with r0, gives
//    every position its r (16 positions a thread, a warp scan of the
//    threads' maxima, one over the warps);
// 4. each position p computes within = p - off[r] and covered = within <
//    len[r], gathers data[start[r] + within] (neighbouring positions of a
//    request read neighbouring elements) and writes the window and the
//    mask, neighbouring threads on neighbouring positions.
// A tile whose p range wraps past 2^31 - 1 is not monotonic in p; there
// each position searches the list on its own, as the TPU does.
//
// Row bases are 64-bit: rows x out_len reaches 2^28 and the payload 2^31
// elements.
//
// What bounds it: device memory, one payload read per covered position and
// one or two window writes per position; the walk adds two searches and
// the row's requests once per tile.
#pragma once

#include <climits>
#include <cstring>

#include "tile_walk.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kPackThreads)
pack_tiles_kernel(const int* __restrict__ s_off,
                  const int* __restrict__ s_len,
                  const int* __restrict__ s_st, const T* __restrict__ data,
                  const int* __restrict__ base, T* win, T* mask, int cap,
                  long long dcap, long long out_len, T one) {
  __shared__ int s_r[repro::kTile + repro::kTile / 32];  // heads, then r
  __shared__ int s_warp[kPackThreads / 32];
  __shared__ int s_cut[2];
  const long long row = blockIdx.y;
  const int* off = s_off + row * cap;
  const int* len = s_len + row * cap;
  const int* st = s_st + row * cap;
  const T* d = data + row * dcap;
  T* w = win + row * out_len + static_cast<long long>(blockIdx.x) *
                                   repro::kTile;
  T* m = mask == nullptr
             ? nullptr
             : mask + row * out_len +
                   static_cast<long long>(blockIdx.x) * repro::kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p_first = static_cast<int>(
      static_cast<unsigned>(static_cast<long long>(blockIdx.x) *
                            repro::kTile) +
      static_cast<unsigned>(base[row]));

  if (p_first > INT_MAX - (repro::kTile - 1)) {   // p wraps in this tile
    for (int i = threadIdx.x; i < repro::kTile; i += kPackThreads) {
      const int p = static_cast<int>(static_cast<unsigned>(p_first) + i);
      int lo = 0, hi = cap;   // first index with off > p
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(off + mid) <= p) lo = mid + 1; else hi = mid;
      }
      T v, c;
      pack_one(off, len, st, d, dcap, p, lo - 1, one, v, c);
      w[i] = v;
      if (m != nullptr) m[i] = c;
    }
    return;
  }

  // 1. the carry-in and the end of the tile's run
  if (warp < 2) {
    const int q = warp == 0 ? p_first : p_first + (repro::kTile - 1);
    const int c = count_le(off, cap, q, lane);
    if (lane == 0) s_cut[warp] = c - 1;
  }
  for (int i = threadIdx.x; i < repro::kTile; i += kPackThreads)
    s_r[tile_slot(i)] = -1;
  __syncthreads();
  const int r0 = s_cut[0];
  const int r_end = s_cut[1];

  tile_requests(off, r0, r_end, p_first, s_r, s_warp, lane, warp);

  // 4. the window and the mask, neighbouring threads on neighbouring
  //    positions
#pragma unroll   // all 16 gathers in flight at once
  for (int k = 0; k < kPackItems; ++k) {
    const int i = k * kPackThreads + threadIdx.x;
    T v, c;
    pack_one(off, len, st, d, dcap, p_first + i, s_r[tile_slot(i)], one, v,
             c);
    w[i] = v;
    if (m != nullptr) m[i] = c;
  }
}

template <typename T>
cudaError_t launch_pack(const int* s_off, const int* s_len, const int* s_st,
                        const void* data, const int* base, void* win,
                        void* mask, int b, int cap, long long dcap,
                        long long out_len, unsigned long long one_bits,
                        cudaStream_t stream) {
  T one;
  memcpy(&one, &one_bits, sizeof(T));   // little-endian low bytes
  const dim3 grid(static_cast<unsigned>(out_len / repro::kTile),
                  static_cast<unsigned>(b));
  pack_tiles_kernel<T><<<grid, kPackThreads, 0, stream>>>(
      s_off, s_len, s_st, static_cast<const T*>(data), base,
      static_cast<T*>(win), static_cast<T*>(mask), cap, dcap, out_len, one);
  return cudaGetLastError();
}

// launch_pack for a payload of elem_bytes-wide elements (1, 2, 4 or 8);
// mask may be null (no mask is written).
inline cudaError_t launch_pack_elems(const int* s_off, const int* s_len,
                                     const int* s_st, const void* data,
                                     const int* base, void* win, void* mask,
                                     int b, int cap, long long dcap,
                                     long long out_len, int elem_bytes,
                                     unsigned long long one_bits,
                                     cudaStream_t stream) {
  switch (elem_bytes) {
    case 1:
      return launch_pack<uint8_t>(s_off, s_len, s_st, data, base, win, mask,
                                  b, cap, dcap, out_len, one_bits, stream);
    case 2:
      return launch_pack<uint16_t>(s_off, s_len, s_st, data, base, win, mask,
                                   b, cap, dcap, out_len, one_bits, stream);
    case 4:
      return launch_pack<uint32_t>(s_off, s_len, s_st, data, base, win, mask,
                                   b, cap, dcap, out_len, one_bits, stream);
    case 8:
      return launch_pack<uint64_t>(s_off, s_len, s_st, data, base, win, mask,
                                   b, cap, dcap, out_len, one_bits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
