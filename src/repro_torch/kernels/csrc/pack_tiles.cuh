// The gather-form pack tile, shared by fused_sort_pack (fused_round.cu)
// and pack (pack.cu).
//
// For every output position p of a window, binary-search the last
// offset <= p + base in the row's offset-sorted requests and, from that
// single search, write the gathered payload and (when a mask buffer is
// given) the coverage mask: 1 where covered, else 0, in the payload's
// type, exactly as the TPU kernels' tile body (pack.py::_pack_tile)
// does. One CTA per (tile of kTile positions, row); each thread searches
// the row's metadata through the read-only cache. Row bases are 64-bit:
// rows x out_len reaches 2^28 and the payload 2^31 elements.
//
// What bounds it: device-memory traffic (one payload read and one or two
// window writes per position) is the floor; the search adds log2(cap)
// dependent L2 loads per position, so the kernel is latency-bound above
// that floor. Walking the sorted list once per tile instead of searching
// per position is later work.
#pragma once

#include <cstring>

#include "common.cuh"

namespace {

template <typename T>
__global__ void pack_tiles_kernel(const int* __restrict__ s_off,
                                  const int* __restrict__ s_len,
                                  const int* __restrict__ s_st,
                                  const T* __restrict__ data,
                                  const int* __restrict__ base, T* win,
                                  T* mask, int cap, long long dcap,
                                  long long out_len, T one) {
  const long long row = blockIdx.y;
  const int* off = s_off + row * cap;
  const int* len = s_len + row * cap;
  const int* st = s_st + row * cap;
  const T* d = data + row * dcap;
  T* w = win + row * out_len;
  T* m = mask == nullptr ? nullptr : mask + row * out_len;
  const int b = base[row];
  const long long tile0 = static_cast<long long>(blockIdx.x) * repro::kTile;
  for (int i = threadIdx.x; i < repro::kTile; i += blockDim.x) {
    const long long pos = tile0 + i;
    // the TPU computes iota + tile_start + base in int32
    const int p = static_cast<int>(static_cast<unsigned>(pos) +
                                   static_cast<unsigned>(b));
    int lo = 0, hi = cap;            // first index with off > p
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(off + mid) <= p) lo = mid + 1; else hi = mid;
    }
    const int r = lo - 1;            // last offset <= p, -1 if none
    T v = T(0), c = T(0);
    if (r >= 0) {
      const int within = p - __ldg(off + r);
      if (within < __ldg(len + r)) {
        long long src = static_cast<long long>(__ldg(st + r)) + within;
        src = src < 0 ? 0 : (src >= dcap ? dcap - 1 : src);
        v = d[src];
        c = one;
      }
    }
    w[pos] = v;
    if (m != nullptr) m[pos] = c;
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
  pack_tiles_kernel<T><<<grid, 256, 0, stream>>>(
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
