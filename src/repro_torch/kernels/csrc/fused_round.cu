// fused_sort_pack for Hopper: replaces kernels/fused_round.py::
// fused_sort_pack (one pallas_call: a bitonic sort under
// pl.when(program_id == 0), then one output tile per grid step).
//
// Per row (one drain window), it sorts the unsorted merged request list
// by offset, then for every output position p binary-searches the last
// offset <= p + base and, from that single search, writes both the
// gathered payload and the coverage mask (1 where covered, else 0, in
// the payload's type), exactly as the TPU kernel's tile body does.
//
// Design: the TPU kernel sorts once and keeps the sorted metadata in
// VMEM scratch across its sequential grid. CUDA blocks run concurrently
// and in no order, so that does not carry over: the call is two
// launches on one stream. Launch 1 is the shared-memory bitonic sort of
// bitonic.cuh (offsets, carrying lengths and starts) into scratch the
// wrapper allocates. Launch 2 is a tile kernel over grid (out_len /
// TILE, rows): each thread binary-searches its row's sorted offsets
// (read through the read-only cache; the metadata of a row is at most
// 384 KiB and stays in L2) once per output position. Row bases are
// 64-bit: rows x out_len reaches 2^28 and the payload 2^31 elements.
//
// What bounds it: at deployment size the tile kernel's device-memory
// traffic (one payload read and two window writes per position) is
// the floor; the search adds log2(cap) dependent L2 loads per position,
// so the kernel is latency-bound above that floor. Walking the sorted
// list once per tile instead of searching per position is later work.
#include <cstring>

#include "bitonic.cuh"

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
  T* m = mask + row * out_len;
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
    m[pos] = c;
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

}  // namespace

// offsets/lengths/starts: int32 [b, cap] (unsorted, PAD_OFFSET/0 pad),
// cap a power of two <= 32768; data [b, dcap] of elem_bytes-wide
// elements; base int32 [b]; sorted_*: int32 [b, cap] scratch; win/mask
// [b, out_len], out_len a multiple of 4096; one_bits: the bytes of 1 in
// the payload type. b <= 65535 (grid y).
extern "C" int repro_fused_sort_pack(const int* offsets, const int* lengths,
                                     const int* starts, const void* data,
                                     const int* base, int* sorted_offsets,
                                     int* sorted_lengths, int* sorted_starts,
                                     void* win, void* mask, int b, int cap,
                                     long long dcap, long long out_len,
                                     int elem_bytes,
                                     unsigned long long one_bits,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_sort_rows(offsets, lengths, starts, sorted_offsets,
                                     sorted_lengths, sorted_starts, b, cap, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || out_len == 0) return static_cast<int>(cudaGetLastError());
  switch (elem_bytes) {
    case 1:
      err = launch_pack<uint8_t>(sorted_offsets, sorted_lengths, sorted_starts,
                                 data, base, win, mask, b, cap, dcap, out_len,
                                 one_bits, s);
      break;
    case 2:
      err = launch_pack<uint16_t>(sorted_offsets, sorted_lengths,
                                  sorted_starts, data, base, win, mask, b,
                                  cap, dcap, out_len, one_bits, s);
      break;
    case 4:
      err = launch_pack<uint32_t>(sorted_offsets, sorted_lengths,
                                  sorted_starts, data, base, win, mask, b,
                                  cap, dcap, out_len, one_bits, s);
      break;
    case 8:
      err = launch_pack<uint64_t>(sorted_offsets, sorted_lengths,
                                  sorted_starts, data, base, win, mask, b,
                                  cap, dcap, out_len, one_bits, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
