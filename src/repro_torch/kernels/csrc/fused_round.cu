// fused_sort_pack for Hopper: replaces kernels/fused_round.py::
// fused_sort_pack (one pallas_call: a bitonic sort under
// pl.when(program_id == 0), then one output tile per grid step).
//
// Per row (one drain window), it sorts the unsorted merged request list
// by offset, then writes every output position's gathered payload and
// coverage mask (1 where covered, else 0, in the payload's type) from the
// last request with offset <= p + base, exactly as the TPU kernel's tile
// body does.
//
// Design: the TPU kernel sorts once and keeps the sorted metadata in
// VMEM scratch across its sequential grid. CUDA blocks run concurrently
// and in no order, so that does not carry over: the call is the sort's
// launches (bitonic.cuh: block sorts and merges over many CTAs a row;
// offsets, carrying lengths and starts) into scratch the wrapper
// allocates, then a tile kernel over grid (out_len / TILE, rows), on one
// stream. Each tile walks the row's sorted list once (pack_tiles.cuh: two
// searches for the tile's run of requests, their heads in shared memory,
// a max-scan that gives each position its request). Row bases are 64-bit:
// rows x out_len reaches 2^28 and the payload 2^31 elements.
//
// What bounds it: at deployment size the tile kernel's device-memory
// traffic (one payload read per covered position and two window writes
// per position) is the floor; the sort adds its own launches before it.
#include "bitonic.cuh"
#include "pack_tiles.cuh"

// offsets/lengths/starts: int32 [b, cap] (unsorted, PAD_OFFSET/0 pad),
// cap a power of two <= 32768; data [b, dcap] of elem_bytes-wide
// elements; base int32 [b]; sorted_*: int32 [b, cap] scratch; words: the
// sort's uint64 scratch (min(passes, 2) * b * cap, bitonic.cuh); win/mask
// [b, out_len], out_len a multiple of 4096; one_bits: the bytes of 1 in
// the payload type. b <= 65535 (grid y).
extern "C" int repro_fused_sort_pack(const int* offsets, const int* lengths,
                                     const int* starts, const void* data,
                                     const int* base, int* sorted_offsets,
                                     int* sorted_lengths, int* sorted_starts,
                                     unsigned long long* words, void* win,
                                     void* mask, int b, int cap,
                                     long long dcap, long long out_len,
                                     int elem_bytes,
                                     unsigned long long one_bits,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_sort_rows(offsets, lengths, starts, sorted_offsets,
                                     sorted_lengths, sorted_starts, words, b,
                                     cap, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || out_len == 0) return static_cast<int>(cudaGetLastError());
  err = launch_pack_elems(sorted_offsets, sorted_lengths, sorted_starts,
                          data, base, win, mask, b, cap, dcap, out_len,
                          elem_bytes, one_bits, s);
  return static_cast<int>(err);
}
