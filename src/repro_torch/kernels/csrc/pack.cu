// pack for Hopper: replaces kernels/pack.py::pack (one pallas_call, one
// output tile of 4096 positions per grid step, each position
// binary-searching the VMEM-resident sorted offsets).
//
// The requests arrive offset-sorted and non-overlapping, so this is the
// tile kernel of fused_sort_pack (pack_tiles.cuh) with no sort launch
// and no mask: one launch over out_len / 4096 tiles of one row, each
// tile walking the sorted list once (two searches, heads, a max-scan).
//
// What bounds it: one payload read per covered position and one window
// write per position in device memory.
#include "pack_tiles.cuh"

// offsets/lengths/starts: int32 [cap], offset-sorted, non-overlapping,
// PAD_OFFSET/0 padding at the tail; data [dcap] of elem_bytes-wide
// elements; base: int32 [1] on the device; out [out_len], out_len a
// multiple of 4096.
extern "C" int repro_pack(const int* offsets, const int* lengths,
                          const int* starts, const void* data,
                          const int* base, void* out, int cap,
                          long long dcap, long long out_len, int elem_bytes,
                          void* stream) {
  if (out_len == 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch_pack_elems(
      offsets, lengths, starts, data, base, out, nullptr, 1, cap, dcap,
      out_len, elem_bytes, 0, static_cast<cudaStream_t>(stream)));
}
