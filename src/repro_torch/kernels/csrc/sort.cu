// bitonic_sort for Hopper: replaces kernels/sort.py::bitonic_sort (the
// Pallas grid over rows, one VMEM bitonic network per row) with block
// sorts and merges that spread every row over many CTAs.
//
// Design, bound and what the design does about it: see bitonic.cuh.
#include "bitonic.cuh"

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// offsets/lengths/carry: int32 [b, n], n a power of two <= 32768. Writes
// the three rows sorted by offset (stable) into the out_* buffers; words:
// min(passes, 2) * b * n uint64 of scratch (bitonic.cuh).
extern "C" int repro_bitonic_sort(const int* offsets, const int* lengths,
                                  const int* carry, int* out_offsets,
                                  int* out_lengths, int* out_carry,
                                  unsigned long long* words, int b, int n,
                                  void* stream) {
  cudaError_t err = launch_sort_rows(offsets, lengths, carry, out_offsets,
                                     out_lengths, out_carry, words, b, n,
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
