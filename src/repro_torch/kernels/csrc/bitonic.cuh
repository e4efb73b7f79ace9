// Batched bitonic sort of request rows in shared memory, one CTA per row.
//
// Replaces the VMEM bitonic network of kernels/sort.py (_bitonic_sort_body)
// that both bitonic_sort and fused_sort_pack run on the TPU.
//
// The TPU keeps key + two int32 carries (3 x 32768 x 4 B = 384 KiB) in
// VMEM; a Hopper block has at most 227 KB of shared memory. So the
// network sorts (key int32, original slot uint16) pairs only, 6 B per
// entry (192 KiB at n = 32768), and the carries are gathered from global
// memory by slot once the keys are in order. Ties break by slot, which
// makes the network equal a stable sort exactly.
//
// What bounds it: log2(n) (log2(n) + 1) / 2 compare-exchange sweeps,
// each a block-wide barrier over shared memory (120 sweeps at
// n = 32768), so shared-memory bandwidth and barrier latency, not device
// memory (each row is read once and written once). One CTA per row
// leaves SMs idle when the batch is small (16 rows at deployment size).
#pragma once

#include "common.cuh"

namespace {

__device__ __forceinline__ void bitonic_sort_shared(int* key, uint16_t* slot,
                                                    int n) {
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));   // lower index of the pair
        const int p = i + j;
        const int ki = key[i], kp = key[p];
        const uint16_t si = slot[i], sp = slot[p];
        const bool greater = (ki > kp) || (ki == kp && si > sp);
        const bool ascending = (i & k) == 0;
        if (greater == ascending) {
          key[i] = kp;
          key[p] = ki;
          slot[i] = sp;
          slot[p] = si;
        }
      }
      __syncthreads();
    }
  }
}

// Sort each row of `off` [b, n] ascending (ties by position) and carry
// c0, c1 along. n is a power of two <= kMaxBlock; dynamic shared memory
// is 6 * n bytes.
__global__ void sort_rows_kernel(const int* __restrict__ off,
                                 const int* __restrict__ c0,
                                 const int* __restrict__ c1,
                                 int* __restrict__ out_off,
                                 int* __restrict__ out_c0,
                                 int* __restrict__ out_c1, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* key = reinterpret_cast<int*>(smem);
  uint16_t* slot = reinterpret_cast<uint16_t*>(key + n);
  const long long row = static_cast<long long>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    key[i] = off[row + i];
    slot[i] = static_cast<uint16_t>(i);
  }
  __syncthreads();
  bitonic_sort_shared(key, slot, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s = slot[i];
    out_off[row + i] = key[i];
    out_c0[row + i] = c0[row + s];
    out_c1[row + i] = c1[row + s];
  }
}

// Launch sort_rows_kernel over b rows on `stream`.
inline cudaError_t launch_sort_rows(const int* off, const int* c0,
                                    const int* c1, int* out_off, int* out_c0,
                                    int* out_c1, int b, int n,
                                    cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n) * (sizeof(int) + sizeof(uint16_t));
  cudaError_t err = cudaFuncSetAttribute(
      sort_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(repro::kMaxBlock * (sizeof(int) + sizeof(uint16_t))));
  if (err != cudaSuccess) return err;
  if (b == 0) return cudaSuccess;
  sort_rows_kernel<<<b, repro::row_threads(n / 2 > 0 ? n / 2 : 1), smem,
                     stream>>>(off, c0, c1, out_off, out_c0, out_c1, n);
  return cudaGetLastError();
}

}  // namespace
