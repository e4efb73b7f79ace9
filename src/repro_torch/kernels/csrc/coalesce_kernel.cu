// coalesce for Hopper: replaces kernels/coalesce_kernel.py::coalesce (the
// Pallas grid over rows; per row Hillis-Steele prefix sums over a VMEM
// block, then scatters of run heads and run ends).
//
// Per offset-sorted row it merges every run with off[i] + len[i] ==
// off[i+1] and compacts the runs to the front: (run offset, run length)
// pairs, PAD_OFFSET / 0 behind them, and the run count. It computes what
// the TPU kernel computes, including its handling of padding: a pad
// entry is a run boundary, run ids count pad runs, and slots at or past
// the number of run heads are reset to padding.
//
// Design: one CTA per row. Each thread owns a contiguous chunk of the
// row and counts its boundaries and its non-pad length sum; one
// block-wide exclusive scan (warp shuffles, then a scan of the warp
// totals in shared memory) gives every chunk its starting run id and
// length prefix. A second pass writes each run head's offset and its
// exclusive length prefix to the output, and after a barrier each run's
// last element turns that prefix into the run length. Slots past the
// run count are reset last.
//
// What bounds it: device memory. The row is read twice (once per pass,
// the second from L2) and each output written at most twice, a few
// bytes per entry; the scan is two barriers. One CTA per row leaves SMs
// idle when the batch is small (16 rows at deployment size).
#include "common.cuh"

namespace {

// Exclusive scan of one int per thread across the block; blockDim.x is a
// multiple of 32. `warp_sums` is shared scratch of 32 ints.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  unsigned x = static_cast<unsigned>(v);
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = static_cast<int>(x);
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < n_warps ? static_cast<unsigned>(warp_sums[lane]) : 0u;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = static_cast<int>(w);
  }
  __syncthreads();
  const unsigned before = warp == 0 ? 0u : static_cast<unsigned>(warp_sums[warp - 1]);
  *total = warp_sums[n_warps - 1];
  const int result = static_cast<int>(before + x - static_cast<unsigned>(v));
  __syncthreads();   // warp_sums is reused by the next scan
  return result;
}

// Boundary of entry i: not contiguous with the previous entry, or pad.
// The end off + len wraps as int32 arithmetic does on the TPU.
__device__ __forceinline__ bool is_boundary(const int* off, const int* len,
                                            int i) {
  const int o = off[i];
  const int prev_end = i == 0 ? -1
      : static_cast<int>(static_cast<unsigned>(off[i - 1]) +
                         static_cast<unsigned>(len[i - 1]));
  return o != prev_end || o == repro::kPadOffset;
}

__global__ void coalesce_rows_kernel(const int* __restrict__ off_in,
                                     const int* __restrict__ len_in,
                                     int* __restrict__ off_out,
                                     int* __restrict__ len_out,
                                     int* __restrict__ counts, int n) {
  __shared__ int warp_sums[32];
  const long long row = static_cast<long long>(blockIdx.x) * n;
  const int* off = off_in + row;
  const int* len = len_in + row;
  int* oo = off_out + row;
  int* ol = len_out + row;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int beg = min(n, static_cast<int>(threadIdx.x) * per);
  const int end = min(n, beg + per);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    oo[i] = repro::kPadOffset;
    ol[i] = 0;
  }
  // pass 1: this chunk's boundaries, heads and non-pad length sum
  int n_bound = 0, n_head = 0;
  unsigned len_sum = 0;
  for (int i = beg; i < end; ++i) {
    const bool pad = off[i] == repro::kPadOffset;
    const bool bd = is_boundary(off, len, i);
    n_bound += bd;
    n_head += bd && !pad;
    len_sum += pad ? 0u : static_cast<unsigned>(len[i]);
  }
  int unused, n_runs;
  const int run0 = block_exclusive_scan(n_bound, warp_sums, &unused);
  const int csum0 = block_exclusive_scan(static_cast<int>(len_sum), warp_sums,
                                         &unused);
  block_exclusive_scan(n_head, warp_sums, &n_runs);   // ends with a barrier

  // pass 2a: each run head writes its offset and exclusive length prefix
  int run = run0 - 1;
  unsigned csum = static_cast<unsigned>(csum0);
  for (int i = beg; i < end; ++i) {
    const bool pad = off[i] == repro::kPadOffset;
    const bool bd = is_boundary(off, len, i);
    run += bd;
    const unsigned l = pad ? 0u : static_cast<unsigned>(len[i]);
    csum += l;
    if (bd && !pad && run >= 0) {
      oo[run] = off[i];
      ol[run] = static_cast<int>(csum - l);
    }
  }
  __syncthreads();
  // pass 2b: each run's last element turns the prefix into the length
  run = run0 - 1;
  csum = static_cast<unsigned>(csum0);
  for (int i = beg; i < end; ++i) {
    const bool pad = off[i] == repro::kPadOffset;
    run += is_boundary(off, len, i);
    csum += pad ? 0u : static_cast<unsigned>(len[i]);
    const bool next_bd = i + 1 == n || is_boundary(off, len, i + 1);
    if (!pad && next_bd && run >= 0) {
      ol[run] = static_cast<int>(csum - static_cast<unsigned>(ol[run]));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (i >= n_runs) {
      oo[i] = repro::kPadOffset;
      ol[i] = 0;
    }
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = n_runs;
}

}  // namespace

// offsets/lengths: int32 [b, n], offset-sorted with PAD_OFFSET padding at
// the tail, n <= 32768. Writes the coalesced rows and the run counts [b].
extern "C" int repro_coalesce(const int* offsets, const int* lengths,
                              int* out_offsets, int* out_lengths, int* counts,
                              int b, int n, void* stream) {
  if (b == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  coalesce_rows_kernel<<<b, repro::row_threads(n), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      offsets, lengths, out_offsets, out_lengths, counts, n);
  return static_cast<int>(cudaGetLastError());
}
