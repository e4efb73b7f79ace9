// Batched sort of request rows, each row spread over many CTAs.
//
// Replaces the VMEM bitonic network of kernels/sort.py (_bitonic_sort_body)
// that both bitonic_sort and fused_sort_pack run on the TPU.
//
// The TPU sorts a whole row (key + two int32 carries, 384 KiB at
// n = 32768) in one VMEM network. On Hopper one CTA per row leaves most of
// the 132 SMs idle at 16 rows, and a row does not fit a CTA's shared
// memory with its carries. So each entry is packed into one 64-bit word,
// the key with its sign bit flipped in the high half and its row position
// in the low half: one unsigned compare orders by key and breaks ties by
// position, so every word is unique and the sort is stable without a tie
// test. The call is 1 + sort_merge_passes(n) launches on one stream:
//
// 1. sort_blocks_kernel, grid (rows, n / block): each CTA sorts a block of
//    block = min(n, kSortBlock) words with a bitonic network whose stages
//    all ascend (each stage's first sweep pairs mirrored entries). Thread
//    t holds words 16t .. 16t + 15 in registers, so strides below 16 are
//    compare-exchanges between its registers (every index a constant:
//    42 of the 78 sweeps at 4096), strides 16 to 256 __shfl_xor_sync
//    between lanes (30), and larger ones go through shared memory (6).
//    The loops over stages and strides stay loops, so the code is small;
//    only the register work is unrolled. A block shorter than kSortBlock
//    is padded with all-ones words, which sort last.
// 2. sort_merge_kernel, once per doubling of the sorted runs, grid (rows,
//    n / kMergeChunk): each CTA writes kMergeChunk outputs of one merged
//    pair of runs. Two warps find where its first and its one-past-last
//    output diagonals cut the two runs (merge path: a 32-ary search in
//    device memory, 3 rounds of two loads a lane at runs of 16384), the
//    CTA stages those two slices in shared memory, and each thread finds
//    its own 8 outputs' cut there by binary search and merges them. Every
//    CTA writes an equal share of every pass: 3 passes at n = 32768.
// 3. The last launch (the block sort when n <= kSortBlock, else the last
//    merge) writes the offsets from the words and gathers lengths and
//    carries by the words' positions.
//
// Scratch for the words between launches: min(passes, 2) planes of
// [rows, n] uint64 (ping-pong), allocated by the wrappers.
//
// What bounds it: device memory would allow a few microseconds (each row
// read once and written once, the words twice a pass); the block sort's
// 78 sweeps of compare-exchanges and shuffles, the merge path's dependent
// loads and the launches themselves take longer.
#pragma once

#include "common.cuh"

namespace {

constexpr int kSortItems = 16;                          // words a thread
constexpr int kSortLogItems = 4;
constexpr int kSortThreads = 256;
constexpr int kSortBlock = kSortThreads * kSortItems;   // 4096 a CTA
constexpr int kMergeChunk = 2048;                       // outputs a CTA
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = kMergeChunk / kMergeThreads;  // 8 a thread
constexpr unsigned long long kSentinel = ~0ull;

__device__ __forceinline__ unsigned long long pack_word(int key, int pos) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(key) ^
                                          0x80000000u)
          << 32) |
         static_cast<uint32_t>(pos);
}

// The word's key, and the carries gathered by its position, at row
// position `at`.
__device__ __forceinline__ void write_sorted(
    unsigned long long w, long long row, int at, const int* __restrict__ c0,
    const int* __restrict__ c1, int* __restrict__ out_off,
    int* __restrict__ out_c0, int* __restrict__ out_c1) {
  const long long src = row + static_cast<uint32_t>(w);
  out_off[row + at] = static_cast<int>(static_cast<uint32_t>(w >> 32) ^
                                       0x80000000u);
  out_c0[row + at] = __ldg(c0 + src);
  out_c1[row + at] = __ldg(c1 + src);
}

// One compare-exchange: the smaller word to the lower index.
__device__ __forceinline__ void order(unsigned long long& lo,
                                      unsigned long long& hi) {
  const unsigned long long a = lo, b = hi;
  lo = a < b ? a : b;
  hi = a < b ? b : a;
}

__device__ __forceinline__ unsigned long long keep(unsigned long long mine,
                                                   unsigned long long other,
                                                   bool take_min) {
  return ((mine < other) == take_min) ? mine : other;
}

// The network is the bitonic sort whose stages all ascend: stage k
// first pairs each entry of a k-run's lower half with its mirror,
// i ^ (k - 1), then halves strides k / 4 .. 1 as usual, the smaller word
// always to the lower index. Thread t holds entries t * 16 .. t * 16 + 15,
// so strides below 16 stay in its registers (every index a constant),
// strides 16 to 256 cross lanes of its warp, larger ones shared memory.

// Stages 2 .. 16: a thread's 16 words sorted ascending.
__device__ __forceinline__ void sort_registers(
    unsigned long long (&v)[kSortItems]) {
#pragma unroll
  for (int lk = 1; lk <= kSortLogItems; ++lk) {
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
      const int p = r ^ ((1 << lk) - 1);
      if (p > r) order(v[r], v[p]);
    }
#pragma unroll
    for (int lj = lk - 2; lj >= 0; --lj) {
#pragma unroll
      for (int r = 0; r < kSortItems; ++r)
        if ((r & (1 << lj)) == 0) order(v[r], v[r | (1 << lj)]);
    }
  }
}

// The strides 8 .. 1 that end a later stage.
__device__ __forceinline__ void merge_registers(
    unsigned long long (&v)[kSortItems]) {
#pragma unroll
  for (int lj = kSortLogItems - 1; lj >= 0; --lj) {
#pragma unroll
    for (int r = 0; r < kSortItems; ++r)
      if ((r & (1 << lj)) == 0) order(v[r], v[r | (1 << lj)]);
  }
}

// One sweep against thread t ^ m of the warp: word r meets the partner's
// word r, or its word 15 - r where kMirror; the lower thread keeps the
// smaller.
template <bool kMirror>
__device__ __forceinline__ void sweep_warp(
    unsigned long long (&v)[kSortItems], int m, bool upper) {
  if (kMirror) {
#pragma unroll
    for (int r = 0; r < kSortItems / 2; ++r) {
      const int q = kSortItems - 1 - r;
      const unsigned long long a = __shfl_xor_sync(0xffffffffu, v[q], m);
      const unsigned long long b = __shfl_xor_sync(0xffffffffu, v[r], m);
      v[r] = keep(v[r], a, !upper);
      v[q] = keep(v[q], b, !upper);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kSortItems; ++r)
      v[r] = keep(v[r], __shfl_xor_sync(0xffffffffu, v[r], m), !upper);
  }
}

// One word of padding every 16: the lanes of a warp, 16 words apart,
// fall on distinct banks.
__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// The same sweep against thread t ^ m of another warp, through `xs`.
template <bool kMirror>
__device__ __forceinline__ void sweep_shared(
    unsigned long long (&v)[kSortItems], unsigned long long* xs, int t,
    int m, bool upper) {
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) xs[padded(t * kSortItems + r)] = v[r];
  __syncthreads();
  const int base = (t ^ m) * kSortItems;
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int q = kMirror ? kSortItems - 1 - r : r;
    v[r] = keep(v[r], xs[padded(base + q)], !upper);
  }
}

// Sort `block` words of row blockIdx.x starting at blockIdx.y * block
// (block <= kThreads * kSortItems; a shorter block is padded with
// all-ones words, which sort last). `last`: write the sorted row
// (block == n), else the words to `words`.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
sort_blocks_kernel(const int* __restrict__ off, const int* __restrict__ c0,
                   const int* __restrict__ c1,
                   unsigned long long* __restrict__ words,
                   int* __restrict__ out_off, int* __restrict__ out_c0,
                   int* __restrict__ out_c1, int n, int block, int last) {
  constexpr int kWords = kThreads * kSortItems;
  __shared__ unsigned long long xs[kWords + kWords / 16];
  const long long row = static_cast<long long>(blockIdx.x) * n;
  const int start = blockIdx.y * block;
  const int t = threadIdx.x;
  for (int i = t; i < kWords; i += kThreads)   // coalesced
    xs[padded(i)] = i < block
        ? pack_word(__ldg(off + row + start + i), start + i) : kSentinel;
  __syncthreads();
  unsigned long long v[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) v[r] = xs[padded(t * kSortItems + r)];
  sort_registers(v);
  for (int k = 2 * kSortItems; k <= kWords; k <<= 1) {
    const int m = k / kSortItems - 1;
    const bool upper = (t & (k / (2 * kSortItems))) != 0;
    if (m < 32) sweep_warp<true>(v, m, upper);
    else sweep_shared<true>(v, xs, t, m, upper);
    for (int j = k / 4; j >= kSortItems; j >>= 1) {
      const int mj = j / kSortItems;
      if (mj < 32) sweep_warp<false>(v, mj, (t & mj) != 0);
      else sweep_shared<false>(v, xs, t, mj, (t & mj) != 0);
    }
    merge_registers(v);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) xs[padded(t * kSortItems + r)] = v[r];
  __syncthreads();
  for (int i = t; i < block; i += kThreads) {   // coalesced
    if (last) {
      write_sorted(xs[padded(i)], row, start + i, c0, c1, out_off, out_c0,
                   out_c1);
    } else {
      words[row + start + i] = xs[padded(i)];
    }
  }
}

// The number of a's words among the first d of merge(a[0, la),
// b[0, lb)) (every word unique), found by the calling warp with a 32-ary
// search: each round each lane tests one cut, a ballot keeps the range
// between the last cut that is still before d and the first that is not.
__device__ __forceinline__ int co_rank(const unsigned long long* a,
                                       const unsigned long long* b, int la,
                                       int lb, int d, int lane) {
  int lo = d - lb > 0 ? d - lb : 0;
  int hi = d < la ? d : la;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + (lane + 1) * step - 1;
    const bool before = i < hi && __ldg(a + i) < __ldg(b + d - 1 - i);
    const int c = __popc(__ballot_sync(0xffffffffu, before));
    const int next_hi = lo + (c + 1) * step - 1;
    lo = lo + c * step < hi ? lo + c * step : hi;
    hi = next_hi < hi ? next_hi : hi;
  }
  return lo;
}

// Merge pairs of sorted runs of `run` words into runs of 2 * run: CTA
// (row, y) writes outputs [y * kMergeChunk, (y + 1) * kMergeChunk) of its
// row. `last`: write the sorted row, else the words to `out`.
__global__ void __launch_bounds__(kMergeThreads)
sort_merge_kernel(const unsigned long long* __restrict__ in,
                  unsigned long long* __restrict__ out,
                  const int* __restrict__ c0, const int* __restrict__ c1,
                  int* __restrict__ out_off, int* __restrict__ out_c0,
                  int* __restrict__ out_c1, int n, int run, int last) {
  __shared__ unsigned long long xs[kMergeChunk];
  __shared__ int cut[2];
  const long long row = static_cast<long long>(blockIdx.x) * n;
  const int first = blockIdx.y * kMergeChunk;   // first output, in the row
  const int pair = first / (2 * run);
  const int d0 = first - pair * 2 * run;        // ... in the merged pair
  const unsigned long long* a =
      in + row + static_cast<long long>(pair) * 2 * run;
  const unsigned long long* b = a + run;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < 2) {
    const int r = co_rank(a, b, run, run, d0 + warp * kMergeChunk, lane);
    if (lane == 0) cut[warp] = r;
  }
  __syncthreads();
  const int a0 = cut[0];
  const int na = cut[1] - a0;                   // a's words in this chunk
  const int nb = kMergeChunk - na;
  const int b0 = d0 - a0;
  for (int i = threadIdx.x; i < kMergeChunk; i += kMergeThreads)
    xs[i] = i < na ? __ldg(a + a0 + i) : __ldg(b + b0 + i - na);
  __syncthreads();

  // this thread's outputs [dt, dt + kMergeItems) of the chunk
  const int dt = threadIdx.x * kMergeItems;
  int lo = dt - nb > 0 ? dt - nb : 0;
  int hi = dt < na ? dt : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (xs[mid] < xs[na + dt - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  int ia = lo, ib = dt - lo;
  unsigned long long merged[kMergeItems];
#pragma unroll
  for (int e = 0; e < kMergeItems; ++e) {
    const unsigned long long xa = xs[ia < kMergeChunk ? ia : kMergeChunk - 1];
    const int jb = na + ib;
    const unsigned long long xb = xs[jb < kMergeChunk ? jb : kMergeChunk - 1];
    const bool take_a = ib >= nb || (ia < na && xa < xb);
    merged[e] = take_a ? xa : xb;
    ia += take_a;
    ib += !take_a;
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kMergeItems; ++e) xs[dt + e] = merged[e];
  __syncthreads();
  for (int i = threadIdx.x; i < kMergeChunk; i += kMergeThreads) {
    if (last) {
      write_sorted(xs[i], row, first + i, c0, c1, out_off, out_c0, out_c1);
    } else {
      out[row + first + i] = xs[i];
    }
  }
}

// Merge passes after the block sort: log2(n / min(n, kSortBlock)).
inline int sort_merge_passes(int n) {
  int passes = 0;
  for (int run = n < kSortBlock ? n : kSortBlock; run < n; run <<= 1)
    ++passes;
  return passes;
}

// Sort each [n] row of off (ascending, ties by position) carrying c0 and
// c1, over b rows on `stream`. n is a power of two <= 32768 (MAX_BLOCK);
// `words` holds min(sort_merge_passes(n), 2) * b * n uint64 of scratch.
inline cudaError_t launch_sort_rows(const int* off, const int* c0,
                                    const int* c1, int* out_off, int* out_c0,
                                    int* out_c1, unsigned long long* words,
                                    int b, int n, cudaStream_t stream) {
  if (b == 0) return cudaSuccess;
  const int block = n < kSortBlock ? n : kSortBlock;
  const int passes = sort_merge_passes(n);
  const long long plane = static_cast<long long>(b) * n;
  sort_blocks_kernel<kSortThreads>
      <<<dim3(b, n / block), kSortThreads, 0, stream>>>(
      off, c0, c1, words, out_off, out_c0, out_c1, n, block, passes == 0);
  cudaError_t err = cudaGetLastError();
  for (int p = 0; p < passes && err == cudaSuccess; ++p) {
    sort_merge_kernel<<<dim3(b, n / kMergeChunk), kMergeThreads, 0,
                        stream>>>(
        words + (p % 2) * plane, words + ((p + 1) % 2) * plane, c0, c1,
        out_off, out_c0, out_c1, n, block << p, p == passes - 1);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace
