// zero_skip_encode / zero_skip_decode for Hopper: replace
// kernels/fused_round.py::zero_skip_encode and ::zero_skip_decode (the
// rle codec's wire on the slow hop; per row the TPU kernels hold the whole
// row in VMEM, run a Hillis-Steele scan of the nonzero flags and scatter).
//
// encode: per [rows, n] row, the nonzero elements (v != 0 in the payload's
// own type) compacted to the front in position order, their int32
// positions beside them, (0, -1) behind. decode: the inverse,
// out[row, pos] = val where 0 <= pos < n, zeros elsewhere, for positions
// in any order. Both take 1-, 2-, 4- and 8-byte elements and move them as
// raw bits; only the zero test reads them. For a float (f16, bf16, f32,
// f64) it is (bits & ~sign) != 0, so -0.0 is a zero and NaN is not; for an
// integer or bool, bits != 0.
//
// encode's design. A row of 131072 or 262144 elements does not fit a
// block's shared memory, so rows are walked in tiles of 4096 elements (at
// every width: each thread loads 16 bytes, 16 / w elements, a load, so a
// tile is 1, 2, 4 or 8 loads a thread). In a tile a thread counts its
// elements' nonzeros, a warp scan and one scan over the (load, warp)
// totals give each nonzero its slot, the tile's nonzeros are staged in
// shared memory in slot order, and the CTA writes them out with
// neighbouring threads on neighbouring slots. Slots follow positions, so
// the result is the stable partition of the plain version. Two kernels
// take the rows, as the wrapper's rule (encode_chunks) picks:
// - where the rows give every SM a CTA (256 and 16384 on the paths), one
//   CTA a row walks its tiles with a carried count;
// - else (a read's 16 rows) every tile is a chunk with a CTA of its own,
//   and the chunks of a row chain their counts through a decoupled
//   look-back (Merrill and Garland's single-pass scan): a chunk publishes
//   its count in a per-row status array (flag "aggregate") as soon as it
//   has it, stages its tile, and then its warp 0 sums the predecessors'
//   words backwards until it meets an "inclusive" one and publishes its
//   own inclusive prefix. Chunk ids come from an atomic ticket, not from
//   blockIdx, so that every chunk's predecessors already run and none
//   waits on a CTA that is not resident. A status word holds its flag and
//   count in one 64-bit store, read with volatile loads; it carries all
//   it tells, and a chunk's two stores go to one address in program
//   order, so no fence orders them (a __threadfence before each cost 3%
//   with 64 chunks a row on the H100).
//
// Who writes the padding (0, -1) of slots [total, n): no chunk knows the
// row's total until the row's last chunk has its inclusive prefix, but
// every tile knows how many zeros it holds and how many come before it
// (its first position less its prefix). So each tile writes its share of
// the padding counted back from the row's end: slots [n - zeros before
// it - zeros in it, n - zeros before it). Those shares tile [total, n)
// exactly, as the nonzeros' slots tile [0, total): every CTA writes as
// many slots as it reads elements, and no launch waits for a row's end.
//
// decode's design. A CTA that owns a tile of the output cannot know which
// entries land in it without reading the whole row's positions, so the
// call is two launches on one stream, each spread over the whole card
// whatever the number of rows: launch A zeroes the [rows, n] output with
// 16-byte stores, a grid of a few CTAs per SM striding over it; launch B
// reads the flattened (vals, pos) rows in tiles of kDecodeTile entries, one
// CTA per tile (several waves of 132 SMs at every deployment shape): pos
// whole, vals only where 0 <= pos < n, and stores each value at its
// position. pos loads are 4 bytes a lane, neighbouring lanes on
// neighbouring entries, so that a warp's stores of the encoder's ascending
// positions also fall on neighbouring elements (16-byte loads of four
// entries a lane spread each warp's stores over four times the elements,
// and were slower on the H100). An encoded wire has no duplicate
// positions, so the order of the stores does not matter.
//
// What bounds them: device memory. encode reads n elements of w bytes and
// writes n values and n int32 positions; where rows are few, each chunk's
// look-back adds its round trips to the chunk's path (at 256 rows the
// look-back cost more than one CTA a row saves, so 256 rows take one CTA
// a row). decode reads pos whole and vals
// where pos >= 0 and writes n elements (the zeroing writes n more, and
// each value is written a second time).
#include "common.cuh"

namespace {

constexpr int kEncodeThreads = 256;
constexpr int kEncodeWarps = kEncodeThreads / 32;
constexpr int kEncodeTile = 4096;              // elements a tile, any width
constexpr int kRowBlocksPerSm = 6;              // 40 registers a thread
constexpr int kChunkBlocksPerSm = 8;            // 32 registers (w < 8)
constexpr unsigned long long kAggregate = 1ull << 32;   // status flags
constexpr unsigned long long kInclusive = 2ull << 32;

template <typename T>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);    // elements a 16-byte load
  static constexpr int kLoads = kEncodeTile / (kEncodeThreads * kVec);
  static constexpr int kTotals = kLoads * kEncodeWarps;   // 8 to 64
  // the tile's nonzeros in slot order: values, positions in the tile
  T vals[kEncodeTile];
  unsigned short idx[kEncodeTile];
  int base[kTotals];   // exclusive slot base of each (load, warp)
  int total;           // the tile's nonzeros
  int excl;            // the row's nonzeros before the tile (look-back)
  unsigned ticket;
};

// v != 0 in the payload's own type, on its bits.
template <typename T, bool kFloat>
__device__ __forceinline__ bool nonzero(T bits) {
  if (kFloat) {
    const T magnitude = static_cast<T>(~(T(1) << (sizeof(T) * 8 - 1)));
    return (bits & magnitude) != T(0);
  }
  return bits != T(0);
}

// The thread's elements of the tile at in[tile]: load j holds elements
// tile + (j * kEncodeThreads + threadIdx.x) * kVec + [0, kVec), one
// 16-byte load where all lie before end and start on 16 bytes, else
// element by element (zeros from end on).
template <typename T>
__device__ __forceinline__ void load_tile(
    const T* __restrict__ in, int tile, int end,
    T (&v)[Tile<T>::kLoads][Tile<T>::kVec]) {
  constexpr int kVec = Tile<T>::kVec;
#pragma unroll
  for (int j = 0; j < Tile<T>::kLoads; ++j) {
    const int e = tile + (j * kEncodeThreads + threadIdx.x) * kVec;
    if (e + kVec <= end &&
        (reinterpret_cast<uintptr_t>(in + e) & 15u) == 0) {
      union {
        uint4 q;
        T x[kVec];
      } u;
      u.q = __ldg(reinterpret_cast<const uint4*>(in + e));
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[j][k] = u.x[k];
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        v[j][k] = e + k < end ? in[e + k] : T(0);
    }
  }
}

// Ranks the tile's nonzeros: the thread's flags per load, its lane prefix
// per load, t.base and t.total. Called by every thread; ends after a
// __syncthreads, with t.base and t.total visible to all.
template <typename T, bool kFloat>
__device__ __forceinline__ void rank_tile(
    const T (&v)[Tile<T>::kLoads][Tile<T>::kVec],
    unsigned (&flags)[Tile<T>::kLoads], int (&lane_base)[Tile<T>::kLoads],
    Tile<T>& t, int lane, int warp) {
  constexpr int kTotals = Tile<T>::kTotals;
  constexpr int kPer = (kTotals + 31) / 32;
#pragma unroll
  for (int j = 0; j < Tile<T>::kLoads; ++j) {
    flags[j] = 0u;
#pragma unroll
    for (int k = 0; k < Tile<T>::kVec; ++k)
      flags[j] |= static_cast<unsigned>(nonzero<T, kFloat>(v[j][k])) << k;
    const int c = __popc(flags[j]);
    int x = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    lane_base[j] = x - c;
    if (lane == 31) t.base[j * kEncodeWarps + warp] = x;
  }
  __syncthreads();
  if (warp == 0) {   // exclusive scan of the (load, warp) totals
    int part[kPer], sum = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = lane * kPer + q;
      part[q] = i < kTotals ? t.base[i] : 0;
      sum += part[q];
    }
    int x = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    int run = x - sum;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = lane * kPer + q;
      if (i < kTotals) t.base[i] = run;
      run += part[q];
    }
    if (lane == 31) t.total = x;
  }
  __syncthreads();
}

// Stages the thread's nonzeros at their slots of t.vals / t.idx.
template <typename T>
__device__ __forceinline__ void stage_tile(
    const T (&v)[Tile<T>::kLoads][Tile<T>::kVec],
    const unsigned (&flags)[Tile<T>::kLoads],
    const int (&lane_base)[Tile<T>::kLoads], Tile<T>& t, int warp) {
#pragma unroll
  for (int j = 0; j < Tile<T>::kLoads; ++j) {
    int slot = t.base[j * kEncodeWarps + warp] + lane_base[j];
    const int first = (j * kEncodeThreads + threadIdx.x) * Tile<T>::kVec;
#pragma unroll
    for (int k = 0; k < Tile<T>::kVec; ++k) {
      if ((flags[j] >> k) & 1u) {
        t.vals[slot] = v[j][k];
        t.idx[slot] = static_cast<unsigned short>(first + k);
        ++slot;
      }
    }
  }
}

// Writes the tile's len slots of a row (ov, op): slot s < total (the
// tile's nonzeros) takes its s-th nonzero at carry + s (carry: the row's
// nonzeros before the tile); the rest pad, counted back from the row's
// end past the zeros before the tile (tile - carry of them).
template <typename T>
__device__ __forceinline__ void write_tile(T* __restrict__ ov,
                                           int* __restrict__ op,
                                           const Tile<T>& t, int total,
                                           int carry, int tile, int len,
                                           int n) {
  const int pad_at = n - (tile - carry) - len;
  for (int s = threadIdx.x; s < len; s += kEncodeThreads) {
    if (s < total) {
      ov[carry + s] = t.vals[s];
      op[carry + s] = tile + t.idx[s];
    } else {
      ov[pad_at + s] = T(0);
      op[pad_at + s] = -1;
    }
  }
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long flag,
                                             int value) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      flag | static_cast<uint32_t>(value);
}

// The sum of the counts of chunks [0, chunk) of one row, by warp 0:
// lane l reads the status of chunk hi - l, waits until it holds a count,
// and the lanes up to the nearest inclusive prefix are summed; without
// one, all 32 counts are summed and the window moves 32 chunks back.
__device__ int look_back(const unsigned long long* status, int chunk,
                         int lane) {
  int excl = 0;
  for (int hi = chunk - 1;; hi -= 32) {
    const int i = hi - lane;
    unsigned long long w = i >= 0 ? load_status(status + i) : kInclusive;
    while (__any_sync(0xffffffffu, (w >> 32) == 0)) {
      if ((w >> 32) == 0) w = load_status(status + i);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, (w >> 32) == 2);
    const int last = incl ? __ffs(incl) - 1 : 31;
    int v = lane <= last ? static_cast<int>(static_cast<uint32_t>(w)) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    excl += v;
    if (incl) return excl;
  }
}

// One CTA a row: the row's tiles in order, with a carried count.
template <typename T, bool kFloat>
__global__ void __launch_bounds__(kEncodeThreads, kRowBlocksPerSm)
zero_skip_encode_rows_kernel(const T* __restrict__ data,
                             T* __restrict__ vals, int* __restrict__ pos,
                             int n) {
  __shared__ Tile<T> t;
  const long long row = blockIdx.x;
  const T* in = data + row * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int tile = 0; tile < n; tile += kEncodeTile) {
    T v[Tile<T>::kLoads][Tile<T>::kVec];
    unsigned flags[Tile<T>::kLoads];
    int lane_base[Tile<T>::kLoads];
    load_tile<T>(in, tile, n, v);
    rank_tile<T, kFloat>(v, flags, lane_base, t, lane, warp);
    const int total = t.total;
    stage_tile<T>(v, flags, lane_base, t, warp);
    __syncthreads();
    write_tile<T>(vals + row * n, pos + row * n, t, total, carry, tile,
                  n - tile < kEncodeTile ? n - tile : kEncodeTile, n);
    carry += total;
    __syncthreads();   // the next tile rewrites t
  }
}

// One CTA a chunk of one tile (chunks a row), the chunk from the ticket at
// status[gridDim.x]; status[row * chunks + chunk] holds the chunk's word.
// All zero at launch.
template <typename T, bool kFloat>
__global__ void __launch_bounds__(kEncodeThreads,
                                  sizeof(T) == 8 ? 4 : kChunkBlocksPerSm)
zero_skip_encode_chunks_kernel(const T* __restrict__ data,
                               T* __restrict__ vals, int* __restrict__ pos,
                               unsigned long long* __restrict__ status,
                               int n, int chunks) {
  __shared__ Tile<T> t;
  if (threadIdx.x == 0)
    t.ticket = atomicAdd(reinterpret_cast<unsigned*>(status + gridDim.x), 1u);
  __syncthreads();
  const unsigned id = t.ticket;
  const long long row = id / chunks;
  const int chunk = static_cast<int>(id - row * chunks);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T v[Tile<T>::kLoads][Tile<T>::kVec];
  unsigned flags[Tile<T>::kLoads];
  int lane_base[Tile<T>::kLoads];
  load_tile<T>(data + row * n, chunk * kEncodeTile, n, v);
  rank_tile<T, kFloat>(v, flags, lane_base, t, lane, warp);
  const int total = t.total;
  if (threadIdx.x == 0)   // the count, as soon as it is known
    store_status(status + id, chunk ? kAggregate : kInclusive, total);
  stage_tile<T>(v, flags, lane_base, t, warp);
  if (chunk > 0 && warp == 0) {   // the row's nonzeros before the chunk
    const int excl = look_back(status + row * chunks, chunk, lane);
    if (lane == 0) {
      store_status(status + id, kInclusive, excl + total);
      t.excl = excl;
    }
  }
  __syncthreads();
  write_tile<T>(vals + row * n, pos + row * n, t, total,
                chunk > 0 ? t.excl : 0, chunk * kEncodeTile, kEncodeTile, n);
}

constexpr int kDecodeThreads = 256;
constexpr int kDecodeItems = 8;                          // entries a thread
constexpr int kDecodeTile = kDecodeThreads * kDecodeItems;   // 2048 a CTA
constexpr int kZeroThreads = 512;
constexpr int kZeroBlocksPerSm = 4;

// Launch A of decode: out[0, bytes) = 0 with 16-byte stores (out 16-byte
// aligned).
__global__ void __launch_bounds__(kZeroThreads)
zero_skip_zero_kernel(uint8_t* __restrict__ out, long long bytes) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint4* o = reinterpret_cast<uint4*>(out);
  const long long vecs = bytes >> 4;
  for (long long v = i; v < vecs; v += stride)
    o[v] = make_uint4(0u, 0u, 0u, 0u);
  for (long long e = (vecs << 4) + i; e < bytes; e += stride) out[e] = 0;
}

// Launch B of decode: one CTA per kDecodeTile entries of the flattened
// [rows, n] (vals, pos); entry e of row r = e >> log2n stores vals[e] at
// out[r * n + pos[e]] where 0 <= pos[e] < n. Thread t takes entries
// tile + k * kDecodeThreads + t: a warp's loads and, for the encoder's
// ascending positions, its stores fall on consecutive elements.
template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
zero_skip_scatter_kernel(const T* __restrict__ vals,
                         const int* __restrict__ pos, T* __restrict__ out,
                         long long count, int log2n) {
  const int n = 1 << log2n;
  const long long tile = static_cast<long long>(blockIdx.x) * kDecodeTile;
  int p[kDecodeItems];
#pragma unroll
  for (int k = 0; k < kDecodeItems; ++k) {
    const long long e = tile + k * kDecodeThreads + threadIdx.x;
    p[k] = e < count ? __ldg(pos + e) : -1;
  }
#pragma unroll
  for (int k = 0; k < kDecodeItems; ++k) {
    const long long e = tile + k * kDecodeThreads + threadIdx.x;
    if (p[k] >= 0 && p[k] < n)
      out[((e >> log2n) << log2n) + p[k]] = __ldg(vals + e);
  }
}

template <typename T, bool kFloat>
cudaError_t launch_encode(const void* data, void* vals, int* pos,
                          unsigned long long* status, int rows, int n,
                          int chunks, cudaStream_t s) {
  const T* in = static_cast<const T*>(data);
  T* ov = static_cast<T*>(vals);
  if (chunks == 1) {
    zero_skip_encode_rows_kernel<T, kFloat>
        <<<rows, kEncodeThreads, 0, s>>>(in, ov, pos, n);
    return cudaGetLastError();
  }
  const unsigned count = static_cast<unsigned>(rows) * chunks;
  const cudaError_t err = cudaMemsetAsync(
      status, 0, (static_cast<size_t>(count) + 1) * sizeof(*status), s);
  if (err != cudaSuccess) return err;
  zero_skip_encode_chunks_kernel<T, kFloat>
      <<<count, kEncodeThreads, 0, s>>>(in, ov, pos, status, n, chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scatter(const void* vals, const int* pos, void* out,
                           long long count, int log2n, cudaStream_t s) {
  const unsigned tiles =
      static_cast<unsigned>((count + kDecodeTile - 1) / kDecodeTile);
  zero_skip_scatter_kernel<T><<<tiles, kDecodeThreads, 0, s>>>(
      static_cast<const T*>(vals), pos, static_cast<T*>(out), count, log2n);
  return cudaGetLastError();
}

}  // namespace

// data, vals: [rows, n] of elem_bytes-wide elements (1, 2, 4, 8); pos:
// int32 [rows, n]; is_float picks the float zero test (widths 2, 4, 8).
// chunks: chunks a row, 1 (one CTA a row) or n / 4096; status: rows *
// chunks + 1 64-bit words of scratch, zeroed here where chunks > 1.
extern "C" int repro_zero_skip_encode(const void* data, void* vals, int* pos,
                                      unsigned long long* status, int rows,
                                      int n, int chunks, int elem_bytes,
                                      int is_float, void* stream) {
  if (rows == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  if (chunks < 1 || (chunks > 1 && n / chunks != kEncodeTile) ||
      n % chunks || static_cast<long long>(rows) * chunks >= 0xffffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (elem_bytes * 2 + (is_float ? 1 : 0)) {
    case 2:
      err = launch_encode<uint8_t, false>(data, vals, pos, status, rows, n,
                                          chunks, s);
      break;
    case 4:
      err = launch_encode<uint16_t, false>(data, vals, pos, status, rows, n,
                                           chunks, s);
      break;
    case 5:
      err = launch_encode<uint16_t, true>(data, vals, pos, status, rows, n,
                                          chunks, s);
      break;
    case 8:
      err = launch_encode<uint32_t, false>(data, vals, pos, status, rows, n,
                                           chunks, s);
      break;
    case 9:
      err = launch_encode<uint32_t, true>(data, vals, pos, status, rows, n,
                                          chunks, s);
      break;
    case 16:
      err = launch_encode<uint64_t, false>(data, vals, pos, status, rows, n,
                                           chunks, s);
      break;
    case 17:
      err = launch_encode<uint64_t, true>(data, vals, pos, status, rows, n,
                                          chunks, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// vals, out: [rows, n] of elem_bytes-wide elements (1, 2, 4, 8); pos:
// int32 [rows, n], -1 = no slot; n a power of two; out 16-byte aligned.
// Two launches: zero the output, then scatter.
extern "C" int repro_zero_skip_decode(const void* vals, const int* pos,
                                      void* out, int rows, int n,
                                      int elem_bytes, void* stream) {
  if (rows == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  if (reinterpret_cast<uintptr_t>(out) & 15u)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4 &&
      elem_bytes != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long count = static_cast<long long>(rows) * n;
  const long long bytes = count * elem_bytes;
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed = (bytes / 16 + kZeroThreads - 1) / kZeroThreads;
  const long long most = static_cast<long long>(sms) * kZeroBlocksPerSm;
  const int zero_blocks = static_cast<int>(
      needed < 1 ? 1 : (needed < most ? needed : most));
  zero_skip_zero_kernel<<<zero_blocks, kZeroThreads, 0, s>>>(
      static_cast<uint8_t*>(out), bytes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (elem_bytes) {
    case 1:
      err = launch_scatter<uint8_t>(vals, pos, out, count, log2n, s);
      break;
    case 2:
      err = launch_scatter<uint16_t>(vals, pos, out, count, log2n, s);
      break;
    case 4:
      err = launch_scatter<uint32_t>(vals, pos, out, count, log2n, s);
      break;
    default:
      err = launch_scatter<uint64_t>(vals, pos, out, count, log2n, s);
  }
  return static_cast<int>(err);
}
