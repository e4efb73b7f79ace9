// zero_skip_encode / zero_skip_decode for Hopper: replace
// kernels/fused_round.py::zero_skip_encode and ::zero_skip_decode (the
// rle codec's wire on the slow hop; per row the TPU kernels hold the whole
// row in VMEM, run a Hillis-Steele scan of the nonzero flags and scatter).
//
// encode: per [rows, n] row, the nonzero words (data != 0 in the payload's
// own type: for float32 -0.0 is zero and NaN is not) compacted to the
// front in position order, their positions beside them, (0, -1) behind.
// decode: the inverse, out[row, pos] = val where 0 <= pos < n, zeros
// elsewhere, for positions in any order.
//
// encode's design. A row of 131072 or 262144 words (512 KiB, 1 MiB) does
// not fit a block's 227 KB of shared memory, so one CTA walks its row in
// tiles of kItems * blockDim words with a running count carried across
// tiles. In a tile, thread t loads words base + j * blockDim + t
// (coalesced) for j < kItems; a warp ballot per j gives each word its rank
// inside its warp and the warp's count, and one scan over the warps of
// each j (warp shuffles) plus a serial sum over the kItems totals gives
// every nonzero its output slot: carry + earlier items + earlier warps +
// earlier lanes. Slots follow positions, so the result equals the stable
// partition of the plain version. Words are moved as raw bits; only the
// zero test reads them as float.
//
// decode's design. A CTA that owns a tile of the output cannot know which
// entries land in it without reading the whole row's positions, so the
// call is two launches on one stream, each spread over the whole card
// whatever the number of rows: launch A zeroes the [rows, n] output with
// 16-byte stores, a grid of a few CTAs per SM striding over it; launch B
// reads the flattened (vals, pos) rows in tiles of kDecodeTile entries, one
// CTA per tile (several waves of 132 SMs at every deployment shape): pos
// whole, vals only where 0 <= pos < n, and stores each value at its
// position. Loads are 4 bytes a lane, neighbouring lanes on neighbouring
// entries, so that a warp's stores of the encoder's ascending positions
// also fall on neighbouring words (16-byte loads of four entries a lane
// spread each warp's stores over four times the words, and were slower on
// the H100). An encoded wire has no duplicate positions, so the order of
// the stores does not matter.
//
// What bounds them: device memory. encode reads n words and writes 2n;
// decode reads pos whole and vals where pos >= 0 and writes n (the zeroing
// writes n more, and each value is written a second time). encode runs one
// CTA per row, with 16384 rows on the two-phase wire and 16 on a read's
// windows (where most SMs idle).
#include "common.cuh"

namespace {

constexpr int kItems = 16;          // words per thread per tile
constexpr int kEncodeThreads = 256;  // tile of 4096 words

template <bool kFloat>
__device__ __forceinline__ bool nonzero(uint32_t bits) {
  if (kFloat) return __uint_as_float(bits) != 0.0f;
  return bits != 0u;
}

template <bool kFloat>
__global__ void __launch_bounds__(kEncodeThreads)
zero_skip_encode_kernel(const uint32_t* __restrict__ data,
                        uint32_t* __restrict__ vals, int* __restrict__ pos,
                        int n) {
  __shared__ int warp_prefix[kItems][32];   // exclusive, per (item, warp)
  __shared__ int item_total[kItems];
  const long long row = static_cast<long long>(blockIdx.x) * n;
  const uint32_t* in = data + row;
  uint32_t* ov = vals + row;
  int* op = pos + row;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int tile = kItems * blockDim.x;

  int carry = 0;
  for (int base = 0; base < n; base += tile) {
    uint32_t v[kItems];
    unsigned m[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = base + j * blockDim.x + threadIdx.x;
      v[j] = e < n ? in[e] : 0u;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = base + j * blockDim.x + threadIdx.x;
      m[j] = __ballot_sync(0xffffffffu, e < n && nonzero<kFloat>(v[j]));
      if (lane == 0) warp_prefix[j][warp] = __popc(m[j]);
    }
    __syncthreads();
    for (int j = warp; j < kItems; j += n_warps) {
      const int c = lane < n_warps ? warp_prefix[j][lane] : 0;
      int x = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (lane < n_warps) warp_prefix[j][lane] = x - c;
      if (lane == 31) item_total[j] = x;
    }
    __syncthreads();
    int before = carry;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if ((m[j] >> lane) & 1u) {
        const int r = before + warp_prefix[j][warp] + __popc(m[j] & lanes_below);
        ov[r] = v[j];
        op[r] = base + j * blockDim.x + threadIdx.x;
      }
      before += item_total[j];
    }
    carry = before;
    __syncthreads();   // the next tile rewrites warp_prefix and item_total
  }
  for (int e = carry + threadIdx.x; e < n; e += blockDim.x) {
    ov[e] = 0u;
    op[e] = -1;
  }
}

constexpr int kDecodeThreads = 256;
constexpr int kDecodeItems = 8;                          // entries a thread
constexpr int kDecodeTile = kDecodeThreads * kDecodeItems;   // 2048 a CTA
constexpr int kZeroThreads = 512;
constexpr int kZeroBlocksPerSm = 4;

// Launch A: out[0, words) = 0 with 16-byte stores (out 16-byte aligned).
__global__ void __launch_bounds__(kZeroThreads)
zero_skip_zero_kernel(uint32_t* __restrict__ out, long long words) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint4* o = reinterpret_cast<uint4*>(out);
  const long long vecs = words >> 2;
  for (long long v = i; v < vecs; v += stride)
    o[v] = make_uint4(0u, 0u, 0u, 0u);
  for (long long e = (vecs << 2) + i; e < words; e += stride) out[e] = 0u;
}

// Launch B: one CTA per kDecodeTile entries of the flattened [rows, n]
// (vals, pos); entry e of row r = e >> log2n stores vals[e] at
// out[r * n + pos[e]] where 0 <= pos[e] < n. Thread t takes entries
// tile + k * kDecodeThreads + t: a warp's loads and, for the encoder's
// ascending positions, its stores fall on consecutive words.
__global__ void __launch_bounds__(kDecodeThreads)
zero_skip_scatter_kernel(const uint32_t* __restrict__ vals,
                         const int* __restrict__ pos,
                         uint32_t* __restrict__ out, long long words,
                         int log2n) {
  const int n = 1 << log2n;
  const long long tile = static_cast<long long>(blockIdx.x) * kDecodeTile;
  int p[kDecodeItems];
#pragma unroll
  for (int k = 0; k < kDecodeItems; ++k) {
    const long long e = tile + k * kDecodeThreads + threadIdx.x;
    p[k] = e < words ? __ldg(pos + e) : -1;
  }
#pragma unroll
  for (int k = 0; k < kDecodeItems; ++k) {
    const long long e = tile + k * kDecodeThreads + threadIdx.x;
    if (p[k] >= 0 && p[k] < n)
      out[((e >> log2n) << log2n) + p[k]] = __ldg(vals + e);
  }
}

}  // namespace

// data, vals: 4-byte words [rows, n]; pos: int32 [rows, n]. is_float picks
// the float32 zero test, else the int32 one.
extern "C" int repro_zero_skip_encode(const void* data, void* vals, int* pos,
                                      int rows, int n, int is_float,
                                      void* stream) {
  if (rows == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads =
      n < kEncodeThreads ? repro::row_threads(n) : kEncodeThreads;
  const uint32_t* in = static_cast<const uint32_t*>(data);
  uint32_t* ov = static_cast<uint32_t*>(vals);
  if (is_float) {
    zero_skip_encode_kernel<true><<<rows, threads, 0, s>>>(in, ov, pos, n);
  } else {
    zero_skip_encode_kernel<false><<<rows, threads, 0, s>>>(in, ov, pos, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// vals, out: 4-byte words [rows, n]; pos: int32 [rows, n], -1 = no slot;
// n a power of two; out 16-byte aligned. Two launches: zero the output,
// then scatter.
extern "C" int repro_zero_skip_decode(const void* vals, const int* pos,
                                      void* out, int rows, int n,
                                      void* stream) {
  if (rows == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  if (reinterpret_cast<uintptr_t>(out) & 15u)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long words = static_cast<long long>(rows) * n;
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed = (words / 4 + kZeroThreads - 1) / kZeroThreads;
  const long long most = static_cast<long long>(sms) * kZeroBlocksPerSm;
  const int zero_blocks = static_cast<int>(
      needed < 1 ? 1 : (needed < most ? needed : most));
  uint32_t* o = static_cast<uint32_t*>(out);
  zero_skip_zero_kernel<<<zero_blocks, kZeroThreads, 0, s>>>(o, words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles =
      static_cast<unsigned>((words + kDecodeTile - 1) / kDecodeTile);
  zero_skip_scatter_kernel<<<tiles, kDecodeThreads, 0, s>>>(
      static_cast<const uint32_t*>(vals), pos, o, words, log2n);
  return static_cast<int>(cudaGetLastError());
}
