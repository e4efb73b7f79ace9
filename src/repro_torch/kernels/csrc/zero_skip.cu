// zero_skip_encode / zero_skip_decode for Hopper: replace
// kernels/fused_round.py::zero_skip_encode and ::zero_skip_decode (the
// rle codec's wire on the slow hop; per row the TPU kernels hold the whole
// row in VMEM, run a Hillis-Steele scan of the nonzero flags and scatter).
//
// encode: per [rows, n] row, the nonzero words (data != 0 in the payload's
// own type: for float32 -0.0 is zero and NaN is not) compacted to the
// front in position order, their positions beside them, (0, -1) behind.
// decode: the inverse, out[row, pos] = val where 0 <= pos < n, zeros
// elsewhere.
//
// Design. A row of 131072 or 262144 words (512 KiB, 1 MiB) does not fit a
// block's 227 KB of shared memory, so one CTA walks its row in tiles of
// kItems * blockDim words with a running count carried across tiles. In a
// tile, thread t loads words base + j * blockDim + t (coalesced) for
// j < kItems; a warp ballot per j gives each word its rank inside its warp
// and the warp's count, and one scan over the warps of each j (warp
// shuffles) plus a serial sum over the kItems totals gives every nonzero
// its output slot: carry + earlier items + earlier warps + earlier lanes.
// Slots follow positions, so the result equals the stable partition of
// the plain version. Words are moved as raw bits; only the zero test reads
// them as float. decode zeroes its row, then (after a barrier) each thread
// scatters its (val, pos) pairs; an encoded wire has no duplicate
// positions, so the order of the stores does not matter.
//
// What bounds them: device memory. encode reads n words and writes 2n,
// decode reads 2n and writes n (plus the zeroing pass, n more). Three
// barriers per tile of 4096 words; one CTA per row, with 16384 rows on the
// two-phase wire and 16 on a read's windows (where most SMs idle).
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

__global__ void zero_skip_decode_kernel(const uint32_t* __restrict__ vals,
                                        const int* __restrict__ pos,
                                        uint32_t* __restrict__ out, int n) {
  const long long row = static_cast<long long>(blockIdx.x) * n;
  uint32_t* o = out + row;
  for (int e = threadIdx.x; e < n; e += blockDim.x) o[e] = 0u;
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int p = pos[row + e];
    if (p >= 0 && p < n) o[p] = vals[row + e];
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

// vals, out: 4-byte words [rows, n]; pos: int32 [rows, n], -1 = no slot.
extern "C" int repro_zero_skip_decode(const void* vals, const int* pos,
                                      void* out, int rows, int n,
                                      void* stream) {
  if (rows == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  zero_skip_decode_kernel<<<rows, repro::row_threads(n), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vals), pos, static_cast<uint32_t*>(out),
      n);
  return static_cast<int>(cudaGetLastError());
}
