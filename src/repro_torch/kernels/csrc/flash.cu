// flash_attention_fused for Hopper: replaces kernels/flash.py::
// flash_attention_fused (_attn_kernel: one program per (batch x kv head,
// q block), the g = Hq / Hkv query heads of a kv head together, K/V
// streamed in blocks with the online softmax state m, l, acc in f32).
//
// Same function: logits = (q . k) * scale, then the tanh softcap, then
// the masks kv_pos < kv_len, causal kv_pos <= q_offset + s, window
// q_pos - kv_pos < window (masked logits are -1e30, as the reference
// uses); m, l and acc in f32; output acc / max(l, 1e-30) in the input
// type (f32 or bf16), head dim up to 256. The p.v product takes the
// probabilities and values rounded to bf16 and sums in f32, as the
// attention the reference's model runs (models/layers.py::
// flash_attention at its default) does; the Pallas kernel keeps them in
// f32. The row sums l take the unrounded probabilities, as there.
//
// Design. A CTA owns kRows (query, head) rows of one (batch, kv head):
// row r is query s = r / g, head h = r % g, so the g heads that share a
// kv head share every K/V tile, whatever g is (g = 7 included). The Q
// rows and each tile of kKeys keys and values are converted to f32 into
// shared memory (rows padded by one word: no bank conflicts). 256
// threads form a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i
// (i < 4) in both products: keys tx + 16 j of the logits and columns
// tx + 16 c of the output, so each row's running max, sum and scale stay
// in the registers of the 16 lanes of a half warp (shuffle reductions),
// and only the probabilities pass through shared memory between the two
// products. q_offset and kv_len are runtime arguments: a decode step
// passes its cache position with no rebuild. The CTA walks only the key
// tiles that some row of it can see: up to min(Skv, kv_len), up to its
// last query's diagonal when causal, and from its first query's window
// start. A row whose keys are all masked in a tile it does walk behaves
// as in the reference (its weights there are wiped by the first real
// key), so the result is the reference's for every row with a real key.
//
// What bounds it: scalar f32 FMAs fed from shared memory. Each thread
// does 16 FMAs per 8 shared loads in q.k and 64 per 20 in p.v, so the
// shared-memory load rate, not device memory nor the FMA rate, is the
// limit: far from the tensor cores' bf16 rate that the bound counts.
// Tensor-core tiles (mma.sync / wgmma), TMA and splitting long caches
// across CTAs for decode are later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kRows = 64;      // (query, head) rows per CTA
constexpr int kKeys = 64;      // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPerThread = 4;  // rows (and keys) per thread: 64 / 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

constexpr size_t smem_bytes(int hdp) {
  return sizeof(float) *
         (static_cast<size_t>(kRows + 2 * kKeys) * (hdp + 1) +
          static_cast<size_t>(kRows) * (kKeys + 1));
}

// Max over the 16 lanes of a half warp (the lanes that share a row).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q [B, Sq, Hq, hd], k/v [B, Skv, Hkv, hd], out like q; all contiguous.
// HDP: hd rounded up to a power of two >= 16 (the padding is zero).
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int sq, int skv, int hq, int hkv, int hd,
                           float scale, int causal, int window, float cap,
                           int q_offset, int kv_len) {
  constexpr int LD = HDP + 1;
  constexpr int kCols = HDP / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [kRows][LD]
  float* ks = qs + kRows * LD;      // [kKeys][LD]
  float* vs = ks + kKeys * LD;      // [kKeys][LD]
  float* ps = vs + kKeys * LD;      // [kRows][kKeys + 1]

  const int g = hq / hkv;
  const int b = blockIdx.x / hkv;
  const int kvh = blockIdx.x % hkv;
  const long long rows = static_cast<long long>(sq) * g;
  const long long row0 = static_cast<long long>(blockIdx.y) * kRows;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  // this CTA's query rows into shared memory, as f32
  for (int idx = tid; idx < kRows * HDP; idx += kThreads) {
    const int r = idx / HDP, d = idx % HDP;
    const long long row = row0 + r;
    float x = 0.f;
    if (row < rows && d < hd) {
      const long long s = row / g, h = row % g;
      x = to_f32(q[((static_cast<long long>(b) * sq + s) * hq +
                    static_cast<long long>(kvh) * g + h) * hd + d]);
    }
    qs[r * LD + d] = x;
  }

  int q_pos[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i)
    q_pos[i] = q_offset + static_cast<int>((row0 + ty + 16 * i) / g);

  // key tiles that some row of this CTA can see
  const long long last_row = (row0 + kRows < rows ? row0 + kRows : rows) - 1;
  const int s_first = static_cast<int>(row0 / g);
  const int s_last = static_cast<int>(last_row / g);
  int hi = skv < kv_len ? skv : kv_len;
  if (causal && q_offset + s_last + 1 < hi) hi = q_offset + s_last + 1;
  int lo = 0;
  if (window > 0 && q_offset + s_first - window + 1 > lo)
    lo = q_offset + s_first - window + 1;
  const int t_lo = lo / kKeys;
  const int t_hi = hi > lo ? (hi + kKeys - 1) / kKeys : t_lo;

  float m[kPerThread], l[kPerThread], acc[kPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const long long kv_row_stride = static_cast<long long>(hkv) * hd;
  const T* kb = k + (static_cast<long long>(b) * skv * hkv + kvh) * hd;
  const T* vb = v + (static_cast<long long>(b) * skv * hkv + kvh) * hd;

  for (int t = t_lo; t < t_hi; ++t) {
    const int key0 = t * kKeys;
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < kKeys * HDP; idx += kThreads) {
      const int r = idx / HDP, d = idx % HDP;
      const int key = key0 + r;
      float kx = 0.f, vx = 0.f;
      if (key < skv && d < hd) {
        kx = to_f32(kb[key * kv_row_stride + d]);
        vx = round_bf16(to_f32(vb[key * kv_row_stride + d]));
      }
      ks[r * LD + d] = kx;
      vs[r * LD + d] = vx;
    }
    __syncthreads();

    // logits for rows ty + 16 i, keys tx + 16 j
    float s[kPerThread][kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float qv[kPerThread], kv[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) s[i][j] += qv[i] * kv[j];
    }

    // scale, softcap, mask; online softmax per row
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int kv_pos = key0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        bool ok = kv_pos < skv && kv_pos < kv_len;
        if (causal) ok = ok && kv_pos <= q_pos[i];
        if (window > 0) ok = ok && q_pos[i] - kv_pos < window;
        s[i][j] = ok ? x : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        ps[(ty + 16 * i) * (kKeys + 1) + tx + 16 * j] = round_bf16(p);
      }
      l[i] = l[i] * alpha + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p . v for rows ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      float p[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        p[i] = ps[(ty + 16 * i) * (kKeys + 1) + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vx = vs[key * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) acc[i][c] += p[i] * vx;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long row = row0 + ty + 16 * i;
    if (row >= rows) continue;
    const long long s = row / g, h = row % g;
    T* o = out + ((static_cast<long long>(b) * sq + s) * hq +
                  static_cast<long long>(kvh) * g + h) * hd;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) store(o + d, acc[i][c] * inv);
    }
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int sq, int skv, int hq, int hkv, int hd,
                   float scale, int causal, int window, float cap,
                   int q_offset, int kv_len, cudaStream_t stream) {
  auto* kernel = flash_attention_kernel<T, HDP>;
  const size_t bytes = smem_bytes(HDP);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(sq) * (hq / hkv);
  const dim3 grid(static_cast<unsigned>(b * hkv),
                  static_cast<unsigned>((rows + kRows - 1) / kRows));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, hq, hkv, hd,
      scale, causal, window, cap, q_offset, kv_len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      int b, int sq, int skv, int hq, int hkv, int hd,
                      float scale, int causal, int window, float cap,
                      int q_offset, int kv_len, cudaStream_t stream) {
#define REPRO_FLASH_HD(HDP)                                                   \
  if (hd <= HDP)                                                             \
    return launch<T, HDP>(q, k, v, out, b, sq, skv, hq, hkv, hd, scale,      \
                          causal, window, cap, q_offset, kv_len, stream);
  REPRO_FLASH_HD(16)
  REPRO_FLASH_HD(32)
  REPRO_FLASH_HD(64)
  REPRO_FLASH_HD(128)
  REPRO_FLASH_HD(256)
#undef REPRO_FLASH_HD
  return cudaErrorInvalidValue;
}

}  // namespace

// q [b, sq, hq, hd], k/v [b, skv, hkv, hd], out [b, sq, hq, hd], all
// contiguous, f32 (is_bf16 = 0) or bf16 (1); hq a multiple of hkv;
// 1 <= hd <= 256; ceil(sq * hq / hkv / 64) <= 65535. scale: the logit
// scale (1 / sqrt(hd), rounded once from double as the reference does);
// causal: 0/1;
// window <= 0: none; cap <= 0: no softcap; kv_len: keys at positions
// >= kv_len are masked.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int sq,
                                     int skv, int hq, int hkv, int hd,
                                     float scale, int causal, int window,
                                     float cap,
                                     int q_offset, int kv_len, int is_bf16,
                                     void* stream) {
  if (b == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_hd<__nv_bfloat16>(q, k, v, out, b, sq, skv, hq, hkv,
                                         hd, scale, causal, window, cap,
                                         q_offset, kv_len, s)
              : launch_hd<float>(q, k, v, out, b, sq, skv, hq, hkv, hd,
                                 scale, causal, window, cap, q_offset,
                                 kv_len, s);
  return static_cast<int>(err);
}
