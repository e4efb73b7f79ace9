// flash_attention_fused for Hopper: replaces src/repro/kernels/flash.py:92
// (flash_attention_fused; _attn_kernel: one program per (batch x kv
// head, q block), the g = Hq / Hkv query heads of a kv head together,
// K/V streamed in blocks with the online softmax state m, l, acc in f32).
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
// Rows. Every route flattens (query, head) pairs of one (batch, kv head)
// into rows r = s * g + h, so the g heads that share a kv head share
// every K/V tile, whatever g is (1, 2, 7, 16). q_offset and kv_len are
// runtime arguments: a decode step passes its cache position with no
// rebuild and no host synchronisation. The caller names the route; this
// file launches it or returns an error, never another route.
//
// Route tc_prefill (bf16, more than 16 rows per (batch, kv head)): what
// bounds it on the H100 is operations (4 * hd flops per visible
// (query, key) pair against a few bytes a pair). So both products run
// on the tensor cores through wgmma (flash_wgmma.cuh), bf16 in and f32
// accumulate: a CTA of two warpgroups owns 128 rows, 64 a warpgroup.
// Its Q tile is loaded once as bf16; K and V stream as bf16 tiles of 64
// keys through a two-stage cp.async ring (16 bytes a thread), so tile
// t + 1 loads while tile t computes; all three live in shared memory in
// the 128-byte swizzle that wgmma's descriptors read (where a row does
// not start on 16 bytes, a head dim that is not a multiple of 8 or a
// tensor off a 16-byte boundary, the same tiles are filled element by
// element: the instantiation VEC = false). S = Q . K^T is
// wgmma m64n64k16 with both operands in shared memory; the logits stay
// in registers (scale, softcap, masks only on tiles that cross an edge,
// online softmax with ex2), are rounded to bf16 in registers and feed
// O += P . V as wgmma's register A operand against V in shared memory
// (m64n{64,128,256}k16, V transposed by the descriptor). At hd 256: Q
// 64 KB + 2 x (K + V) 128 KB of shared memory, 128 accumulator
// registers a thread. The CTA walks only the key tiles some row of it
// can see; a warpgroup skips a tile none of its rows sees; the heaviest
// causal row blocks launch first. What is left: the two warpgroups run
// in step (one barrier a tile), so the softmax does not overlap the
// products; a producer warp with TMA and a ping-pong between the
// warpgroups is the next step.
//
// Route split_decode (flash_decode.cu) takes bf16 calls of at most 16
// rows per (batch, kv head); route scalar_f32 (below) takes f32.
//
// Route scalar_f32, the kernel of the first port, for f32 inputs only
// (TF32 tensor cores would not hold the 5e-3 f32 check). A CTA owns 64
// rows. The Q rows and each tile of kKeys keys and values are converted
// to f32 into shared memory (rows padded by one word: no bank
// conflicts). 256 threads form a 16 x 16 grid; thread (ty, tx) owns
// rows ty + 16 i (i < 4) in both products: keys tx + 16 j of the logits
// and columns tx + 16 c of the output, so each row's running max, sum
// and scale stay in the registers of the 16 lanes of a half warp
// (shuffle reductions), and only the probabilities pass through shared
// memory between the two products. It walks the same key tiles. A row
// whose keys are all masked in a tile it does walk behaves as in the
// reference (its weights there are wiped by the first real key), so
// every route's result is the reference's for every row with a real
// key. What bounds it: scalar f32 FMAs fed from shared memory (16 FMAs
// per 8 shared loads in q.k, 64 per 20 in p.v).
#include <cuda_bf16.h>
#include <limits.h>

#include "common.cuh"
#include "flash_tiles.cuh"
#include "flash_wgmma.cuh"

namespace {

constexpr int kRows = 64;      // (query, head) rows per CTA
constexpr int kKeys = 64;      // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPerThread = 4;  // rows (and keys) per thread: 64 / 16
using repro_flash::kNegInf;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// f32 q [B, Sq, Hq, hd], k/v [B, Skv, Hkv, hd], out like q; all
// contiguous. HDP: hd rounded up to a power of two >= 16 (the padding is
// zero).
template <int HDP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const repro_flash::Params prm) {
  const float* __restrict__ q = static_cast<const float*>(prm.q);
  const float* __restrict__ k = static_cast<const float*>(prm.k);
  const float* __restrict__ v = static_cast<const float*>(prm.v);
  float* __restrict__ out = static_cast<float*>(prm.out);
  const int sq = prm.sq, skv = prm.skv, hq = prm.hq, hkv = prm.hkv,
            hd = prm.hd;
  const float scale = prm.scale, cap = prm.cap;
  const int causal = prm.causal, window = prm.window,
            q_offset = prm.q_offset, kv_len = prm.kv_len;
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
      x = q[((static_cast<long long>(b) * sq + s) * hq +
             static_cast<long long>(kvh) * g + h) * hd + d];
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
  const float* kb = k + (static_cast<long long>(b) * skv * hkv + kvh) * hd;
  const float* vb = v + (static_cast<long long>(b) * skv * hkv + kvh) * hd;

  for (int t = t_lo; t < t_hi; ++t) {
    const int key0 = t * kKeys;
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < kKeys * HDP; idx += kThreads) {
      const int r = idx / HDP, d = idx % HDP;
      const int key = key0 + r;
      float kx = 0.f, vx = 0.f;
      if (key < skv && d < hd) {
        kx = kb[key * kv_row_stride + d];
        vx = round_bf16(vb[key * kv_row_stride + d]);
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
    float* o = out + ((static_cast<long long>(b) * sq + s) * hq +
                      static_cast<long long>(kvh) * g + h) * hd;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) o[d] = acc[i][c] * inv;
    }
  }
}

template <int HDP>
cudaError_t launch_scalar(const repro_flash::Params& p, cudaStream_t stream) {
  auto* kernel = flash_attention_kernel<HDP>;
  const size_t bytes = smem_bytes(HDP);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(p.sq) * (p.hq / p.hkv);
  const dim3 grid(static_cast<unsigned>(p.b * p.hkv),
                  static_cast<unsigned>((rows + kRows - 1) / kRows));
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_scalar_f32(const repro_flash::Params& p,
                              cudaStream_t stream) {
  if (p.hd < 1) return cudaErrorInvalidValue;
#define REPRO_FLASH_HD(HDP) \
  if (p.hd <= HDP) return launch_scalar<HDP>(p, stream);
  REPRO_FLASH_HD(16)
  REPRO_FLASH_HD(32)
  REPRO_FLASH_HD(64)
  REPRO_FLASH_HD(128)
  REPRO_FLASH_HD(256)
#undef REPRO_FLASH_HD
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------- tc_prefill

template <int HDP>
struct TcTile {
  static constexpr int kGroups = 2;            // warpgroups, 64 rows each
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kRows = 64 * kGroups;   // (query, head) rows a CTA
  static constexpr int kKeys = 64;             // keys a tile
  static constexpr uint32_t kQBytes = kRows * HDP * 2;
  static constexpr uint32_t kTileBytes = kKeys * HDP * 2;   // K or V
  // Q, 2 stages of (K, V), and room to align the tiles to 1024 bytes
  static constexpr size_t kSmem = kQBytes + 4 * kTileBytes + 1024;
};

// VEC: rows_aligned16 (the tiles load by cp.async), else element-wise.
template <int HDP, bool VEC>
__global__ void __launch_bounds__(TcTile<HDP>::kThreads, 1)
    flash_tc_prefill_kernel(const repro_flash::Params p) {
  using C = TcTile<HDP>;
  using namespace repro_flash;
  extern __shared__ __align__(1024) unsigned char tile_smem[];
  const auto* q = static_cast<const __nv_bfloat16*>(p.q);
  const auto* k = static_cast<const __nv_bfloat16*>(p.k);
  const auto* v = static_cast<const __nv_bfloat16*>(p.v);
  auto* out = static_cast<__nv_bfloat16*>(p.out);

  const int g = p.hq / p.hkv;
  const long long rows = static_cast<long long>(p.sq) * g;
  const int n_rb = static_cast<int>((rows + C::kRows - 1) / C::kRows);
  const int heads = p.b * p.hkv;
  const int rb = n_rb - 1 - static_cast<int>(blockIdx.x / heads);
  const int bh = static_cast<int>(blockIdx.x % heads);
  const int b = bh / p.hkv, kvh = bh % p.hkv;
  const long long row0 = static_cast<long long>(rb) * C::kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp >> 2;   // this thread's warpgroup
  const uint32_t q_tile = (smem_u32(tile_smem) + 1023u) & ~1023u;
  const uint32_t kv_base = q_tile + C::kQBytes;

  // key tiles that some row of this CTA can see
  const int key_end = min(p.skv, p.kv_len);
  const long long last_row = min(row0 + C::kRows, rows) - 1;
  const int s_first = static_cast<int>(row0 / g);
  const int s_last = static_cast<int>(last_row / g);
  int hi = key_end;
  if (p.causal) hi = min(hi, p.q_offset + s_last + 1);
  int lo = 0;
  if (p.window > 0) lo = max(lo, p.q_offset + s_first - p.window + 1);
  const int t_lo = lo / C::kKeys;
  const int t_hi = hi > lo ? (hi + C::kKeys - 1) / C::kKeys : t_lo;

  const long long stride = static_cast<long long>(p.hkv) * p.hd;
  const __nv_bfloat16* kb =
      k + (static_cast<long long>(b) * p.skv * p.hkv + kvh) * p.hd;
  const __nv_bfloat16* vb =
      v + (static_cast<long long>(b) * p.skv * p.hkv + kvh) * p.hd;
  auto load_tile = [&](int t, uint32_t dst) {
    load_kv_tile<HDP, C::kKeys, C::kThreads, VEC>(
        dst, kb, stride, t * C::kKeys, key_end, p.hd, tid);
    load_kv_tile<HDP, C::kKeys, C::kThreads, VEC>(
        dst + C::kTileBytes, vb, stride, t * C::kKeys, key_end, p.hd, tid);
  };
  load_q_tile<HDP, C::kRows, C::kThreads, VEC>(q_tile, q, p, b, kvh, row0,
                                               rows, tid);
  if (t_lo < t_hi) load_tile(t_lo, kv_base);
  cp_async_commit();

  // this warpgroup's 64 rows (a tile none of them sees is skipped), this
  // warp's 16 (a tile all of them see whole is not masked) and this
  // thread's two (lane / 4 and lane / 4 + 8)
  const long long g_row0 = row0 + grp * 64;
  const bool g_live = g_row0 < rows;
  const long long g_last = min(g_row0 + 63, rows - 1);
  const int gs_first = static_cast<int>(g_row0 / g);
  const int gs_last = static_cast<int>(g_last / g);
  const long long w_row0 = row0 + warp * 16;
  const long long w_last = min(w_row0 + 15, rows - 1);
  const int ws_first = static_cast<int>(min(w_row0, rows - 1) / g);
  const int ws_last = static_cast<int>(w_last / g);
  const int qpos[2] = {
      p.q_offset + static_cast<int>((w_row0 + (lane >> 2)) / g),
      p.q_offset + static_cast<int>((w_row0 + (lane >> 2) + 8) / g)};

  // descriptors: Q rows of this warpgroup, K (both K-major: head dim
  // contiguous) and V (MN-major: its head dim is the product's N)
  const uint32_t q_rows = q_tile + grp * 64 * 128;
  constexpr uint32_t kPanelQ = C::kRows * 128, kPanelKV = C::kKeys * 128;

  float o[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = t_lo; t < t_hi; ++t) {
    const uint32_t k_tile = kv_base + ((t - t_lo) & 1) * 2 * C::kTileBytes;
    const uint32_t v_tile = k_tile + C::kTileBytes;
    if (t + 1 < t_hi) {
      load_tile(t + 1, kv_base + ((t + 1 - t_lo) & 1) * 2 * C::kTileBytes);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const int key0 = t * C::kKeys;
    const int key_last = key0 + C::kKeys - 1;
    const bool seen = g_live &&
                      (!p.causal || key0 <= p.q_offset + gs_last) &&
                      (p.window <= 0 ||
                       key_last > p.q_offset + gs_first - p.window);
    if (seen) {
      float s[C::kKeys / 8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kPanelQ + (kk & 3) * 32;
        const uint32_t koff = (kk >> 2) * kPanelKV + (kk & 3) * 32;
        wgmma_m64n64_ss(s, gmma_desc(q_rows + off, 16, 1024),
                        gmma_desc(k_tile + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      const bool masked =
          key_last >= key_end ||
          (p.causal && key_last > p.q_offset + ws_first) ||
          (p.window > 0 && key0 <= p.q_offset + ws_last - p.window);
      softmax_tile<HDP, C::kKeys>(s, o, m, l, p, masked, qpos, key0,
                                  key_end, lane);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::kKeys / 16; ++ks) {
        uint32_t a[4];
        p_operand<C::kKeys>(a, s, ks);
        wgmma_rs<HDP>(o, a, gmma_desc(v_tile + ks * 16 * 128, kPanelKV,
                                      1024));
      }
      wgmma_commit();
      wgmma_wait_all();
    }
    __syncthreads();   // the stage is free for the load of tile t + 2
  }
  cp_async_wait<0>();

  const float inv[2] = {1.f / fmaxf(quad_sum(l[0]), 1e-30f),
                        1.f / fmaxf(quad_sum(l[1]), 1e-30f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = w_row0 + (lane >> 2) + 8 * i;
    if (row >= rows) continue;
    const long long s = row / g, h = row % g;
    __nv_bfloat16* o_row =
        out + ((static_cast<long long>(b) * p.sq + s) * p.hq +
               static_cast<long long>(kvh) * g + h) * p.hd;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      if (d >= p.hd) continue;
      const float x0 = o[n][2 * i] * inv[i], x1 = o[n][2 * i + 1] * inv[i];
      if constexpr (VEC) {
        *reinterpret_cast<__nv_bfloat162*>(o_row + d) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        o_row[d] = __float2bfloat16_rn(x0);
        if (d + 1 < p.hd) o_row[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int HDP, bool VEC>
cudaError_t launch_tc(const repro_flash::Params& p, cudaStream_t stream) {
  using C = TcTile<HDP>;
  auto* kernel = flash_tc_prefill_kernel<HDP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(p.sq) * (p.hq / p.hkv);
  const long long ctas = static_cast<long long>(p.b) * p.hkv *
                         ((rows + C::kRows - 1) / C::kRows);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(ctas), C::kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_tc_hd(const repro_flash::Params& p, cudaStream_t stream) {
  if (p.hd <= 64) return launch_tc<64, VEC>(p, stream);
  if (p.hd <= 128) return launch_tc<128, VEC>(p, stream);
  return launch_tc<256, VEC>(p, stream);
}

cudaError_t launch_tc_prefill(const repro_flash::Params& p,
                              cudaStream_t stream) {
  if (p.hd < 1 || p.hd > 256) return cudaErrorInvalidValue;
  return repro_flash::rows_aligned16(p) ? launch_tc_hd<true>(p, stream)
                                        : launch_tc_hd<false>(p, stream);
}

}  // namespace

namespace repro_flash {
// flash_decode.cu
cudaError_t launch_split_decode(const Params& p, cudaStream_t stream);
}  // namespace repro_flash

// q [b, sq, hq, hd], k/v [b, skv, hkv, hd], out [b, sq, hq, hd], all
// contiguous; hq a multiple of hkv; 1 <= hd <= 256. route: 0 =
// scalar_f32 (f32, ceil(sq * hq / hkv / 64) <= 65535), 1 = tc_prefill
// (bf16), 2 = split_decode (bf16, sq * hq / hkv <= 16, n_chunks >= 1
// and scratch of b * hkv * n_chunks * sq * (hq / hkv) * (hd + 2)
// floats). The bf16 routes take any alignment: rows that do not all
// start on 16 bytes load element by element. scale: the
// logit scale (1 / sqrt(hd), rounded once from double as the reference
// does); causal: 0/1; window <= 0: none; cap <= 0: no softcap; kv_len:
// keys at positions >= kv_len are masked. Returns a CUDA error code; an
// unknown route or a shape it does not take is cudaErrorInvalidValue.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* scratch,
                                     int b, int sq, int skv, int hq, int hkv,
                                     int hd, float scale, int causal,
                                     int window, float cap, int q_offset,
                                     int kv_len, int route, int n_chunks,
                                     void* stream) {
  if (b == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro_flash::Params p{q,     k,      v,        out,
                              static_cast<float*>(scratch),
                              b,     sq,     skv,      hq,     hkv,  hd,
                              scale, cap,    causal,   window, q_offset,
                              kv_len, n_chunks};
  cudaError_t err = cudaErrorInvalidValue;
  switch (route) {
    case 0:
      err = launch_scalar_f32(p, s);
      break;
    case 1:
      err = launch_tc_prefill(p, s);
      break;
    case 2:
      err = repro_flash::launch_split_decode(p, s);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}
