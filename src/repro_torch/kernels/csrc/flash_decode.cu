// Route split_decode of flash_attention_fused: replaces
// src/repro/kernels/flash.py:92 (flash_attention_fused) for bf16 calls
// of at most 16 (query, head) rows per (batch, kv head): decode steps
// (sq = 1, or a few queries) over a long KV cache. Same function and
// rows as flash.cu's routes (see there).
//
// What bounds it on the H100: bytes. Each visible key is read once, hd
// bf16 of K and of V, for about 2 * rows flops a byte, far below the
// card's 295 flops a byte. One CTA per (batch, kv head), as the first
// port had, leaves the card empty at batch 1 (8 CTAs on 132 SMs, each
// walking the cache alone), so the visible key range [lo, hi) of each
// (batch, kv head) is cut into n_chunks chunks of whole 64-key tiles.
// n_chunks depends on shapes only (kernels/flash.py: about two CTAs per
// SM), and lo and hi come from q_offset and kv_len in the kernel, so a
// decode step needs no host synchronisation and a CUDA graph could
// capture it.
//
// Pass 1 (flash_split_decode_kernel): a CTA of 4 warps reads its chunk
// once, K and V as bf16 tiles of 64 keys through a two-stage cp.async
// ring (16 bytes a thread; element by element where a row does not
// start on 16 bytes, as in flash.cu). The products run on the tensor
// cores as mma.sync m16n8k16 from ldmatrix (flash_mma.cuh; 16 rows are
// one mma tile, too few for wgmma's 64). Every warp computes the logits
// of all (up to 16) rows over the tile's 64 keys and the same online
// softmax, and warp w accumulates head-dim columns [w hd / 4, (w + 1)
// hd / 4) of p.v: the four warps share m and l, so they write one
// partial (m, l, acc) in f32 per row with no merge between them, to
// scratch [b * hkv, n_chunks, rows, hd] (acc) and [b * hkv, n_chunks,
// rows, 2] (m, l).
// The repeated q.k costs shared-memory reads, not device memory. A
// chunk with no visible key writes m = -1e30, l = 0, acc = 0.
// Pass 2 (flash_split_merge_kernel): one CTA per row, one thread per
// column, merges the chunks: m = max m_c, l = sum l_c e^(m_c - m),
// out = sum acc_c e^(m_c - m) / l.
// A chunk whose row saw only masked keys carries m = -1e30 and drops out.
//
// The f32 p.v variant (PV32, REPRO_PERF_OPTS=0): the values are bf16
// already, so only p needs more bits: each 16-key step multiplies V's
// fragments by bf16(p) and by bf16(p - bf16(p)) (flash_mma.cuh's
// pv_k16_hilo), which carries p to about 2^-17 relative, against the
// bf16 output's 2^-9. Twice the p.v products; the bytes, which bound
// the route, do not change.
#include <cuda_bf16.h>
#include <limits.h>

#include "flash_mma.cuh"
#include "flash_tiles.cuh"

namespace repro_flash {
namespace {

constexpr int kMaxRows = 16;   // rows per (batch, kv head): one mma tile
constexpr int kWarps = 4;     // each a quarter of the head dim in p.v
constexpr int kKeys = 64;     // keys a tile

// s = Q . K^T for the 16 rows of the Q tile and the kKeys keys of the
// K tile, from ldmatrix.
template <int HDP>
__device__ __forceinline__ void qk_rows(float (&s)[kKeys / 8][4],
                                        uint32_t q_tile, uint32_t k_tile,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(q_tile + tile_off<kMaxRows>(lane & 15, kk * 2 + (lane >> 4)),
            a[0], a[1], a[2], a[3]);
#pragma unroll
    for (int np = 0; np < kKeys / 16; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(k_tile + tile_off<kKeys>(np * 16 + (lane >> 4) * 8 + (lane & 7),
                                       kk * 2 + ((lane >> 3) & 1)),
              b0, b1, b2, b3);
      mma_bf16(s[2 * np], a, b0, b1);
      mma_bf16(s[2 * np + 1], a, b2, b3);
    }
  }
}

template <int HDP>
struct SplitTile {
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kCols = HDP / kWarps;   // p.v columns a warp
  static constexpr uint32_t kQBytes = kMaxRows * HDP * 2;
  static constexpr uint32_t kTileBytes = kKeys * HDP * 2;   // K or V
  static constexpr size_t kSmem = kQBytes + 4 * kTileBytes;  // 2 stages
};

// VEC: rows_aligned16 (the tiles load by cp.async), else element-wise;
// PV32: the f32 p.v variant.
template <int HDP, bool VEC, bool PV32>
__global__ void __launch_bounds__(SplitTile<HDP>::kThreads)
    flash_split_decode_kernel(const Params p) {
  using C = SplitTile<HDP>;
  extern __shared__ __align__(128) unsigned char tile_smem[];
  const auto* q = static_cast<const __nv_bfloat16*>(p.q);
  const auto* k = static_cast<const __nv_bfloat16*>(p.k);
  const auto* v = static_cast<const __nv_bfloat16*>(p.v);

  const int g = p.hq / p.hkv;
  const int rows = p.sq * g;
  const int bh = static_cast<int>(blockIdx.x / p.n_chunks);
  const int chunk = static_cast<int>(blockIdx.x % p.n_chunks);
  const int b = bh / p.hkv, kvh = bh % p.hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t q_tile = smem_u32(tile_smem);
  const uint32_t kv_base = q_tile + C::kQBytes;

  // the keys some row sees, [lo, hi), cut into n_chunks whole-tile chunks
  const int key_end = min(p.skv, p.kv_len);
  int hi = key_end;
  if (p.causal) hi = min(hi, p.q_offset + p.sq);
  const int lo = p.window > 0 ? max(0, p.q_offset - p.window + 1) : 0;
  const int span = max(hi - lo, 0);
  const int per = ((span + p.n_chunks - 1) / p.n_chunks + kKeys - 1) /
                  kKeys * kKeys;
  const int c_lo = lo + chunk * per;
  const int c_hi = min(hi, c_lo + per);
  const int n_tiles = c_hi > c_lo ? (c_hi - c_lo + kKeys - 1) / kKeys
                                  : 0;

  const long long stride = static_cast<long long>(p.hkv) * p.hd;
  const __nv_bfloat16* kb =
      k + (static_cast<long long>(b) * p.skv * p.hkv + kvh) * p.hd;
  const __nv_bfloat16* vb =
      v + (static_cast<long long>(b) * p.skv * p.hkv + kvh) * p.hd;
  auto load_tile = [&](int t, uint32_t dst) {
    const int key0 = c_lo + t * kKeys;
    load_kv_tile<HDP, kKeys, C::kThreads, VEC>(dst, kb, stride, key0, c_hi,
                                               p.hd, tid);
    load_kv_tile<HDP, kKeys, C::kThreads, VEC>(dst + C::kTileBytes, vb,
                                               stride, key0, c_hi, p.hd, tid);
  };
  load_q_tile<HDP, kMaxRows, C::kThreads, VEC>(q_tile, q, p, b, kvh, 0, rows,
                                               tid);
  if (n_tiles > 0) load_tile(0, kv_base);
  cp_async_commit();

  const int qpos[2] = {p.q_offset + (lane >> 2) / g,
                       p.q_offset + ((lane >> 2) + 8) / g};
  const int col0 = warp * C::kCols;   // this warp's p.v columns
  float o[C::kCols / 8][4];
#pragma unroll
  for (int n = 0; n < C::kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t stage = kv_base + (t & 1) * 2 * C::kTileBytes;
    if (t + 1 < n_tiles) {
      load_tile(t + 1, kv_base + ((t + 1) & 1) * 2 * C::kTileBytes);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int key0 = c_lo + t * kKeys;
    const int key_last = key0 + kKeys - 1;
    const bool masked =
        key_last >= c_hi || (p.causal && key_last > p.q_offset) ||
        (p.window > 0 && key0 <= p.q_offset + p.sq - 1 - p.window);
    float s[kKeys / 8][4];
    qk_rows<HDP>(s, q_tile, stage, lane);
    softmax_tile<C::kCols, kKeys>(s, o, m, l, p, masked, qpos, key0, c_hi,
                                  lane);
    pv_cols<kKeys, C::kCols, PV32>(o, s, stage + C::kTileBytes, col0,
                                   lane);
    __syncthreads();   // the stage is free for the load of tile t + 2
  }
  cp_async_wait<0>();

  // this chunk's partial: every warp its columns; warp 0 m and l
  const long long part = static_cast<long long>(bh) * p.n_chunks + chunk;
  float* acc_out = p.scratch + part * rows * p.hd;
  float* ml_out = p.scratch +
                  static_cast<long long>(p.b) * p.hkv * p.n_chunks * rows *
                      p.hd +
                  part * rows * 2;
  const float lsum[2] = {quad_sum(l[0]), quad_sum(l[1])};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (lane >> 2) + 8 * i;
    if (r >= rows) continue;
    if (warp == 0 && (lane & 3) == 0) {
      ml_out[r * 2] = m[i];
      ml_out[r * 2 + 1] = lsum[i];
    }
#pragma unroll
    for (int n = 0; n < C::kCols / 8; ++n) {
      const int d = col0 + n * 8 + (lane & 3) * 2;
      if (d < p.hd) acc_out[r * p.hd + d] = o[n][2 * i];
      if (d + 1 < p.hd) acc_out[r * p.hd + d + 1] = o[n][2 * i + 1];
    }
  }
}

constexpr int kMergeThreads = 256;   // one thread a column (hd <= 256)

// One CTA a row: the chunks' weights e^(m_c - m) and sums l_c once
// into shared memory, then each thread sums its column over the chunks,
// eight loads in flight.
__global__ void __launch_bounds__(kMergeThreads)
    flash_split_merge_kernel(const Params p) {
  extern __shared__ float weight[];   // [n_chunks], then l [n_chunks]
  const int g = p.hq / p.hkv;
  const int rows = p.sq * g;
  const int bh = static_cast<int>(blockIdx.x / rows);
  const int r = static_cast<int>(blockIdx.x % rows);
  const int b = bh / p.hkv, kvh = bh % p.hkv;
  const long long part0 = static_cast<long long>(bh) * p.n_chunks;
  const float* acc = p.scratch + (part0 * rows + r) * p.hd;
  const float* ml = p.scratch +
                    static_cast<long long>(p.b) * p.hkv * p.n_chunks * rows *
                        p.hd +
                    (part0 * rows + r) * 2;
  const long long acc_stride = static_cast<long long>(rows) * p.hd;
  float* lsum = weight + p.n_chunks;
  for (int c = threadIdx.x; c < p.n_chunks; c += kMergeThreads) {
    weight[c] = ml[c * rows * 2];
    lsum[c] = ml[c * rows * 2 + 1];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int c = 0; c < p.n_chunks; ++c) mx = fmaxf(mx, weight[c]);
  __syncthreads();
  for (int c = threadIdx.x; c < p.n_chunks; c += kMergeThreads)
    weight[c] = exp2f((weight[c] - mx) * kLog2e);
  __syncthreads();
  float lt = 0.f;
  for (int c = 0; c < p.n_chunks; ++c) lt += lsum[c] * weight[c];
  const float inv = 1.f / fmaxf(lt, 1e-30f);
  const int d = threadIdx.x;
  if (d >= p.hd) return;
  float a = 0.f;
#pragma unroll 8
  for (int c = 0; c < p.n_chunks; ++c)
    a += acc[c * acc_stride + d] * weight[c];
  const long long s = r / g, h = r % g;
  auto* out = static_cast<__nv_bfloat16*>(p.out) +
              ((static_cast<long long>(b) * p.sq + s) * p.hq +
               static_cast<long long>(kvh) * g + h) * p.hd;
  out[d] = __float2bfloat16_rn(a * inv);
}

template <int HDP, bool VEC, bool PV32>
cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  using C = SplitTile<HDP>;
  auto* kernel = flash_split_decode_kernel<HDP, VEC, PV32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const long long heads = static_cast<long long>(p.b) * p.hkv;
  const long long rows = static_cast<long long>(p.sq) * (p.hq / p.hkv);
  if (heads * p.n_chunks > INT_MAX || heads * rows > INT_MAX)
    return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(heads * p.n_chunks), C::kThreads, C::kSmem,
           stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_split_merge_kernel<<<static_cast<unsigned>(heads * rows),
                             kMergeThreads, 2 * p.n_chunks * sizeof(float),
                             stream>>>(p);
  return cudaGetLastError();
}

template <bool VEC, bool PV32>
cudaError_t launch_split_hd(const Params& p, cudaStream_t stream) {
  if (p.hd <= 64) return launch_split<64, VEC, PV32>(p, stream);
  if (p.hd <= 128) return launch_split<128, VEC, PV32>(p, stream);
  return launch_split<256, VEC, PV32>(p, stream);
}

template <bool PV32>
cudaError_t launch_split_variant(const Params& p, cudaStream_t stream) {
  return rows_aligned16(p) ? launch_split_hd<true, PV32>(p, stream)
                           : launch_split_hd<false, PV32>(p, stream);
}

}  // namespace

cudaError_t launch_split_decode(const Params& p, cudaStream_t stream) {
  if (p.hd < 1 || p.hd > 256 || p.n_chunks < 1 || p.scratch == nullptr ||
      static_cast<long long>(p.sq) * (p.hq / p.hkv) > kMaxRows)
    return cudaErrorInvalidValue;
  return p.pv32 ? launch_split_variant<true>(p, stream)
                : launch_split_variant<false>(p, stream);
}

}  // namespace repro_flash
