// flash_attention_bwd for Hopper: the gradient of flash_attention_fused
// (flash.cu) with respect to q, k and v. The reference has no Pallas
// backward: its training gradient is XLA's autodiff of the model's
// attention (src/repro/models/layers.py:112, flash_attention at its
// default). This file computes that autodiff's function:
//
//   x = (q . k) * scale, softcapped c = cap * tanh(x / cap), masked;
//   p~ = exp(c - m) with m the row's max over its visible keys,
//   l = sum p~, out = sum bf16(p~) bf16(v) / l;
//   dO' = dout / l, D = sum_d dO' * out (the gradient through l);
//   dP = bf16(dO' . bf16(v)), g = p~ (dP - D), dm = -sum_keys g;
//   dS = (g + [key = argmax] dm) (1 - tanh^2(x / cap));
//   dq = scale * sum_keys dS k, dk = scale * sum_rows dS q,
//   dv = bf16(sum_rows bf16(p~) dO').
//
// The bf16 roundings are those autograd makes through the model's
// `probs.to(bf16).float()` and `v.to(bf16).float()`: the gradient of a
// bf16 operand is rounded to bf16, element by element for dP and once a
// key for dv. dm is the gradient autograd sends through the row max
// (`exp(logits - max)`): zero in exact arithmetic, not once dP is
// rounded; it lands on the row's first argmax key (autograd splits it
// among tied keys). Masked (query, key) pairs (kv_len, causal, window,
// keys past Skv) get no gradient; a row with no visible key gets none
// either. The plain version's rows of more than 4096 keys take their
// max a chunk at a time, so there dm splits over the chunks' maxima.
//
// The f32 p.v variant (PV32: the gradient of the forward's variant, the
// model's attention under REPRO_PERF_OPTS=0) rounds nothing to bf16:
// out = sum p~ v / l, so dP = dO' . v, dv = sum_rows p~ dO', and dm is
// zero but for rounding (no bf16(dP) makes it otherwise). dP's v is
// split like dO' for f32 inputs (exact for bf16), dv's p~ is split for
// bf16 inputs (f32 inputs keep the FMA chain, of the unrounded p~), and
// V is not rounded in shared memory. The dq and dk/dv kernels are
// instantiated apart for it; the stats pass is the same.
//
// What bounds it. Five products of hd a visible pair (S, dP, dv, dk, dq)
// make it bound by operations on this card (0.69 ms at TF32's 495
// TFLOP/s at the training shape, 5.1 ms at the f32 cores' 67). The f32
// check holds it to the plain backward (relative L2 1e-4), and TF32
// alone (10 mantissa bits) misses that by 10x, so the tensor cores run
// split products ("3xTF32", CUTLASS's OpMultiplyAddFastF32): an f32
// operand x is hi = rna_tf32(x) plus lo = rna_tf32(x - hi)
// (cvt.rna.tf32.f32: to nearest, ties away), and a . b = a_lo b_hi +
// a_hi b_lo + a_hi b_hi. Each product of two TF32 numbers is exact in
// f32; the dropped a_lo b_lo and lo's own rounding leave about 2^-21
// (5e-7) of a term, against f32's 2^-24. An operand that is bf16 already
// (bf16(v), bf16(p~), q and k of bf16 inputs) is exact in TF32: its lo is
// zero and its term is not issued.
//
// The check does not measure accuracy, though: it measures closeness to
// the plain version's f32 roundings, because the gradient rounds each
// bf16(p~) and dP to bf16, and logits a few f32 ulps off the plain
// version's move some of those roundings to the other neighbour. At head
// dim 256 even exact logits and products miss its relative L2 limit
// (tests/test_torch_attention_grad.py, on the CPU). So for f32 inputs
// the logits are FMA chains over the head dim in index order, as
// cuBLAS's f32 product (the plain version's) sums them at the plain
// version's shapes, scaled and softcapped with each operation rounded
// on its own and the cap's reciprocal as PyTorch divides by a scalar:
// the kernel is tied to that summation order. And the tensor cores add
// as FMAs do not: an mma aligns its products to the largest addend and
// truncates, so each k-step's chain here starts from zero and is added
// into f32 with round-to-nearest adds (one chain a tile missed the check
// 1.6x to 4.4x on the card). dv, rounded to bf16 at the end, is for f32
// inputs an FMA chain over the rows in order, which is how cuBLAS sums
// the plain dv: given the same p~ and dO' the card gives the plain dv
// bit for bit (on the tensor cores it read 8.4e-5 at the training
// shape, by FMAs 2.5e-5). l is the sum of the very p~ = exp(x - m) the
// later passes use, in f64, rounded once: a sum against a running max,
// rescaled, left dO' a few ulps off in half its elements, and one dv
// element 1e-7 from a bf16 midpoint then rounded the other way.
// The FMA logits were the pace: the stats pass keeps each pair's q . k
// (f32, `dots`: 1.07 GB at the training shape, written once and read
// three times, about 1 ms of traffic against 3.5 ms a recomputation),
// and its second sweep, dq and dk/dv read it; past the wrapper's byte
// budget `dots` is null and each pass recomputes it, with the same
// bits. Products a pair: f32 on the tensor cores dP 2 + 2 (two passes),
// dk 3, dq 3, by FMAs S 1 (4 without `dots`), dv 1; bf16 all on the
// tensor cores: S 1 (4), dP 2 + 2, dv 2, dk 2, dq 2.
//
// The route is mma.sync.m16n8k8 TF32 from shared memory, not wgmma:
// wgmma takes TF32 operands only K-major from shared memory, so dv, dk
// and dq (whose reduction runs over rows or keys) would need transposed
// copies of Q, dO' and K, and a split B operand in shared memory needs
// its hi and lo tiles both (twice the bytes of a budget already full at
// hd 256). mma.sync reads its fragments with 32-bit loads, so one tile
// serves both orientations: tiles are f32, row r's column c at
// r * W + (c ^ swz(r)), swz(r) = 8 (r & 3) + (r & 4), which makes the
// A/B fragment loads of rows (16 rows x 4 columns) and of columns (4 rows
// x 8 columns) free of bank conflicts and keeps every 16-byte chunk of a
// row whole for cp.async and the FMA chains' 16-byte loads. The tile
// layout, its loads and the split products are in flash_mma.cuh, which
// the f32 forward (flash.cu, route tc_f32) shares.
//
// Three launches, no atomics, every sum in a fixed order (the mma's, the
// key tiles' and the rows' in index order, the merge of two warps' row
// statistics in warp order), so the same inputs give the same bits; the
// logits are kept or recomputed by the same code in the same order, and
// dP is recomputed so, so every pass sees the same bits of them.
//  1. stats: one CTA of 8 warps per (batch, kv head, 64 rows) walks the
//     key tiles (64 keys, double-buffered by cp.async) the rows can see
//     twice: first each warp keeps the max and argmax of its half of
//     every tile and the two halves merge; then each sums p~ in f64 and
//     the halves add in warp order (the second sweep reads the first's
//     q . k from `dots` and loads no key); then dO' (f32 scratch, the q
//     layout) and (m, D, 0, argmax) (four words a row). Smem at hd 256:
//     Q 64 KB + 2 x K 64 KB = 192 KB; 77 registers.
//  2. dq: one CTA of 8 warps per (batch, kv head, 64 rows) walks the key
//     tiles (32 keys): the logits (read from `dots`, whose loads are
//     issued before dP, or recomputed) and dP (each warp 16 rows x 16
//     keys), dS through shared memory, dq += dS K (each warp 16 rows x
//     half the head dim, 64 accumulators a thread); the argmax key's
//     term is added once dm is known; dm to the scratch. Smem at hd 256:
//     Q (loaded only without `dots`), dO' 64 KB each, K, V 32 KB each,
//     dS 8 KB = 200 KB.
//  3. dk/dv: one CTA of 16 warps per (batch, kv head, 64 keys) walks the
//     rows that can see its keys (all g query heads of the group: rows
//     s * g + h, as in the forward) 32 at a time: logits (from `dots`
//     or recomputed) and dP (each warp 16 rows x 8 keys), bf16(p~) and
//     dS through shared memory, then
//     dv += bf16(p~)^T dO' and dk += dS^T Q (each warp 16 keys x a
//     quarter of the head dim: 32 + 32 accumulators a thread, at most 128
//     registers at 512 threads; at hd 256 ptxas gives it all 128 and a
//     48-byte stack in f32 (112 bytes of spill stores), 184 bytes in
//     bf16 (532); the dq kernel takes 255 registers and an 8-byte stack
//     in f32, 64 bytes in bf16).
//     Smem at hd 256: K, V 64 KB each, Q, dO' 32 KB each, p~ and dS 8 KB
//     each = 208 KB.
// The budget leaves no room for a second buffer of the streamed tiles in
// dq or dk/dv, so each streamed operand is reloaded as soon as its last
// reader is done and is waited for only by its first: dk/dv loads the
// next dO' (cp.async) while it multiplies dk and the next Q while it
// multiplies dP; dq loads the next V during dq += dS K and the next K
// during dP. The first 64 keys are seen by every causal row, so dk/dv's
// grid (keys in index order) launches its longest CTAs first; the stats
// and dq grids take their row blocks from the last (the rows that see
// the most keys) under causal masking.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "flash_tiles.cuh"

namespace {

using repro_flash::a_cols;
using repro_flash::a_rows;
using repro_flash::at;
using repro_flash::b_cols;
using repro_flash::b_rows;
using repro_flash::cp_async_commit;
using repro_flash::cp_async_wait;
using repro_flash::Frag;
using repro_flash::Lane;
using repro_flash::lane_of;
using repro_flash::ld;
using repro_flash::load_tile;
using repro_flash::mma_add;
using repro_flash::round_bf16;

constexpr float kNegInf = -1e30f;   // the forward's mask value
// stats and dq: rows a CTA, keys a tile, threads (8 warps)
constexpr int kQRows = 64;
constexpr int kStatKeys = 64;
constexpr int kQKeys = 32;
constexpr int kQThreads = 256;
// dk/dv: keys a CTA, rows a block, threads (16 warps)
constexpr int kKKeys = 64;
constexpr int kKRows = 32;
constexpr int kKThreads = 512;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* dos;     // [b, sq, hq, hd]: dout / l
  float* stats;   // [b, sq, hq, 4]: m, D, dm, argmax key (int bits)
  float* dots;    // [b, hkv, sq * g, dots_ld]: q . k of the pairs the
                  // stats pass sees (rows s * g + h), or null: each
                  // pass recomputes them
  long long dots_ld;
  int b, sq, skv, hq, hkv, hd;
  float scale, cap;
  float inv_cap;  // 1 / cap in f32: PyTorch divides by a scalar by
                  // multiplying by its reciprocal
  int causal, window, q_offset, kv_len;
  int vec;        // q, k, v, out, dout rows on 16 (f32) / 8 (bf16) bytes
};

__device__ __forceinline__ void st(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// Sums and arg-maxes over the 4 lanes of an mma quad (one row's lanes).
template <typename F>
__device__ __forceinline__ F quad_sum(F x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
// ties to the smaller index
__device__ __forceinline__ void quad_argmax(float& x, int& idx) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float ox = __shfl_xor_sync(0xffffffffu, x, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    if (ox > x || (ox == x && oi < idx)) {
      x = ox;
      idx = oi;
    }
  }
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Element offset of row `row` (= s * g + h) of (batch bb, kv head kvh)
// in a [b, sq, hq, hd] tensor.
__device__ __forceinline__ long long row_off(const BwdParams& p, int bb,
                                             int kvh, long long row) {
  const int g = p.hq / p.hkv;
  const long long s = row / g, h = row % g;
  return ((static_cast<long long>(bb) * p.sq + s) * p.hq +
          static_cast<long long>(kvh) * g + h) * p.hd;
}
__device__ __forceinline__ long long key_off(const BwdParams& p, int bb,
                                             int kvh, long long key) {
  return ((static_cast<long long>(bb) * p.skv + key) * p.hkv + kvh) * p.hd;
}

// Scale, softcap and mask of one logit: the capped value, the softcap's
// derivative 1 - tanh^2, and whether the pair is visible.
__device__ __forceinline__ bool logit(const BwdParams& p, float dot,
                                      int q_pos, int kv_pos, float& x,
                                      float& dcap) {
  // each operation rounded on its own, as PyTorch's kernels round them
  // (no contraction into an fma): the logits, and so p~, keep the plain
  // version's bits
  x = __fmul_rn(dot, p.scale);
  dcap = 1.f;
  if (p.cap > 0.f) {
    const float t = tanhf(__fmul_rn(x, p.inv_cap));
    x = __fmul_rn(p.cap, t);
    dcap = 1.f - t * t;
  }
  bool ok = kv_pos < p.skv && kv_pos < p.kv_len;
  if (p.causal) ok = ok && kv_pos <= q_pos;
  if (p.window > 0) ok = ok && q_pos - kv_pos < p.window;
  return ok;
}

// ------------------------------------------------------ kept logits

// The kept q . k of row `row` of (bb, kvh) from key `key` on (even).
__device__ __forceinline__ float2* dots_at(const BwdParams& p, int bb,
                                           int kvh, long long row, int key) {
  const long long rows = static_cast<long long>(p.sq) * (p.hq / p.hkv);
  return reinterpret_cast<float2*>(
      p.dots + ((static_cast<long long>(bb) * p.hkv + kvh) * rows + row) *
                   p.dots_ld + key);
}
// Store or load the kept q . k of a warp's 16 rows (row0 + [0, 16), those
// below `row_end`) and NJ 8-key tiles (key0 + 8 j), in the mma C layout;
// rows past the end load as 0.
template <int NJ>
__device__ __forceinline__ void store_dots(const BwdParams& p, int bb,
                                           int kvh, long long row0,
                                           long long row_end, int key0,
                                           const float (&s)[NJ][4]) {
  const Lane l = lane_of();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = row0 + l.g + 8 * i;
    if (row >= row_end) continue;
    float2* d = dots_at(p, bb, kvh, row, key0 + 2 * l.t);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      d[4 * j] = make_float2(s[j][2 * i], s[j][2 * i + 1]);
  }
}
template <int NJ>
__device__ __forceinline__ void load_dots(const BwdParams& p, int bb,
                                          int kvh, long long row0,
                                          long long row_end, int key0,
                                          float (&s)[NJ][4]) {
  const Lane l = lane_of();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = row0 + l.g + 8 * i;
    const float2* d = dots_at(p, bb, kvh, row < row_end ? row : 0,
                                  key0 + 2 * l.t);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 x = row < row_end ? d[4 * j] : make_float2(0.f, 0.f);
      s[j][2 * i] = x.x;
      s[j][2 * i + 1] = x.y;
    }
  }
}

// acc[j] += A B over the head dim for a warp's 16 rows (m0) and NJ
// 8-key tiles (n0 + 8 j): A rows of `as` (queries x HDP), B rows of `bs`
// (keys x HDP). SA, SB: split A, B; RB: round B to bf16 first (exact).
template <int HDP, int NJ, bool SA, bool SB, bool RB>
__device__ __forceinline__ void row_key_product(const float* as,
                                                const float* bs, int m0,
                                                int n0,
                                                float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < HDP; k0 += 8) {
    float x[4];
    a_rows<HDP>(as, m0, k0, x);
    Frag<4, SA> a;
    a.set(x);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float y[2];
      b_rows<HDP>(bs, n0 + 8 * j, k0, y);
      if constexpr (RB) {
        y[0] = round_bf16(y[0]);
        y[1] = round_bf16(y[1]);
      }
      Frag<2, SB && !RB> b;
      b.set(y);
      mma_add(acc[j], a, b);
    }
  }
}

// The f32 logits q . k of a warp's 16 rows (m0) and NJ 8-key tiles
// (n0 + 8 j), in the mma C layout: each a chain of f32 FMAs over the
// head dim in index order from zero, the bits the plain version's f32
// matmul gives (see the header). Rows and keys go by 16-byte loads.
template <int HDP, int NJ>
__device__ __forceinline__ void fma_logits(const float* qs, const float* ks,
                                           int m0, int n0,
                                           float (&acc)[NJ][4]) {
  const Lane l = lane_of();
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
  for (int c = 0; c < HDP; c += 4) {
    float4 qv[2], kv[NJ][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      qv[i] = *reinterpret_cast<const float4*>(
          qs + at<HDP>(m0 + l.g + 8 * i, c));
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        kv[j][e] = *reinterpret_cast<const float4*>(
            ks + at<HDP>(n0 + 8 * j + 2 * l.t + e, c));
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& a = acc[j][2 * i + e];
          a = __fmaf_rn(qv[i].x, kv[j][e].x, a);
          a = __fmaf_rn(qv[i].y, kv[j][e].y, a);
          a = __fmaf_rn(qv[i].z, kv[j][e].z, a);
          a = __fmaf_rn(qv[i].w, kv[j][e].w, a);
        }
  }
}

// The logits of a warp's tile: FMA chains for f32 inputs, one TF32 mma a
// k-step for bf16 inputs (their products are exact).
template <int HDP, int NJ, typename T>
__device__ __forceinline__ void logits(const float* qs, const float* ks,
                                       int m0, int n0, float (&acc)[NJ][4]) {
  if constexpr (sizeof(T) == 2)
    row_key_product<HDP, NJ, false, false, false>(qs, ks, m0, n0, acc);
  else
    fma_logits<HDP, NJ>(qs, ks, m0, n0, acc);
}

// acc[j] += A B for a warp's 16 rows or keys (m0) and NJ 8-column tiles
// of the head dim (n0 + 8 j), over KS k-steps: A's fragment from
// load_a(k0) (split where SA), B's from `bs`, whose rows are the
// reduction (b_cols).
template <int HDP, int NJ, int KS, bool SA, bool SB, typename LoadA>
__device__ __forceinline__ void col_product(LoadA load_a, const float* bs,
                                            int n0, float (&acc)[NJ][4]) {
#pragma unroll
  for (int k0 = 0; k0 < 8 * KS; k0 += 8) {
    float x[4];
    load_a(k0, x);
    Frag<4, SA> a;
    a.set(x);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float y[2];
      b_cols<HDP>(bs, n0 + 8 * j, k0, y);
      Frag<2, SB> b;
      b.set(y);
      mma_add(acc[j], a, b);
    }
  }
}

// Key tiles [t_lo, t_hi) of KEYS keys that some row of [row0, row0 +
// kQRows) can see.
template <int KEYS>
__device__ __forceinline__ void key_tiles(const BwdParams& p, long long row0,
                                          long long rows, int& t_lo,
                                          int& t_hi) {
  const int g = p.hq / p.hkv;
  const long long last = (row0 + kQRows < rows ? row0 + kQRows : rows) - 1;
  const long long s_first = row0 / g, s_last = last / g;
  long long hi = p.skv < p.kv_len ? p.skv : p.kv_len;
  if (p.causal && p.q_offset + s_last + 1 < hi) hi = p.q_offset + s_last + 1;
  long long lo = 0;
  if (p.window > 0 && p.q_offset + s_first - p.window + 1 > lo)
    lo = p.q_offset + s_first - p.window + 1;
  t_lo = static_cast<int>(lo / KEYS);
  t_hi = hi > lo ? static_cast<int>((hi + KEYS - 1) / KEYS) : t_lo;
}

// The row block of a stats or dq CTA: under causal masking the last
// first (its rows see the most keys).
__device__ __forceinline__ long long row_block(const BwdParams& p,
                                               long long rows) {
  const long long n = (rows + kQRows - 1) / kQRows;
  const long long y = blockIdx.y;
  return (p.causal ? n - 1 - y : y) * kQRows;
}

// ---------------------------------------------------------------- stats

// Pass 1: each row's m and first argmax key over its visible keys (the
// first sweep of its key tiles), then l = sum p~ with p~ = exp(x - m)
// (the second sweep: the bits of p~ the later passes use, summed in f64
// and rounded once); then dO' = dout / l into `dos` and (m, D, 0,
// argmax) into `stats`.
template <int HDP, typename T>
__global__ void __launch_bounds__(kQThreads)
    flash_bwd_stats_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [kQRows][HDP]
  float* kbuf = qs + kQRows * HDP;         // 2 x [kStatKeys][HDP]
  __shared__ float row_m[kQRows];
  __shared__ double row_l[kQRows];
  __shared__ int row_arg[kQRows];
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* out = static_cast<const T*>(p.out);
  const T* dout = static_cast<const T*>(p.dout);
  const int g = p.hq / p.hkv;
  const int bb = blockIdx.x / p.hkv, kvh = blockIdx.x % p.hkv;
  const long long rows = static_cast<long long>(p.sq) * g;
  const long long row0 = row_block(p, rows);
  const int warp = threadIdx.x >> 5;
  const Lane l = lane_of();
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const int n_valid = static_cast<int>(rows - row0 < kQRows ? rows - row0
                                                            : kQRows);
  int t_lo, t_hi;
  key_tiles<kStatKeys>(p, row0, rows, t_lo, t_hi);
  const int n_tiles = t_hi - t_lo;
  // the second sweep reads the first's q . k where they are kept
  const int n_loads = p.dots ? n_tiles : 2 * n_tiles;
  // step `it` of the two sweeps: key tile t_lo + it % n_tiles, in
  // buffer it & 1
  auto load_keys = [&](int it) {
    const int key0 = (t_lo + it % n_tiles) * kStatKeys;
    load_tile<HDP, kStatKeys, kQThreads>(
        kbuf + (it & 1) * kStatKeys * HDP, k, p.skv - key0, p.hd,
        [&](int r) { return key_off(p, bb, kvh, key0 + r); }, p.vec);
  };
  load_tile<HDP, kQRows, kQThreads>(
      qs, q, n_valid, p.hd,
      [&](int r) { return row_off(p, bb, kvh, row0 + r); }, p.vec);
  if (n_tiles > 0) load_keys(0);
  cp_async_commit();

  int q_pos[2], arg[2];
  float m[2];
  double lsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    q_pos[i] = p.q_offset + static_cast<int>((row0 + m0 + l.g + 8 * i) / g);
    m[i] = kNegInf;
    lsum[i] = 0.0;
    arg[i] = INT_MAX;
  }
  for (int it = 0; it < 2 * n_tiles; ++it) {
    const int t = t_lo + it % n_tiles;
    float* ks = kbuf + (it & 1) * kStatKeys * HDP;
    if (it + 1 < n_loads) {
      load_keys(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (it == n_tiles) {
      // the row max: merge the two warps of each 16 rows (keys [0, 32)
      // and [32, 64) of every tile); ties to the first key
      if (warp >= 4 && l.t == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          row_m[m0 + l.g + 8 * i] = m[i];
          row_arg[m0 + l.g + 8 * i] = arg[i];
        }
      }
      __syncthreads();
      if (warp < 4 && l.t == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = m0 + l.g + 8 * i;
          const float m2 = row_m[r];
          const int a2 = row_arg[r];
          row_arg[r] = m2 > m[i] ? a2 : m[i] > m2 ? arg[i] : min(arg[i], a2);
          row_m[r] = fmaxf(m[i], m2);
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) m[i] = row_m[m0 + l.g + 8 * i];
    }
    __syncthreads();
    float s[4][4];
    if (it < n_tiles || !p.dots) {
      logits<HDP, 4, T>(qs, ks, m0, n0, s);
      if (p.dots)
        store_dots<4>(p, bb, kvh, row0 + m0, rows, t * kStatKeys + n0, s);
    } else {
      load_dots<4>(p, bb, kvh, row0 + m0, rows, t * kStatKeys + n0, s);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tile_max = kNegInf;
      int tile_arg = INT_MAX;
      double tile_sum = 0.0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x, dcap;
          const int key = t * kStatKeys + n0 + 8 * j + 2 * l.t + e;
          const bool ok = logit(p, s[j][2 * i + e], q_pos[i], key, x, dcap);
          if (it < n_tiles) {
            if (ok && x > tile_max) {
              tile_max = x;
              tile_arg = key;
            }
          } else if (ok) {
            tile_sum += expf(__fsub_rn(x, m[i]));
          }
        }
      if (it < n_tiles) {
        quad_argmax(tile_max, tile_arg);
        if (tile_max > m[i]) {
          m[i] = tile_max;
          arg[i] = tile_arg;
        }
      } else {
        lsum[i] += quad_sum(tile_sum);
      }
    }
    __syncthreads();   // the next tile's load refills this buffer
  }
  // l: the two warps' sums of each 16 rows, in warp order
  if (warp >= 4 && l.t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) row_l[m0 + l.g + 8 * i] = lsum[i];
  }
  __syncthreads();
  if (warp < 4 && l.t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + l.g + 8 * i;
      row_l[r] = lsum[i] + row_l[r];
    }
  }
  __syncthreads();
  // dO' = dout / l and D = dO' . out, a warp a row; zero for a row with
  // no visible key
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < n_valid; r += kQThreads / 32) {
    const long long o = row_off(p, bb, kvh, row0 + r);
    const float lv = static_cast<float>(row_l[r]);
    const bool seen = lv > 0.f;
    float dsum = 0.f;
    for (int d = lane; d < p.hd; d += 32) {
      const float x = seen ? ld(dout, o + d) / fmaxf(lv, 1e-30f) : 0.f;
      p.dos[o + d] = x;
      dsum += x * ld(out, o + d);
    }
    dsum = warp_sum(dsum);
    if (lane == 0) {
      float* st4 = p.stats + o / p.hd * 4;
      st4[0] = seen ? row_m[r] : 0.f;
      st4[1] = dsum;
      st4[2] = 0.f;
      st4[3] = __int_as_float(seen ? row_arg[r] : -1);
    }
  }
}

// ------------------------------------------------------------- row stats

// What a thread knows of each of its two rows: the query position,
// whether the row exists, and its m, D, dm (the gradient autograd sends
// through the row max) and argmax key (-1: the row sees no key).
struct Rows {
  int q_pos[2];
  bool ok[2];
  float m[2], dd[2], dm[2];
  int arg[2];
};

__device__ __forceinline__ Rows load_row_stats(const BwdParams& p, int bb,
                                               int kvh, long long row0,
                                               int m0, long long row_end) {
  const int g = p.hq / p.hkv;
  const Lane l = lane_of();
  Rows r;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = row0 + m0 + l.g + 8 * i;
    r.q_pos[i] = p.q_offset + static_cast<int>(row / g);
    r.ok[i] = row < row_end;
    r.m[i] = r.dd[i] = r.dm[i] = 0.f;
    r.arg[i] = -1;
    if (r.ok[i]) {
      const float4 st4 = *reinterpret_cast<const float4*>(
          p.stats + row_off(p, bb, kvh, row) / p.hd * 4);
      r.m[i] = st4.x;
      r.dd[i] = st4.y;
      r.dm[i] = st4.z;
      r.arg[i] = __float_as_int(st4.w);
    }
  }
  return r;
}

// The gradient of one C-fragment element (row i of the thread's two,
// key `key`) from its logit s and dP dp:
//   ds = (p~ (bf16(dp) - D) + [key == argmax] dm) (1 - tanh^2);
// p~ to `pt`, p~ (bf16(dp) - D) added to `dmsum`.
// PV32: dp as it is (the variant rounds nothing).
template <bool PV32>
__device__ __forceinline__ float grad_elem(const BwdParams& p, const Rows& rw,
                                           int i, int key, float s, float dp,
                                           float& pt, float& dmsum) {
  // logit() sets x and dcap for every pair, rows past the block's end
  // included: their ds (0 * dcap) enters the products
  float x, dcap;
  const bool ok = logit(p, s, rw.q_pos[i], key, x, dcap) && rw.ok[i];
  pt = ok ? expf(__fsub_rn(x, rw.m[i])) : 0.f;
  const float gr = pt * ((PV32 ? dp : round_bf16(dp)) - rw.dd[i]);
  dmsum += gr;
  return (gr + (ok && key == rw.arg[i] ? rw.dm[i] : 0.f)) * dcap;
}

// ---------------------------------------------------------------- dq

// Pass 2: dq of 64 rows, and each row's dm (into `stats`) for pass 3.
template <int HDP, typename T, bool PV32>
__global__ void __launch_bounds__(kQThreads)
    flash_bwd_dq_kernel(const BwdParams p) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int NQ = HDP / 16;   // 8-column tiles of dq a warp
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [kQRows][HDP]
  float* dos_s = qs + kQRows * HDP;      // [kQRows][HDP]
  float* ks = dos_s + kQRows * HDP;      // [kQKeys][HDP]
  float* vs = ks + kQKeys * HDP;         // [kQKeys][HDP], raw (rounded
                                         // to bf16 as it is read)
  float* dss = vs + kQKeys * HDP;        // [kQRows][kQKeys]: dS
  __shared__ float dm_part[2][kQRows];
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int g = p.hq / p.hkv;
  const int bb = blockIdx.x / p.hkv, kvh = blockIdx.x % p.hkv;
  const long long rows = static_cast<long long>(p.sq) * g;
  const long long row0 = row_block(p, rows);
  const int warp = threadIdx.x >> 5;
  const Lane l = lane_of();
  // logits and dP: rows m0 + [0, 16), keys n0 + [0, 16); dq: rows
  // m0 + [0, 16), columns nq0 + [0, HDP / 2)
  const int m0 = 16 * (warp & 3), n0 = 16 * (warp >> 2);
  const int nq0 = (HDP / 2) * (warp >> 2);
  const int n_valid = static_cast<int>(rows - row0 < kQRows ? rows - row0
                                                            : kQRows);
  const bool vec_dos = p.hd % 4 == 0;
  auto roff = [&](int r) { return row_off(p, bb, kvh, row0 + r); };
  int t_lo, t_hi;
  key_tiles<kQKeys>(p, row0, rows, t_lo, t_hi);
  auto load_v = [&](int t) {
    const int key0 = t * kQKeys;
    load_tile<HDP, kQKeys, kQThreads>(
        vs, v, p.skv - key0, p.hd,
        [&](int r) { return key_off(p, bb, kvh, key0 + r); }, p.vec);
  };
  auto load_k = [&](int t) {
    const int key0 = t * kQKeys;
    load_tile<HDP, kQKeys, kQThreads>(
        ks, k, p.skv - key0, p.hd,
        [&](int r) { return key_off(p, bb, kvh, key0 + r); }, p.vec);
  };
  // groups: {Q (unless the logits are kept), dO', V of the first tile},
  // {K of the first tile}
  if (!p.dots)
    load_tile<HDP, kQRows, kQThreads>(qs, q, n_valid, p.hd, roff, p.vec);
  load_tile<HDP, kQRows, kQThreads>(dos_s, static_cast<const float*>(p.dos),
                                    n_valid, p.hd, roff, vec_dos);
  if (t_lo < t_hi) load_v(t_lo);
  cp_async_commit();
  if (t_lo < t_hi) load_k(t_lo);
  cp_async_commit();
  const Rows rw = load_row_stats(p, bb, kvh, row0, m0, rows);   // dm 0

  float dq[NQ][4], dmsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int key0 = t * kQKeys;
    float dp[2][4], s[2][4];
    if (p.dots) load_dots<2>(p, bb, kvh, row0 + m0, rows, key0 + n0, s);
    cp_async_wait<1>();   // V (and, the first time, Q and dO')
    __syncthreads();
    row_key_product<HDP, 2, true, PV32 && !kExact, !kExact && !PV32>(
        dos_s, vs, m0, n0, dp);
    cp_async_wait<0>();   // K
    __syncthreads();
    if (!p.dots) logits<HDP, 2, T>(qs, ks, m0, n0, s);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = n0 + 8 * j + 2 * l.t + (e & 1);
        float pt;
        dss[at<kQKeys>(m0 + l.g + 8 * i, c)] =
            grad_elem<PV32>(p, rw, i, key0 + c, s[j][e], dp[j][e], pt,
                            dmsum[i]);
      }
    __syncthreads();   // dS written; V read
    if (t + 1 < t_hi) load_v(t + 1);
    cp_async_commit();
    // dq += dS K: A = dS (rows x keys), B = K (keys x HDP)
    col_product<HDP, NQ, kQKeys / 8, true, !kExact>(
        [&](int k0, float (&x)[4]) { a_rows<kQKeys>(dss, m0, k0, x); }, ks,
        nq0, dq);
    __syncthreads();   // K and dS read
    if (t + 1 < t_hi) load_k(t + 1);
    cp_async_commit();
  }
  // the row max's term: dm = -sum p~ (dP - D), on the argmax key's
  // logit, with the softcap's derivative there, 1 - (m / cap)^2; the
  // two warps of each 16 rows hold the halves of every key tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dmsum[i] = quad_sum(dmsum[i]);
    if (l.t == 0) dm_part[warp >> 2][m0 + l.g + 8 * i] = dmsum[i];
  }
  __syncthreads();
  T* dq_out = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + l.g + 8 * i;
    const long long row = row0 + r;
    if (row >= rows) continue;
    const float dm = -(dm_part[0][r] + dm_part[1][r]);
    const long long o = row_off(p, bb, kvh, row);
    float w = 0.f;
    long long ko = 0;
    if (rw.arg[i] >= 0) {
      const float tc = p.cap > 0.f ? rw.m[i] / p.cap : 0.f;
      w = dm * (1.f - tc * tc);
      ko = key_off(p, bb, kvh, rw.arg[i]);
      if (warp < 4 && l.t == 0) p.stats[o / p.hd * 4 + 2] = dm;
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = nq0 + 8 * j + 2 * l.t + e;
        if (d < p.hd) {
          const float kx = rw.arg[i] >= 0 ? ld(k, ko + d) : 0.f;
          st(dq_out, o + d, (dq[j][2 * i + e] + w * kx) * p.scale);
        }
      }
  }
}

// ---------------------------------------------------------------- dk, dv

// Pass 3: dk and dv of 64 keys.
template <int HDP, typename T, bool PV32>
__global__ void __launch_bounds__(kKThreads, 1)
    flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int NK = HDP / 32;   // 8-column tiles of dk and dv a warp
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                      // [kKKeys][HDP]
  float* vs = ks + kKKeys * HDP;         // [kKKeys][HDP], bf16-rounded
                                         // (PV32: as it is)
  float* qs = vs + kKKeys * HDP;         // [kKRows][HDP]
  float* dos_s = qs + kKRows * HDP;      // [kKRows][HDP]
  float* ps = dos_s + kKRows * HDP;      // [kKRows][kKKeys]: bf16(p~)
                                         // (PV32: p~)
  float* dss = ps + kKRows * kKKeys;     // [kKRows][kKKeys]: dS
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int g = p.hq / p.hkv;
  const int bb = blockIdx.x / p.hkv, kvh = blockIdx.x % p.hkv;
  const int key0 = blockIdx.y * kKKeys;
  const int warp = threadIdx.x >> 5;
  const Lane l = lane_of();
  // logits and dP: rows m0 + [0, 16), keys n0 + [0, 8); dk, dv: keys
  // km0 + [0, 16), columns nd0 + [0, HDP / 4)
  const int m0 = 16 * (warp & 1), n0 = 8 * (warp >> 1);
  const int km0 = 16 * (warp & 3), nd0 = (HDP / 4) * (warp >> 2);
  const bool vec_dos = p.hd % 4 == 0;
  auto koff = [&](int r) { return key_off(p, bb, kvh, key0 + r); };
  load_tile<HDP, kKKeys, kKThreads>(ks, k, p.skv - key0, p.hd, koff, p.vec);
  load_tile<HDP, kKKeys, kKThreads>(vs, v, p.skv - key0, p.hd, koff, p.vec);
  cp_async_commit();

  // the rows that can see a key of [key0, key0 + kKKeys)
  const long long key_end = p.skv < p.kv_len ? p.skv : p.kv_len;
  long long s_lo = 0, s_hi = p.sq;
  if (p.causal && key0 - static_cast<long long>(p.q_offset) > s_lo)
    s_lo = key0 - static_cast<long long>(p.q_offset);
  if (p.window > 0) {
    const long long end = static_cast<long long>(key0) + kKKeys - 1 +
                          p.window - p.q_offset;
    if (end < s_hi) s_hi = end;
  }
  if (key0 >= key_end) s_hi = s_lo;
  const long long r_end = s_hi > s_lo ? s_hi * g : 0;
  const long long r_begin = s_lo * g;
  auto load_rows = [&](float* dst, const auto* src, long long rb, bool vec) {
    const int n = static_cast<int>(r_end - rb < kKRows ? r_end - rb : kKRows);
    load_tile<HDP, kKRows, kKThreads>(
        dst, src, n, p.hd, [&](int r) { return row_off(p, bb, kvh, rb + r); },
        vec);
  };
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (!kExact && !PV32) {
    for (int idx = threadIdx.x; idx < kKKeys * HDP; idx += kKThreads)
      vs[idx] = round_bf16(vs[idx]);
  }
  // groups: {dO' of the first block}, {Q of the first block}
  if (r_begin < r_end) load_rows(dos_s, static_cast<const float*>(p.dos),
                                 r_begin, vec_dos);
  cp_async_commit();
  if (r_begin < r_end) load_rows(qs, q, r_begin, p.vec);
  cp_async_commit();

  float dk[NK][4], dv[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (long long rb = r_begin; rb < r_end; rb += kKRows) {
    const Rows rw = load_row_stats(p, bb, kvh, rb, m0, r_end);
    float dp[1][4], s[1][4];
    if (p.dots) load_dots<1>(p, bb, kvh, rb + m0, r_end, key0 + n0, s);
    cp_async_wait<1>();   // dO' (and V's rounding)
    __syncthreads();
    row_key_product<HDP, 1, true, PV32 && !kExact, false>(dos_s, vs, m0,
                                                          n0, dp);
    cp_async_wait<0>();   // Q
    __syncthreads();
    if (!p.dots) logits<HDP, 1, T>(qs, ks, m0, n0, s);
    float unused = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, c = n0 + 2 * l.t + (e & 1);
      const int r = m0 + l.g + 8 * i;
      float pt;
      dss[at<kKKeys>(r, c)] = grad_elem<PV32>(p, rw, i, key0 + c, s[0][e],
                                              dp[0][e], pt, unused);
      ps[at<kKKeys>(r, c)] = PV32 ? pt : round_bf16(pt);
    }
    __syncthreads();   // p~ and dS written; dO' and Q read
    // dv += bf16(p~)^T dO': f32 inputs by FMA chains over the rows in
    // order (see the header), bf16 inputs on the tensor cores with
    // A = p~ (rows x keys, read as keys x rows; split where PV32)
    if constexpr (kExact) {
      col_product<HDP, NK, kKRows / 8, PV32, true>(
          [&](int k0, float (&x)[4]) { a_cols<kKKeys>(ps, km0, k0, x); },
          dos_s, nd0, dv);
    } else {
#pragma unroll 4
      for (int r = 0; r < kKRows; ++r) {
        const float p0 = ps[at<kKKeys>(r, km0 + l.g)];
        const float p1 = ps[at<kKKeys>(r, km0 + l.g + 8)];
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const float2 x = *reinterpret_cast<const float2*>(
              dos_s + at<HDP>(r, nd0 + 8 * j + 2 * l.t));
          dv[j][0] = __fmaf_rn(p0, x.x, dv[j][0]);
          dv[j][1] = __fmaf_rn(p0, x.y, dv[j][1]);
          dv[j][2] = __fmaf_rn(p1, x.x, dv[j][2]);
          dv[j][3] = __fmaf_rn(p1, x.y, dv[j][3]);
        }
      }
    }
    __syncthreads();   // dO' read
    if (rb + kKRows < r_end)
      load_rows(dos_s, static_cast<const float*>(p.dos), rb + kKRows,
                vec_dos);
    cp_async_commit();
    // dk += dS^T Q
    col_product<HDP, NK, kKRows / 8, true, !kExact>(
        [&](int k0, float (&x)[4]) { a_cols<kKKeys>(dss, km0, k0, x); },
        qs, nd0, dk);
    __syncthreads();   // Q, p~ and dS read
    if (rb + kKRows < r_end) load_rows(qs, q, rb + kKRows, p.vec);
    cp_async_commit();
  }
  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + km0 + l.g + 8 * i;
    if (key >= p.skv) continue;
    const long long o = key_off(p, bb, kvh, key);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = nd0 + 8 * j + 2 * l.t + e;
        if (d < p.hd) {
          st(dk_out, o + d, dk[j][2 * i + e] * p.scale);
          st(dv_out, o + d,
             PV32 ? dv[j][2 * i + e] : round_bf16(dv[j][2 * i + e]));
        }
      }
  }
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t s, const BwdParams& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

// `passes`: a mask of the launches to make (1 stats, 2 dq, 4 dk/dv), in
// that order; each reads what the earlier ones wrote.
template <int HDP, typename T, bool PV32>
cudaError_t launch_bwd(const BwdParams& p, int passes, cudaStream_t s) {
  const long long rows = static_cast<long long>(p.sq) * (p.hq / p.hkv);
  const long long row_blocks = (rows + kQRows - 1) / kQRows;
  const long long key_blocks = (p.skv + kKKeys - 1) / kKKeys;
  if (row_blocks > 65535 || key_blocks > 65535) return cudaErrorInvalidValue;
  const unsigned heads = static_cast<unsigned>(p.b * p.hkv);
  const size_t stats_smem = sizeof(float) * (kQRows + 2 * kStatKeys) * HDP;
  const size_t dq_smem = sizeof(float) * ((2 * kQRows + 2 * kQKeys) * HDP +
                                          kQRows * kQKeys);
  const size_t dkdv_smem = sizeof(float) * ((2 * kKKeys + 2 * kKRows) * HDP +
                                            2 * kKRows * kKKeys);
  const dim3 row_grid(heads, static_cast<unsigned>(row_blocks));
  cudaError_t err = cudaSuccess;
  if (passes & 1)
    err = launch(flash_bwd_stats_kernel<HDP, T>, row_grid, kQThreads,
                 stats_smem, s, p);
  if (err == cudaSuccess && (passes & 2))
    err = launch(flash_bwd_dq_kernel<HDP, T, PV32>, row_grid, kQThreads,
                 dq_smem, s, p);
  if (err == cudaSuccess && (passes & 4))
    err = launch(flash_bwd_dkdv_kernel<HDP, T, PV32>,
                 dim3(heads, static_cast<unsigned>(key_blocks)), kKThreads,
                 dkdv_smem, s, p);
  return err;
}

template <typename T, bool PV32>
cudaError_t launch_bwd_hd(const BwdParams& p, int passes, cudaStream_t s) {
#define REPRO_FLASH_BWD_HD(HDP) \
  if (p.hd <= HDP) return launch_bwd<HDP, T, PV32>(p, passes, s);
  REPRO_FLASH_BWD_HD(32)   // the swizzle needs rows of 32 words
  REPRO_FLASH_BWD_HD(64)
  REPRO_FLASH_BWD_HD(128)
  REPRO_FLASH_BWD_HD(256)
#undef REPRO_FLASH_BWD_HD
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out, dout, dq [b, sq, hq, hd]; k, v, dk, dv [b, skv, hkv, hd]; all
// contiguous and of one type (bf16 when `bf16`, else f32); hq a multiple
// of hkv; 1 <= hd <= 256; b, sq, skv >= 1. dos: b * sq * hq * hd floats,
// stats: b * sq * hq * 4 floats of scratch, both on 16 bytes; dots:
// b * hq * sq * ceil(skv / 64) * 64 floats of scratch on 8 bytes that keep
// the logits' q . k from the stats pass for the others, or null (each
// pass recomputes them). scale,
// causal, window, cap, q_offset and kv_len as repro_flash_attention's,
// with which `out` was computed. passes: 7 (all three launches) writes
// every element of dq, dk and dv; 1, 2 or 4 makes one launch (stats, dq,
// dk/dv), for timing a pass once a full call has filled the scratch.
// pv32: 1 for the gradient of the forward's f32 p.v variant. Returns a
// CUDA error code (cudaErrorInvalidValue for a shape it does not take).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, float* dos, float* stats,
    float* dots, int b, int sq, int skv, int hq, int hkv, int hd,
    float scale, int causal, int window, float cap, int q_offset,
    int kv_len, int bf16, int passes, int pv32, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv || hd < 1 ||
      hd > 256 || passes < 1 || passes > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
      reinterpret_cast<uintptr_t>(dout);
  const int vec = hd % 4 == 0 && any % (bf16 ? 8 : 16) == 0;
  const long long dots_ld =
      (static_cast<long long>(skv) + kStatKeys - 1) / kStatKeys * kStatKeys;
  const BwdParams p{q,      k,      v,        out,    dout,   dq,
                    dk,     dv,     dos,      stats,  dots,   dots_ld,
                    b,      sq,     skv,      hq,     hkv,    hd,
                    scale,  cap,    cap > 0.f ? 1.f / cap : 0.f,
                    causal, window, q_offset, kv_len, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pv32)
    err = bf16 ? launch_bwd_hd<__nv_bfloat16, true>(p, passes, s)
               : launch_bwd_hd<float, true>(p, passes, s);
  else
    err = bf16 ? launch_bwd_hd<__nv_bfloat16, false>(p, passes, s)
               : launch_bwd_hd<float, false>(p, passes, s);
  return static_cast<int>(err);
}
