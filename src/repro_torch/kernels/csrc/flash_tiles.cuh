// Pieces shared by the routes of flash_attention_fused (flash.cu:
// tc_prefill and tc_f32; flash_decode.cu: split_decode): launch
// arguments, the swizzled bf16 tile layout and quad reductions, and for
// the bf16 routes the tile loads, the softcap and the online softmax.
//
// Tiles of bf16 rows live in shared memory HDP elements wide (HDP: the
// head dim rounded up to 64, 128 or 256; the padding is zero), in
// 64-column panels with the 128-byte swizzle (`tile_off`). Where every
// row starts on 16 bytes (`rows_aligned16`: the head dim a multiple of
// 8, the tensors on 16 bytes) cp.async fills them 16 bytes a thread and
// zero-fills what lies outside the tensor; else (VEC false) each thread
// reads its 8 columns element by element, zero past the head dim, and
// stores them as one 16-byte word. A warp owns 16 rows of a product;
// its logits and its output accumulator are in the m16n8k16 C layout
// (both routes' products, mma.sync and wgmma, give that layout), on
// which the online softmax (`softmax_tile`) works.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_flash {

constexpr float kNegInf = -1e30f;           // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

// Launch arguments of every route (q/k/v/out [B, S, H, hd] contiguous).
struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* scratch;     // split_decode's partials (f32), else unused
  int b, sq, skv, hq, hkv, hd;
  float scale;        // logit scale
  float cap;          // softcap, <= 0: none
  int causal, window, q_offset, kv_len;
  int n_chunks;       // split_decode's chunks per (batch, kv head)
  int pv32;           // the f32 p.v variant (REPRO_PERF_OPTS=0)
};

// Whether every row of q, k, v and out starts on 16 bytes.
inline bool rows_aligned16(const Params& p) {
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
      reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.out);
  return p.hd % 8 == 0 && any % 16 == 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 writes zeros and reads
// nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
// The first n (<= 8) bf16 of src, then zeros, to 16 bytes of shared
// memory, with plain loads (any alignment).
__device__ __forceinline__ void copy8_sync(uint32_t dst,
                                           const __nv_bfloat16* src, int n) {
  const auto* h = reinterpret_cast<const unsigned short*>(src);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = 2 * e < n ? h[2 * e] : 0u;
    const uint32_t hi = 2 * e + 1 < n ? h[2 * e + 1] : 0u;
    w[e] = lo | (hi << 16);
  }
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]));
}

// Chunk c (8 columns) of a row of hd columns at src into shared memory:
// by cp.async where rows are 16-byte aligned (VEC), else by copy8_sync;
// zeros where !ok or past hd.
template <bool VEC>
__device__ __forceinline__ void load_chunk(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           bool ok, int c, int hd) {
  if constexpr (VEC)
    cp_async16(dst, src, ok);
  else
    copy8_sync(dst, src, ok ? min(8, hd - c * 8) : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The probabilities of keys 16 ks .. 16 ks + 15 of a logits tile (C
// layout), rounded to bf16, as the A operand of the p.v product.
template <int KEYS>
__device__ __forceinline__ void p_operand(uint32_t (&a)[4],
                                          const float (&s)[KEYS / 8][4],
                                          int ks) {
  a[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
  a[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
  a[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
  a[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
}

// What p_operand leaves of each probability, p - bf16(p) (exact in
// f32), rounded to bf16: the f32 p.v variant's second A operand, with
// which hi + lo carries p to about 2^-17 relative (bf16 values are
// exact, so p.v is then about f32's).
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}
template <int KEYS>
__device__ __forceinline__ void p_operand_lo(uint32_t (&a)[4],
                                             const float (&s)[KEYS / 8][4],
                                             int ks) {
  a[0] = pack_bf16(bf16_rest(s[2 * ks][0]), bf16_rest(s[2 * ks][1]));
  a[1] = pack_bf16(bf16_rest(s[2 * ks][2]), bf16_rest(s[2 * ks][3]));
  a[2] = pack_bf16(bf16_rest(s[2 * ks + 1][0]), bf16_rest(s[2 * ks + 1][1]));
  a[3] = pack_bf16(bf16_rest(s[2 * ks + 1][2]), bf16_rest(s[2 * ks + 1][3]));
}

// 2^x on the special-function unit (relative error about 2^-22; a
// result below 2^-126 is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = sign(x) (1 - 2 / (e^(2|x|) + 1)) from ex2 and rcp.approx:
// its absolute error stays below about 6e-7 everywhere (both unit
// operations are good to a few 2^-23 relative, and 2 / (e^(2|x|) + 1)
// <= 1), so a logit under softcap 50 moves by at most 3e-5. That is
// the accuracy that matters here; tanh.approx.f32 (relative error
// about 5e-4, up to 0.025 on a logit) does not have it. It replaces
// libdevice's tanhf, whose two branches (a polynomial below 0.6) both
// run when a warp holds logits on either side.
__device__ __forceinline__ float tanh_softcap(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;"
      : "=f"(r)
      : "f"(ex2(2.f * kLog2e * fabsf(x)) + 1.f));
  return copysignf(fmaf(-2.f, r, 1.f), x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Byte offset of 16-byte chunk c of row r in a ROWS-row tile cut into
// panels of 64 bf16 columns: a panel holds its rows at a 128-byte
// stride, and chunk c of row r sits at chunk (c % 8) ^ (r % 8) of its
// panel's row (the 128-byte swizzle of wgmma's operands; ldmatrix's
// eight rows of one 8 x 8 matrix then fall in eight bank groups).
template <int ROWS>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * (ROWS * 128) + r * 128 +
                               (((c & 7) ^ (r & 7)) << 4));
}

// Loads keys [key0, key0 + ROWS) of one (batch, kv head) into a
// swizzled tile; keys at or past key_end, and chunks at or past hd,
// are zero. base: the key-0 row of this (batch, kv head); stride: the
// elements between consecutive keys (Hkv * hd).
template <int HDP, int ROWS, int NT, bool VEC>
__device__ __forceinline__ void load_kv_tile(uint32_t dst,
                                             const __nv_bfloat16* base,
                                             long long stride, int key0,
                                             int key_end, int hd, int tid) {
  constexpr int kChunks = HDP / 8;
  static_assert(ROWS * kChunks % NT == 0, "whole rounds of 16-byte copies");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / kChunks, c = idx % kChunks;
    const int key = key0 + r;
    const bool ok = key < key_end && c * 8 < hd;
    const __nv_bfloat16* src = ok ? base + key * stride + c * 8 : base;
    load_chunk<VEC>(dst + tile_off<ROWS>(r, c), src, ok, c, hd);
  }
}

// Loads (query, head) rows [row0, row0 + ROWS) of one (batch, kv head)
// into a swizzled tile: row r is query s = r / g, head h = r % g of the
// kv head's group. Rows at or past n_rows are zero.
template <int HDP, int ROWS, int NT, bool VEC>
__device__ __forceinline__ void load_q_tile(uint32_t dst,
                                            const __nv_bfloat16* q,
                                            const Params& p, int b, int kvh,
                                            long long row0, long long n_rows,
                                            int tid) {
  constexpr int kChunks = HDP / 8;
  static_assert(ROWS * kChunks % NT == 0, "whole rounds of 16-byte copies");
  const int g = p.hq / p.hkv;
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / kChunks, c = idx % kChunks;
    const long long row = row0 + r;
    const bool ok = row < n_rows && c * 8 < p.hd;
    const __nv_bfloat16* src = q;
    if (ok) {
      const long long s = row / g, h = row % g;
      src = q + ((static_cast<long long>(b) * p.sq + s) * p.hq +
                 static_cast<long long>(kvh) * g + h) * p.hd + c * 8;
    }
    load_chunk<VEC>(dst + tile_off<ROWS>(r, c), src, ok, c, p.hd);
  }
}

// Scale, softcap and (where `masked`) mask the logits of this warp's
// tile in place, then the online-softmax step of its two rows per
// thread (rows lane / 4 and lane / 4 + 8 of the warp): the running max
// m, the per-thread partial sums l (of the unrounded probabilities),
// the accumulator o rescaled, and s replaced by the probabilities.
// qpos: the two rows' query positions; key0: the tile's first key;
// key_end: keys at or past it are masked.
template <int COLS, int KEYS>
__device__ __forceinline__ void softmax_tile(
    float (&s)[KEYS / 8][4], float (&o)[COLS / 8][4], float (&m)[2],
    float (&l)[2], const Params& p, bool masked, const int (&qpos)[2],
    int key0, int key_end, int lane) {
  const float inv_cap = p.cap > 0.f ? 1.f / p.cap : 0.f;
  float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * p.scale;
      if (p.cap > 0.f) x = p.cap * tanh_softcap(x * inv_cap);
      if (masked) {
        const int key = key0 + j * 8 + (lane & 3) * 2 + (e & 1);
        const int qp = qpos[e >> 1];
        bool ok = key < key_end;
        if (p.causal) ok = ok && key <= qp;
        if (p.window > 0) ok = ok && qp - key < p.window;
        x = ok ? x : kNegInf;
      }
      s[j][e] = x;
      row_max[e >> 1] = fmaxf(row_max[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(row_max[i]));
    alpha[i] = ex2((m[i] - m_new) * kLog2e);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
  // (x - m) first: for a masked logit under a row max that is still the
  // mask value this is exactly 0, as exp(x - m) in the reference; an
  // fma of x * log2(e) against a rounded m * log2(e) would leave about
  // 1e23 there and overflow.
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = ex2((s[j][e] - m[e >> 1]) * kLog2e);
      l[e >> 1] += pr;
      s[j][e] = pr;
    }
#pragma unroll
  for (int n = 0; n < COLS / 8; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

}  // namespace repro_flash
