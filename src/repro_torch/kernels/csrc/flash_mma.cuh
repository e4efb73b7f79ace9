// The mma.sync pieces shared by the f32 attention forward (flash.cu,
// route tc_f32), its backward (flash_bwd.cu) and the decode route
// (flash_decode.cu): f32 tiles in shared memory in a layout that both
// orientations of an mma fragment read without bank conflicts, split
// TF32 products, and the bf16 products with ldmatrix.
//
// Split TF32 ("3xTF32", CUTLASS's OpMultiplyAddFastF32): an f32 operand
// x is hi = rna_tf32(x) plus lo = rna_tf32(x - hi) (cvt.rna.tf32.f32: to
// nearest, ties away), and a . b = a_lo b_hi + a_hi b_lo + a_hi b_hi on
// mma.sync.m16n8k8. Each product of two TF32 numbers is exact in f32;
// the dropped a_lo b_lo and lo's own rounding leave about 2^-21 of a
// term, against f32's 2^-24. An operand exact in TF32 (a bf16 value) has
// lo = 0 and its term is not issued.
//
// f32 tiles: W words a row (W a multiple of 32), row r's column c at
// r * W + (c ^ swz(r)), swz(r) = 8 (r & 3) + (r & 4). The A/B fragment
// loads of rows (16 rows x 4 columns) and of columns (4 rows x 8
// columns) are then free of bank conflicts, and every 16-byte chunk of a
// row stays whole for cp.async and 16-byte loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace repro_flash {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

// ------------------------------------------------------ shared tiles

// Row r, column c of a W-wide f32 tile (W a multiple of 32).
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }
template <int W>
__device__ __forceinline__ int at(int r, int c) {
  return r * W + (c ^ swz(r));
}

// Rows [0, N) of a W-wide tile from rows of type T: row r's first hd
// elements at element offset off(r); zeros past hd and from row `valid`
// on. f32 rows on 16 bytes (`vec`) go by cp.async, 16 bytes a chunk (the
// caller commits and waits); bf16 rows on 8 bytes by 8-byte loads; the
// rest element by element.
template <int W, int N, int NT, typename T, typename Off>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int valid, int hd, Off off,
                                          bool vec) {
  constexpr int C4 = W / 4;
  for (int idx = threadIdx.x; idx < N * C4; idx += NT) {
    const int r = idx / C4, c = (idx % C4) * 4;
    float* d = dst + at<W>(r, c);
    const bool ok = r < valid && c < hd;
    float x[4];
    if constexpr (sizeof(T) == 4) {
      if (vec) {
        cp_async16(smem_u32(d), ok ? src + off(r) + c : src, ok);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = ok && c + e < hd ? ld(src, off(r) + c + e) : 0.f;
    } else {
      if (vec && ok) {
        const uint2 w = *reinterpret_cast<const uint2*>(src + off(r) + c);
        x[0] = __uint_as_float(w.x << 16);
        x[1] = __uint_as_float(w.x & 0xffff0000u);
        x[2] = __uint_as_float(w.y << 16);
        x[3] = __uint_as_float(w.y & 0xffff0000u);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = ok && c + e < hd ? ld(src, off(r) + c + e) : 0.f;
      }
    }
    *reinterpret_cast<float4*>(d) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// ------------------------------------------------------ split products

// An lane's place in an mma: g = lane / 4 (rows g, g + 8 of A and C,
// column g of B), t = lane % 4 (columns t, t + 4 of A, rows of B; C
// columns 2t, 2t + 1).
struct Lane {
  int g, t;
};
__device__ __forceinline__ Lane lane_of() {
  const int l = threadIdx.x & 31;
  return {l >> 2, l & 3};
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// hi: x rounded to TF32 to nearest, ties away, in two integer operations
// (cvt.rna's emulation in SASS takes four: it also tests for infinity).
// The bits of tf32(x) for every x but a NaN, which may come out as
// another value: a caller keeps the NaN in lo, which x - hi makes NaN.
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An operand fragment of N words: hi and, where SPLIT, lo (see the
// header); without SPLIT the values are exact in TF32 and pass as they
// are.
template <int N, bool SPLIT>
struct Frag {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (SPLIT) {
        hi[i] = tf32_hi(x[i]);
        lo[i] = tf32(x[i] - __uint_as_float(hi[i]));
      } else {
        hi[i] = __float_as_uint(x[i]);
      }
    }
  }
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c += a b: the small terms first, then hi . hi
template <bool SA, bool SB>
__device__ __forceinline__ void mma_split(float (&c)[4],
                                          const Frag<4, SA>& a,
                                          const Frag<2, SB>& b) {
  if constexpr (SA) mma(c, a.lo, b.hi);
  if constexpr (SB) mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}
// acc += a b: one k-step's chain from zero, added into acc with
// round-to-nearest f32 adds (the tensor cores align their addends to the
// largest and truncate; flash_bwd.cu's header says why that matters
// there)
template <bool SA, bool SB>
__device__ __forceinline__ void mma_add(float (&acc)[4],
                                        const Frag<4, SA>& a,
                                        const Frag<2, SB>& b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_split(d, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// Fragments at (m0 or n0, k0). a_rows / b_rows: the tile's rows are the
// product's m (n), its columns the reduction; a_cols / b_cols: the
// tile's rows are the reduction.
template <int W>
__device__ __forceinline__ void a_rows(const float* s, int m0, int k0,
                                       float (&a)[4]) {
  const Lane l = lane_of();
  a[0] = s[at<W>(m0 + l.g, k0 + l.t)];
  a[1] = s[at<W>(m0 + l.g + 8, k0 + l.t)];
  a[2] = s[at<W>(m0 + l.g, k0 + l.t + 4)];
  a[3] = s[at<W>(m0 + l.g + 8, k0 + l.t + 4)];
}
template <int W>
__device__ __forceinline__ void a_cols(const float* s, int m0, int k0,
                                       float (&a)[4]) {
  const Lane l = lane_of();
  a[0] = s[at<W>(k0 + l.t, m0 + l.g)];
  a[1] = s[at<W>(k0 + l.t, m0 + l.g + 8)];
  a[2] = s[at<W>(k0 + l.t + 4, m0 + l.g)];
  a[3] = s[at<W>(k0 + l.t + 4, m0 + l.g + 8)];
}
template <int W>
__device__ __forceinline__ void b_rows(const float* s, int n0, int k0,
                                       float (&b)[2]) {
  const Lane l = lane_of();
  b[0] = s[at<W>(n0 + l.g, k0 + l.t)];
  b[1] = s[at<W>(n0 + l.g, k0 + l.t + 4)];
}
template <int W>
__device__ __forceinline__ void b_cols(const float* s, int n0, int k0,
                                       float (&b)[2]) {
  const Lane l = lane_of();
  b[0] = s[at<W>(k0 + l.t, n0 + l.g)];
  b[1] = s[at<W>(k0 + l.t + 4, n0 + l.g)];
}

// ------------------------------------------------------ bf16 products

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a . b for one 16 x 8 x 16 tile (A row-major, B column-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// o += A . V[16 ks .. 16 ks + 16, col0 .. col0 + COLS): A a 16 x 16 bf16
// fragment (16 rows, keys 16 ks ..), V a bf16 tile of KEYS keys in the
// 128-byte swizzle (tile_off), read transposed by ldmatrix.trans.
template <int KEYS, int COLS>
__device__ __forceinline__ void pv_k16(float (&o)[COLS / 8][4],
                                       const uint32_t (&a)[4],
                                       uint32_t v_tile, int ks, int col0,
                                       int lane) {
#pragma unroll
  for (int dn = 0; dn < COLS / 16; ++dn) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4_t(v_tile + tile_off<KEYS>(ks * 16 + ((lane >> 3) & 1) * 8 +
                                          (lane & 7),
                                      col0 / 8 + dn * 2 + (lane >> 4)),
              b0, b1, b2, b3);
    mma_bf16(o[2 * dn], a, b0, b1);
    mma_bf16(o[2 * dn + 1], a, b2, b3);
  }
}

// pv_k16 for the f32 p.v variant: o += (A_hi + A_lo) . V, each V
// fragment read once and multiplied by both (A_hi first).
template <int KEYS, int COLS>
__device__ __forceinline__ void pv_k16_hilo(float (&o)[COLS / 8][4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&a_lo)[4],
                                            uint32_t v_tile, int ks,
                                            int col0, int lane) {
#pragma unroll
  for (int dn = 0; dn < COLS / 16; ++dn) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4_t(v_tile + tile_off<KEYS>(ks * 16 + ((lane >> 3) & 1) * 8 +
                                          (lane & 7),
                                      col0 / 8 + dn * 2 + (lane >> 4)),
              b0, b1, b2, b3);
    mma_bf16(o[2 * dn], a, b0, b1);
    mma_bf16(o[2 * dn + 1], a, b2, b3);
    mma_bf16(o[2 * dn], a_lo, b0, b1);
    mma_bf16(o[2 * dn + 1], a_lo, b2, b3);
  }
}

// o += P . V[:, col0 .. col0 + COLS): P the probabilities s (a KEYS-key
// logits tile in the C layout) rounded to bf16 in registers, which is
// the A operand's layout; with PV32 (the f32 p.v variant) P is
// bf16(p) + bf16(p - bf16(p)), two products (p_operand_lo).
template <int KEYS, int COLS, bool PV32 = false>
__device__ __forceinline__ void pv_cols(float (&o)[COLS / 8][4],
                                        const float (&s)[KEYS / 8][4],
                                        uint32_t v_tile, int col0, int lane) {
#pragma unroll
  for (int ks = 0; ks < KEYS / 16; ++ks) {
    uint32_t a[4];
    p_operand<KEYS>(a, s, ks);
    if constexpr (PV32) {
      uint32_t a_lo[4];
      p_operand_lo<KEYS>(a_lo, s, ks);
      pv_k16_hilo<KEYS, COLS>(o, a, a_lo, v_tile, ks, col0, lane);
    } else {
      pv_k16<KEYS, COLS>(o, a, v_tile, ks, col0, lane);
    }
  }
}

}  // namespace repro_flash
