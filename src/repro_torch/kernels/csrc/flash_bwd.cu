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
// Three launches, no atomics, so the same inputs give the same bits:
//  1. stats: one CTA per (batch, kv head, 64 rows) recomputes each row's
//     m, l and argmax over its visible keys, then writes dO' (f32
//     scratch, the q layout) and m, D, argmax (f32 scratch, four words a
//     row). The forward kernels stay as they are.
//  2. dq: one CTA per (batch, kv head, 64 rows) walks the key tiles the
//     rows can see, recomputing the logits and dP; dq in registers, the
//     argmax key's term added once dm is known; dm to the scratch.
//  3. dk/dv: one CTA per (batch, kv head, 32 keys) walks the rows that
//     can see its keys (all g query heads of the group: rows s * g + h,
//     as in the forward), 64 at a time, recomputing the logits and dP;
//     the key block's dk and dv stay in registers and are written once.
//
// Scalar f32 FMAs from shared memory (no tensor cores): a 16 x 16 grid
// of 256 threads, thread (ty, tx) owning rows ty + 16 i and keys
// tx + 16 j of a 64 x 32 tile, and columns tx + 16 c of the head dim.
// Tiles are f32 in shared memory, rows padded by one word. At head dim
// 256 the dk/dv and dq kernels hold Q, dO' (64 rows), K, V (32 keys) and
// one 64 x 32 tile of probabilities: 201 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kRows = 64;      // query rows a tile
constexpr int kKeys = 32;      // keys a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRowsPer = kRows / 16;
constexpr int kKeysPer = kKeys / 16;
constexpr float kNegInf = -1e30f;   // the forward's mask value

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
  int b, sq, skv, hq, hkv, hd;
  float scale, cap;
  int causal, window, q_offset, kv_len;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

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
  x = dot * p.scale;
  dcap = 1.f;
  if (p.cap > 0.f) {
    const float t = tanhf(x / p.cap);
    x = p.cap * t;
    dcap = 1.f - t * t;
  }
  bool ok = kv_pos < p.skv && kv_pos < p.kv_len;
  if (p.causal) ok = ok && kv_pos <= q_pos;
  if (p.window > 0) ok = ok && q_pos - kv_pos < p.window;
  return ok;
}

// n rows of a [b, s, h, hd] tensor of type T into shared memory as f32
// (rows LD words apart, zero past hd and past `valid` rows); `off(r)` is
// row r's element offset. `round` rounds each value to bf16.
template <int HDP, typename T, typename Off>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int n,
                                          int valid, int hd, Off off,
                                          bool round) {
  constexpr int LD = HDP + 1;
  for (int idx = threadIdx.x; idx < n * HDP; idx += kThreads) {
    const int r = idx / HDP, d = idx % HDP;
    const float x = r < valid && d < hd ? ld(src, off(r) + d) : 0.f;
    dst[r * LD + d] = round ? round_bf16(x) : x;
  }
}

// The 64 x 32 products a thread owns: acc[i][j] += a[ty + 16 i] . b[tx + 16 j]
// over the head dim, for two pairs of tiles at once.
template <int HDP>
__device__ __forceinline__ void two_products(
    const float* a0, const float* b0, const float* a1, const float* b1,
    float (&s0)[kRowsPer][kKeysPer], float (&s1)[kRowsPer][kKeysPer]) {
  constexpr int LD = HDP + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int j = 0; j < kKeysPer; ++j) s0[i][j] = s1[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; ++d) {
    float x0[kRowsPer], x1[kRowsPer], y0[kKeysPer], y1[kKeysPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      x0[i] = a0[(ty + 16 * i) * LD + d];
      x1[i] = a1[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < kKeysPer; ++j) {
      y0[j] = b0[(tx + 16 * j) * LD + d];
      y1[j] = b1[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        s0[i][j] += x0[i] * y0[j];
        s1[i][j] += x1[i] * y1[j];
      }
  }
}

// Key tiles [t_lo, t_hi) some row of [row0, row0 + kRows) can see.
__device__ __forceinline__ void key_tiles(const BwdParams& p, long long row0,
                                          long long rows, int& t_lo,
                                          int& t_hi) {
  const int g = p.hq / p.hkv;
  const long long last = (row0 + kRows < rows ? row0 + kRows : rows) - 1;
  const long long s_first = row0 / g, s_last = last / g;
  long long hi = p.skv < p.kv_len ? p.skv : p.kv_len;
  if (p.causal && p.q_offset + s_last + 1 < hi) hi = p.q_offset + s_last + 1;
  long long lo = 0;
  if (p.window > 0 && p.q_offset + s_first - p.window + 1 > lo)
    lo = p.q_offset + s_first - p.window + 1;
  t_lo = static_cast<int>(lo / kKeys);
  t_hi = hi > lo ? static_cast<int>((hi + kKeys - 1) / kKeys) : t_lo;
}

// ---------------------------------------------------------------- stats

// Max of (x, idx) pairs over the 16 lanes of a half warp, ties to the
// smaller index.
__device__ __forceinline__ void half_warp_argmax(float& x, int& idx) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    const float ox = __shfl_xor_sync(0xffffffffu, x, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    if (ox > x || (ox == x && oi < idx)) {
      x = ox;
      idx = oi;
    }
  }
}

// Pass 1: each row's m, l and first argmax key over its visible keys;
// then dO' = dout / l into `dos` and (m, D, 0, argmax) into `stats`.
template <int HDP, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_stats_kernel(const BwdParams p) {
  constexpr int LD = HDP + 1;
  constexpr int kCols = HDP / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [kRows][LD]
  float* ks = qs + kRows * LD;    // [kKeys][LD]
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* out = static_cast<const T*>(p.out);
  const T* dout = static_cast<const T*>(p.dout);
  const int g = p.hq / p.hkv;
  const int bb = blockIdx.x / p.hkv, kvh = blockIdx.x % p.hkv;
  const long long rows = static_cast<long long>(p.sq) * g;
  const long long row0 = static_cast<long long>(blockIdx.y) * kRows;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int n_valid = static_cast<int>(rows - row0 < kRows ? rows - row0
                                                           : kRows);
  load_rows<HDP>(qs, q, kRows, n_valid, p.hd,
                 [&](int r) { return row_off(p, bb, kvh, row0 + r); }, false);
  int q_pos[kRowsPer], arg[kRowsPer];
  float m[kRowsPer], l[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    q_pos[i] = p.q_offset + static_cast<int>((row0 + ty + 16 * i) / g);
    m[i] = kNegInf;
    l[i] = 0.f;
    arg[i] = 0;
  }
  int t_lo, t_hi;
  key_tiles(p, row0, rows, t_lo, t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int key0 = t * kKeys;
    __syncthreads();
    const int n_keys = p.skv - key0 < kKeys ? p.skv - key0 : kKeys;
    load_rows<HDP>(ks, k, kKeys, n_keys, p.hd,
                   [&](int r) { return key_off(p, bb, kvh, key0 + r); },
                   false);
    __syncthreads();
    float s[kRowsPer][kKeysPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float x[kRowsPer], y[kKeysPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) x[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) y[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPer; ++j) s[i][j] += x[i] * y[j];
    }
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      bool ok[kKeysPer];
      float tile_max = kNegInf;
      int tile_arg = INT_MAX;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        float dcap;
        const int key = key0 + tx + 16 * j;
        ok[j] = logit(p, s[i][j], q_pos[i], key, s[i][j], dcap);
        if (ok[j] && s[i][j] > tile_max) {
          tile_max = s[i][j];
          tile_arg = key;
        }
      }
      half_warp_argmax(tile_max, tile_arg);
      if (tile_max > m[i]) arg[i] = tile_arg;
      const float m_new = fmaxf(m[i], tile_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j)
        if (ok[j]) row_sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(row_sum);
      m[i] = m_new;
    }
  }
  // dO' = dout / l and D = dO' . out; zero for a row with no visible key
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    // every lane joins the half-warp sum: no early exit
    const long long row = row0 + ty + 16 * i;
    const bool valid = row < rows;
    const bool seen = l[i] > 0.f;
    const long long o = valid ? row_off(p, bb, kvh, row) : 0;
    float dsum = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (valid && d < p.hd) {
        const float x = seen ? ld(dout, o + d) / fmaxf(l[i], 1e-30f) : 0.f;
        p.dos[o + d] = x;
        dsum += x * ld(out, o + d);
      }
    }
    dsum = half_warp_sum(dsum);
    if (valid && tx == 0) {
      float* st4 = p.stats + o / p.hd * 4;
      st4[0] = seen ? m[i] : 0.f;
      st4[1] = dsum;
      st4[2] = 0.f;
      st4[3] = __int_as_float(seen ? arg[i] : -1);
    }
  }
}

// ---------------------------------------------------------------- dk, dv

// What a thread knows of each of its rows: the query position, whether
// the row exists, and its m, D, dm (the gradient autograd sends through
// the row max) and argmax key (-1: the row sees no key).
struct Rows {
  int q_pos[kRowsPer];
  bool ok[kRowsPer];
  float m[kRowsPer], dd[kRowsPer], dm[kRowsPer];
  int arg[kRowsPer];
};

__device__ __forceinline__ Rows load_row_stats(const BwdParams& p, int bb,
                                               int kvh, long long row0,
                                               long long row_end) {
  const int g = p.hq / p.hkv;
  const int ty = threadIdx.x >> 4;
  Rows r;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const long long row = row0 + ty + 16 * i;
    r.q_pos[i] = p.q_offset + static_cast<int>(row / g);
    r.ok[i] = row < row_end;
    r.m[i] = r.dd[i] = r.dm[i] = 0.f;
    r.arg[i] = -1;
    if (r.ok[i]) {
      const float* st4 = p.stats + row_off(p, bb, kvh, row) / p.hd * 4;
      r.m[i] = st4[0];
      r.dd[i] = st4[1];
      r.dm[i] = st4[2];
      r.arg[i] = __float_as_int(st4[3]);
    }
  }
  return r;
}

// One 64 x 32 tile of the gradient, shared by the dk/dv and dq kernels,
// from qs, dos_s (rows) and ks, vs (keys) in shared memory:
//   ds = (p~ (bf16(dO' . v) - D) + [key == argmax] dm) (1 - tanh^2)
// and, where `ps` is given, bf16(p~) into it; `dmsum` gathers the
// thread's share of sum_keys p~ (dP - D), of which dm = -sum.
template <int HDP>
__device__ __forceinline__ void grad_tile(
    const BwdParams& p, const float* qs, const float* dos_s, const float* ks,
    const float* vs, float* ps, const Rows& rw, int key0,
    float (&ds)[kRowsPer][kKeysPer], float (&dmsum)[kRowsPer]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[kRowsPer][kKeysPer], dp[kRowsPer][kKeysPer];
  two_products<HDP>(qs, ks, dos_s, vs, s, dp);
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int j = 0; j < kKeysPer; ++j) {
      // logit() sets x and dcap for every pair, rows past the block's
      // end included: their ds (0 * dcap) enters dk
      float x, dcap;
      const int key = key0 + tx + 16 * j;
      const bool ok = logit(p, s[i][j], rw.q_pos[i], key, x, dcap) &&
                      rw.ok[i];
      const float pt = ok ? expf(x - rw.m[i]) : 0.f;
      const float g = pt * (round_bf16(dp[i][j]) - rw.dd[i]);
      dmsum[i] += g;
      ds[i][j] = (g + (ok && key == rw.arg[i] ? rw.dm[i] : 0.f)) * dcap;
      if (ps != nullptr)
        ps[(ty + 16 * i) * (kKeys + 1) + tx + 16 * j] = round_bf16(pt);
    }
}

// Pass 3: dk and dv of 32 keys.
template <int HDP, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int LD = HDP + 1;
  constexpr int kCols = HDP / 16;
  extern __shared__ float smem[];
  float* ks = smem;                  // [kKeys][LD]
  float* vs = ks + kKeys * LD;       // [kKeys][LD], bf16-rounded
  float* qs = vs + kKeys * LD;       // [kRows][LD]
  float* dos_s = qs + kRows * LD;    // [kRows][LD]
  float* ps = dos_s + kRows * LD;    // [kRows][kKeys + 1]
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int g = p.hq / p.hkv;
  const int bb = blockIdx.x / p.hkv, kvh = blockIdx.x % p.hkv;
  const int key0 = blockIdx.y * kKeys;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int n_keys = p.skv - key0 < kKeys ? p.skv - key0 : kKeys;
  auto koff = [&](int r) { return key_off(p, bb, kvh, key0 + r); };
  load_rows<HDP>(ks, k, kKeys, n_keys, p.hd, koff, false);
  load_rows<HDP>(vs, v, kKeys, n_keys, p.hd, koff, true);

  float dk[kKeysPer][kCols], dv[kKeysPer][kCols];
#pragma unroll
  for (int i = 0; i < kKeysPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  // the rows that can see a key of [key0, key0 + kKeys)
  const long long key_end = p.skv < p.kv_len ? p.skv : p.kv_len;
  long long s_lo = 0, s_hi = p.sq;
  if (p.causal && key0 - static_cast<long long>(p.q_offset) > s_lo)
    s_lo = key0 - static_cast<long long>(p.q_offset);
  if (p.window > 0) {
    const long long end = static_cast<long long>(key0) + kKeys - 1 +
                          p.window - p.q_offset;
    if (end < s_hi) s_hi = end;
  }
  if (key0 >= key_end) s_hi = s_lo;
  const long long r_end = s_hi > s_lo ? s_hi * g : 0;
  for (long long rb = s_lo * g; rb < r_end; rb += kRows) {
    __syncthreads();   // the previous block's readers are done
    const int n_valid = static_cast<int>(r_end - rb < kRows ? r_end - rb
                                                            : kRows);
    auto roff = [&](int r) { return row_off(p, bb, kvh, rb + r); };
    load_rows<HDP>(qs, q, kRows, n_valid, p.hd, roff, false);
    load_rows<HDP>(dos_s, static_cast<const float*>(p.dos), kRows, n_valid,
                   p.hd, roff, false);
    const Rows rw = load_row_stats(p, bb, kvh, rb, r_end);
    __syncthreads();
    float ds[kRowsPer][kKeysPer], dmsum[kRowsPer] = {};
    grad_tile<HDP>(p, qs, dos_s, ks, vs, ps, rw, key0, ds, dmsum);
    __syncthreads();
    // dv += bf16(p~)^T dO' for keys ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      float pr[kKeysPer];
#pragma unroll
      for (int i = 0; i < kKeysPer; ++i)
        pr[i] = ps[r * (kKeys + 1) + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float x = dos_s[r * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kKeysPer; ++i) dv[i][c] += pr[i] * x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j)
        ps[(ty + 16 * i) * (kKeys + 1) + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dk += dS^T q
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      float pr[kKeysPer];
#pragma unroll
      for (int i = 0; i < kKeysPer; ++i)
        pr[i] = ps[r * (kKeys + 1) + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float x = qs[r * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kKeysPer; ++i) dk[i][c] += pr[i] * x;
      }
    }
  }
  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < kKeysPer; ++i) {
    const int key = key0 + ty + 16 * i;
    if (key >= p.skv) continue;
    const long long o = key_off(p, bb, kvh, key);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < p.hd) {
        st(dk_out, o + d, dk[i][c] * p.scale);
        st(dv_out, o + d, round_bf16(dv[i][c]));
      }
    }
  }
}

// ---------------------------------------------------------------- dq

// Pass 2: dq of 64 rows, and each row's dm (into `stats`) for pass 3.
template <int HDP, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = HDP + 1;
  constexpr int kCols = HDP / 16;
  extern __shared__ float smem[];
  float* ks = smem;                  // [kKeys][LD]
  float* vs = ks + kKeys * LD;       // [kKeys][LD], bf16-rounded
  float* qs = vs + kKeys * LD;       // [kRows][LD]
  float* dos_s = qs + kRows * LD;    // [kRows][LD]
  float* ps = dos_s + kRows * LD;    // [kRows][kKeys + 1]: dS
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int g = p.hq / p.hkv;
  const int bb = blockIdx.x / p.hkv, kvh = blockIdx.x % p.hkv;
  const long long rows = static_cast<long long>(p.sq) * g;
  const long long row0 = static_cast<long long>(blockIdx.y) * kRows;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int n_valid = static_cast<int>(rows - row0 < kRows ? rows - row0
                                                           : kRows);
  auto roff = [&](int r) { return row_off(p, bb, kvh, row0 + r); };
  load_rows<HDP>(qs, q, kRows, n_valid, p.hd, roff, false);
  load_rows<HDP>(dos_s, static_cast<const float*>(p.dos), kRows, n_valid,
                 p.hd, roff, false);
  Rows rw = load_row_stats(p, bb, kvh, row0, rows);   // dm still 0

  float dq[kRowsPer][kCols], dmsum[kRowsPer] = {};
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[i][c] = 0.f;

  int t_lo, t_hi;
  key_tiles(p, row0, rows, t_lo, t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int key0 = t * kKeys;
    __syncthreads();
    const int n_keys = p.skv - key0 < kKeys ? p.skv - key0 : kKeys;
    auto koff = [&](int r) { return key_off(p, bb, kvh, key0 + r); };
    load_rows<HDP>(ks, k, kKeys, n_keys, p.hd, koff, false);
    load_rows<HDP>(vs, v, kKeys, n_keys, p.hd, koff, true);
    __syncthreads();
    float ds[kRowsPer][kKeysPer];
    grad_tile<HDP>(p, qs, dos_s, ks, vs, nullptr, rw, key0, ds, dmsum);
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j)
        ps[(ty + 16 * i) * (kKeys + 1) + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dq += dS k for rows ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      float pr[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
        pr[i] = ps[(ty + 16 * i) * (kKeys + 1) + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float x = ks[key * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) dq[i][c] += pr[i] * x;
      }
    }
  }
  // the row max's term: dm = -sum p~ (dP - D), on the argmax key's
  // logit, with the softcap's derivative there, 1 - (m / cap)^2
  T* dq_out = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const float dm = -half_warp_sum(dmsum[i]);   // every lane joins
    const long long row = row0 + ty + 16 * i;
    if (row >= rows) continue;
    const long long o = row_off(p, bb, kvh, row);
    float w = 0.f;
    long long ko = 0;
    if (rw.arg[i] >= 0) {
      const float t = p.cap > 0.f ? rw.m[i] / p.cap : 0.f;
      w = dm * (1.f - t * t);
      ko = key_off(p, bb, kvh, rw.arg[i]);
      if (tx == 0) p.stats[o / p.hd * 4 + 2] = dm;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < p.hd) {
        const float kx = rw.arg[i] >= 0 ? ld(k, ko + d) : 0.f;
        st(dq_out, o + d, (dq[i][c] + w * kx) * p.scale);
      }
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s,
                   const BwdParams& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int HDP, typename T>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t s) {
  constexpr size_t LD = HDP + 1;
  const long long rows = static_cast<long long>(p.sq) * (p.hq / p.hkv);
  const long long row_blocks = (rows + kRows - 1) / kRows;
  const long long key_blocks = (p.skv + kKeys - 1) / kKeys;
  if (row_blocks > 65535 || key_blocks > 65535) return cudaErrorInvalidValue;
  const unsigned heads = static_cast<unsigned>(p.b * p.hkv);
  const size_t stats_smem = sizeof(float) * (kRows + kKeys) * LD;
  const size_t grad_smem = sizeof(float) * ((2 * kRows + 2 * kKeys) * LD +
                                            kRows * (kKeys + 1));
  cudaError_t err = launch(flash_bwd_stats_kernel<HDP, T>,
                           dim3(heads, static_cast<unsigned>(row_blocks)),
                           stats_smem, s, p);
  if (err != cudaSuccess) return err;
  err = launch(flash_bwd_dq_kernel<HDP, T>,
               dim3(heads, static_cast<unsigned>(row_blocks)), grad_smem, s,
               p);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dkdv_kernel<HDP, T>,
                dim3(heads, static_cast<unsigned>(key_blocks)), grad_smem, s,
                p);
}

template <typename T>
cudaError_t launch_bwd_hd(const BwdParams& p, cudaStream_t s) {
#define REPRO_FLASH_BWD_HD(HDP) \
  if (p.hd <= HDP) return launch_bwd<HDP, T>(p, s);
  REPRO_FLASH_BWD_HD(16)
  REPRO_FLASH_BWD_HD(32)
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
// stats: b * sq * hq * 4 floats of scratch. scale, causal, window, cap,
// q_offset and kv_len as repro_flash_attention's, with which `out` was
// computed. Writes every element of dq, dk and dv. Returns a CUDA error
// code (cudaErrorInvalidValue for a shape it does not take).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, float* dos, float* stats,
    int b, int sq, int skv, int hq, int hkv, int hd, float scale, int causal,
    int window, float cap, int q_offset, int kv_len, int bf16, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv || hd < 1 ||
      hd > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{q,     k,   v,     out,    dout,   dq,       dk,
                    dv,    dos, stats, b,      sq,     skv,      hq,
                    hkv,   hd,  scale, cap,    causal, window,   q_offset,
                    kv_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_bwd_hd<__nv_bfloat16>(p, s)
                               : launch_bwd_hd<float>(p, s);
  return static_cast<int>(err);
}
