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
// The f32 p.v variant (Params::pv32; the model under REPRO_PERF_OPTS=0
// and the Pallas kernel): every route has it, instantiated apart (the
// template flag PV32), so the default's code is what it was. bf16
// routes: v is exact in bf16, so p alone is split, hi = bf16(p) and
// lo = bf16(p - hi), two products into one f32 accumulator (about
// 2^-17 relative on p, against the bf16 output's 2^-9). tc_f32: p and v
// both split into TF32 halves, three mma.sync.m16n8k8 products, as its
// q . k (below).
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
// rows per (batch, kv head); route tc_f32 (below) takes f32.
//
// Route tc_f32 (f32 inputs): the same function on the tensor cores,
// redone for Hopper (the first port's kernel here ran scalar f32 FMAs
// from shared memory at 2% of its bound, slower than its own plain
// version). What bounds it on the card: operations, as tc_prefill, and
// in this design the instructions that feed the mma.sync units.
//
// q . k is a split TF32 product, a_lo b_hi + a_hi b_lo + a_hi b_hi on
// mma.sync.m16n8k8 (flash_mma.cuh), about f32's accuracy: hi is the
// cvt.rna rounding (tf32_hi: two integer operations, where the cvt's
// emulation costs four), lo = x - hi goes to the tensor core whole,
// which truncates it (the backward rounds its lo).
// A single TF32 product holds the f32 check on unit-sized logits but
// not on logits four times larger (tests/test_torch_flash_f32.py): its
// error grows with the logits, the split's does not. p.v takes p and v
// rounded to bf16 (the function's own rounding), an exact bf16 product
// on mma.sync.m16n8k16 with an f32 sum; V is rounded to bf16 once a tile
// into a 128-byte-swizzled tile that ldmatrix.trans reads as the B
// operand. The softmax runs in registers on the C layout (quad shuffles)
// with expf and libdevice's tanhf.
//
// A CTA of 8 warps owns 64 rows in four groups of 16 and walks 32-key
// tiles; the two warps of a row group each take 16 of a tile's keys and
// half of O's columns (64 registers of O a thread at hd 256, not 128),
// and exchange the tile's row max and the bf16 P through shared memory
// under a named barrier of the pair (P reaches p.v's A operand by
// ldmatrix). K and V stream as f32 through two cp.async stages (tile
// t + 1 loads while tile t computes); shared memory at hd 256: Q 64 KB
// + 2 x (K, V) 128 KB + bf16 V 16 KB + P 5 KB = 213 KB, one CTA an SM;
// below hd 256 two (registers held to 128 a thread). Q's and K's f32
// fragments are split as they load, by 8-byte loads (each k-step's
// columns go to the mma's k slots in the order 0 2 4 6 1 3 5 7 for both
// operands), and each term of the logits has its own accumulator (three
// mma chains of 32 k-steps a tile, not one of 96).
//
// Measured on an H100 SXM at 700 W (f32 causal softcap prefill [1, 8192,
// 16, 256] vs 8 kv heads): one warp a row group with all of the tile's
// keys and O's columns and P in registers (p.v's A operand is the
// logits' C layout) 15.3 ms, two warps 14.1; K split once a tile into
// shared hi and lo tiles (the staging then single) 17.4; one TF32
// product in place of three saved 7%: issued instructions, not the mma
// rate, set the pace (cvt.rna's emulation and the swizzled addresses
// took about 100 of a k-step's 130). 8-byte fragment loads and the
// two-operation split: 12.3 (one warp) and 10.4 (two); separate
// accumulators 9.9 with two warps (one warp lost 5% to 255 registers).
// One warp a row group won at hd 128 ([1, 4096, 8, 128] causal: 0.60 vs
// 0.74 ms, two CTAs an SM against one); one design is kept, two warps
// with two CTAs an SM below hd 256 (0.70 ms there, 20 bytes of spill).
// Tiles of 64 keys do not fit at hd 256 (Q 64 KB + 2 stages of 128 KB).
//
// The CTA walks only the key tiles some row of it can see, a row group
// skips a tile none of its rows sees, masks apply only on tiles that
// cross an edge, and the heaviest causal row blocks launch first. Where
// a row does not start on 16 bytes (hd not a multiple of 4, a tensor off
// a 16-byte boundary) the same kernel loads element by element (VEC =
// false). Every sum runs in a fixed order: two calls on the same inputs
// give the same bits.
#include <cuda_bf16.h>
#include <limits.h>

#include "common.cuh"
#include "flash_mma.cuh"
#include "flash_tiles.cuh"
#include "flash_wgmma.cuh"

namespace {

// ---------------------------------------------------------------- tc_f32

template <int HDP>
struct F32Tile {
  static constexpr int kThreads = 256;   // 8 warps, two a row group
  // CTAs an SM: two below hd 256 (registers held to 128 a thread)
  static constexpr int kMinBlocks = HDP == 256 ? 1 : 2;
  static constexpr int kRows = 64;             // (query, head) rows a CTA
  static constexpr int kKeys = 32;             // keys a tile
  static constexpr int kWarpKeys = kKeys / 2;  // a warp's keys of a tile
  static constexpr int kCols = HDP / 2;        // a warp's columns of O
  static constexpr int kQFloats = kRows * HDP;
  static constexpr int kKFloats = kKeys * HDP;   // one K or V tile in f32
  // the bf16 V tile: 64-column panels of 128-byte rows
  static constexpr int kVBytes = kKeys * 128 * ((HDP + 63) / 64);
  // bf16 P, rows of kKeys + 8 (80 bytes: ldmatrix's 8 rows fall in 8
  // bank groups)
  static constexpr int kPLd = kKeys + 8;
  static constexpr int kPBytes = kRows * kPLd * 2;
  // Q, 2 stages of (K, f32 V), the bf16 V, P
  static constexpr size_t kSmem =
      sizeof(float) * (kQFloats + 4 * kKFloats) + kVBytes + kPBytes;
};

// Whether every row of the f32 q, k, v and out starts on 16 bytes.
inline bool rows_aligned16_f32(const repro_flash::Params& p) {
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
      reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.out);
  return p.hd % 4 == 0 && any % 16 == 0;
}

// x as a TF32 pair: hi = tf32_hi(x), lo = x - hi (exact), passed
// whole: the tensor core reads its TF32 bits (truncating them).
__device__ __forceinline__ void split_fast(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = repro_flash::tf32_hi(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Scale, softcap (libdevice's tanhf, through the cap's f32 reciprocal
// as PyTorch divides by a scalar) and, where `masked`, mask a warp's
// logits of keys key0 + [0, KEYS) in place; each of the thread's two
// rows' max over them, reduced over the quad.
template <int KEYS>
__device__ __forceinline__ void f32_logits(float (&s)[KEYS / 8][4],
                                           float (&row_max)[2],
                                           const repro_flash::Params& p,
                                           bool masked, const int (&qpos)[2],
                                           int key0, int key_end, int lane) {
  using namespace repro_flash;
  const float inv_cap = p.cap > 0.f ? 1.f / p.cap : 0.f;
  row_max[0] = row_max[1] = kNegInf;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * p.scale;
      if (p.cap > 0.f) x = p.cap * tanhf(x * inv_cap);
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
  row_max[0] = quad_max(row_max[0]);
  row_max[1] = quad_max(row_max[1]);
}

// The online-softmax step after f32_logits, given the tile's row max:
// m moves to the new max, l (this thread's partial, of the unrounded
// probabilities) and o are rescaled, and s becomes exp(x - m) (expf;
// x - m first, so a masked logit under a row max that is still the
// mask value gives exactly 1, as the reference's exp(x - m)).
template <int KEYS, int COLS>
__device__ __forceinline__ void f32_softmax(float (&s)[KEYS / 8][4],
                                            float (&o)[COLS / 8][4],
                                            float (&m)[2], float (&l)[2],
                                            const float (&tile_max)[2]) {
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], tile_max[i]);
    alpha[i] = expf(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = expf(s[j][e] - m[e >> 1]);
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

// The two warps that share 16 rows (named barrier 1 + row group).
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg));
}

// VEC: rows_aligned16_f32 (tiles load by cp.async), else element-wise.
// PV32: the f32 p.v variant. P goes through shared memory as f32 (in
// the space of the bf16 V and P tiles, which it does not use: 8 KB in
// the at<kKeys> layout), and o += P . V is the split TF32 product of P
// and the f32 V stage, as S = Q . K^T is.
template <int HDP, bool VEC, bool PV32>
__global__ void __launch_bounds__(F32Tile<HDP>::kThreads,
                                  F32Tile<HDP>::kMinBlocks)
    flash_tc_f32_kernel(const repro_flash::Params p) {
  using C = F32Tile<HDP>;
  using namespace repro_flash;
  extern __shared__ __align__(128) float f32_smem[];
  __shared__ float pair_red[2][C::kRows];   // row max, then l
  float* qs = f32_smem;                       // [kRows][HDP], at<HDP>
  float* kbuf = qs + C::kQFloats;             // 2 x [kKeys][HDP]
  float* vbuf = kbuf + 2 * C::kKFloats;       // 2 x [kKeys][HDP], f32
  const uint32_t v_tile = smem_u32(vbuf + 2 * C::kKFloats);   // bf16
  const uint32_t p_tile = v_tile + C::kVBytes;   // bf16 [kRows][kPLd]
  // PV32: f32 P [kRows][kKeys], at<kKeys>, where the bf16 tiles were
  float* p_f32 = vbuf + 2 * C::kKFloats;
  static_assert(C::kRows * C::kKeys * sizeof(float) <=
                    C::kVBytes + C::kPBytes,
                "the f32 P tile fits the bf16 V and P tiles' space");
  const auto* q = static_cast<const float*>(p.q);
  const auto* k = static_cast<const float*>(p.k);
  const auto* v = static_cast<const float*>(p.v);
  auto* out = static_cast<float*>(p.out);

  const int g = p.hq / p.hkv;
  const long long rows = static_cast<long long>(p.sq) * g;
  const int n_rb = static_cast<int>((rows + C::kRows - 1) / C::kRows);
  const int heads = p.b * p.hkv;
  const int rb = n_rb - 1 - static_cast<int>(blockIdx.x / heads);
  const int bh = static_cast<int>(blockIdx.x % heads);
  const int b = bh / p.hkv, kvh = bh % p.hkv;
  const long long row0 = static_cast<long long>(rb) * C::kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto row_off = [&](long long row) {
    const long long s = row / g, h = row % g;
    return ((static_cast<long long>(b) * p.sq + s) * p.hq +
            static_cast<long long>(kvh) * g + h) * p.hd;
  };

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
  const long long kv0 = (static_cast<long long>(b) * p.skv * p.hkv + kvh) *
                        p.hd;
  auto load_stage = [&](int t) {
    const int key0 = t * C::kKeys, st = (t - t_lo) & 1;
    auto off = [&](int r) {
      return kv0 + static_cast<long long>(key0 + r) * stride;
    };
    load_tile<HDP, C::kKeys, C::kThreads>(kbuf + st * C::kKFloats, k,
                                          key_end - key0, p.hd, off, VEC);
    load_tile<HDP, C::kKeys, C::kThreads>(vbuf + st * C::kKFloats, v,
                                          key_end - key0, p.hd, off, VEC);
  };
  load_tile<HDP, C::kRows, C::kThreads>(
      qs, q, static_cast<int>(min(rows - row0, 1LL * C::kRows)), p.hd,
      [&](int r) { return row_off(row0 + r); }, VEC);
  if (t_lo < t_hi) load_stage(t_lo);
  cp_async_commit();

  // this warp's 16 rows (a tile none of them sees is skipped; a tile all
  // of them see whole is not masked), its keys and columns, and this
  // thread's two rows (lane / 4 and lane / 4 + 8)
  const int rg = warp & 3, kh = warp >> 2;
  const int m0 = 16 * rg, n0 = kh * C::kWarpKeys, col0 = kh * C::kCols;
  const long long w_row0 = row0 + m0;
  const bool w_live = w_row0 < rows;
  const long long w_last = min(w_row0 + 15, rows - 1);
  const int ws_first = static_cast<int>(min(w_row0, rows - 1) / g);
  const int ws_last = static_cast<int>(w_last / g);
  const int qpos[2] = {
      p.q_offset + static_cast<int>((w_row0 + (lane >> 2)) / g),
      p.q_offset + static_cast<int>((w_row0 + (lane >> 2) + 8) / g)};

  // The logits' fragments: each k-step's 8 columns k0 .. k0 + 7 go to
  // the mma's k slots in the order 0 2 4 6 1 3 5 7 for both operands
  // (slot t takes column k0 + 2t, slot t + 4 column k0 + 2t + 1; the
  // sum over the slots is the same), so a thread's two columns of a row
  // are one 8-byte load. In the at<HDP> layout column k0 + 2t of a row r
  // with r % 8 = lane / 4 lies at c0 + col[k0 / 8 % 4] (c0 = k0 rounded
  // down to 32): the warp's A rows (m0 + lane / 4, + 8) and B rows (keys
  // n0 + 8 j + lane / 4) all share it.
  int col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    col[j] = 8 * (j ^ ((lane >> 2) & 3)) +
             ((2 * (lane & 3)) ^ ((lane >> 2) & 4));
  const float* qa = qs + (m0 + (lane >> 2)) * HDP;

  float o[C::kCols / 8][4];
#pragma unroll
  for (int n = 0; n < C::kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    cp_async_wait<0>();
    __syncthreads();   // tile t is in; tile t - 1's readers are done
    if (t + 1 < t_hi) load_stage(t + 1);
    cp_async_commit();
    // V rounded to bf16 into the swizzled tile ldmatrix reads
    const float* vs = vbuf + st * C::kKFloats;
    if constexpr (!PV32) {
#pragma unroll
      for (int idx = tid; idx < C::kKeys * HDP / 4; idx += C::kThreads) {
        const int r = idx / (HDP / 4), c = (idx % (HDP / 4)) * 4;
        const float4 x =
            *reinterpret_cast<const float4*>(vs + at<HDP>(r, c));
        asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(
                         v_tile + tile_off<C::kKeys>(r, c >> 3) +
                         (c & 7) * 2),
                     "r"(pack_bf16(x.x, x.y)), "r"(pack_bf16(x.z, x.w)));
      }
    }
    const int key0 = t * C::kKeys, key_last = key0 + C::kKeys - 1;
    const bool seen = w_live &&
                      (!p.causal || key0 <= p.q_offset + ws_last) &&
                      (p.window <= 0 ||
                       key_last > p.q_offset + ws_first - p.window);
    float s[C::kWarpKeys / 8][4];
    if (seen) {
      // S = Q . K^T in split TF32: a chain over the head dim for each
      // term, added as (lo hi + hi lo) + hi hi
      const float* kb = kbuf + st * C::kKFloats + (n0 + (lane >> 2)) * HDP;
      float s2[C::kWarpKeys / 8][4], s3[C::kWarpKeys / 8][4];
#pragma unroll
      for (int j = 0; j < C::kWarpKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = s3[j][e] = 0.f;
#pragma unroll
      for (int c0 = 0; c0 < HDP; c0 += 32)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const float2 a0 = *reinterpret_cast<const float2*>(
              qa + c0 + col[ks]);
          const float2 a1 = *reinterpret_cast<const float2*>(
              qa + 8 * HDP + c0 + col[ks]);
          Frag<4, true> a;
          split_fast(a0.x, a.hi[0], a.lo[0]);
          split_fast(a1.x, a.hi[1], a.lo[1]);
          split_fast(a0.y, a.hi[2], a.lo[2]);
          split_fast(a1.y, a.hi[3], a.lo[3]);
#pragma unroll
          for (int j = 0; j < C::kWarpKeys / 8; ++j) {
            const float2 y = *reinterpret_cast<const float2*>(
                kb + 8 * j * HDP + c0 + col[ks]);
            Frag<2, true> bk;
            split_fast(y.x, bk.hi[0], bk.lo[0]);
            split_fast(y.y, bk.hi[1], bk.lo[1]);
            mma(s2[j], a.lo, bk.hi);
            mma(s3[j], a.hi, bk.lo);
            mma(s[j], a.hi, bk.hi);
          }
        }
#pragma unroll
      for (int j = 0; j < C::kWarpKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e] + s3[j][e];
      const bool masked =
          key_last >= key_end ||
          (p.causal && key_last > p.q_offset + ws_first) ||
          (p.window > 0 && key0 <= p.q_offset + ws_last - p.window);
      float tile_max[2];
      f32_logits<C::kWarpKeys>(s, tile_max, p, masked, qpos, key0 + n0,
                               key_end, lane);
      // the row max over both warps' keys (max: any order, same bits)
      if ((lane & 3) == 0) {
        pair_red[kh][m0 + (lane >> 2)] = tile_max[0];
        pair_red[kh][m0 + (lane >> 2) + 8] = tile_max[1];
      }
      pair_sync(rg);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        tile_max[i] = fmaxf(pair_red[0][m0 + (lane >> 2) + 8 * i],
                            pair_red[1][m0 + (lane >> 2) + 8 * i]);
      f32_softmax<C::kWarpKeys, C::kCols>(s, o, m, l, tile_max);
      // this warp's probabilities, rounded to bf16 (PV32: f32), for
      // both warps
#pragma unroll
      for (int j = 0; j < C::kWarpKeys / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = m0 + (lane >> 2) + 8 * i;
          const int c = n0 + 8 * j + (lane & 3) * 2;
          if constexpr (PV32) {
            // c is even: c and c + 1 stay neighbours under at's swizzle
            *reinterpret_cast<float2*>(p_f32 + at<C::kKeys>(r, c)) =
                make_float2(s[j][2 * i], s[j][2 * i + 1]);
          } else {
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                             p_tile + (r * C::kPLd + c) * 2),
                         "r"(pack_bf16(s[j][2 * i], s[j][2 * i + 1])));
          }
        }
      pair_sync(rg);
    }
    __syncthreads();   // the bf16 V tile is written
    if (seen) {
      if constexpr (PV32) {
        // o += P . V in split TF32: P (16 rows x 32 keys) and the f32 V
        // stage, each k-step's fragments split into hi and lo
#pragma unroll
        for (int k0 = 0; k0 < C::kKeys; k0 += 8) {
          float x[4];
          a_rows<C::kKeys>(p_f32, m0, k0, x);
          Frag<4, true> pa;
          pa.set(x);
#pragma unroll
          for (int n = 0; n < C::kCols / 8; ++n) {
            float y[2];
            b_cols<HDP>(vs, col0 + 8 * n, k0, y);
            Frag<2, true> vb;
            vb.set(y);
            mma_split(o[n], pa, vb);
          }
        }
      } else {
        // o += P . V: P (16 rows x 32 keys) from shared memory by
        // ldmatrix
#pragma unroll
        for (int ks = 0; ks < C::kKeys / 16; ++ks) {
          uint32_t a[4];
          ldsm_x4(p_tile + ((m0 + (lane & 15)) * C::kPLd + ks * 16 +
                            (lane >> 4) * 8) * 2,
                  a[0], a[1], a[2], a[3]);
          pv_k16<C::kKeys, C::kCols>(o, a, v_tile, ks, col0, lane);
        }
      }
    }
  }
  cp_async_wait<0>();

  // l: the two warps' partials of each row, in warp order
  float lt[2] = {quad_sum(l[0]), quad_sum(l[1])};
  __syncthreads();   // the last tile's pair_red readers are done
  if ((lane & 3) == 0) {
    pair_red[kh][m0 + (lane >> 2)] = lt[0];
    pair_red[kh][m0 + (lane >> 2) + 8] = lt[1];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lt[i] = pair_red[0][m0 + (lane >> 2) + 8 * i] +
            pair_red[1][m0 + (lane >> 2) + 8 * i];
  const float inv[2] = {1.f / fmaxf(lt[0], 1e-30f),
                        1.f / fmaxf(lt[1], 1e-30f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = w_row0 + (lane >> 2) + 8 * i;
    if (row >= rows) continue;
    float* o_row = out + row_off(row);
#pragma unroll
    for (int n = 0; n < C::kCols / 8; ++n) {
      const int d = col0 + n * 8 + (lane & 3) * 2;
      if (d >= p.hd) continue;
      const float x0 = o[n][2 * i] * inv[i], x1 = o[n][2 * i + 1] * inv[i];
      if constexpr (VEC) {
        *reinterpret_cast<float2*>(o_row + d) = make_float2(x0, x1);
      } else {
        o_row[d] = x0;
        if (d + 1 < p.hd) o_row[d + 1] = x1;
      }
    }
  }
}

template <int HDP, bool VEC, bool PV32>
cudaError_t launch_f32(const repro_flash::Params& p, cudaStream_t stream) {
  using C = F32Tile<HDP>;
  auto* kernel = flash_tc_f32_kernel<HDP, VEC, PV32>;
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

template <bool VEC, bool PV32>
cudaError_t launch_f32_hd(const repro_flash::Params& p, cudaStream_t stream) {
  // the tile layout (at<W>) needs rows of a multiple of 32 words
  if (p.hd <= 32) return launch_f32<32, VEC, PV32>(p, stream);
  if (p.hd <= 64) return launch_f32<64, VEC, PV32>(p, stream);
  if (p.hd <= 128) return launch_f32<128, VEC, PV32>(p, stream);
  return launch_f32<256, VEC, PV32>(p, stream);
}

template <bool PV32>
cudaError_t launch_f32_variant(const repro_flash::Params& p,
                               cudaStream_t stream) {
  return rows_aligned16_f32(p) ? launch_f32_hd<true, PV32>(p, stream)
                               : launch_f32_hd<false, PV32>(p, stream);
}

cudaError_t launch_tc_f32(const repro_flash::Params& p, cudaStream_t stream) {
  if (p.hd < 1 || p.hd > 256) return cudaErrorInvalidValue;
  return p.pv32 ? launch_f32_variant<true>(p, stream)
                : launch_f32_variant<false>(p, stream);
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
// PV32: the f32 p.v variant (a second wgmma of bf16(p - bf16(p)) a
// 16-key step).
template <int HDP, bool VEC, bool PV32>
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
        if constexpr (PV32) {
          uint32_t a_lo[4];
          p_operand_lo<C::kKeys>(a_lo, s, ks);
          wgmma_rs<HDP>(o, a_lo, gmma_desc(v_tile + ks * 16 * 128,
                                           kPanelKV, 1024));
        }
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

template <int HDP, bool VEC, bool PV32>
cudaError_t launch_tc(const repro_flash::Params& p, cudaStream_t stream) {
  using C = TcTile<HDP>;
  auto* kernel = flash_tc_prefill_kernel<HDP, VEC, PV32>;
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

template <bool VEC, bool PV32>
cudaError_t launch_tc_hd(const repro_flash::Params& p, cudaStream_t stream) {
  if (p.hd <= 64) return launch_tc<64, VEC, PV32>(p, stream);
  if (p.hd <= 128) return launch_tc<128, VEC, PV32>(p, stream);
  return launch_tc<256, VEC, PV32>(p, stream);
}

template <bool PV32>
cudaError_t launch_tc_variant(const repro_flash::Params& p,
                              cudaStream_t stream) {
  return repro_flash::rows_aligned16(p) ? launch_tc_hd<true, PV32>(p, stream)
                                        : launch_tc_hd<false, PV32>(p, stream);
}

cudaError_t launch_tc_prefill(const repro_flash::Params& p,
                              cudaStream_t stream) {
  if (p.hd < 1 || p.hd > 256) return cudaErrorInvalidValue;
  return p.pv32 ? launch_tc_variant<true>(p, stream)
                : launch_tc_variant<false>(p, stream);
}

}  // namespace

namespace repro_flash {
// flash_decode.cu
cudaError_t launch_split_decode(const Params& p, cudaStream_t stream);
}  // namespace repro_flash

// q [b, sq, hq, hd], k/v [b, skv, hkv, hd], out [b, sq, hq, hd], all
// contiguous; hq a multiple of hkv; 1 <= hd <= 256. route: 0 = tc_f32
// (f32), 1 = tc_prefill (bf16), 2 = split_decode (bf16, sq * hq / hkv
// <= 16, n_chunks >= 1 and scratch of b * hkv * n_chunks * sq *
// (hq / hkv) * (hd + 2) floats). Every route takes any alignment: rows
// that do not all start on 16 bytes load element by element. scale: the
// logit scale (1 / sqrt(hd), rounded once from double as the reference
// does); causal: 0/1; window <= 0: none; cap <= 0: no softcap; kv_len:
// keys at positions >= kv_len are masked; pv32: 1 for the route's f32
// p.v variant. Returns a CUDA error code; an unknown route or a shape it
// does not take is cudaErrorInvalidValue.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* scratch,
                                     int b, int sq, int skv, int hq, int hkv,
                                     int hd, float scale, int causal,
                                     int window, float cap, int q_offset,
                                     int kv_len, int route, int n_chunks,
                                     int pv32, void* stream) {
  if (b == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro_flash::Params p{q,     k,      v,        out,
                              static_cast<float*>(scratch),
                              b,     sq,     skv,      hq,     hkv,  hd,
                              scale, cap,    causal,   window, q_offset,
                              kv_len, n_chunks, pv32 != 0};
  cudaError_t err = cudaErrorInvalidValue;
  switch (route) {
    case 0:
      err = launch_tc_f32(p, s);
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
