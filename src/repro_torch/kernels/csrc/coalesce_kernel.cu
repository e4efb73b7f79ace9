// coalesce for Hopper: replaces kernels/coalesce_kernel.py::coalesce (the
// Pallas grid over rows; per row Hillis-Steele prefix sums over a VMEM
// block, then scatters of run heads and run ends).
//
// Per offset-sorted row it merges every run with off[i] + len[i] ==
// off[i+1] and compacts the runs to the front: (run offset, run length)
// pairs, PAD_OFFSET / 0 behind them, and the run count. It computes what
// the TPU kernel computes, including its handling of padding: a pad
// entry is a run boundary, run ids count pad runs, and slots at or past
// the number of run heads are padding. Ends and length sums wrap as the
// TPU's int32 arithmetic does.
//
// Design: one launch; each row is a thread-block cluster of
// ceil(n / 4096) CTAs (at most 8, the portable cluster size; 128 CTAs at
// the TAM path's [16, 32768]), each CTA one tile of 4096 entries, 512
// threads of eight. A CTA loads its tile once (two 16-byte loads a lane
// and array; neighbours' ends come by shuffles and shared memory, the
// entries on either side of the tile from device memory, issued first),
// marks boundaries, and scans its boundaries, heads and non-pad length
// sums across the block. Then, in tile terms (local run ids, length
// prefixes from the tile's start), it stages its outputs in shared
// memory: each boundary entry its offset and its run's start, each
// run's last entry its inclusive prefix. It pushes its tile's totals
// (16 bytes: boundaries, heads, length sum, and the start at its last
// boundary, 0 for a pad) into the shared memory of every CTA of its row
// through distributed shared memory; one cluster barrier later each CTA
// holds all of its row's totals locally, which give it its run base,
// its length base, the start of the run open at its first entry (from
// the nearest earlier tile with a boundary) and the row's run count. No
// global scratch, no look-back, no second launch, and no CTA touches
// another's shared memory after the barrier, so none waits at its end.
// Every output word is written exactly once, by coalesced stores from
// the staged tables: slots [run base, run base + the tile's boundaries)
// the tile's run offsets, the lengths of the runs that end in the tile,
// and the tile's share of the padding slots [B, n) (B: the row's
// boundaries), counted back from the row's end.
//
// What bounds it: device memory, at 16 bytes an entry (8 read, 8
// written); at the path's 16 rows of 32768 that is 2.5 us, so latency
// dominates: the tile's loads, two block barriers of the scan, one
// cluster barrier. Two CTAs fit an SM (48 registers, 55 KB of tables),
// so cudaOccupancyMaxActiveClusters on the H100 gives 30 clusters of 8
// and the path's 16 rows run in one wave (1024-thread CTAs, one an SM,
// gave 15).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 4096;        // entries a CTA of the cluster holds
constexpr int kPer = 8;            // entries a thread holds
constexpr int kThreads = kTile / kPer;
constexpr int kMaxCluster = 8;     // tiles of a row: n <= 32768

// Shared tables indexed by run id: one word skipped every 8, so that a
// warp whose lanes hold 8 runs each (a row of padding) hits 32 banks.
constexpr int kTable = kTile + 1 + (kTile + 1) / 8 + 1;
__device__ __forceinline__ int sx(int k) { return k + (k >> 3); }

// What a tile publishes to the CTAs of its row's cluster, in 16 bytes:
// x its boundary entries and heads (boundaries that are not pads; each
// at most 4096, 13 bits) and whether its last boundary is a pad; y its
// non-pad length sum (wrapping); z the exclusive length prefix in the
// tile at its last boundary (unused if that boundary is a pad: 0).
__device__ __forceinline__ int pack_counts(int n_bound, int n_head,
                                           int last_pad) {
  return n_bound | n_head << 13 | last_pad << 26;
}

__device__ __forceinline__ int wrap_end(int off, int len) {
  return static_cast<int>(static_cast<unsigned>(off) +
                          static_cast<unsigned>(len));
}

// Exclusive scan of two wrapping words per thread across the block;
// blockDim.x is a multiple of 32. `sums` is shared scratch of 32 uint2.
__device__ __forceinline__ uint2 block_scan2(uint2 v, uint2* sums,
                                             uint2* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  uint2 x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned a = __shfl_up_sync(0xffffffffu, x.x, d);
    const unsigned b = __shfl_up_sync(0xffffffffu, x.y, d);
    if (lane >= d) { x.x += a; x.y += b; }
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint2 w = lane < n_warps ? sums[lane] : make_uint2(0u, 0u);
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned a = __shfl_up_sync(0xffffffffu, w.x, d);
      const unsigned b = __shfl_up_sync(0xffffffffu, w.y, d);
      if (lane >= d) { w.x += a; w.y += b; }
    }
    sums[lane] = w;
  }
  __syncthreads();
  const uint2 before = warp == 0 ? make_uint2(0u, 0u) : sums[warp - 1];
  *total = sums[n_warps - 1];
  return make_uint2(before.x + x.x - v.x, before.y + x.y - v.y);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
coalesce_cluster_kernel(const int* __restrict__ off_in,
                        const int* __restrict__ len_in,
                        int* __restrict__ off_out, int* __restrict__ len_out,
                        int* __restrict__ counts, int n, int tiles) {
  __shared__ int4 s_row[kMaxCluster];          // every tile's totals
  __shared__ uint2 s_scan[32];
  __shared__ int s_warp_end[32], s_warp_off[32];
  __shared__ int s_first_end, s_last_end;      // which edge runs end here
  // in tile terms, through sx: by local run id, the offsets of the
  // tile's boundary entries; by local run id + 1 (0 is the run open at
  // the tile's first entry), each run's start (for a pad's run: 1 if it
  // is the pad alone) and the inclusive length prefix at its last entry
  extern __shared__ unsigned s_tables[];
  int* s_off = reinterpret_cast<int*>(s_tables);
  unsigned* s_start = s_tables + kTable;
  unsigned* s_incl = s_tables + 2 * kTable;

  cg::cluster_group cluster = cg::this_cluster();
  const int tile = static_cast<int>(cluster.block_rank());
  const long long row = static_cast<long long>(blockIdx.x / tiles) * n;
  const int* off = off_in + row;
  const int* len = len_in + row;
  int* oo = off_out + row;
  int* ol = len_out + row;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = tile * kTile;
  const int tile_len = min(kTile, n - t0);
  const int i0 = t0 + static_cast<int>(threadIdx.x) * kPer;
  const int left = n - i0;        // entries from my first to the row's end
  const int cnt = max(0, min(kPer, left));

  // ---- the entries beside the tile (device memory, issued first), then
  // the tile once: 16 bytes a load where rows are aligned
  int before_off = -1, before_len = 0, after_off = repro::kPadOffset;
  if (threadIdx.x == 0 && t0 > 0) {
    before_off = off[t0 - 1];
    before_len = len[t0 - 1];
  }
  const bool tile_end = cnt > 0 && i0 + cnt == t0 + tile_len;
  if (tile_end && t0 + tile_len < n) after_off = off[t0 + tile_len];
  if (threadIdx.x == 0) s_first_end = s_last_end = 0;
  int o[kPer], l[kPer];
  // The 16-byte loads are chosen on the entries left in the row, not on
  // cnt == kPer: built by nvcc 12.8 for sm_90a, that test (one VIMNMX with
  // the min and max above) also sent threads with fewer entries (the
  // row's last, and those past it) down this path, to read past the row.
  // What they read was never used, so the results held, but a row whose
  // buffer ends a mapping faulted.
  if (kVec && left >= kPer) {
#pragma unroll
    for (int q = 0; q < kPer; q += 4) {
      const int4 a = *reinterpret_cast<const int4*>(off + i0 + q);
      const int4 b = *reinterpret_cast<const int4*>(len + i0 + q);
      o[q] = a.x; o[q + 1] = a.y; o[q + 2] = a.z; o[q + 3] = a.w;
      l[q] = b.x; l[q + 1] = b.y; l[q + 2] = b.z; l[q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      o[j] = j < cnt ? off[i0 + j] : repro::kPadOffset;
      l[j] = j < cnt ? len[i0 + j] : 0;
    }
  }
  // the end of my last entry; only a row's last thread holds fewer than
  // kPer, and nothing reads its end
  const int my_end = wrap_end(o[kPer - 1], l[kPer - 1]);
  if (lane == 31) s_warp_end[warp] = my_end;
  if (lane == 0) s_warp_off[warp] = o[0];
  const int end_up = __shfl_up_sync(0xffffffffu, my_end, 1);
  const int off_down = __shfl_down_sync(0xffffffffu, o[0], 1);
  __syncthreads();

  // ---- boundaries: the end before this thread's first entry, and the
  // offset after its last
  int prev_end;
  if (threadIdx.x == 0) {
    prev_end = t0 == 0 ? -1 : wrap_end(before_off, before_len);
  } else {
    prev_end = lane == 0 ? s_warp_end[warp - 1] : end_up;
  }
  bool last_bd = true;            // the entry after my last is a boundary
  if (cnt > 0 && i0 + cnt < n) {
    const int nxt = tile_end ? after_off
                    : lane == 31 ? s_warp_off[warp + 1] : off_down;
    last_bd = nxt != my_end || nxt == repro::kPadOffset;
  }
  bool bd[kPer], pad[kPer];
  int n_bound = 0, n_head = 0;
  unsigned len_sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = j > 0 ? j - 1 : 0;          // a constant index
    const int pe = j == 0 ? prev_end : wrap_end(o[i], l[i]);
    pad[j] = o[j] == repro::kPadOffset;
    bd[j] = j < cnt && (o[j] != pe || pad[j]);
    n_bound += bd[j];
    n_head += bd[j] && !pad[j];
    len_sum += j < cnt && !pad[j] ? static_cast<unsigned>(l[j]) : 0u;
  }

  // ---- the tile's scan: boundaries | heads << 16 (each <= 4096), lengths
  uint2 tile_tot;
  const uint2 ex = block_scan2(
      make_uint2(static_cast<unsigned>(n_bound | n_head << 16), len_sum),
      s_scan, &tile_tot);
  const int bound_before = static_cast<int>(ex.x & 0xffffu);
  const int tile_bound = static_cast<int>(tile_tot.x & 0xffffu);

  // ---- stage the tile in shared memory, in tile terms (local run ids,
  // length prefixes from the tile's start), while the cluster's other
  // tiles get to the same point: each boundary entry its offset and its
  // run's start (for a pad: 1 if the pad's run is the pad alone), each
  // run's last entry its inclusive prefix; and publish the tile's totals
  int k = bound_before;           // local id of my next run
  unsigned cs = ex.y;
  unsigned last_start = 0u;
  int last_pad = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    // past a thread's last entry comes the row's end or last_bd
    const bool next_bd = j + 1 < cnt ? bd[j + 1 < kPer ? j + 1 : j]
                                     : last_bd;
    if (bd[j]) {                  // never past cnt
      s_off[sx(k)] = o[j];
      s_start[sx(k + 1)] = pad[j] ? next_bd : cs;
      last_start = cs;
      last_pad = pad[j];
      ++k;
    }
    cs += j < cnt && !pad[j] ? static_cast<unsigned>(l[j]) : 0u;
    if (j < cnt && next_bd) {     // k: my run's id less the run base, +1
      s_incl[sx(k)] = cs;
      if (k == 0) {
        s_first_end = 1;
      } else if (k == tile_bound) {
        s_last_end = 1;
      }
    }
  }
  // the tile's totals go to every CTA of the row (distributed shared
  // memory stores, done before the barrier lets anyone past)
  const bool publish_len = threadIdx.x == 0;
  const bool publish_last = n_bound > 0 && k == tile_bound;
  if (publish_len || publish_last) {
    for (int t = 0; t < tiles; ++t) {
      int4& dst = cluster.map_shared_rank(s_row, t)[tile];
      if (publish_len) {
        dst.y = static_cast<int>(tile_tot.y);
        if (tile_bound == 0) dst.x = dst.z = 0;
      }
      if (publish_last) {                 // the tile's last boundary
        dst.x = pack_counts(tile_bound, static_cast<int>(tile_tot.x >> 16),
                            last_pad);
        dst.z = static_cast<int>(last_start);
      }
    }
  }
  cluster.sync();                 // totals pushed, tables staged

  // ---- every warp sums the totals of the tiles before its own (lane t
  // holds tile t's)
  const int4 tot = lane < tiles ? s_row[lane] : make_int4(0, 0, 0, 0);
  int run_base = 0, nonb_before = 0, n_runs = 0;
  unsigned len_base = 0u, carry = 0u;
  for (int t = 0; t < tiles; ++t) {
    const int counts_t = __shfl_sync(0xffffffffu, tot.x, t);
    const int n_bound_t = counts_t & 0x1fff;
    n_runs += counts_t >> 13 & 0x1fff;
    if (t < tile) {
      const unsigned len_t = __shfl_sync(0xffffffffu, tot.y, t);
      const unsigned start_t = __shfl_sync(0xffffffffu, tot.z, t);
      if (n_bound_t > 0) carry = counts_t >> 26 ? 0u : len_base + start_t;
      run_base += n_bound_t;
      nonb_before += min(kTile, n - t * kTile) - n_bound_t;
      len_base += len_t;
    }
  }

  // ---- coalesced stores, each output word once: the tile's run
  // offsets (a pad's, or past the run count: padding), the lengths of
  // the runs that end in it (all but the two at its edges do; past the
  // run count 0), its padding share
#pragma unroll 4
  for (int q = threadIdx.x; q < tile_bound; q += blockDim.x) {
    const int v = s_off[sx(q)];
    oo[run_base + q] = run_base + q >= n_runs ? repro::kPadOffset : v;
  }
#pragma unroll 4
  for (int q = threadIdx.x; q <= tile_bound; q += blockDim.x) {
    const int r = run_base - 1 + q;
    const bool ended = q == 0 ? s_first_end && r >= 0
                       : q < tile_bound || s_last_end;
    if (ended) {
      unsigned length = 0u;
      if (r < n_runs) {
        const unsigned start = s_start[sx(q)];
        const unsigned incl = len_base + s_incl[sx(q)];
        if (q == 0) {                             // the run carried in
          length = incl - carry;
        } else if (s_off[sx(q - 1)] != repro::kPadOffset) {
          length = incl - (len_base + start);
        } else if (start == 0u) {                 // a pad's run goes on
          length = incl;
        }
      }
      ol[r] = static_cast<int>(length);
    }
  }
  const int nonb = tile_len - tile_bound;
  const int pad0 = n - nonb_before - nonb;
  for (int q = threadIdx.x; q < nonb; q += blockDim.x) {
    oo[pad0 + q] = repro::kPadOffset;
    ol[pad0 + q] = 0;
  }
  if (tile == 0 && threadIdx.x == 0) counts[blockIdx.x / tiles] = n_runs;
}

constexpr size_t kTablesBytes = 3 * kTable * sizeof(unsigned);

// The tables take more than the 48 KB a launch gets without asking.
template <bool kVec>
cudaError_t allow_tables() {
  return cudaFuncSetAttribute(coalesce_cluster_kernel<kVec>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kTablesBytes);
}

struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
};

void launch_config(Launch* l, int b, int n, cudaStream_t stream) {
  const int tiles = (n + kTile - 1) / kTile;
  const int threads = tiles > 1 ? kThreads
                                : ((n + kPer - 1) / kPer + 31) / 32 * 32;
  l->cfg = cudaLaunchConfig_t{};
  l->cfg.gridDim = dim3(static_cast<unsigned>(b) * tiles);
  l->cfg.blockDim = dim3(threads);
  l->cfg.dynamicSmemBytes = kTablesBytes;
  l->cfg.stream = stream;
  l->attr.id = cudaLaunchAttributeClusterDimension;
  l->attr.val.clusterDim.x = tiles;
  l->attr.val.clusterDim.y = 1;
  l->attr.val.clusterDim.z = 1;
  l->cfg.attrs = &l->attr;
  l->cfg.numAttrs = 1;
}

}  // namespace

// offsets/lengths: int32 [b, n], offset-sorted with PAD_OFFSET padding at
// the tail, n <= 32768. Writes the coalesced rows and the run counts [b].
extern "C" int repro_coalesce(const int* offsets, const int* lengths,
                              int* out_offsets, int* out_lengths, int* counts,
                              int b, int n, void* stream) {
  if (b == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  if (n > kTile * kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  Launch l;
  launch_config(&l, b, n, static_cast<cudaStream_t>(stream));
  const int tiles = (n + kTile - 1) / kTile;
  const bool vec = n % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(offsets) & 15u) == 0 &&
      (reinterpret_cast<uintptr_t>(lengths) & 15u) == 0;
  cudaError_t rc = vec ? allow_tables<true>() : allow_tables<false>();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = vec
      ? cudaLaunchKernelEx(&l.cfg, coalesce_cluster_kernel<true>, offsets,
                           lengths, out_offsets, out_lengths, counts, n, tiles)
      : cudaLaunchKernelEx(&l.cfg, coalesce_cluster_kernel<false>, offsets,
                           lengths, out_offsets, out_lengths, counts, n,
                           tiles);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of a [b, n] launch the card holds at once
// (cudaOccupancyMaxActiveClusters); 0 with an error code on failure.
extern "C" int repro_coalesce_max_active_clusters(int n, int* clusters) {
  Launch l;
  launch_config(&l, 1, n, nullptr);
  *clusters = 0;
  const cudaError_t rc = allow_tables<true>();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, coalesce_cluster_kernel<true>, &l.cfg));
}
