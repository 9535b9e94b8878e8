// Kernel 1 `cardinal_stats`: the normalisation statistics of a postings
// block. Replaces ops/ranking.local_stats (+ _masked_minmax,
// _term_frequency and the segment_sum of the host counts) of the JAX
// package: masked per-column min/max over valid rows (sentinels
// +-(2^31-1)), the f32 term-frequency min/max, and, when asked, the
// per-host valid counts and their maximum.
//
// Bound: bytes. Every input byte is read once (34 B of int16 or 68 B of
// int32 features, 1 B valid and, when counting, 4 B host id a row) and
// the counts (4 B a host bin) are written once.
//
// What held the first version back: six operations a call (init, main,
// memset, host count, host max, finalize), `valid` read twice, the count
// array read back in full to find its maximum, and one thread per row
// making 17 scalar loads at a 34- or 68-byte stride. This design is one
// memset and one persistent kernel:
//   - the warps stage 64-row chunks of features, valid bytes and host ids
//     into shared memory by 16-byte cp.async, two stages deep, with the
//     helpers cardinal_score uses (common.cuh); a view that does not
//     start on 16 bytes (feats[1:]) and a ragged last chunk are copied as
//     there. Lane l folds rows l and l + 32 of a chunk: an int32 row is 17
//     words, an odd stride, so the column reads meet no bank conflict;
//   - the host counts are taken in the same pass. Where hosts are
//     counted the kernel runs in clusters of 8 blocks, one block an SM,
//     and the shared memory a block does not stage rows in holds host
//     bins (38,104 a block beside int32 rows, 46,808 beside int16): ids
//     below 8 times that (`priv`) are added in the cluster's bins, bin h
//     in block h % 8, over distributed shared memory (the ids of
//     hostid_array are dense from 0, so all of a term's hosts fit unless
//     it has more than ~300,000); after a cluster barrier each block adds
//     its non-zero bins to the counts in device memory, so 10M rows over
//     50,000 hosts make ~0.8M device-memory adds, not 10M. Ids at or
//     above `priv` are added to the counts directly. Either way the lanes
//     of a warp that hold the same host (__match_any_sync) add once for
//     all of them, so a host that holds most of a term's rows does not
//     queue one add a row on one word. atomicAdd returns
//     the old count, and old + (what it added) folded into a running
//     maximum is exactly the final maximum (the add that brings a bin to
//     its final count returns that count minus what it adds; no add
//     returns more), so no pass reads the counts back. Ids outside
//     [0, num_hosts) are dropped, as segment_sum drops them;
//   - a block folds its warps' minima, maxima, NaN flag and host maximum
//     in shared memory and adds them to a 38-word accumulator in device
//     memory by unsigned atomicMax. Each statistic is stored mapped so
//     that 0 is its identity (a minimum v as 0x7fffffff - v, a maximum as
//     v - SMALL, the f32 bounds as order keys offset from +-inf), so the
//     memset that zeroes the counts zeroes the accumulator and the ticket
//     too: no init kernel. A maximum does not depend on the order of its
//     operands, so the result is deterministic;
//   - the last block to finish (an atomic ticket after __threadfence, as
//     in tie_topk) reads the accumulator back and writes the statistics in
//     final form, with the NaN rule of XLA's NaN-propagating min/max (a
//     NaN term frequency makes both tf bounds NaN): no finalize kernel.
//
// Why the cluster bins: 10M adds straight to the counts in device memory
// (the first one-pass design) cost ~0.15 ms that did not overlap the row
// stream, and a returning add cost no more than a fire-and-forget one.
// A block alone sees ~1.5 rows a host, too few to gain from bins of its
// own; a cluster's bins take every add of its 8 SMs. Why the warp
// aggregation: without it, 10M rows on one host take ~0.6 ms, the adds
// queueing on one shared word a cluster. Timed on an H100 with host ids
// drawn evenly, Zipf-skewed and all on one host (PERF.md), the kernel
// beats the same aggregation in device memory alone on every mix.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace yt {

constexpr int S_WARPS = 8;      // warps per block
constexpr int S_MIN_BLOCKS = 2; // resident blocks an SM, at least
constexpr int H_CLUSTER = 8;    // blocks that share their host bins

constexpr int32_t TF_POS_INF = 0x7f800000;        // order key of +inf
constexpr int32_t TF_NEG_INF = (int32_t)0x807fffff;  // order key of -inf

// statistic -> accumulator word, monotone (a better value is a larger
// word) and 0 for the statistic's identity
__device__ __forceinline__ uint32_t to_acc(int s, int32_t v) {
  if (s < S_COL_MAX) return 0x7fffffffu - (uint32_t)v;          // min
  if (s < S_TF_MIN) return (uint32_t)v - (uint32_t)SMALL;       // max
  if (s == S_TF_MIN) return (uint32_t)TF_POS_INF - (uint32_t)v;
  if (s == S_TF_MAX) return (uint32_t)v - (uint32_t)TF_NEG_INF;
  return (uint32_t)v;                                           // host, NaN
}

__device__ __forceinline__ int32_t from_acc(int s, uint32_t u) {
  if (s < S_COL_MAX) return (int32_t)(0x7fffffffu - u);
  if (s < S_TF_MIN) return (int32_t)(u + (uint32_t)SMALL);
  if (s == S_TF_MIN) return (int32_t)((uint32_t)TF_POS_INF - u);
  if (s == S_TF_MAX) return (int32_t)(u + (uint32_t)TF_NEG_INF);
  return (int32_t)u;
}

// One thread's running statistics: column minima and maxima, the tf
// bounds as order keys, the NaN flag and the host maximum.
struct Fold {
  int32_t lmin[NF], lmax[NF];
  int32_t tmin = TF_POS_INF, tmax = TF_NEG_INF, nan = 0, hmax = 0;

  __device__ __forceinline__ Fold() {
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      lmin[k] = BIG;
      lmax[k] = SMALL;
    }
  }

  template <typename T>
  __device__ __forceinline__ void row(const T* f) {
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      const int32_t v = (int32_t)f[k];
      lmin[k] = min(lmin[k], v);
      lmax[k] = max(lmax[k], v);
    }
    const float tf = term_frequency(f);
    if (tf != tf) {
      nan = 1;
    } else {
      const int32_t key = float_order(__float_as_int(tf));
      tmin = min(tmin, key);
      tmax = max(tmax, key);
    }
  }
};

// The block folds its threads' statistics (warp shuffles, then s_acc,
// zeroed by the caller before a __syncthreads) into the accumulator in
// device memory; the last of the `blocks` blocks that share acc and
// ticket to finish writes st in final form.
__device__ __forceinline__ void finish_stats(Fold& a, uint32_t* s_acc,
                                             bool* s_last,
                                             uint32_t* __restrict__ acc,
                                             uint32_t* __restrict__ ticket,
                                             int32_t* __restrict__ st,
                                             unsigned blocks) {
  const int t = threadIdx.x, lane = t & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      a.lmin[k] = min(a.lmin[k], __shfl_xor_sync(0xffffffffu, a.lmin[k], o));
      a.lmax[k] = max(a.lmax[k], __shfl_xor_sync(0xffffffffu, a.lmax[k], o));
    }
    a.tmin = min(a.tmin, __shfl_xor_sync(0xffffffffu, a.tmin, o));
    a.tmax = max(a.tmax, __shfl_xor_sync(0xffffffffu, a.tmax, o));
    a.nan |= __shfl_xor_sync(0xffffffffu, a.nan, o);
    a.hmax = max(a.hmax, __shfl_xor_sync(0xffffffffu, a.hmax, o));
  }
  __syncthreads();  // s_acc zeroed
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      atomicMax(&s_acc[S_COL_MIN + k], to_acc(S_COL_MIN + k, a.lmin[k]));
      atomicMax(&s_acc[S_COL_MAX + k], to_acc(S_COL_MAX + k, a.lmax[k]));
    }
    atomicMax(&s_acc[S_TF_MIN], to_acc(S_TF_MIN, a.tmin));
    atomicMax(&s_acc[S_TF_MAX], to_acc(S_TF_MAX, a.tmax));
    atomicMax(&s_acc[S_HOST_MAX], to_acc(S_HOST_MAX, a.hmax));
    atomicMax(&s_acc[S_NAN], to_acc(S_NAN, a.nan));
  }
  __syncthreads();
  if (t < STATS_LEN && s_acc[t]) atomicMax(acc + t, s_acc[t]);
  __threadfence();
  __syncthreads();
  if (t == 0) *s_last = atomicAdd(ticket, 1u) == blocks - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  if (t < STATS_LEN) s_acc[t] = __ldcg(acc + t);
  __syncthreads();
  if (t < STATS_LEN) {
    int32_t v = from_acc(t, s_acc[t]);
    if (t == S_TF_MIN || t == S_TF_MAX)
      v = s_acc[S_NAN] ? 0x7fc00000 : float_order(v);
    st[t] = v;
  }
}

// HOSTS: launched in clusters of H_CLUSTER blocks, one block an SM; host
// ids below `priv` are counted in the cluster's shared bins (bin h in
// block h % H_CLUSTER, word h / H_CLUSTER, after the stages), the others
// by atomicAdd on `counts`. The pass of block `block` of the `blocks`
// that share the n rows, acc and ticket.
template <typename T, bool HOSTS>
__device__ __forceinline__ void stats_rows_body(
    const T* __restrict__ feats, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ hostids, int64_t n, int64_t num_hosts,
    int64_t priv, int32_t* __restrict__ counts, uint32_t* __restrict__ acc,
    uint32_t* __restrict__ ticket, int32_t* __restrict__ st,
    unsigned char* smem, uint32_t* s_acc, bool* s_last, int block,
    int blocks) {
  constexpr int SB = stage_bytes<T>();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t chunks = (n + CH - 1) / CH;
  const int64_t step = (int64_t)blocks * S_WARPS;
  unsigned char* mine = smem + warp * 2 * SB;
  uint32_t* bins = (uint32_t*)(smem + S_WARPS * 2 * SB);
  const unsigned rank = HOSTS ? cg::this_cluster().block_rank() : 0u;
  // this block's bins: ids rank, rank + H_CLUSTER, ... below priv
  const int64_t nbins =
      HOSTS && priv > rank ? (priv - rank + H_CLUSTER - 1) / H_CLUSTER : 0;

  int64_t c = (int64_t)block * S_WARPS + warp;
  if (c < chunks)
    issue_chunk<T>(feats, nullptr, valid, HOSTS ? hostids : nullptr, n, c,
                   mine, lane);
  cp_async_commit();
  if (t < STATS_LEN) s_acc[t] = 0u;
  if (HOSTS) {
    for (int64_t b = t; b < nbins; b += S_WARPS * 32) bins[b] = 0u;
    cg::this_cluster().sync();  // every block's bins zeroed
  }

  Fold a;

  for (int i = 0; c < chunks; ++i, c += step) {
    const int cur = i & 1;
    if (c + step < chunks)
      issue_chunk<T>(feats, nullptr, valid, HOSTS ? hostids : nullptr, n,
                     c + step, mine + (cur ^ 1) * SB, lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const Stage<T> sg(mine + cur * SB, feats, nullptr, hostids, valid);
#pragma unroll
    for (int m = 0; m < CH / 32; ++m) {
      const int j = lane + 32 * m;
      const bool live = c * CH + j < n && sg.v[j];
      if (live) a.row(sg.row(j));
      if (HOSTS) {
        // the lanes that hold one host add once for all of them (-1: the
        // row is not counted)
        int32_t h = live ? sg.host(j) : -1;
        if (h >= num_hosts) h = -1;
        const unsigned same = __match_any_sync(0xffffffffu, h);
        if (h >= 0 && lane == __ffs(same) - 1) {
          const int k = __popc(same);
          if (h < priv)
            atomicAdd(cg::this_cluster().map_shared_rank(
                          bins + h / H_CLUSTER, h % H_CLUSTER),
                      (uint32_t)k);
          else
            a.hmax = max(a.hmax, atomicAdd(counts + h, k) + k);
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  if (HOSTS) {
    cg::this_cluster().sync();  // every add to this block's bins landed
    for (int64_t b = t; b < nbins; b += S_WARPS * 32) {
      const int32_t k = (int32_t)bins[b];
      if (k)
        a.hmax = max(a.hmax, atomicAdd(counts + rank + b * H_CLUSTER, k) + k);
    }
  }

  finish_stats(a, s_acc, s_last, acc, ticket, st, (unsigned)blocks);
}

template <typename T, bool HOSTS>
__global__ void __launch_bounds__(S_WARPS * 32, HOSTS ? 1 : S_MIN_BLOCKS)
stats_pass(const T* __restrict__ feats, const uint8_t* __restrict__ valid,
           const int32_t* __restrict__ hostids, int64_t n, int64_t num_hosts,
           int64_t priv, int32_t* __restrict__ counts,
           uint32_t* __restrict__ acc, uint32_t* __restrict__ ticket,
           int32_t* __restrict__ st) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_acc[STATS_LEN];
  __shared__ bool s_last;
  stats_rows_body<T, HOSTS>(feats, valid, hostids, n, num_hosts, priv,
                            counts, acc, ticket, st, smem, s_acc, &s_last,
                            blockIdx.x, gridDim.x);
}

// ---------------------------------------------------------------------------
// K6 `span_stats`: pass 1 of the devstore's exact scan
// ---------------------------------------------------------------------------
// Replaces the statistics pass of index/devstore._rank_spans_kernel (JAX
// package, devstore.py:378-423): the column min/max and tf min/max of the
// live rows of up to 8 arena extents, read in place, and of a RAM delta
// block after them (the with_delta branch, :412-420: the delta is one
// more source of the Extents, read where it lies); liveness (row_live)
// from the docids and the tombstone bitmap, no host counts. With a
// constraint filter (common.cuh Filter, the filter branch of
// _tile_valid's caller) only the rows that pass it count, and with a facet
// bitmap (the with_filter branch, _bitmap_member :325) only the rows whose
// docid's bit is set; the flags are staged only when the filter tests a
// flag bit. The row pipeline, the fold and the last block's finish are
// stats_pass'.
//
// `stats_batch` is the same pass with a query dimension (the statistics
// pass of _rank_scan_batch_kernel, :465, vmapped over a wave of filtered
// scans): each slot its own extents, filter, accumulator and ticket, and
// its own range of the grid's blocks (common.cuh ScanBatch).
//
// Bound: bytes, 34 B of features and 4 B of docid read a row (4 B more of
// flags under a flag filter), and the tombstone bytes the docids hit and
// the bitmap words, from the L2; a wave sums its slots' bytes.
__device__ __forceinline__ void stats_extents_body(
    const Extents& x, const Filter& q, const uint8_t* __restrict__ dead,
    int64_t doc_cap, unsigned char* smem, uint32_t* s_acc, bool* s_last,
    uint32_t* __restrict__ acc, uint32_t* __restrict__ ticket,
    int32_t* __restrict__ st, int block, int blocks) {
  constexpr int SB = stage_bytes<int16_t>();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t chunks = x.cbase[x.n];
  const int64_t step = (int64_t)blocks * S_WARPS;
  unsigned char* mine = smem + warp * 2 * SB;

  const bool off = filter_off(q);
  const bool with_flags = q.flag != NO_FLAG;

  int64_t c = (int64_t)block * S_WARPS + warp;
  if (c < chunks) issue_extent_chunk(x, c, with_flags, mine, lane);
  cp_async_commit();
  if (t < STATS_LEN) s_acc[t] = 0u;
  Fold a;

  for (int i = 0; c < chunks; ++i, c += step) {
    const int cur = i & 1;
    if (c + step < chunks)
      issue_extent_chunk(x, c + step, with_flags, mine + (cur ^ 1) * SB,
                         lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int e = extent_of_chunk(x, c);
    const Stage<int16_t> sg(mine + cur * SB, x.feats[e],
                            with_flags ? x.flags[e] : nullptr, x.docids[e],
                            nullptr);
    const int64_t r0 = (c - x.cbase[e]) * CH;
#pragma unroll
    for (int m = 0; m < CH / 32; ++m) {
      const int j = lane + 32 * m;
      const int32_t d = sg.host(j);
      if (r0 + j < x.count[e] && row_live(d, dead, doc_cap)) {
        const int16_t* f = sg.row(j);
        if (off || row_passes(f, with_flags ? sg.flag(j) : 0, d, q))
          a.row(f);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  finish_stats(a, s_acc, s_last, acc, ticket, st, (unsigned)blocks);
}

__global__ void __launch_bounds__(S_WARPS * 32, S_MIN_BLOCKS)
stats_extents(const uint8_t* __restrict__ dead, int64_t doc_cap,
              const Extents x, const Filter q, uint32_t* __restrict__ acc,
              uint32_t* __restrict__ ticket, int32_t* __restrict__ st) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_acc[STATS_LEN];
  __shared__ bool s_last;
  stats_extents_body(x, q, dead, doc_cap, smem, s_acc, &s_last, acc, ticket,
                     st, blockIdx.x, gridDim.x);
}

// out: SLOT_WORDS int32 a slot (the statistics, the accumulator, the
// ticket), slot i at i * SLOT_WORDS
constexpr int SLOT_WORDS = 2 * STATS_LEN + 1;

__global__ void __launch_bounds__(S_WARPS * 32, S_MIN_BLOCKS)
stats_batch(const int16_t* __restrict__ feats,
            const int32_t* __restrict__ flags,
            const int32_t* __restrict__ docids,
            const uint8_t* __restrict__ dead, int64_t doc_cap,
            const ScanBatch b, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_acc[STATS_LEN];
  __shared__ bool s_last;
  __shared__ Extents x;
  __shared__ Filter q;
  const int s = range_of_block(b.bstart, b.bs, blockIdx.x);
  if (threadIdx.x == 0) slot_extents(b, s, feats, flags, docids, x, q);
  __syncthreads();
  int32_t* st = out + (int64_t)s * SLOT_WORDS;
  uint32_t* acc = (uint32_t*)(st + STATS_LEN);
  stats_extents_body(x, q, dead, doc_cap, smem, s_acc, &s_last, acc,
                     acc + STATS_LEN, st, blockIdx.x - b.bstart[s],
                     b.bstart[s + 1] - b.bstart[s]);
}

// ---------------------------------------------------------------------------
// join_stats_batch: kernel 1 over the regions of a join wave
// ---------------------------------------------------------------------------
// The statistics of _join_topk (local_stats with num_hosts = 1, no host
// counts), vmapped over a wave of conjunctions by
// _rank_join_(bm_)batch_kernel (:736, :769): each slot's valid merged
// int32 rows, in its region of join_member_batch's buffers, folded by its
// own range of the grid's blocks into its own accumulator and ticket
// (out: SLOT_WORDS a slot), stats_pass' row pipeline without host
// counts. Bound: bytes, 68 B of merged features and a valid byte read a
// row, summed over the slots.
__global__ void __launch_bounds__(S_WARPS * 32, S_MIN_BLOCKS)
stats_regions(const int32_t* __restrict__ feats,
              const uint8_t* __restrict__ valid, const Regions g,
              int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_acc[STATS_LEN];
  __shared__ bool s_last;
  const int s = range_of_block(g.bstart, g.bs, blockIdx.x);
  int32_t* st = out + (int64_t)s * SLOT_WORDS;
  uint32_t* acc = (uint32_t*)(st + STATS_LEN);
  const int64_t o = g.off[s];
  stats_rows_body<int32_t, false>(
      feats + o * NF, valid + o, nullptr, g.n[s], 0, 0, nullptr, acc,
      acc + STATS_LEN, st, smem, s_acc, &s_last, blockIdx.x - g.bstart[s],
      g.bstart[s + 1] - g.bstart[s]);
}

template <typename T>
static cudaError_t launch(const void* feats, const void* valid,
                          const void* hostids, int64_t n, int64_t num_hosts,
                          int32_t* counts, uint32_t* acc, uint32_t* ticket,
                          int32_t* st, cudaStream_t s) {
  const int64_t chunks = (n + CH - 1) / CH;
  const int stages = S_WARPS * 2 * stage_bytes<T>();
  if (num_hosts <= 0) {
    static int cached[64];
    int limit = 0;
    cudaError_t e = resident_blocks(stats_pass<T, false>, S_WARPS * 32,
                                    stages, cached, &limit);
    if (e != cudaSuccess) return e;
    const int64_t blocks = (chunks + S_WARPS - 1) / S_WARPS;
    const int grid =
        (int)(blocks < 1 ? 1 : (blocks < limit ? blocks : limit));
    stats_pass<T, false><<<grid, S_WARPS * 32, stages, s>>>(
        (const T*)feats, (const uint8_t*)valid, (const int32_t*)hostids, n,
        0, 0, counts, acc, ticket, st);
    return cudaGetLastError();
  }
  // host counts: one block an SM, the rest of its shared memory bins;
  // per device, the bins a block holds and the clusters resident at once
  auto kern = stats_pass<T, true>;
  static int bins_of[64], clusters_of[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = H_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(S_WARPS * 32);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters_of[dev] <= 0) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return e;
    const int bins = (optin - (int)fa.sharedSizeBytes - stages) / 4;
    if (bins < 1) return cudaErrorInvalidConfiguration;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             stages + 4 * bins);
    if (e != cudaSuccess) return e;
    cfg.gridDim = dim3(H_CLUSTER);
    cfg.dynamicSmemBytes = stages + 4 * bins;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, (void*)kern, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    bins_of[dev] = bins;
    clusters_of[dev] = clusters;
  }
  const int64_t want = (chunks + S_WARPS * H_CLUSTER - 1) /
                       (S_WARPS * H_CLUSTER);
  const int64_t cl = want < 1 ? 1
                     : (want < clusters_of[dev] ? want : clusters_of[dev]);
  const int64_t cap = (int64_t)H_CLUSTER * bins_of[dev];
  cfg.gridDim = dim3((unsigned)(cl * H_CLUSTER));
  cfg.dynamicSmemBytes = stages + 4 * bins_of[dev];
  return cudaLaunchKernelEx(&cfg, kern, (const T*)feats,
                            (const uint8_t*)valid, (const int32_t*)hostids, n,
                            num_hosts, num_hosts < cap ? num_hosts : cap,
                            counts, acc, ticket, st);
}

}  // namespace yt

using namespace yt;

// feats: [n, 17] int16 (feat_bytes 2) or int32 (4), at any address aligned
// to its element; valid: [n] bool; hostids: [n] int32 (read only when
// num_hosts > 0). out: int32[38 + cnt + 39] with cnt = max(num_hosts, 1):
// the statistics (written), then the counts, the accumulator and the
// ticket, which this call zeroes with its one memset and then fills.
extern "C" int yt_cardinal_stats(const void* feats, int feat_bytes,
                                 const void* valid, const void* hostids,
                                 int64_t n, int64_t num_hosts, void* out,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* st = (int32_t*)out;
  int32_t* counts = st + STATS_LEN;
  const int64_t cnt = num_hosts > 0 ? num_hosts : 1;
  uint32_t* acc = (uint32_t*)(counts + cnt);
  uint32_t* ticket = acc + STATS_LEN;
  cudaError_t e =
      cudaMemsetAsync(counts, 0, (size_t)(cnt + STATS_LEN + 1) * 4, s);
  if (e != cudaSuccess) return (int)e;
  e = feat_bytes == 2
          ? launch<int16_t>(feats, valid, hostids, n, num_hosts, counts, acc,
                            ticket, st, s)
          : launch<int32_t>(feats, valid, hostids, n, num_hosts, counts, acc,
                            ticket, st, s);
  return (int)e;
}

// K6: ext holds n_ext (start, count) pairs in host memory (n_ext <= 8);
// feats [cap, 17] int16, flags/docids [cap] int32 (flags read only under
// a flag filter), dead [doc_cap] bool; filt the filter's 4 int32
// (language, flag bit, from and to days) in host memory; allow [nwords]
// int32 (the facet bitmap) or null; dfeats [dn, 17] int16, dflags/ddocids
// [dn] int32 the RAM delta block (dn 0: none). out: int32[38 + 39]: the
// statistics (written, host maximum 0), then the accumulator and the
// ticket, which this call zeroes with its one memset.
extern "C" int yt_span_stats(const void* feats, const void* flags,
                             const void* docids, const void* dead,
                             int64_t doc_cap, const int64_t* ext, int n_ext,
                             const int32_t* filt, const void* allow,
                             int64_t nwords, const void* dfeats,
                             const void* dflags, const void* ddocids,
                             int64_t dn, void* out, void* stream) {
  if (n_ext < 0 || n_ext > MAX_EXT || dn < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Extents x = make_extents(feats, flags, docids, ext, n_ext, dfeats,
                                 dflags, ddocids, dn);
  const Filter q = make_filter(filt, allow, nwords);
  int32_t* st = (int32_t*)out;
  uint32_t* acc = (uint32_t*)(st + STATS_LEN);
  uint32_t* ticket = acc + STATS_LEN;
  cudaError_t e = cudaMemsetAsync(acc, 0, (STATS_LEN + 1) * 4, s);
  if (e != cudaSuccess) return (int)e;
  const int stages = S_WARPS * 2 * stage_bytes<int16_t>();
  static int cached[64];
  int limit = 0;
  e = resident_blocks(stats_extents, S_WARPS * 32, stages, cached, &limit);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (x.cbase[x.n] + S_WARPS - 1) / S_WARPS;
  const int grid = (int)(blocks < 1 ? 1 : (blocks < limit ? blocks : limit));
  stats_extents<<<grid, S_WARPS * 32, stages, s>>>((const uint8_t*)dead,
                                                   doc_cap, x, q, acc,
                                                   ticket, st);
  return (int)cudaGetLastError();
}

// The batched K6 over a wave of bs <= 16 slots: slots the wave in host
// memory (common.cuh scan_batch_of, SLOT_DESC_WORDS int32 a slot); the
// arena as for K6 (flags always given). out: bs * (38 + 39) int32: per
// slot the statistics (written), then its accumulator and ticket, all
// zeroed by this call's one memset.
extern "C" int yt_span_stats_batch(const void* feats, const void* flags,
                                   const void* docids, const void* dead,
                                   int64_t doc_cap, const int32_t* slots,
                                   int bs, void* out, void* stream) {
  if (bs < 1 || bs > BATCH_SLOTS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  ScanBatch b{};
  if (!scan_batch_of(slots, bs, &b)) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaMemsetAsync(out, 0, (size_t)bs * SLOT_WORDS * 4, s);
  if (e != cudaSuccess) return (int)e;
  const int stages = S_WARPS * 2 * stage_bytes<int16_t>();
  static int cached[64];
  int limit = 0;
  e = resident_blocks(stats_batch, S_WARPS * 32, stages, cached, &limit);
  if (e != cudaSuccess) return (int)e;
  // the slots share the resident blocks in proportion to their rows
  const int grid = wave_blocks(&b, S_WARPS, limit);
  stats_batch<<<grid, S_WARPS * 32, stages, s>>>(
      (const int16_t*)feats, (const int32_t*)flags, (const int32_t*)docids,
      (const uint8_t*)dead, doc_cap, b, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The batched kernel 1 over the regions of a join wave of bs <= 16 slots:
// merged [off[bs], 17] int32 and valid [off[bs]] bool, slot s's n[s]
// rows from row off[s] (off: bs + 1 int64, n: bs int64, host memory).
// out: bs * (38 + 39) int32: per slot the statistics (written, host
// maximum 0), then its accumulator and ticket, zeroed by this call.
extern "C" int yt_join_stats_batch(const void* merged, const void* valid,
                                   const int64_t* off, const int64_t* n,
                                   int bs, void* out, void* stream) {
  Regions g{};
  if (!regions_of(off, n, bs, &g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)bs * SLOT_WORDS * 4, s);
  if (e != cudaSuccess) return (int)e;
  const int stages = S_WARPS * 2 * stage_bytes<int32_t>();
  static int cached[64];
  int limit = 0;
  e = resident_blocks(stats_regions, S_WARPS * 32, stages, cached, &limit);
  if (e != cudaSuccess) return (int)e;
  const int grid = split_blocks(g.n, bs, S_WARPS * CH, limit, g.bstart);
  stats_regions<<<grid, S_WARPS * 32, stages, s>>>(
      (const int32_t*)merged, (const uint8_t*)valid, g, (int32_t*)out);
  return (int)cudaGetLastError();
}
