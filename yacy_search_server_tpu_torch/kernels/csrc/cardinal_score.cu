// Kernel 2 `cardinal_score`: one int32 cardinal score per posting row.
// Replaces ops/ranking.cardinal_from_stats (+ _norm_div_exact_fast) of
// the JAX package, the vectorised ReferenceOrder.cardinal: normalised
// columns << |coeff|, domlength, the f32 tf norm, the language match, the
// 11 flag terms and, when the authority coefficient is > 12, the
// domain-authority term. Invalid rows score -(2^31-1).
//
// Bound: bytes. One pass reads each row's features (34 B int16 or 68 B
// int32), its flags, valid byte and (with authority) host id and count,
// and writes 4 B. Arithmetic follows XLA's int32 semantics exactly:
// products and sums wrap (done in uint32), the int32 path floors its
// division, the compact path reproduces the f32 reciprocal estimate with
// its +-1 correction, and every float step is an explicitly rounded
// intrinsic (no FMA contraction). The per-row arithmetic is close to the
// memory time on its own (some 13 divisions a row on the int32 path), so
// the design has to overlap the two.
//
// What held the first version back: one thread per row made 17 scalar
// loads at a 34- or 68-byte stride (no 16-byte vector, neighbouring
// threads 34 or 68 bytes apart), and the valid -> host id -> count chain
// was a dependent round trip per row. This design: persistent warps, each
// walking chunks of CH = 64 rows. A warp copies a chunk's features, and
// its flags, valid bytes and host ids, into its own shared-memory stage
// by 16-byte cp.async.cg copies with neighbouring lanes on neighbouring
// addresses, two stages deep, so the next chunk is in flight while this
// one is scored. 64 rows are a multiple of 16 bytes for both row widths,
// so every chunk starts at the same offset mod 16 as the block; a view
// that does not start on 16 bytes (feats[1:]) has its ragged head and
// tail copied element by element, and nothing outside the rows is read.
// Lane l scores rows l and l + 32 of the chunk out of shared memory: an
// int32 row is 17 words, an odd stride, so its column reads meet no bank
// conflict; an int16 row is read as 2-byte values at a 8.5-word stride,
// which puts the 32 lanes on 32 distinct words (no conflict either).
// Scores are stored coalesced; the authority gather reads the host
// counts through the L2 (40 MB at 10M bins, never staged). The staging
// helpers (issue_chunk, copy_span, Stage) live in common.cuh, shared with
// cardinal_stats, and so does the row scorer (score_row), shared with the
// devstore kernels.
//
// Three rewrites of the first version's row body, each exact:
//   - the int32 path's floor(prod / safe) is a double estimate (prod
//     times the double reciprocal of safe rounded to nearest, rounded
//     down to an integer) corrected once by its remainder in 64-bit
//     integers. |prod| <= 2^31 and 1 <= safe < 2^31, so the estimate's
//     relative error is below 2^-52 + 2^-106 and its absolute error below
//     2^-21: it is the floor or one off it either way, and the remainder
//     test (r >= safe: +1, r < 0: -1) gives the floor (safe == 1 has the
//     reciprocal 1.0 and is exact at once). It replaces the two integer
//     divisions of `floordiv`, which cost 0.364 against 0.308 device ms
//     at the rank_placed shape on an H100 80GB HBM3 at 700 W (PERF.md);
//   - (f - cmin) * 256 is computed as f * 256 + (-cmin * 256) in uint32:
//     the same residue mod 2^32;
//   - a column whose span is 0 is not skipped: its shift becomes 32, and
//     the clamping funnel shift makes its term 0, as the skip did.
// chip_smoke.py and the card tests hold the kernel to its plain version
// on column bounds and features at int32's edges (kernels/bench.
// edge_block), and tests/test_torch_ranking.py holds the plain version to
// the JAX package there.
#include "common.cuh"

namespace yt {

constexpr int WARPS = 4;               // warps per block
constexpr int MIN_BLOCKS = 4;          // resident blocks an SM, at least

// The rows of block `block` of the `blocks` that share the n rows.
template <typename T, bool FAST>
__device__ __forceinline__ void score_rows_body(
    const T* __restrict__ feats, const int32_t* __restrict__ flags,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ hostids,
    int64_t n, const int32_t* __restrict__ st,
    const int32_t* __restrict__ counts, int64_t num_hosts,
    const int32_t* __restrict__ consts, int32_t* __restrict__ out,
    unsigned char* smem, ScoreConsts& k, int block, int blocks) {
  constexpr int SB = stage_bytes<T>();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t chunks = (n + CH - 1) / CH;
  const int64_t step = (int64_t)blocks * WARPS;
  unsigned char* mine = smem + warp * 2 * SB;
  // authority is decided from the constants in device memory, so the
  // first copy can go out before the block's constants are ready
  const bool use_auth = num_hosts > 1 && consts[C_AUTHORITY] > 12;
  const int32_t* hsrc = use_auth ? hostids : nullptr;

  int64_t c = (int64_t)block * WARPS + warp;
  if (c < chunks) issue_chunk(feats, flags, valid, hsrc, n, c, mine, lane);
  cp_async_commit();

  fill_consts(k, st, consts, t);
  __syncthreads();
  RegConsts rk;
  load_consts(k, rk);

  for (int i = 0; c < chunks; ++i, c += step) {
    const int cur = i & 1;
    if (c + step < chunks)
      issue_chunk(feats, flags, valid, hsrc, n, c + step,
                  mine + (cur ^ 1) * SB, lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const Stage<T> sg(mine + cur * SB, feats, flags, hostids, valid);
#pragma unroll
    for (int m = 0; m < CH / 32; ++m) {
      const int j = lane + 32 * m;
      const int64_t r = c * CH + j;
      if (r < n) {
        int32_t score = SMALL;
        if (sg.v[j]) {
          const T* f = sg.row(j);
          const int32_t fl = flags ? sg.flag(j) : (int32_t)f[F_FLAGS];
          int32_t cnt = 0;
          if (use_auth) {
            int64_t h = sg.host(j);
            h = h < 0 ? 0 : (h >= num_hosts ? num_hosts - 1 : h);
            cnt = __ldg(counts + h);
          }
          score = score_row<T, FAST>(f, fl, rk, use_auth, cnt);
        }
        out[r] = score;
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

template <typename T, bool FAST>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
score_chunks(const T* __restrict__ feats, const int32_t* __restrict__ flags,
             const uint8_t* __restrict__ valid,
             const int32_t* __restrict__ hostids, int64_t n,
             const int32_t* __restrict__ st,
             const int32_t* __restrict__ counts, int64_t num_hosts,
             const int32_t* __restrict__ consts,
             int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ScoreConsts k;
  score_rows_body<T, FAST>(feats, flags, valid, hostids, n, st, counts,
                           num_hosts, consts, out, smem, k, blockIdx.x,
                           gridDim.x);
}

// ---------------------------------------------------------------------------
// join_score_batch: kernel 2 over the regions of a join wave
// ---------------------------------------------------------------------------
// The scores of _join_topk (cardinal_from_stats on the merged rows, their
// OR'd flags, no authority: num_hosts = 1), vmapped over a wave by
// _rank_join_(bm_)batch_kernel (:736, :769): each slot's merged int32
// rows scored on the int32 path against its own statistics, by its own
// range of the grid's blocks, into its region of one buffer; invalid rows
// -(2^31-1). score_chunks' row pipeline. Bound: bytes, 68 B of merged
// features, 4 B of flags and a valid byte read and 4 B written a row,
// summed over the slots.
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
score_regions(const int32_t* __restrict__ feats,
              const int32_t* __restrict__ flags,
              const uint8_t* __restrict__ valid, const Regions g,
              const int32_t* __restrict__ stats, int64_t stats_stride,
              const int32_t* __restrict__ consts,
              int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ScoreConsts k;
  const int s = range_of_block(g.bstart, g.bs, blockIdx.x);
  const int64_t o = g.off[s];
  score_rows_body<int32_t, false>(
      feats + o * NF, flags + o, valid + o, nullptr, g.n[s],
      stats + (int64_t)s * stats_stride, nullptr, 1, consts, out + o, smem,
      k, blockIdx.x - g.bstart[s], g.bstart[s + 1] - g.bstart[s]);
}

// ---------------------------------------------------------------------------
// K7 `span_score`: pass 2 of the devstore's exact scan, minus its top-k
// ---------------------------------------------------------------------------
// Replaces the scoring pass of index/devstore._rank_spans_kernel (JAX
// package, devstore.py:425-459): the rows of up to 8 arena extents scored
// in place against given statistics (span_stats' or a span's frozen
// ones) with the compact path's division, into one contiguous buffer in
// extent order; kernel 3 then selects from it in index mode, which is the
// order of the JAX running merge (score descending, then the row's place
// in the sequence). A RAM delta block (the with_delta branch, :456-458)
// is one more source after the extents: its rows are scored against the
// same statistics and written after every extent row, so that a span row
// precedes a delta row of equal score, as the JAX merge of the delta's
// top-k after the spans' does. Liveness is decided here from the docids
// and the tombstone bitmap (row_live), so the host sends no counts and
// no mask. Rows [rows, out_len) of the buffer get -(2^31-1): a top-k of
// kk > rows reads them as the JAX merge reads its init entries. A row
// that fails the constraint filter or the facet bitmap (common.cuh
// Filter; the with_filter branch, _bitmap_member :325) scores -(2^31-1)
// as a dead one does; the statistics are then span_stats' under the same
// filter, or the filtered-stats cache's copy of them (the with_ext_stats
// branch).
//
// `score_batch` is the same pass with a query dimension (the scoring pass
// of _rank_scan_batch_kernel, :465): each slot scored against its own
// statistics into its own region of one packed buffer ([obase[s],
// obase[s + 1]), as long as the slot's rows need) by its own range of the
// grid's blocks (common.cuh ScanBatch).
//
// Bound: bytes, 34 B of features + 4 B flags + 4 B docid read and 4 B
// written a row (and the bitmap words, from the L2); a wave sums its
// slots' bytes. The row pipeline is score_chunks': persistent warps,
// 64-row chunks staged by cp.async two stages deep, the docids in the
// host-id region; a chunk never straddles two sources.
__device__ __forceinline__ void score_extents_body(
    const Extents& x, const Filter& q, const uint8_t* __restrict__ dead,
    int64_t doc_cap, const int32_t* __restrict__ st,
    const int32_t* __restrict__ consts, unsigned char* smem, ScoreConsts& k,
    int32_t* __restrict__ out, int64_t out_len, int block, int blocks) {
  constexpr int SB = stage_bytes<int16_t>();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t chunks = x.cbase[x.n];
  const int64_t step = (int64_t)blocks * WARPS;
  unsigned char* mine = smem + warp * 2 * SB;

  const bool off = filter_off(q);

  int64_t c = (int64_t)block * WARPS + warp;
  if (c < chunks) issue_extent_chunk(x, c, true, mine, lane);
  cp_async_commit();
  fill_consts(k, st, consts, t);
  __syncthreads();
  RegConsts rk;
  load_consts(k, rk);

  for (int i = 0; c < chunks; ++i, c += step) {
    const int cur = i & 1;
    if (c + step < chunks)
      issue_extent_chunk(x, c + step, true, mine + (cur ^ 1) * SB, lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int e = extent_of_chunk(x, c);
    const Stage<int16_t> sg(mine + cur * SB, x.feats[e], x.flags[e],
                            x.docids[e], nullptr);
    const int64_t r0 = (c - x.cbase[e]) * CH;
#pragma unroll
    for (int m = 0; m < CH / 32; ++m) {
      const int j = lane + 32 * m;
      if (r0 + j < x.count[e]) {
        int32_t score = SMALL;
        const int16_t* f = sg.row(j);
        const int32_t d = sg.host(j);
        if (row_live(d, dead, doc_cap) &&
            (off || row_passes(f, sg.flag(j), d, q)))
          score = score_row<int16_t, true>(f, sg.flag(j), rk, false, 0);
        out[x.obase[e] + r0 + j] = score;
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  for (int64_t r = x.obase[x.n] + (int64_t)block * blockDim.x + t;
       r < out_len; r += (int64_t)blocks * blockDim.x)
    out[r] = SMALL;
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
score_extents(const uint8_t* __restrict__ dead, int64_t doc_cap,
              const Extents x, const Filter q,
              const int32_t* __restrict__ st,
              const int32_t* __restrict__ consts,
              int32_t* __restrict__ out, int64_t out_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ScoreConsts k;
  score_extents_body(x, q, dead, doc_cap, st, consts, smem, k, out, out_len,
                     blockIdx.x, gridDim.x);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
score_batch(const int16_t* __restrict__ feats,
            const int32_t* __restrict__ flags,
            const int32_t* __restrict__ docids,
            const uint8_t* __restrict__ dead, int64_t doc_cap,
            const ScanBatch b, const int32_t* __restrict__ stats,
            int64_t stats_stride, const int32_t* __restrict__ consts,
            int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ScoreConsts k;
  __shared__ Extents x;
  __shared__ Filter q;
  const int s = range_of_block(b.bstart, b.bs, blockIdx.x);
  if (threadIdx.x == 0) slot_extents(b, s, feats, flags, docids, x, q);
  __syncthreads();
  score_extents_body(x, q, dead, doc_cap, stats + (int64_t)s * stats_stride,
                     consts, smem, k, out + b.obase[s],
                     b.obase[s + 1] - b.obase[s], blockIdx.x - b.bstart[s],
                     b.bstart[s + 1] - b.bstart[s]);
}

template <typename T, bool FAST>
static cudaError_t launch(const void* feats, const void* flags,
                          const void* valid, const void* hostids, int64_t n,
                          const void* stats, const void* counts,
                          int64_t num_hosts, const void* consts, void* out,
                          cudaStream_t s) {
  const int smem = WARPS * 2 * stage_bytes<T>();
  static int cached[64];
  int limit = 0;
  cudaError_t e = resident_blocks(score_chunks<T, FAST>, WARPS * 32, smem,
                                  cached, &limit);
  if (e != cudaSuccess) return e;
  const int64_t blocks = ((n + CH - 1) / CH + WARPS - 1) / WARPS;
  const int grid = (int)(blocks < limit ? blocks : limit);
  score_chunks<T, FAST><<<grid, WARPS * 32, smem, s>>>(
      (const T*)feats, (const int32_t*)flags, (const uint8_t*)valid,
      (const int32_t*)hostids, n, (const int32_t*)stats,
      (const int32_t*)counts, num_hosts, (const int32_t*)consts,
      (int32_t*)out);
  return cudaGetLastError();
}

}  // namespace yt

using namespace yt;

// feats: [n, 17] int16 (feat_bytes 2) or int32 (4), at any address
// aligned to its element; flags: [n] int32 or null (read the F_FLAGS
// column); valid [n] bool; hostids [n] int32; stats int32[38]; counts
// int32[num_hosts] (num_hosts <= 1: no authority); consts int32[44];
// out [n] int32.
extern "C" int yt_cardinal_score(const void* feats, int feat_bytes,
                                 const void* flags, const void* valid,
                                 const void* hostids, int64_t n,
                                 const void* stats, const void* counts,
                                 int64_t num_hosts, const void* consts,
                                 int fast_div, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    auto* f = feat_bytes == 2
                  ? (fast_div ? launch<int16_t, true> : launch<int16_t, false>)
                  : (fast_div ? launch<int32_t, true> : launch<int32_t, false>);
    cudaError_t e = f(feats, flags, valid, hostids, n, stats, counts,
                      num_hosts, consts, out, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// K7: ext holds n_ext (start, count) pairs in host memory (n_ext <= 8);
// feats [cap, 17] int16, flags/docids [cap] int32, dead [doc_cap] bool;
// filt the filter's 4 int32 in host memory; allow [nwords] int32 (the
// facet bitmap) or null; dfeats [dn, 17] int16, dflags/ddocids [dn] int32
// the RAM delta block (dn 0: none); stats int32[38]; consts int32[44];
// out [out_len] int32, out_len >= the extents' and the delta's rows.
extern "C" int yt_span_score(const void* feats, const void* flags,
                             const void* docids, const void* dead,
                             int64_t doc_cap, const int64_t* ext, int n_ext,
                             const int32_t* filt, const void* allow,
                             int64_t nwords, const void* dfeats,
                             const void* dflags, const void* ddocids,
                             int64_t dn, const void* stats,
                             const void* consts, void* out, int64_t out_len,
                             void* stream) {
  if (n_ext < 0 || n_ext > MAX_EXT || dn < 0)
    return (int)cudaErrorInvalidValue;
  const Extents x = make_extents(feats, flags, docids, ext, n_ext, dfeats,
                                 dflags, ddocids, dn);
  const Filter q = make_filter(filt, allow, nwords);
  if (out_len < x.obase[x.n]) return (int)cudaErrorInvalidValue;
  const int smem = WARPS * 2 * stage_bytes<int16_t>();
  static int cached[64];
  int limit = 0;
  cudaError_t e =
      resident_blocks(score_extents, WARPS * 32, smem, cached, &limit);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (x.cbase[x.n] + WARPS - 1) / WARPS;
  const int grid = (int)(blocks < 1 ? 1 : (blocks < limit ? blocks : limit));
  score_extents<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)dead, doc_cap, x, q, (const int32_t*)stats,
      (const int32_t*)consts, (int32_t*)out, out_len);
  return (int)cudaGetLastError();
}

// The batched K7 over a wave of bs <= 16 slots (common.cuh scan_batch_of,
// in host memory); the arena as for K7; stats the wave's statistics, slot
// i at i * stats_stride int32; consts int32[44] (one profile a wave); out
// int32 [out_off[bs]], slot s's region [out_off[s], out_off[s + 1])
// (out_off: bs + 1 int64 in host memory, out_off[0] = 0, each region at
// least the slot's rows).
extern "C" int yt_span_score_batch(const void* feats, const void* flags,
                                   const void* docids, const void* dead,
                                   int64_t doc_cap, const int32_t* slots,
                                   int bs, const void* stats,
                                   int64_t stats_stride, const void* consts,
                                   void* out, const int64_t* out_off,
                                   void* stream) {
  if (bs < 1 || bs > BATCH_SLOTS) return (int)cudaErrorInvalidValue;
  ScanBatch b{};
  if (!scan_batch_of(slots, bs, &b, out_off))
    return (int)cudaErrorInvalidValue;
  const int smem = WARPS * 2 * stage_bytes<int16_t>();
  static int cached[64];
  int limit = 0;
  cudaError_t e =
      resident_blocks(score_batch, WARPS * 32, smem, cached, &limit);
  if (e != cudaSuccess) return (int)e;
  // the slots share the resident blocks in proportion to their rows
  const int grid = wave_blocks(&b, WARPS, limit);
  score_batch<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int16_t*)feats, (const int32_t*)flags, (const int32_t*)docids,
      (const uint8_t*)dead, doc_cap, b, (const int32_t*)stats, stats_stride,
      (const int32_t*)consts, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The batched kernel 2 over the regions of a join wave of bs <= 16 slots:
// merged [off[bs], 17] int32, flags [off[bs]] int32, valid [off[bs]]
// bool, slot s's n[s] rows from row off[s] (off: bs + 1 int64, n: bs
// int64, host memory); stats the slots' statistics, slot s at s *
// stats_stride int32; consts int32[44]; out [off[bs]] int32, slot s's
// scores at its rows.
extern "C" int yt_join_score_batch(const void* merged, const void* flags,
                                   const void* valid, const int64_t* off,
                                   const int64_t* n, int bs,
                                   const void* stats, int64_t stats_stride,
                                   const void* consts, void* out,
                                   void* stream) {
  Regions g{};
  if (!regions_of(off, n, bs, &g)) return (int)cudaErrorInvalidValue;
  const int smem = WARPS * 2 * stage_bytes<int32_t>();
  static int cached[64];
  int limit = 0;
  cudaError_t e =
      resident_blocks(score_regions, WARPS * 32, smem, cached, &limit);
  if (e != cudaSuccess) return (int)e;
  const int grid = split_blocks(g.n, bs, WARPS * CH, limit, g.bstart);
  score_regions<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)merged, (const int32_t*)flags, (const uint8_t*)valid,
      g, (const int32_t*)stats, stats_stride, (const int32_t*)consts,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
