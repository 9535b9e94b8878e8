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
#include <type_traits>

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
// top-k after the spans' does. With a docid column (`out_docids`) the
// pass also writes each row's docid beside its score, in the same order:
// the mesh store's per-cell scan (_mesh_rank_shard, meshstore.py:1888)
// selects in tie mode, (score DESC, docid ASC), so kernel 3 takes them
// as its secondary key. Liveness is decided here from the docids
// and the tombstone bitmap (row_live), so the host sends no counts and
// no mask. Rows [rows, out_len) of the buffer get -(2^31-1): a top-k of
// kk > rows reads them as the JAX merge reads its init entries. A row
// that fails the constraint filter or the facet bitmap (common.cuh
// Filter; the with_filter branch, _bitmap_member :325) scores -(2^31-1)
// as a dead one does; the statistics are then span_stats' under the same
// filter, or the filtered-stats cache's copy of them (the with_ext_stats
// branch).
//
// Bound: bytes, 34 B of features + 4 B flags + 4 B docid read and 4 B
// written a row (and the bitmap words, from the L2). The row pipeline is
// score_chunks': persistent warps, 64-row chunks staged by cp.async two
// stages deep, the docids in the host-id region; a chunk never straddles
// two sources.
__device__ __forceinline__ void score_extents_body(
    const Extents& x, const Filter& q, const uint8_t* __restrict__ dead,
    int64_t doc_cap, const int32_t* __restrict__ st,
    const int32_t* __restrict__ consts, unsigned char* smem, ScoreConsts& k,
    int32_t* __restrict__ out, int32_t* __restrict__ out_d, int64_t out_len,
    int block, int blocks) {
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
        if (out_d) out_d[x.obase[e] + r0 + j] = d;
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  for (int64_t r = x.obase[x.n] + (int64_t)block * blockDim.x + t;
       r < out_len; r += (int64_t)blocks * blockDim.x) {
    out[r] = SMALL;
    if (out_d) out_d[r] = -1;
  }
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
score_extents(const uint8_t* __restrict__ dead, int64_t doc_cap,
              const Extents x, const Filter q,
              const int32_t* __restrict__ st,
              const int32_t* __restrict__ consts,
              int32_t* __restrict__ out, int32_t* __restrict__ out_d,
              int64_t out_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ScoreConsts k;
  score_extents_body(x, q, dead, doc_cap, st, consts, smem, k, out, out_d,
                     out_len, blockIdx.x, gridDim.x);
}

// ---------------------------------------------------------------------------
// K7 batched with its selection `span_topk_batch`: a group read once
// ---------------------------------------------------------------------------
// The scoring pass of _rank_scan_batch_kernel (JAX package,
// devstore.py:465) with its running top-k (:540-548, _chunked_topk of a
// tile merged by lax.top_k), and the packed [bs, 2kk] output of
// _rank_scan_batch_packed_kernel (:1032). The slots of a group (identical
// extent lists, common.cuh group_slots) share its rows: the group's
// blocks stream them once (common.cuh's group stream: 16 warps, 8 chunks
// a step, three stages, one barrier a step), find each row's liveness,
// term frequency and the profile's terms of its score (score_row's
// profile_terms) once, and score the row against each slot of the group
// whose filter it passes (stats_terms; each slot's constants in shared
// memory, loaded into registers where a warp's share moves to the slot).
//
// The selection (common.cuh, shared with K7bp's) keeps each slot's kk
// best rows in the order of the JAX merge, score descending, then the
// row's place in the slot's extent order ascending: a block's sorted
// list and candidate buffer (K7_CAND keys) a slot, merged after a step
// whose buffer passed K7_CAND - K7_STEP, the blocks' lists merged up a
// tree; the root writes each slot's row of [bs, 2kk]: the scores, then
// the docids (from the rows' places), and (-(2^31-1), -1) where a slot
// has fewer than kk rows.
// Up to FUSED_KK, where every group's lists fit beside the stages (GL
// false), a block's lists take G (KL + K7_CAND) keys of shared memory for
// a group of G slots (on an H100 16 slots fit at kk <= 128, six at kk =
// 2048). Past FUSED_KK, or where a group has more slots than fit (GL
// true, common.cuh gflush), only the buffers stay in shared memory
// (GL_KEYS keys shared by the group's slots, up to 4,096 a slot) and each
// slot's list lies in device memory, so a group of 16 stays whole at
// every kk: every kk the scan kind sends takes this kernel, and no group
// is cut (before, a group past the room was cut into groups that each
// read its rows again). There a step that fills one slot's buffer merges
// every slot's that holds candidates: the sort's barriers are paid once
// for all. There a group's blocks are no more than its rows hold kk
// keys each (at least one), so that the lists in device memory come to
// at most twice the group's rows a slot, and the tree stays short when
// kk is large against the rows.
//
// Bound: the larger of the bytes (each distinct row of a group read once:
// 34 B of features, 4 B of flags and of docid, the tombstone byte; the
// statistics, the constants and [bs, 2kk] written) and the operations
// (score_row's integer and f32 steps for each row and slot whose filter
// it passes: at 8 slots a group about as long as the bytes). Before, each
// slot had a range of the grid of its own, read its rows itself and
// wrote a score a row, and kernel 3 read each slot's region back in 16
// launches; past FUSED_KK that stayed the route (355 MB of scores at the
// bench's 16-slot wave, 36 device operations a wave).
constexpr int K7_CHUNKS = 8, K7_STEP = K7_CHUNKS * CH, K7_STAGES = 3;
constexpr int K7_CAND = 1024;       // a slot's candidate buffer, keys
// with the lists in device memory (GL) the buffers share GL_KEYS keys:
// CW = gl_cand(G) a slot
constexpr int GL_KEYS = BATCH_SLOTS * K7_CAND, GL_CAND_MOST = 4096;
__host__ __device__ constexpr int gl_cand(int G) {
  int cw = K7_CAND;
  while (2 * cw <= GL_CAND_MOST && 2 * cw * G <= GL_KEYS) cw *= 2;
  return cw;
}
constexpr int K7_FIXED =            // the stages
    K7_STAGES * K7_CHUNKS * EXT_STAGE_BYTES;

template <bool GL>
__global__ void __launch_bounds__(G_THREADS, 1)
topk_groups(const int16_t* __restrict__ feats,
            const int32_t* __restrict__ flags,
            const int32_t* __restrict__ docids,
            const uint8_t* __restrict__ dead, int64_t doc_cap,
            const __grid_constant__ ScanBatch b,
            const int32_t* __restrict__ stats, int64_t stats_stride,
            const int32_t* __restrict__ consts, int kk,
            int KL, u64* __restrict__ glists, int32_t* __restrict__ grec,
            uint32_t* __restrict__ tickets, int32_t* __restrict__ out) {
  constexpr int SB = EXT_STAGE_BYTES;
  constexpr int RG = K7_STEP / 32;  // 32-row groups a step
  extern __shared__ __align__(16) unsigned char smem[];
  u64* lists = (u64*)(smem + K7_FIXED);
  __shared__ StepFacts<K7_CHUNKS, true> sf[2];
  __shared__ ScoreConsts sk[BATCH_SLOTS];
  __shared__ Extents x;
  __shared__ Filter q[BATCH_SLOTS];
  __shared__ int s_cnt[BATCH_SLOTS];
  __shared__ u64 s_thr[BATCH_SLOTS];
  __shared__ bool s_go;
  // GL: each slot's list length and half, and gmerge_tree's words
  __shared__ int s_len[BATCH_SLOTS], s_half[BATCH_SLOTS];
  __shared__ int s_p[2 * BATCH_SLOTS + 2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = range_of_block(b.gbstart, b.ng, blockIdx.x);
  const int block = blockIdx.x - b.gbstart[g];
  const int blocks = b.gbstart[g + 1] - b.gbstart[g];
  const int s0 = b.gfirst[g], G = b.gfirst[g + 1] - s0;
  // GL: KL is the lists' capacity L, the buffers CW apart
  const int CW = GL ? gl_cand(G) : K7_CAND;
  const int LW = GL ? CW : KL + K7_CAND;
  auto glist = [&](int k, int leaf, int half) {
    return glists + ((b.glist[g] + (int64_t)k * blocks + leaf) * 2 + half) *
                        (int64_t)KL;
  };
  auto mylist = [&](int k, int half) { return glist(k, block, half); };
  if (t == 0)
    slot_extents(b, b.gslot[s0], feats, flags, docids, x, q[0]);
  else if (t < G)
    slot_filter(b, b.gslot[s0 + t], q[t]);
  if (t < G) {
    s_cnt[t] = 0;
    s_thr[t] = 0;
    s_len[t] = 0;
    s_half[t] = 0;
  }
  if (!GL)
    for (int i2 = t; i2 < G * KL; i2 += G_THREADS)
      lists[(i2 / KL) * LW + i2 % KL] = 0;
  for (int i2 = t; i2 < G * 64; i2 += G_THREADS)
    fill_consts(sk[i2 >> 6],
                stats + (int64_t)b.gslot[s0 + (i2 >> 6)] * stats_stride,
                consts, i2 & 63);
  __syncthreads();
  const int64_t chunks = x.cbase[x.n];
  const int64_t first = (int64_t)block * K7_CHUNKS;
  const int64_t stride = (int64_t)blocks * K7_CHUNKS;
  const int steps = chunks > first ? (int)((chunks - first + stride - 1) /
                                           stride) : 0;
  auto stage = [&](int i, int u) {
    return smem + ((i % K7_STAGES) * K7_CHUNKS + u) * SB;
  };
  auto issue = [&](int i) {
    const int64_t c = first + (int64_t)i * stride + warp;
    if (i < steps && warp < K7_CHUNKS && c < chunks)
      issue_group_chunk(x, c, true, stage(i, warp), lane);
    cp_async_commit();
  };
  int lo, hi;
  item_range(G * RG, warp, lo, hi);
  auto flush = [&](unsigned need) {
    if (GL)
      gflush(lists, LW, kk, KL, G, need, s_cnt, s_thr, s_len, s_half,
             mylist);
    else
      flush_cands(lists, LW, KL, kk, G, need, s_cnt, s_thr);
  };
  // The steps, in one of two copies: PRE takes the profile's terms of a
  // row's score (the same for every slot) once a row in the facts, where
  // a group has more than one slot; without it the items add them, and
  // the warps that stage (the facts' work) carry no more than the others.
  auto run = [&](auto pre_c) {
    constexpr bool PRE = decltype(pre_c)::value;
    auto facts = [&](int i) {
      RegConsts pk;
      if (PRE) load_consts(sk[0], pk);
      return facts_begin<K7_CHUNKS, true>(
          x, first + (int64_t)i * stride + warp, stage(i, warp), dead,
          doc_cap, PRE, pk, sf[i & 1], warp, lane);
    };
    const bool stager = warp < K7_CHUNKS;
    for (int i = 0; i < K7_STAGES - 1; ++i) issue(i);
    cp_async_wait<K7_STAGES - 2>();
    __syncwarp();
    if (0 < steps && stager) facts_end(facts(0), sf[0], warp, lane);
    __syncthreads();
    // the statistics' constants of slot k_have, kept over the steps (a
    // warp whose share stays in one slot loads them once)
    RegConsts rk;
    int k_have = -1;
    for (int i = 0; i < steps; ++i) {
      issue(i + K7_STAGES - 1);
      cp_async_wait<K7_STAGES - 2>();
      __syncwarp();
      // step i + 1's facts, their tombstone bytes loaded under step i's
      // items
      const bool ahead = i + 1 < steps && stager;
      RowsPending pend{};
      if (ahead) pend = facts(i + 1);
      const StepFacts<K7_CHUNKS, true>& fs = sf[i & 1];
      for (int it = lo; it < hi;) {
        const int k = it / RG;
        const int end = hi < (k + 1) * RG ? hi : (k + 1) * RG;
        if (k != k_have) {
          load_consts(sk[k], rk);
          k_have = k;
        }
        const Filter qk = q[k];
        const bool off = filter_off(qk);
        const u64 thr = s_thr[k];
        u64* cand = lists + k * LW + (GL ? 0 : KL);
        for (; it < end; ++it) {
          const int h = it % RG;
          const int u = h >> 1, j = 2 * lane + (h & 1);
          const int r = u * CH + (h & 1) * 32 + lane;
          bool c = false;
          u64 key = 0;
          if (fs.tfb[r] != DEAD_ROW) {
            const int e = fs.e[u];
            const Stage<int16_t> sg(stage(i, u), x.feats[e], x.flags[e],
                                    x.docids[e], nullptr);
            const int16_t* f = sg.row(j);
            if (off ||
                constraint_ok(f[F_LANGUAGE], f[F_LASTMOD], sg.flag(j), qk)) {
              const uint32_t pt =
                  PRE ? fs.base[r]
                      : profile_terms(f[F_DOMLENGTH], f[F_LANGUAGE],
                                      sg.flag(j), rk);
              const int32_t score = (int32_t)(
                  stats_terms<int16_t, true>(f, rk,
                                             __int_as_float(fs.tfb[r])) +
                  pt);
              key = row_key(score, fs.pos0[u] + j);
              c = score > SMALL && key > thr;
            }
          }
          append_key(c, key, cand, &s_cnt[k], lane);
        }
      }
      if (ahead) facts_end(pend, sf[(i + 1) & 1], warp, lane);
      __syncthreads();
      // a buffer past CW - K7_STEP is merged before the next step's items
      // add up to K7_STEP; GL: every slot's buffer with candidates is
      // merged then too (one sort's barriers for all)
      unsigned need = 0u, some = 0u;
      for (int k = 0; k < G; ++k) {
        if (s_cnt[k] > CW - K7_STEP) need |= 1u << k;
        if (s_cnt[k] > 0) some |= 1u << k;
      }
      if (need) flush(GL ? some : need);
    }
  };
  if (G > 1)
    run(std::true_type{});
  else
    run(std::false_type{});
  cp_async_wait<0>();
  unsigned need = 0u;
  for (int k = 0; k < G; ++k)
    if (s_cnt[k] > 0) need |= 1u << k;
  if (need) flush(need);

  // the group's blocks' lists merged pairwise up a tree (from shared
  // memory slot k's of leaf l at (glist[g] + k * blocks + l) * KL of the
  // scratch; GL where they lie, glist); the root writes each slot's kk
  // best as scores, then docids
  uint32_t* tk = tickets + (int64_t)b.gbstart[g] * TREE_WORDS;
  if (GL) {
    __syncthreads();                      // the stages are free
    const int room =
        (int)((K7_FIXED + (int64_t)G * CW * 8) / 8);
    if (!gmerge_tree((u64*)smem, room, KL, G, s_len, s_half, s_p,
                     grec + (int64_t)b.gbstart[g] * TREE_WORDS * TREE_REC,
                     tk, block, blocks, glist))
      return;
  } else if (!merge_tree(lists, LW, KL, G, glists + b.glist[g] * KL,
                         (int64_t)blocks * KL, tk, block, blocks, &s_go)) {
    return;
  }
  for (int64_t i2 = t; i2 < (int64_t)G * kk; i2 += G_THREADS) {
    const int k = (int)(i2 / kk);
    const int64_t i = i2 - (int64_t)k * kk;
    u64 key;
    if (GL)
      key = i < s_len[k] ? __ldcg(mylist(k, s_half[k]) + i) : 0ull;
    else
      key = lists[k * LW + i];
    int32_t sv = SMALL, d = -1;
    if (key) {
      sv = key_score(key);
      d = docid_at(x, key_place(key));
    }
    int32_t* o = out + (int64_t)b.gslot[s0 + k] * 2 * kk;
    o[i] = sv;
    o[kk + i] = d;
  }
}

// ---------------------------------------------------------------------------
// K7bp over a bit-packed span: `span_topk_bp` (with its selection) and
// `span_score_bp` (a score a row)
// ---------------------------------------------------------------------------
// The scoring pass of _rank_scan_batch_bp_kernel (JAX package,
// devstore.py:1213, a slot of it) over one packed span of `count` rows:
// each row scored against the given statistics with score_row's terms
// (the compact path's division), dead rows and rows the filter rejects
// out. `topk_bp` keeps the running top-k in the pass, as the reference
// does (:1265-1272): the span's kk best rows by score, then place (the
// JAX merge's order), with the batched K7's selection (common.cuh: one
// sorted list and a buffer of BP_CAND keys a block, the blocks' lists
// merged up a tree); the root writes [2kk], the scores, then the docids
// decoded from the winners' places, (-(2^31-1), -1) where fewer than kk
// rows are live. `score_bp` writes a score a row instead (-(2^31-1) for
// the rows out, and for [count, out_len)), for kernel 3 in index mode
// past FUSED_KK.
//
// Bound: bytes, the packed payload (row_bits / 8 a row, flags and the 15
// scored features: the doctype and the flags feature column are never
// staged) and the tombstone bytes; score_bp writes 4 B a row more.
// Before, a thread decoded a row a grid-stride step from the store (38
// scalar loads, clamped 64-bit indices), 2.8x K7 on the same rows, and
// wrote 4 B a row that kernel 3 read back in two launches and
// topk_finish_bp decoded the winners' docids in one more. Now the tiles
// stream through shared memory (common.cuh bp_run: blocks of 8 warps,
// two an SM, a tile's docids and their tombstone loads a step before the
// rest) and each thread scores its two rows of a tile from the stage
// (bp_score_pair), column by column: the geometry of a column is read
// once for both rows, and only the values the profile's and the tf terms
// need stay in registers beside the constants.
constexpr int BP_CAND = 2 * BP_TILE;  // a block's candidate buffer, keys

__global__ void __launch_bounds__(BP_THREADS, BP_MIN_BLOCKS)
topk_bp(const __grid_constant__ BpPlan P, const uint8_t* __restrict__ dead,
        int64_t doc_cap, const Filter q, const int32_t* __restrict__ st,
        const int32_t* __restrict__ consts, int kk, int KL,
        u64* __restrict__ glists, uint32_t* __restrict__ tickets,
        int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* lists = (u64*)(smem + (size_t)BP_STAGES * P.stage_words * 4);
  __shared__ BpTabs tb;
  __shared__ ScoreConsts sk;
  __shared__ int s_cnt[1];
  __shared__ u64 s_thr[1];
  __shared__ bool s_go;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int LW = KL + BP_CAND;
  bp_tables(P, tb, t);
  fill_consts(sk, st, consts, t);
  for (int i = t; i < KL; i += BP_THREADS) lists[i] = 0;
  if (t == 0) {
    s_cnt[0] = 0;
    s_thr[0] = 0;
  }
  __syncthreads();
  RegConsts rk;
  load_consts(sk, rk);
  const bool off = filter_off(q);
  u64* cand = lists + KL;
  bp_run(
      P, smem, blockIdx.x, gridDim.x,
      [&] {
        // a buffer that the next tile could overfill is merged first
        if (s_cnt[0] > BP_CAND - BP_TILE)
          flush_cands(lists, LW, KL, kk, 1, 1u, s_cnt, s_thr);
      },
      [&](int64_t tile, const uint32_t* sw) {
        return bp_head(P, tb, tile, sw, dead, doc_cap, lane, warp);
      },
      [&](int64_t tile, const uint32_t* sw, const BpGone& gone) {
        int32_t sc[2];
        bool ok[2];
        bp_score_pair(sw, P, tb, gone, q, off, rk, lane, warp, sc, ok);
        const u64 thr = s_thr[0];
        const int64_t p = tile * BP_TILE + 32 * warp + lane;
        const u64 k0 = row_key(sc[0], p), k1 = row_key(sc[1], p + BP_HALF);
        append_key(ok[0] && sc[0] > SMALL && k0 > thr, k0, cand, s_cnt,
                   lane);
        append_key(ok[1] && sc[1] > SMALL && k1 > thr, k1, cand, s_cnt,
                   lane);
      });
  if (s_cnt[0] > 0) flush_cands(lists, LW, KL, kk, 1, 1u, s_cnt, s_thr);
  if (!merge_tree(lists, LW, KL, 1, glists, (int64_t)gridDim.x * KL, tickets,
                  blockIdx.x, gridDim.x, &s_go))
    return;
  for (int i = t; i < kk; i += BP_THREADS) {
    const u64 key = lists[i];
    int32_t sv = SMALL, d = -1;
    if (key) {
      sv = key_score(key);
      d = unpack_col(P.words, P.nw, P.wbase, P.m.v, C_DOCIDS, key_place(key));
    }
    out[i] = sv;
    out[kk + i] = d;
  }
}

__global__ void __launch_bounds__(BP_THREADS, BP_MIN_BLOCKS)
score_bp(const __grid_constant__ BpPlan P, const uint8_t* __restrict__ dead,
         int64_t doc_cap, const Filter q, const int32_t* __restrict__ st,
         const int32_t* __restrict__ consts, int32_t* __restrict__ out,
         int64_t out_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ BpTabs tb;
  __shared__ ScoreConsts sk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  bp_tables(P, tb, t);
  fill_consts(sk, st, consts, t);
  __syncthreads();
  RegConsts rk;
  load_consts(sk, rk);
  const bool off = filter_off(q);
  bp_run(
      P, smem, blockIdx.x, gridDim.x, [] {},
      [&](int64_t tile, const uint32_t* sw) {
        return bp_head(P, tb, tile, sw, dead, doc_cap, lane, warp);
      },
      [&](int64_t tile, const uint32_t* sw, const BpGone& gone) {
        const int64_t nr = P.count - tile * BP_TILE;
        int32_t sc[2];
        bool ok[2];
        bp_score_pair(sw, P, tb, gone, q, off, rk, lane, warp, sc, ok);
        const int r0 = 32 * warp + lane;
        int32_t* o = out + tile * BP_TILE + r0;
        if (r0 < nr) o[0] = ok[0] ? sc[0] : SMALL;
        if (r0 + BP_HALF < nr) o[BP_HALF] = ok[1] ? sc[1] : SMALL;
      });
  for (int64_t r = P.count + (int64_t)blockIdx.x * BP_THREADS + t;
       r < out_len; r += (int64_t)gridDim.x * BP_THREADS)
    out[r] = SMALL;
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
// out [out_len] int32, out_len >= the extents' and the delta's rows;
// out_docids [out_len] int32 or null: each scored row's docid beside its
// score (-1 past the rows), for kernel 3's tie mode.
extern "C" int yt_span_score(const void* feats, const void* flags,
                             const void* docids, const void* dead,
                             int64_t doc_cap, const int64_t* ext, int n_ext,
                             const int32_t* filt, const void* allow,
                             int64_t nwords, const void* dfeats,
                             const void* dflags, const void* ddocids,
                             int64_t dn, const void* stats,
                             const void* consts, void* out, void* out_docids,
                             int64_t out_len, void* stream) {
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
      (const int32_t*)consts, (int32_t*)out, (int32_t*)out_docids, out_len);
  return (int)cudaGetLastError();
}

// The batched K7's layout for a wave (slots, bs, kk): the wave b with its
// groups and their blocks, GL (the lists in device memory: kk past
// FUSED_KK, or a group whose lists do not fit beside the stages), KL (in
// shared memory the pow2 at or above kk, in device memory the lists'
// capacity L), the grid, the dynamic shared memory, the scratch's bytes
// (the lists, and with GL the tree's records) and the ticket
// words a call needs (a device's constant: TREE_WORDS a block of the
// largest grid). Cached per device: the resident blocks and the keys a
// block's lists may take.
static cudaError_t topk_plan(const int32_t* slots, int bs, int kk,
                             ScanBatch* b, bool* GL, int* KL, int* grid,
                             int* smem, int64_t* scratch_bytes,
                             int64_t* ticket_words) {
  if (bs < 1 || bs > BATCH_SLOTS || kk < 1 || kk > (1 << 30))
    return cudaErrorInvalidValue;
  if (!scan_batch_of(slots, bs, b)) return cudaErrorInvalidValue;
  int64_t most_rows = 1;
  for (int s = 0; s < bs; ++s) {
    int64_t rows = 0;
    for (int e = 0; e < b->n[s]; ++e) rows += b->count[s][e];
    if (rows >= ((int64_t)1 << 32) - 1) return cudaErrorInvalidValue;
    most_rows = rows > most_rows ? rows : most_rows;
  }
  static int keys_of[64], limit_of[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (limit_of[dev] <= 0) {
    int optin = 0, sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa, fg;
    e = cudaFuncGetAttributes(&fa, topk_groups<false>);
    if (e != cudaSuccess) return e;
    e = cudaFuncGetAttributes(&fg, topk_groups<true>);
    if (e != cudaSuccess) return e;
    const int fixed = (int)(fa.sharedSizeBytes > fg.sharedSizeBytes
                                ? fa.sharedSizeBytes
                                : fg.sharedSizeBytes);
    const int most = optin - fixed;
    if (most < K7_FIXED + (FUSED_KK + K7_CAND) * 8 ||
        most < K7_FIXED + GL_KEYS * 8)
      return cudaErrorInvalidConfiguration;
    e = cudaFuncSetAttribute(topk_groups<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(topk_groups<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      topk_groups<false>,
                                                      G_THREADS, most);
    if (e != cudaSuccess) return e;
    keys_of[dev] = (most - K7_FIXED) / 8;
    limit_of[dev] = (per_sm < 1 ? 1 : per_sm) * sms;
  }
  // the lists in shared memory where every group's fit beside the
  // stages (up to FUSED_KK), else in device memory
  int kl = 1;
  while (kl < kk) kl <<= 1;
  int gmax = kk <= FUSED_KK ? keys_of[dev] / (kl + K7_CAND) : 0;
  group_slots(b);
  int gbig = 1;
  for (int g = 0; g < b->ng; ++g)
    if (b->gfirst[g + 1] - b->gfirst[g] > gbig)
      gbig = b->gfirst[g + 1] - b->gfirst[g];
  const bool gl = gbig > gmax;
  // in device memory the lists' capacity, even (16-byte aligned lists)
  if (gl) kl = (int)(((kk < most_rows ? kk : most_rows) + 1) & ~1LL);
  // GL: a block takes at least kk rows' chunks
  int per_block = K7_CHUNKS;
  if (gl && (kk + CH - 1) / CH > per_block) per_block = (kk + CH - 1) / CH;
  *grid = group_blocks(b, per_block, limit_of[dev]);
  int gmost = 1;
  b->glist[0] = 0;
  for (int g = 0; g < b->ng; ++g) {
    const int G = b->gfirst[g + 1] - b->gfirst[g];
    gmost = G > gmost ? G : gmost;
    b->glist[g + 1] =
        b->glist[g] + (int64_t)G * (b->gbstart[g + 1] - b->gbstart[g]);
  }
  *GL = gl;
  *KL = kl;
  *smem = K7_FIXED + (gl ? GL_KEYS : gmost * (kl + K7_CAND)) * 8;
  const int64_t nlists = b->glist[b->ng];
  *scratch_bytes =
      gl ? nlists * 2 * kl * 8 + (int64_t)*grid * TREE_WORDS * TREE_REC * 4
         : nlists * kl * 8;
  *ticket_words = (int64_t)TREE_WORDS * (limit_of[dev] + BATCH_SLOTS);
  return cudaSuccess;
}

// What a batched K7 call over the wave (slots, bs) at kk needs of its
// caller: out[0] the scratch's bytes, out[1] the ticket words (zero, and
// left at zero by every call).
extern "C" int yt_span_topk_batch_plan(const int32_t* slots, int bs, int kk,
                                       int64_t* out) {
  ScanBatch b{};
  bool gl = false;
  int KL = 0, grid = 0, smem = 0;
  int64_t bytes = 0, words = 0;
  const cudaError_t e =
      topk_plan(slots, bs, kk, &b, &gl, &KL, &grid, &smem, &bytes, &words);
  if (e != cudaSuccess) return (int)e;
  out[0] = bytes;
  out[1] = words;
  return 0;
}

// K7 batched with its selection over a wave of bs <= 16 slots (common.cuh
// scan_batch_of, in host memory), 1 <= kk <= 2^30; the arena as for K7;
// stats the wave's statistics, slot i at i * stats_stride int32; consts
// int32[44] (one profile a wave); scratch of scratch_bytes and tickets of
// ticket_words as yt_span_topk_batch_plan asks; out [bs, 2kk] int32: each
// slot's kk best scores, then their docids.
extern "C" int yt_span_topk_batch(const void* feats, const void* flags,
                                  const void* docids, const void* dead,
                                  int64_t doc_cap, const int32_t* slots,
                                  int bs, const void* stats,
                                  int64_t stats_stride, const void* consts,
                                  int kk, void* scratch,
                                  int64_t scratch_bytes, void* tickets,
                                  int64_t ticket_words, void* out,
                                  void* stream) {
  ScanBatch b{};
  bool gl = false;
  int KL = 0, grid = 0, smem = 0;
  int64_t bytes = 0, words = 0;
  cudaError_t e =
      topk_plan(slots, bs, kk, &b, &gl, &KL, &grid, &smem, &bytes, &words);
  if (e != cudaSuccess) return (int)e;
  if (scratch_bytes < bytes || ticket_words < words ||
      (int64_t)TREE_WORDS * grid > words)
    return (int)cudaErrorInvalidValue;
  // GL: the tree's records follow the lists
  int32_t* rec = (int32_t*)((u64*)scratch + b.glist[b.ng] * 2 * KL);
  auto k = gl ? topk_groups<true> : topk_groups<false>;
  k<<<grid, G_THREADS, smem, (cudaStream_t)stream>>>(
      (const int16_t*)feats, (const int32_t*)flags, (const int32_t*)docids,
      (const uint8_t*)dead, doc_cap, b, (const int32_t*)stats, stats_stride,
      (const int32_t*)consts, kk, KL, (u64*)scratch, rec, (uint32_t*)tickets,
      (int32_t*)out);
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

// K7bp: words [nw] int32 (the packed-words store), the span's block at
// word wbase with meta (57 int32, host memory) and `count` rows; dead
// [doc_cap] bool; filt the filter's 4 int32 in host memory; stats
// int32[38]; consts int32[44]; out [out_len] int32, out_len >= count.
extern "C" int yt_span_score_bp(const void* words, int64_t nw, int64_t wbase,
                                const int32_t* meta, int64_t count,
                                const void* dead, int64_t doc_cap,
                                const int32_t* filt, const void* stats,
                                const void* consts, void* out,
                                int64_t out_len, void* stream) {
  if (nw < 1 || count < 0 || out_len < count)
    return (int)cudaErrorInvalidValue;
  BpPlan P;
  if (!make_bp_plan(words, nw, wbase, meta, count, BP_SCORED, &P))
    return (int)cudaErrorInvalidValue;
  const Filter q = make_filter(filt, nullptr, 0);
  static int most[64], occ[64][BP_OCC];
  int smem = 0, grid = 0;
  cudaError_t e = bp_shape(score_bp, P, 0, most, occ, &smem, &grid);
  if (e != cudaSuccess) return (int)e;
  score_bp<<<grid, BP_THREADS, smem, (cudaStream_t)stream>>>(
      P, (const uint8_t*)dead, doc_cap, q, (const int32_t*)stats,
      (const int32_t*)consts, (int32_t*)out, out_len);
  return (int)cudaGetLastError();
}

// K7bp with its selection's layout: the plan, KL, the dynamic shared
// memory and the grid.
static cudaError_t topk_bp_shape(const void* words, int64_t nw,
                                 int64_t wbase, const int32_t* meta,
                                 int64_t count, int kk, BpPlan* P, int* KL,
                                 int* smem, int* grid) {
  if (nw < 1 || count < 0 || count >= ((int64_t)1 << 32) - 1 || kk < 1 ||
      kk > FUSED_KK)
    return cudaErrorInvalidValue;
  if (!make_bp_plan(words, nw, wbase, meta, count, BP_SCORED, P))
    return cudaErrorInvalidValue;
  int kl = 1;
  while (kl < kk) kl <<= 1;
  *KL = kl;
  static int most[64], occ[64][BP_OCC];
  return bp_shape(topk_bp, *P, (int64_t)(kl + BP_CAND) * 8, most, occ, smem,
                  grid);
}

// What span_topk_bp calls at kk on the current device need of their
// caller, whatever the block: out[0] the scratch's bytes, out[1] the
// ticket words (zero, and left at zero by every call), for as many blocks
// as the card could hold (2048 threads an SM).
extern "C" int yt_span_topk_bp_plan(int kk, int64_t* out) {
  if (kk < 1 || kk > FUSED_KK) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int kl = 1;
  while (kl < kk) kl <<= 1;
  const int64_t blocks = (int64_t)(2048 / BP_THREADS) * sms;
  out[0] = blocks * kl * 8;
  out[1] = (int64_t)TREE_WORDS * blocks;
  return 0;
}

// K7bp with its selection (1 <= kk <= FUSED_KK): the arguments as K7bp's;
// scratch of scratch_bytes and tickets of ticket_words as
// yt_span_topk_bp_plan asks; out [2kk] int32: the span's kk best scores,
// then their docids.
extern "C" int yt_span_topk_bp(const void* words, int64_t nw, int64_t wbase,
                               const int32_t* meta, int64_t count,
                               const void* dead, int64_t doc_cap,
                               const int32_t* filt, const void* stats,
                               const void* consts, int kk, void* scratch,
                               int64_t scratch_bytes, void* tickets,
                               int64_t ticket_words, void* out,
                               void* stream) {
  BpPlan P;
  int KL = 0, smem = 0, grid = 0;
  cudaError_t e = topk_bp_shape(words, nw, wbase, meta, count, kk, &P, &KL,
                                &smem, &grid);
  if (e != cudaSuccess) return (int)e;
  if (scratch_bytes < (int64_t)grid * KL * 8 ||
      ticket_words < (int64_t)TREE_WORDS * grid)
    return (int)cudaErrorInvalidValue;
  const Filter q = make_filter(filt, nullptr, 0);
  topk_bp<<<grid, BP_THREADS, smem, (cudaStream_t)stream>>>(
      P, (const uint8_t*)dead, doc_cap, q, (const int32_t*)stats,
      (const int32_t*)consts, kk, KL, (u64*)scratch, (uint32_t*)tickets,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
