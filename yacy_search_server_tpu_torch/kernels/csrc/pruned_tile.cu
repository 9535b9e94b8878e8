// K5 `pruned_tile`: the devstore's b = 1 pruned query, a batch of slots.
// Replaces index/devstore._rank_pruned_batch1_kernel and its packed twin
// _rank_pruned_batch1_packed_kernel (JAX package, devstore.py:897,
// :1009), and _rank_pruned_kernel / _rank_pruned_batch_kernel at b = 1
// (:866, :959, body _pruned_span_topk :799). Each slot of the fused
// descriptor (_pack_batch1_fused's layout) scores the first TILE =
// 32,768 rows of its span's proxy-sorted extent against the span's
// frozen statistics, keeps the kk best by (score descending, place in
// the tile ascending), gathers their docids and checks that no tail tile
// of the span, bounded by its pmax row, can beat the kk-th score.
// Output [bs, 2kk + 1] int32: scores, docids, ok.
//
// `init` selects the general kernel's form: its running merge starts
// from kk entries (-(2^31-1), docid -1) that precede every row, so where
// the kk-th row scores -(2^31-1) or less those entries take its place.
// Without `init` (the batched kernel) such places keep the rows' docids.
// A row that is dead, or past the span's count inside the tile, scores
// -(2^31-1) and keeps its place, so such rows fill a short slot in place
// order with the docids the tile holds there.
//
// Bound: bytes, 42 B a row read (34 B features, flags, docid) and the
// tombstone bytes the docids hit: 1.38 MB a slot, 0.4 us at 3.35 TB/s,
// under an empty launch's time. So what counts is the chain of steps
// after the launch. Before, a scoring kernel wrote the tile's scores to
// a scratch buffer and a selection kernel of one 1,024-thread block a
// slot ran six radix passes, a candidate pass and a bitonic sort on one
// SM (0.0398 device ms at one slot). Now one launch a call holds one
// thread-block cluster a slot (PT_CLUSTER = 16 CTAs, a non-portable size;
// 8 where the card cannot hold 16), and each CTA of 8 warps takes 2,048
// contiguous rows of the tile, staged all at once by cp.async (K5: its
// int16 chunks, by copy_span_async, so that no load holds a warp). A
// thread scores the CTA's rows t, t + 256, .. (the span is proxy-sorted,
// so the best rows fall to different threads) and keeps each row's 64-bit
// key (common.cuh row_key: the score, then the place's complement; every
// key distinct, a larger key ranks first) in registers, E a thread.
// Up to PRE_KK = 128 a cheap bound leaves some 200 of a CTA's 2,048 keys
// (cluster_topk): a bitonic network over them (select_top, cta_top:
// strides inside a thread in registers, inside a warp by shuffles, across
// warps through a shared exchange buffer, one barrier a stage; the sort
// stops at runs of kk and each later round keeps the larger half of a
// pair of runs) gives the CTA's kk best, which it stores into the leader
// CTA's shared memory; after one cluster barrier the leader bounds the
// lists again and, where one list holds every key that reaches the bound
// (the proxy order's CTA 0 at the smoke's 10M term), takes it as it is.
// Past PRE_KK every key takes the network and the lists meet in levels
// through distributed shared memory. The leader writes the slot's row:
// scores, docids and the tail check over the span's pmax rows. No score
// leaves the chip; nothing is allocated beside the output.
//
// K5bp `pruned_tile_bp` is the same query over a bit-packed span
// (replaces _rank_pruned_batch1_bp_kernel, devstore.py:1151): each CTA
// stages its four 512-row tiles at once (common.cuh bp_issue_tile; the
// plan built on the card by one warp, bp_plan_warp), takes each tile's
// docids and tombstone loads (bp_head) before any score (bp_score_pair),
// and the leader decodes the winners' docids from the store (unpack_col,
// whose clamp also covers the places past the block's count, which the
// stages never decode). The slot's word base takes the start's place in
// the descriptor, and each slot's meta vector follows the fused layout;
// BP_SLOTS slots a launch keep the parameters under 4 KB. Bound: bytes,
// the tile's packed payload (row_bits / 8 a row) and the tombstone bytes.
//
// The descriptor travels by value in the launch's parameters (up to
// SLOTS slots a launch; more slots take more launches), so a query
// uploads nothing before its kernel and the host never waits on a copy
// from pageable memory.
//
// `topk_finish` is the tail of the other routes: after kernel 3 (index
// mode) over K7's buffer it maps each winner's row back to its docid (an
// arena row's, or a RAM delta row's where the winner lies in the delta's
// region after the extents), applies the init entries' rule and writes
// either the tail check's ok (the b > 1 escalation of _pruned_span_topk)
// or the scan's statistics (_rank_spans_packed_kernel's [2kk + 36]
// output). `topk_finish_batch` does the same for a wave of batched scans
// (_rank_scan_batch_packed_kernel's [bs, 2kk] output), one block a slot.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace yt {

constexpr int TILE = 32768;                 // devstore TILE
constexpr int SEL_THREADS = 1024;           // the finishes' blocks
constexpr int MAX_KK = 2048;
constexpr int SLOTS = 16;                   // slots a launch (2.6 KB)
constexpr int32_t INT32_MAX_ = 2147483647;
constexpr int PT_THREADS = BP_THREADS;      // a CTA of K5 / K5bp
constexpr int PT_CLUSTER = 16;              // CTAs a slot (8: the fallback)

// Up to SL slots of a descriptor, by value: the fused layout
// (_pack_batch1_fused: [bound_shift, lang_term, starts[bs], counts[bs],
// tstarts[bs], tcounts[bs], cmins[bs][17], cmaxs[bs][17], tf_mins[bs]
// (f32 bits), tf_maxs[bs] (f32 bits)]) cut into slot-major fields. The
// packed form (BpDesc) holds each slot's word base in `start` and its
// meta vector, which follow the fused layout as metas[bs][META_LEN].
template <int SL>
struct DescT {
  int32_t shift, lang;
  int32_t start[SL], count[SL], tstart[SL], tcount[SL];
  int32_t cmin[SL][NF], cmax[SL][NF];
  int32_t tmin[SL], tmax[SL];
};
using Desc = DescT<SLOTS>;
constexpr int BP_SLOTS = 8;                 // packed slots a launch (3.1 KB)
struct BpDesc : DescT<BP_SLOTS> {
  int32_t meta[BP_SLOTS][META_LEN];
};

// slots [first, first + n) of the fused descriptor q of bs slots
template <class D>
__host__ inline void fused_fields(const int32_t* q, int bs, int first, int n,
                                  D& d) {
  d.shift = q[0];
  d.lang = q[1];
  for (int j = 0; j < n; ++j) {
    const int i = first + j;
    d.start[j] = q[2 + i];
    d.count[j] = q[2 + bs + i];
    d.tstart[j] = q[2 + 2 * bs + i];
    d.tcount[j] = q[2 + 3 * bs + i];
    for (int c = 0; c < NF; ++c) {
      d.cmin[j][c] = q[2 + 4 * bs + i * NF + c];
      d.cmax[j][c] = q[2 + 4 * bs + bs * NF + i * NF + c];
    }
    d.tmin[j] = q[2 + 4 * bs + 2 * bs * NF + i];
    d.tmax[j] = q[2 + 5 * bs + 2 * bs * NF + i];
  }
}

__host__ inline Desc desc_of(const int32_t* q, int bs, int first, int n) {
  Desc d = {};
  fused_fields(q, bs, first, n, d);
  return d;
}

// the packed descriptor: the fused layout, then metas[bs][META_LEN]
__host__ inline BpDesc bp_desc_of(const int32_t* q, int bs, int first,
                                  int n) {
  BpDesc d = {};
  fused_fields(q, bs, first, n, d);
  const int32_t* metas = q + 2 + (4 + 2 * NF + 2) * bs;
  for (int j = 0; j < n; ++j)
    for (int c = 0; c < META_LEN; ++c)
      d.meta[j][c] = metas[(int64_t)(first + j) * META_LEN + c];
  return d;
}

// Is the tail tile with bound row pm beaten by theta? (devstore.py:939-951:
// cap leaves headroom for the language term; pm << pos only where
// pm <= cap >> pos; >> neg arithmetic; the sum wraps as int32.)
__device__ __forceinline__ bool tail_ok(int32_t pm, int32_t bound_shift,
                                        int32_t lang_term, int32_t theta) {
  const int pos = bound_shift > 0 ? bound_shift : 0;
  const int neg = bound_shift < 0 ? -bound_shift : 0;
  const int32_t cap =
      (int32_t)((uint32_t)(INT32_MAX_ - 2048) - (uint32_t)lang_term);
  int32_t shifted = pm > (cap >> pos) ? cap : (int32_t)((uint32_t)pm << pos);
  shifted >>= neg;
  return (int32_t)((uint32_t)shifted + (uint32_t)lang_term) <= theta;
}

// ---------------------------------------------------------------------------
// The selection of K5 and K5bp (head note)
// ---------------------------------------------------------------------------
// A CTA's N = E * T keys (T = PT_THREADS) are the network's: key j of
// thread t has index i = t * E + j, so strides below E stay in a
// thread, strides below 32 E in a warp (shuffles), the rest cross warps
// through the exchange buffer xb (two of N keys, j-major: key j of
// thread t at j * T + t, so that a warp's accesses meet no bank twice
// beyond the two a 64-bit key takes; one barrier a stage, the two
// alternate). A stage of stride s pairs i with i ^ s: both keep the
// larger (BOTH), or the pair is put in order, descending where (i &
// dbit) == 0 (dbit > s; dbit >= N: everywhere). Past the thread,
// whether i is the pair's lower index and which way the pair runs are
// the thread's alone, so a key costs one compare and one select.

// a stage of stride s < E, inside the thread (S a constant, so that every
// index into v stays a register)
template <int E, bool BOTH, int S = 1>
__device__ __forceinline__ void net_thread(u64 (&v)[E], int s, int base,
                                           int dbit) {
  if constexpr (S < E) {
    if (s != S) {
      net_thread<E, BOTH, 2 * S>(v, s, base, dbit);
      return;
    }
    const bool tdesc = (base & dbit) == 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j & S) continue;
      const u64 a = v[j], b = v[j | S];
      const bool first = (a > b) == (BOTH || (tdesc && (j & dbit) == 0));
      v[j] = first ? a : b;
      v[j | S] = BOTH ? v[j] : (first ? b : a);
    }
  }
}

template <int E, bool BOTH>
__device__ __forceinline__ void net_stage(u64 (&v)[E], int s, int dbit,
                                          u64* xb, int& par) {
  constexpr int T = PT_THREADS;
  const int t = threadIdx.x, base = t * E;
  if (s < E) {
    net_thread<E, BOTH>(v, s, base, dbit);
    return;
  }
  const int ts = s / E;
  const bool keep_max = BOTH || (((t & ts) == 0) == ((base & dbit) == 0));
  if (s < 32 * E) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const u64 o = __shfl_xor_sync(0xffffffffu, v[j], ts);
      v[j] = (v[j] > o) == keep_max ? v[j] : o;
    }
  } else {
    u64* b = xb + par * (E * T);
#pragma unroll
    for (int j = 0; j < E; ++j) b[j * T + t] = v[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const u64 o = b[j * T + (t ^ ts)];
      v[j] = (v[j] > o) == keep_max ? v[j] : o;
    }
    par ^= 1;
  }
}

// Runs of kk keys at [0, F kk), alternately descending and ascending,
// become their kk best, sorted descending, at [0, kk): log2 F rounds in
// which runs r and r ^ 1 both keep the larger of each pair (i, i ^ s), a
// bitonic sequence of the pair's kk best, merged in the next run's
// direction. The pairs' copies stay where they are, so every stage takes
// all threads.
template <int E>
__device__ __forceinline__ void net_reduce(u64 (&v)[E], int kk, int span,
                                           u64* xb, int& par) {
  for (int s = kk; s < span; s <<= 1) {
    net_stage<E, true>(v, s, 0, xb, par);
    for (int h = kk >> 1; h > 0; h >>= 1)
      net_stage<E, false>(v, h, s << 1, xb, par);
  }
}

// The CTA's kk best keys, sorted descending, at indices [0, kk) (kk a
// power of two, 16 <= kk <= N): runs of kk sorted, alternately descending
// and ascending (a bitonic sort up to kk), then reduced to one.
template <int E>
__device__ __forceinline__ void cta_top(u64 (&v)[E], int kk, u64* xb,
                                        int& par) {
  constexpr int T = PT_THREADS;
  constexpr int N = E * T;
  for (int len = 2; len <= kk; len <<= 1)
    for (int s = len >> 1; s > 0; s >>= 1)
      net_stage<E, false>(v, s, len, xb, par);
  net_reduce<E>(v, kk, N, xb, par);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The warp's 32 keys (one a lane) sorted descending across its lanes.
__device__ __forceinline__ u64 warp_sort(u64 x, int lane) {
  for (int len = 2; len <= 32; len <<= 1)
    for (int s = len >> 1; s > 0; s >>= 1) {
      const u64 o = __shfl_xor_sync(0xffffffffu, x, s);
      const bool keep_max = ((lane & s) == 0) == ((lane & len) == 0);
      x = (x > o) == keep_max ? x : o;
    }
  return x;
}

// The block's keys v[E] at or above thr, packed into cand[0, M) (in no
// order); returns M. s_sum holds the warps' counts.
template <int E>
__device__ __forceinline__ int compact(const u64 (&v)[E], u64 thr, u64* cand,
                                       int* s_sum) {
  constexpr int T = PT_THREADS;
  constexpr int W = T / 32;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int c = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) c += v[j] >= thr ? 1 : 0;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_sum[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    before += w < warp ? s_sum[w] : 0;
    total += s_sum[w];
  }
  int k = before + incl - c;
#pragma unroll
  for (int j = 0; j < E; ++j)
    if (v[j] >= thr) cand[k++] = v[j];
  __syncthreads();
  return total;
}

// The kk best of the keys cand[0, M) (kk <= M), sorted descending into
// list[0, kk): a network of E' keys a thread, E' the least of 1, 2, 4, 8
// (then EMAX) with E' T >= M (zero keys past M).
template <int E>
__device__ __forceinline__ void select_run(const u64* cand, int M, int kk,
                                           u64* xb, u64* list) {
  const int t = threadIdx.x;
  u64 v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = t * E + j;
    v[j] = i < M ? cand[i] : 0ull;
  }
  int par = 0;
  cta_top<E>(v, kk, xb, par);
  if (t * E < kk) {
#pragma unroll
    for (int j = 0; j < E; ++j) list[t * E + j] = v[j];
  }
}

template <int EMAX>
__device__ __forceinline__ void select_top(const u64* cand, int M, int kk,
                                           u64* xb, u64* list) {
  constexpr int T = PT_THREADS;
  if (M <= T)
    select_run<1>(cand, M, kk, xb, list);
  else if (M <= 2 * T)
    select_run<2>(cand, M, kk, xb, list);
  else if (M <= 4 * T)
    select_run<4>(cand, M, kk, xb, list);
  else if (EMAX <= 8 || M <= 8 * T)
    select_run<8>(cand, M, kk, xb, list);
  else
    select_run<EMAX>(cand, M, kk, xb, list);
}

constexpr int PRE_KK = 128;  // the largest kk the bounds take (head note)

// The slot's kk best keys over the cluster's CL CTAs, each holding its
// rows' keys v[E], and the leader's output row o [2kk + 1]. Up to PRE_KK:
// a bound first, the smallest over the W warps of each warp's (kk /
// W)-th largest thread maximum (warp_sort): at least kk keys of the CTA
// reach it, so its kk best do; only the keys at or above it (at most E
// kk; 226-240 of 2,048 at the smoke's 10M term) go into a network
// (compact, select_top), whose kk best, sorted descending, the CTA
// stores into run `rank` of the leader's `list` (distributed shared
// memory, once every CTA of the cluster runs). After one cluster barrier
// the leader bounds the CL lists by the largest of their kk-th keys; a
// list that holds every key reaching it (M2 = kk) is the answer as it
// stands, else the keys reaching it take the network. Past PRE_KK, each
// CTA's network takes its N keys (cta_top) and the lists meet in levels
// of fan-in F = N / kk (F = 2 where a CTA holds one list alone, kk = N:
// the partner's list mirrored, the larger key at each place kept): the
// CTAs of rank a multiple of span * F read the lists of ranks rank +
// span, .., rank + (F - 1) span as runs (odd runs mirrored: ascending)
// and reduce them (net_reduce); one cluster barrier a level. The leader
// then writes the scores and docids (docid_of(place)), with `init`'s
// rule, and the ok of the tail pmax[tstart + 1, tstart + tcount) against
// the kk-th score (its first rows loaded under the merge). No CTA leaves
// while another may still read its list.
template <int CL, int E, class DocidOf>
__device__ __forceinline__ void cluster_topk(
    u64 (&v)[E], u64* xb, u64* cand, u64* list, int kk, int init,
    int32_t shift, int32_t lang, int32_t tstart, int32_t tcount,
    const int32_t* __restrict__ pmax, int32_t* __restrict__ o,
    DocidOf docid_of) {
  constexpr int T = PT_THREADS;
  constexpr int N = E * T, W = T / 32;
  __shared__ u64 s_bound[CL > W ? CL : W];
  __shared__ int s_sum[W], s_fin;
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, base = t * E;
  cluster_arrive();                       // this CTA runs (see the waits)
  // the leader's first two pmax rows a thread, loaded under the merge
  int32_t pm[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int j = 1 + t + q * T;
    pm[q] = rank == 0 && j < tcount ? pmax[(int64_t)tstart + j] : 0;
  }
  if (t == 0) s_fin = 0;
  if (kk <= PRE_KK) {
    u64 m = v[0];
#pragma unroll
    for (int j = 1; j < E; ++j) m = v[j] > m ? v[j] : m;
    m = warp_sort(m, lane);
    const u64 mine = __shfl_sync(0xffffffffu, m, kk / W - 1);
    if (lane == 0) s_bound[warp] = mine;
    __syncthreads();
    u64 thr = s_bound[0];
#pragma unroll
    for (int w = 1; w < W; ++w) thr = s_bound[w] < thr ? s_bound[w] : thr;
    const int M = compact<E>(v, thr, cand, s_sum);
    // each CTA's list goes straight into run `rank` of the leader's
    // `list` (CL kk keys there), once every CTA of the cluster runs
    cluster_wait();
    select_top<E>(cand, M, kk, xb,
                     cl.map_shared_rank(list, 0u) + rank * kk);
    cl.sync();                            // every list in the leader's
    if (rank == 0) {
      // the bound: the largest kk-th key of a list; where one list alone
      // reaches it (M2 = kk), that list is the answer
      u64 g8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int g = 8 * t + j;
        g8[j] = g < CL * kk ? list[g] : 0ull;
        if (g < CL * kk && g % kk == kk - 1) s_bound[g / kk] = g8[j];
      }
      __syncthreads();
      u64 thr2 = s_bound[0];
      int best = 0;
#pragma unroll
      for (int c = 1; c < CL; ++c)
        if (s_bound[c] > thr2) {
          thr2 = s_bound[c];
          best = c;
        }
      const int M2 = compact<8>(g8, thr2, cand, s_sum);
      if (M2 == kk) {
        if (t == 0) s_fin = best * kk;
      } else {
        select_top<8>(cand, M2, kk, xb, list);
      }
    }
  } else {
    int par = 0;
    cta_top<E>(v, kk, xb, par);
    const bool whole = kk == N;            // a CTA holds one list alone
    const int F = whole ? 2 : (N / kk < CL ? N / kk : CL);
    if (base < kk) {
#pragma unroll
      for (int j = 0; j < E; ++j) list[base + j] = v[j];
    }
    cluster_wait();
    cl.sync();                            // every list written
    for (int span = 1; span < CL; span *= F) {
      if (rank % (span * F) == 0) {
        // thread t's keys lie in run c at places p0 .. p0 + E - 1
        const int c = whole ? 1 : base / kk, p0 = base % kk;
        const int from = rank + span * c;
        if (c > 0 && c < F && base < (whole ? kk : F * kk)) {
          const bool up = whole || (c & 1);   // the run read mirrored
          const u64* p = from < CL
                             ? cl.map_shared_rank(list, (unsigned)from)
                             : nullptr;
#pragma unroll
          for (int j = 0; j < E; ++j) {
            const u64 w = p ? p[up ? kk - 1 - (p0 + j) : p0 + j] : 0ull;
            v[j] = whole ? (v[j] > w ? v[j] : w) : w;
          }
        }
        if (whole) {
          for (int h = kk >> 1; h > 0; h >>= 1)
            net_stage<E, false>(v, h, N, xb, par);
        } else {
          net_reduce<E>(v, kk, F * kk, xb, par);
        }
        // no CTA reads a receiver's list in its own level
        if (base < kk && (span * F < CL || rank == 0)) {
#pragma unroll
          for (int j = 0; j < E; ++j) list[base + j] = v[j];
        }
      }
      if (span * F < CL) cl.sync();       // the level's reads and lists done
    }
  }
  cluster_arrive();                       // my reads of the others are done
  if (rank == 0) {
    __syncthreads();
    const u64* fin = list + s_fin;
    for (int i = t; i < kk; i += T) {
      const u64 key = fin[i];
      int32_t s = key_score(key);
      int32_t d = docid_of((int)key_place(key));
      if (init && s <= SMALL) {
        s = SMALL;
        d = -1;
      }
      o[i] = s;
      o[kk + i] = d;
    }
    int32_t theta = key_score(fin[kk - 1]);
    if (init && theta < SMALL) theta = SMALL;
    bool ok = true;
#pragma unroll
    for (int q = 0; q < 2; ++q)
      ok = ok && (1 + t + q * T >= tcount || tail_ok(pm[q], shift, lang,
                                                     theta));
    for (int j = 1 + t + 2 * T; j < tcount; j += T)
      ok = ok && tail_ok(pmax[(int64_t)tstart + j], shift, lang, theta);
    ok = __syncthreads_and(ok);
    if (t == 0) o[2 * kk] = ok ? 1 : 0;
  }
  cluster_wait();                         // no CTA leaves while read
}

// The block's constants of slot `slot` (threads 0-43 take part; the
// caller syncs before and after, then load_consts).
template <class D>
__device__ __forceinline__ void slot_consts(const D& q, int slot,
                                            const int32_t* consts,
                                            int32_t* s_st, ScoreConsts& k,
                                            int t, bool fill_stats) {
  if (fill_stats) {
    if (t < NF) {
      s_st[S_COL_MIN + t] = q.cmin[slot][t];
      s_st[S_COL_MAX + t] = q.cmax[slot][t];
    }
    if (t == 0) {
      s_st[S_TF_MIN] = q.tmin[slot];
      s_st[S_TF_MAX] = q.tmax[slot];
      s_st[S_HOST_MAX] = 0;
      s_st[S_NAN] = 0;
    }
  } else {
    fill_consts(k, s_st, consts, t);
  }
}

// The dynamic shared memory of a CTA of n keys: the region that the rows'
// stages and then the exchange buffer (two of n keys) and the candidates
// (n keys) take (`front` bytes, at least those), then the CTA's list of
// `keys` keys (pt_list).
__host__ __device__ constexpr int64_t pt_smem(int64_t front, int n,
                                              int keys) {
  return ((front > 24LL * n ? front : 24LL * n) + 15) / 16 * 16 + 8LL * keys;
}

// The keys of a CTA's list: up to PRE_KK the leader's holds all CL
// CTAs' lists
__host__ __device__ constexpr int pt_list(int cl, int kk) {
  return kk <= PRE_KK ? cl * kk : kk;
}

// K5's stages: a CTA's TILE / CL rows in chunks of CH
__host__ __device__ constexpr int64_t k5_front(int cl) {
  return (int64_t)TILE / cl / CH * stage_bytes<int16_t>();
}

// K5: one cluster of CL CTAs a slot; CTA `rank` takes the tile's rows
// [rank * TILE / CL, + TILE / CL), warp w staging its NCHK chunks of CH
// rows from chunk (rank * T / 32 + w) * NCHK, all by cp.async at once.
template <int CL>
__global__ void __launch_bounds__(PT_THREADS, 2)
tile_topk(const int16_t* __restrict__ feats, const int32_t* __restrict__ flags,
          const int32_t* __restrict__ docids, const uint8_t* __restrict__ dead,
          int64_t doc_cap, const __grid_constant__ Desc q,
          const int32_t* __restrict__ consts,
          const int32_t* __restrict__ pmax, int kk, int init,
          int32_t* __restrict__ out) {
  constexpr int T = PT_THREADS;
  constexpr int E = TILE / CL / T;             // keys a thread
  constexpr int NCHK = E / 2;                  // chunks a warp stages
  constexpr int SB = stage_bytes<int16_t>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ScoreConsts k;
  __shared__ int32_t s_st[STATS_LEN];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int slot = blockIdx.x / CL, rank = blockIdx.x % CL;
  const int32_t start = q.start[slot], count = q.count[slot];
  const int16_t* f0 = feats + (int64_t)start * NF;
  const int32_t* fl0 = flags + start;
  const int32_t* d0 = docids + start;
  const int c0 = (rank * (T / 32) + warp) * NCHK;
  unsigned char* mine = smem + warp * NCHK * SB;
#pragma unroll
  for (int u = 0; u < NCHK; ++u) {
    // features, flags and docids where Stage reads them, by cp.async
    // alone (the arena's arrays start on 16 bytes)
    const int64_t r0 = (int64_t)(c0 + u) * CH, r1 = r0 + CH;
    unsigned char* st = mine + u * SB;
    copy_span_async(st, (uintptr_t)(f0 + r0 * NF), (uintptr_t)(f0 + r1 * NF),
                    lane);
    st += feat_region<int16_t>();
    copy_span_async(st, (uintptr_t)(fl0 + r0), (uintptr_t)(fl0 + r1), lane);
    copy_span_async(st + WORD_REGION, (uintptr_t)(d0 + r0),
                    (uintptr_t)(d0 + r1), lane);
  }
  cp_async_commit();
  slot_consts(q, slot, consts, s_st, k, t, true);
  __syncthreads();
  slot_consts(q, slot, consts, s_st, k, t, false);
  __syncthreads();
  RegConsts rk;
  load_consts(k, rk);
  cp_async_wait<0>();
  __syncthreads();                        // rows other warps staged
  // thread t scores the CTA's rows t, t + T, ..: the best rows (the arena
  // holds a span proxy-sorted) fall to different threads
  const int row0 = rank * E * T;
  u64 v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int r = j * T + t, x = r % CH;
    const Stage<int16_t> sg(smem + (r / CH) * SB, f0, fl0, d0, nullptr);
    const bool live =
        row0 + r < count && row_live(sg.host(x), dead, doc_cap);
    const int32_t s =
        score_row<int16_t, true>(sg.row(x), sg.flag(x), rk, false, 0);
    v[j] = row_key(live ? s : SMALL, row0 + r);
  }
  __syncthreads();                        // the stages become the buffer
  u64* list = (u64*)(smem + pt_smem(k5_front(CL), E * T, 0));
  cluster_topk<CL, E>(v, (u64*)smem, (u64*)smem + 2 * E * T, list, kk,
                      init, q.shift, q.lang, q.tstart[slot], q.tcount[slot],
                      pmax, out + (int64_t)slot * (2 * kk + 1),
                      [&](int row) { return d0[row]; });
}

// K5bp: as K5, CTA `rank` taking the packed tiles rank * STEPS, .. of
// the slot's first TILE rows (two rows a thread a tile), all staged at
// once (bp_issue_tile into its own stage each, `front` bytes in all), then
// each tile's docids and their tombstone loads (bp_head), then the scores
// (bp_score_pair).
template <int CL>
__global__ void __launch_bounds__(PT_THREADS, 2)
tile_topk_bp(const uint32_t* __restrict__ words, int64_t nw,
             const uint8_t* __restrict__ dead, int64_t doc_cap,
             const __grid_constant__ BpDesc q,
             const int32_t* __restrict__ consts,
             const int32_t* __restrict__ pmax, int kk, int64_t front,
             int32_t* __restrict__ out) {
  constexpr int E = TILE / CL / PT_THREADS;
  constexpr int STEPS = E / 2;                 // tiles a CTA
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ BpPlan P;
  __shared__ BpTabs tb;
  __shared__ ScoreConsts sk;
  __shared__ int32_t s_st[STATS_LEN];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int slot = blockIdx.x / CL, rank = blockIdx.x % CL;
  const int32_t count = q.count[slot];
  if (warp == 0)
    bp_plan_warp(words, nw, q.start[slot], q.meta[slot],
                 count < TILE ? count : TILE, BP_SCORED, P, lane);
  slot_consts(q, slot, consts, s_st, sk, t, true);
  __syncthreads();
  const int64_t sb = (int64_t)P.stage_words * 4;
#pragma unroll
  for (int u = 0; u < STEPS; ++u)
    if (rank * STEPS + u < P.tiles)
      bp_issue_tile(P, rank * STEPS + u, smem + u * sb, warp, lane);
  cp_async_commit();
  bp_tables(P, tb, t);
  slot_consts(q, slot, consts, s_st, sk, t, false);
  __syncthreads();
  RegConsts rk;
  load_consts(sk, rk);
  const Filter none = {NO_LANG, NO_FLAG, DAYS_NONE_LO, DAYS_NONE_HI,
                       nullptr, 0};
  cp_async_wait<0>();
  __syncthreads();
  BpGone gone[STEPS];
#pragma unroll
  for (int u = 0; u < STEPS; ++u)
    if (rank * STEPS + u < P.tiles)
      gone[u] = bp_head(P, tb, rank * STEPS + u,
                        (const uint32_t*)(smem + u * sb), dead, doc_cap,
                        lane, warp);
  u64 v[E];
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const int tile = rank * STEPS + u;
    const int p = tile * BP_TILE + 32 * warp + lane;
    int32_t sc[2] = {SMALL, SMALL};
    bool ok[2] = {false, false};
    if (tile < P.tiles)
      bp_score_pair((const uint32_t*)(smem + u * sb), P, tb, gone[u], none,
                    true, rk, lane, warp, sc, ok);
    v[2 * u] = row_key(ok[0] ? sc[0] : SMALL, p);
    v[2 * u + 1] = row_key(ok[1] ? sc[1] : SMALL, p + BP_HALF);
  }
  __syncthreads();                        // the stages become the buffer
  u64* list = (u64*)(smem + pt_smem(front, E * PT_THREADS, 0));
  const int32_t* meta = P.m.v;
  const int64_t wbase = q.start[slot];
  cluster_topk<CL, E>(
      v, (u64*)smem, (u64*)smem + 2 * E * PT_THREADS, list, kk, 0, q.shift,
      q.lang, q.tstart[slot], q.tcount[slot], pmax,
      out + (int64_t)slot * (2 * kk + 1),
      [&](int row) {
        return unpack_col(words, nw, wbase, meta, C_DOCIDS, row);
      });
}

// One block: the kk winners of kernel 3 (index mode) over a K7 buffer,
// mapped back to docids (the extents', then the delta's), with the init
// entries' rule; then either ok of the tail [j0, tcount) (stats null) or
// the scan's statistics [0, 36).
__global__ void __launch_bounds__(SEL_THREADS)
topk_finish(const int32_t* __restrict__ top_s,
            const int32_t* __restrict__ top_rows, int kk, const Extents x,
            const int32_t* __restrict__ pmax, int64_t tstart, int64_t j0,
            int64_t tcount, int32_t bound_shift, int32_t lang_term,
            const int32_t* __restrict__ stats, int32_t* __restrict__ out) {
  const int t = threadIdx.x;
  for (int i = t; i < kk; i += SEL_THREADS) {
    int32_t s = top_s[i];
    int32_t d = docid_at(x, top_rows[i]);
    if (s <= SMALL) {
      s = SMALL;
      d = -1;
    }
    out[i] = s;
    out[kk + i] = d;
  }
  if (stats) {
    if (t < 2 * NF + 2) out[2 * kk + t] = stats[t];
    return;
  }
  int32_t theta = top_s[kk - 1];
  if (theta < SMALL) theta = SMALL;
  bool ok = true;
  for (int64_t j = j0 + t; j < tcount; j += SEL_THREADS)
    ok = ok && tail_ok(pmax[tstart + j], bound_shift, lang_term, theta);
  ok = __syncthreads_and(ok);
  if (t == 0) out[2 * kk] = ok ? 1 : 0;
}

// The finish of the packed exact scan (and of K5bp's kk > 2048 form):
// kernel 3's kk winners over a K7bp buffer of one packed span of
// `count` rows, the docid of each decoded from the block (rows past the
// count, or scores at or below -(2^31-1), give (-(2^31-1), -1)); then
// nothing (tstart < 0: the scan, [2kk]) or the ok of the tail [1,
// tcount) against theta = max(kk-th score, -(2^31-1)) ([2kk + 1]).
__global__ void __launch_bounds__(SEL_THREADS)
topk_finish_bp(const int32_t* __restrict__ top_s,
               const int32_t* __restrict__ top_rows, int kk,
               const uint32_t* __restrict__ words, int64_t nw, int64_t wbase,
               const PackMeta m, int64_t count,
               const int32_t* __restrict__ pmax, int64_t tstart,
               int64_t tcount, int32_t bound_shift, int32_t lang_term,
               int32_t* __restrict__ out) {
  __shared__ int32_t s_meta[META_LEN];
  const int t = threadIdx.x;
  if (t < META_LEN) s_meta[t] = m.v[t];
  __syncthreads();
  for (int i = t; i < kk; i += SEL_THREADS) {
    int32_t s = top_s[i];
    const int64_t r = top_rows[i];
    int32_t d = -1;
    if (s <= SMALL || r < 0 || r >= count)
      s = SMALL;
    else
      d = unpack_col(words, nw, wbase, s_meta, C_DOCIDS, r);
    out[i] = s;
    out[kk + i] = d;
  }
  if (tstart < 0) return;
  int32_t theta = top_s[kk - 1];
  if (theta < SMALL) theta = SMALL;
  bool ok = true;
  for (int64_t j = 1 + t; j < tcount; j += SEL_THREADS)
    ok = ok && tail_ok(pmax[tstart + j], bound_shift, lang_term, theta);
  ok = __syncthreads_and(ok);
  if (t == 0) out[2 * kk] = ok ? 1 : 0;
}

// One block a slot of a wave of batched scans: slot s's kk winners
// (top_s / top_rows [bs, kk]) mapped back to docids over its extents,
// (-(2^31-1), -1) at or below -(2^31-1); out [bs, 2kk]: scores, docids.
__global__ void __launch_bounds__(SEL_THREADS)
topk_finish_batch(const int32_t* __restrict__ top_s,
                  const int32_t* __restrict__ top_rows, int kk,
                  const int16_t* __restrict__ feats,
                  const int32_t* __restrict__ flags,
                  const int32_t* __restrict__ docids, const ScanBatch b,
                  int32_t* __restrict__ out) {
  __shared__ Extents x;
  __shared__ Filter q;
  if (threadIdx.x == 0) slot_extents(b, blockIdx.x, feats, flags, docids, x, q);
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kk;
  int32_t* o = out + 2 * base;
  for (int i = threadIdx.x; i < kk; i += SEL_THREADS) {
    int32_t s = top_s[base + i];
    int32_t d = docid_at(x, top_rows[base + i]);
    if (s <= SMALL) {
      s = SMALL;
      d = -1;
    }
    o[i] = s;
    o[kk + i] = d;
  }
}

}  // namespace yt

using namespace yt;

// yt_pruned_tile_cluster's choice a kernel (bp) and device: PT_CLUSTER
// where cudaOccupancyMaxActiveClusters finds room for one such cluster at
// the kernel's largest shared memory, else 8; and that room.
static int cluster_size[2][64], cluster_room[2][64];

template <int CL>
static cudaError_t pt_prepare(const void* kernel, int64_t most, int* room) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (e != cudaSuccess) return e;
  if (CL > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(CL * SLOTS));
  cfg.blockDim = dim3(PT_THREADS);
  cfg.dynamicSmemBytes = (size_t)most;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(room, kernel, &cfg);
}

// The dynamic shared memory a CTA of K5 (bp 0) or K5bp (bp 1) may take
// at most: K5's stages and kk = MAX_KK's list; for K5bp the most the
// device allows a block beside the kernel's static shared memory.
template <int CL>
static cudaError_t pt_most(int bp, const void* kernel, int64_t* most) {
  if (!bp) {
    const int keys = pt_list(CL, PRE_KK) > MAX_KK ? pt_list(CL, PRE_KK)
                                                  : MAX_KK;
    *most = pt_smem(k5_front(CL), TILE / CL, keys);
    return cudaSuccess;
  }
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  *most = optin - (int64_t)fa.sharedSizeBytes;
  return cudaSuccess;
}

template <int CL>
static const void* pt_kernel(int bp) {
  return bp ? (const void*)tile_topk_bp<CL>
            : (const void*)tile_topk<CL>;
}

// The cluster size of K5 (bp 0) or K5bp (bp 1) on the current device:
// want -1 reads it (chosen at the first call), 0 chooses it again, 8 or
// 16 sets it; out[0] the size, out[1] how many such clusters the card
// holds at once.
extern "C" int yt_pruned_tile_cluster(int bp, int want, int32_t* out) {
  if ((bp != 0 && bp != 1) ||
      (want != -1 && want != 0 && want != 8 && want != PT_CLUSTER))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  int& size = cluster_size[bp][dev];
  int& room = cluster_room[bp][dev];
  if (want >= 0 || !size) {
    int64_t most = 0;
    int big = 0, small = 0;
    if (want != 8) {
      const void* k = pt_kernel<PT_CLUSTER>(bp);
      e = pt_most<PT_CLUSTER>(bp, k, &most);
      if (e == cudaSuccess)
        e = pt_prepare<PT_CLUSTER>(k, most, &big);
      if (e != cudaSuccess && want == PT_CLUSTER) return (int)e;
      cudaGetLastError();   // a size the card refuses is an answer
    }
    if (want == PT_CLUSTER || (want != 8 && big > 0)) {
      if (big < 1) return (int)cudaErrorInvalidConfiguration;
      size = PT_CLUSTER;
      room = big;
    } else {
      const void* k = pt_kernel<8>(bp);
      e = pt_most<8>(bp, k, &most);
      if (e == cudaSuccess)
        e = pt_prepare<8>(k, most, &small);
      if (e != cudaSuccess) return (int)e;
      if (small < 1) return (int)cudaErrorInvalidConfiguration;
      size = 8;
      room = small;
    }
  }
  if (out) {
    out[0] = size;
    out[1] = room;
  }
  return (int)cudaSuccess;
}

// One cluster launch of n slots.
template <class K, class... Args>
static cudaError_t launch_clusters(K kernel, int cl, int n, int64_t smem,
                                   cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(cl * n));
  cfg.blockDim = dim3(PT_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

static bool kk_ok(int bs, int kk) {
  return bs >= 1 && kk >= 16 && kk <= MAX_KK && !(kk & (kk - 1));
}

template <int CL>
static cudaError_t k5_launches(const void* feats, const void* flags,
                               const void* docids, const void* dead,
                               int64_t doc_cap, const void* pmax,
                               const int32_t* desc, int bs, int kk, int init,
                               const void* consts, void* out,
                               cudaStream_t s) {
  const int64_t smem = pt_smem(k5_front(CL), TILE / CL, pt_list(CL, kk));
  for (int first = 0; first < bs; first += SLOTS) {
    const int n = bs - first < SLOTS ? bs - first : SLOTS;
    const cudaError_t e = launch_clusters(
        tile_topk<CL>, CL, n, smem, s,
        (const int16_t*)feats, (const int32_t*)flags, (const int32_t*)docids,
        (const uint8_t*)dead, doc_cap, desc_of(desc, bs, first, n),
        (const int32_t*)consts, (const int32_t*)pmax, kk, init,
        (int32_t*)out + (int64_t)first * (2 * kk + 1));
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// K5: feats [cap, 17] int16, flags/docids [cap] int32 (every slot's
// start + TILE <= cap: the arena's spare tile), dead [doc_cap] bool,
// pmax int32, desc the fused descriptor of bs slots in HOST memory
// (copied into the launches' parameters), consts int32[44]; out [bs,
// 2kk + 1] int32; kk a power of two in [16, 2048]. One launch of up to
// SLOTS slots.
extern "C" int yt_pruned_tile(const void* feats, const void* flags,
                              const void* docids, const void* dead,
                              int64_t doc_cap, const void* pmax,
                              const void* desc, int bs, int kk, int init,
                              const void* consts, void* out, void* stream) {
  if (!kk_ok(bs, kk)) return (int)cudaErrorInvalidValue;
  int32_t cl[2];
  cudaError_t e = (cudaError_t)yt_pruned_tile_cluster(0, -1, cl);
  if (e != cudaSuccess) return (int)e;
  const int32_t* q = (const int32_t*)desc;
  cudaStream_t s = (cudaStream_t)stream;
  e = cl[0] == PT_CLUSTER
          ? k5_launches<PT_CLUSTER>(feats, flags, docids, dead, doc_cap, pmax,
                                    q, bs, kk, init, consts, out, s)
          : k5_launches<8>(feats, flags, docids, dead, doc_cap, pmax, q, bs,
                           kk, init, consts, out, s);
  return (int)e;
}

template <int CL>
static cudaError_t k5bp_launches(const void* words, int64_t nw,
                                 const void* dead, int64_t doc_cap,
                                 const void* pmax, const int32_t* desc,
                                 int bs, int kk, const void* consts,
                                 void* out, cudaStream_t s) {
  constexpr int E = TILE / CL / PT_THREADS;
  int64_t most = 0;
  cudaError_t e = pt_most<CL>(1, pt_kernel<CL>(1), &most);
  if (e != cudaSuccess) return e;
  for (int first = 0; first < bs; first += BP_SLOTS) {
    const int n = bs - first < BP_SLOTS ? bs - first : BP_SLOTS;
    const BpDesc q = bp_desc_of(desc, bs, first, n);
    // each slot's block checked, its stages sized (bp_plan_warp builds
    // the same plan on the card)
    int64_t front = 0;
    for (int j = 0; j < n; ++j) {
      BpPlan P;
      const int64_t count = q.count[j] < TILE ? q.count[j] : TILE;
      if (count < 0 || !make_bp_plan(words, nw, q.start[j], q.meta[j], count,
                                     BP_SCORED, &P))
        return cudaErrorInvalidValue;
      const int64_t f = (int64_t)(E / 2) * P.stage_words * 4;
      front = f > front ? f : front;
    }
    const int64_t smem = pt_smem(front, TILE / CL, pt_list(CL, kk));
    if (smem > most) return cudaErrorInvalidConfiguration;
    e = launch_clusters(tile_topk_bp<CL>, CL, n, smem, s,
                        (const uint32_t*)words, nw, (const uint8_t*)dead,
                        doc_cap, q, (const int32_t*)consts,
                        (const int32_t*)pmax, kk, front,
                        (int32_t*)out + (int64_t)first * (2 * kk + 1));
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// K5bp: words [nw] int32 (the packed-words store), dead [doc_cap] bool,
// pmax int32, desc the packed descriptor of bs slots in HOST memory (the
// fused layout with each slot's word base as its start, then
// metas[bs][57]), consts int32[44]; out [bs, 2kk + 1] int32 (scores,
// docids, ok; the batched form: no init entries); kk a power of two in
// [16, 2048]. One launch of up to BP_SLOTS slots.
extern "C" int yt_pruned_tile_bp(const void* words, int64_t nw,
                                 const void* dead, int64_t doc_cap,
                                 const void* pmax, const void* desc, int bs,
                                 int kk, const void* consts, void* out,
                                 void* stream) {
  if (nw < 1 || !kk_ok(bs, kk)) return (int)cudaErrorInvalidValue;
  int32_t cl[2];
  cudaError_t e = (cudaError_t)yt_pruned_tile_cluster(1, -1, cl);
  if (e != cudaSuccess) return (int)e;
  const int32_t* q = (const int32_t*)desc;
  cudaStream_t s = (cudaStream_t)stream;
  e = cl[0] == PT_CLUSTER
          ? k5bp_launches<PT_CLUSTER>(words, nw, dead, doc_cap, pmax, q, bs,
                                      kk, consts, out, s)
          : k5bp_launches<8>(words, nw, dead, doc_cap, pmax, q, bs, kk,
                             consts, out, s);
  return (int)e;
}

// The finish of the b > 1 and scan routes: top_s / top_rows [kk] (kernel
// 3's scores and rows over a K7 buffer of the n_ext arena extents in
// `ext`, host memory, then the delta block's dn rows with docids
// ddocids); stats int32[38] or null; out [2kk + 1] (stats null) or
// [2kk + 36] int32.
extern "C" int yt_topk_finish(const void* top_s, const void* top_rows,
                              int kk, const void* docids, const int64_t* ext,
                              int n_ext, const void* ddocids, int64_t dn,
                              const void* pmax, int64_t tstart, int64_t j0,
                              int64_t tcount, int bound_shift, int lang_term,
                              const void* stats, void* out, void* stream) {
  if (kk < 1 || n_ext < 0 || n_ext > MAX_EXT || dn < 0)
    return (int)cudaErrorInvalidValue;
  // only the docids are read (the feature and flag pointers are not)
  const Extents x = make_extents(docids, nullptr, docids, ext, n_ext,
                                 ddocids, nullptr, ddocids, dn);
  topk_finish<<<1, SEL_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)top_s, (const int32_t*)top_rows, kk, x,
      (const int32_t*)pmax, tstart, j0, tcount, bound_shift, lang_term,
      (const int32_t*)stats, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The finish of a wave of bs <= 16 batched scans (common.cuh
// scan_batch_of, host memory): top_s / top_rows [bs, kk]; docids the
// arena's; out [bs, 2kk] int32.
extern "C" int yt_topk_finish_batch(const void* top_s, const void* top_rows,
                                    int kk, const void* docids,
                                    const int32_t* slots, int bs, void* out,
                                    void* stream) {
  if (kk < 1 || bs < 1 || bs > BATCH_SLOTS) return (int)cudaErrorInvalidValue;
  ScanBatch b{};
  if (!scan_batch_of(slots, bs, &b)) return (int)cudaErrorInvalidValue;
  topk_finish_batch<<<bs, SEL_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)top_s, (const int32_t*)top_rows, kk,
      (const int16_t*)docids, (const int32_t*)docids,
      (const int32_t*)docids, b, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The packed finish: top_s / top_rows [kk] (kernel 3 over a K7bp buffer
// of the packed span of `count` rows at word wbase of words [nw], meta
// the block's 57 int32 in host memory); tstart < 0: out [2kk]; else out
// [2kk + 1] with the tail check over pmax[tstart + 1, tstart + tcount).
extern "C" int yt_topk_finish_bp(const void* top_s, const void* top_rows,
                                 int kk, const void* words, int64_t nw,
                                 int64_t wbase, const int32_t* meta,
                                 int64_t count, const void* pmax,
                                 int64_t tstart, int64_t tcount,
                                 int bound_shift, int lang_term, void* out,
                                 void* stream) {
  if (kk < 1 || nw < 1 || count < 0) return (int)cudaErrorInvalidValue;
  PackMeta m;
  for (int c = 0; c < META_LEN; ++c) m.v[c] = meta[c];
  topk_finish_bp<<<1, SEL_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)top_s, (const int32_t*)top_rows, kk,
      (const uint32_t*)words, nw, wbase, m, count, (const int32_t*)pmax,
      tstart, tcount, bound_shift, lang_term, (int32_t*)out);
  return (int)cudaGetLastError();
}
