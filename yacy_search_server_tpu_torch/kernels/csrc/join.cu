// K8 `join_member`: the membership and merge step of the devstore's
// device conjunction. Replaces the body of index/devstore._join_topk (JAX
// package, devstore.py:639) up to its statistics, which
// _rank_join_batch_kernel / _rank_join_batch_packed_kernel (:736, :1049)
// and _rank_join_bm_batch_kernel / _rank_join_bm_batch_packed_kernel
// (:769, :1068) run at bs = 1 for a solo query: for each row of the rarest
// include term's span, its liveness, its membership in every other
// include term (partner) and in every exclude term, and the merge of the
// partner rows into it (worddistance = max - min of posintext across the
// terms, hitcount = min, flags = OR), then the constraint filter on the
// merged row. Kernels 1-3 and topk_finish take the merged block from
// there, as _join_topk's local_stats, cardinal_from_stats and top_k did.
//
// Membership of the row's docid d in a partner segment (the partner's
// docids, sorted, with the arena row each lives at: jdocids/jpos from
// jstart, jcount entries) comes in two modes, per partner:
//   - bitmap (slot >= 0): the term's docid bitmap row bmtab[slot] of
//     nwords (word bits, rank prefix) pairs: found iff 0 <= d < 32 nwords
//     and the bit of clip(d) is set; its rank (prefix + popcount of the
//     bits below) is its place in the segment, and the partner row is
//     jpos[clip(jstart + rank)] (_membership_bitmap :609, _popc32 :601);
//   - sort (slot -1): found iff clip(d, 0, 2^29) occurs in the segment;
//     the partner row is jpos at that entry. The reference sorts the
//     rare docids against the segment (_membership_sorted :558) because a
//     random gather is the TPU's slow path; here each lane binary-searches
//     the sorted segment instead, ~log2(jcount) loads from the L2 for a
//     partner of a few hundred thousand entries. The clip is kept: a
//     docid at or above 2^29 matches a partner docid of exactly 2^29, as
//     in the reference. The reference's sort (stable, its rare rows
//     before the segment, the tag in the key's low bit) puts only the
//     last of the still-valid rare rows of one clipped key next to the
//     partner's entry, so of two or more such rows only the last in row
//     order matches. A span never holds a docid twice (runs are built by
//     postings.sort_dedupe), so only the clip makes keys equal: the rows
//     at or above 2^29. `join_rows` counts them; where there are two or
//     more and a partner is in sort mode, `join_high` (one block, after
//     it) redoes those rows with the reference's rule, partner by
//     partner: the last still-valid one (the largest row) alone can
//     match the partner's 2^29. Below two it returns at once.
// A row that is not live, or has missed a partner or hit an exclude, is
// invalid and is tested against no later term, so a row invalid before a
// partner never matches it (the reference masks those rows the same
// way). The merged columns of an invalid row hold what the merge had
// reached when the row fell out; the statistics and scores read valid
// rows only.
//
// Bound: bytes. A row reads its 34 B of features, its flags and docid
// and the tombstone byte the docid hits, and writes 68 B of merged int32
// features, 4 B of flags and a valid byte; each partner lookup of a row
// still valid gathers the bitmap pair or the searched entry and its arena
// row (8 B), and for an include the partner's posintext, hitcount (2 B
// each) and flags (4 B). The design keeps every access but the gathers
// coalesced: a block of 128 threads stages its 128 rows' features into
// shared memory with 2-byte loads of consecutive addresses, one thread a
// row merges, and the block writes the merged rows back through shared
// memory as consecutive words.
#include "common.cuh"

namespace yt {

constexpr int J_THREADS = 128;          // rows a block stages and merges
constexpr int H_THREADS = 1024;         // join_high's one block
constexpr int MAX_PARTS = 11;           // 5 include partners + 6 excludes
constexpr int32_t JOIN_DOCID_CAP = 1 << 29;

// The partners of one query: includes [0, n_inc), then excludes
struct JoinParts {
  int64_t jstart[MAX_PARTS], jcount[MAX_PARTS];
  int32_t slot[MAX_PARTS];
  int n_inc, n_exc;
};

// Membership of docid d in partner p: the partner's arena row, or -1.
__device__ __forceinline__ int64_t member(const JoinParts& a, int p,
                                          int32_t d,
                                          const int32_t* __restrict__ jdocids,
                                          const int32_t* __restrict__ jpos,
                                          int64_t jcap,
                                          const int32_t* __restrict__ bmtab,
                                          int64_t nwords) {
  if (a.slot[p] >= 0) {
    const int64_t nbits = nwords * 32;
    const int64_t t = d < 0 ? 0 : (d >= nbits ? nbits - 1 : d);
    const int2 wp = __ldg(reinterpret_cast<const int2*>(bmtab) +
                          (int64_t)a.slot[p] * nwords + (t >> 5));
    const uint32_t w = (uint32_t)wp.x;
    const uint32_t sh = (uint32_t)(t & 31);
    if (d < 0 || d >= nbits || !((w >> sh) & 1u)) return -1;
    int64_t q = a.jstart[p] + wp.y + __popc(w & ((1u << sh) - 1u));
    q = q < 0 ? 0 : (q >= jcap ? jcap - 1 : q);
    return __ldg(jpos + q);
  }
  const int32_t key = d < 0 ? 0 : (d > JOIN_DOCID_CAP ? JOIN_DOCID_CAP : d);
  int64_t lo = a.jstart[p], hi = a.jstart[p] + a.jcount[p];
  while (lo < hi) {  // the first entry >= key
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(jdocids + mid) < key) lo = mid + 1;
    else hi = mid;
  }
  if (lo >= a.jstart[p] + a.jcount[p] || __ldg(jdocids + lo) != key)
    return -1;
  return __ldg(jpos + lo);
}

// The rows of one query's rare window taken by block `block` of the
// `blocks` that share it (a grid stride), staged through s_in / s_out.
__device__ __forceinline__ void join_rows_body(
    const int16_t* __restrict__ feats, const int32_t* __restrict__ flags,
    const int32_t* __restrict__ docids, const uint8_t* __restrict__ dead,
    int64_t doc_cap, int64_t start, int64_t count,
    const int32_t* __restrict__ jdocids, const int32_t* __restrict__ jpos,
    int64_t jcap, const int32_t* __restrict__ bmtab, int64_t nwords,
    const JoinParts& a, const Filter& q, int32_t* __restrict__ merged,
    int32_t* __restrict__ flags_out, uint8_t* __restrict__ valid_out,
    uint32_t* __restrict__ nhigh, int16_t* s_in, int32_t* s_out, int block,
    int blocks) {
  const int t = threadIdx.x;
  const bool off = filter_off(q);
  for (int64_t r0 = (int64_t)block * J_THREADS; r0 < count;
       r0 += (int64_t)blocks * J_THREADS) {
    const int rows = count - r0 < J_THREADS ? (int)(count - r0) : J_THREADS;
    const int16_t* src = feats + (start + r0) * NF;
    for (int i = t; i < rows * NF; i += J_THREADS) s_in[i] = src[i];
    __syncthreads();
    if (t < rows) {
      const int64_t r = start + r0 + t;
      const int32_t d = __ldg(docids + r);
      if (nhigh && d >= JOIN_DOCID_CAP) atomicAdd(nhigh, 1u);
      const int16_t* f = s_in + t * NF;
      int32_t fo = __ldg(flags + r);
      int32_t pmin = f[F_POSINTEXT], pmax = pmin, hmin = f[F_HITCOUNT];
      bool v = row_live(d, dead, doc_cap);
      for (int p = 0; p < a.n_inc && v; ++p) {
        const int64_t pr =
            member(a, p, d, jdocids, jpos, jcap, bmtab, nwords);
        v = pr >= 0;
        if (v) {
          const int32_t pp = __ldg(feats + pr * NF + F_POSINTEXT);
          pmin = min(pmin, pp);
          pmax = max(pmax, pp);
          hmin = min(hmin, (int32_t)__ldg(feats + pr * NF + F_HITCOUNT));
          fo |= __ldg(flags + pr);
        }
      }
      for (int e = a.n_inc; e < a.n_inc + a.n_exc && v; ++e)
        v = member(a, e, d, jdocids, jpos, jcap, bmtab, nwords) < 0;
      int32_t* o = s_out + t * NF;
#pragma unroll
      for (int c = 0; c < NF; ++c) o[c] = f[c];
      o[F_WORDDISTANCE] = pmax - pmin;
      o[F_HITCOUNT] = hmin;
      v = v && (off || constraint_ok(f[F_LANGUAGE], f[F_LASTMOD], fo, q));
      flags_out[r0 + t] = fo;
      valid_out[r0 + t] = v ? 1 : 0;
    }
    __syncthreads();
    int32_t* dst = merged + r0 * NF;
    for (int i = t; i < rows * NF; i += J_THREADS) dst[i] = s_out[i];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(J_THREADS)
join_rows(const int16_t* __restrict__ feats,
          const int32_t* __restrict__ flags,
          const int32_t* __restrict__ docids,
          const uint8_t* __restrict__ dead, int64_t doc_cap, int64_t start,
          int64_t count, const int32_t* __restrict__ jdocids,
          const int32_t* __restrict__ jpos, int64_t jcap,
          const int32_t* __restrict__ bmtab, int64_t nwords,
          const JoinParts a, const Filter q, int32_t* __restrict__ merged,
          int32_t* __restrict__ flags_out, uint8_t* __restrict__ valid_out,
          uint32_t* __restrict__ nhigh) {
  __shared__ int16_t s_in[J_THREADS * NF];
  __shared__ int32_t s_out[J_THREADS * NF];
  join_rows_body(feats, flags, docids, dead, doc_cap, start, count, jdocids,
                 jpos, jcap, bmtab, nwords, a, q, merged, flags_out,
                 valid_out, nhigh, s_in, s_out, blockIdx.x, gridDim.x);
}

// The rows of the rare window whose docid is at or above 2^29, redone
// with the reference's last-match rule (head note) where there are two or
// more. The state of such a row lives in the outputs while the partners
// are walked: valid_out (still valid), flags_out (the OR), and in its
// merged row the posintext minimum (worddistance column), maximum
// (posintext column) and hitcount minimum; the rows are written in final
// form at the end. A sort-mode partner matches only the largest
// still-valid such row, and only where its segment holds 2^29; a bitmap
// partner tests each row's own docid, as join_rows does.
__device__ __forceinline__ void join_high_body(
    const int16_t* __restrict__ feats, const int32_t* __restrict__ flags,
    const int32_t* __restrict__ docids, const uint8_t* __restrict__ dead,
    int64_t doc_cap, int64_t start, int64_t count,
    const int32_t* __restrict__ jdocids, const int32_t* __restrict__ jpos,
    int64_t jcap, const int32_t* __restrict__ bmtab, int64_t nwords,
    const JoinParts& a, const Filter& q, int32_t* __restrict__ merged,
    int32_t* __restrict__ flags_out, uint8_t* __restrict__ valid_out,
    const uint32_t* __restrict__ nhigh, unsigned long long& s_last) {
  if (__ldcg(nhigh) < 2u) return;
  const int t = threadIdx.x;
  for (int64_t r = t; r < count; r += H_THREADS) {
    const int32_t d = docids[start + r];
    if (d < JOIN_DOCID_CAP) continue;
    const int16_t* f = feats + (start + r) * NF;
    int32_t* m = merged + r * NF;
    m[F_WORDDISTANCE] = f[F_POSINTEXT];
    m[F_POSINTEXT] = f[F_POSINTEXT];
    m[F_HITCOUNT] = f[F_HITCOUNT];
    flags_out[r] = flags[start + r];
    valid_out[r] = row_live(d, dead, doc_cap) ? 1 : 0;
  }
  __syncthreads();
  for (int p = 0; p < a.n_inc + a.n_exc; ++p) {
    const bool sorted = a.slot[p] < 0;
    unsigned long long last = 0;  // the largest still-valid row, plus one
    int64_t prow_cap = -1;        // the partner's row of docid 2^29
    if (sorted) {
      if (t == 0) s_last = 0ull;
      __syncthreads();
      unsigned long long mine = 0;
      for (int64_t r = t; r < count; r += H_THREADS)
        if (docids[start + r] >= JOIN_DOCID_CAP && valid_out[r])
          mine = (unsigned long long)r + 1ull;
      if (mine) atomicMax(&s_last, mine);
      __syncthreads();
      last = s_last;
      if (last)
        prow_cap = member(a, p, JOIN_DOCID_CAP, jdocids, jpos, jcap, bmtab,
                          nwords);
    }
    for (int64_t r = t; r < count; r += H_THREADS) {
      const int32_t d = docids[start + r];
      if (d < JOIN_DOCID_CAP || !valid_out[r]) continue;
      const int64_t pr =
          sorted ? ((unsigned long long)r + 1ull == last ? prow_cap : -1)
                 : member(a, p, d, jdocids, jpos, jcap, bmtab, nwords);
      if (p >= a.n_inc) {
        if (pr >= 0) valid_out[r] = 0;
      } else if (pr < 0) {
        valid_out[r] = 0;
      } else {
        int32_t* m = merged + r * NF;
        const int32_t pp = feats[pr * NF + F_POSINTEXT];
        m[F_WORDDISTANCE] = min(m[F_WORDDISTANCE], pp);
        m[F_POSINTEXT] = max(m[F_POSINTEXT], pp);
        m[F_HITCOUNT] = min(m[F_HITCOUNT], (int32_t)feats[pr * NF + F_HITCOUNT]);
        flags_out[r] |= flags[pr];
      }
    }
    __syncthreads();
  }
  const bool off = filter_off(q);
  for (int64_t r = t; r < count; r += H_THREADS) {
    if (docids[start + r] < JOIN_DOCID_CAP) continue;
    const int16_t* f = feats + (start + r) * NF;
    int32_t* m = merged + r * NF;
    const int32_t pmin = m[F_WORDDISTANCE], pmax = m[F_POSINTEXT];
    const int32_t hmin = m[F_HITCOUNT];
    for (int c = 0; c < NF; ++c) m[c] = f[c];
    m[F_WORDDISTANCE] = pmax - pmin;
    m[F_HITCOUNT] = hmin;
    valid_out[r] = valid_out[r] &&
                   (off || constraint_ok(f[F_LANGUAGE], f[F_LASTMOD],
                                         flags_out[r], q));
  }
}

__global__ void __launch_bounds__(H_THREADS)
join_high(const int16_t* __restrict__ feats,
          const int32_t* __restrict__ flags,
          const int32_t* __restrict__ docids,
          const uint8_t* __restrict__ dead, int64_t doc_cap, int64_t start,
          int64_t count, const int32_t* __restrict__ jdocids,
          const int32_t* __restrict__ jpos, int64_t jcap,
          const int32_t* __restrict__ bmtab, int64_t nwords,
          const JoinParts a, const Filter q, int32_t* __restrict__ merged,
          int32_t* __restrict__ flags_out, uint8_t* __restrict__ valid_out,
          const uint32_t* __restrict__ nhigh) {
  __shared__ unsigned long long s_last;
  join_high_body(feats, flags, docids, dead, doc_cap, start, count, jdocids,
                 jpos, jcap, bmtab, nwords, a, q, merged, flags_out,
                 valid_out, nhigh, s_last);
}

// ---------------------------------------------------------------------------
// join_member_batch: K8 with a slot dimension
// ---------------------------------------------------------------------------
// Replaces the membership and merge of _join_topk as
// _rank_join_batch_kernel / _rank_join_bm_batch_kernel (:736, :769) and
// their packed twins (:1049, :1068) vmap it over a wave: each slot its
// own rare span, filter and partner segments (one descriptor row a slot,
// the reference's qargs_batch), its merged rows, flags and valid bytes in
// a region of its own of three wave buffers (rows off[s] on). The grid's
// blocks are cut into one range a slot in proportion to its rows
// (split_blocks), so a wave of one big and several small slots keeps
// every block busy; a block builds its slot's JoinParts and filter in
// shared memory and runs join_rows' body over the slot's window. A
// partner's mode is its slot's own (slot >= 0 a bitmap, -1 a sorted
// segment): in the reference the modes are statics of the wave, which
// the port's group key keeps. The clip rule's count of rows at or above
// 2^29 is a slot's own (nhigh[s]), and join_high's redo runs as one
// block a slot, each for its own rare span and filter: two slots of one
// span under different filters need each their own fix-up.
//
// Bound: bytes, as K8's: the slots' rare rows read and merged rows
// written, summed (68 + 4 + 1 B a row written: a wave of 16 slots of 4M
// rows holds 4.7 GB, sized from the live slots' counts).
constexpr int JOIN_SLOTS = BATCH_SLOTS;
constexpr int QARGS = 6;   // start, count, the filter's 4 int32

// slot s: its rare span's rows [start[s], start[s] + count[s]), its
// filter and partners, its region from off[s] and its blocks
// [bstart[s], bstart[s + 1]). Fields of its own, not a Regions: with one
// nvcc gave join_rows_batch 32 registers in place of 40 and it ran 1.7x
// slower at 16 slots of 4M rows (H100 80GB HBM3, 700 W)
struct JoinWave {
  int32_t start[JOIN_SLOTS], count[JOIN_SLOTS], filt[JOIN_SLOTS][4];
  int32_t jstart[JOIN_SLOTS][MAX_PARTS], jcount[JOIN_SLOTS][MAX_PARTS];
  int32_t jslot[JOIN_SLOTS][MAX_PARTS];
  int64_t off[JOIN_SLOTS + 1];
  int32_t bstart[JOIN_SLOTS + 1];
  int32_t bs, n_inc, n_exc;
};

// Slot s's partners and filter (thread 0 of a block, into shared memory).
__device__ __forceinline__ void slot_parts(const JoinWave& w, int s,
                                           JoinParts& a, Filter& q) {
  a.n_inc = w.n_inc;
  a.n_exc = w.n_exc;
  for (int p = 0; p < w.n_inc + w.n_exc; ++p) {
    a.jstart[p] = w.jstart[s][p];
    a.jcount[p] = w.jcount[s][p];
    a.slot[p] = w.jslot[s][p];
  }
  q = Filter{w.filt[s][0], w.filt[s][1], w.filt[s][2], w.filt[s][3],
             nullptr, 0};
}

__global__ void __launch_bounds__(J_THREADS)
join_rows_batch(const int16_t* __restrict__ feats,
                const int32_t* __restrict__ flags,
                const int32_t* __restrict__ docids,
                const uint8_t* __restrict__ dead, int64_t doc_cap,
                const int32_t* __restrict__ jdocids,
                const int32_t* __restrict__ jpos, int64_t jcap,
                const int32_t* __restrict__ bmtab, int64_t nwords,
                const JoinWave w, int32_t* __restrict__ merged,
                int32_t* __restrict__ flags_out,
                uint8_t* __restrict__ valid_out,
                uint32_t* __restrict__ nhigh) {
  __shared__ int16_t s_in[J_THREADS * NF];
  __shared__ int32_t s_out[J_THREADS * NF];
  __shared__ JoinParts a;
  __shared__ Filter q;
  const int s = range_of_block(w.bstart, w.bs, blockIdx.x);
  if (threadIdx.x == 0) slot_parts(w, s, a, q);
  __syncthreads();
  const int64_t o = w.off[s];
  join_rows_body(feats, flags, docids, dead, doc_cap, w.start[s],
                 w.count[s], jdocids, jpos, jcap, bmtab, nwords, a, q,
                 merged + o * NF, flags_out + o, valid_out + o, nhigh + s,
                 s_in, s_out, blockIdx.x - w.bstart[s],
                 w.bstart[s + 1] - w.bstart[s]);
}

// one block a slot: join_high's redo where the slot has a sort-mode
// membership (elsewhere none is needed, as in the solo K8)
__global__ void __launch_bounds__(H_THREADS)
join_high_batch(const int16_t* __restrict__ feats,
                const int32_t* __restrict__ flags,
                const int32_t* __restrict__ docids,
                const uint8_t* __restrict__ dead, int64_t doc_cap,
                const int32_t* __restrict__ jdocids,
                const int32_t* __restrict__ jpos, int64_t jcap,
                const int32_t* __restrict__ bmtab, int64_t nwords,
                const JoinWave w, int32_t* __restrict__ merged,
                int32_t* __restrict__ flags_out,
                uint8_t* __restrict__ valid_out,
                const uint32_t* __restrict__ nhigh) {
  __shared__ unsigned long long s_last;
  __shared__ JoinParts a;
  __shared__ Filter q;
  const int s = blockIdx.x;
  bool any_sorted = false;
  for (int p = 0; p < w.n_inc + w.n_exc; ++p)
    any_sorted = any_sorted || w.jslot[s][p] < 0;
  if (!any_sorted) return;
  if (threadIdx.x == 0) slot_parts(w, s, a, q);
  __syncthreads();
  const int64_t o = w.off[s];
  join_high_body(feats, flags, docids, dead, doc_cap, w.start[s], w.count[s],
                 jdocids, jpos, jcap, bmtab, nwords, a, q, merged + o * NF,
                 flags_out + o, valid_out + o, nhigh + s, s_last);
}

}  // namespace yt

using namespace yt;

// K8. Arena: feats [cap, 17] int16, flags/docids [cap] int32, dead
// [doc_cap] bool; the rare span's rows [start, start + count). Join
// tables: jdocids/jpos [jcap] int32, bmtab [slots, nwords, 2] int32.
// parts: n_inc + n_exc partners (n_inc <= 5, n_exc <= 6) as int64 triples
// (jstart, jcount, slot) in host memory; filt the filter's 4 int32 in
// host memory. Out: merged [count, 17] int32, flags_out [count] int32,
// valid_out [count] bool. scratch: int32[1], the count of rows at or
// above 2^29 (zeroed here; read only where a partner is in sort mode).
extern "C" int yt_join_member(const void* feats, const void* flags,
                              const void* docids, const void* dead,
                              int64_t doc_cap, int64_t start, int64_t count,
                              const void* jdocids, const void* jpos,
                              int64_t jcap, const void* bmtab, int64_t nwords,
                              const int64_t* parts, int n_inc, int n_exc,
                              const int32_t* filt, void* merged,
                              void* flags_out, void* valid_out, void* scratch,
                              void* stream) {
  if (n_inc < 0 || n_exc < 0 || n_inc > 5 || n_exc > 6 || count < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  JoinParts a = {};
  a.n_inc = n_inc;
  a.n_exc = n_exc;
  bool any_sorted = false;
  for (int p = 0; p < n_inc + n_exc; ++p) {
    a.jstart[p] = parts[3 * p];
    a.jcount[p] = parts[3 * p + 1];
    a.slot[p] = (int32_t)parts[3 * p + 2];
    any_sorted = any_sorted || a.slot[p] < 0;
  }
  const Filter q = make_filter(filt, nullptr, 0);
  if (count == 0) return (int)cudaGetLastError();
  uint32_t* nhigh = any_sorted ? (uint32_t*)scratch : nullptr;
  if (nhigh) {
    cudaError_t e = cudaMemsetAsync(nhigh, 0, 4, s);
    if (e != cudaSuccess) return (int)e;
  }
  static int cached[64];
  int limit = 0;
  cudaError_t e = resident_blocks(join_rows, J_THREADS, 0, cached, &limit);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (count + J_THREADS - 1) / J_THREADS;
  const int grid = (int)(blocks < limit ? blocks : limit);
  join_rows<<<grid, J_THREADS, 0, s>>>(
      (const int16_t*)feats, (const int32_t*)flags, (const int32_t*)docids,
      (const uint8_t*)dead, doc_cap, start, count, (const int32_t*)jdocids,
      (const int32_t*)jpos, jcap, (const int32_t*)bmtab, nwords, a, q,
      (int32_t*)merged, (int32_t*)flags_out, (uint8_t*)valid_out, nhigh);
  e = cudaGetLastError();
  if (e != cudaSuccess || !nhigh) return (int)e;
  join_high<<<1, H_THREADS, 0, s>>>(
      (const int16_t*)feats, (const int32_t*)flags, (const int32_t*)docids,
      (const uint8_t*)dead, doc_cap, start, count, (const int32_t*)jdocids,
      (const int32_t*)jpos, jcap, (const int32_t*)bmtab, nwords, a, q,
      (int32_t*)merged, (int32_t*)flags_out, (uint8_t*)valid_out, nhigh);
  return (int)cudaGetLastError();
}

// The batched K8 over a wave of bs <= 16 slots: desc bs rows of 6 + 3
// (n_inc + n_exc) int32 in host memory (the reference's qargs_batch:
// start, count, the filter's 4, then jstart, jcount and slot of each
// include partner and of each exclude, slot -1 for a sorted segment);
// off bs + 1 int64 region starts in host memory (off[0] = 0, each
// region at least its slot's count). The arena and join tables as for
// K8. Out: merged [off[bs], 17] int32, flags_out [off[bs]] int32,
// valid_out [off[bs]] bool, slot s's rows from off[s]; scratch int32[bs],
// each slot's count of rows at or above 2^29 (zeroed here).
extern "C" int yt_join_member_batch(
    const void* feats, const void* flags, const void* docids,
    const void* dead, int64_t doc_cap, const void* jdocids, const void* jpos,
    int64_t jcap, const void* bmtab, int64_t nwords, const int32_t* desc,
    int bs, int n_inc, int n_exc, const int64_t* off, void* merged,
    void* flags_out, void* valid_out, void* scratch, void* stream) {
  if (bs < 1 || bs > JOIN_SLOTS || n_inc < 0 || n_exc < 0 || n_inc > 5 ||
      n_exc > 6)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int words = QARGS + 3 * (n_inc + n_exc);
  JoinWave w = {};
  w.bs = bs;
  w.n_inc = n_inc;
  w.n_exc = n_exc;
  int64_t rows[JOIN_SLOTS];
  for (int i = 0; i < bs; ++i) {
    const int32_t* q = desc + (int64_t)i * words;
    if (q[0] < 0 || q[1] < 0 || off[i + 1] - off[i] < q[1])
      return (int)cudaErrorInvalidValue;
    w.start[i] = q[0];
    w.count[i] = q[1];
    rows[i] = q[1];
    for (int k = 0; k < 4; ++k) w.filt[i][k] = q[2 + k];
    for (int t = 0; t < n_inc; ++t) {
      w.jstart[i][t] = q[QARGS + t];
      w.jcount[i][t] = q[QARGS + n_inc + t];
      w.jslot[i][t] = q[QARGS + 2 * n_inc + t];
    }
    const int32_t* e = q + QARGS + 3 * n_inc;
    for (int x = 0; x < n_exc; ++x) {
      w.jstart[i][n_inc + x] = e[x];
      w.jcount[i][n_inc + x] = e[n_exc + x];
      w.jslot[i][n_inc + x] = e[2 * n_exc + x];
    }
  }
  if (off[0] != 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i <= bs; ++i) w.off[i] = off[i];
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)bs * 4, s);
  if (e != cudaSuccess) return (int)e;
  static int cached[64];
  int limit = 0;
  e = resident_blocks(join_rows_batch, J_THREADS, 0, cached, &limit);
  if (e != cudaSuccess) return (int)e;
  // the slots share the resident blocks in proportion to their rows
  const int grid = split_blocks(rows, bs, J_THREADS, limit, w.bstart);
  join_rows_batch<<<grid, J_THREADS, 0, s>>>(
      (const int16_t*)feats, (const int32_t*)flags, (const int32_t*)docids,
      (const uint8_t*)dead, doc_cap, (const int32_t*)jdocids,
      (const int32_t*)jpos, jcap, (const int32_t*)bmtab, nwords, w,
      (int32_t*)merged, (int32_t*)flags_out, (uint8_t*)valid_out,
      (uint32_t*)scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  join_high_batch<<<bs, H_THREADS, 0, s>>>(
      (const int16_t*)feats, (const int32_t*)flags, (const int32_t*)docids,
      (const uint8_t*)dead, doc_cap, (const int32_t*)jdocids,
      (const int32_t*)jpos, jcap, (const int32_t*)bmtab, nwords, w,
      (int32_t*)merged, (int32_t*)flags_out, (uint8_t*)valid_out,
      (const uint32_t*)scratch);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K18 `xjoin`: the cross-row conjunction of the mesh store
// ---------------------------------------------------------------------------
// Replaces the membership exchange of index/meshstore._mesh_xjoin_shard
// (JAX package, meshstore.py:1720-1810). Terms on different term rows of
// the mesh share doc columns (a docid's column is the same for every
// term), so within one column the rare include's candidates (the rare
// cell's docids, rows [start, start + n), n its count) are tested against
// every cell's own docid-sorted join window, and the owner cell's partner
// features come back through term-axis reductions (the mesh's collectives,
// between the two entry points):
//   - `xjoin_probe`, on every cell of the column, one term a launch: a
//     candidate is valid while it is live, below n and passed every
//     earlier term (the reduced contributions `prior`, includes first:
//     found > 0, then excludes: found == 0), as the JAX loop narrows gv
//     term by term. A valid candidate is binary-searched in this cell's
//     window jdocids[lo, lo + cnt) for clip(docid, 0, 2^29); of the valid
//     candidates at or above 2^29 only the last (the largest row) can
//     match, as _membership_sorted's stable co-sort decides
//     (`xjoin_last_high` finds it first). Output int32 [5, n], neutral
//     where not found: found (0/1), posintext min (INT32_MAX) and max
//     (-INT32_MAX), hitcount min (INT32_MAX), flags (0). A non-owner
//     cell's window is empty (cnt 0): all neutral.
//   - `xjoin_apply`, on the rare cell: the term-axis-reduced
//     contributions (psum, pmin, pmax, pmin, psum) of every term folded
//     into the rare rows as K8 merges partner rows (worddistance = max -
//     min of posintext, hitcount = min, flags OR'd with the psum), an
//     include missed or an exclude hit invalidates the row, the filter
//     is applied; merged int32 [n, 17], flags int32 [n], valid [n] as K8
//     writes them, so kernels 1-3 follow as in the column-local join.
//     Only the rare row's cells score (the JAX body's axis_index mask):
//     the others hold no candidate.
// Bound: bytes. A probe reads a candidate's docid and tombstone byte, the
// prior words and, for a valid one, ~log2(cnt) window entries (L2) and
// the partner's 8 B; it writes 20 B. The apply reads the rare rows (34 B
// of features, flags, docid) and 20 B a term, and writes 73 B a row.
constexpr int X_THREADS = 256;
constexpr int32_t X_BIG = 0x7fffffff;  // the neutral fills' INT32_MAX

__device__ __forceinline__ bool xjoin_valid(
    int64_t i, const int32_t* __restrict__ cand, int64_t n,
    const uint8_t* __restrict__ dead, int64_t doc_cap,
    const int32_t* __restrict__ prior, int n_prior, int n_inc) {
  if (i >= n || !row_live(__ldg(cand + i), dead, doc_cap)) return false;
  for (int p = 0; p < n_prior; ++p) {
    const int32_t c = __ldg(prior + (int64_t)p * 5 * n + i);
    if (p < n_inc ? c <= 0 : c != 0) return false;
  }
  return true;
}

__global__ void __launch_bounds__(X_THREADS)
xjoin_last_high(const int32_t* __restrict__ cand, int64_t n,
                const uint8_t* __restrict__ dead, int64_t doc_cap,
                const int32_t* __restrict__ prior, int n_prior, int n_inc,
                int* __restrict__ last) {
  for (int64_t i = (int64_t)blockIdx.x * X_THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * X_THREADS)
    if (__ldg(cand + i) >= JOIN_DOCID_CAP &&
        xjoin_valid(i, cand, n, dead, doc_cap, prior, n_prior, n_inc))
      atomicMax(last, (int)i);
}

__global__ void __launch_bounds__(X_THREADS)
xjoin_probe(const int32_t* __restrict__ cand, int64_t n,
            const uint8_t* __restrict__ dead, int64_t doc_cap,
            const int32_t* __restrict__ prior, int n_prior, int n_inc,
            const int32_t* __restrict__ jdocids,
            const int32_t* __restrict__ jpos, int64_t lo, int64_t cnt,
            const int16_t* __restrict__ feats,
            const int32_t* __restrict__ flags,
            const int* __restrict__ last, int32_t* __restrict__ out) {
  for (int64_t i = (int64_t)blockIdx.x * X_THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * X_THREADS) {
    int32_t found = 0, pmin = X_BIG, pmax = -X_BIG, hmin = X_BIG, fl = 0;
    if (xjoin_valid(i, cand, n, dead, doc_cap, prior, n_prior, n_inc)) {
      const int32_t d = __ldg(cand + i);
      if (d < JOIN_DOCID_CAP || i == *last) {
        const int32_t key = d > JOIN_DOCID_CAP ? JOIN_DOCID_CAP : d;
        int64_t a = lo, b = lo + cnt;
        while (a < b) {  // the first entry >= key
          const int64_t mid = (a + b) >> 1;
          if (__ldg(jdocids + mid) < key) a = mid + 1;
          else b = mid;
        }
        if (a < lo + cnt && __ldg(jdocids + a) == key) {
          const int64_t pr = __ldg(jpos + a);
          found = 1;
          pmin = pmax = __ldg(feats + pr * NF + F_POSINTEXT);
          hmin = __ldg(feats + pr * NF + F_HITCOUNT);
          fl = __ldg(flags + pr);
        }
      }
    }
    out[i] = found;
    out[n + i] = pmin;
    out[2 * n + i] = pmax;
    out[3 * n + i] = hmin;
    out[4 * n + i] = fl;
  }
}

// The apply stages a block's XA_THREADS rows through shared memory as
// join_rows does (2-byte loads of consecutive addresses in, the merged
// rows out as consecutive words); one thread a row merges. (Its first
// form, a thread a row reading 34 B and writing 68 B at a row's stride,
// took 0.438 device ms at 2M rows against a 0.081 bound, staged 0.139,
// on an H100 80GB HBM3 at 700 W: PERF.md.)
constexpr int XA_THREADS = 128;

__global__ void __launch_bounds__(XA_THREADS)
xjoin_apply(const int16_t* __restrict__ feats,
            const int32_t* __restrict__ flags,
            const int32_t* __restrict__ docids,
            const uint8_t* __restrict__ dead, int64_t doc_cap, int64_t start,
            int64_t n, const int32_t* __restrict__ contrib, int n_inc,
            int n_exc, const Filter q, int32_t* __restrict__ merged,
            int32_t* __restrict__ flags_out, uint8_t* __restrict__ valid_out) {
  __shared__ int16_t s_in[XA_THREADS * NF];
  __shared__ int32_t s_out[XA_THREADS * NF];
  const bool off = filter_off(q);
  const int t = threadIdx.x;
  for (int64_t r0 = (int64_t)blockIdx.x * XA_THREADS; r0 < n;
       r0 += (int64_t)gridDim.x * XA_THREADS) {
    const int rows = n - r0 < XA_THREADS ? (int)(n - r0) : XA_THREADS;
    const int16_t* src = feats + (start + r0) * NF;
    for (int i = t; i < rows * NF; i += XA_THREADS) s_in[i] = src[i];
    __syncthreads();
    if (t < rows) {
      const int64_t i = r0 + t;
      const int16_t* f = s_in + t * NF;
      bool v = row_live(__ldg(docids + start + i), dead, doc_cap);
      int32_t fo = __ldg(flags + start + i);
      int32_t pmin = f[F_POSINTEXT], pmax = pmin, hmin = f[F_HITCOUNT];
      for (int k = 0; k < n_inc; ++k) {
        const int32_t* c = contrib + (int64_t)k * 5 * n + i;
        v = v && __ldg(c) > 0;
        pmin = min(pmin, __ldg(c + n));
        pmax = max(pmax, __ldg(c + 2 * n));
        hmin = min(hmin, __ldg(c + 3 * n));
        fo |= __ldg(c + 4 * n);
      }
      for (int e = n_inc; e < n_inc + n_exc; ++e)
        v = v && __ldg(contrib + (int64_t)e * 5 * n + i) == 0;
      int32_t* o = s_out + t * NF;
#pragma unroll
      for (int c = 0; c < NF; ++c) o[c] = f[c];
      o[F_WORDDISTANCE] = pmax - pmin;
      o[F_HITCOUNT] = hmin;
      v = v && (off || constraint_ok(f[F_LANGUAGE], f[F_LASTMOD], fo, q));
      flags_out[i] = fo;
      valid_out[i] = v ? 1 : 0;
    }
    __syncthreads();
    int32_t* dst = merged + r0 * NF;
    for (int i = t; i < rows * NF; i += XA_THREADS) dst[i] = s_out[i];
    __syncthreads();
  }
}

static unsigned x_grid(int64_t n) {
  const int64_t g = (n + X_THREADS - 1) / X_THREADS;
  return (unsigned)(g < 1 ? 1 : (g > 8192 ? 8192 : g));
}

// cand [n] int32 (the rare cell's docids from its span start), dead
// [doc_cap] bool of this cell's device; prior [n_prior, 5, n] int32 (the
// reduced contributions of the earlier terms, includes first, n_inc of
// them at most); jdocids/jpos this cell's join table, the window [lo, lo +
// cnt); feats [*, 17] int16 and flags int32 this cell's arena; scratch one
// int32; out [5, n] int32.
extern "C" int yt_xjoin_probe(const void* cand, int64_t n, const void* dead,
                              int64_t doc_cap, const void* prior,
                              int n_prior, int n_inc, const void* jdocids,
                              const void* jpos, int64_t lo, int64_t cnt,
                              const void* feats, const void* flags,
                              void* scratch, void* out, void* stream) {
  if (n < 0 || n_prior < 0 || n_inc < 0 || lo < 0 || cnt < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0xff, 4, s);  // -1: none
  if (e != cudaSuccess) return (int)e;
  const unsigned g = x_grid(n);
  xjoin_last_high<<<g, X_THREADS, 0, s>>>(
      (const int32_t*)cand, n, (const uint8_t*)dead, doc_cap,
      (const int32_t*)prior, n_prior, n_inc, (int*)scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  xjoin_probe<<<g, X_THREADS, 0, s>>>(
      (const int32_t*)cand, n, (const uint8_t*)dead, doc_cap,
      (const int32_t*)prior, n_prior, n_inc, (const int32_t*)jdocids,
      (const int32_t*)jpos, lo, cnt, (const int16_t*)feats,
      (const int32_t*)flags, (const int*)scratch, (int32_t*)out);
  return (int)cudaGetLastError();
}

// the rare cell's arena, its rows [start, start + n); contrib [n_inc +
// n_exc, 5, n] int32 reduced over the term axis; filt 4 int32 in host
// memory; merged [n, 17] int32, flags_out [n] int32, valid_out [n] bool.
extern "C" int yt_xjoin_apply(const void* feats, const void* flags,
                              const void* docids, const void* dead,
                              int64_t doc_cap, int64_t start, int64_t n,
                              const void* contrib, int n_inc, int n_exc,
                              const int32_t* filt, void* merged,
                              void* flags_out, void* valid_out,
                              void* stream) {
  if (n < 0 || start < 0 || n_inc < 0 || n_exc < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const Filter q = make_filter(filt, nullptr, 0);
  static int cached[64];
  int limit = 0;
  cudaError_t e = resident_blocks(xjoin_apply, XA_THREADS, 0, cached, &limit);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (n + XA_THREADS - 1) / XA_THREADS;
  const int grid = (int)(blocks < limit ? blocks : limit);
  xjoin_apply<<<grid, XA_THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)feats, (const int32_t*)flags, (const int32_t*)docids,
      (const uint8_t*)dead, doc_cap, start, n, (const int32_t*)contrib,
      n_inc, n_exc, q, (int32_t*)merged, (int32_t*)flags_out,
      (uint8_t*)valid_out);
  return (int)cudaGetLastError();
}
