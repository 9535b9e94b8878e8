// K8 `join_member`: the membership and merge step of the devstore's
// device conjunction. Replaces the body of index/devstore._join_topk (JAX
// package, devstore.py:639) up to its statistics, which
// _rank_join_batch_kernel / _rank_join_batch_packed_kernel (:736, :1049)
// and _rank_join_bm_batch_kernel / _rank_join_bm_batch_packed_kernel
// (:769, :1068) run at bs = 1 for a solo query and vmap over a wave: for
// each row of the rarest include term's span, its liveness, its
// membership in every other include term (partner) and in every exclude
// term, and the merge of the partner rows into it (worddistance = max -
// min of posintext across the terms, hitcount = min, flags = OR), then
// the constraint filter on the merged row. Kernels 1-3 and topk_finish
// take the merged block from there, as _join_topk's local_stats,
// cardinal_from_stats and top_k did.
//
// Membership of the row's docid d in a partner segment (the partner's
// docids, sorted, with the arena row each lives at: jdocids/jpos from
// jstart, jcount entries) comes in two modes, per partner:
//   - bitmap (slot >= 0): the term's docid bitmap row bmtab[slot] of
//     nwords (word bits, rank prefix) pairs: found iff 0 <= d < 32 nwords
//     and the bit of d is set; its rank (prefix + popcount of the bits
//     below) is its place in the segment, and the partner row is
//     jpos[clip(jstart + rank)] (_membership_bitmap :609, _popc32 :601);
//   - sort (slot -1): found iff clip(d, 0, 2^29) occurs in the segment;
//     the partner row is jpos at that entry. The reference sorts the
//     rare docids against the segment (_membership_sorted :558) because a
//     random gather is the TPU's slow path; here each row searches the
//     sorted segment for the first entry >= the key. The clip is kept: a
//     docid at or above 2^29 matches a partner docid of exactly 2^29, as
//     in the reference. The reference's sort (stable, its rare rows
//     before the segment, the tag in the key's low bit) puts only the
//     last of the still-valid rare rows of one clipped key next to the
//     partner's entry, so of two or more such rows only the last in row
//     order matches. A span never holds a docid twice (runs are built by
//     postings.sort_dedupe), so only the clip makes keys equal: the rows
//     at or above 2^29. The main pass counts them; where there are two or
//     more and a partner is in sort mode, the last block of the pass
//     redoes those rows with the reference's rule, partner by partner:
//     the last still-valid one (the largest row) alone can match the
//     partner's 2^29.
// A row that is not live, or has missed a partner or hit an exclude, is
// invalid and is tested against no later term (it issues no load for
// them), so a row invalid before a partner never matches it (the
// reference masks those rows the same way). The merged columns of an
// invalid row hold what the merge had reached when the row fell out; the
// statistics and scores read valid rows only.
//
// One kernel, `join_rows`, serves the solo K8 and its wave. A call is a
// list of groups and slots (kernels/devstore.join_words): a group is one
// rare span and its partners, and the slots that share them (a solo call:
// one group of one slot). yt_join_rows lays the launch out from them: each
// partner's search, the shared memory, the grid and its cut. Validity up to the filter depends on the span and its
// partners only (the reference applies _constraint_valid after the merge,
// devstore.py:722-723), so a group's membership, merge and OR'd flags are
// computed once and written to each of its slots' regions, the valid
// byte under that slot's own filter. The clip rule's redo is filter-free
// up to the final valid byte as well, so it too runs once a group.
//
// Bound: bytes. A row reads its 34 B of features, its flags and docid and
// the tombstone byte its docid hits, and each slot of its group writes 68
// B of merged int32 features, 4 B of flags and a valid byte; each partner
// lookup of a row still valid gathers the bitmap pair or the searched
// entry and its arena row, and for an include the partner's posintext,
// hitcount (2 B each) and flags (4 B). A term's rows lie in the arena in
// the order of their score proxy, so a span's docids are in no order and
// every gather is a random sector; a row's chain of them (the bitmap
// pair, jpos, the partner's row) waits step by step. The design keeps
// many rows in flight and everything else coalesced or off the warps:
//   - a persistent grid (resident blocks, cut between the groups in
//     proportion to the rows they write) of 8 warps a block; each warp
//     walks tiles of 32 x RPL rows of its group's span on its own, no
//     block barrier in the loop;
//   - a lane carries RPL = 2 rows (4 is slower, PERF.md) through the chain
//     stage by stage: all their lookups, then all their jpos loads, then
//     all their partner loads, so their loads overlap;
//   - a row's tombstone byte is read only where it decides the answer: a
//     row that misses its first partner (or hits its first exclude) falls
//     out alike whether it is live or not (nothing merged, not valid), so
//     only the others read it, beside their jpos loads at that partner;
//   - a warp stages its next tile's features, flags and docids into
//     shared memory by 16-byte cp.async of each span's 16-byte envelope
//     while it works on this one;
//   - the merged rows and flags are built once in shared memory (a merged
//     word is the staged int16 at its place widened) and the bulk copy
//     engine (TMA, cp.async.bulk) writes them out, once for each slot of
//     the group, while the warp goes on to its next tile (written by the
//     warps' own 16-byte stores, the output held a warp longer than its
//     gathers did, most of all at the sort shape and in a wave);
//   - a sort-mode partner is searched in shared memory: each block stages
//     the whole segment when it fits (PM_STAGED), else a fence table of
//     every 2^k-th docid (the search ends in a window of 2^k entries of
//     the segment in device memory); every search runs a fixed number of
//     branch-free steps, so a lane's RPL searches interleave;
//   - one launch a call: the rows at or above 2^29 are counted in the
//     main pass; the last block of a group to finish (an atomic ticket
//     after __threadfence, as cardinal_stats does) redoes them where
//     needed and resets the group's counters and ticket for the next
//     call, so no memset precedes the kernel.
#include "common.cuh"

namespace yt {

constexpr int J_WARPS = 8;
constexpr int J_THREADS = 32 * J_WARPS;
constexpr int MAX_PARTS = 11;           // 5 include partners + 6 excludes
constexpr int32_t JOIN_DOCID_CAP = 1 << 29;
constexpr int JOIN_SLOTS = BATCH_SLOTS;
constexpr int JOIN_CTR = 4;             // a group's counters: rows >= 2^29,
                                        // ~first such row, last + 1, ticket
constexpr int RPL = 2;                  // rows a lane (4 is slower, PERF.md)
// how a partner's membership is found (JoinGroup::mode): a bitmap, a
// sorted segment staged whole, or (PM_FENCE_MIN or more) a fence table of
// stride 2^mode of at most JOIN_FENCE_WORDS docids
constexpr int PM_BITMAP = 0, PM_STAGED = 1, PM_FENCE_MIN = 6;
constexpr int64_t JOIN_FENCE_WORDS = 4096;
constexpr int SMEM_STEP = 4096;         // a launch's shared memory rounded
                                        // up to this (few sizes to cache)

// one rare span, its partners (includes, then excludes) and the slots
// that share them (in slot order), taking blocks [bstart, next bstart)
struct JoinGroup {
  int64_t start, count;
  int32_t jstart[MAX_PARTS], jcount[MAX_PARTS], jslot[MAX_PARTS];
  int8_t mode[MAX_PARTS];
  int8_t nslots;
  int8_t slots[JOIN_SLOTS];
  int32_t bstart;
};

// a call's groups; slot s's region of the outputs starts at row off[s]
struct JoinPlan {
  JoinGroup g[JOIN_SLOTS];
  int64_t off[JOIN_SLOTS];
  int32_t filt[JOIN_SLOTS][4];
  int32_t ngroups, n_inc, n_exc, grid;
};

struct JoinArgs {
  const int16_t* feats;
  const int32_t *flags, *docids;
  const uint8_t* dead;
  const int32_t *jdocids, *jpos, *bmtab;
  int32_t* merged;
  int32_t* flags_out;
  uint8_t* valid_out;
  uint32_t* ctr;          // JOIN_CTR words a group, zero between calls
  int64_t doc_cap, jcap, nwords;
};

// one warp's shared memory: two stages of a tile (features, flags,
// docids, each at its span's offset mod 16), then the tile's merged rows
// and OR'd flags on their way out
struct JTile {
  static constexpr int ROWS = 32 * RPL;
  static constexpr int FEAT = ROWS * NF * 2 + 32;
  static constexpr int WORD = ROWS * 4 + 32;
  static constexpr int STAGE = FEAT + 2 * WORD;
  static constexpr int OUT = ROWS * (NF + 1) * 4;   // merged rows, flags
  static constexpr int WARP = 2 * STAGE + OUT;
};

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// The bulk copy engine (TMA) writes a shared-memory span to device
// memory (sizes and both addresses multiples of 16 bytes); a bulk group
// is committed after a warp's copies, and the buffer is reused once the
// engine has read it.
__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          gdst),
      "r"((unsigned)__cvta_generic_to_shared(ssrc)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// a thread's writes to shared memory made visible to the bulk copy engine
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One warp starts the copy of the bytes [a, b) into dst: the 16-byte
// aligned envelope [floor16(a), ceil16(b)) by cp.async, so byte x lands at
// dst + (x - floor16(a)) and no lane waits on a load. The envelope's extra
// bytes lie in the same allocation (the caching allocator hands out
// 512-byte multiples).
__device__ __forceinline__ void stage_span(unsigned char* dst, uintptr_t a,
                                           uintptr_t b, int lane) {
  const uintptr_t a0 = a & ~(uintptr_t)15;
  const uintptr_t b1 = (b + 15) & ~(uintptr_t)15;
  const int chunks = (int)((b1 - a0) >> 4);
  for (int c = lane; c < chunks; c += 32)
    cp_async16(dst + 16 * c, (const void*)(a0 + 16 * (uintptr_t)c));
}

// the words a partner takes in the block's stage area: a staged segment
// with 16 B of alignment slack, a fence table rounded to 16 B
__host__ __device__ __forceinline__ int64_t stage_words(int mode, int64_t n) {
  if (mode == PM_STAGED) return (n + 7) & ~(int64_t)3;
  if (mode >= PM_FENCE_MIN)
    return ((((n + (1ll << mode) - 1) >> mode)) + 3) & ~(int64_t)3;
  return 0;
}

// The block's threads start the copies of the n words at src into dst (16
// B aligned): the body by 16-byte cp.async, the ragged head and tail by
// word loads; word x lands at dst + 4 x + (src mod 16).
__device__ __forceinline__ void block_copy_words(unsigned char* dst,
                                                 const int32_t* src,
                                                 int64_t n, int t) {
  const uintptr_t a = (uintptr_t)src, b = a + 4 * (uintptr_t)n;
  const uintptr_t a0 = a & ~(uintptr_t)15;
  const uintptr_t body0 = (a + 15) & ~(uintptr_t)15;
  const uintptr_t body1 = b & ~(uintptr_t)15;
  if (body0 < body1) {
    const int64_t chunks = (int64_t)((body1 - body0) >> 4);
    for (int64_t c = t; c < chunks; c += J_THREADS)
      cp_async16(dst + (body0 - a0) + 16 * c,
                 (const void*)(body0 + 16 * (uintptr_t)c));
  }
  const uintptr_t h1 = body0 < b ? body0 : b;
  const uintptr_t t0 = body1 > body0 ? body1 : body0;
  const int nh = (int)((h1 - a) / 4);
  const int nt = b > t0 ? (int)((b - t0) / 4) : 0;
  if (t < nh)
    *(int32_t*)(dst + (a - a0) + 4 * t) = *(const int32_t*)(a + 4 * t);
  else if (t >= 32 && t - 32 < nt)
    *(int32_t*)(dst + (t0 - a0) + 4 * (t - 32)) =
        *(const int32_t*)(t0 + 4 * (t - 32));
}

// Membership of docid d in partner p, in device memory (the redo): the
// partner's arena row, or -1.
__device__ __forceinline__ int64_t member(const JoinGroup& g, int p,
                                          int32_t d, const JoinArgs& A) {
  if (g.jslot[p] >= 0) {
    const int64_t nbits = A.nwords * 32;
    const int64_t t = d < 0 ? 0 : (d >= nbits ? nbits - 1 : d);
    const int2 wp = __ldg(reinterpret_cast<const int2*>(A.bmtab) +
                          (int64_t)g.jslot[p] * A.nwords + (t >> 5));
    const uint32_t w = (uint32_t)wp.x;
    const uint32_t sh = (uint32_t)(t & 31);
    if (d < 0 || d >= nbits || !((w >> sh) & 1u)) return -1;
    int64_t q = g.jstart[p] + wp.y + __popc(w & ((1u << sh) - 1u));
    q = q < 0 ? 0 : (q >= A.jcap ? A.jcap - 1 : q);
    return __ldg(A.jpos + q);
  }
  const int32_t key = d < 0 ? 0 : (d > JOIN_DOCID_CAP ? JOIN_DOCID_CAP : d);
  int64_t lo = g.jstart[p], hi = g.jstart[p] + g.jcount[p];
  while (lo < hi) {  // the first entry >= key
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(A.jdocids + mid) < key) lo = mid + 1;
    else hi = mid;
  }
  if (lo >= g.jstart[p] + g.jcount[p] || __ldg(A.jdocids + lo) != key)
    return -1;
  return __ldg(A.jpos + lo);
}

// The first index i in [0, n) (n >= 1) with s[i] >= key[k], or n, for each
// of a lane's RPL keys, in ceil(log2 n) + 1 branch-free steps.
__device__ __forceinline__ void lower_bound_smem(const int32_t* s, int n,
                                                 const int32_t* key,
                                                 int* base) {
#pragma unroll
  for (int k = 0; k < RPL; ++k) base[k] = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int k = 0; k < RPL; ++k)
      base[k] = s[base[k] + half] < key[k] ? base[k] + half : base[k];
    len -= half;
  }
#pragma unroll
  for (int k = 0; k < RPL; ++k) base[k] += s[base[k]] < key[k] ? 1 : 0;
}

// The same over seg[w0[k], w1[k]) in device memory, each window shorter
// than len (a power of two at least 1): the entries past a window read as
// +inf, so every lane takes the same log2(len) + 1 steps.
__device__ __forceinline__ void lower_bound_global(const int32_t* seg,
                                                   int64_t len,
                                                   const int64_t* w0,
                                                   const int64_t* w1,
                                                   const int32_t* key,
                                                   const bool* on,
                                                   int64_t* base) {
#pragma unroll
  for (int k = 0; k < RPL; ++k) base[k] = w0[k];
  for (; len > 1;) {
    const int64_t half = len >> 1;
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int64_t i = base[k] + half;
      const int32_t x = on[k] && i < w1[k] ? __ldg(seg + i) : BIG;
      base[k] = x < key[k] ? i : base[k];
    }
    len -= half;
  }
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int32_t x =
        on[k] && base[k] < w1[k] ? __ldg(seg + base[k]) : BIG;
    base[k] += x < key[k] ? 1 : 0;
  }
}

// the block's view of its group: the group, its slots' region starts and
// filters, each partner's staged words (byte offset into the block's
// dynamic shared memory), whether a partner is in sort mode
struct JoinShared {
  JoinGroup g;
  int64_t off[JOIN_SLOTS];
  Filter q[JOIN_SLOTS];
  int32_t poff[MAX_PARTS];
  int32_t any_sorted, last;
  unsigned long long s_last;
};

// One warp's tile: rows [r0, r0 + rows) of the group's span, staged at
// st; its merged rows written to every slot of the group.
__device__ __forceinline__ void join_tile(const JoinArgs& A,
                                          const JoinShared& S,
                                          const unsigned char* smem,
                                          const unsigned char* st,
                                          unsigned char* out,
                                          int64_t r0, int rows, int lane,
                                          int n_inc, int n_exc) {
  const JoinGroup& g = S.g;
  const int16_t* fbase = A.feats + g.start * NF;
  const int16_t* fe =
      (const int16_t*)(st + (uintptr_t)fbase % 16);
  const int32_t* fl =
      (const int32_t*)(st + JTile::FEAT + (uintptr_t)(A.flags + g.start) % 16);
  const int32_t* dc = (const int32_t*)(st + JTile::FEAT + JTile::WORD +
                                       (uintptr_t)(A.docids + g.start) % 16);
  int32_t d[RPL], fo[RPL], pmin[RPL], pmax[RPL], hmin[RPL];
  bool v[RPL];
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int j = lane + 32 * k;
    const bool in = j < rows;
    d[k] = in ? dc[j] : -1;
    fo[k] = in ? fl[j] : 0;
    pmin[k] = in ? (int32_t)fe[j * NF + F_POSINTEXT] : 0;
    pmax[k] = pmin[k];
    hmin[k] = in ? (int32_t)fe[j * NF + F_HITCOUNT] : 0;
  }
  // liveness is read where it decides the answer (head note): before the
  // partners only where there are none
  const int np = n_inc + n_exc;
#pragma unroll
  for (int k = 0; k < RPL; ++k) v[k] = d[k] >= 0;
  if (np == 0) {
    uint8_t dd[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k)
      dd[k] = v[k] && d[k] < A.doc_cap ? __ldg(A.dead + d[k]) : 0;
#pragma unroll
    for (int k = 0; k < RPL; ++k) v[k] = v[k] && !dd[k];
  }
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    if (S.any_sorted && d[k] >= JOIN_DOCID_CAP) {
      uint32_t* c = A.ctr;
      const uint32_t r = (uint32_t)(r0 + lane + 32 * k);
      atomicAdd(c, 1u);
      atomicMax(c + 1, 0xffffffffu - r);
      atomicMax(c + 2, r + 1u);
    }
  }
  for (int p = 0; p < np; ++p) {
    const int mode = g.mode[p];
    const bool inc = p < n_inc;
    bool f[RPL];
    int64_t q[RPL];   // the partner's entry in jdocids / jpos
    if (mode == PM_BITMAP) {
      const int2* row = reinterpret_cast<const int2*>(A.bmtab) +
                        (int64_t)g.jslot[p] * A.nwords;
      const int64_t nbits = A.nwords * 32;
      int2 wp[RPL];
#pragma unroll
      for (int k = 0; k < RPL; ++k)
        wp[k] = v[k] && d[k] < nbits ? __ldg(row + (d[k] >> 5))
                                     : make_int2(0, 0);
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const uint32_t w = (uint32_t)wp[k].x, sh = (uint32_t)(d[k] & 31);
        f[k] = v[k] && d[k] < nbits && ((w >> sh) & 1u);
        int64_t e = g.jstart[p] + wp[k].y + __popc(w & ((1u << sh) - 1u));
        q[k] = e < 0 ? 0 : (e >= A.jcap ? A.jcap - 1 : e);
      }
    } else {
      int32_t key[RPL];
#pragma unroll
      for (int k = 0; k < RPL; ++k)
        key[k] = d[k] > JOIN_DOCID_CAP ? JOIN_DOCID_CAP : d[k];
      const int64_t n = g.jcount[p];
      const int32_t* seg = A.jdocids + g.jstart[p];
      if (n == 0) {
#pragma unroll
        for (int k = 0; k < RPL; ++k) f[k] = false, q[k] = 0;
      } else if (mode == PM_STAGED) {
        const int32_t* s =
            (const int32_t*)(smem + S.poff[p]);
        int b[RPL];
        lower_bound_smem(s, (int)n, key, b);
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          f[k] = v[k] && b[k] < n && s[b[k]] == key[k];
          q[k] = g.jstart[p] + b[k];
        }
      } else {
        // the fence j = the first of every 2^mode-th entry >= the key:
        // the answer lies after fence j - 1, up to fence j
        int64_t w0[RPL], w1[RPL], b[RPL];
        const int32_t* fz = (const int32_t*)(smem + S.poff[p]);
        const int nf = (int)((n + (1ll << mode) - 1) >> mode);
        int jf[RPL];
        lower_bound_smem(fz, nf, key, jf);
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          w0[k] = jf[k] == 0 ? 0 : ((int64_t)(jf[k] - 1) << mode) + 1;
          const int64_t e = (int64_t)jf[k] << mode;
          w1[k] = jf[k] == 0 ? 0 : (e < n ? e : n);
        }
        lower_bound_global(seg, 1ll << mode, w0, w1, key, v, b);
        int32_t x[RPL];
#pragma unroll
        for (int k = 0; k < RPL; ++k)
          x[k] = v[k] && b[k] < n ? __ldg(seg + b[k]) : -1;
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
          f[k] = v[k] && b[k] < n && x[k] == key[k];
          q[k] = g.jstart[p] + b[k];
        }
      }
    }
    // at the first partner, the tombstone bytes of the rows it leaves
    // valid (an exclude's misses, an include's hits)
    const bool first = p == 0;
    uint8_t dd[RPL];
    if (!inc) {
#pragma unroll
      for (int k = 0; k < RPL; ++k)
        dd[k] = first && v[k] && !f[k] && d[k] < A.doc_cap
                    ? __ldg(A.dead + d[k])
                    : 0;
#pragma unroll
      for (int k = 0; k < RPL; ++k) v[k] = v[k] && !f[k] && !dd[k];
      continue;
    }
    int32_t pr[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) pr[k] = f[k] ? __ldg(A.jpos + q[k]) : 0;
#pragma unroll
    for (int k = 0; k < RPL; ++k)
      dd[k] = first && f[k] && d[k] < A.doc_cap ? __ldg(A.dead + d[k]) : 0;
    int32_t pp[RPL], ph[RPL], pf[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int16_t* prow = A.feats + (int64_t)pr[k] * NF;
      pp[k] = f[k] ? (int32_t)__ldg(prow + F_POSINTEXT) : 0;
      ph[k] = f[k] ? (int32_t)__ldg(prow + F_HITCOUNT) : 0;
      pf[k] = f[k] ? __ldg(A.flags + pr[k]) : 0;
    }
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      f[k] = f[k] && !dd[k];
      if (f[k]) {
        pmin[k] = min(pmin[k], pp[k]);
        pmax[k] = max(pmax[k], pp[k]);
        hmin[k] = min(hmin[k], ph[k]);
        fo[k] |= pf[k];
      }
      v[k] = f[k];
    }
  }
  // every slot's valid bytes, each under its slot's filter
  for (int i = 0; i < g.nslots; ++i) {
    const Filter& fq = S.q[i];
    const bool off = filter_off(fq);
    const int64_t o = S.off[i] + r0;
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int j = lane + 32 * k;
      if (j < rows)
        A.valid_out[o + j] =
            v[k] && (off || constraint_ok(fe[j * NF + F_LANGUAGE],
                                          fe[j * NF + F_LASTMOD], fo[k], fq))
                ? 1
                : 0;
    }
  }
  // the merged rows and flags built in shared memory once (a merged word
  // is the staged int16 at its place widened, then each row's
  // worddistance and hitcount), after the engine has read the last tile's
  int32_t* om = (int32_t*)out;
  int32_t* of = om + JTile::ROWS * NF;
  if (lane == 0) bulk_wait_read();
  __syncwarp();
  const int nw = rows * NF, n4 = nw >> 2;
  for (int i = lane; i < n4; i += 32)
    reinterpret_cast<int4*>(om)[i] =
        make_int4(fe[4 * i], fe[4 * i + 1], fe[4 * i + 2], fe[4 * i + 3]);
  if (lane < (nw & 3)) om[4 * n4 + lane] = fe[4 * n4 + lane];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int j = lane + 32 * k;
    if (j < rows) {
      om[j * NF + F_WORDDISTANCE] = pmax[k] - pmin[k];
      om[j * NF + F_HITCOUNT] = hmin[k];
      of[j] = fo[k];
    }
  }
  // whole groups of 4 rows go out by the copy engine, one copy of the
  // rows and one of the flags a slot; a last tile's other rows by stores
  fence_async_shared();
  __syncwarp();
  const int rows4 = rows & ~3;
  if (lane == 0 && rows4) {
    for (int s = 0; s < g.nslots; ++s) {
      const int64_t o = S.off[s] + r0;
      bulk_store(A.merged + o * NF, om, (uint32_t)(rows4 * NF * 4));
      bulk_store(A.flags_out + o, of, (uint32_t)(rows4 * 4));
    }
    bulk_commit();
  }
  for (int w = rows4 * NF + lane; w < nw; w += 32)
    for (int s = 0; s < g.nslots; ++s)
      A.merged[(S.off[s] + r0) * NF + w] = om[w];
  if (lane < rows - rows4)
    for (int s = 0; s < g.nslots; ++s)
      A.flags_out[S.off[s] + r0 + rows4 + lane] = of[rows4 + lane];
}

// The rows of the group's span at or above 2^29, [lo, hi) relative to its
// start, redone by the last block with the reference's last-match rule
// (head note). The state of such a row lives in the group's first slot's
// region while the partners are walked: valid_out (still valid),
// flags_out (the OR), and in its merged row the posintext minimum
// (worddistance column), maximum (posintext column) and hitcount minimum;
// the rows are written in final form to every slot at the end, each valid
// byte under its slot's filter. A sort-mode partner matches only the
// largest still-valid such row, and only where its segment holds 2^29; a
// bitmap partner tests each row's own docid, as the main pass does.
__device__ __forceinline__ void join_redo(const JoinArgs& A, JoinShared& S,
                                          int64_t lo, int64_t hi, int n_inc,
                                          int n_exc) {
  const JoinGroup& g = S.g;
  const int t = threadIdx.x;
  const int64_t o0 = S.off[0];
  int32_t* M = A.merged + o0 * NF;
  int32_t* FO = A.flags_out + o0;
  uint8_t* VO = A.valid_out + o0;
  const int16_t* F = A.feats + g.start * NF;
  const int32_t* D = A.docids + g.start;
  for (int64_t r = lo + t; r < hi; r += J_THREADS) {
    const int32_t d = D[r];
    if (d < JOIN_DOCID_CAP) continue;
    const int16_t* f = F + r * NF;
    int32_t* m = M + r * NF;
    m[F_WORDDISTANCE] = f[F_POSINTEXT];
    m[F_POSINTEXT] = f[F_POSINTEXT];
    m[F_HITCOUNT] = f[F_HITCOUNT];
    FO[r] = A.flags[g.start + r];
    VO[r] = row_live(d, A.dead, A.doc_cap) ? 1 : 0;
  }
  __syncthreads();
  for (int p = 0; p < n_inc + n_exc; ++p) {
    const bool sorted = g.jslot[p] < 0;
    unsigned long long last = 0;  // the largest still-valid row, plus one
    int64_t prow_cap = -1;        // the partner's row of docid 2^29
    if (sorted) {
      if (t == 0) S.s_last = 0ull;
      __syncthreads();
      unsigned long long mine = 0;
      for (int64_t r = lo + t; r < hi; r += J_THREADS)
        if (D[r] >= JOIN_DOCID_CAP && VO[r])
          mine = (unsigned long long)r + 1ull;
      if (mine) atomicMax(&S.s_last, mine);
      __syncthreads();
      last = S.s_last;
      if (last) prow_cap = member(g, p, JOIN_DOCID_CAP, A);
    }
    for (int64_t r = lo + t; r < hi; r += J_THREADS) {
      const int32_t d = D[r];
      if (d < JOIN_DOCID_CAP || !VO[r]) continue;
      const int64_t pr =
          sorted ? ((unsigned long long)r + 1ull == last ? prow_cap : -1)
                 : member(g, p, d, A);
      if (p >= n_inc) {
        if (pr >= 0) VO[r] = 0;
      } else if (pr < 0) {
        VO[r] = 0;
      } else {
        int32_t* m = M + r * NF;
        const int32_t pp = A.feats[pr * NF + F_POSINTEXT];
        m[F_WORDDISTANCE] = min(m[F_WORDDISTANCE], pp);
        m[F_POSINTEXT] = max(m[F_POSINTEXT], pp);
        m[F_HITCOUNT] = min(m[F_HITCOUNT], (int32_t)A.feats[pr * NF + F_HITCOUNT]);
        FO[r] |= A.flags[pr];
      }
    }
    __syncthreads();
  }
  for (int64_t r = lo + t; r < hi; r += J_THREADS) {
    if (D[r] < JOIN_DOCID_CAP) continue;
    const int16_t* f = F + r * NF;
    const int32_t* m = M + r * NF;
    const int32_t pmin = m[F_WORDDISTANCE], pmax = m[F_POSINTEXT];
    const int32_t hmin = m[F_HITCOUNT], fo = FO[r];
    const bool vp = VO[r] != 0;
    for (int i = g.nslots - 1; i >= 0; --i) {
      int32_t* mo = A.merged + (S.off[i] + r) * NF;
      for (int c = 0; c < NF; ++c) mo[c] = f[c];
      mo[F_WORDDISTANCE] = pmax - pmin;
      mo[F_HITCOUNT] = hmin;
      A.flags_out[S.off[i] + r] = fo;
      const Filter& fq = S.q[i];
      A.valid_out[S.off[i] + r] =
          vp && (filter_off(fq) ||
                 constraint_ok(f[F_LANGUAGE], f[F_LASTMOD], fo, fq))
              ? 1
              : 0;
    }
  }
}

__global__ void __launch_bounds__(J_THREADS, 2)
join_rows(const JoinArgs A, const __grid_constant__ JoinPlan P) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ JoinShared S;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int gi = 0;
  while (gi + 1 < P.ngroups && (int)blockIdx.x >= P.g[gi + 1].bstart) ++gi;
  const int b0 = P.g[gi].bstart;
  const int nb = (gi + 1 < P.ngroups ? P.g[gi + 1].bstart : P.grid) - b0;
  const int np = P.n_inc + P.n_exc;
  if (t == 0) {
    S.g = P.g[gi];
    int64_t at = (int64_t)J_WARPS * JTile::WARP;
    int any = 0;
    for (int p = 0; p < np; ++p) {
      const int m = P.g[gi].mode[p];
      any |= P.g[gi].jslot[p] < 0;
      S.poff[p] = (int32_t)at;
      if (m == PM_STAGED)
        S.poff[p] += (int32_t)((uintptr_t)(A.jdocids + P.g[gi].jstart[p]) %
                               16);
      at += 4 * stage_words(m, P.g[gi].jcount[p]);
    }
    S.any_sorted = any;
  }
  if (t < P.g[gi].nslots) {
    const int s = P.g[gi].slots[t];
    S.off[t] = P.off[s];
    S.q[t] = Filter{P.filt[s][0], P.filt[s][1], P.filt[s][2], P.filt[s][3],
                    nullptr, 0};
  }
  __syncthreads();
  const JoinGroup& g = S.g;
  JoinArgs a = A;
  a.ctr = A.ctr + JOIN_CTR * gi;

  // the sort-mode partners' stages: whole segments or fence tables
  for (int p = 0; p < np; ++p) {
    const int m = g.mode[p];
    const int32_t* seg = A.jdocids + g.jstart[p];
    if (m == PM_STAGED) {
      block_copy_words(smem + (S.poff[p] & ~15), seg, g.jcount[p], t);
    } else if (m >= PM_FENCE_MIN) {
      const int64_t nf = (g.jcount[p] + (1ll << m) - 1) >> m;
      int32_t* fz = (int32_t*)(smem + S.poff[p]);
      for (int64_t i = t; i < nf; i += J_THREADS)
        cp_async4(fz + i, seg + (i << m));
    }
  }
  cp_async_commit();

  unsigned char* mine = smem + warp * JTile::WARP;
  unsigned char* out = mine + 2 * JTile::STAGE;
  const int64_t n = g.count;
  const int64_t tiles = (n + JTile::ROWS - 1) / JTile::ROWS;
  const int64_t step = (int64_t)nb * J_WARPS;
  int64_t c = (int64_t)(blockIdx.x - b0) * J_WARPS + warp;
  const int16_t* fs = A.feats + g.start * NF;
  const int32_t* fls = A.flags + g.start;
  const int32_t* dcs = A.docids + g.start;
  auto issue = [&](int64_t tile, unsigned char* st) {
    const int64_t r0 = tile * JTile::ROWS;
    const int64_t r1 = r0 + JTile::ROWS < n ? r0 + JTile::ROWS : n;
    stage_span(st, (uintptr_t)(fs + r0 * NF), (uintptr_t)(fs + r1 * NF),
               lane);
    stage_span(st + JTile::FEAT, (uintptr_t)(fls + r0), (uintptr_t)(fls + r1),
               lane);
    stage_span(st + JTile::FEAT + JTile::WORD, (uintptr_t)(dcs + r0),
               (uintptr_t)(dcs + r1), lane);
  };
  if (c < tiles) issue(c, mine);
  cp_async_commit();
  cp_async_wait<1>();   // the partners' stages
  __syncthreads();
  for (int i = 0; c < tiles; ++i, c += step) {
    const int cur = i & 1;
    if (c + step < tiles) issue(c + step, mine + (cur ^ 1) * JTile::STAGE);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int64_t r0 = c * JTile::ROWS;
    const int rows = n - r0 < JTile::ROWS ? (int)(n - r0) : JTile::ROWS;
    join_tile(a, S, smem, mine + cur * JTile::STAGE, out, r0, rows, lane,
                   P.n_inc, P.n_exc);
  }
  cp_async_wait<0>();
  if (lane == 0) bulk_wait();   // the warp's rows are written

  // the last block of the group redoes the rows at or above 2^29 where
  // the clip rule needs it and leaves the counters at zero
  __threadfence();
  __syncthreads();
  if (t == 0) S.last = atomicAdd(a.ctr + 3, 1u) == (unsigned)(nb - 1);
  __syncthreads();
  if (!S.last) return;
  __threadfence();
  const uint32_t nhigh = __ldcg(a.ctr);
  const int64_t lo = (int64_t)(0xffffffffu - __ldcg(a.ctr + 1));
  const int64_t hi = (int64_t)__ldcg(a.ctr + 2);
  __syncthreads();
  if (S.any_sorted && nhigh >= 2u) join_redo(a, S, lo, hi, P.n_inc, P.n_exc);
  if (t < JOIN_CTR) a.ctr[t] = 0u;
}

// The most dynamic shared memory join_rows may take on the current device
// (the opt-in limit less its static shared memory), found and set as the
// kernel's limit on the first call on a device.
static cudaError_t join_max_smem(int* out) {
  static int cache[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < 64 && cache[dev] > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, join_rows);
  if (e != cudaSuccess) return e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const int most = optin - (int)fa.sharedSizeBytes;
  e = cudaFuncSetAttribute(join_rows,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < 64) cache[dev] = most;
  *out = most;
  return cudaSuccess;
}

// The words of stage area a block has for its group's sort-mode partners
// on the current device: what its warps' tiles leave of `most`.
static int64_t join_budget(int most) {
  return ((int64_t)most - (int64_t)J_WARPS * JTile::WARP) / 4;
}

// Each partner's search (g.mode) within `budget` words of stage area: a
// bitmap partner PM_BITMAP; a sort-mode one staged whole where it fits,
// else the fence table of the smallest stride 2^k >= 2^PM_FENCE_MIN that
// fits in JOIN_FENCE_WORDS and what is left. Room for a table of one
// 16-byte line (4 words) is kept for each sort-mode partner after it, so
// every partner gets a stage. Returns the words they take, or -1 where the
// budget cannot hold even those lines.
static int64_t join_modes(JoinGroup& g, int np, int64_t budget) {
  int later = 0;
  for (int p = 0; p < np; ++p) later += g.jslot[p] < 0;
  if (budget < 4 * (int64_t)later) return -1;
  int64_t used = 0;
  for (int p = 0; p < np; ++p) {
    if (g.jslot[p] >= 0) {
      g.mode[p] = PM_BITMAP;
      continue;
    }
    --later;
    const int64_t room = budget - used - 4 * (int64_t)later;
    const int64_t n = g.jcount[p];
    int mode = PM_STAGED;
    if (stage_words(PM_STAGED, n) > room) {
      const int64_t cap = room < JOIN_FENCE_WORDS ? room : JOIN_FENCE_WORDS;
      mode = PM_FENCE_MIN;
      while (stage_words(mode, n) > cap) ++mode;
    }
    g.mode[p] = (int8_t)mode;
    used += stage_words(mode, n);
  }
  return used;
}

// How many join_rows blocks of `smem` dynamic bytes the current device
// holds at once (occupancy times SMs), cached per device and size.
static cudaError_t join_resident(int smem, int* out) {
  static int cache[64][64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int step = (smem + SMEM_STEP - 1) / SMEM_STEP;
  const bool keep = dev >= 0 && dev < 64 && step < 64;
  if (keep && cache[dev][step] > 0) {
    *out = cache[dev][step];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, join_rows,
                                                    J_THREADS, smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (keep) cache[dev][step] = per_sm * sms;
  *out = per_sm * sms;
  return cudaSuccess;
}

}  // namespace yt

using namespace yt;

// The most entries of a sorted partner segment that a block stages whole
// on the current device, where it is its group's only sort-mode partner
// (a larger one is searched through a fence table): out[0].
extern "C" int yt_join_stage_most(int* out) {
  int most = 0;
  const cudaError_t e = join_max_smem(&most);
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)((join_budget(most) & ~(int64_t)3) - 4);
  return (int)cudaSuccess;
}

// K8, solo or a wave, one launch. Arena: feats [cap, 17] int16,
// flags/docids [cap] int32, dead [doc_cap] bool. Join tables:
// jdocids/jpos [jcap] int32, bmtab [slots, nwords, 2] int32. In host
// memory (kernels/devstore.join_words), int64 words:
//   groups: ngroups of (start, count, then (jstart, jcount, jslot) of each
//   include partner and each exclude), jslot >= 0 a bitmap row, -1 sorted;
//   slots: bs of (off, group, the filter's 4), off its region's first row,
//   a multiple of 4.
// Out: merged [rows, 17] int32 and flags_out [rows] int32 (both 16-byte
// aligned), valid_out [rows] bool, slot s's rows from off[s]. ctr:
// JOIN_CTR uint32 a group, zero before the call and left at zero (one set
// a stream). The launch is laid out here: each partner's search
// (join_modes), the shared memory its group's stages need, a grid of the
// blocks the card holds at that size, cut between the groups in
// proportion to the rows they write.
extern "C" int yt_join_rows(const void* feats, const void* flags,
                            const void* docids, const void* dead,
                            int64_t doc_cap, const void* jdocids,
                            const void* jpos, int64_t jcap, const void* bmtab,
                            int64_t nwords, const int64_t* groups,
                            int64_t ngroups, const int64_t* slots, int64_t bs,
                            int64_t n_inc, int64_t n_exc, void* merged,
                            void* flags_out, void* valid_out, void* ctr,
                            void* stream) {
  const int64_t ng = ngroups, np = n_inc + n_exc;
  if (ng < 1 || ng > JOIN_SLOTS || bs < 1 || bs > JOIN_SLOTS || n_inc < 0 ||
      n_exc < 0 || n_inc > 5 || n_exc > 6 || ((uintptr_t)merged & 15) ||
      ((uintptr_t)flags_out & 15))
    return (int)cudaErrorInvalidValue;
  int most = 0;
  cudaError_t e = join_max_smem(&most);
  if (e != cudaSuccess) return (int)e;
  const int64_t budget = join_budget(most);
  if (budget < 0) return (int)cudaErrorInvalidConfiguration;
  JoinPlan P = {};
  P.ngroups = (int32_t)ng;
  P.n_inc = (int32_t)n_inc;
  P.n_exc = (int32_t)n_exc;
  for (int64_t s = 0; s < bs; ++s) {
    const int64_t* w = slots + 6 * s;
    // a region starts on a multiple of 4 rows: 16-byte merged stores
    if (w[0] < 0 || (w[0] & 3) || w[1] < 0 || w[1] >= ng)
      return (int)cudaErrorInvalidValue;
    P.off[s] = w[0];
    for (int k = 0; k < 4; ++k) P.filt[s][k] = (int32_t)w[2 + k];
    JoinGroup& g = P.g[w[1]];
    g.slots[g.nslots++] = (int8_t)s;
  }
  int64_t words = 0, total = 0;
  for (int64_t i = 0; i < ng; ++i) {
    const int64_t* w = groups + i * (2 + 3 * np);
    JoinGroup& g = P.g[i];
    if (w[0] < 0 || w[1] < 0 || g.nslots == 0)
      return (int)cudaErrorInvalidValue;
    g.start = w[0];
    g.count = w[1];
    for (int64_t p = 0; p < np; ++p) {
      const int64_t* q = w + 2 + 3 * p;
      if (q[0] < 0 || q[1] < 0 || q[0] + q[1] > jcap ||
          q[0] + q[1] > INT32_MAX)
        return (int)cudaErrorInvalidValue;
      g.jstart[p] = (int32_t)q[0];
      g.jcount[p] = (int32_t)q[1];
      g.jslot[p] = (int32_t)(q[2] < 0 ? -1 : q[2]);
    }
    const int64_t used = join_modes(g, (int)np, budget);
    if (used < 0) return (int)cudaErrorInvalidValue;
    words = used > words ? used : words;
    total += g.count * g.nslots;
  }
  // the shared memory: the warps' tiles and the largest group's stages
  int64_t smem = (int64_t)J_WARPS * JTile::WARP + 4 * words;
  smem = (smem + SMEM_STEP - 1) / SMEM_STEP * SMEM_STEP;
  if (smem > most) smem = most;
  int limit = 0;
  e = join_resident((int)smem, &limit);
  if (e != cudaSuccess) return (int)e;
  // a group's blocks in proportion to the rows it writes (count x slots),
  // at least one and no more than its rows need
  int32_t at = 0;
  for (int64_t i = 0; i < ng; ++i) {
    JoinGroup& g = P.g[i];
    const int64_t rows_a_pass = (int64_t)JTile::ROWS * J_WARPS;
    const int64_t want = (g.count + rows_a_pass - 1) / rows_a_pass;
    int64_t share = total > 0 ? (int64_t)limit * g.count * g.nslots / total
                              : 1;
    share = share > want ? want : share;
    g.bstart = at;
    at += (int32_t)(share < 1 ? 1 : share);
  }
  P.grid = at;
  const JoinArgs A = {(const int16_t*)feats, (const int32_t*)flags,
                      (const int32_t*)docids, (const uint8_t*)dead,
                      (const int32_t*)jdocids, (const int32_t*)jpos,
                      (const int32_t*)bmtab, (int32_t*)merged,
                      (int32_t*)flags_out, (uint8_t*)valid_out,
                      (uint32_t*)ctr, doc_cap, jcap, nwords};
  join_rows<<<(unsigned)P.grid, J_THREADS, (size_t)smem,
              (cudaStream_t)stream>>>(A, P);
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
//   - `xjoin_probe`, on every cell of the column, one term a launch:
//     a candidate is valid while it is live, below n and passed every
//     earlier term (the reduced contributions `prior`, includes first:
//     found > 0, then excludes: found == 0), as the JAX loop narrows gv
//     term by term. A valid candidate is searched in this cell's window
//     jdocids[lo, lo + cnt) for clip(docid, 0, 2^29); of the valid
//     candidates at or above 2^29 only the last (the largest row) can
//     match, as _membership_sorted's stable co-sort decides. Output int32
//     [5, n], neutral where not found: found (0/1), posintext min
//     (INT32_MAX) and max (-INT32_MAX), hitcount min (INT32_MAX), flags
//     (0). A non-owner cell's window is empty (cnt 0): all neutral, no
//     search.
//   - `xjoin_apply`, on the rare cell: the term-axis-reduced
//     contributions (psum, pmin, pmax, pmin, psum) of every term folded
//     into the rare rows as K8 merges partner rows (worddistance = max -
//     min of posintext, hitcount = min, flags OR'd with the psum), an
//     include missed or an exclude hit invalidates the row, the filter
//     is applied; merged int32 [n, 17], flags int32 [n], valid [n] as K8
//     writes them, so kernels 1-3 follow as in the column-local join.
//     Only the rare row's cells score (the JAX body's axis_index mask):
//     the others hold no candidate.
// Bound: bytes. A probe reads a candidate's docid, the prior words and,
// for a found one, its tombstone byte, its window entry, jpos and the
// partner's 8 B; it writes 20 B. The apply reads the rare rows (34 B of
// features, flags, docid) and 20 B a term, and writes 73 B a row.
//
// The probe's design: the candidates arrive in score order, so each
// search is a random walk down the window (10M entries, 40 MB, in the
// smoke). One launch a call:
//   - a block a tile of XP_THREADS x RPL candidates; each block stages the
//     window in shared memory, whole where it fits in XP_TABLE_WORDS words
//     (K8's PM_STAGED), else as a fence table of every 2^s-th entry, s the
//     least that fits; a search runs in shared memory and ends in device
//     memory in a window of 2^s entries (K8's lower_bound_smem,
//     lower_bound_global), branch-free;
//   - a thread carries RPL candidates through the chain stage by stage,
//     so their loads overlap;
//   - the tombstone byte is read only where it decides the answer: for a
//     found candidate, and for a valid one at or above 2^29;
//   - the main pass writes the rows at or above 2^29 neutral and keeps the
//     largest valid one (its row + 1, by atomicMax) in a word of the
//     call's counters; the last block to finish (an atomic ticket after
//     __threadfence, as join_rows does) searches that row for 2^29 and
//     resets both words for the next call, so no memset precedes it.
// What binds is the device memory's random sectors, not the chain's
// length: the upper steps of a search hit the L2 cache whether they run
// in shared memory or not, the last ones (a window of ~64 entries) miss
// it, and a found candidate then gathers its tombstone byte, jpos, the
// partner's row and flags. So the table stays small: on an H100 a table
// of 256 words (s = 16 at 10M entries) with a block a tile beat 1,024 to
// 32,768 words and a persistent grid of resident blocks (PERF.md).
constexpr int XP_THREADS = J_THREADS;        // a probe block (K8's size:
                                             // block_copy_words)
constexpr int64_t XP_TABLE_WORDS = 256;      // the most a block stages
constexpr int32_t X_BIG = 0x7fffffff;  // the neutral fills' INT32_MAX

// The window's search in a block: staged whole (shift 0) or through a
// fence table of every 2^shift-th entry (tab), the answers' entries b
// (the first >= key) and whether each is found there
__device__ __forceinline__ void xprobe_search(const int32_t* tab,
                                              const int32_t* seg,
                                              int64_t cnt, int shift,
                                              const int32_t* key,
                                              const bool* on, int64_t* b,
                                              bool* f) {
  if (shift == 0) {
    int bi[RPL];
    lower_bound_smem(tab, (int)cnt, key, bi);
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      b[k] = bi[k];
      f[k] = on[k] && bi[k] < cnt && tab[bi[k]] == key[k];
    }
    return;
  }
  // the fence j = the first of every 2^shift-th entry >= the key: the
  // answer lies after fence j - 1, up to fence j
  const int nf = (int)((cnt + (1ll << shift) - 1) >> shift);
  int jf[RPL];
  int64_t w0[RPL], w1[RPL];
  lower_bound_smem(tab, nf, key, jf);
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    w0[k] = jf[k] == 0 ? 0 : ((int64_t)(jf[k] - 1) << shift) + 1;
    const int64_t e = (int64_t)jf[k] << shift;
    w1[k] = jf[k] == 0 ? 0 : (e < cnt ? e : cnt);
  }
  lower_bound_global(seg, 1ll << shift, w0, w1, key, on, b);
  int32_t x[RPL];
#pragma unroll
  for (int k = 0; k < RPL; ++k)
    x[k] = on[k] && b[k] < cnt ? __ldg(seg + b[k]) : -1;
#pragma unroll
  for (int k = 0; k < RPL; ++k) f[k] = on[k] && b[k] < cnt && x[k] == key[k];
}

// K18's probe (head note). seg/jp: the window's jdocids and jpos; shift -1
// for an empty window, 0 staged whole, else the fence stride's log2; ctr:
// the call's two counter words (the largest valid row at or above 2^29 +
// 1, the ticket), zero before the call and left at zero.
__global__ void __launch_bounds__(XP_THREADS, 2)
xjoin_probe(const int32_t* __restrict__ cand, int64_t n,
            const uint8_t* __restrict__ dead, int64_t doc_cap,
            const int32_t* __restrict__ prior, int n_prior, int n_inc,
            const int32_t* __restrict__ seg, const int32_t* __restrict__ jp,
            int64_t cnt, int shift, const int16_t* __restrict__ feats,
            const int32_t* __restrict__ flags, uint32_t* __restrict__ ctr,
            int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char xp_smem[];
  __shared__ int s_last;
  const int t = threadIdx.x;
  const int32_t* tab = reinterpret_cast<const int32_t*>(
      xp_smem + (shift == 0 ? (uintptr_t)seg % 16 : 0));
  if (shift == 0) {
    block_copy_words(xp_smem, seg, cnt, t);
  } else if (shift > 0) {
    int32_t* fz = reinterpret_cast<int32_t*>(xp_smem);
    const int64_t nf = (cnt + (1ll << shift) - 1) >> shift;
    for (int64_t j = t; j < nf; j += XP_THREADS)
      cp_async4(fz + j, seg + (j << shift));
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // the block's tile
  const int64_t base = (int64_t)blockIdx.x * XP_THREADS * RPL;
  int64_t i[RPL];
  int32_t d[RPL];
  bool ok[RPL];
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    i[k] = base + k * XP_THREADS + t;
    d[k] = i[k] < n ? __ldg(cand + i[k]) : -1;
    ok[k] = d[k] >= 0;
  }
  for (int p = 0; p < n_prior; ++p) {
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      if (!ok[k]) continue;
      const int32_t c = __ldg(prior + (int64_t)p * 5 * n + i[k]);
      ok[k] = p < n_inc ? c > 0 : c == 0;
    }
  }
  // a valid row at or above 2^29: its liveness decides whether it is
  // the one the last block searches
  bool on[RPL];
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const bool high = ok[k] && d[k] >= JOIN_DOCID_CAP;
    if (high && !(d[k] < doc_cap && __ldg(dead + d[k])))
      atomicMax(ctr, (uint32_t)(i[k] + 1));
    on[k] = ok[k] && !high && shift >= 0;
  }
  int64_t b[RPL];
  bool f[RPL];
  if (shift >= 0) {
    xprobe_search(tab, seg, cnt, shift, d, on, b, f);
  } else {
#pragma unroll
    for (int k = 0; k < RPL; ++k) f[k] = false, b[k] = 0;
  }
  // a found row's liveness, then its partner row
  int64_t pr[RPL];
#pragma unroll
  for (int k = 0; k < RPL; ++k)
    f[k] = f[k] && !(d[k] < doc_cap && __ldg(dead + d[k]));
#pragma unroll
  for (int k = 0; k < RPL; ++k) pr[k] = f[k] ? __ldg(jp + b[k]) : 0;
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    if (i[k] >= n) continue;
    int32_t pos = X_BIG, pmx = -X_BIG, hit = X_BIG, fl = 0;
    if (f[k]) {
      pos = pmx = __ldg(feats + pr[k] * NF + F_POSINTEXT);
      hit = __ldg(feats + pr[k] * NF + F_HITCOUNT);
      fl = __ldg(flags + pr[k]);
    }
    out[i[k]] = f[k] ? 1 : 0;
    out[n + i[k]] = pos;
    out[2 * n + i[k]] = pmx;
    out[3 * n + i[k]] = hit;
    out[4 * n + i[k]] = fl;
  }
  // the last block searches the largest valid row at or above 2^29 for
  // the clipped key and leaves the counters at zero
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(ctr + 1, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last || t != 0) return;
  __threadfence();
  const uint32_t h = __ldcg(ctr);
  if (h != 0 && shift >= 0) {
    const int64_t r = (int64_t)h - 1;
    int32_t key[RPL];
    bool on[RPL], f[RPL];
    int64_t b[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) key[k] = JOIN_DOCID_CAP, on[k] = k == 0;
    xprobe_search(tab, seg, cnt, shift, key, on, b, f);
    if (f[0]) {
      const int64_t q = __ldg(jp + b[0]);
      out[r] = 1;
      out[n + r] = out[2 * n + r] = __ldg(feats + q * NF + F_POSINTEXT);
      out[3 * n + r] = __ldg(feats + q * NF + F_HITCOUNT);
      out[4 * n + r] = __ldg(flags + q);
    }
  }
  ctr[0] = 0u;
  ctr[1] = 0u;
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

// K18 probe's layout for a window of cnt entries: the search's shift (-1
// none, 0 the window staged whole, else the least fence stride whose
// table fits in XP_TABLE_WORDS words) and the bytes of shared memory it
// takes
static int xprobe_layout(int64_t cnt, int* smem) {
  if (cnt == 0) {
    *smem = 0;
    return -1;
  }
  if (stage_words(PM_STAGED, cnt) <= XP_TABLE_WORDS) {
    *smem = (int)(4 * stage_words(PM_STAGED, cnt));
    return 0;
  }
  int shift = 1;
  while (((cnt + (1ll << shift) - 1) >> shift) > XP_TABLE_WORDS) ++shift;
  *smem = (int)(4 * ((((cnt + (1ll << shift) - 1) >> shift) + 3) & ~3ll));
  return shift;
}

// cand [n] int32 (the rare cell's docids from its span start), dead
// [doc_cap] bool of this cell's device; prior [n_prior, 5, n] int32 (the
// reduced contributions of the earlier terms, includes first, n_inc of
// them at most); jdocids/jpos this cell's join table, the window [lo, lo +
// cnt); feats [*, 17] int16 and flags int32 this cell's arena; ctr two
// uint32, zero before the call and left at zero (one pair a stream); out
// [5, n] int32. One launch.
extern "C" int yt_xjoin_probe(const void* cand, int64_t n, const void* dead,
                              int64_t doc_cap, const void* prior,
                              int n_prior, int n_inc, const void* jdocids,
                              const void* jpos, int64_t lo, int64_t cnt,
                              const void* feats, const void* flags,
                              void* ctr, void* out, void* stream) {
  if (n < 0 || n_prior < 0 || n_inc < 0 || lo < 0 || cnt < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  int smem = 0;
  const int shift = xprobe_layout(cnt, &smem);
  // a block a tile of XP_THREADS x RPL candidates
  const int64_t grid = (n + XP_THREADS * RPL - 1) / (XP_THREADS * RPL);
  if (grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  xjoin_probe<<<(unsigned)grid, XP_THREADS, (size_t)smem,
                (cudaStream_t)stream>>>(
      (const int32_t*)cand, n, (const uint8_t*)dead, doc_cap,
      (const int32_t*)prior, n_prior, n_inc, (const int32_t*)jdocids + lo,
      (const int32_t*)jpos + lo, cnt, shift, (const int16_t*)feats,
      (const int32_t*)flags, (uint32_t*)ctr, (int32_t*)out);
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
