// Shared definitions of the port's CUDA kernels: the posting column
// layout, the packed profile-constant and statistics vectors, the
// order-preserving integer keys the selection kernels sort by, the
// staged row chunks and the row scorer, and the arena extents (with a
// RAM delta as one more source), row liveness, constraint filter, facet
// bitmap and batched-scan wave of the devstore kernels.
//
// Layouts (mirrored in kernels/cardinal.py):
//   consts int32[44]: [0,17) norm coeffs, [17,28) flag bits,
//     [28,39) flag shifts, 39 domlength, 40 tf, 41 language,
//     42 authority, 43 language preference
//   stats  int32[38]: [0,17) col_min, [17,34) col_max, 34 tf_min (f32
//     bits), 35 tf_max (f32 bits), 36 max host count, 37 NaN-seen flag
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace yt {

constexpr int NF = 17;
constexpr int F_LASTMOD = 0;
constexpr int F_WORDS_IN_TITLE = 1;
constexpr int F_WORDS_IN_TEXT = 2;
constexpr int F_LANGUAGE = 5;
constexpr int F_FLAGS = 10;
constexpr int F_HITCOUNT = 11;
constexpr int F_POSINTEXT = 12;
constexpr int F_WORDDISTANCE = 15;
constexpr int F_DOMLENGTH = 16;
constexpr int N_FLAG_TERMS = 11;

constexpr int C_NORM = 0, C_BITS = 17, C_SHIFTS = 28, C_DOMLENGTH = 39,
              C_TF = 40, C_LANGUAGE = 41, C_AUTHORITY = 42, C_LANG_PREF = 43,
              CONSTS_LEN = 44;
constexpr int S_COL_MIN = 0, S_COL_MAX = 17, S_TF_MIN = 34, S_TF_MAX = 35,
              S_HOST_MAX = 36, S_NAN = 37, STATS_LEN = 38;

constexpr int32_t BIG = 2147483647;        // masked-min sentinel
constexpr int32_t SMALL = -2147483647;     // masked-max / invalid score

// columns that carry a normalised contribution (flags, doctype,
// language and domlength have terms of their own) and the direct ones
__host__ __device__ constexpr bool is_active(int c) {
  return c != 4 && c != 5 && c != 10 && c != 16;
}
__host__ __device__ constexpr bool is_direct(int c) {
  return c == 0 || c == 1 || c == 2 || c == 3 || c == 6 || c == 7 || c == 11;
}

// XLA semantics of a shift left: amounts outside [0, 32) give 0; the
// value wraps as two's complement int32.
__device__ __forceinline__ uint32_t shl(uint32_t x, int s) {
  return (s < 0 || s >= 32) ? 0u : (x << s);
}

// floor division for a positive divisor (b >= 1)
__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;
  if ((a % b) != 0 && a < 0) q -= 1;
  return q;
}

// hitcount / (wordsintext + wordsintitle + 1) in IEEE f32, rounded once
template <typename T>
__device__ __forceinline__ float term_frequency(const T* f) {
  int32_t den = (int32_t)f[F_WORDS_IN_TEXT] + (int32_t)f[F_WORDS_IN_TITLE] + 1;
  return __fdiv_rn(__int2float_rn((int32_t)f[F_HITCOUNT]),
                   __int2float_rn(den));
}

// float bits -> signed int ordered like the IEEE total order
// (-NaN < -inf < ... < -0 < +0 < ... < inf < NaN); an involution
__device__ __forceinline__ int32_t float_order(int32_t b) {
  return b >= 0 ? b : (b ^ 0x7fffffff);
}

// ascending unsigned key of a score (int32 or f32 bits)
__device__ __forceinline__ uint32_t asc_key(int32_t s, bool is_float) {
  return (uint32_t)(is_float ? float_order(s) : s) ^ 0x80000000u;
}

// lax.top_k order: descending total order, ties by the secondary key
__device__ __forceinline__ uint32_t topk_hi(int32_t s, bool is_float) {
  return ~asc_key(s, is_float);
}

// tie_topk order: lax.sort ascending on -score. For floats lax.sort
// canonicalises first: -0.0 equals +0.0 and every NaN is one +NaN that
// sorts last; the int32 negation wraps (INT_MIN stays INT_MIN).
__device__ __forceinline__ uint32_t tie_hi(int32_t s, bool is_float) {
  if (!is_float) return asc_key((int32_t)(0u - (uint32_t)s), false);
  int32_t nb = s ^ (int32_t)0x80000000;
  float v = __int_as_float(nb);
  if (v == 0.0f) nb = 0;
  else if (v != v) nb = 0x7fc00000;
  return asc_key(nb, true);
}

__device__ __forceinline__ uint32_t sec_key(int32_t d) {
  return (uint32_t)d ^ 0x80000000u;
}

// ---------------------------------------------------------------------------
// Row chunks staged into shared memory by 16-byte cp.async (kernels 1-2)
// ---------------------------------------------------------------------------

constexpr int CH = 64;  // rows per chunk (two per lane)

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int ES> struct Elem;
template <> struct Elem<1> { using T = uint8_t; };
template <> struct Elem<2> { using T = uint16_t; };
template <> struct Elem<4> { using T = uint32_t; };

// One warp copies the bytes [a, b) (whole elements of ES bytes) so that
// byte x lands at dst + (x - floor16(a)): the 16-byte aligned body by
// cp.async, the ragged head (lanes 0-15) and tail (lanes 16-31) by
// element loads.
template <int ES>
__device__ __forceinline__ void copy_span(unsigned char* dst, uintptr_t a,
                                         uintptr_t b, int lane) {
  using E = typename Elem<ES>::T;
  const uintptr_t a0 = a & ~(uintptr_t)15;
  const uintptr_t body0 = (a + 15) & ~(uintptr_t)15;
  const uintptr_t body1 = b & ~(uintptr_t)15;
  if (body0 < body1) {
    const int chunks = (int)((body1 - body0) >> 4);
    for (int c = lane; c < chunks; c += 32)
      cp_async16(dst + (body0 - a0) + 16 * c,
                 (const void*)(body0 + 16 * (uintptr_t)c));
  }
  const uintptr_t h1 = body0 < b ? body0 : b;
  const uintptr_t t0 = body1 > body0 ? body1 : body0;
  const int nh = (int)((h1 - a) / ES);
  const int nt = b > t0 ? (int)((b - t0) / ES) : 0;
  if (lane < nh)
    *(E*)(dst + (a - a0) + lane * ES) = *(const E*)(a + lane * ES);
  else if (lane >= 16 && lane - 16 < nt)
    *(E*)(dst + (t0 - a0) + (lane - 16) * ES) =
        *(const E*)(t0 + (lane - 16) * ES);
}

// byte sizes of one stage's regions: the span of a chunk plus 16 bytes
// of alignment slack
template <typename T>
__host__ __device__ constexpr int feat_region() {
  return CH * NF * (int)sizeof(T) + 16;
}
constexpr int WORD_REGION = CH * 4 + 16;
constexpr int BYTE_REGION = CH + 16;
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return feat_region<T>() + 2 * WORD_REGION + BYTE_REGION;
}

// One stage of a staged chunk, each array at its start's offset mod 16:
// features, flags (or none), host ids (or none), valid bytes.
template <typename T>
struct Stage {
  const unsigned char *f, *fl, *h, *v;
  __device__ __forceinline__ Stage(const unsigned char* s, const T* feats,
                                   const int32_t* flags,
                                   const int32_t* hostids,
                                   const uint8_t* valid)
      : f(s + (uintptr_t)feats % 16),
        fl(s + feat_region<T>() + (uintptr_t)flags % 16),
        h(s + feat_region<T>() + WORD_REGION + (uintptr_t)hostids % 16),
        v(s + feat_region<T>() + 2 * WORD_REGION + (uintptr_t)valid % 16) {}
  __device__ __forceinline__ const T* row(int j) const {
    return (const T*)(f + j * NF * (int)sizeof(T));
  }
  __device__ __forceinline__ int32_t flag(int j) const {
    return ((const int32_t*)fl)[j];
  }
  __device__ __forceinline__ int32_t host(int j) const {
    return ((const int32_t*)h)[j];
  }
};

// One warp starts the copies of chunk c into stage st (flags, host ids
// and valid bytes only when given). A chunk's bytes start at a multiple of 16 from each
// array's start, so every chunk of an array sits at the same offset (its
// start mod 16) in its region.
template <typename T>
__device__ __forceinline__ void issue_chunk(
    const T* feats, const int32_t* flags, const uint8_t* valid,
    const int32_t* hostids, int64_t n, int64_t c, unsigned char* st,
    int lane) {
  const int64_t r0 = c * CH;
  const int64_t r1 = r0 + CH < n ? r0 + CH : n;
  copy_span<sizeof(T)>(st, (uintptr_t)(feats + r0 * NF),
                       (uintptr_t)(feats + r1 * NF), lane);
  st += feat_region<T>();
  if (flags)
    copy_span<4>(st, (uintptr_t)(flags + r0), (uintptr_t)(flags + r1), lane);
  st += WORD_REGION;
  if (hostids)
    copy_span<4>(st, (uintptr_t)(hostids + r0), (uintptr_t)(hostids + r1),
                 lane);
  st += WORD_REGION;
  if (valid)
    copy_span<1>(st, (uintptr_t)(valid + r0), (uintptr_t)(valid + r1), lane);
}

// ---------------------------------------------------------------------------
// The row scorer of kernel 2, shared with the devstore kernels
// (pruned_tile.cu, span_score in cardinal_score.cu)
// ---------------------------------------------------------------------------

struct ScoreConsts {
  int32_t cmin[NF], span[NF], safe[NF], shift[NF];
  float rcp[NF];
  int32_t c[CONSTS_LEN];
  float tmin, tspan, tden;
  int32_t hmax;
};

// The block's constants in registers, each constant-only subexpression
// folded once. A shift amount outside [0, 32) becomes 32 and the shift a
// clamping funnel shift, which gives 0 there as XLA's shift does; a
// column whose span is 0 gets shift 32 (its term is 0, as when skipped);
// (f - cmin) * 256 is f * 256 + (-cmin * 256) in uint32; a flag bit
// outside [0, 32) tests bit 31 (fl < 0); a flag or language hit adds its
// shl(255, s).
struct RegConsts {
  uint32_t cneg[NF];
  int32_t safe[NF];
  uint32_t shift[NF];
  float rcp[NF];
  double rcp64[NF];
  uint32_t flag_bit[N_FLAG_TERMS], flag_val[N_FLAG_TERMS];
  uint32_t dl_shift, tf_shift, auth_shift, lang_val;
  int32_t lang_pref, hmax;
  float tmin, tspan, tden;
};

__device__ __forceinline__ uint32_t clamp_shift(int32_t s) {
  return (s < 0 || s >= 32) ? 32u : (uint32_t)s;
}

// x << s for s in [0, 32), 0 for s == 32
__device__ __forceinline__ uint32_t shl32(uint32_t x, uint32_t s) {
  return __funnelshift_lc(0u, x, s);
}

__device__ __forceinline__ void load_consts(const ScoreConsts& k,
                                            RegConsts& r) {
#pragma unroll
  for (int c = 0; c < NF; ++c) {
    if (!is_active(c)) continue;
    r.cneg[c] = (0u - (uint32_t)k.cmin[c]) * 256u;
    r.safe[c] = k.safe[c];
    r.shift[c] = k.span[c] == 0 ? 32u : clamp_shift(k.shift[c]);
    r.rcp[c] = k.rcp[c];
    r.rcp64[c] = __ddiv_rn(1.0, (double)k.safe[c]);
  }
#pragma unroll
  for (int j = 0; j < N_FLAG_TERMS; ++j) {
    const int32_t b = k.c[C_BITS + j];
    r.flag_bit[j] = (b < 0 || b >= 32) ? 31u : (uint32_t)b;
    r.flag_val[j] = shl(255u, k.c[C_SHIFTS + j]);
  }
  r.dl_shift = clamp_shift(k.c[C_DOMLENGTH]);
  r.tf_shift = clamp_shift(k.c[C_TF]);
  r.auth_shift = clamp_shift(k.c[C_AUTHORITY]);
  r.lang_val = shl(255u, k.c[C_LANGUAGE]);
  r.lang_pref = k.c[C_LANG_PREF];
  r.hmax = k.hmax;
  r.tmin = k.tmin;
  r.tspan = k.tspan;
  r.tden = k.tden;
}

// Thread t of a block fills its part of the block's constants from the
// statistics int32[38] and the profile int32[44] (threads 0-43 take
// part); the block then syncs and each thread loads them (load_consts).
__device__ __forceinline__ void fill_consts(ScoreConsts& k,
                                            const int32_t* st,
                                            const int32_t* consts, int t) {
  if (t < CONSTS_LEN) k.c[t] = consts[t];
  if (t < NF) {
    int32_t cmin = st[S_COL_MIN + t];
    int32_t span = (int32_t)((uint32_t)st[S_COL_MAX + t] - (uint32_t)cmin);
    int32_t safe = max(span, 1);
    k.cmin[t] = cmin;
    k.span[t] = span;
    k.safe[t] = safe;
    k.rcp[t] = __fdiv_rn(1.0f, __int2float_rn(safe));
    int32_t cc = consts[C_NORM + t];
    k.shift[t] = cc < 0 ? -cc : cc;
  }
  if (t == 0) {
    float tmin = __int_as_float(st[S_TF_MIN]);
    k.tmin = tmin;
    k.tspan = __fsub_rn(__int_as_float(st[S_TF_MAX]), tmin);
    k.tden = fmaxf(k.tspan, 1e-9f);
    k.hmax = st[S_HOST_MAX];
  }
}

// floor(a / d) for 1 <= d < 2^31, rcp = 1.0 / d rounded to nearest: the
// estimate is within one of the floor (head note), the remainder fixes it
__device__ __forceinline__ int32_t floordiv64(int32_t a, int32_t d,
                                              double rcp) {
  long long q = __double2ll_rd(__dmul_rn((double)a, rcp));
  const long long r = (long long)a - q * d;
  q += (r >= d ? 1 : 0) - (r < 0 ? 1 : 0);
  return (int32_t)q;
}

// One row's score with the constants in registers: every float step is
// the first version's intrinsic, every integer step its value mod 2^32.
template <typename T, bool FAST>
__device__ __forceinline__ int32_t score_row(const T* f, int32_t fl,
                                             const RegConsts& k,
                                             bool use_auth,
                                             int32_t count_h) {
  uint32_t score = 0;
#pragma unroll
  for (int c = 0; c < NF; ++c) {
    if (!is_active(c)) continue;
    const int32_t safe = k.safe[c];
    const int32_t prod = (int32_t)((uint32_t)(int32_t)f[c] * 256u + k.cneg[c]);
    int32_t norm;
    if (FAST) {
      int32_t q0 = __float2int_rz(__fmul_rn(__int2float_rn(prod), k.rcp[c]));
      int32_t rem =
          (int32_t)((uint32_t)prod - (uint32_t)q0 * (uint32_t)safe);
      norm = q0 + (rem >= safe ? 1 : 0) - (rem < 0 ? 1 : 0);
    } else {
      norm = floordiv64(prod, safe, k.rcp64[c]);
    }
    uint32_t contrib = is_direct(c) ? (uint32_t)norm : 256u - (uint32_t)norm;
    score += shl32(contrib, k.shift[c]);
  }
  score += shl32(256u - (uint32_t)(int32_t)f[F_DOMLENGTH], k.dl_shift);

  if (k.tspan > 0.0f) {
    float tf = term_frequency(f);
    float x = __fdiv_rn(__fmul_rn(__fsub_rn(tf, k.tmin), 256.0f), k.tden);
    score += shl32((uint32_t)__float2int_rz(x), k.tf_shift);
  }

  if ((int32_t)f[F_LANGUAGE] == k.lang_pref) score += k.lang_val;

#pragma unroll
  for (int j = 0; j < N_FLAG_TERMS; ++j)
    score += (((uint32_t)fl >> k.flag_bit[j]) & 1u) * k.flag_val[j];

  if (use_auth) {
    int32_t a = floordiv((int32_t)((uint32_t)count_h << 8), 1 + k.hmax);
    score += shl32((uint32_t)a, k.auth_shift);
  }
  return (int32_t)score;
}

// ---------------------------------------------------------------------------
// Arena extents read in place, and a RAM delta block (the devstore kernels)
// ---------------------------------------------------------------------------

constexpr int MAX_EXT = 8;              // DeviceSegmentStore.MAX_SPANS
constexpr int MAX_SRC = MAX_EXT + 1;    // the extents, then a RAM delta

// Up to MAX_EXT arena extents and an optional RAM delta block, read in
// place as one row sequence in source order: row r of source e is row
// obase[e] + r of the sequence, and CH-row chunk c of the sequence is
// chunk c - cbase[e] of source e (cbase[n] chunks, obase[n] rows in all).
// Each source has its own feature, flag and docid pointers: an extent's
// point into the arena at its first row, the delta's at its own block,
// so the delta is read after the extents and is never copied into the
// arena.
struct Extents {
  const int16_t* feats[MAX_SRC];
  const int32_t* flags[MAX_SRC];
  const int32_t* docids[MAX_SRC];
  int64_t count[MAX_SRC], obase[MAX_SRC + 1], cbase[MAX_SRC + 1];
  int n;
};

__host__ __device__ inline void add_source(Extents& x, const int16_t* f,
                                           const int32_t* fl,
                                           const int32_t* d, int64_t n) {
  const int e = x.n++;
  x.feats[e] = f;
  x.flags[e] = fl;
  x.docids[e] = d;
  x.count[e] = n;
  x.obase[e + 1] = x.obase[e] + n;
  x.cbase[e + 1] = x.cbase[e] + (n + CH - 1) / CH;
}

// The arena's n (start, count) pairs ext (host memory), then the delta
// block of dn rows when dn > 0 (dfeats [dn, 17] int16, dflags/ddocids
// [dn] int32). flags may be null (never staged then).
__host__ inline Extents make_extents(const void* feats, const void* flags,
                                     const void* docids, const int64_t* ext,
                                     int n, const void* dfeats,
                                     const void* dflags, const void* ddocids,
                                     int64_t dn) {
  Extents x = {};
  const int16_t* f = (const int16_t*)feats;
  const int32_t* fl = (const int32_t*)flags;
  const int32_t* d = (const int32_t*)docids;
  for (int e = 0; e < n; ++e) {
    const int64_t s = ext[2 * e];
    add_source(x, f + s * NF, fl ? fl + s : nullptr, d + s, ext[2 * e + 1]);
  }
  if (dn > 0)
    add_source(x, (const int16_t*)dfeats, (const int32_t*)dflags,
               (const int32_t*)ddocids, dn);
  return x;
}

// the source of chunk c < cbase[n] (empty sources are skipped)
__device__ __forceinline__ int extent_of_chunk(const Extents& x, int64_t c) {
  int e = 0;
  while (e + 1 < x.n && c >= x.cbase[e + 1]) ++e;
  return e;
}

// the docid of sequence row r, or -1 past the last source
__device__ __forceinline__ int32_t docid_at(const Extents& x, int64_t r) {
  for (int e = 0; e < x.n; ++e)
    if (r < x.obase[e + 1]) return x.docids[e][r - x.obase[e]];
  return -1;
}

// One warp starts the copies of sequence chunk c into stage st: the
// source's features, flags (when with_flags) and docids (in the host-id
// region).
__device__ __forceinline__ void issue_extent_chunk(const Extents& x,
                                                   int64_t c, bool with_flags,
                                                   unsigned char* st,
                                                   int lane) {
  const int e = extent_of_chunk(x, c);
  issue_chunk<int16_t>(x.feats[e], with_flags ? x.flags[e] : nullptr,
                       nullptr, x.docids[e], x.count[e], c - x.cbase[e], st,
                       lane);
}

// Liveness of an arena row (devstore _tile_valid): a docid (pad rows hold
// -1) that is not tombstoned. Docids at or past the bitmap are alive: it
// grows to cover every tombstone.
__device__ __forceinline__ bool row_live(int32_t d, const uint8_t* dead,
                                         int64_t doc_cap) {
  return d >= 0 && !(d < doc_cap && dead[d]);
}

// A query's constraint filter (devstore _constraint_valid): a language,
// one content-domain flag bit and a lastmod range in days, each off at
// its sentinel (NO_LANG 0, NO_FLAG -1, DAYS_NONE_LO -2^30, DAYS_NONE_HI
// 2^30); and a facet docid bitmap (_bitmap_member: `allow` words of 32
// docids, `nbits` = 32 x its words; null: none). Passed by value in the
// launch parameters.
struct Filter {
  int32_t lang, flag, from_days, to_days;
  const uint32_t* allow;
  int64_t nbits;
};
constexpr int32_t NO_LANG = 0, NO_FLAG = -1;
constexpr int32_t DAYS_NONE_LO = -(1 << 30), DAYS_NONE_HI = 1 << 30;

// the filter of 4 int32 in host memory, with a bitmap of nwords words or
// none (allow null)
__host__ inline Filter make_filter(const int32_t* filt, const void* allow,
                                   int64_t nwords) {
  Filter q = {filt[0], filt[1], filt[2], filt[3], (const uint32_t*)allow,
              allow ? nwords * 32 : 0};
  return q;
}

__host__ __device__ inline bool filter_off(const Filter& q) {
  return q.lang == NO_LANG && q.flag == NO_FLAG &&
         q.from_days == DAYS_NONE_LO && q.to_days == DAYS_NONE_HI &&
         q.allow == nullptr;
}

// Whether a row passes the constraints, from its language and lastmod
// columns and its flags. The flag test is XLA's (fl >> max(bit, 0)) & 1
// on int32: an arithmetic shift, so a bit of 32 or more reads the sign
// (bit 31).
__device__ __forceinline__ bool constraint_ok(int32_t lang, int32_t lastmod,
                                              int32_t fl, const Filter& q) {
  const int b = q.flag < 0 ? 0 : (q.flag > 31 ? 31 : q.flag);
  return (q.lang == NO_LANG || lang == q.lang) &&
         (q.flag == NO_FLAG || ((fl >> b) & 1)) &&
         (q.from_days == DAYS_NONE_LO || lastmod >= q.from_days) &&
         (q.to_days == DAYS_NONE_HI || lastmod <= q.to_days);
}

// The facet bitmap's bit of a live row's docid d >= 0; a docid at or past
// the bitmap is excluded.
__device__ __forceinline__ bool bitmap_ok(int32_t d, const Filter& q) {
  return q.allow == nullptr ||
         (d < q.nbits && ((__ldg(q.allow + (d >> 5)) >> (d & 31)) & 1u));
}

// The whole filter on a live row (features f, flags fl, docid d).
__device__ __forceinline__ bool row_passes(const int16_t* f, int32_t fl,
                                           int32_t d, const Filter& q) {
  return constraint_ok(f[F_LANGUAGE], f[F_LASTMOD], fl, q) && bitmap_ok(d, q);
}

constexpr int BATCH_SLOTS = 16;

// A wave whose slots are regions of one set of buffers (the batched
// join's kernels 1 and 2): slot s's n[s] rows from row off[s], taken by
// the grid's blocks [bstart[s], bstart[s + 1]) (split_blocks).
struct Regions {
  int64_t off[BATCH_SLOTS + 1], n[BATCH_SLOTS];
  int32_t bstart[BATCH_SLOTS + 1];
  int32_t bs;
};

// The range of `bs` block ranges (bstart[0..bs]) that holds block blk.
__device__ __forceinline__ int range_of_block(const int32_t* bstart, int bs,
                                              int blk) {
  int s = 0;
  while (s + 1 < bs && blk >= bstart[s + 1]) ++s;
  return s;
}

// Cut a grid of at most `limit` blocks, a block taking `per_block` units
// (rows, or chunks) a pass, into one range a slot of `rows[s]` units, in
// proportion to them, at least one block a slot and no more than its
// units need; fills bstart[0..bs] and returns the grid's blocks.
__host__ inline int split_blocks(const int64_t* rows, int bs,
                                 int64_t per_block, int limit,
                                 int32_t* bstart) {
  int64_t total = 0;
  for (int s = 0; s < bs; ++s) total += rows[s];
  bstart[0] = 0;
  for (int s = 0; s < bs; ++s) {
    const int64_t want = (rows[s] + per_block - 1) / per_block;
    int64_t share = total > 0 ? (int64_t)limit * rows[s] / total : 1;
    if (share > want) share = want;
    if (share < 1) share = 1;
    bstart[s + 1] = bstart[s] + (int32_t)share;
  }
  return bstart[bs];
}

// A Regions wave from bs + 1 region starts and bs row counts in host
// memory (each region at least its rows); false where malformed.
__host__ inline bool regions_of(const int64_t* off, const int64_t* n, int bs,
                                Regions* g) {
  if (bs < 1 || bs > BATCH_SLOTS || off[0] != 0) return false;
  for (int s = 0; s < bs; ++s) {
    if (n[s] < 0 || off[s + 1] - off[s] < n[s]) return false;
    g->n[s] = n[s];
  }
  for (int s = 0; s <= bs; ++s) g->off[s] = off[s];
  g->bs = bs;
  return true;
}

// A wave of exact scans (the batched scan): up to BATCH_SLOTS queries
// over the same arena, each with its own extents and constraint filter
// (no delta, no bitmap: those queries stay solo), by value in the launch
// parameters. A one-dimensional grid is cut into one block range a slot,
// [bstart[s], bstart[s + 1]), its length in proportion to the slot's rows
// (wave_blocks), so that a wave of one big and many small scans keeps
// every block busy until the big one is done. The batched K7 writes slot
// s into [obase[s], obase[s + 1]) of one packed buffer (each slot's own
// length, kernels/devstore.scan_batch_offsets).
struct ScanBatch {
  int32_t start[BATCH_SLOTS][MAX_EXT], count[BATCH_SLOTS][MAX_EXT];
  int32_t n[BATCH_SLOTS];
  int32_t filt[BATCH_SLOTS][4];
  int32_t bstart[BATCH_SLOTS + 1];
  int64_t obase[BATCH_SLOTS + 1];
  int32_t bs;
};

// The extents and filter of slot s of a wave over the arena.
__host__ __device__ inline void slot_extents(const ScanBatch& b, int s,
                                             const int16_t* feats,
                                             const int32_t* flags,
                                             const int32_t* docids,
                                             Extents& x, Filter& q) {
  x.n = 0;
  x.obase[0] = x.cbase[0] = 0;
  for (int e = 0; e < b.n[s]; ++e) {
    const int64_t st = b.start[s][e];
    add_source(x, feats + st * NF, flags + st, docids + st, b.count[s][e]);
  }
  q.lang = b.filt[s][0];
  q.flag = b.filt[s][1];
  q.from_days = b.filt[s][2];
  q.to_days = b.filt[s][3];
  q.allow = nullptr;
  q.nbits = 0;
}

// A wave's slots in host memory, SLOT_DESC_WORDS int32 a slot: the
// extent count n (<= 8), 8 (start, count) pairs, the filter's 4 int32
// (kernels/devstore.scan_batch_desc). Fills b and, with `out_off` (bs + 1
// int64 region starts of the batched K7's packed output, from 0), its
// obase; false on a malformed slot or a region shorter than its rows.
constexpr int SLOT_DESC_WORDS = 1 + 2 * MAX_EXT + 4;
__host__ inline bool scan_batch_of(const int32_t* slots, int bs, ScanBatch* b,
                                   const int64_t* out_off = nullptr) {
  for (int s = 0; s < bs; ++s) {
    const int32_t* w = slots + (int64_t)s * SLOT_DESC_WORDS;
    if (w[0] < 0 || w[0] > MAX_EXT) return false;
    b->n[s] = w[0];
    int64_t rows = 0;
    for (int e = 0; e < MAX_EXT; ++e) {
      b->start[s][e] = w[1 + 2 * e];
      b->count[s][e] = w[2 + 2 * e];
      if (e < w[0]) {
        if (w[1 + 2 * e] < 0 || w[2 + 2 * e] < 0) return false;
        rows += w[2 + 2 * e];
      }
    }
    for (int k = 0; k < 4; ++k) b->filt[s][k] = w[1 + 2 * MAX_EXT + k];
    if (out_off != nullptr &&
        (out_off[0] != 0 || out_off[s + 1] - out_off[s] < rows))
      return false;
  }
  for (int s = 0; s <= bs && out_off != nullptr; ++s)
    b->obase[s] = out_off[s];
  b->bs = bs;
  return true;
}

// Cut a grid of at most `limit` blocks (`warps` warps of one CH-row chunk
// each a block) into the wave's slot ranges, in proportion to each slot's
// chunks and at least one block a slot; returns the grid's blocks.
__host__ inline int wave_blocks(ScanBatch* b, int warps, int limit) {
  int64_t chunks[BATCH_SLOTS];
  for (int s = 0; s < b->bs; ++s) {
    chunks[s] = 0;
    for (int e = 0; e < b->n[s]; ++e)
      chunks[s] += (b->count[s][e] + CH - 1) / CH;
  }
  return split_blocks(chunks, b->bs, warps, limit, b->bstart);
}

// How many blocks of `kernel` (threads, smem dynamic bytes) the card holds
// at once: occupancy times SMs, cached per device in cache[64] after the
// first call, which also raises the kernel's dynamic shared-memory limit.
template <typename K>
__host__ cudaError_t resident_blocks(K kernel, int threads, int smem,
                                     int* cache, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int limit = dev >= 0 && dev < 64 ? cache[dev] : 0;
  if (limit <= 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    limit = (per_sm < 1 ? 1 : per_sm) * sms;
    if (dev >= 0 && dev < 64) cache[dev] = limit;
  }
  *out = limit;
  return cudaSuccess;
}

}  // namespace yt
