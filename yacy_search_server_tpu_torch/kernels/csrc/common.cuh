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
__device__ __forceinline__ float term_frequency_of(int32_t hitcount,
                                                   int32_t words_in_text,
                                                   int32_t words_in_title) {
  int32_t den = words_in_text + words_in_title + 1;
  return __fdiv_rn(__int2float_rn(hitcount), __int2float_rn(den));
}
template <typename T>
__device__ __forceinline__ float term_frequency(const T* f) {
  return term_frequency_of((int32_t)f[F_HITCOUNT],
                           (int32_t)f[F_WORDS_IN_TEXT],
                           (int32_t)f[F_WORDS_IN_TITLE]);
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
// the first version's intrinsic, every integer step its value mod 2^32,
// so the terms add up in any order. It is the terms that read the
// statistics (stats_terms: the normalised columns, each norm_term, and
// the tf term of term frequency `tf`), the ones that read only the
// profile's constants (profile_terms: domlength, the language match, the
// flags; the same for every slot of a batched scan's wave) and the
// authority term.
template <bool FAST>
__device__ __forceinline__ uint32_t norm_term(int c, int32_t v,
                                              const RegConsts& k) {
  const int32_t safe = k.safe[c];
  const int32_t prod = (int32_t)((uint32_t)v * 256u + k.cneg[c]);
  int32_t norm;
  if (FAST) {
    int32_t q0 = __float2int_rz(__fmul_rn(__int2float_rn(prod), k.rcp[c]));
    int32_t rem = (int32_t)((uint32_t)prod - (uint32_t)q0 * (uint32_t)safe);
    norm = q0 + (rem >= safe ? 1 : 0) - (rem < 0 ? 1 : 0);
  } else {
    norm = floordiv64(prod, safe, k.rcp64[c]);
  }
  uint32_t contrib = is_direct(c) ? (uint32_t)norm : 256u - (uint32_t)norm;
  return shl32(contrib, k.shift[c]);
}

__device__ __forceinline__ uint32_t tf_term(float tf, const RegConsts& k) {
  if (!(k.tspan > 0.0f)) return 0u;
  float x = __fdiv_rn(__fmul_rn(__fsub_rn(tf, k.tmin), 256.0f), k.tden);
  return shl32((uint32_t)__float2int_rz(x), k.tf_shift);
}

template <typename T, bool FAST>
__device__ __forceinline__ uint32_t stats_terms(const T* f,
                                                const RegConsts& k,
                                                float tf) {
  uint32_t score = 0;
#pragma unroll
  for (int c = 0; c < NF; ++c)
    if (is_active(c)) score += norm_term<FAST>(c, (int32_t)f[c], k);
  return score + tf_term(tf, k);
}

__device__ __forceinline__ uint32_t profile_terms(int32_t domlength,
                                                  int32_t lang, int32_t fl,
                                                  const RegConsts& k) {
  uint32_t score = shl32(256u - (uint32_t)domlength, k.dl_shift);
  if (lang == k.lang_pref) score += k.lang_val;
#pragma unroll
  for (int j = 0; j < N_FLAG_TERMS; ++j)
    score += (((uint32_t)fl >> k.flag_bit[j]) & 1u) * k.flag_val[j];
  return score;
}

template <typename T, bool FAST>
__device__ __forceinline__ int32_t score_row(const T* f, int32_t fl,
                                             const RegConsts& k,
                                             bool use_auth,
                                             int32_t count_h) {
  // the tf term reads the row's term frequency only where it counts
  uint32_t score = stats_terms<T, FAST>(
      f, k, k.tspan > 0.0f ? term_frequency(f) : 0.0f);
  score += profile_terms((int32_t)f[F_DOMLENGTH], (int32_t)f[F_LANGUAGE], fl,
                         k);
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
template <typename T>
__device__ __forceinline__ bool row_passes(const T* f, int32_t fl, int32_t d,
                                           const Filter& q) {
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
// parameters.
//
// The batched K6 and K7 read a wave by groups: slots whose extent lists
// are identical form a group (group_slots; slots of different lists are
// separate groups, even where their extents overlap), and the blocks of
// [gbstart[g], gbstart[g + 1]) stream group g's rows once for all of its
// slots (group_blocks: each group's range in proportion to its rows).
// Group g's slots are gslot[gfirst[g]] .. gslot[gfirst[g + 1] - 1], in
// wave order; glist[g] is its first list in K7's scratch.
//
// The K7 that writes scores (span_score_batch, the route above K7's
// fused selection) cuts the grid into one block range a slot,
// [bstart[s], bstart[s + 1]) (wave_blocks), and writes slot s into
// [obase[s], obase[s + 1]) of one packed buffer (each slot's own length,
// kernels/devstore.scan_batch_offsets).
struct ScanBatch {
  int32_t start[BATCH_SLOTS][MAX_EXT], count[BATCH_SLOTS][MAX_EXT];
  int32_t n[BATCH_SLOTS];
  int32_t filt[BATCH_SLOTS][4];
  int32_t bstart[BATCH_SLOTS + 1];
  int64_t obase[BATCH_SLOTS + 1];
  int32_t bs;
  int32_t ng;
  int32_t gfirst[BATCH_SLOTS + 1], gslot[BATCH_SLOTS];
  int32_t gbstart[BATCH_SLOTS + 1];
  int64_t glist[BATCH_SLOTS + 1];
};

// The filter of slot s of a wave.
__host__ __device__ inline void slot_filter(const ScanBatch& b, int s,
                                            Filter& q) {
  q.lang = b.filt[s][0];
  q.flag = b.filt[s][1];
  q.from_days = b.filt[s][2];
  q.to_days = b.filt[s][3];
  q.allow = nullptr;
  q.nbits = 0;
}

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
  slot_filter(b, s, q);
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

__host__ inline bool same_extents(const ScanBatch& b, int s, int t) {
  if (b.n[s] != b.n[t]) return false;
  for (int e = 0; e < b.n[s]; ++e)
    if (b.start[s][e] != b.start[t][e] || b.count[s][e] != b.count[t][e])
      return false;
  return true;
}

// The wave's groups: slots of identical extent lists, at most gmax a
// group (a larger set of such slots is cut into groups of gmax in wave
// order), the groups in the order of their first slots.
__host__ inline void group_slots(ScanBatch* b, int gmax) {
  bool taken[BATCH_SLOTS] = {};
  int ng = 0, k = 0;
  b->gfirst[0] = 0;
  for (int s = 0; s < b->bs; ++s) {
    if (taken[s]) continue;
    int in = 0;
    for (int t = s; t < b->bs; ++t) {
      if (taken[t] || !same_extents(*b, s, t)) continue;
      if (in == gmax) {
        b->gfirst[++ng] = k;
        in = 0;
      }
      b->gslot[k++] = t;
      taken[t] = true;
      ++in;
    }
    b->gfirst[++ng] = k;
  }
  b->ng = ng;
}

// The CH-row chunks of slot s's extents.
__host__ inline int64_t slot_chunks(const ScanBatch& b, int s) {
  int64_t c = 0;
  for (int e = 0; e < b.n[s]; ++e) c += (b.count[s][e] + CH - 1) / CH;
  return c;
}

// Cut a grid of at most `limit` blocks (`per_block` chunks a block a
// step) into the groups' ranges gbstart, in proportion to each group's
// chunks, at least one block a group; returns the grid's blocks.
__host__ inline int group_blocks(ScanBatch* b, int per_block, int limit) {
  int64_t chunks[BATCH_SLOTS];
  for (int g = 0; g < b->ng; ++g)
    chunks[g] = slot_chunks(*b, b->gslot[b->gfirst[g]]);
  return split_blocks(chunks, b->ng, per_block, limit, b->gbstart);
}

// ---------------------------------------------------------------------------
// A group block's row stream (the batched K6 and K7)
// ---------------------------------------------------------------------------
// A block of G_WARPS warps walks its group's row sequence (the Extents of
// the group's slots) in steps of NCH chunks: step i takes the sequence
// chunks (i * blocks + block) * NCH + u, u < NCH, warp u staging chunk u
// into its region of the step's stage (NST stages, so NST - 1 steps are
// in flight), as the single-slot passes stage theirs, but by cp.async
// alone (issue_group_chunk). Step i's rows are taken in step i - 1 by
// the warp that staged them (facts_begin before that step's items,
// facts_end after them): each row's liveness (its tombstone byte, whose
// load runs under the items) and term frequency once for every slot of
// the group, and for K7 the profile's terms of its score, into the step's
// parity of a double buffer; so one barrier a step suffices.
// The block's warps then take the step's (slot, 32-row group) items,
// slot-major, in equal contiguous shares (item_range): a warp serves at
// most two slots a step.
constexpr int G_WARPS = 16;
constexpr int G_THREADS = G_WARPS * 32;

// A stage of an extent chunk: features, flags and docids, no valid bytes.
constexpr int EXT_STAGE_BYTES = feat_region<int16_t>() + 2 * WORD_REGION;

// cp.async of the 16 bytes at src, of which only the first n are read
// (the rest of the destination is zero-filled)
__device__ __forceinline__ void cp_async16_n(void* smem_dst, const void* src,
                                             uint32_t n) {
  unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

// copy_span by 16-byte cp.async alone, so that no load of the copy holds
// the warp: from floor16(a) (bytes of the same allocation, which starts
// on 16 bytes), the last copy reading only up to b. The region holds the
// copy: a chunk's bytes start at its array's start mod 16.
__device__ __forceinline__ void copy_span_async(unsigned char* dst,
                                                uintptr_t a, uintptr_t b,
                                                int lane) {
  if (a >= b) return;
  const uintptr_t a0 = a & ~(uintptr_t)15;
  const int n16 = (int)((b - a0 + 15) >> 4);
  for (int c = lane; c < n16; c += 32) {
    const uintptr_t s = a0 + 16 * (uintptr_t)c;
    cp_async16_n(dst + 16 * c, (const void*)s,
                 b - s >= 16 ? 16u : (uint32_t)(b - s));
  }
}

// One warp starts the copies of the group sequence's chunk c into stage
// st (features, flags where with_flags, docids), asynchronously alone.
__device__ __forceinline__ void issue_group_chunk(const Extents& x,
                                                  int64_t c, bool with_flags,
                                                  unsigned char* st,
                                                  int lane) {
  const int e = extent_of_chunk(x, c);
  const int64_t r0 = (c - x.cbase[e]) * CH;
  const int64_t r1 = r0 + CH < x.count[e] ? r0 + CH : x.count[e];
  copy_span_async(st, (uintptr_t)(x.feats[e] + r0 * NF),
                  (uintptr_t)(x.feats[e] + r1 * NF), lane);
  st += feat_region<int16_t>();
  if (with_flags)
    copy_span_async(st, (uintptr_t)(x.flags[e] + r0),
                    (uintptr_t)(x.flags[e] + r1), lane);
  copy_span_async(st + WORD_REGION, (uintptr_t)(x.docids[e] + r0),
                  (uintptr_t)(x.docids[e] + r1), lane);
}

// Lane l of a warp takes rows 2l and 2l + 1 of a chunk (the 32-row group
// of a parity): an int16 row is 8.5 words, so rows two apart are 17 words
// apart and the 32 lanes read 32 banks. Row 2l + m's facts sit at entry
// 32m + l of its chunk's.
//
// What the facts of a step hold: each row's tf bits, DEAD_ROW where
// the row is past its source or dead (a signalling NaN: term_frequency's
// NaN is the canonical quiet one), and (BASE) its profile terms; each
// chunk's source (-1 past the rows) and its first row's place in the
// slot's extent order.
constexpr int32_t DEAD_ROW = 0x7f800001;
template <int NCH, bool BASE>
struct StepFacts {
  int32_t tfb[NCH * CH];
  uint32_t base[BASE ? NCH * CH : 1];
  int32_t e[NCH];
  int64_t pos0[NCH];
};

// The tombstone bytes of a warp's rows (1: the row is past its source
// or dead), loaded by facts_begin and read by facts_end, so that the
// loads' latency runs under the step's items.
struct RowsPending {
  uint32_t gone[CH / 32];
};

// Warp u's facts of sequence chunk c staged at `st` (the profile's terms
// where BASE and `pre`, from its constants pk): everything but the
// liveness, which facts_end adds.
template <int NCH, bool BASE>
__device__ __forceinline__ RowsPending facts_begin(
    const Extents& x, int64_t c, const unsigned char* st,
    const uint8_t* __restrict__ dead, int64_t doc_cap, bool pre,
    const RegConsts& pk, StepFacts<NCH, BASE>& sf, int u, int lane) {
  int e = -1, n = 0;
  int64_t p0 = 0;
  if (c < x.cbase[x.n]) {
    e = extent_of_chunk(x, c);
    const int64_t r0 = (c - x.cbase[e]) * CH;
    n = (int)(x.count[e] - r0 < CH ? x.count[e] - r0 : CH);
    p0 = x.obase[e] + r0;
  }
  RowsPending p;
#pragma unroll
  for (int m = 0; m < CH / 32; ++m) {
    const int j = 2 * lane + m;
    int32_t tb = DEAD_ROW;
    uint32_t bs = 0;
    p.gone[m] = 1u;
    if (j < n) {
      const Stage<int16_t> sg(st, x.feats[e], x.flags[e], x.docids[e],
                              nullptr);
      const int32_t d = sg.host(j);
      if (d >= 0) p.gone[m] = d < doc_cap ? __ldg(dead + d) : 0u;
      const int16_t* f = sg.row(j);
      tb = __float_as_int(term_frequency(f));
      if (BASE && pre)
        bs = profile_terms(f[F_DOMLENGTH], f[F_LANGUAGE], sg.flag(j), pk);
    }
    sf.tfb[u * CH + 32 * m + lane] = tb;
    if (BASE && pre) sf.base[u * CH + 32 * m + lane] = bs;
  }
  if (lane == 0) {
    sf.e[u] = e;
    sf.pos0[u] = p0;
  }
  return p;
}

// The liveness of the rows facts_begin took (row_live's rule).
template <int NCH, bool BASE>
__device__ __forceinline__ void facts_end(const RowsPending& p,
                                          StepFacts<NCH, BASE>& sf, int u,
                                          int lane) {
#pragma unroll
  for (int m = 0; m < CH / 32; ++m)
    if (p.gone[m]) sf.tfb[u * CH + 32 * m + lane] = DEAD_ROW;
}

// Warp w's share [lo, hi) of `items` step items among G_WARPS warps.
__device__ __forceinline__ void item_range(int items, int w, int& lo,
                                           int& hi) {
  lo = w * items / G_WARPS;
  hi = (w + 1) * items / G_WARPS;
}

// ---------------------------------------------------------------------------
// The kk best rows of a scan kept in the pass (the batched K7's and
// K7bp's selection)
// ---------------------------------------------------------------------------
// The order is the JAX merge's: score descending, then the row's place in
// its scan ascending, as one 64-bit key a row (score ^ 2^31 above, the
// place's complement below: a larger key ranks first; every key is
// distinct, so the order is total and the answer does not depend on which
// block finishes first). Rows at or below -(2^31-1) are never kept: the
// JAX merge ranks them after its init entries (-(2^31-1), -1), which is
// what a scan of fewer rows gets in their place.
//   - a block holds for each of its G slots a sorted
//     list of KL keys (KL = the power of two at or above kk) and a buffer
//     of candidates in shared memory (slot k's at lists + k * LW: the
//     list, then the buffer), and a threshold: the list's kk-th key. A row
//     whose key is above it is appended to the buffer (append_key: one
//     shared atomic a warp). A buffer that another step could overfill is
//     sorted (bitonic) and merged into the list (flush_cands): the list
//     becomes the best KL of both (the maximum of the list and the
//     reversed buffer element by element, a bitonic sequence, then a
//     bitonic merge), and the threshold rises;
//   - at the end each block's lists go to a scratch in device memory and
//     the blocks merge them pairwise up a tree (merge_tree): of the two
//     blocks of a pair, the second to arrive (an atomic ticket after a
//     fence, as in cardinal_stats) merges its partner's lists into its own
//     and goes up; the one that merges at the root holds the answer;
//   - the tickets live in a buffer of the caller that every call leaves
//     at zero (the second of a pair resets its ticket): TREE_WORDS a block.
using u64 = unsigned long long;
constexpr int FUSED_KK = 2048;      // the largest kk the selection takes
constexpr int TREE_WORDS = 16;      // ticket words a block (tree levels)

__device__ __forceinline__ u64 row_key(int32_t score, int64_t pos) {
  return ((u64)((uint32_t)score ^ 0x80000000u) << 32) |
         (u64)(~(uint32_t)pos);
}

// The score and place of a kept key.
__device__ __forceinline__ int32_t key_score(u64 key) {
  return (int32_t)((uint32_t)(key >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int64_t key_place(u64 key) {
  return (int64_t)(~(uint32_t)key);
}

// The lanes of a warp whose `c` holds append their keys to a slot's
// buffer, one shared atomic for the warp.
__device__ __forceinline__ void append_key(bool c, u64 key, u64* cand,
                                           int* cnt, int lane) {
  const unsigned m = __ballot_sync(0xffffffffu, c);
  if (m == 0u) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(cnt, __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (c) cand[base + __popc(m & ((1u << lane) - 1u))] = key;
}

// Every thread of the block calls these.

// pair i of p in a bitonic stage of stride h (a power of two)
__device__ __forceinline__ int pair_lo(int p, int h) {
  return ((p & ~(h - 1)) << 1) | (p & (h - 1));
}

// Sort the first `size` candidates (a power of two) of each slot in
// `need` descending.
__device__ inline void sort_cands(u64* lists, int LW, int KL, int G,
                                  unsigned need, int size) {
  const int t = threadIdx.x, half = size >> 1;
  for (int len = 2; len <= size; len <<= 1)
    for (int h = len >> 1; h > 0; h >>= 1) {
      for (int i2 = t; i2 < G * half; i2 += blockDim.x) {
        const int k = i2 / half, i = pair_lo(i2 - k * half, h);
        if (!((need >> k) & 1u)) continue;
        u64* c = lists + k * LW + KL;
        const u64 a = c[i], z = c[i + h];
        if ((a < z) == ((i & len) == 0)) {
          c[i] = z;
          c[i + h] = a;
        }
      }
      __syncthreads();
    }
}

// Each slot k in `need`: its list becomes the best KL keys of the list
// and of src + k * sstride (n keys sorted descending, 0 past them; in
// device memory where GLOBAL), sorted descending.
template <bool GLOBAL>
__device__ inline void merge_top(u64* lists, int LW, int KL, int G,
                                 unsigned need, const u64* src,
                                 int64_t sstride, int n) {
  const int t = threadIdx.x;
  for (int i2 = t; i2 < G * KL; i2 += blockDim.x) {
    const int k = i2 / KL, i = i2 - k * KL;
    if (!((need >> k) & 1u)) continue;
    const int xx = KL - 1 - i;
    u64 o = 0;
    if (xx < n) {
      const u64* p = src + k * sstride + xx;
      o = GLOBAL ? __ldcg(p) : *p;
    }
    u64* L = lists + k * LW;
    if (o > L[i]) L[i] = o;
  }
  __syncthreads();
  const int half = KL >> 1;
  for (int h = half; h > 0; h >>= 1) {
    for (int i2 = t; i2 < G * half; i2 += blockDim.x) {
      const int k = i2 / half, i = pair_lo(i2 - k * half, h);
      if (!((need >> k) & 1u)) continue;
      u64* L = lists + k * LW;
      const u64 a = L[i], z = L[i + h];
      if (a < z) {
        L[i] = z;
        L[i + h] = a;
      }
    }
    __syncthreads();
  }
}

// Merge the candidates of each slot in `need` into its list; its
// threshold becomes the list's kk-th key and its buffer empty.
__device__ inline void flush_cands(u64* lists, int LW, int KL, int kk, int G,
                                   unsigned need, int* s_cnt, u64* s_thr) {
  const int t = threadIdx.x;
  int most = 1;
  for (int k = 0; k < G; ++k)
    if ((need >> k) & 1u) most = s_cnt[k] > most ? s_cnt[k] : most;
  int size = 1;
  while (size < most) size <<= 1;
  for (int i2 = t; i2 < G * size; i2 += blockDim.x) {
    const int k = i2 / size, i = i2 - k * size;
    if (((need >> k) & 1u) && i >= s_cnt[k]) lists[k * LW + KL + i] = 0;
  }
  __syncthreads();
  sort_cands(lists, LW, KL, G, need, size);
  merge_top<false>(lists, LW, KL, G, need, lists + KL, LW, size);
  if (t < G && ((need >> t) & 1u)) {
    s_thr[t] = lists[t * LW + kk - 1];
    s_cnt[t] = 0;
  }
  __syncthreads();
}

// The `blocks` blocks' lists merged pairwise up a tree: node `node` of
// level `lvl` keeps its lists at leaf node << lvl of the scratch gl (slot
// k's of leaf l at k * kstride + l * KL), its ticket at word lvl * blocks
// + node / 2 of tk (TREE_WORDS * blocks words, zero). Returns true in the
// block that holds the merged lists at the end (the root); every other
// block returns false as soon as its lists are handed up.
__device__ inline bool merge_tree(u64* lists, int LW, int KL, int G, u64* gl,
                                  int64_t kstride, uint32_t* tk, int block,
                                  int blocks, bool* s_go) {
  const int t = threadIdx.x;
  int node = block, n = blocks, lvl = 0;
  if (n > 1) {
    for (int i2 = t; i2 < G * KL; i2 += blockDim.x) {
      const int k = i2 / KL, i = i2 - k * KL;
      gl[k * kstride + (int64_t)node * KL + i] = lists[k * LW + i];
    }
    __threadfence();
    __syncthreads();
  }
  const unsigned all = G >= 32 ? ~0u : (1u << G) - 1u;
  while (n > 1) {
    const int partner = node ^ 1;
    const bool pair = partner < n;
    if (pair) {
      if (t == 0) {
        uint32_t* w = tk + lvl * blocks + (node >> 1);
        const uint32_t old = atomicAdd(w, 1u);
        if (old) *w = 0u;
        *s_go = old != 0u;
      }
      __syncthreads();
      if (!*s_go) return false;
      __threadfence();
      merge_top<true>(lists, LW, KL, G, all,
                      gl + (int64_t)(partner << lvl) * KL, kstride, KL);
    }
    node >>= 1;
    ++lvl;
    n = (n + 1) >> 1;
    if (pair && n > 1) {
      for (int i2 = t; i2 < G * KL; i2 += blockDim.x) {
        const int k = i2 / KL, i = i2 - k * KL;
        gl[k * kstride + (int64_t)(node << lvl) * KL + i] =
            lists[k * LW + i];
      }
      __threadfence();
      __syncthreads();
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// K12: the decode of a bit-packed block (ops/packed.py)
// ---------------------------------------------------------------------------
// Replaces ops/packed.unpack_rows_dev of the JAX package (packed.py:205),
// which its packed-decode scorers fuse. A block's columns (17 compact
// features, the flags, the docids) are sub-streams of a uint32 word
// stream, each from its own word: row i of a column of width w (1..32)
// holds bits [i w, i w + w) of it, stored as value - column minimum. A
// value sits in two words at most: lo at i w / 32 and the next one,
// hi. The meta vector (META_LEN int32: word offsets, widths, minima)
// describes a block; `wbase` is its first word in the packed-words store
// of `nw` words. As in the reference, word indices clamp to the store,
// so a row past the block's count decodes garbage: every caller tests
// the row against the count before it reads anything (a tombstone
// byte) through the garbage.
constexpr int NCOLS = NF + 2, C_FLAGS = NF, C_DOCIDS = NF + 1;
constexpr int META_LEN = 3 * NCOLS;

// The meta vector by value in a launch's parameters.
struct PackMeta {
  int32_t v[META_LEN];
};

// Row i of the column of width w (0..32) and minimum vmin whose words
// start at word `base` of the store. __funnelshift_r gives
// ((hi:lo) >> s) for every s in 0..31, so s == 0 needs no case of its
// own; the mask of w == 32 is all ones (1 << 32 is undefined). The
// value wraps as int32: a column spanning more than 2^31 adds its
// offset in uint32.
__device__ __forceinline__ int32_t unpack_value(const uint32_t* __restrict__ words,
                                                int64_t nw, int64_t base,
                                                int32_t w, int32_t vmin,
                                                int64_t i) {
  const int64_t bit = i * (int64_t)w;
  const int64_t wi = base + (bit >> 5);
  const int64_t a = wi < 0 ? 0 : (wi >= nw ? nw - 1 : wi);
  const int64_t b = wi + 1 < 0 ? 0 : (wi + 1 >= nw ? nw - 1 : wi + 1);
  const uint32_t v =
      __funnelshift_r(__ldg(words + a), __ldg(words + b), (uint32_t)(bit & 31));
  const uint32_t mask =
      w >= 32 ? 0xffffffffu : (w <= 0 ? 0u : ((1u << w) - 1u));
  return (int32_t)((v & mask) + (uint32_t)vmin);
}

// Column c of row i of the block at word wbase with meta m (shared
// memory or registers).
__device__ __forceinline__ int32_t unpack_col(const uint32_t* __restrict__ words,
                                              int64_t nw, int64_t wbase,
                                              const int32_t* m, int c,
                                              int64_t i) {
  return unpack_value(words, nw, wbase + m[c], m[NCOLS + c], m[2 * NCOLS + c],
                      i);
}

// Row i in full: its 17 features (int32, the int16 values widened as
// the int16 path widens them), flags and docid.
__device__ __forceinline__ void unpack_row(const uint32_t* __restrict__ words,
                                           int64_t nw, int64_t wbase,
                                           const int32_t* m, int64_t i,
                                           int32_t* f, int32_t& fl,
                                           int32_t& d) {
#pragma unroll
  for (int c = 0; c < NF; ++c) f[c] = unpack_col(words, nw, wbase, m, c, i);
  fl = unpack_col(words, nw, wbase, m, C_FLAGS, i);
  d = unpack_col(words, nw, wbase, m, C_DOCIDS, i);
}

// ---------------------------------------------------------------------------
// A bit-packed block read in staged tiles (K6bp, K7bp)
// ---------------------------------------------------------------------------
// A block of `count` rows is cut into tiles of BP_TILE rows, two a
// thread of a block. Column c's bits for tile t are the words [wbase +
// m[c] + BP_RUN t w, + BP_RUN w) of the store (BP_RUN = BP_TILE / 32
// words a bit of width): whole words, since BP_TILE is a multiple of 32.
// A block of BP_THREADS threads walks the tiles block, block + blocks,
// ... (bp_run): warp u copies the runs of the staged columns u, u +
// BP_WARPS, ... of a tile into a stage of a ring of BP_STAGES
// (bp_issue_tile), by 16-byte cp.async with the source size: each run
// from its start aligned down to 16 bytes (the head skip, a column's
// constant: BP_RUN t w is a multiple of 4 words), read up to its last
// word or the store's end and no further, the rest of its last 16 bytes
// and one more word zero-filled (the high word of the run's last value,
// whose bits are masked off). A tile is taken in two steps: its docids
// and their tombstone loads when it lands, the rest a step later, so that
// the random tombstone bytes (misses of the L2 while the stream runs)
// arrive under a step's decode; BP_STAGES - 2 tiles are in flight
// meanwhile; one barrier a step.
//
// The decode reads the stage, never the store, with no clamp: lane l of
// warp u takes the tile's rows r = 32 u + l and r + BP_HALF (bp_pair).
// Row r's value of a column of width w starts at bit r w of its run: the
// words r w / 32 and the next, the shift (r w) % 32 = (l w) % 32 (32 u w
// and BP_HALF w are whole words), 32-bit offsets (r w < 2^15); a funnel
// shift of the two shared words, the mask, the minimum added, as
// unpack_value. The 32 lanes of a warp read w + 1 consecutive words of a
// column: no bank conflict beyond broadcasts. Each column's per-lane word
// offset and shift sit in a table made once a launch (bp_tables); its
// width, mask and minimum are the plan's, a kernel parameter, which the
// instructions read as constant-bank operands (no shared load).
//
// Bit for bit as unpack_value for every row below the count: the words a
// value needs lie in its run (the high word is read past the run only
// where no bit of it is kept), which the stage holds as the store does;
// the clamp of unpack_value changes only words past the store, which no
// such value needs. A row at or past the count decodes garbage and is
// dropped before anything is read through it.
constexpr int BP_WARPS = 8;                // two blocks an SM (PERF.md)
constexpr int BP_THREADS = BP_WARPS * 32;
constexpr int BP_TILE = 2 * BP_THREADS;    // rows a tile: two a thread
constexpr int BP_HALF = BP_TILE / 2;       // a lane's second row
constexpr int BP_RUN = BP_TILE / 32;       // a tile's words a bit of width
constexpr int BP_MIN_BLOCKS = 16 / BP_WARPS;  // up to 128 registers
constexpr int BP_STAGES = 3;  // four measured no faster (PERF.md)

struct BpPlan {
  const uint32_t* words;
  int64_t nw, wbase, count, tiles;
  int64_t a0[NCOLS];     // column c's tile-0 copy start (a store word)
  int32_t head[NCOLS];   // its run's first word past a0 (0..3)
  int32_t w[NCOLS], vmin[NCOLS];
  int32_t soff[NCOLS];   // its region in a stage (words, a multiple of 4)
  uint32_t mask[NCOLS];  // the mask of its width
  int32_t col[NCOLS];    // the staged columns, in stage order
  int32_t ncol, stage_words;
  PackMeta m;
};

// The plan of the block at word wbase (meta vector `meta`, host memory)
// of the store `words` of nw words, its columns in the bit set `staged`
// staged; false on a width outside 0..32 or a column outside the store.
// A column's region holds its head skip, BP_RUN w words and two more.
__host__ inline bool make_bp_plan(const void* words, int64_t nw,
                                  int64_t wbase, const int32_t* meta,
                                  int64_t count, uint32_t staged,
                                  BpPlan* p) {
  *p = BpPlan{};
  p->words = (const uint32_t*)words;
  p->nw = nw;
  p->wbase = wbase;
  p->count = count;
  p->tiles = (count + BP_TILE - 1) / BP_TILE;
  for (int i = 0; i < META_LEN; ++i) p->m.v[i] = meta[i];
  const uint64_t wq = (uint64_t)(uintptr_t)words >> 2;
  int32_t off = 0;
  for (int c = 0; c < NCOLS; ++c) {
    const int32_t w = meta[NCOLS + c];
    if (w < 0 || w > 32) return false;
    p->w[c] = w;
    p->vmin[c] = meta[2 * NCOLS + c];
    p->mask[c] = w >= 32 ? 0xffffffffu : (1u << w) - 1u;
    if (!((staged >> c) & 1u)) continue;
    const int64_t s = wbase + meta[c];
    if (s < 0 || s > nw) return false;
    const int head = (int)((wq + (uint64_t)s) & 3u);
    p->a0[c] = s - head;
    p->head[c] = head;
    p->soff[c] = off;
    off += (head + BP_RUN * w + 2 + 3) & ~3;
    p->col[p->ncol++] = c;
  }
  p->stage_words = off;
  return true;
}

// make_bp_plan's plan built on the card by one warp (lane c takes column
// c; the stage regions by a scan of the staged columns' sizes), for a
// kernel whose blocks read different blocks of the store (K5bp: one a
// slot). The host has checked the block with make_bp_plan.
__device__ __forceinline__ void bp_plan_warp(const uint32_t* words,
                                             int64_t nw, int64_t wbase,
                                             const int32_t* meta,
                                             int64_t count, uint32_t staged,
                                             BpPlan& p, int lane) {
  const bool col = lane < NCOLS;
  const bool st = col && ((staged >> lane) & 1u);
  const int32_t w = col ? meta[NCOLS + lane] : 0;
  int64_t s = 0;
  int head = 0, sz = 0;
  if (st) {
    s = wbase + meta[lane];
    head = (int)((((uint64_t)(uintptr_t)words >> 2) + (uint64_t)s) & 3u);
    sz = (head + BP_RUN * w + 2 + 3) & ~3;
  }
  int incl = sz;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  const unsigned m = __ballot_sync(0xffffffffu, st);
  if (col) {
    p.w[lane] = w;
    p.vmin[lane] = meta[2 * NCOLS + lane];
    p.mask[lane] = w >= 32 ? 0xffffffffu : (1u << w) - 1u;
    p.a0[lane] = s - head;
    p.head[lane] = head;
    p.soff[lane] = incl - sz;
  }
  if (st) p.col[__popc(m & ((1u << lane) - 1u))] = lane;
  for (int i = lane; i < META_LEN; i += 32) p.m.v[i] = meta[i];
  if (lane == 31) p.stage_words = incl;
  if (lane == 0) {
    p.words = words;
    p.nw = nw;
    p.wbase = wbase;
    p.count = count;
    p.tiles = (count + BP_TILE - 1) / BP_TILE;
    p.ncol = __popc(m);
  }
}

struct BpTabs {
  uint2 lane[NCOLS][32];  // the lane's first row: stage word, shift
};

// Threads t of the block fill the tables (the caller syncs).
__device__ __forceinline__ void bp_tables(const BpPlan& P, BpTabs& tb,
                                          int t) {
  for (int i = t; i < NCOLS * 32; i += BP_THREADS) {
    const int c = i >> 5, l = i & 31;
    const uint32_t lw = (uint32_t)l * (uint32_t)P.w[c];
    tb.lane[c][l] =
        make_uint2((uint32_t)(P.soff[c] + P.head[c]) + (lw >> 5), lw & 31u);
  }
}

// Warp `warp` starts the copies of its columns' runs of tile t into the
// stage st: the whole 16-byte chunks, then the ragged one and the pad
// word, zero past the run (cp.async with the source size).
__device__ __forceinline__ void bp_issue_tile(const BpPlan& P, int64_t t,
                                              unsigned char* st, int warp,
                                              int lane) {
  const int64_t left = P.count - t * BP_TILE;
  const int nr = left < BP_TILE ? (int)left : BP_TILE;
  for (int j = warp; j < P.ncol; j += BP_WARPS) {
    const int c = P.col[j];
    const int w = P.w[c];
    const int64_t a = P.a0[c] + t * BP_RUN * w;
    // the run's words from a, cut at the store's end
    int n = P.head[c] + ((nr * w + 31) >> 5);
    if (a + n > P.nw) n = (int)(P.nw - a);
    const uint32_t* src = P.words + a;
    unsigned char* dst = st + 4 * P.soff[c];
    const int full = n >> 2;
    for (int k = lane; k < full; k += 32) cp_async16(dst + 16 * k, src + 4 * k);
    for (int k = full + lane; k < ((n + 5) >> 2); k += 32) {
      const int m = n - 4 * k;
      cp_async16_n(dst + 16 * k, m > 0 ? src + 4 * k : src,
                   m > 0 ? 4u * (uint32_t)m : 0u);
    }
  }
}

// Column c of the thread's two rows of the tile staged at st: the lane's
// word offset and shift from the table, the width, mask and minimum from
// the plan (a kernel parameter: operands of the constant bank).
__device__ __forceinline__ void bp_pair(const uint32_t* st, const BpPlan& P,
                                        const BpTabs& tb, int c, int lane,
                                        int warp, int32_t& v0, int32_t& v1) {
  const uint2 L = tb.lane[c][lane];
  const uint32_t w = (uint32_t)P.w[c];
  const uint32_t* p = st + L.x + (uint32_t)warp * w;
  v0 = (int32_t)((__funnelshift_r(p[0], p[1], L.y) & P.mask[c]) +
                 (uint32_t)P.vmin[c]);
  p += BP_HALF / 32 * w;
  v1 = (int32_t)((__funnelshift_r(p[0], p[1], L.y) & P.mask[c]) +
                 (uint32_t)P.vmin[c]);
}

// The thread's two rows of tile t staged at st, as far as the tombstone
// loads: each row's tombstone byte (1: the row is gone: past the tile's
// rows, a pad docid or dead, row_live's rule), its load issued as soon
// as the docid is decoded and read a step later (bp_run).
struct BpGone {
  uint32_t g[2];
};
__device__ __forceinline__ BpGone bp_head(const BpPlan& P, const BpTabs& tb,
                                          int64_t t, const uint32_t* st,
                                          const uint8_t* __restrict__ dead,
                                          int64_t doc_cap, int lane,
                                          int warp) {
  const int64_t nr = P.count - t * BP_TILE;
  const int r0 = 32 * warp + lane;
  int32_t d[2];
  bp_pair(st, P, tb, C_DOCIDS, lane, warp, d[0], d[1]);
  BpGone out;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    out.g[m] = 1u;
    if (r0 + m * BP_HALF < nr && d[m] >= 0)
      out.g[m] = d[m] < doc_cap ? (uint32_t)__ldg(dead + d[m]) : 0u;
  }
  return out;
}

// The thread's two rows of a staged tile whose tombstone bytes bp_head
// loaded (`gone`): their scores sc[m] (score_row<int32_t, true>'s terms
// in another order, the same sum mod 2^32) and whether each is kept
// (below the count, live, passing the filter). A warp none of whose rows
// pass the filter decodes nothing more.
__device__ __forceinline__ void bp_score_pair(
    const uint32_t* sw, const BpPlan& P, const BpTabs& tb, const BpGone& gone,
    const Filter& q, bool off, const RegConsts& k, int lane, int warp,
    int32_t* sc, bool* ok) {
  int32_t lm0, lm1, lg0, lg1, fl0, fl1;
  bp_pair(sw, P, tb, F_LASTMOD, lane, warp, lm0, lm1);
  bp_pair(sw, P, tb, F_LANGUAGE, lane, warp, lg0, lg1);
  bp_pair(sw, P, tb, C_FLAGS, lane, warp, fl0, fl1);
  const bool p0 = !gone.g[0] && (off || constraint_ok(lg0, lm0, fl0, q));
  const bool p1 = !gone.g[1] && (off || constraint_ok(lg1, lm1, fl1, q));
  sc[0] = sc[1] = SMALL;
  ok[0] = ok[1] = false;
  if (!__any_sync(0xffffffffu, p0 || p1)) return;
  uint32_t s0 = norm_term<true>(F_LASTMOD, lm0, k);
  uint32_t s1 = norm_term<true>(F_LASTMOD, lm1, k);
  int32_t ti0 = 0, ti1 = 0, tx0 = 0, tx1 = 0, h0 = 0, h1 = 0;
#pragma unroll
  for (int c = 1; c < NF; ++c) {
    if (!is_active(c)) continue;
    int32_t a, b;
    bp_pair(sw, P, tb, c, lane, warp, a, b);
    s0 += norm_term<true>(c, a, k);
    s1 += norm_term<true>(c, b, k);
    if (c == F_WORDS_IN_TITLE) ti0 = a, ti1 = b;
    if (c == F_WORDS_IN_TEXT) tx0 = a, tx1 = b;
    if (c == F_HITCOUNT) h0 = a, h1 = b;
  }
  int32_t dl0, dl1;
  bp_pair(sw, P, tb, F_DOMLENGTH, lane, warp, dl0, dl1);
  s0 += profile_terms(dl0, lg0, fl0, k);
  s1 += profile_terms(dl1, lg1, fl1, k);
  if (k.tspan > 0.0f) {
    s0 += tf_term(term_frequency_of(h0, tx0, ti0), k);
    s1 += tf_term(term_frequency_of(h1, tx1, ti1), k);
  }
  sc[0] = (int32_t)s0;
  sc[1] = (int32_t)s1;
  ok[0] = p0;
  ok[1] = p1;
}

// The columns K7bp and K5bp stage: the scored features, the flags and
// the docids.
constexpr uint32_t BP_SCORED =
    (((1u << NF) - 1u) & ~(1u << 4) & ~(1u << F_FLAGS)) | (1u << C_FLAGS) |
    (1u << C_DOCIDS);

// The block's tiles block, block + blocks, ... through a ring of
// BP_STAGES stages at smem. Each step begins with a barrier, then
// at_barrier() (every thread), then the copies of a later tile into the
// stage freed in the step before. A tile is taken by head(t, stage) (every
// thread; the docids and their tombstone loads, BpGone) in the step its
// copies land and by body(t, stage, gone) (every thread) in the next, so
// that a tombstone load has a whole step to arrive; BP_STAGES - 2 tiles
// are in flight meanwhile.
template <typename AtBarrier, typename Head, typename Body>
__device__ __forceinline__ void bp_run(const BpPlan& P, unsigned char* smem,
                                       int block, int blocks,
                                       AtBarrier at_barrier, Head head,
                                       Body body) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t steps =
      P.tiles > block ? (P.tiles - block + blocks - 1) / blocks : 0;
  constexpr int ahead = BP_STAGES - 2;
  const size_t sb = (size_t)P.stage_words * 4;
  auto stage = [&](int s) { return (const uint32_t*)(smem + s * sb); };
  auto next_stage = [&](int s) { return s + 1 == BP_STAGES ? 0 : s + 1; };
  int s_issue = 0;
  auto issue = [&](int64_t i) {
    if (i < steps)
      bp_issue_tile(P, block + i * blocks, (unsigned char*)stage(s_issue),
                    warp, lane);
    cp_async_commit();
    s_issue = next_stage(s_issue);
  };
  for (int i = 0; i < ahead; ++i) issue(i);
  BpGone cur{};
  int s_cur = 0, s_prev = 0;
  for (int64_t i = 0; i <= steps; ++i) {
    // tile i's copies landed, the later ones may be in flight
    cp_async_wait<ahead - 1>();
    __syncthreads();
    at_barrier();
    issue(i + ahead);
    BpGone next{};
    if (i < steps) next = head(block + i * blocks, stage(s_cur));
    if (i > 0) body(block + (i - 1) * blocks, stage(s_prev), cur);
    cur = next;
    s_prev = s_cur;
    s_cur = next_stage(s_cur);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The dynamic shared memory a launch of `kernel` takes (BP_STAGES stages
// and `extra` bytes) and its grid (the tiles, at most the blocks
// the card holds at once, at least one). Cached per device: in most[64]
// the dynamic shared memory a block may take (set on the kernel at the
// first call), in occ[64][BP_OCC] the blocks an SM holds for each 2 KB of
// dynamic shared memory (the query asks for the 2 KB above the launch's).
// cudaErrorInvalidConfiguration where that does not fit.
constexpr int BP_OCC = 128;  // 2 KB steps of dynamic shared memory
template <typename K>
__host__ cudaError_t bp_shape(K kernel, const BpPlan& P, int64_t extra,
                              int* most, int (*occ)[BP_OCC], int* smem,
                              int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (most[dev] <= 0) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    const int m = optin - (int)fa.sharedSizeBytes;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, m);
    if (e != cudaSuccess) return e;
    most[dev] = m;
  }
  const int64_t sb = (int64_t)P.stage_words * 4;
  if (BP_STAGES * sb + extra > most[dev]) return cudaErrorInvalidConfiguration;
  *smem = (int)(BP_STAGES * sb + extra);
  const int step = (*smem + 2047) / 2048;
  if (step >= BP_OCC) return cudaErrorInvalidConfiguration;
  if (occ[dev][step] <= 0) {
    int per_sm = 0, sms = 0;
    const int q = step * 2048 < most[dev] ? step * 2048 : most[dev];
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      BP_THREADS, q);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    occ[dev][step] = (per_sm < 1 ? 1 : per_sm) * sms;
  }
  const int64_t limit = occ[dev][step];
  *grid = (int)(P.tiles < 1 ? 1 : (P.tiles < limit ? P.tiles : limit));
  return cudaSuccess;
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
