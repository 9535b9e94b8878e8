// Shared definitions of the port's CUDA kernels: the posting column
// layout, the packed profile-constant and statistics vectors, and the
// order-preserving integer keys the selection kernels sort by.
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
constexpr int F_WORDS_IN_TITLE = 1;
constexpr int F_WORDS_IN_TEXT = 2;
constexpr int F_LANGUAGE = 5;
constexpr int F_FLAGS = 10;
constexpr int F_HITCOUNT = 11;
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

}  // namespace yt
