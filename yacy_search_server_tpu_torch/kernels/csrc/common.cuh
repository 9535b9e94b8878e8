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

// One warp starts the copies of chunk c into stage st (flags and host ids
// only when given). A chunk's bytes start at a multiple of 16 from each
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
  copy_span<1>(st, (uintptr_t)(valid + r0), (uintptr_t)(valid + r1), lane);
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
