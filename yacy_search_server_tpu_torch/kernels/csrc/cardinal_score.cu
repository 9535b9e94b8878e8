// Kernel 2 `cardinal_score`: one int32 cardinal score per posting row.
// Replaces ops/ranking.cardinal_from_stats (+ _norm_div_exact_fast) of
// the JAX package, the vectorised ReferenceOrder.cardinal: normalised
// columns << |coeff|, domlength, the f32 tf norm, the language match, the
// 11 flag terms and, when the authority coefficient is > 12, the
// domain-authority term. Invalid rows score -(2^31-1).
//
// Bound: bytes. One pass reads each row's features (34 B int16 or 68 B
// int32), its flags, valid byte and (with authority) host id and count,
// and writes 4 B. The per-column span, reciprocal and shift are computed
// once per block into shared memory. Arithmetic follows XLA's int32
// semantics exactly: products and sums wrap (done in uint32), the int32
// path floors its division, the compact path reproduces the f32
// reciprocal estimate with its +-1 correction, and every float step is
// an explicitly rounded intrinsic (no FMA contraction).
#include "common.cuh"

namespace yt {

template <typename T>
__global__ void score_main(const T* __restrict__ feats,
                           const int32_t* __restrict__ flags,
                           const uint8_t* __restrict__ valid,
                           const int32_t* __restrict__ hostids, int64_t n,
                           const int32_t* __restrict__ st,
                           const int32_t* __restrict__ counts,
                           int64_t num_hosts,
                           const int32_t* __restrict__ consts, int fast_div,
                           int32_t* __restrict__ out) {
  __shared__ int32_t s_cmin[NF], s_span[NF], s_safe[NF], s_shift[NF];
  __shared__ float s_rcp[NF];
  __shared__ int32_t s_c[CONSTS_LEN];
  __shared__ float s_tmin, s_tspan;
  __shared__ int32_t s_hmax;
  int t = threadIdx.x;
  if (t < CONSTS_LEN) s_c[t] = consts[t];
  if (t < NF) {
    int32_t cmin = st[S_COL_MIN + t];
    int32_t span = (int32_t)((uint32_t)st[S_COL_MAX + t] - (uint32_t)cmin);
    int32_t safe = max(span, 1);
    s_cmin[t] = cmin;
    s_span[t] = span;
    s_safe[t] = safe;
    s_rcp[t] = __fdiv_rn(1.0f, __int2float_rn(safe));
    int32_t k = consts[C_NORM + t];
    s_shift[t] = k < 0 ? -k : k;
  }
  if (t == 0) {
    float tmin = __int_as_float(st[S_TF_MIN]);
    s_tmin = tmin;
    s_tspan = __fsub_rn(__int_as_float(st[S_TF_MAX]), tmin);
    s_hmax = st[S_HOST_MAX];
  }
  __syncthreads();
  const bool use_auth = num_hosts > 1 && s_c[C_AUTHORITY] > 12;
  const float tspan = s_tspan;
  const float tden = fmaxf(tspan, 1e-9f);

  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + t; r < n;
       r += stride) {
    if (!valid[r]) {
      out[r] = SMALL;
      continue;
    }
    const T* f = feats + r * NF;
    uint32_t score = 0;
#pragma unroll
    for (int c = 0; c < NF; ++c) {
      if (!is_active(c)) continue;
      int32_t span = s_span[c];
      if (span == 0) continue;             // norm = inverted = 0
      int32_t safe = s_safe[c];
      int32_t prod =
          (int32_t)(((uint32_t)(int32_t)f[c] - (uint32_t)s_cmin[c]) * 256u);
      int32_t norm;
      if (fast_div) {
        int32_t q0 = __float2int_rz(
            __fmul_rn(__int2float_rn(prod), s_rcp[c]));
        int32_t rem =
            (int32_t)((uint32_t)prod - (uint32_t)q0 * (uint32_t)safe);
        norm = q0 + (rem >= safe ? 1 : 0) - (rem < 0 ? 1 : 0);
      } else {
        norm = floordiv(prod, safe);
      }
      uint32_t contrib = is_direct(c) ? (uint32_t)norm
                                      : 256u - (uint32_t)norm;
      score += shl(contrib, s_shift[c]);
    }
    score += shl(256u - (uint32_t)(int32_t)f[F_DOMLENGTH], s_c[C_DOMLENGTH]);

    if (tspan > 0.0f) {
      float tf = term_frequency(f);
      float x = __fdiv_rn(__fmul_rn(__fsub_rn(tf, s_tmin), 256.0f), tden);
      score += shl((uint32_t)__float2int_rz(x), s_c[C_TF]);
    }

    if ((int32_t)f[F_LANGUAGE] == s_c[C_LANG_PREF])
      score += shl(255u, s_c[C_LANGUAGE]);

    int32_t fl = flags ? flags[r] : (int32_t)f[F_FLAGS];
#pragma unroll
    for (int j = 0; j < N_FLAG_TERMS; ++j) {
      int32_t b = s_c[C_BITS + j];
      int32_t hit = (b < 0 || b >= 32) ? (fl < 0 ? 1 : 0) : ((fl >> b) & 1);
      if (hit) score += shl(255u, s_c[C_SHIFTS + j]);
    }

    if (use_auth) {
      int64_t h = hostids[r];
      h = h < 0 ? 0 : (h >= num_hosts ? num_hosts - 1 : h);
      int32_t a = floordiv((int32_t)((uint32_t)counts[h] << 8), 1 + s_hmax);
      score += shl((uint32_t)a, s_c[C_AUTHORITY]);
    }
    out[r] = (int32_t)score;
  }
}

}  // namespace yt

using namespace yt;

// feats: [n, 17] int16 (feat_bytes 2) or int32 (4); flags: [n] int32 or
// null (read the F_FLAGS column); valid [n] bool; hostids [n] int32;
// stats int32[38]; counts int32[num_hosts] (num_hosts <= 1: no
// authority); consts int32[44]; out [n] int32.
extern "C" int yt_cardinal_score(const void* feats, int feat_bytes,
                                 const void* flags, const void* valid,
                                 const void* hostids, int64_t n,
                                 const void* stats, const void* counts,
                                 int64_t num_hosts, const void* consts,
                                 int fast_div, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const int threads = 256;
    int64_t g = (n + threads - 1) / threads;
    int grid = (int)(g > 132 * 16 ? 132 * 16 : g);
    if (feat_bytes == 2)
      score_main<int16_t><<<grid, threads, 0, s>>>(
          (const int16_t*)feats, (const int32_t*)flags,
          (const uint8_t*)valid, (const int32_t*)hostids, n,
          (const int32_t*)stats, (const int32_t*)counts, num_hosts,
          (const int32_t*)consts, fast_div, (int32_t*)out);
    else
      score_main<int32_t><<<grid, threads, 0, s>>>(
          (const int32_t*)feats, (const int32_t*)flags,
          (const uint8_t*)valid, (const int32_t*)hostids, n,
          (const int32_t*)stats, (const int32_t*)counts, num_hosts,
          (const int32_t*)consts, fast_div, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
