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
// cardinal_stats.
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
  constexpr int SB = stage_bytes<T>();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t chunks = (n + CH - 1) / CH;
  const int64_t step = (int64_t)gridDim.x * WARPS;
  unsigned char* mine = smem + warp * 2 * SB;
  // authority is decided from the constants in device memory, so the
  // first copy can go out before the block's constants are ready
  const bool use_auth = num_hosts > 1 && consts[C_AUTHORITY] > 12;
  const int32_t* hsrc = use_auth ? hostids : nullptr;

  int64_t c = (int64_t)blockIdx.x * WARPS + warp;
  if (c < chunks) issue_chunk(feats, flags, valid, hsrc, n, c, mine, lane);
  cp_async_commit();

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
