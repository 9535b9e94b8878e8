// The dense-first IVF ANN kernels: K14 `ann_assign` and K15 `ann_fuse`.
// They replace the two jitted kernels of the JAX package's ops/ann.py:
// `_ann_assign_batch_kernel` (:82, the wave's queries against the
// centroid matrix, top np_ centroid ids a slot) and
// `_ann_fuse_batch_packed_kernel` (:151, the probe gather over the int8
// hot slab, the dequantised bf16 dot, the fixed-scale boost added to the
// sparse lanes' scores, and the (score DESC, docid ASC) sort a slot). On
// the TPU both are one MXU product; here a dot is one warp's, in K9's
// fixed order (dense_dot.cuh), so the card equals the plain versions
// (kernels/ann.py) to the bit.
//
// K14, one block a slot. The slot's warps take the centroid rows in turn:
// a row is f16 (the uploaded block), rounded to bf16 like the query's
// f32; rows at or past c_real (the pow2 pad) are -inf without a read.
// Each sim goes into shared memory as the 64-bit key (lax.top_k's order:
// the descending IEEE total order of the sim, common.cuh topk_hi; the
// centroid id below, so ties go to the lower id), K10's bitonic network
// sorts the C_pad keys, and the first np_ ids are the answer. C_pad <=
// 8192 (64 KB of keys). Bound: the centroid matrix (512 B a row) read
// once, the queries and B x np_ ids; at B = 16, C = 1024 about 0.6 MB,
// 0.2 us at 3.35 TB/s: launch and the sort's 55 barrier stages cost.
//
// K15, two kernels. `ann_fuse_keys`: one warp a run of 8 lanes of a
// slot's descriptor ([n_valid, alpha bits, rows[nb], docids[nb],
// sparse[nb], query bits[256]], ops/ann.pack_ann_fuse_row), the query
// read into registers once for the 8 (its 1 KB is four rows' bytes):
// for a lane below
// n_valid whose row lies in [0, cap), the int8 row (exact in bf16) dot
// the bf16 query, times the f16 scale; otherwise sims = 0 without a
// read. docid = the lane's own where >= 0, else sdocids[row] inside the
// slab, else INT32_MAX (invalid). final = sparse + rint((sims * alpha) *
// SCALE) on valid lanes, -(2^31-1) elsewhere; the lane's 64-bit key is
// (the wrapping negation of final, docid), each half in unsigned order
// (common.cuh tie_hi, sec_key), INT32_MAX docid on invalid lanes: the
// key alone determines both outputs. `ann_fuse_round`, the selection in
// rounds: a block takes a chunk of C keys of one slot (C = max(4096,
// 2kk') with kk' the pow2 at or above kk), sorts it with K10's network
// and keeps its first kk'; the next round does the same over the kept
// keys (each round halves a slot's keys at least), until one chunk is
// left, whose first kk the last round writes. The kk best of a slot are
// among each chunk's kk best, so the result is lax.sort then [:kk]'s.
// Chunks past a slot's keys are filled with ~0, the key of an invalid
// lane (INT32_MAX docid, -(2^31-1) score), which is what the JAX kernel
// outputs for those. Output [bs, 2kk]: the finals, then the docids.
// Bound: each live lane's gathered row (256 B), scale and docid, the
// descriptors and the output; the keys (8 B a lane, written once and read
// once a round) are this design's own traffic.
#include <cstring>

#include "dense_dot.cuh"

namespace yt {

constexpr int AN_WARPS = 8;
constexpr int AN_THREADS = AN_WARPS * 32;
constexpr int AN_LANES = 8;              // lanes a warp of ann_fuse_keys
constexpr int AA_THREADS = 1024;
constexpr int AA_MAX_C = 8192;
constexpr int AF_THREADS = 1024;
constexpr int AF_CHUNK = 4096;           // keys a block sorts (at least)
constexpr int AF_MAX_CHUNK = 16384;      // 2 x K15's largest kk

// K14: ids[b, :np_] of the slot's best centroids
__global__ void __launch_bounds__(AA_THREADS)
ann_assign_k(const __half* __restrict__ cent, int cpad, int c_real,
             const float* __restrict__ qv, int np_,
             int32_t* __restrict__ ids) {
  extern __shared__ unsigned long long aa_key[];
  const int b = blockIdx.x;
  const int w = threadIdx.x / 32, l = threadIdx.x & 31;
  float q[8];
  const float* qb = qv + (int64_t)b * DD_DIM + 8 * l;
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = bf16r(__ldg(qb + i));
  for (int c = w; c < cpad; c += AA_THREADS / 32) {
    float s = -INFINITY;
    if (c < c_real) {
      float d[8];
      load8(cent + (int64_t)c * DD_DIM, l, d);
      s = warp_sum(lane_sum(d, q));
    }
    if (l == 0)
      aa_key[c] = ((unsigned long long)topk_hi(__float_as_int(s), true)
                   << 32) | (uint32_t)c;
  }
  __syncthreads();
  bitonic_sort<false>(aa_key, nullptr, cpad);
  for (int i = threadIdx.x; i < np_; i += AA_THREADS)
    ids[(int64_t)b * np_ + i] = (int32_t)(uint32_t)aa_key[i];
}

// K15, the lanes' keys: keys[b, j] for every lane of every slot; a warp
// takes AN_LANES consecutive lanes of one slot, the query in registers
__global__ void __launch_bounds__(AN_THREADS)
ann_fuse_keys(const int8_t* __restrict__ slab,
              const __half* __restrict__ scales,
              const int32_t* __restrict__ sdocids, int64_t cap,
              const int32_t* __restrict__ qd, int bs, int nb,
              unsigned long long* __restrict__ keys) {
  const int64_t w = (int64_t)blockIdx.x * AN_WARPS + threadIdx.x / 32;
  const int l = threadIdx.x & 31;
  const int per = nb / AN_LANES;
  if (w >= (int64_t)bs * per) return;  // the whole warp
  const int b = (int)(w / per);
  const int j0 = (int)(w - (int64_t)b * per) * AN_LANES;
  const int32_t* row = qd + (int64_t)b * (2 + 3 * nb + DD_DIM);
  const int32_t nvalid = row[0];
  float q[8];
  bool have_q = false;
  for (int j = j0; j < j0 + AN_LANES; ++j) {
    int32_t fin = SMALL, tk = BIG;
    if (j < nvalid) {
      const int32_t r = row[2 + j];
      const bool in_slab = r >= 0 && r < cap;
      float sims = 0.0f;
      if (in_slab) {
        if (!have_q) {
          load8_q(row + 2 + 3 * nb, l, q);
          have_q = true;
        }
        float d[8];
        load8_i8(slab + (int64_t)r * DD_DIM, l, d);
        sims = __fmul_rn(warp_sum(lane_sum(d, q)), __half2float(scales[r]));
      }
      const int32_t own = row[2 + nb + j];
      const int32_t dd = own >= 0 ? own : (in_slab ? sdocids[r] : BIG);
      if (dd != BIG) {
        fin = boosted(row[2 + 2 * nb + j], sims, __int_as_float(row[1]));
        tk = dd;
      }
    }
    if (l == 0)
      keys[(int64_t)b * nb + j] =
          ((unsigned long long)tie_hi(fin, false) << 32) | sec_key(tk);
  }
}

// K15, one round of the selection: block (chunk c, slot b) sorts keys
// c*C .. c*C+C of the slot's m and keeps its first KK (out != null) or
// writes the first kk decoded (the last round, one chunk)
__global__ void __launch_bounds__(AF_THREADS)
ann_fuse_round(const unsigned long long* __restrict__ in, int64_t m, int C,
               int KK, unsigned long long* __restrict__ out, int kk,
               int32_t* __restrict__ dec) {
  extern __shared__ unsigned long long af_key[];
  const int b = blockIdx.y, c = blockIdx.x;
  const unsigned long long* src = in + (int64_t)b * m + (int64_t)c * C;
  const int64_t have = m - (int64_t)c * C;
  for (int i = threadIdx.x; i < C; i += AF_THREADS)
    af_key[i] = i < have ? src[i] : ~0ull;
  __syncthreads();
  bitonic_sort<false>(af_key, nullptr, C);
  if (out != nullptr) {
    unsigned long long* o = out + (int64_t)b * gridDim.x * KK +
                            (int64_t)c * KK;
    for (int i = threadIdx.x; i < KK; i += AF_THREADS) o[i] = af_key[i];
    return;
  }
  int32_t* o = dec + (int64_t)b * 2 * kk;
  for (int i = threadIdx.x; i < kk; i += AF_THREADS) {
    const unsigned long long x = af_key[i];
    // the high half is the negated final in unsigned order
    const int32_t neg = (int32_t)((uint32_t)(x >> 32) ^ 0x80000000u);
    o[i] = (int32_t)(0u - (uint32_t)neg);
    o[kk + i] = (int32_t)((uint32_t)x ^ 0x80000000u);
  }
}

}  // namespace yt

using namespace yt;

extern "C" int yt_ann_assign(const void* cent, int cpad, int c_real,
                             const void* qv, int nq, int np_, void* ids,
                             void* stream) {
  if (nq < 1 || cpad < 2 || cpad > AA_MAX_C || (cpad & (cpad - 1)) ||
      c_real < 1 || c_real > cpad || np_ < 1 || np_ > cpad)
    return (int)cudaErrorInvalidValue;
  const int smem = cpad * 8;
  if (smem > 48 * 1024) {
    static bool raised[64];
    const cudaError_t e = allow_smem(ann_assign_k, AA_MAX_C * 8, raised);
    if (e != cudaSuccess) return (int)e;
  }
  ann_assign_k<<<nq, AA_THREADS, smem, (cudaStream_t)stream>>>(
      (const __half*)cent, cpad, c_real, (const float*)qv, np_,
      (int32_t*)ids);
  return (int)cudaGetLastError();
}

// keys: bs * nb * 3 / 2 uint64 of scratch (the lanes' keys, then the
// first round's survivors)
extern "C" int yt_ann_fuse(const void* slab, const void* scales,
                           const void* sdocids, int64_t cap, const void* qd,
                           int bs, int nb, int kk, void* keys, void* out,
                           void* stream) {
  if (bs < 1 || bs > 65535 || cap < 1 || nb < 16 || (nb & (nb - 1)) ||
      kk < 1 || kk > nb || kk > AF_MAX_CHUNK / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t warps = (int64_t)bs * (nb / AN_LANES);
  unsigned long long* buf[2] = {
      (unsigned long long*)keys,
      (unsigned long long*)keys + (int64_t)bs * nb};
  ann_fuse_keys<<<(unsigned)((warps + AN_WARPS - 1) / AN_WARPS), AN_THREADS,
                  0, s>>>((const int8_t*)slab, (const __half*)scales,
                          (const int32_t*)sdocids, cap, (const int32_t*)qd,
                          bs, nb, buf[0]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  static bool raised[64];
  e = allow_smem(ann_fuse_round, AF_MAX_CHUNK * 8, raised);
  if (e != cudaSuccess) return (int)e;
  int KK = 1;
  while (KK < kk) KK <<= 1;
  const int C = KK * 2 > AF_CHUNK ? KK * 2 : AF_CHUNK;
  int64_t m = nb;
  int cur = 0;
  while (m > C) {
    const int64_t chunks = m / C;
    ann_fuse_round<<<dim3((unsigned)chunks, bs), AF_THREADS, C * 8, s>>>(
        buf[cur], m, C, KK, buf[cur ^ 1], kk, nullptr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    m = chunks * KK;
    cur ^= 1;
  }
  const int last = m < 2 ? 2 : (int)m;
  ann_fuse_round<<<dim3(1, bs), AF_THREADS, last * 8, s>>>(
      buf[cur], m, last, KK, nullptr, kk, (int32_t*)out);
  return (int)cudaGetLastError();
}
