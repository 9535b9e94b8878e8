// The dense rerank's kernels: K9 `dense_dot`, K10 `rerank_sort`, K11
// `hybrid_blend`. They replace the four jitted functions of the JAX
// package's ops/dense.py: `_rerank_fwd_batch_packed_kernel` (:290, the
// serving rerank over the device-resident forward index: K9 gather mode,
// then K10), `dense_boost_topk` (:218, K9 block mode, then kernel 3),
// `hybrid_rerank_topk` (:150) and `hybrid_rerank_topk_batch` (:177) (K9
// similarity mode, K11, then kernel 3 a slot). On the TPU all four are
// one bf16 MXU product with f32 accumulation; here a candidate's dot is
// one warp's.
//
// K9, the dot. DIM = 256, f16 rows (the forward index's and get_block's
// type): lane l holds elements 8l..8l+7 (one 16-byte load of 8 halves; a
// 512-byte row is one warp load). Every element is rounded to bf16 to nearest even (doc
// rows f16 -> f32 -> bf16, the query f32 -> bf16), so each product of two
// bf16 values is exact in f32 and only the order of the sum decides the
// bits. That order is fixed, here and in the plain version
// (kernels/dense.dot_plain): ((p0+p1)+(p2+p3))+((p4+p5)+(p6+p7)) a lane,
// then the xor butterfly over offsets 16, 8, 4, 2, 1 (every lane ends with
// the same sum: f32 addition commutes). Built with -fmad=false, and every
// operation is an explicitly rounded intrinsic. The boost is JAX's
// (sims * alpha) * 8355840 in two f32 multiplies, rintf (half to even),
// then int32; the sum with the sparse score wraps as XLA's int32 add.
// Non-finite vectors are outside this promise (the encoder L2-normalises
// every vector; NaN and -0 handling may differ from XLA's).
//   gather mode: one warp a (slot, lane); lanes at or past n_valid write
//     -(2^31-1) without reading, docids outside [0, cap) keep their sparse
//     score without a read. Bound: the gathered rows (n x 512 B a live
//     slot), the descriptor and the output; at bs = 16, nb = 128 about
//     1 MB, a third of a microsecond at 3.35 TB/s: the launch is what costs.
//   block mode: one warp a row of a contiguous block, and the boost.
//   similarity mode: one warp a row, the row held in registers while the
//     warp loops over up to 32 queries staged (bf16-rounded) in shared
//     memory: each row is read once for all of them. Bound: the block
//     (1 GiB at 2^21 rows: 0.32 ms) and B x n x 4 bytes of output.
//
// K10, the sort: one block a slot sorts its nb (a power of two <= 16384)
// lanes in shared memory by a bitonic network (dense_dot.cuh, shared with
// K14 and K15) on (key, lane), key = the
// 64-bit (score half, docid half): the score half orders -final as
// lax.sort does (the wrapping negation of kernel 3's tie mode,
// common.cuh:tie_hi), the docid half is docid ^ 0x80000000, INT32_MAX on
// lanes at or past n_valid. The lane breaks full ties, which makes the
// network's result the stable sort's (lax.sort is stable). Output: the
// sorted finals then the sorted docids over all nb lanes. Shared memory:
// 10 bytes a lane (160 KB at 16384). Bound: 8 bytes a lane in, 8 out.
//
// K11, the blend: pass 1, a grid of (chunk, slot) blocks, reduces each
// chunk's min of where(valid, s, 1e30) and max of where(valid, s, -1e30)
// (exact in any order); pass 2 reduces a slot's chunk results in every
// block and writes (1 - alpha) * ((s - min) / max(max - min, 1e-6)) +
// alpha * sims on valid lanes, -inf elsewhere, in JAX's operation order.
// Bound: sims, sparse and valid read (9 bytes a lane), the output written.
#include <cstring>

#include "dense_dot.cuh"

namespace yt {

constexpr int DD_WARPS = 8;              // warps a block of K9
constexpr int DD_THREADS = DD_WARPS * 32;
constexpr int DD_SQ = 32;                // queries a K9 similarity pass
constexpr int RS_MAX_NB = 1 << 14;
constexpr int RS_SMEM = RS_MAX_NB * 10;  // keys (8 B) and lanes (2 B)
constexpr int HB_THREADS = 256;
constexpr int HB_MAX_CHUNKS = 1024;

// K9 gather mode. qd: [bs, 2 + 2nb + 256] int32 rows (n_valid, alpha
// bits, docids[nb], sparse[nb], query bits[256]); final: [bs, nb].
__global__ void __launch_bounds__(DD_THREADS)
dense_gather(const __half* __restrict__ fwd, int64_t cap,
             const int32_t* __restrict__ qd, int bs, int nb,
             int32_t* __restrict__ fout) {
  const int64_t w = (int64_t)blockIdx.x * DD_WARPS + threadIdx.x / 32;
  const int l = threadIdx.x & 31;
  if (w >= (int64_t)bs * nb) return;  // the whole warp
  const int b = (int)(w / nb), j = (int)(w - (int64_t)b * nb);
  const int32_t* row = qd + (int64_t)b * (2 + 2 * nb + DD_DIM);
  int32_t out = SMALL;
  if (j < row[0]) {
    const int32_t docid = row[2 + j];
    float sims = 0.0f;
    if (docid >= 0 && docid < cap) {
      float d[8], q[8];
      load8(fwd + (int64_t)docid * DD_DIM, l, d);
      const int32_t* qb = row + 2 + 2 * nb + 8 * l;
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = bf16r(__int_as_float(qb[i]));
      sims = warp_sum(lane_sum(d, q));
    }
    out = boosted(row[2 + nb + j], sims, __int_as_float(row[1]));
  }
  if (l == 0) fout[w] = out;
}

// K9 block mode: final[i] = valid[i] ? sparse[i] + boost : -(2^31-1)
__global__ void __launch_bounds__(DD_THREADS)
dense_rows(const __half* __restrict__ docs, int64_t n,
           const float* __restrict__ qvec, const int32_t* __restrict__ sparse,
           const bool* __restrict__ valid, float alpha,
           int32_t* __restrict__ fout) {
  const int64_t w = (int64_t)blockIdx.x * DD_WARPS + threadIdx.x / 32;
  const int l = threadIdx.x & 31;
  if (w >= n) return;
  float d[8], q[8];
  load8(docs + w * DD_DIM, l, d);
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = bf16r(__ldg(qvec + 8 * l + i));
  const float sims = warp_sum(lane_sum(d, q));
  if (l == 0) fout[w] = valid[w] ? boosted(sparse[w], sims, alpha) : SMALL;
}

// K9 similarity mode: sims[q, i] = dot(docs[i], qvecs[q]); grid.y passes
// over the queries DD_SQ at a time
__global__ void __launch_bounds__(DD_THREADS)
dense_sims(const __half* __restrict__ docs, int64_t n,
           const float* __restrict__ qvecs, int nq,
           float* __restrict__ sims) {
  __shared__ __align__(16) float sq[DD_SQ * DD_DIM];
  const int q0 = blockIdx.y * DD_SQ;
  const int nqb = min(DD_SQ, nq - q0);
  for (int i = threadIdx.x; i < nqb * DD_DIM; i += DD_THREADS)
    sq[i] = bf16r(__ldg(qvecs + (int64_t)q0 * DD_DIM + i));
  __syncthreads();
  const int64_t w = (int64_t)blockIdx.x * DD_WARPS + threadIdx.x / 32;
  const int l = threadIdx.x & 31;
  if (w >= n) return;
  float d[8];
  load8(docs + w * DD_DIM, l, d);
  for (int q = 0; q < nqb; ++q) {
    const float4* qq = reinterpret_cast<const float4*>(sq + q * DD_DIM) + 2 * l;
    const float4 a = qq[0], b = qq[1];
    const float qv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const float s = warp_sum(lane_sum(d, qv));
    if (l == 0) sims[(int64_t)(q0 + q) * n + w] = s;
  }
}

// K10: one block a slot
__global__ void __launch_bounds__(1024)
rerank_sort_k(const int32_t* __restrict__ fin_all,
              const int32_t* __restrict__ qd, int nb,
              int32_t* __restrict__ out) {
  extern __shared__ unsigned long long rs_key[];
  uint16_t* lane = reinterpret_cast<uint16_t*>(rs_key + nb);
  const int b = blockIdx.x;
  const int32_t* row = qd + (int64_t)b * (2 + 2 * nb + DD_DIM);
  const int32_t* fin = fin_all + (int64_t)b * nb;
  const int nvalid = row[0];
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int32_t t = i < nvalid ? row[2 + i] : BIG;
    rs_key[i] = ((unsigned long long)tie_hi(fin[i], false) << 32) |
                sec_key(t);
    lane[i] = (uint16_t)i;
  }
  __syncthreads();
  bitonic_sort<true>(rs_key, lane, nb);
  int32_t* o = out + (int64_t)b * 2 * nb;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int src = lane[i];
    o[i] = fin[src];
    o[nb + i] = row[2 + src];
  }
}

__device__ __forceinline__ void block_minmax(float& mn, float& mx) {
  __shared__ float smn[32], smx[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  const int wid = threadIdx.x / 32, l = threadIdx.x & 31;
  if (l == 0) {
    smn[wid] = mn;
    smx[wid] = mx;
  }
  __syncthreads();
  if (wid == 0) {
    const int nw = blockDim.x / 32;
    mn = l < nw ? smn[l] : INFINITY;
    mx = l < nw ? smx[l] : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
  }
}

// K11 pass 1: part[(q * G + g) * 2 + {0, 1}] = the chunk's min, max
__global__ void __launch_bounds__(HB_THREADS)
blend_minmax(const float* __restrict__ sparse, const bool* __restrict__ valid,
             int64_t n, int64_t chunk, float* __restrict__ part) {
  const int q = blockIdx.y, g = blockIdx.x;
  const int64_t lo = (int64_t)g * chunk, hi = min(n, lo + chunk);
  const float* s = sparse + (int64_t)q * n;
  const bool* v = valid + (int64_t)q * n;
  float mn = INFINITY, mx = -INFINITY;
  for (int64_t i = lo + threadIdx.x; i < hi; i += HB_THREADS) {
    const bool ok = v[i];
    const float x = s[i];
    mn = fminf(mn, ok ? x : 1e30f);
    mx = fmaxf(mx, ok ? x : -1e30f);
  }
  block_minmax(mn, mx);
  if (threadIdx.x == 0) {
    part[((int64_t)q * gridDim.x + g) * 2] = mn;
    part[((int64_t)q * gridDim.x + g) * 2 + 1] = mx;
  }
}

// K11 pass 2: the slot's min and max from the G chunk results, then the
// blend over a grid-stride range of the slot's lanes
__global__ void __launch_bounds__(HB_THREADS)
blend_apply(const float* __restrict__ sims, const float* __restrict__ sparse,
            const bool* __restrict__ valid, int64_t n, int G,
            const float* __restrict__ part, float alpha,
            float* __restrict__ out) {
  __shared__ float s_mn, s_mx;
  const int q = blockIdx.y;
  float mn = INFINITY, mx = -INFINITY;
  for (int g = threadIdx.x; g < G; g += HB_THREADS) {
    mn = fminf(mn, part[((int64_t)q * G + g) * 2]);
    mx = fmaxf(mx, part[((int64_t)q * G + g) * 2 + 1]);
  }
  block_minmax(mn, mx);
  if (threadIdx.x == 0) {
    s_mn = mn;
    s_mx = mx;
  }
  __syncthreads();
  const float smin = s_mn;
  const float span0 = __fsub_rn(s_mx, smin);
  const float span = span0 > 1e-6f ? span0 : 1e-6f;
  const float oma = __fsub_rn(1.0f, alpha);
  const int64_t base = (int64_t)q * n;
  for (int64_t i = (int64_t)blockIdx.x * HB_THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * HB_THREADS) {
    const int64_t x = base + i;
    out[x] = valid[x]
                 ? __fadd_rn(__fmul_rn(oma, __fdiv_rn(__fsub_rn(sparse[x],
                                                                 smin),
                                                       span)),
                             __fmul_rn(alpha, sims[x]))
                 : -INFINITY;
  }
}

// an f32 from its bits, on the host
inline float host_f32(int bits) {
  float f;
  std::memcpy(&f, &bits, sizeof f);
  return f;
}

__host__ int blend_chunks(int64_t n) {
  int64_t g = (n + 8191) / 8192;
  return (int)(g < 1 ? 1 : (g > HB_MAX_CHUNKS ? HB_MAX_CHUNKS : g));
}

}  // namespace yt

using namespace yt;

extern "C" int yt_dense_gather(const void* fwd, int64_t cap, const void* qd,
                               int bs, int nb, void* fout, void* stream) {
  if (bs < 1 || nb < 16 || nb > RS_MAX_NB || (nb & (nb - 1)) || cap < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t warps = (int64_t)bs * nb;
  dense_gather<<<(unsigned)((warps + DD_WARPS - 1) / DD_WARPS), DD_THREADS,
                 0, (cudaStream_t)stream>>>(
      (const __half*)fwd, cap, (const int32_t*)qd, bs, nb, (int32_t*)fout);
  return (int)cudaGetLastError();
}

extern "C" int yt_dense_rows(const void* docs, int64_t n, const void* qvec,
                             const void* sparse, const void* valid,
                             int alpha_bits, void* fout, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  dense_rows<<<(unsigned)((n + DD_WARPS - 1) / DD_WARPS), DD_THREADS, 0,
               (cudaStream_t)stream>>>(
      (const __half*)docs, n, (const float*)qvec, (const int32_t*)sparse,
      (const bool*)valid, host_f32(alpha_bits), (int32_t*)fout);
  return (int)cudaGetLastError();
}

extern "C" int yt_dense_sims(const void* docs, int64_t n, const void* qvecs,
                             int nq, void* sims, void* stream) {
  if (n < 1 || nq < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + DD_WARPS - 1) / DD_WARPS),
                  (unsigned)((nq + DD_SQ - 1) / DD_SQ));
  dense_sims<<<grid, DD_THREADS, 0, (cudaStream_t)stream>>>(
      (const __half*)docs, n, (const float*)qvecs, nq, (float*)sims);
  return (int)cudaGetLastError();
}

extern "C" int yt_rerank_sort(const void* fin_all, const void* qd, int bs,
                              int nb, void* out, void* stream) {
  if (bs < 1 || nb < 16 || nb > RS_MAX_NB || (nb & (nb - 1)))
    return (int)cudaErrorInvalidValue;
  const int smem = nb * 10;
  if (smem > 48 * 1024) {
    static bool raised[64];
    const cudaError_t e = allow_smem(rerank_sort_k, RS_SMEM, raised);
    if (e != cudaSuccess) return (int)e;
  }
  rerank_sort_k<<<bs, nb < 1024 ? nb : 1024, smem, (cudaStream_t)stream>>>(
      (const int32_t*)fin_all, (const int32_t*)qd, nb, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int64_t yt_hybrid_blend_scratch_bytes(int64_t n, int64_t nq) {
  return (int64_t)blend_chunks(n) * nq * 2 * (int64_t)sizeof(float);
}

extern "C" int yt_hybrid_blend(const void* sims, const void* sparse,
                               const void* valid, int64_t n, int nq,
                               int alpha_bits, void* scratch, void* out,
                               void* stream) {
  if (n < 1 || nq < 1 || nq > 65535) return (int)cudaErrorInvalidValue;
  const int G = blend_chunks(n);
  const int64_t chunk = (n + G - 1) / G;
  cudaStream_t s = (cudaStream_t)stream;
  blend_minmax<<<dim3(G, nq), HB_THREADS, 0, s>>>(
      (const float*)sparse, (const bool*)valid, n, chunk, (float*)scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t g2 = (n + HB_THREADS * 8 - 1) / (HB_THREADS * 8);
  blend_apply<<<dim3((unsigned)(g2 < 1 ? 1 : (g2 > 65535 ? 65535 : g2)), nq),
                HB_THREADS, 0, s>>>(
      (const float*)sims, (const float*)sparse, (const bool*)valid, n, G,
      (const float*)scratch, host_f32(alpha_bits), (float*)out);
  return (int)cudaGetLastError();
}
