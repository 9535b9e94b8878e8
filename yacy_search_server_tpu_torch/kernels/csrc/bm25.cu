// K16 `bm25_pass`: the scoring pass of the JAX package's ops/ranking.py
// `bm25_topk` (:653-677; the top-k stays on kernel 3): avgdl over the
// valid rows, idf of the t query terms, and per row the sum over the
// terms of idf * tf * (k1 + 1) / max(denom, 1e-9), -inf on invalid rows.
//
// Two kernels after one memset, also callable apart (`yt_bm25_sums`,
// `yt_bm25_rows`: the split of parallel/mesh.py's _bm25_shard across
// cells, the doc axis' psum of the sums between them, the term axis'
// psum of the rows' partial scores after). `bm25_sums` adds the valid
// rows' doclen (int64) and their count with integer atomics after a block reduction:
// integer sums are exact in any order, so the result is the same every
// run. `bm25_rows`: each block first computes avgdl = f32(sum) /
// max(f32(count), 1) and the t idf values in shared memory, idf =
// f32(log(double(1 + ((ndocs - df) + 0.5) / (df + 0.5)))) (the log in
// double, rounded once: one function that both this kernel and the plain
// version, ops/ranking.bm25_scores_plain, evaluate to the same bits);
// then one thread a row, in the plain version's order: base = k1 *
// ((1 - b) + b * (dl / max(avgdl, 1e-6))), term_j = ((idf_j * tf_j) *
// (k1 + 1)) / max(tf_j + base, 1e-9), score = ((term_0 + term_1) + ...)
// left to right. Constants are f32 from the host's doubles, as PyTorch
// rounds a Python scalar for an f32 tensor. Every operation is an
// explicitly rounded intrinsic and the build has -fmad=false, so the
// card equals the plain version to the bit. Bound: the bytes, tf (4 B a
// term a row), doclen and valid read twice, the scores written: at 1M x
// 4, 30 MB, 9 us at 3.35 TB/s.
#include <cmath>
#include <cstring>

#include "common.cuh"

namespace yt {

constexpr int BM_THREADS = 256;
constexpr int BM_MAX_T = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int32_t x) { return __int2float_rn(x); }

__global__ void __launch_bounds__(BM_THREADS)
bm25_sums(const int32_t* __restrict__ doclen, const bool* __restrict__ valid,
          int64_t n, unsigned long long* __restrict__ acc) {
  __shared__ unsigned long long s_sum[BM_THREADS / 32], s_cnt[BM_THREADS / 32];
  unsigned long long sum = 0, cnt = 0;
  for (int64_t i = (int64_t)blockIdx.x * BM_THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * BM_THREADS) {
    if (valid[i]) {
      sum += (unsigned long long)(int64_t)doclen[i];
      cnt += 1;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  }
  const int wid = threadIdx.x / 32, l = threadIdx.x & 31;
  if (l == 0) {
    s_sum[wid] = sum;
    s_cnt[wid] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long a = 0, c = 0;
    for (int i = 0; i < BM_THREADS / 32; ++i) {
      a += s_sum[i];
      c += s_cnt[i];
    }
    if (c) {
      atomicAdd(acc, a);
      atomicAdd(acc + 1, c);
    }
  }
}

template <typename TF>
__global__ void __launch_bounds__(BM_THREADS)
bm25_rows(const TF* __restrict__ tf, const int32_t* __restrict__ doclen,
          const int32_t* __restrict__ df, const bool* __restrict__ valid,
          int64_t n, int t, const int32_t* __restrict__ ndocs_dev,
          float ndocs_val, const unsigned long long* __restrict__ acc,
          float k1, float c0, float b, float k1p1,
          float* __restrict__ out) {
  __shared__ float s_idf[BM_MAX_T];
  __shared__ float s_avg;
  if (threadIdx.x == 0) {
    const float sum = __ll2float_rn((long long)acc[0]);
    const float cnt = __ll2float_rn((long long)acc[1]);
    const float avgdl = __fdiv_rn(sum, cnt > 1.0f ? cnt : 1.0f);
    s_avg = avgdl > 1e-6f ? avgdl : 1e-6f;
  }
  const float nd =
      ndocs_dev != nullptr ? __int2float_rn(*ndocs_dev) : ndocs_val;
  for (int j = threadIdx.x; j < t; j += BM_THREADS) {
    const float d = __int2float_rn(df[j]);
    const float x = __fadd_rn(
        1.0f, __fdiv_rn(__fadd_rn(__fsub_rn(nd, d), 0.5f), __fadd_rn(d, 0.5f)));
    s_idf[j] = __double2float_rn(log((double)x));
  }
  __syncthreads();
  const float a = s_avg;
  for (int64_t i = (int64_t)blockIdx.x * BM_THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * BM_THREADS) {
    if (!valid[i]) {
      out[i] = -INFINITY;
      continue;
    }
    const float dl = __int2float_rn(doclen[i]);
    const float base = __fmul_rn(k1, __fadd_rn(c0, __fmul_rn(b, __fdiv_rn(dl, a))));
    const TF* row = tf + i * t;
    float s = 0.0f;
    for (int j = 0; j < t; ++j) {
      const float f = to_f32(row[j]);
      const float den = __fadd_rn(f, base);
      const float term = __fdiv_rn(__fmul_rn(__fmul_rn(s_idf[j], f), k1p1),
                                   den > 1e-9f ? den : 1e-9f);
      s = j == 0 ? term : __fadd_rn(s, term);
    }
    out[i] = s;
  }
}

inline float host_f32b(int bits) {
  float f;
  std::memcpy(&f, &bits, sizeof f);
  return f;
}

}  // namespace yt

using namespace yt;

// K16's first half: the valid rows' doclen sum and count into acc (two
// uint64, zeroed here). Across a mesh's doc axis each cell adds its own
// rows; the cells' acc words are summed (exact integers) and handed to
// yt_bm25_rows.
extern "C" int yt_bm25_sums(const void* doclen, const void* valid, int64_t n,
                            void* acc, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(acc, 0, 2 * sizeof(unsigned long long), s);
  if (e != cudaSuccess || n == 0) return (int)e;
  int64_t g = (n + BM_THREADS - 1) / BM_THREADS;
  const unsigned grid = (unsigned)(g < 1 ? 1 : (g > 4096 ? 4096 : g));
  bm25_sums<<<grid, BM_THREADS, 0, s>>>((const int32_t*)doclen,
                                        (const bool*)valid, n,
                                        (unsigned long long*)acc);
  return (int)cudaGetLastError();
}

// K16's second half: the rows' scores over the t term columns of tf
// (tf_int: int32, else f32) against the sums in acc (yt_bm25_sums', or
// the doc axis' total); a mesh cell's t columns give its partial score,
// which the term axis sums. ndocs_dev: an int32 on the device or null
// (then ndocs_bits, an f32).
extern "C" int yt_bm25_rows(const void* tf, int tf_int, const void* doclen,
                            const void* df, const void* valid, int64_t n,
                            int t, const void* ndocs_dev, int ndocs_bits,
                            int k1_bits, int c0_bits, int b_bits,
                            int k1p1_bits, const void* acc, void* out,
                            void* stream) {
  if (n < 1 || t < 0 || t > BM_MAX_T) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int64_t g = (n + BM_THREADS - 1) / BM_THREADS;
  const unsigned grid = (unsigned)(g < 1 ? 1 : (g > 4096 ? 4096 : g));
  const int32_t* nd = (const int32_t*)ndocs_dev;
  const float ndv = host_f32b(ndocs_bits);
  const auto* a = (const unsigned long long*)acc;
  if (tf_int)
    bm25_rows<int32_t><<<grid, BM_THREADS, 0, s>>>(
        (const int32_t*)tf, (const int32_t*)doclen, (const int32_t*)df,
        (const bool*)valid, n, t, nd, ndv, a, host_f32b(k1_bits),
        host_f32b(c0_bits), host_f32b(b_bits), host_f32b(k1p1_bits),
        (float*)out);
  else
    bm25_rows<float><<<grid, BM_THREADS, 0, s>>>(
        (const float*)tf, (const int32_t*)doclen, (const int32_t*)df,
        (const bool*)valid, n, t, nd, ndv, a, host_f32b(k1_bits),
        host_f32b(c0_bits), host_f32b(b_bits), host_f32b(k1p1_bits),
        (float*)out);
  return (int)cudaGetLastError();
}

// tf_int: tf is int32 (else f32); ndocs_dev: an int32 on the device or
// null (then ndocs_bits, an f32); acc: two uint64 of scratch
extern "C" int yt_bm25_pass(const void* tf, int tf_int, const void* doclen,
                            const void* df, const void* valid, int64_t n,
                            int t, const void* ndocs_dev, int ndocs_bits,
                            int k1_bits, int c0_bits, int b_bits,
                            int k1p1_bits, void* acc, void* out,
                            void* stream) {
  if (n < 1 || t < 0 || t > BM_MAX_T) return (int)cudaErrorInvalidValue;
  const int e = yt_bm25_sums(doclen, valid, n, acc, stream);
  if (e != 0) return e;
  return yt_bm25_rows(tf, tf_int, doclen, df, valid, n, t, ndocs_dev,
                      ndocs_bits, k1_bits, c0_bits, b_bits, k1p1_bits, acc,
                      out, stream);
}
