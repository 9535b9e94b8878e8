// Kernel 4 `gather_topk`: the merge of the candidate-fusion collective.
// Replaces the Pallas kernel parallel/mesh._all_gather_topk_pallas of the
// JAX package (its pallas_call and the tie_topk epilogue). On the TPU
// each device's (k, 2) int32 block of local top-k rows rides a ring of
// remote DMAs and the gathered rows are merged under (score DESC, docid
// ASC). Here the gather is a plain copy (one card) or, across cards, an
// NCCL all-gather outside the kernel; this kernel is the merge.
//
// Input: the gathered [m, 2] int32 buffer (column 0 the score, bit-cast
// from f32 when is_float; column 1 the docid), any number of shard
// blocks of any length, in any order. Output: the first k rows of the
// tie_topk order (lax.sort's canonical float order). Each row's output
// position is its rank: the number of rows whose (key, position) pair is
// smaller. Blocks of 256 rows stream all keys through shared memory, so
// the work is m^2 comparisons with no sort and no atomics, deterministic.
// Bound: operations at the m of a fused query (m = shards * k <= 16,000);
// the bytes are a few hundred KB.
#include "common.cuh"

namespace yt {

constexpr int GT_THREADS = 256;

__device__ __forceinline__ unsigned long long block_key(const int32_t* b,
                                                        int64_t i,
                                                        bool is_float) {
  return ((unsigned long long)tie_hi(b[2 * i], is_float) << 32) |
         sec_key(b[2 * i + 1]);
}

__global__ void gather_rank(const int32_t* __restrict__ block, int64_t m,
                            int is_float, int64_t k, int32_t* out_s,
                            int32_t* out_d) {
  __shared__ unsigned long long tk[GT_THREADS];
  int64_t i = (int64_t)blockIdx.x * GT_THREADS + threadIdx.x;
  unsigned long long mine = i < m ? block_key(block, i, is_float) : 0ull;
  int64_t rank = 0;
  for (int64_t base = 0; base < m; base += GT_THREADS) {
    int64_t j = base + threadIdx.x;
    if (j < m) tk[threadIdx.x] = block_key(block, j, is_float);
    __syncthreads();
    int64_t lim = m - base < GT_THREADS ? m - base : GT_THREADS;
    for (int64_t t = 0; t < lim; ++t) {
      unsigned long long o = tk[t];
      rank += (o < mine) || (o == mine && base + t < i);
    }
    __syncthreads();
  }
  if (i < m && rank < k) {
    out_s[rank] = block[2 * i];
    out_d[rank] = block[2 * i + 1];
  }
}

}  // namespace yt

using namespace yt;

// block: [m, 2] int32; out_scores / out_docids: [k] int32, 1 <= k <= m
extern "C" int yt_gather_topk(const void* block, int64_t m, int is_float,
                              int64_t k, void* out_scores, void* out_docids,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k < 1 || k > m) return (int)cudaErrorInvalidValue;
  int grid = (int)((m + GT_THREADS - 1) / GT_THREADS);
  gather_rank<<<grid, GT_THREADS, 0, s>>>((const int32_t*)block, m,
                                          is_float, k, (int32_t*)out_scores,
                                          (int32_t*)out_docids);
  return (int)cudaGetLastError();
}
