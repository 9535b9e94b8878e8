// Kernel 3 `tie_topk`: exact top-k under (score DESC, secondary ASC).
// Replaces lax.top_k in ops/ranking.score_topk16 / score_topk, in
// ops/streaming, and parallel/mesh.tie_topk (lax.sort on two keys) of the
// JAX package. Two orders:
//   index mode (no secondary): lax.top_k's order, the descending IEEE
//     total order for floats, ties broken by the lower row index;
//   tie mode (secondary = docids): lax.sort ascending on (-score,
//     docid), with lax.sort's float canonicalisation (-0 == +0, NaN last).
// Scores are int32 or f32 (passed as their bits).
//
// Bound: bytes. Every row is mapped to a unique-ish 64-bit key (order
// key of the score above, secondary below) that is never stored: a radix
// select over the keys, 8 bits a pass from the top, counts the bucket
// that holds the k-th key (one histogram pass over the scores, plus the
// docids once the low half is reached, then a one-thread bucket pick),
// and stops as soon as the chosen bucket is taken whole, which for
// distinct scores is after the score half. A collect pass writes the k
// selected (key, row) pairs, which are then sorted in shared memory
// (k <= 2048) or by a bitonic network in device memory, and the outputs
// are read back through the row index. Equal keys (same score and same
// docid) are interchangeable in every output but the row index.
#include "common.cuh"

namespace yt {

struct SelState {
  unsigned long long prefix, mask;
  uint32_t rem, done, take_eq, less_cnt, eq_cnt, pad[3];
  uint32_t hist[256];
};
constexpr int64_t STATE_BYTES = 2048;
constexpr int SHARED_SORT_MAX = 2048;

__device__ __forceinline__ uint32_t key_hi(const int32_t* scores, int64_t i,
                                           bool is_float, bool tie) {
  int32_t s = scores[i];
  return tie ? tie_hi(s, is_float) : topk_hi(s, is_float);
}

__device__ __forceinline__ unsigned long long full_key(
    const int32_t* scores, const int32_t* sec, int64_t i, bool is_float) {
  bool tie = sec != nullptr;
  uint32_t lo = tie ? sec_key(sec[i]) : (uint32_t)i;
  return ((unsigned long long)key_hi(scores, i, is_float, tie) << 32) | lo;
}

__global__ void sel_init(SelState* st, uint32_t k) {
  st->rem = k;
}

__global__ void sel_hist(const int32_t* __restrict__ scores,
                         const int32_t* __restrict__ sec, int64_t n,
                         int is_float, SelState* st, int shift) {
  if (st->done) return;
  __shared__ uint32_t h[256];
  for (int b = threadIdx.x; b < 256; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const unsigned long long prefix = st->prefix, mask = st->mask;
  const bool tie = sec != nullptr;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    unsigned long long key;
    if (shift >= 32)   // the low half is not looked at yet
      key = (unsigned long long)key_hi(scores, i, is_float, tie) << 32;
    else
      key = full_key(scores, sec, i, is_float);
    if ((key & mask) == prefix) atomicAdd(&h[(key >> shift) & 255u], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += blockDim.x)
    if (h[b]) atomicAdd(&st->hist[b], h[b]);
}

__global__ void sel_pick(SelState* st, int shift) {
  if (threadIdx.x != 0 || st->done) return;
  uint32_t cum = 0;
  int d = 0;
  for (; d < 256; ++d) {
    uint32_t c = st->hist[d];
    if (cum + c >= st->rem) break;
    cum += c;
  }
  st->prefix |= (unsigned long long)d << shift;
  st->mask |= 0xffull << shift;
  st->rem -= cum;
  if (st->hist[d] == st->rem || shift == 0) {
    st->done = 1;
    st->take_eq = st->rem;
  }
  for (int b = 0; b < 256; ++b) st->hist[b] = 0;
}

__global__ void sel_collect(const int32_t* __restrict__ scores,
                            const int32_t* __restrict__ sec, int64_t n,
                            int is_float, SelState* st, uint32_t k,
                            unsigned long long* ck, uint32_t* ci) {
  const unsigned long long prefix = st->prefix, mask = st->mask;
  const uint32_t take_eq = st->take_eq;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    unsigned long long key = full_key(scores, sec, i, is_float);
    unsigned long long mk = key & mask;
    if (mk < prefix) {
      uint32_t slot = atomicAdd(&st->less_cnt, 1u);
      ck[slot] = key;
      ci[slot] = (uint32_t)i;
    } else if (mk == prefix) {
      uint32_t slot = atomicAdd(&st->eq_cnt, 1u);
      if (slot < take_eq) {
        ck[k - take_eq + slot] = key;
        ci[k - take_eq + slot] = (uint32_t)i;
      }
    }
  }
}

__device__ __forceinline__ bool pair_gt(unsigned long long ka, uint32_t ia,
                                        unsigned long long kb, uint32_t ib) {
  return ka > kb || (ka == kb && ia > ib);
}

// one block, P <= SHARED_SORT_MAX (a power of two), 1024 threads
__global__ void sort_shared(unsigned long long* ck, uint32_t* ci, uint32_t k,
                            uint32_t P) {
  __shared__ unsigned long long sk[SHARED_SORT_MAX];
  __shared__ uint32_t si[SHARED_SORT_MAX];
  for (uint32_t i = threadIdx.x; i < P; i += blockDim.x) {
    sk[i] = i < k ? ck[i] : ~0ull;
    si[i] = i < k ? ci[i] : 0xffffffffu;
  }
  __syncthreads();
  for (uint32_t size = 2; size <= P; size <<= 1) {
    for (uint32_t j = size >> 1; j > 0; j >>= 1) {
      for (uint32_t i = threadIdx.x; i < P; i += blockDim.x) {
        uint32_t l = i ^ j;
        if (l > i) {
          bool asc = (i & size) == 0;
          if (pair_gt(sk[i], si[i], sk[l], si[l]) == asc) {
            unsigned long long tk = sk[i]; sk[i] = sk[l]; sk[l] = tk;
            uint32_t ti = si[i]; si[i] = si[l]; si[l] = ti;
          }
        }
      }
      __syncthreads();
    }
  }
  for (uint32_t i = threadIdx.x; i < k; i += blockDim.x) {
    ck[i] = sk[i];
    ci[i] = si[i];
  }
}

__global__ void sort_pad(unsigned long long* ck, uint32_t* ci, uint32_t k,
                         uint32_t P) {
  uint32_t i = k + blockIdx.x * blockDim.x + threadIdx.x;
  if (i < P) {
    ck[i] = ~0ull;
    ci[i] = 0xffffffffu;
  }
}

__global__ void sort_step(unsigned long long* ck, uint32_t* ci, uint32_t P,
                          uint32_t j, uint32_t size) {
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  uint32_t l = i ^ j;
  if (l <= i) return;
  bool asc = (i & size) == 0;
  if (pair_gt(ck[i], ci[i], ck[l], ci[l]) == asc) {
    unsigned long long tk = ck[i]; ck[i] = ck[l]; ck[l] = tk;
    uint32_t ti = ci[i]; ci[i] = ci[l]; ci[l] = ti;
  }
}

__global__ void sel_output(const int32_t* __restrict__ scores,
                           const int32_t* __restrict__ sec,
                           const int32_t* __restrict__ payload,
                           const uint32_t* __restrict__ ci, uint32_t k,
                           int32_t* out_s, int32_t* out_sec,
                           int32_t* out_idx) {
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  uint32_t r = ci[i];
  out_s[i] = scores[r];
  out_sec[i] = payload ? payload[r] : (sec ? sec[r] : (int32_t)r);
  out_idx[i] = (int32_t)r;
}

static uint32_t pow2_at_least(int64_t k) {
  uint32_t p = 1;
  while ((int64_t)p < k) p <<= 1;
  return p;
}

}  // namespace yt

using namespace yt;

// scratch bytes the wrapper must allocate for a top-k of size k
extern "C" int64_t yt_tie_topk_scratch_bytes(int64_t k) {
  int64_t P = pow2_at_least(k < 1 ? 1 : k);
  return STATE_BYTES + P * 8 + P * 4;
}

// scores [n] int32 (or f32 bits, is_float); secondary [n] int32 or null
// (index mode); payload [n] int32 or null: out_sec is payload[row] when
// given, else secondary[row], else the row. 1 <= k <= n.
extern "C" int yt_tie_topk(const void* scores, int is_float,
                           const void* secondary, const void* payload,
                           int64_t n, int64_t k, void* scratch,
                           void* out_scores, void* out_sec, void* out_idx,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k < 1 || k > n) return (int)cudaErrorInvalidValue;
  SelState* st = (SelState*)scratch;
  uint32_t P = pow2_at_least(k);
  unsigned long long* ck =
      (unsigned long long*)((char*)scratch + STATE_BYTES);
  uint32_t* ci = (uint32_t*)(ck + P);
  const int32_t* sc = (const int32_t*)scores;
  const int32_t* sec = (const int32_t*)secondary;
  cudaMemsetAsync(st, 0, sizeof(SelState), s);
  sel_init<<<1, 1, 0, s>>>(st, (uint32_t)k);
  const int threads = 256;
  int64_t g = (n + threads - 1) / threads;
  int grid = (int)(g > 132 * 8 ? 132 * 8 : g);
  for (int shift = 56; shift >= 0; shift -= 8) {
    sel_hist<<<grid, threads, 0, s>>>(sc, sec, n, is_float, st, shift);
    sel_pick<<<1, 32, 0, s>>>(st, shift);
  }
  sel_collect<<<grid, threads, 0, s>>>(sc, sec, n, is_float, st,
                                       (uint32_t)k, ck, ci);
  if (P <= SHARED_SORT_MAX) {
    sort_shared<<<1, 1024, 0, s>>>(ck, ci, (uint32_t)k, P);
  } else {
    uint32_t blocks = (P + 255) / 256;
    sort_pad<<<(P - (uint32_t)k + 255) / 256 + 1, 256, 0, s>>>(
        ck, ci, (uint32_t)k, P);
    for (uint32_t size = 2; size <= P; size <<= 1)
      for (uint32_t j = size >> 1; j > 0; j >>= 1)
        sort_step<<<blocks, 256, 0, s>>>(ck, ci, P, j, size);
  }
  sel_output<<<((uint32_t)k + 255) / 256, 256, 0, s>>>(
      sc, sec, (const int32_t*)payload, ci, (uint32_t)k,
      (int32_t*)out_scores, (int32_t*)out_sec, (int32_t*)out_idx);
  return (int)cudaGetLastError();
}
