// Kernel 1 `cardinal_stats`: the normalisation statistics of a postings
// block. Replaces ops/ranking.local_stats (+ _masked_minmax and
// _term_frequency) of the JAX package: masked per-column min/max over
// valid rows (sentinels +-(2^31-1)), the f32 term-frequency min/max, and,
// when asked, the per-host valid counts and their maximum.
//
// Bound: bytes. Every row of the block is read once (34 B of int16 or
// 68 B of int32 features, 1 B valid, 4 B hostid when counting); the
// output is a few dozen words. Each thread folds its rows into register
// minima/maxima, a warp reduces by shuffles, a block through shared
// memory, and blocks combine with integer atomics into the statistics
// vector, which is order-free and so deterministic. Floats are folded as
// order-preserving integers; a NaN term frequency is only flagged, and
// the finalise step makes both tf bounds NaN as XLA's NaN-propagating
// min/max would. Host counts are integer atomics (exact, order-free).
#include "common.cuh"

namespace yt {

__global__ void stats_init(int32_t* st) {
  int t = threadIdx.x;
  if (t < NF) {
    st[S_COL_MIN + t] = BIG;
    st[S_COL_MAX + t] = SMALL;
  }
  if (t == 0) {
    st[S_TF_MIN] = float_order(0x7f800000);           // +inf
    st[S_TF_MAX] = float_order((int32_t)0xff800000);  // -inf
    st[S_HOST_MAX] = 0;
    st[S_NAN] = 0;
  }
}

template <typename T>
__global__ void stats_main(const T* __restrict__ feats,
                           const uint8_t* __restrict__ valid, int64_t n,
                           int32_t* st) {
  __shared__ int32_t s_min[NF], s_max[NF];
  __shared__ int32_t s_tmin, s_tmax, s_nan;
  if (threadIdx.x < NF) {
    s_min[threadIdx.x] = BIG;
    s_max[threadIdx.x] = SMALL;
  }
  if (threadIdx.x == 0) {
    s_tmin = float_order(0x7f800000);
    s_tmax = float_order((int32_t)0xff800000);
    s_nan = 0;
  }
  __syncthreads();

  int32_t lmin[NF], lmax[NF];
#pragma unroll
  for (int c = 0; c < NF; ++c) {
    lmin[c] = BIG;
    lmax[c] = SMALL;
  }
  int32_t tmin = float_order(0x7f800000);
  int32_t tmax = float_order((int32_t)0xff800000);
  int32_t nan = 0;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!valid[r]) continue;
    const T* f = feats + r * NF;
#pragma unroll
    for (int c = 0; c < NF; ++c) {
      int32_t v = (int32_t)f[c];
      lmin[c] = min(lmin[c], v);
      lmax[c] = max(lmax[c], v);
    }
    float tf = term_frequency(f);
    if (tf != tf) {
      nan = 1;
    } else {
      int32_t k = float_order(__float_as_int(tf));
      tmin = min(tmin, k);
      tmax = max(tmax, k);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < NF; ++c) {
      lmin[c] = min(lmin[c], __shfl_xor_sync(0xffffffffu, lmin[c], o));
      lmax[c] = max(lmax[c], __shfl_xor_sync(0xffffffffu, lmax[c], o));
    }
    tmin = min(tmin, __shfl_xor_sync(0xffffffffu, tmin, o));
    tmax = max(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    nan |= __shfl_xor_sync(0xffffffffu, nan, o);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < NF; ++c) {
      atomicMin(&s_min[c], lmin[c]);
      atomicMax(&s_max[c], lmax[c]);
    }
    atomicMin(&s_tmin, tmin);
    atomicMax(&s_tmax, tmax);
    atomicOr(&s_nan, nan);
  }
  __syncthreads();
  int t = threadIdx.x;
  if (t < NF) {
    atomicMin(&st[S_COL_MIN + t], s_min[t]);
    atomicMax(&st[S_COL_MAX + t], s_max[t]);
  } else if (t == NF) {
    atomicMin(&st[S_TF_MIN], s_tmin);
    atomicMax(&st[S_TF_MAX], s_tmax);
    if (s_nan) atomicOr(&st[S_NAN], 1);
  }
}

// segment sum of valid rows into num_hosts bins (out-of-range ids drop,
// as jax.ops.segment_sum drops them)
__global__ void host_count(const uint8_t* __restrict__ valid,
                           const int32_t* __restrict__ hostids, int64_t n,
                           int64_t num_hosts, int32_t* counts) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    int32_t h = hostids[r];
    if (valid[r] && h >= 0 && h < num_hosts) atomicAdd(&counts[h], 1);
  }
}

__global__ void host_max(const int32_t* __restrict__ counts,
                         int64_t num_hosts, int32_t* st) {
  int32_t m = 0;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < num_hosts; i += stride)
    m = max(m, counts[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) atomicMax(&st[S_HOST_MAX], m);
}

__global__ void stats_finalize(int32_t* st) {
  if (threadIdx.x != 0) return;
  if (st[S_NAN]) {
    st[S_TF_MIN] = 0x7fc00000;
    st[S_TF_MAX] = 0x7fc00000;
  } else {
    st[S_TF_MIN] = float_order(st[S_TF_MIN]);
    st[S_TF_MAX] = float_order(st[S_TF_MAX]);
  }
}

static int grid_for(int64_t n, int threads) {
  int64_t g = (n + threads - 1) / threads;
  if (g > 132 * 16) g = 132 * 16;
  return g < 1 ? 1 : (int)g;
}

}  // namespace yt

using namespace yt;

// feats: [n, 17] int16 (feat_bytes 2) or int32 (4); valid: [n] bool;
// hostids: [n] int32; stats: int32[38]; counts: int32[max(num_hosts, 1)],
// zeroed, then counted when num_hosts > 0 (0 skips the per-host scatter).
extern "C" int yt_cardinal_stats(const void* feats, int feat_bytes,
                                 const void* valid, const void* hostids,
                                 int64_t n, int64_t num_hosts, void* stats,
                                 void* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* st = (int32_t*)stats;
  const uint8_t* v = (const uint8_t*)valid;
  stats_init<<<1, 32, 0, s>>>(st);
  const int threads = 256;
  int grid = grid_for(n, threads);
  if (n > 0) {
    if (feat_bytes == 2)
      stats_main<int16_t><<<grid, threads, 0, s>>>(
          (const int16_t*)feats, v, n, st);
    else
      stats_main<int32_t><<<grid, threads, 0, s>>>(
          (const int32_t*)feats, v, n, st);
  }
  cudaMemsetAsync(counts, 0, (size_t)(num_hosts > 0 ? num_hosts : 1) * 4, s);
  if (num_hosts > 0) {
    if (n > 0)
      host_count<<<grid, threads, 0, s>>>(v, (const int32_t*)hostids, n,
                                          num_hosts, (int32_t*)counts);
    host_max<<<grid_for(num_hosts, threads), threads, 0, s>>>(
        (const int32_t*)counts, num_hosts, st);
  }
  stats_finalize<<<1, 32, 0, s>>>(st);
  return (int)cudaGetLastError();
}
