// K17 `power_iterate`: BlockRank's damped power iteration over a host
// edge list, the JAX package's ops/blockrank.py `_power_iterate_sparse`
// (:27-50, a jax.jit while_loop), to the bit.
//
// What XLA's CPU compiler makes of that loop (read from its optimized
// HLO) and this file repeats, step for step, in f32:
//   r0 = f32(1.0 / n) (a double rounded once), inv = 1.0f / f32(n),
//   teleport = (1 - d) * inv (XLA turns a division by the constant n
//   into a product with its inverse);
//   each step: s = the sum of where(dangling, r, 0) in XLA's tree order
//   (TreeReductionRewriter: while more than 32 values remain, pad to a
//   multiple of 32 with the padding split pad / 2 low, the rest high,
//   add each window of 32 left to right from 0; the last <= 32 values
//   left to right from 0); dm = s * inv; the segment sum starts from dm
//   (XLA folds `contrib + dm` into the scatter's initial value) and adds
//   each edge's product f32(w * r[src]) in edge order; r' = fma(d, acc,
//   teleport), rounded once (XLA's CPU contracts the multiply-add);
//   delta = max |r' - r|; stop when !(delta > f32(1e-9)) or after
//   max_iters steps.
// The build has -fmad=false: every operation is an explicitly rounded
// intrinsic, and kernels/blockrank.power_iterate_plain computes the same
// values on the CPU, so the card equals it, and the JAX kernel, to the
// bit.
//
// Design. The wrapper lays the edges out once a call as a CSR by
// destination (a stable sort keeps each destination's edges in edge
// order). A step is up to five launches, none synchronised with the
// host: `br_windows` (the first tree level, a thread a window),
// `br_finish` (one block: the other levels, dm, delta reset), `br_light`
// (a thread sums a destination of at most BR_LIGHT edges, pulling its
// products in order: no float atomics, whose order would wander),
// `br_heavy` (a block a hub: eight warps stage 1024 products a round in
// shared memory, four gathers in flight a thread, while one thread adds
// the previous round's in order) and
// `br_step_end` (one thread: the trip count, the stop flag, the buffer
// swap). delta is a max of non-negative floats, kept as their bit
// patterns (which order as unsigned ints) and folded by atomicMax. Once
// the flag is set every later launch returns at once; the host fetches
// the state (trip count, current buffer) once at the end.
//
// Bound: the bytes a step, 12 an edge (src, weight, the gathered rank)
// and 8 a host (read, write), as the JAX roofline's cost model counts
// them (ops/roofline.py:541): at the realistic graph (5.2M edges, 1M
// hosts) 70 MB, 0.021 ms a step at 3.35 TB/s. What bounds a step is the
// biggest hub's sum, one dependent chain of in-degree adds (about 4
// cycles each: 0.09 ms for that graph's 45,139 in-edges); br_heavy keeps
// the chain fed (1024 products staged a round, four gathers in flight a
// stager) and reaches about 6 cycles an add on an H100. The launches
// after the stop cost a few microseconds each (kernels/blockrank.py's
// callers see them in the call time).
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace yt {

constexpr int BR_THREADS = 256;
constexpr int BR_WIN = 32;            // XLA's tree-reduction window
constexpr int BR_LIGHT = 32;          // in-degree summed by one thread
constexpr int BR_STAGERS = 256;       // a hub's stagers, 4 products each
constexpr int BR_PER = 4;
constexpr int BR_CHUNK = BR_STAGERS * BR_PER;   // products staged a round
constexpr int BR_HEAVY_THREADS = 32 + BR_STAGERS;   // warp 0 adds
constexpr int BR_FINISH_THREADS = 1024;

// the state, int32[8]: the stop flag, steps done, delta's bits, dm's
// bits, which rank buffer is current
constexpr int ST_DONE = 0, ST_ITERS = 1, ST_DELTA = 2, ST_DM = 3, ST_CUR = 4;

// the first tree level: window w adds where(dangling, r, 0) over
// positions [32w - lo, 32w - lo + 32), padding and live hosts' zeros
// included (adding 0 to a non-negative sum changes nothing)
__global__ void __launch_bounds__(BR_THREADS)
br_windows(const float* rb0, const float* rb1,
           const bool* __restrict__ dangling, int64_t n, int64_t lo,
           int64_t nwin, float* __restrict__ part,
           const int* __restrict__ st) {
  if (st[ST_DONE]) return;
  const float* r = st[ST_CUR] ? rb1 : rb0;
  const int64_t w = (int64_t)blockIdx.x * BR_THREADS + threadIdx.x;
  if (w >= nwin) return;
  float acc = 0.0f;
  const int64_t base = w * BR_WIN - lo;
  for (int j = 0; j < BR_WIN; ++j) {
    const int64_t i = base + j;
    if (i >= 0 && i < n && dangling[i]) acc = __fadd_rn(acc, r[i]);
  }
  part[w] = acc;
}

// the other tree levels in one block (ping-pong between sa and sb), the
// last <= 32 values in order by one thread, dm, and delta reset for this
// step; with n <= 32 there is no window: the sum runs over r itself
__global__ void __launch_bounds__(BR_FINISH_THREADS)
br_finish(const float* rb0, const float* rb1,
          const bool* __restrict__ dangling, int64_t n, const float* part0,
          int64_t nwin, float* sa, float* sb, float inv, int* st) {
  if (st[ST_DONE]) return;
  const float* src = part0;
  float* dst = sa;
  int64_t len = nwin;
  if (n > BR_WIN) {
    while (len > BR_WIN) {
      const int64_t m = (len + BR_WIN - 1) / BR_WIN;
      const int64_t lo = (m * BR_WIN - len) / 2;
      for (int64_t w = threadIdx.x; w < m; w += BR_FINISH_THREADS) {
        float acc = 0.0f;
        for (int j = 0; j < BR_WIN; ++j) {
          const int64_t i = w * BR_WIN + j - lo;
          if (i >= 0 && i < len) acc = __fadd_rn(acc, src[i]);
        }
        dst[w] = acc;
      }
      __syncthreads();
      src = dst;
      dst = dst == sa ? sb : sa;
      len = m;
    }
  }
  if (threadIdx.x == 0) {
    float s = 0.0f;
    if (n > BR_WIN) {
      for (int64_t i = 0; i < len; ++i) s = __fadd_rn(s, src[i]);
    } else {
      const float* r = st[ST_CUR] ? rb1 : rb0;
      for (int64_t i = 0; i < n; ++i)
        if (dangling[i]) s = __fadd_rn(s, r[i]);
    }
    st[ST_DM] = __float_as_int(__fmul_rn(s, inv));
    st[ST_DELTA] = 0;
  }
}

// a thread a destination of at most BR_LIGHT in-edges (hubs are left to
// br_heavy): dm, then each edge's product in edge order, then the update
__global__ void __launch_bounds__(BR_THREADS)
br_light(const int* __restrict__ rowptr, const int* __restrict__ src_s,
         const float* __restrict__ w_s, float* rb0, float* rb1, int64_t n,
         float d, float tele, int* st) {
  if (st[ST_DONE]) return;
  const int cur = st[ST_CUR];
  const float* r = cur ? rb1 : rb0;
  float* out = cur ? rb0 : rb1;
  const float dm = __int_as_float(st[ST_DM]);
  const int64_t v = (int64_t)blockIdx.x * BR_THREADS + threadIdx.x;
  unsigned diff = 0u;
  if (v < n) {
    const int beg = rowptr[v], end = rowptr[v + 1];
    if (end - beg <= BR_LIGHT) {
      float acc = dm;
      for (int e = beg; e < end; ++e)
        acc = __fadd_rn(acc, __fmul_rn(w_s[e], r[src_s[e]]));
      const float r2 = __fmaf_rn(d, acc, tele);
      out[v] = r2;
      diff = __float_as_uint(fabsf(__fsub_rn(r2, r[v])));
    }
  }
  diff = __reduce_max_sync(0xffffffffu, diff);
  if ((threadIdx.x & 31) == 0 && diff)
    atomicMax(reinterpret_cast<unsigned*>(st + ST_DELTA), diff);
}

// stager t's products of a round: BR_PER independent gathers in flight
__device__ __forceinline__ void br_stage(float* dst,
                                         const int* __restrict__ src_s,
                                         const float* __restrict__ w_s,
                                         const float* r, int base, int end,
                                         int t) {
  float p[BR_PER];
#pragma unroll
  for (int k = 0; k < BR_PER; ++k) {
    const int e = base + t + k * BR_STAGERS;
    p[k] = e < end ? __fmul_rn(w_s[e], r[src_s[e]]) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < BR_PER; ++k) dst[t + k * BR_STAGERS] = p[k];
}

// a block a hub: warps 1-8 stage the next round's 1024 products in shared
// memory while thread 0 adds the current round's, in edge order
__global__ void __launch_bounds__(BR_HEAVY_THREADS)
br_heavy(const int* __restrict__ heavy, const int* __restrict__ rowptr,
         const int* __restrict__ src_s, const float* __restrict__ w_s,
         float* rb0, float* rb1, float d, float tele, int* st) {
  if (st[ST_DONE]) return;
  __shared__ __align__(16) float buf[2][BR_CHUNK];
  const int cur = st[ST_CUR];
  const float* r = cur ? rb1 : rb0;
  float* out = cur ? rb0 : rb1;
  const int v = heavy[blockIdx.x];
  const int beg = rowptr[v], end = rowptr[v + 1];
  const int nch = (end - beg + BR_CHUNK - 1) / BR_CHUNK;
  const int t = (int)threadIdx.x - 32;          // a stager's slot
  if (t >= 0) br_stage(buf[0], src_s, w_s, r, beg, end, t);
  __syncthreads();
  float acc = __int_as_float(st[ST_DM]);
  for (int c = 0; c < nch; ++c) {
    if (t >= 0) {
      if (c + 1 < nch)
        br_stage(buf[(c + 1) & 1], src_s, w_s, r, beg + (c + 1) * BR_CHUNK,
                 end, t);
    } else if (threadIdx.x == 0) {
      const int rest = end - beg - c * BR_CHUNK;
      const int cnt = rest < BR_CHUNK ? rest : BR_CHUNK;
      const float* b = buf[c & 1];
      const float4* b4 = reinterpret_cast<const float4*>(b);
      int k = 0;
      for (; k + 4 <= cnt; k += 4) {
        const float4 v = b4[k >> 2];
        acc = __fadd_rn(acc, v.x);
        acc = __fadd_rn(acc, v.y);
        acc = __fadd_rn(acc, v.z);
        acc = __fadd_rn(acc, v.w);
      }
      for (; k < cnt; ++k) acc = __fadd_rn(acc, b[k]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float r2 = __fmaf_rn(d, acc, tele);
    out[v] = r2;
    const unsigned diff = __float_as_uint(fabsf(__fsub_rn(r2, r[v])));
    if (diff) atomicMax(reinterpret_cast<unsigned*>(st + ST_DELTA), diff);
  }
}

// one thread: the step is done; the stop test of the JAX loop's cond
__global__ void br_step_end(int* st, float tol, int max_iters) {
  if (st[ST_DONE]) return;
  const int it = st[ST_ITERS] + 1;
  st[ST_ITERS] = it;
  st[ST_CUR] ^= 1;
  const float delta = __uint_as_float((unsigned)st[ST_DELTA]);
  if (!(delta > tol && it < max_iters)) st[ST_DONE] = 1;
}

inline float host_f32b(int bits) {
  float f;
  std::memcpy(&f, &bits, sizeof f);
  return f;
}

}  // namespace yt

using namespace yt;

// rowptr int32[n + 1], src_s int32[e], w_s f32[e]: the CSR by
// destination; heavy int32[n_heavy]: the destinations of more than
// BR_LIGHT in-edges; dangling bool[n]; rb0 f32[n] holds r0, rb1 f32[n]
// scratch; part f32[part_len] the tree's scratch; state int32[8] zeroed.
// Launches max_iters steps; steps after the stop return at once.
extern "C" int yt_power_iterate(const void* rowptr, const void* src_s,
                                const void* w_s, const void* heavy,
                                int n_heavy, const void* dangling, int64_t n,
                                void* rb0, void* rb1, void* part,
                                int64_t part_len, void* state, int d_bits,
                                int inv_bits, int tele_bits, int tol_bits,
                                int max_iters, void* stream) {
  if (n < 1 || n >= (int64_t)1 << 31 || n_heavy < 0 || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t nwin = n > BR_WIN ? (n + BR_WIN - 1) / BR_WIN : 0;
  const int64_t lvl = (nwin + BR_WIN - 1) / BR_WIN;
  if (part_len < nwin + 2 * lvl) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* p0 = (float*)part;
  float* sa = p0 + nwin;
  float* sb = sa + lvl;
  const int64_t lo = (nwin * BR_WIN - n) / 2;
  const float d = host_f32b(d_bits), inv = host_f32b(inv_bits),
              tele = host_f32b(tele_bits), tol = host_f32b(tol_bits);
  auto* st = (int*)state;
  auto* r0 = (float*)rb0;
  auto* r1 = (float*)rb1;
  const auto* dg = (const bool*)dangling;
  const unsigned light_grid = (unsigned)((n + BR_THREADS - 1) / BR_THREADS);
  cudaError_t e;
  for (int it = 0; it < max_iters; ++it) {
    if (nwin) {
      br_windows<<<(unsigned)((nwin + BR_THREADS - 1) / BR_THREADS),
                   BR_THREADS, 0, s>>>(r0, r1, dg, n, lo, nwin, p0, st);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    br_finish<<<1, BR_FINISH_THREADS, 0, s>>>(r0, r1, dg, n, p0, nwin, sa,
                                              sb, inv, st);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    br_light<<<light_grid, BR_THREADS, 0, s>>>(
        (const int*)rowptr, (const int*)src_s, (const float*)w_s, r0, r1, n,
        d, tele, st);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (n_heavy) {
      br_heavy<<<(unsigned)n_heavy, BR_HEAVY_THREADS, 0, s>>>(
          (const int*)heavy, (const int*)rowptr, (const int*)src_s,
          (const float*)w_s, r0, r1, d, tele, st);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    br_step_end<<<1, 1, 0, s>>>(st, tol, max_iters);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
