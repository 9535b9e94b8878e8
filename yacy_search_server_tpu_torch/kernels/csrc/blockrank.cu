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
// Design: one persistent launch a call (a cooperative launch, so every
// block is resident; the grid is the occupancy's blocks an SM, two at
// most 112 registers, times the SMs). The wrapper lays the edges out once
// a call as a CSR by destination (a stable sort keeps each destination's
// edges in edge order) and a work list: the hubs (more than the wrapper's
// hub_min in-edges) by descending in-degree, ties by host id, then the
// medium destinations (33 .. hub_min in-edges) the same way; every other
// host is light (at most BR_LIGHT in-edges). A step:
//   1. every warp sums a window of the tree's second level: its 32
//      first-level windows (loaded coalesced, a window's 32 values summed
//      in order across the lanes by shuffles), then those 32 sums in
//      order; the last block to finish (an atomic ticket) sums the upper
//      levels and publishes dm through a flag word (the step it belongs
//      to);
//   2. blocks take hubs off the list (an atomic counter, so the longest
//      chains start first): eight warps stage 1,024 products a round in
//      shared memory, four gathers in flight a thread, from r alone, so
//      staging starts before dm is known; one thread waits for the flag
//      and adds them in edge order, reading 16 products ahead into
//      registers so that each add waits only on the one before;
//   3. warps take medium destinations off the list: a lane a product,
//      eight rounds of 32 in flight, lane order broadcast to every lane by
//      shuffles and added in edge order;
//   4. blocks take chunks of 1,152 hosts off a counter; a thread sums the
//      light destinations among its 4 side by side (their loads in
//      flight together), each from dm in edge order;
//   5. delta (a max of non-negative floats, kept as bit patterns, which
//      order as unsigned ints) is folded by atomicMax into one slot; a
//      grid barrier (the last block to arrive counts the step, takes the
//      stop test, clears the slot and the counters before it lets the
//      others go) ends the step. No launch follows the stop.
// Ranks written in a step are read in the next by other SMs: every read
// of r, of the tree's scratch and of the state goes to L2 (ld.cg or
// volatile), never to an SM's L1, which is not coherent.
//
// Bound: the bytes a step, 12 an edge (src, weight, the gathered rank)
// and 8 a host (read, write), as the JAX roofline's cost model counts
// them (ops/roofline.py:541): at the realistic graph (5.2M edges, 1M
// hosts) 70 MB, 0.021 ms a step at 3.35 TB/s. What bounds a step is the
// biggest hub's sum, one dependent chain of in-degree adds (about 4
// cycles each: 0.09-0.10 ms a step for that graph's 45,139 in-edges at
// 1.755-1.98 GHz).
#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace yt {

constexpr int BR_WIN = 32;            // XLA's tree-reduction window
constexpr int BR_LIGHT = 32;          // in-degree summed by one thread
constexpr int BR_STAGERS = 256;       // a hub's stagers, 4 products each
constexpr int BR_PER = 4;
constexpr int BR_CHUNK = BR_STAGERS * BR_PER;   // products staged a round
constexpr int BR_THREADS = 32 + BR_STAGERS;     // warp 0 adds a hub
constexpr int BR_AHEAD = 8;           // a medium warp's rounds in flight
constexpr int BR_LPER = 4;            // light destinations a thread a chunk
constexpr int BR_LCHUNK = BR_LPER * BR_THREADS;   // hosts a light chunk
constexpr unsigned long long BR_HANG_NS = 30ull * 1000 * 1000 * 1000;

// the state, int32[BR_STATE]: the stop flag, steps done, dm's bits, the
// step whose dm is published (steps + 1), which rank buffer is current,
// the step's delta bits, the windows' ticket, the barrier's arrivals and
// generation (steps ended), the hub, medium and light counters
constexpr int ST_DONE = 0, ST_ITERS = 1, ST_DM = 2, ST_DMSTEP = 3,
              ST_CUR = 4, ST_DELTA = 5, ST_WTICKET = 6, ST_ARRIVE = 7,
              ST_GEN = 8, ST_HUB = 9, ST_MED = 10, ST_LIGHT = 11,
              BR_STATE = 16;

struct BrArgs {
  const int* rowptr;      // [n + 1]
  const int* src;         // [e], by destination
  const float* w;         // [e]
  const int* order;       // [n_hub + n_med]: hubs, then medium
  const bool* dangling;   // [n]
  float* rb0;             // r0 in, then the ranks of even steps
  float* rb1;
  float* part;            // the tree's first level [nwin]
  float* sa;              // its upper levels, ping-pong
  float* sb;
  int* st;
  int64_t n, nwin, lo;
  int n_hub, n_med, max_iters;
  float d, inv, tele, tol;
};

__device__ __forceinline__ int br_ld(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ unsigned long long br_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// spin until st[i] >= want; a wait far past any real step traps (the call
// fails loudly, never with a wrong answer)
__device__ __forceinline__ void br_wait(const int* st, int i, int want) {
  unsigned long long t0 = 0;
  while (br_ld(st + i) < want) {
    __nanosleep(64);
    const unsigned long long t = br_now();
    if (!t0) t0 = t;
    else if (t - t0 > BR_HANG_NS) __trap();
  }
  __threadfence();
}

__device__ __forceinline__ float br_dm(const BrArgs& a, int step) {
  br_wait(a.st, ST_DMSTEP, step + 1);
  return __int_as_float(br_ld(a.st + ST_DM));
}

__device__ __forceinline__ float br_update(const BrArgs& a, float acc,
                                           const float* r, float* out,
                                           int v) {
  const float r2 = __fmaf_rn(a.d, acc, a.tele);
  __stcg(out + v, r2);
  return fabsf(__fsub_rn(r2, __ldcg(r + v)));
}

__device__ __forceinline__ void br_delta(const BrArgs& a, float diff) {
  const unsigned b = __float_as_uint(diff);
  if (b) atomicMax(reinterpret_cast<unsigned*>(a.st + ST_DELTA), b);
}

// the ordered sum, from 0, of the 32 values a warp holds (lane t's value
// t-th) for up to 4 windows side by side; every lane gets the sums
template <int K>
__device__ __forceinline__ void br_lanes_sum(const float (&v)[K],
                                             float (&s)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = 0.0f;
#pragma unroll
  for (int t = 0; t < BR_WIN; ++t) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      s[k] = __fadd_rn(s[k], __shfl_sync(0xffffffffu, v[k], t));
  }
}

// a lane's value of level-1 window w: where(dangling, r, 0) at position
// 32w - lo + lane, 0 past [0, n) (padding, and live hosts' zeros: adding
// 0 to a non-negative sum changes nothing)
__device__ __forceinline__ float br_leaf(const BrArgs& a, const float* r,
                                         int64_t w, int lane) {
  const int64_t p = w * BR_WIN - a.lo + lane;
  if (w < 0 || w >= a.nwin || p < 0 || p >= a.n) return 0.0f;
  const float x = __ldcg(r + p);
  return a.dangling[p] ? x : 0.0f;
}

// the tree's first two levels, a window of the second level a warp: its
// 32 first-level windows (32 positions each, loaded coalesced, 4 windows
// side by side) each summed in order across the lanes, then added in
// order. With nwin <= 32 there is one level: a window a warp into part.
__device__ void br_lower(const BrArgs& a, const float* r, int64_t gwarp,
                         int64_t nwarps, int lane) {
  if (a.nwin <= BR_WIN) {
    for (int64_t w = gwarp; w < a.nwin; w += nwarps) {
      float v[1] = {br_leaf(a, r, w, lane)}, t[1];
      br_lanes_sum(v, t);
      if (lane == 0) __stcg(a.part + w, t[0]);
    }
    return;
  }
  const int64_t m2 = (a.nwin + BR_WIN - 1) / BR_WIN;
  const int64_t lo2 = (m2 * BR_WIN - a.nwin) / 2;
  for (int64_t u = gwarp; u < m2; u += nwarps) {
    float acc = 0.0f;
    for (int t0 = 0; t0 < BR_WIN; t0 += 4) {
      float v[4], t[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = br_leaf(a, r, u * BR_WIN + t0 + k - lo2, lane);
      br_lanes_sum(v, t);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = __fadd_rn(acc, t[k]);
    }
    if (lane == 0) __stcg(a.sa + u, acc);
  }
}

// the upper tree levels from the second (in sa; ping-pong between sb and
// part) by the block's warps, a window a warp, then the last <= 32 values
// in order by warp 0, and dm published; with nwin <= 32 the last values
// are the first level's (part), with n <= 32 r's own
__device__ void br_upper(const BrArgs& a, const float* r, int step) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* src;
  int64_t len;
  if (a.nwin > BR_WIN) {
    src = a.sa;
    len = (a.nwin + BR_WIN - 1) / BR_WIN;
    float* dst = a.sb;
    while (len > BR_WIN) {
      const int64_t m = (len + BR_WIN - 1) / BR_WIN;
      const int64_t lo = (m * BR_WIN - len) / 2;
      for (int64_t w = warp; w < m; w += blockDim.x / 32) {
        const int64_t i = w * BR_WIN - lo + lane;
        float v[1] = {i >= 0 && i < len ? __ldcg(src + i) : 0.0f}, t[1];
        br_lanes_sum(v, t);
        if (lane == 0) __stcg(dst + w, t[0]);
      }
      __syncthreads();
      src = dst;
      dst = dst == a.sb ? a.part : a.sb;
      len = m;
    }
  } else {
    src = a.nwin ? a.part : r;
    len = a.nwin ? a.nwin : a.n;
  }
  if (warp == 0) {
    float v[1] = {lane < len ? __ldcg(src + lane) : 0.0f}, t[1];
    if (!a.nwin && lane < len && !a.dangling[lane]) v[0] = 0.0f;
    br_lanes_sum(v, t);
    if (lane == 0) {
      a.st[ST_DM] = __float_as_int(__fmul_rn(t[0], a.inv));
      a.st[ST_WTICKET] = 0;      // every block has taken its ticket
      __threadfence();
      atomicExch(a.st + ST_DMSTEP, step + 1);
    }
  }
}

// stager t's products of a round: BR_PER independent gathers in flight
__device__ __forceinline__ void br_stage(float* dst, const BrArgs& a,
                                         const float* r, int base, int end,
                                         int t) {
  float p[BR_PER];
#pragma unroll
  for (int k = 0; k < BR_PER; ++k) {
    const int e = base + t + k * BR_STAGERS;
    p[k] = e < end ? __fmul_rn(__ldg(a.w + e), __ldcg(r + __ldg(a.src + e)))
                   : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < BR_PER; ++k) dst[t + k * BR_STAGERS] = p[k];
}

// acc plus cnt staged products in order. A full round is one straight
// run of loads and adds (no branch: the loads are scheduled ahead of the
// adds that wait on them); a short round is a loop of 4 at a time.
__device__ __forceinline__ float br_add(const float* b, int cnt, float acc) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  if (cnt == BR_CHUNK) {
#pragma unroll
    for (int i = 0; i < BR_CHUNK / 4; ++i) {
      const float4 x = b4[i];
      acc = __fadd_rn(acc, x.x);
      acc = __fadd_rn(acc, x.y);
      acc = __fadd_rn(acc, x.z);
      acc = __fadd_rn(acc, x.w);
    }
    return acc;
  }
  int k = 0;
  for (; k + 4 <= cnt; k += 4) {
    const float4 x = b4[k >> 2];
    acc = __fadd_rn(acc, x.x);
    acc = __fadd_rn(acc, x.y);
    acc = __fadd_rn(acc, x.z);
    acc = __fadd_rn(acc, x.w);
  }
  for (; k < cnt; ++k) acc = __fadd_rn(acc, b[k]);
  return acc;
}

// a hub by the whole block: warps 1-8 stage the next round's products
// while thread 0 adds the current round's (it waits for dm once a step)
__device__ void br_hub(const BrArgs& a, const float* r, float* out, int v,
                       int step, float (*buf)[BR_CHUNK], float& dm,
                       bool& have_dm) {
  const int beg = __ldg(a.rowptr + v), end = __ldg(a.rowptr + v + 1);
  const int nch = (end - beg + BR_CHUNK - 1) / BR_CHUNK;
  const int t = (int)threadIdx.x - 32;
  if (t >= 0) br_stage(buf[0], a, r, beg, end, t);
  __syncthreads();
  float acc = 0.0f;
  if (threadIdx.x == 0) {
    if (!have_dm) {
      dm = br_dm(a, step);
      have_dm = true;
    }
    acc = dm;
  }
  for (int c = 0; c < nch; ++c) {
    if (t >= 0) {
      if (c + 1 < nch)
        br_stage(buf[(c + 1) & 1], a, r, beg + (c + 1) * BR_CHUNK, end, t);
    } else if (threadIdx.x == 0) {
      const int rest = end - beg - c * BR_CHUNK;
      acc = br_add(buf[c & 1], rest < BR_CHUNK ? rest : BR_CHUNK, acc);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) br_delta(a, br_update(a, acc, r, out, v));
}

// product of edge e, 0 past the end
__device__ __forceinline__ float br_prod(const BrArgs& a, const float* r,
                                         int e, int end) {
  return e < end ? __fmul_rn(__ldg(a.w + e), __ldcg(r + __ldg(a.src + e)))
                 : 0.0f;
}

// a medium destination by one warp: lane l holds the products of edges
// beg + 32 i + l for BR_AHEAD rounds i ahead; every lane adds the round's
// 32 in lane order (broadcast by shuffles), so all lanes hold the sum
__device__ void br_medium(const BrArgs& a, const float* r, float* out,
                          int v, float dm) {
  const int lane = threadIdx.x & 31;
  const int beg = __ldg(a.rowptr + v), end = __ldg(a.rowptr + v + 1);
  float p[BR_AHEAD];
#pragma unroll
  for (int i = 0; i < BR_AHEAD; ++i) p[i] = br_prod(a, r, beg + 32 * i + lane,
                                                    end);
  float acc = dm;
  for (int base = beg; base < end; base += 32 * BR_AHEAD) {
#pragma unroll
    for (int i = 0; i < BR_AHEAD; ++i) {
      const int rb = base + 32 * i;
      if (rb < end) {
        const float cur = p[i];
        p[i] = br_prod(a, r, rb + 32 * BR_AHEAD + lane, end);
        const int cnt = end - rb < 32 ? end - rb : 32;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float x = __shfl_sync(0xffffffffu, cur, j);
          if (j < cnt) acc = __fadd_rn(acc, x);
        }
      }
    }
  }
  if (lane == 0) br_delta(a, br_update(a, acc, r, out, v));
}

__global__ void __launch_bounds__(BR_THREADS, 2)
br_iterate(const BrArgs a) {
  __shared__ __align__(16) float buf[2][BR_CHUNK];
  __shared__ int s_int;
  __shared__ float s_dm;
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t gt = (int64_t)blockIdx.x * BR_THREADS + tid;
  const int64_t gsz = (int64_t)gridDim.x * BR_THREADS;
  int step = 0;
  bool done = a.max_iters <= 0;
  while (!done) {
    const float* r = (step & 1) ? a.rb1 : a.rb0;
    float* out = (step & 1) ? a.rb0 : a.rb1;
    // 1. the tree's first two levels, a second-level window a warp
    br_lower(a, r, gt >> 5, gsz >> 5, lane);
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      s_int = atomicAdd(a.st + ST_WTICKET, 1) == (int)gridDim.x - 1;
    }
    __syncthreads();
    if (s_int) {
      __threadfence();
      br_upper(a, r, step);
    }
    // 2. hubs, longest first
    float dm = 0.0f;
    bool have_dm = false;
    for (;;) {
      __syncthreads();
      if (tid == 0) s_int = atomicAdd(a.st + ST_HUB, 1);
      __syncthreads();
      const int h = s_int;
      if (h >= a.n_hub) break;
      br_hub(a, r, out, __ldg(a.order + h), step, buf, dm, have_dm);
    }
    if (tid == 0) s_dm = have_dm ? dm : br_dm(a, step);
    __syncthreads();
    dm = s_dm;
    // 3. medium destinations, a warp each
    for (;;) {
      int m = 0;
      if (lane == 0) m = atomicAdd(a.st + ST_MED, 1);
      m = __shfl_sync(0xffffffffu, m, 0);
      if (m >= a.n_med) break;
      br_medium(a, r, out, __ldg(a.order + a.n_hub + m), dm);
    }
    // 4. light destinations (at most BR_LIGHT in-edges), chunks of
    // BR_LCHUNK hosts taken off a counter; a thread sums BR_LPER of them
    // side by side, each from dm in edge order
    float diff = 0.0f;
    for (;;) {
      __syncthreads();
      if (tid == 0) s_int = atomicAdd(a.st + ST_LIGHT, 1);
      __syncthreads();
      const int64_t base = (int64_t)s_int * BR_LCHUNK;
      if (base >= a.n) break;
      int beg[BR_LPER], cnt[BR_LPER];
      float acc[BR_LPER];
      int most = 0;
#pragma unroll
      for (int k = 0; k < BR_LPER; ++k) {
        const int64_t v = base + tid + k * BR_THREADS;
        beg[k] = 0;
        cnt[k] = -1;                    // no light destination here
        if (v < a.n) {
          beg[k] = __ldg(a.rowptr + v);
          const int c = __ldg(a.rowptr + v + 1) - beg[k];
          if (c <= BR_LIGHT) cnt[k] = c;
        }
        most = max(most, cnt[k]);
        acc[k] = dm;
      }
      // 4 edges of each at a time: their 16 gathers in flight together,
      // then each destination's adds in edge order
      for (int j = 0; j < most; j += 4) {
        float p[BR_LPER][4];
#pragma unroll
        for (int k = 0; k < BR_LPER; ++k)
#pragma unroll
          for (int t = 0; t < 4; ++t)
            p[k][t] = j + t < cnt[k] ? br_prod(a, r, beg[k] + j + t, INT_MAX)
                                     : 0.0f;
#pragma unroll
        for (int k = 0; k < BR_LPER; ++k)
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (j + t < cnt[k]) acc[k] = __fadd_rn(acc[k], p[k][t]);
      }
#pragma unroll
      for (int k = 0; k < BR_LPER; ++k)
        if (cnt[k] >= 0)
          diff = fmaxf(diff, br_update(a, acc[k], r, out,
                                       (int)(base + tid + k * BR_THREADS)));
    }
    const unsigned dmax = __reduce_max_sync(0xffffffffu, __float_as_uint(diff));
    if (lane == 0 && dmax)
      atomicMax(reinterpret_cast<unsigned*>(a.st + ST_DELTA), dmax);
    // 5. the grid barrier; the last block in ends the step
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      if (atomicAdd(a.st + ST_ARRIVE, 1) == (int)gridDim.x - 1) {
        __threadfence();
        const int it = br_ld(a.st + ST_ITERS) + 1;
        const float delta =
            __uint_as_float((unsigned)br_ld(a.st + ST_DELTA));
        a.st[ST_ITERS] = it;
        a.st[ST_CUR] = (step + 1) & 1;
        a.st[ST_DELTA] = 0;
        a.st[ST_HUB] = 0;
        a.st[ST_MED] = 0;
        a.st[ST_LIGHT] = 0;
        a.st[ST_ARRIVE] = 0;
        a.st[ST_DONE] = !(delta > a.tol && it < a.max_iters);
        __threadfence();
        atomicExch(a.st + ST_GEN, step + 1);
      } else {
        br_wait(a.st, ST_GEN, step + 1);
      }
      s_int = br_ld(a.st + ST_DONE);
    }
    __syncthreads();
    done = s_int != 0;
    ++step;
  }
}

inline float host_f32b(int bits) {
  float f;
  std::memcpy(&f, &bits, sizeof f);
  return f;
}

// every block resident: the occupancy's blocks an SM times the SMs (a
// device's figure cached)
inline cudaError_t br_grid(int* out) {
  static int cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0, coop = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, br_iterate,
                                                    BR_THREADS, 0);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *out = per_sm * sms;
  if (dev >= 0 && dev < 64) cached[dev] = *out;
  return cudaSuccess;
}

}  // namespace yt

using namespace yt;

// rowptr int32[n + 1], src_s int32[e], w_s f32[e]: the CSR by
// destination; order int32[n_hub + n_med]: the hubs, then the medium
// destinations (the light ones are the other hosts); dangling bool[n]; rb0 f32[n] holds
// r0, rb1 f32[n] scratch; part f32[part_len] the tree's scratch; state
// int32[BR_STATE] zeroed. One launch runs every step; afterwards state[1]
// holds the steps taken and state[4] the current buffer.
extern "C" int yt_power_iterate(const void* rowptr, const void* src_s,
                                const void* w_s, const void* order,
                                int n_hub, int n_med, const void* dangling,
                                int64_t n, void* rb0, void* rb1, void* part,
                                int64_t part_len, void* state, int d_bits,
                                int inv_bits, int tele_bits, int tol_bits,
                                int max_iters, void* stream) {
  if (n < 1 || n >= (int64_t)1 << 31 || n_hub < 0 || n_med < 0 ||
      (int64_t)n_hub + n_med > n || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t nwin = n > BR_WIN ? (n + BR_WIN - 1) / BR_WIN : 0;
  const int64_t lvl = (nwin + BR_WIN - 1) / BR_WIN;
  if (part_len < nwin + 2 * lvl) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t e = br_grid(&grid);
  if (e != cudaSuccess) return (int)e;
  BrArgs a;
  a.rowptr = (const int*)rowptr;
  a.src = (const int*)src_s;
  a.w = (const float*)w_s;
  a.order = (const int*)order;
  a.dangling = (const bool*)dangling;
  a.rb0 = (float*)rb0;
  a.rb1 = (float*)rb1;
  a.part = (float*)part;
  a.sa = a.part + nwin;
  a.sb = a.sa + lvl;
  a.st = (int*)state;
  a.n = n;
  a.nwin = nwin;
  a.lo = (nwin * BR_WIN - n) / 2;
  a.n_hub = n_hub;
  a.n_med = n_med;
  a.max_iters = max_iters;
  a.d = host_f32b(d_bits);
  a.inv = host_f32b(inv_bits);
  a.tele = host_f32b(tele_bits);
  a.tol = host_f32b(tol_bits);
  void* kargs[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)br_iterate, dim3(grid),
                                  dim3(BR_THREADS), kargs, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
