// The selection of a slot's kk best 64-bit keys over a thread-block
// cluster, each CTA holding its keys in registers: K5 `pruned_tile` and
// K5bp `pruned_tile_bp` (pruned_tile.cu) and K15 `ann_fuse` (ann.cu).
// A larger key ranks first and 0 is the least key (a pad).
//
// A CTA of CS_THREADS threads holds N = E * CS_THREADS keys, E a thread
// (v[E]). Up to PRE_KK a cheap bound leaves few of them for a bitonic
// network: the least over the warps of each warp's (kk / W)-th largest
// thread maximum, which at least kk keys of the CTA reach; the keys at
// or above it are compacted and take the network (select_top), whose kk
// best the CTA stores into run `rank` of the leader CTA's list
// (distributed shared memory); after one cluster barrier the leader
// bounds the lists again and, where one list holds every key that
// reaches the bound, takes it as it is. Past PRE_KK every key takes the
// network (cta_top) and the lists meet in levels of fan-in N / kk through
// distributed shared memory. The network (net_stage): strides inside a
// thread in registers, inside a warp by shuffles, across warps through a
// shared exchange buffer, one barrier a stage; a key costs one compare
// and one select a stage (about 290 cycles a stage whatever its kind,
// PERF.md: so fewer keys pay, not cheaper stages).
#pragma once
#include <cooperative_groups.h>

#include "common.cuh"

namespace yt {

namespace cg = cooperative_groups;

constexpr int CS_THREADS = BP_THREADS;   // a CTA of the cluster selection
constexpr int CS_MAX_CLUSTER = 16;

// ---------------------------------------------------------------------------
// The network (K5, K5bp and K15)
// ---------------------------------------------------------------------------
// A CTA's N = E * T keys (T = CS_THREADS) are the network's: key j of
// thread t has index i = t * E + j, so strides below E stay in a
// thread, strides below 32 E in a warp (shuffles), the rest cross warps
// through the exchange buffer xb (two of N keys, j-major: key j of
// thread t at j * T + t, so that a warp's accesses meet no bank twice
// beyond the two a 64-bit key takes; one barrier a stage, the two
// alternate). A stage of stride s pairs i with i ^ s: both keep the
// larger (BOTH), or the pair is put in order, descending where (i &
// dbit) == 0 (dbit > s; dbit >= N: everywhere). Past the thread,
// whether i is the pair's lower index and which way the pair runs are
// the thread's alone, so a key costs one compare and one select.

// a stage of stride s < E, inside the thread (S a constant, so that every
// index into v stays a register)
template <int E, bool BOTH, int S = 1>
__device__ __forceinline__ void net_thread(u64 (&v)[E], int s, int base,
                                           int dbit) {
  if constexpr (S < E) {
    if (s != S) {
      net_thread<E, BOTH, 2 * S>(v, s, base, dbit);
      return;
    }
    const bool tdesc = (base & dbit) == 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j & S) continue;
      const u64 a = v[j], b = v[j | S];
      const bool first = (a > b) == (BOTH || (tdesc && (j & dbit) == 0));
      v[j] = first ? a : b;
      v[j | S] = BOTH ? v[j] : (first ? b : a);
    }
  }
}

template <int E, bool BOTH>
__device__ __forceinline__ void net_stage(u64 (&v)[E], int s, int dbit,
                                          u64* xb, int& par) {
  constexpr int T = CS_THREADS;
  const int t = threadIdx.x, base = t * E;
  if (s < E) {
    net_thread<E, BOTH>(v, s, base, dbit);
    return;
  }
  const int ts = s / E;
  const bool keep_max = BOTH || (((t & ts) == 0) == ((base & dbit) == 0));
  if (s < 32 * E) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const u64 o = __shfl_xor_sync(0xffffffffu, v[j], ts);
      v[j] = (v[j] > o) == keep_max ? v[j] : o;
    }
  } else {
    u64* b = xb + par * (E * T);
#pragma unroll
    for (int j = 0; j < E; ++j) b[j * T + t] = v[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const u64 o = b[j * T + (t ^ ts)];
      v[j] = (v[j] > o) == keep_max ? v[j] : o;
    }
    par ^= 1;
  }
}

// Runs of kk keys at [0, F kk), alternately descending and ascending,
// become their kk best, sorted descending, at [0, kk): log2 F rounds in
// which runs r and r ^ 1 both keep the larger of each pair (i, i ^ s), a
// bitonic sequence of the pair's kk best, merged in the next run's
// direction. The pairs' copies stay where they are, so every stage takes
// all threads.
template <int E>
__device__ __forceinline__ void net_reduce(u64 (&v)[E], int kk, int span,
                                           u64* xb, int& par) {
  for (int s = kk; s < span; s <<= 1) {
    net_stage<E, true>(v, s, 0, xb, par);
    for (int h = kk >> 1; h > 0; h >>= 1)
      net_stage<E, false>(v, h, s << 1, xb, par);
  }
}

// The CTA's kk best keys, sorted descending, at indices [0, kk) (kk a
// power of two, 16 <= kk <= N): runs of kk sorted, alternately descending
// and ascending (a bitonic sort up to kk), then reduced to one.
template <int E>
__device__ __forceinline__ void cta_top(u64 (&v)[E], int kk, u64* xb,
                                        int& par) {
  constexpr int T = CS_THREADS;
  constexpr int N = E * T;
  for (int len = 2; len <= kk; len <<= 1)
    for (int s = len >> 1; s > 0; s >>= 1)
      net_stage<E, false>(v, s, len, xb, par);
  net_reduce<E>(v, kk, N, xb, par);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The warp's 32 keys (one a lane) sorted descending across its lanes.
__device__ __forceinline__ u64 warp_sort(u64 x, int lane) {
  for (int len = 2; len <= 32; len <<= 1)
    for (int s = len >> 1; s > 0; s >>= 1) {
      const u64 o = __shfl_xor_sync(0xffffffffu, x, s);
      const bool keep_max = ((lane & s) == 0) == ((lane & len) == 0);
      x = (x > o) == keep_max ? x : o;
    }
  return x;
}

// The block's keys v[E] at or above thr, packed into cand[0, M) (in no
// order); returns M. s_sum holds the warps' counts.
template <int E>
__device__ __forceinline__ int compact(const u64 (&v)[E], u64 thr, u64* cand,
                                       int* s_sum) {
  constexpr int T = CS_THREADS;
  constexpr int W = T / 32;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int c = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) c += v[j] >= thr ? 1 : 0;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_sum[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    before += w < warp ? s_sum[w] : 0;
    total += s_sum[w];
  }
  int k = before + incl - c;
#pragma unroll
  for (int j = 0; j < E; ++j)
    if (v[j] >= thr) cand[k++] = v[j];
  __syncthreads();
  return total;
}

// The kk best of the keys cand[0, M) (kk <= M), sorted descending into
// list[0, kk): a network of E' keys a thread, E' the least of 1, 2, 4, 8
// (then EMAX) with E' T >= M (zero keys past M).
template <int E>
__device__ __forceinline__ void select_run(const u64* cand, int M, int kk,
                                           u64* xb, u64* list) {
  const int t = threadIdx.x;
  u64 v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = t * E + j;
    v[j] = i < M ? cand[i] : 0ull;
  }
  int par = 0;
  cta_top<E>(v, kk, xb, par);
  if (t * E < kk) {
#pragma unroll
    for (int j = 0; j < E; ++j) list[t * E + j] = v[j];
  }
}

template <int EMAX>
__device__ __forceinline__ void select_top(const u64* cand, int M, int kk,
                                           u64* xb, u64* list) {
  constexpr int T = CS_THREADS;
  if (M <= T)
    select_run<1>(cand, M, kk, xb, list);
  else if (M <= 2 * T)
    select_run<2>(cand, M, kk, xb, list);
  else if (M <= 4 * T)
    select_run<4>(cand, M, kk, xb, list);
  else if (EMAX <= 8 || M <= 8 * T)
    select_run<8>(cand, M, kk, xb, list);
  else
    select_run<EMAX>(cand, M, kk, xb, list);
}

constexpr int PRE_KK = 128;  // the largest kk the bounds take

// The slot's kk best keys over the cluster's CL CTAs (CL <= 16), each
// holding its keys v[E] (kk a power of two, 16 <= kk <= N; up to PRE_KK
// CL kk <= 8 CS_THREADS). `xb` (2 N keys) and `cand` (N keys) are the
// CTA's exchange buffer and candidates, `list` (cs_list(CL, kk) keys) its
// list, all in shared memory. Up to PRE_KK: the bound, the compacted keys'
// network, each CTA's kk best stored into run `rank` of the leader's
// `list` (once every CTA of the cluster runs); after one cluster barrier
// the leader bounds the CL lists by the largest of their kk-th keys; a
// list that holds every key reaching it (M2 = kk) is the answer as it
// stands, else the keys reaching it take the network. Past PRE_KK, each
// CTA's network takes its N keys (cta_top) and the lists meet in levels
// of fan-in F = N / kk (F = 2 where a CTA holds one list alone, kk = N:
// the partner's list mirrored, the larger key at each place kept): the
// CTAs of rank a multiple of span * F read the lists of ranks rank +
// span, .., rank + (F - 1) span as runs (odd runs mirrored: ascending)
// and reduce them (net_reduce); one cluster barrier a level. The caller
// arrives at the cluster barrier before (cluster_arrive: this CTA runs)
// and, after reading the answer, arrives and waits once more, so that no
// CTA leaves while another may still read its list. Returns, in the
// leader, the answer's offset in its `list` (kk keys, sorted
// descending).
template <int E>
__device__ __forceinline__ int cluster_select(u64 (&v)[E], u64* xb,
                                              u64* cand, u64* list, int kk,
                                              int CL) {
  constexpr int T = CS_THREADS;
  constexpr int N = E * T, W = T / 32;
  __shared__ u64 s_bound[CS_MAX_CLUSTER > W ? CS_MAX_CLUSTER : W];
  __shared__ int s_sum[W], s_fin;
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, base = t * E;
  if (t == 0) s_fin = 0;
  if (kk <= PRE_KK) {
    u64 m = v[0];
#pragma unroll
    for (int j = 1; j < E; ++j) m = v[j] > m ? v[j] : m;
    m = warp_sort(m, lane);
    const u64 mine = __shfl_sync(0xffffffffu, m, kk / W - 1);
    if (lane == 0) s_bound[warp] = mine;
    __syncthreads();
    u64 thr = s_bound[0];
#pragma unroll
    for (int w = 1; w < W; ++w) thr = s_bound[w] < thr ? s_bound[w] : thr;
    const int M = compact<E>(v, thr, cand, s_sum);
    // each CTA's list goes straight into run `rank` of the leader's
    // `list` (CL kk keys there), once every CTA of the cluster runs
    cluster_wait();
    select_top<E>(cand, M, kk, xb,
                     cl.map_shared_rank(list, 0u) + rank * kk);
    cl.sync();                            // every list in the leader's
    if (rank == 0) {
      // the bound: the largest kk-th key of a list; where one list alone
      // reaches it (M2 = kk), that list is the answer
      u64 g8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int g = 8 * t + j;
        g8[j] = g < CL * kk ? list[g] : 0ull;
        if (g < CL * kk && g % kk == kk - 1) s_bound[g / kk] = g8[j];
      }
      __syncthreads();
      u64 thr2 = s_bound[0];
      int best = 0;
      for (int c = 1; c < CL; ++c)
        if (s_bound[c] > thr2) {
          thr2 = s_bound[c];
          best = c;
        }
      const int M2 = compact<8>(g8, thr2, cand, s_sum);
      if (M2 == kk) {
        if (t == 0) s_fin = best * kk;
      } else {
        select_top<8>(cand, M2, kk, xb, list);
      }
    }
  } else {
    int par = 0;
    cta_top<E>(v, kk, xb, par);
    const bool whole = kk == N;            // a CTA holds one list alone
    const int F = whole ? 2 : (N / kk < CL ? N / kk : CL);
    if (base < kk) {
#pragma unroll
      for (int j = 0; j < E; ++j) list[base + j] = v[j];
    }
    cluster_wait();
    cl.sync();                            // every list written
    for (int span = 1; span < CL; span *= F) {
      if (rank % (span * F) == 0) {
        // thread t's keys lie in run c at places p0 .. p0 + E - 1
        const int c = whole ? 1 : base / kk, p0 = base % kk;
        const int from = rank + span * c;
        if (c > 0 && c < F && base < (whole ? kk : F * kk)) {
          const bool up = whole || (c & 1);   // the run read mirrored
          const u64* p = from < CL
                             ? cl.map_shared_rank(list, (unsigned)from)
                             : nullptr;
#pragma unroll
          for (int j = 0; j < E; ++j) {
            const u64 w = p ? p[up ? kk - 1 - (p0 + j) : p0 + j] : 0ull;
            v[j] = whole ? (v[j] > w ? v[j] : w) : w;
          }
        }
        if (whole) {
          for (int h = kk >> 1; h > 0; h >>= 1)
            net_stage<E, false>(v, h, N, xb, par);
        } else {
          net_reduce<E>(v, kk, F * kk, xb, par);
        }
        // no CTA reads a receiver's list in its own level
        if (base < kk && (span * F < CL || rank == 0)) {
#pragma unroll
          for (int j = 0; j < E; ++j) list[base + j] = v[j];
        }
      }
      if (span * F < CL) cl.sync();       // the level's reads and lists done
    }
  }
  if (rank == 0) __syncthreads();         // s_fin, and the answer
  return s_fin;
}

// The keys of a CTA's list: up to PRE_KK the leader's holds all CL
// CTAs' lists
__host__ __device__ constexpr int cs_list(int cl, int kk) {
  return kk <= PRE_KK ? cl * kk : kk;
}

}  // namespace yt
