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
//   similarity mode: no warp a row and no shuffle. Blocks of 4 warps,
//     two an SM, stage tiles of 64 rows by 16-byte cp.async into a ring
//     of two (32 KB each; a row's 16-byte groups placed by row & 7), the
//     next tile's copies in flight while a tile is summed; each thread rounds
//     the chunks it copied to bf16 in place (once a tile), and warp w
//     takes the tile's chunks of 4 queries w, w + 4, ...: a thread holds
//     2 rows (lane, lane + 32) x up to 4 queries of sums in registers and
//     walks the 32 eight-element groups in the bit-reversed order of
//     their lane (0, 16, 8, 24, 4, ...), where the butterfly's tree is a
//     pairwise tree over consecutive groups (a binary counter of at most
//     5 partials a pair). Queries (up to 32 a pass, rounded once a block)
//     are read by broadcast; a query's outputs are stored 32 rows a warp
//     store. Where every staged query element is 0 or within [2^-100,
//     2^100], each group's leaf pairs are fma(d1, q1, d0 * q0): a bf16
//     product is then exact in f32 (16 significant bits, above 2^-126),
//     so the fma equals the add of the two products. Bound: the block
//     read once (1 GiB at 2^21 rows: 0.32 ms) and B x n x 4 bytes of
//     output; at B = 16 the ALU would bind first (383 operations a (row,
//     query) pair with the fma, 511 without, 12.8G lane operations: about
//     0.43 ms at ~30T a second), but the kernel runs at about half the
//     issue rate (PERF.md: neither 8 warps an SM in one block, nor 4
//     rows a thread over half-tiles, nor the 25 % fewer operations of the
//     fma moved it much).
//
// K10, the sort: each slot's nb (a power of two <= 16384) lanes sorted
// on (key, lane), key = the 64-bit (score half, docid half): the score
// half orders -final as lax.sort does (the wrapping negation of kernel 3's
// tie mode, common.cuh:tie_hi), the docid half is docid ^ 0x80000000,
// INT32_MAX on lanes at or past n_valid. The lane breaks full ties, which
// makes the result the stable sort's (lax.sort is stable). Output: the
// sorted finals then the sorted docids over all nb lanes. Bound: 8 bytes
// a lane in, 8 out. Keys and lanes sit in shared memory, 10 bytes a lane.
//   Only the live prefix is sorted. A pad lane (at or past n_valid) whose
//   final is -(2^31-1), as K9 writes every pad lane, has the largest key
//   there is (tie_hi(-(2^31-1)) and sec_key(INT32_MAX) are both all ones),
//   and the pad lanes are the slot's last lanes. So if every pad lane holds
//   -(2^31-1), each lane in [m, nb), m the power of two at least n_valid,
//   sorts after every lane below m (its key is larger, or equal and its
//   lane larger), and those lanes keep their lane order among themselves:
//   the stable sort of all nb lanes is the sort of [0, m) followed by
//   lanes m..nb-1 as they are. The kernel checks the pad lanes (any other
//   final sorts the whole slot, m = nb), sorts [0, m) and copies the rest;
//   a slot with n_valid 0 is a copy (the pad slots of a solo rerank).
//   The network: a key a thread, in registers (rs_sort_regs: the strides
//   below 32 by warp shuffles, the others through a double buffer in
//   shared memory, one barrier a step); every layout gives a CTA a thread
//   a lane it holds.
//   One block a slot below nb = RS_CLUSTER_NB (1,024).
//   A thread-block cluster a slot from there: nb / RS_CHUNK CTAs, up to
//   16, each holding kc = nb / ctas lanes. A slot of m live lanes takes
//   A = m / k of them, k = min(m,
//   kc): CTA r sorts lanes [r k, r k + k), then log2(A) rounds merge the
//   sorted runs pairwise across the cluster's distributed shared memory.
//   In a round each CTA owns k consecutive places of its pair's merged
//   run: two warps find the merge-path split of its first and last place
//   (a 32-way search, each lane probing one split through
//   map_shared_rank), the CTA copies the two pieces it needs from the
//   runs into a local stage, a cluster barrier (every stage read: the
//   runs may change), each thread merges its places locally (a binary
//   search on its own diagonal), a cluster barrier (the merged runs
//   written); the last round writes the finals and docids to device
//   memory, coalesced, between its barrier's arrive and wait, so no CTA
//   leaves while another still reads its shared memory. A cluster
//   barrier also follows the local sort. (key, lane) is unique in a slot,
//   so every merge is exact. Every CTA of a cluster reads the slot's
//   n_valid and all its pad lanes, so all agree on m and on the rounds
//   without a barrier first; the CTAs past A only copy pad lanes. That
//   check reads a pad lane once a CTA: 16 times at nb = 16,384 (~15.7 MB
//   for the serving solo shape's 15 pad slots, against a bound of 4.2 MB
//   for the call), mostly from the L2 cache; the live slot's sort takes
//   most of the call all the same.
//   Measured on an H100 (PERF.md): 512 lanes a CTA beat 256 and
//   1,024 where nb allows, one block beat a cluster below nb = 1,024, the
//   register network beat the shared-memory one by 20-30 %.
// K11, the blend: pass 1, a grid of (chunk, slot) blocks, reduces each
// chunk's min of where(valid, s, 1e30) and max of where(valid, s, -1e30)
// (exact in any order); pass 2 reduces a slot's chunk results in every
// block and writes (1 - alpha) * ((s - min) / max(max - min, 1e-6)) +
// alpha * sims on valid lanes, -inf elsewhere, in JAX's operation order.
// Bound: sims, sparse and valid read (9 bytes a lane), the output written.
#include <cooperative_groups.h>

#include <cstring>

#include "dense_dot.cuh"

namespace cg = cooperative_groups;

namespace yt {

constexpr int DD_WARPS = 8;              // warps a block of K9
constexpr int DD_THREADS = DD_WARPS * 32;
constexpr int DD_SQ = 32;                // queries a K9 similarity pass
constexpr int SIM_THREADS = 128;         // a K9 similarity block, 4 warps
constexpr int SIM_ROWS = 64;             // rows a staged tile: 2 a lane
constexpr int SIM_STAGE_BYTES = SIM_ROWS * DD_DIM * 2;    // 32 KB of f16
constexpr int SIM_CHUNKS = SIM_STAGE_BYTES / 16 / SIM_THREADS;
constexpr int SIM_STAGES = 2;            // the ring's tiles
constexpr int SIM_SMEM = SIM_STAGES * SIM_STAGE_BYTES + DD_SQ * DD_DIM * 4;
constexpr int RS_MAX_NB = 1 << 14;
constexpr int RS_THREADS = 1024;         // a K10 block (fewer at nb < 1024)
constexpr int RS_CHUNK = 512;            // lanes a CTA holds, cluster path
constexpr int RS_CLUSTER_NB = 1024;      // lanes from which a cluster sorts
constexpr int RS_MAX_CTAS = 16;          // a cluster (8 is the portable size)
// a cluster's CTA holds at most 1,024 lanes in three buffers of 10 bytes a
// lane, one block at most 512 and the network's double buffer: no launch
// needs more than the 48 KB of shared memory a kernel has unasked
static_assert(3 * (RS_MAX_NB / RS_MAX_CTAS) * 10 <= 48 * 1024 &&
              RS_MAX_NB / RS_MAX_CTAS <= RS_THREADS, "K10's layout");
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

// K9 similarity mode (head note): a block a run of tiles, SIM_ROWS rows a
// tile staged by 16-byte cp.async into a ring of two tiles; each
// thread converts the chunks it copied to bf16 in place, then computes a
// register tile of 2 rows x up to 4 queries over the 32 groups in the
// lanes' bit-reversed order, folding the butterfly's tree as a pairwise
// tree over consecutive groups. No warp shuffle.

// chunk c (16 bytes, the dot's group c) of a staged row r sits at 16-byte
// place c ^ (r & 7) of its row: the 8 lanes of a quarter warp (8
// consecutive rows) that read one group hit 8 different bank quads
__device__ __forceinline__ int sim_place(int r, int c) {
  return r * (DD_DIM / 8) + (c ^ (r & 7));
}

// 8 f16 values bf16-rounded (to nearest even), as bf16 pairs, low element
// in the low half
__device__ __forceinline__ uint4 sim_to_bf16(uint4 u) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __float22bfloat162_rn(__half22float2(h[i]));
    o[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// 8 bf16 values (4 pairs) as floats, exactly
__device__ __forceinline__ void sim_unpack(const uint4 u, float* v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// a group's 8-product tree, ((p0+p1)+(p2+p3))+((p4+p5)+(p6+p7)); with FMA
// each leaf pair is fma(d1, q1, d0 * q0), equal where the products are
// exact (the kernel takes it only then)
template <bool FMA>
__device__ __forceinline__ float sim_group(const float* d, const float4 qa,
                                           const float4 qb) {
  float a0, a1, a2, a3;
  if (FMA) {
    a0 = __fmaf_rn(d[1], qa.y, __fmul_rn(d[0], qa.x));
    a1 = __fmaf_rn(d[3], qa.w, __fmul_rn(d[2], qa.z));
    a2 = __fmaf_rn(d[5], qb.y, __fmul_rn(d[4], qb.x));
    a3 = __fmaf_rn(d[7], qb.w, __fmul_rn(d[6], qb.z));
  } else {
    a0 = __fadd_rn(__fmul_rn(d[0], qa.x), __fmul_rn(d[1], qa.y));
    a1 = __fadd_rn(__fmul_rn(d[2], qa.z), __fmul_rn(d[3], qa.w));
    a2 = __fadd_rn(__fmul_rn(d[4], qb.x), __fmul_rn(d[5], qb.y));
    a3 = __fadd_rn(__fmul_rn(d[6], qb.z), __fmul_rn(d[7], qb.w));
  }
  return __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
}

// One unit: tile rows lane and lane + 32 against Q
// staged queries (sq: Q x DD_DIM bf16-rounded floats), written to
// out[q * n + row] for rows below n. Walk position k = 8m + jj visits
// group brev5(k) = (brev3(jj) << 2) | brev2(m): in that order the
// butterfly (lane l with l ^ 16 first, then ^ 8 .. ^ 1) is a pairwise
// tree over consecutive positions, so a position's sum is folded with
// the partials below it as a binary counter does (levels 0-2 inside the
// 8 unrolled positions, levels 3-4 across m).
template <int Q, bool FMA>
__device__ __forceinline__ void sim_unit(const uint4* __restrict__ stage,
                                         const float* __restrict__ sq,
                                         int lane, int64_t row0, int64_t n,
                                         float* __restrict__ out) {
  const uint4* rows[2] = {stage + lane * (DD_DIM / 8),
                          stage + (lane + 32) * (DD_DIM / 8)};
  const int sw = lane & 7;            // r & 7 of both rows
  float a3[2][Q], a4[2][Q], res[2][Q];
#pragma unroll 1
  for (int m = 0; m < 4; ++m) {
    const int gm = ((m & 1) << 1) | (m >> 1);
    const int x = gm ^ sw;
    const float* qm = sq + 8 * gm;
    float l0[2][Q], l1[2][Q], l2[2][Q], c3[2][Q];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int gs = (((jj & 1) << 2) | (jj & 2) | ((jj >> 2) & 1)) << 2;
      float d[2][8];
      sim_unpack(rows[0][gs ^ x], d[0]);
      sim_unpack(rows[1][gs ^ x], d[1]);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4* qq =
            reinterpret_cast<const float4*>(qm + q * DD_DIM + 8 * gs);
        const float4 qa = qq[0], qb = qq[1];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float c = sim_group<FMA>(d[j], qa, qb);
          if (jj & 1) {
            c = __fadd_rn(l0[j][q], c);
            if (jj & 2) {
              c = __fadd_rn(l1[j][q], c);
              if (jj & 4) {
                c3[j][q] = __fadd_rn(l2[j][q], c);
              } else {
                l2[j][q] = c;
              }
            } else {
              l1[j][q] = c;
            }
          } else {
            l0[j][q] = c;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (m & 1) {
          const float c = __fadd_rn(a3[j][q], c3[j][q]);
          if (m & 2) {
            res[j][q] = __fadd_rn(a4[j][q], c);
          } else {
            a4[j][q] = c;
          }
        } else {
          a3[j][q] = c3[j][q];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t row = row0 + lane + 32 * j;
    if (row < n) {
#pragma unroll
      for (int q = 0; q < Q; ++q) out[(int64_t)q * n + row] = res[j][q];
    }
  }
}

template <bool FMA>
__device__ __forceinline__ void sim_unit_q(int qc, const uint4* stage,
                                           const float* sq, int lane,
                                           int64_t row0, int64_t n,
                                           float* out) {
  switch (qc) {
    case 4: sim_unit<4, FMA>(stage, sq, lane, row0, n, out); break;
    case 3: sim_unit<3, FMA>(stage, sq, lane, row0, n, out); break;
    case 2: sim_unit<2, FMA>(stage, sq, lane, row0, n, out); break;
    default: sim_unit<1, FMA>(stage, sq, lane, row0, n, out); break;
  }
}

// K9 similarity mode: sims[q, i] = dot(docs[i], qvecs[q]); grid.y passes
// over the queries DD_SQ at a time, grid.x blocks take tiles i = x, x +
// gridDim.x, ..., a block's warps the tile's chunks of 4 queries w, w + 4,
// ... Dynamic shared memory: the ring, then the pass's queries.
__global__ void __launch_bounds__(SIM_THREADS)
dense_sims(const __half* __restrict__ docs, int64_t n,
           const float* __restrict__ qvecs, int nq,
           float* __restrict__ sims) {
  extern __shared__ __align__(16) unsigned char sim_smem[];
  uint4* ring = reinterpret_cast<uint4*>(sim_smem);
  float* sq =
      reinterpret_cast<float*>(sim_smem + SIM_STAGES * SIM_STAGE_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * DD_SQ;
  const int nqb = min(DD_SQ, nq - q0);
  // the queries rounded once a block; FMA only where every product is
  // exact: a nonzero rounded element in [2^-100, 2^100] times a doc element
  // (|x| >= 2^-24 where nonzero, f16) stays a normal f32, 16 bits wide
  int exact = 1;
  for (int i = tid; i < nqb * DD_DIM; i += SIM_THREADS) {
    const float x = bf16r(__ldg(qvecs + (int64_t)q0 * DD_DIM + i));
    sq[i] = x;
    const float ax = fabsf(x);
    exact &= (x == 0.0f) | ((ax >= 0x1p-100f) & (ax <= 0x1p100f));
  }
  const bool fma = __syncthreads_and(exact) != 0;
  const int64_t ntiles = (n + SIM_ROWS - 1) / SIM_ROWS;
  const int64_t mine =
      ntiles > blockIdx.x ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  // a thread's chunks of a tile: k = tid + SIM_THREADS * i, row k / 32,
  // chunk k % 32 (neighbouring threads on neighbouring 16 bytes)
  auto issue = [&](int64_t i) {
    if (i < mine) {
      const int64_t row0 = (blockIdx.x + i * gridDim.x) * SIM_ROWS;
      uint4* st = ring + (i % SIM_STAGES) * (SIM_STAGE_BYTES / 16);
#pragma unroll
      for (int c = 0; c < SIM_CHUNKS; ++c) {
        const int k = tid + SIM_THREADS * c, r = k >> 5;
        if (row0 + r < n)
          cp_async16(st + sim_place(r, k & 31),
                     docs + (row0 + r) * DD_DIM + 8 * (k & 31));
      }
    }
    cp_async_commit();
  };
  issue(0);
  const int nch = (nqb + 3) / 4;
  for (int64_t i = 0; i < mine; ++i) {
    const int64_t row0 = (blockIdx.x + i * gridDim.x) * SIM_ROWS;
    uint4* st = ring + (i % SIM_STAGES) * (SIM_STAGE_BYTES / 16);
    cp_async_wait<0>();                // this thread's copies of tile i
#pragma unroll
    for (int c = 0; c < SIM_CHUNKS; ++c) {
      const int k = tid + SIM_THREADS * c, r = k >> 5;
      if (row0 + r < n) {
        uint4* p = st + sim_place(r, k & 31);
        *p = sim_to_bf16(*p);
      }
    }
    __syncthreads();   // the tile converted; every thread done with i - 1
    issue(i + 1);                      // into the stage of tile i - 1
    for (int ch = warp; ch < nch; ch += SIM_THREADS / 32) {
      const int qc = min(4, nqb - 4 * ch);
      float* out = sims + (int64_t)(q0 + 4 * ch) * n;
      const float* sqc = sq + 4 * ch * DD_DIM;
      if (fma)
        sim_unit_q<true>(qc, st, sqc, lane, row0, n, out);
      else
        sim_unit_q<false>(qc, st, sqc, lane, row0, n, out);
    }
  }
  cp_async_wait<0>();
}

// K10's 64-bit key of a lane (head note)
__device__ __forceinline__ unsigned long long rs_key(int32_t fin,
                                                     int32_t docid) {
  return ((unsigned long long)tie_hi(fin, false) << 32) | sec_key(docid);
}
__device__ __forceinline__ bool rs_less(unsigned long long ka, uint16_t la,
                                        unsigned long long kb, uint16_t lb) {
  return ka < kb || (ka == kb && la < lb);
}

// The lanes of the slot's sorted prefix, the same in every CTA of a slot:
// nb if a pad lane's final is not -(2^31-1), else the power of two at
// least n_valid (0 for none)
__device__ __forceinline__ int rs_live_len(const int32_t* __restrict__ fin,
                                           int nv, int nb) {
  int bad = 0;
#pragma unroll 4
  for (int i = nv + threadIdx.x; i < nb; i += blockDim.x)
    bad |= __ldg(fin + i) != SMALL;
  if (__syncthreads_or(bad)) return nb;
  int m = nv ? 1 : 0;
  while (m < nv) m <<= 1;
  return m;
}

// K10's network with a key a thread: thread i < n holds (k, l) and ends
// with the i-th smallest of the n (a power of two); the block's threads
// all take part (n <= blockDim.x). Steps of stride 32 or more trade
// through the double buffer xk/xl (2 blockDim.x each), one barrier a
// step; the others by warp shuffles. The comparisons are
// dense_dot.cuh:bitonic_sort's: the lower thread of a pair keeps the
// smaller key in an ascending block, the larger in a descending one.
__device__ __forceinline__ void rs_sort_regs(unsigned long long& k,
                                             uint16_t& l, int n,
                                             unsigned long long* xk,
                                             uint16_t* xl) {
  const int i = threadIdx.x, T = blockDim.x;
  int buf = 0;
  for (int size = 2; size <= n; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      unsigned long long pk;
      uint16_t pl;
      if (j >= 32) {
        xk[buf * T + i] = k;
        xl[buf * T + i] = l;
        __syncthreads();
        pk = xk[buf * T + (i ^ j)];
        pl = xl[buf * T + (i ^ j)];
        buf ^= 1;
      } else {
        pk = __shfl_xor_sync(0xffffffffu, k, j);
        pl = (uint16_t)__shfl_xor_sync(0xffffffffu, (int)l, j);
      }
      if (i < n) {
        const bool keep_min = ((i & j) == 0) == ((i & size) == 0);
        const bool pless = rs_less(pk, pl, k, l);
        if (keep_min == pless) {
          k = pk;
          l = pl;
        }
      }
    }
  }
}

// Element x of a run held k (a power of two, 2^kl) lanes a CTA from CTA
// c0 on, read through the cluster's distributed shared memory
__device__ __forceinline__ void rs_at(const cg::cluster_group& cl,
                                      unsigned long long* key,
                                      uint16_t* lane, int c0, int kl, int x,
                                      unsigned long long& kx, uint16_t& lx) {
  const unsigned c = (unsigned)(c0 + (x >> kl));
  const int o = x & ((1 << kl) - 1);
  kx = *cl.map_shared_rank(key + o, c);
  lx = *cl.map_shared_rank(lane + o, c);
}

// The merge-path split of diagonal t between runs A (CTAs from ca) and B
// (from cb), each of L lanes: how many of the merged run's first t come
// from A. One warp: each lane probes one split, the ballot narrows the
// range 32-fold a step (the predicate A[i] < B[t-1-i] holds for a prefix).
__device__ int rs_split(const cg::cluster_group& cl, unsigned long long* key,
                        uint16_t* lane, int ca, int cb, int kl, int L, int t) {
  const int l = threadIdx.x & 31;
  int lo = t > L ? t - L : 0, hi = t < L ? t : L;
  while (lo < hi) {
    const int n = hi - lo;
    const int p = lo + (int)(((int64_t)l * n) >> 5);
    unsigned long long ka, kb;
    uint16_t la, lb;
    rs_at(cl, key, lane, ca, kl, p, ka, la);
    rs_at(cl, key, lane, cb, kl, t - 1 - p, kb, lb);
    const int c = __popc(__ballot_sync(0xffffffffu, rs_less(ka, la, kb, lb)));
    if (c == 0) {
      hi = lo;
    } else {
      const int pl = lo + (int)(((int64_t)(c - 1) * n) >> 5);
      hi = c < 32 ? lo + (int)(((int64_t)c * n) >> 5) : hi;
      lo = pl + 1;
    }
  }
  return lo;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// K10's merge rounds across the cluster (head note): A runs of k sorted
// lanes, run r in CTA r's first buffer, merged pairwise log2(A) times
__device__ void rs_merge(const int32_t* __restrict__ fin,
                         const int32_t* __restrict__ row,
                         int32_t* __restrict__ o, int nb, int kc, int k,
                         int A, int r, unsigned long long* key,
                         uint16_t* lane) {
  __shared__ int s_split[2];
  const int t = threadIdx.x, T = blockDim.x;
  const cg::cluster_group cl = cg::this_cluster();
  const int kl = __ffs(k) - 1;
  unsigned long long* skey = key + 2 * kc;   // the stage
  uint16_t* slane = lane + 2 * kc;
  cl.sync();                                   // every run sorted
  int cur = 0;
  for (int half = 1; half < A; half <<= 1) {
    const bool last = 2 * half == A;
    unsigned long long* ck = key + cur * kc;
    uint16_t* cln = lane + cur * kc;
    int t0 = 0, na = 0;
    if (r < A) {
      const int g = r & ~(2 * half - 1);       // the pair's first CTA
      const int L = k * half;
      t0 = (r - g) * k;
      if (t < 64) {
        const int s = rs_split(cl, ck, cln, g, g + half, kl, L,
                               t0 + (t >> 5) * k);
        if ((t & 31) == 0) s_split[t >> 5] = s;
      }
      __syncthreads();
      const int i0 = s_split[0];
      na = s_split[1] - i0;
      const int j0 = t0 - i0;
      for (int e = t; e < k; e += T) {
        if (e < na)
          rs_at(cl, ck, cln, g, kl, i0 + e, skey[e], slane[e]);
        else
          rs_at(cl, ck, cln, g + half, kl, j0 + e - na, skey[e], slane[e]);
      }
    }
    if (last) cluster_arrive();   // my reads of the others are done
    else cl.sync();               // every stage read: shares may change
    if (r < A) {
      __syncthreads();
      const int nbb = k - na;
      unsigned long long* nk = key + (cur ^ 1) * kc;
      uint16_t* nl = lane + (cur ^ 1) * kc;
      for (int e = t; e < k; e += T) {
        int lo = e > nbb ? e - nbb : 0, hi = e < na ? e : na;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const int q = na + e - 1 - mid;
          if (rs_less(skey[mid], slane[mid], skey[q], slane[q])) lo = mid + 1;
          else hi = mid;
        }
        const int ib = e - lo;
        const bool a = lo < na && (ib >= nbb ||
                                   rs_less(skey[lo], slane[lo], skey[na + ib],
                                           slane[na + ib]));
        const int at = a ? lo : na + ib;
        if (last) {
          const int src = slane[at];
          o[t0 + e] = __ldg(fin + src);
          o[nb + t0 + e] = __ldg(row + 2 + src);
        } else {
          nk[e] = skey[at];
          nl[e] = slane[at];
        }
      }
    }
    if (last) cluster_wait();     // no CTA leaves while another reads it
    else cl.sync();               // the merged shares written
    cur ^= 1;
  }
}

// The lanes of K10's shared memory (keys, then as many lanes): one block
// a slot holds its kc = nb lanes, a cluster's CTA three buffers of kc (its
// sorted share twice, the stage), and either room past the first buffer
// for the register network's double buffer (2 x threads)
__host__ __device__ __forceinline__ int rs_lanes(bool cluster, int kc,
                                                 int threads) {
  const int own = cluster ? 3 * kc : kc;
  return own > kc + 2 * threads ? own : kc + 2 * threads;
}

// K10: a slot a block (CLUSTER false: keys and lanes of nb lanes) or a slot
// a cluster of `ctas` CTAs (three buffers of kc = nb / ctas keys and lanes:
// two for the sorted share, one for the stage)
template <bool CLUSTER>
__global__ void __launch_bounds__(RS_THREADS)
rerank_sort_k(const int32_t* __restrict__ fin_all,
              const int32_t* __restrict__ qd, int nb, int ctas,
              int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char rs_smem[];
  const int kc = nb / ctas;
  unsigned long long* key = reinterpret_cast<unsigned long long*>(rs_smem);
  uint16_t* lane = reinterpret_cast<uint16_t*>(
      key + rs_lanes(CLUSTER, kc, (int)blockDim.x));
  const int b = blockIdx.x / ctas;
  const int r = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const int t = threadIdx.x, T = blockDim.x;
  const int32_t* row = qd + (int64_t)b * (2 + 2 * nb + DD_DIM);
  const int32_t* fin = fin_all + (int64_t)b * nb;
  int32_t* o = out + (int64_t)b * 2 * nb;
  const int nv = min(max(row[0], 0), nb);
  const int m = rs_live_len(fin, nv, nb);
  // the lanes past the prefix, as they are: CTA r copies its share
  for (int i = max(m, r * kc) + t; i < (r + 1) * kc; i += T) {
    o[i] = __ldg(fin + i);
    o[nb + i] = __ldg(row + 2 + i);
  }
  if (m == 0) return;
  const int k = m < kc ? m : kc;     // lanes an active CTA sorts
  const int A = m / k;               // active CTAs, a power of two
  if (r < A) {
    // a key a thread (threads past k hold the largest key): the network
    // over n = max(k, 32) in registers, the long strides through the
    // buffers past the first (the cluster's) or past nb (one block)
    const int n = k > 32 ? k : 32;
    unsigned long long kk = ~0ull;
    uint16_t ll = 0xffff;
    if (t < k) {
      const int i = r * k + t;
      kk = rs_key(__ldg(fin + i), i < nv ? __ldg(row + 2 + i) : BIG);
      ll = (uint16_t)i;
    }
    rs_sort_regs(kk, ll, n, key + kc, lane + kc);
    __syncthreads();
    if (t < k) {
      key[t] = kk;
      lane[t] = ll;
    }
    __syncthreads();
  }
  if (A == 1) {
    if (r == 0)
      for (int e = t; e < k; e += T) {
        const int src = lane[e];
        o[e] = __ldg(fin + src);
        o[nb + e] = __ldg(row + 2 + src);
      }
    return;
  }
  if constexpr (CLUSTER) rs_merge(fin, row, o, nb, kc, k, A, r, key, lane);
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

// K9's similarity grid: two blocks an SM (each holds the ring and a
// pass's queries, 96 KB); the smem cap raised once a device
inline cudaError_t sim_grid(int* blocks) {
  static bool raised[64];
  static int sms[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  e = allow_smem(dense_sims, SIM_SMEM, raised);
  if (e != cudaSuccess) return e;
  if (!sms[dev]) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  *blocks = 2 * sms[dev];
  return cudaSuccess;
}

extern "C" int yt_dense_sims(const void* docs, int64_t n, const void* qvecs,
                             int nq, void* sims, void* stream) {
  if (n < 1 || nq < 1) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e = sim_grid(&blocks);
  if (e != cudaSuccess) return (int)e;
  const int64_t ntiles = (n + SIM_ROWS - 1) / SIM_ROWS;
  const dim3 grid((unsigned)(ntiles < blocks ? ntiles : blocks),
                  (unsigned)((nq + DD_SQ - 1) / DD_SQ));
  dense_sims<<<grid, SIM_THREADS, SIM_SMEM, (cudaStream_t)stream>>>(
      (const __half*)docs, n, (const float*)qvecs, nq, (float*)sims);
  return (int)cudaGetLastError();
}

// K10's layout, from nb alone: its CTAs a slot (one below RS_CLUSTER_NB
// lanes, else one a RS_CHUNK lanes, up to RS_MAX_CTAS), its threads (a
// thread a lane a CTA holds: whole warps, and a cluster's CTA two at least
// for its two split searches) and its dynamic shared memory. nb is the
// bucket of the wave's largest candidate count (ops/dense.rerank_bucket),
// so it stands for the live lanes; within a launch each slot's CTAs take
// their share of its own live prefix.
static cudaError_t rs_layout(int nb, int* ctas, int* threads, int* smem) {
  int c = nb < RS_CLUSTER_NB ? 1 : nb / RS_CHUNK;
  c = c < RS_MAX_CTAS ? c : RS_MAX_CTAS;
  const int kc = nb / c, least = c > 1 ? 64 : 32;
  *ctas = c;
  *threads = kc < least ? least : kc;
  *smem = rs_lanes(c > 1, kc, *threads) * 10;
  if (c == 1) return cudaSuccess;
  // a cluster past the portable 8 CTAs, allowed once a device
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  static bool nonportable[64];
  if (!nonportable[dev]) {
    const cudaError_t a = cudaFuncSetAttribute(
        rerank_sort_k<true>, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (a != cudaSuccess) return a;
    nonportable[dev] = true;
  }
  return cudaSuccess;
}

// fin_all [bs, nb] int32, qd [bs, 2 + 2nb + 256] int32 descriptors; out
// [bs, 2nb] int32. One launch: a block a slot, or a cluster a slot.
extern "C" int yt_rerank_sort(const void* fin_all, const void* qd, int bs,
                              int nb, void* out, void* stream) {
  if (bs < 1 || nb < 16 || nb > RS_MAX_NB || (nb & (nb - 1)))
    return (int)cudaErrorInvalidValue;
  int ctas = 1, threads = 0, smem = 0;
  cudaError_t e = rs_layout(nb, &ctas, &threads, &smem);
  if (e != cudaSuccess) return (int)e;
  if (ctas == 1) {
    rerank_sort_k<false><<<bs, threads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)fin_all, (const int32_t*)qd, nb, 1,
        (int32_t*)out);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(bs * ctas));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, rerank_sort_k<true>, (const int32_t*)fin_all,
                         (const int32_t*)qd, nb, ctas, (int32_t*)out);
  if (e != cudaSuccess) return (int)e;
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
