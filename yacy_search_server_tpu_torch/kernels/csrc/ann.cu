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
// K15 in one launch (`ann_fuse_cl`) up to kk 2048: one thread-block
// cluster a slot (cudaLaunchKernelEx; CL CTAs, 16 where the card holds
// such clusters, else 8; fewer where a CTA would take under 256 lanes),
// every slot of the call in the one grid. CTA `rank` takes the slot's
// valid lanes [rank LP, (rank + 1) LP), LP = n_valid / CL rounded up to
// 32: its warps take chunks of 32 lanes in turn, lane l of a warp
// reading lane l's descriptor words (coalesced) and, where its row lies
// in [0, cap), its scale and slab docid. The chunk's dots then go two
// rows at a time, a half-warp a row: lane p of a half holds the elements
// of the dot's lanes p and p + 16 (two 8-byte loads, a half-warp's 128
// contiguous bytes each), adds their two pairwise trees, then the
// butterfly over 8, 4, 2, 1 inside the half: the additions of K9's fixed
// order, in its order (the first butterfly step adds lanes p and p +
// 16), so the sums are the plain version's to the bit. Each lane keeps
// its lane's key in registers (E keys a thread): the complement of the
// two-kernel route's key below, so that a larger key ranks first and an
// invalid lane or a pad is 0. The slot's kk' best keys (kk' the pow2 at
// or above kk, at least 16) are then the cluster's (cluster_select.cuh,
// K5's selection: up to kk' 128 a bound leaves few keys for the network
// and the CTAs' lists go into the leader's shared memory; past it every
// key takes the network and the lists meet in levels through distributed
// shared memory), and the leader decodes the first kk into [2kk]. No key
// leaves the chip and nothing is allocated beside the output. Bound:
// bytes, each live lane's gathered row (256 B), its scale and docid, the
// descriptor and the output (a slot of the dense-first mix's commonest
// group, 16,699 rows at nb 32768: 4.3 MB, 1.3 us at 3.35 TB/s); what the
// design does about it: a warp issues 16 rows' loads (branch-free: a lane
// outside the slab reads row 0) before it sums them, reads the next
// chunk's descriptor words meanwhile and skips chunks of pads, and a
// slot's valid lanes spread evenly over CL SMs.
//
// Past kk 2048 (up to MAX_KK 8192), or where a CTA would hold more than
// 4,096 lanes (nb 65536 on a card without 16-CTA clusters), the route of
// two kernels stays: `ann_fuse_keys`, one warp a run of 8 lanes of a
// slot's descriptor ([n_valid, alpha bits, rows[nb], docids[nb],
// sparse[nb], query bits[256]], ops/ann.pack_ann_fuse_row), the query
// read into registers once for the 8: for a lane below n_valid whose row
// lies in [0, cap), the int8 row (exact in bf16) dot the bf16 query,
// times the f16 scale; otherwise sims = 0 without a read. docid = the
// lane's own where >= 0, else sdocids[row] inside the slab, else
// INT32_MAX (invalid). final = sparse + rint((sims * alpha) * SCALE) on
// valid lanes, -(2^31-1) elsewhere; the lane's 64-bit key is (the
// wrapping negation of final, docid), each half in unsigned order
// (common.cuh tie_hi, sec_key), INT32_MAX docid on invalid lanes: the key
// alone determines both outputs. `ann_fuse_round`, the selection in
// rounds: a block takes a chunk of C keys of one slot (C = max(4096,
// 2kk') with kk' the pow2 at or above kk), sorts it with K10's network
// and keeps its first kk'; the next round does the same over the kept
// keys (each round halves a slot's keys at least), until one chunk is
// left, whose first kk the last round writes. The kk best of a slot are
// among each chunk's kk best, so the result is lax.sort then [:kk]'s.
// Chunks past a slot's keys are filled with ~0, the key of an invalid
// lane (INT32_MAX docid, -(2^31-1) score), which is what the JAX kernel
// outputs for those. Output [bs, 2kk]: the finals, then the docids.
// There the keys (8 B a lane, written once and read once a round) are the
// design's own traffic, in a buffer the wrapper allocates.
#include <cstring>

#include "cluster_select.cuh"
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
constexpr int AF_CL_KK = 2048;           // the largest kk' of ann_fuse_cl
constexpr int AF_MIN_LANES = 256;       // lanes a CTA at least, where CL > 1
constexpr int AF_PAIRS = 8;              // row pairs whose loads a warp issues at once

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


// K15 in one launch: the keys of a CTA's lanes (E a thread) into
// registers, then the cluster's selection; the leader writes [2kk].
template <int E>
__global__ void __launch_bounds__(CS_THREADS, 2)
ann_fuse_cl(const int8_t* __restrict__ slab,
            const __half* __restrict__ scales,
            const int32_t* __restrict__ sdocids, int64_t cap,
            const int32_t* __restrict__ qd, int nb, int CL, int kk, int KK,
            int32_t* __restrict__ out) {
  constexpr int T = CS_THREADS, W = T / 32, N = E * T;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int slot = blockIdx.x / CL, rank = blockIdx.x % CL;
  const int32_t* row = qd + (int64_t)slot * (2 + 3 * nb + DD_DIM);
  const int32_t nvalid = row[0] < nb ? row[0] : nb;
  const float alpha = __int_as_float(row[1]);
  // the CTAs share the slot's valid lanes (lanes past n_valid are pads):
  // LP lanes a CTA, a multiple of 32 and at most N
  int LP = ((nvalid + CL - 1) / CL + 31) / 32 * 32;
  LP = LP < N ? LP : N;
  // half h of the warp takes a pair's row h; its lane p the elements of
  // the dot's lanes p and p + 16
  const int h = lane >> 4, p = lane & 15;
  float q0[8], q1[8];
  load8_q(row + 2 + 3 * nb, p, q0);
  load8_q(row + 2 + 3 * nb, p + 16, q1);
  // chunk c of the warp: the CTA's lanes 32 (c W + warp) ..; each lane
  // reads its lane's descriptor words a chunk ahead
  auto lane_of = [&](int c, int32_t& r, int32_t& own, int32_t& sp) {
    const int at = 32 * (c * W + warp) + lane;
    const int j = rank * LP + at;
    const bool mine = at < LP && j < nvalid;
    r = mine ? row[2 + j] : -1;
    own = mine ? row[2 + nb + j] : -1;
    sp = mine ? row[2 + 2 * nb + j] : 0;
    return mine;
  };
  u64 v[E];
  int32_t r_n, own_n, sp_n;
  bool mine_n = lane_of(0, r_n, own_n, sp_n);
#pragma unroll
  for (int c = 0; c < E; ++c) {
    v[c] = 0ull;
    if (32 * (c * W + warp) >= LP || rank * LP + 32 * (c * W + warp) >= nvalid)
      continue;                           // the warp's chunk is all pads
    const int32_t r = r_n, own = own_n, sp = sp_n;
    const bool mine = mine_n;
    if (c + 1 < E) mine_n = lane_of(c + 1, r_n, own_n, sp_n);
    const bool in_slab = mine && r >= 0 && r < cap;
    float sc = 0.0f;
    int32_t sd = BIG;
    if (in_slab) {
      sc = __half2float(scales[r]);
      sd = sdocids[r];
    }
    // the chunk's 32 rows two at a time (a half-warp a row), the loads of
    // AF_PAIRS pairs issued before their sums; a lane outside the slab
    // reads row 0 and its sum is not used
    const int32_t rs = in_slab ? r : 0;
    float dot = 0.0f;
#pragma unroll
    for (int g = 0; g < 16; g += AF_PAIRS) {
      uint2 ra[AF_PAIRS], rb[AF_PAIRS];
#pragma unroll
      for (int u = 0; u < AF_PAIRS; ++u) {
        const int32_t rr = __shfl_sync(FULL, rs, 2 * (g + u) + h);
        const uint2* rp =
            reinterpret_cast<const uint2*>(slab + (int64_t)rr * DD_DIM);
        ra[u] = __ldg(rp + p);
        rb[u] = __ldg(rp + p + 16);
      }
#pragma unroll
      for (int u = 0; u < AF_PAIRS; ++u) {
        float d0[8], d1[8];
        i8x8(ra[u], d0);
        i8x8(rb[u], d1);
        float s = __fadd_rn(lane_sum(d0, q0), lane_sum(d1, q1));
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          s = __fadd_rn(s, __shfl_xor_sync(FULL, s, o));
        const float s0 = __shfl_sync(FULL, s, 0);
        const float s1 = __shfl_sync(FULL, s, 16);
        if (lane == 2 * (g + u)) dot = s0;
        if (lane == 2 * (g + u) + 1) dot = s1;
      }
    }
    const float sims = in_slab ? __fmul_rn(dot, sc) : 0.0f;
    const int32_t dd = own >= 0 ? own : (in_slab ? sd : BIG);
    int32_t fin = SMALL, tk = BIG;
    if (mine && dd != BIG) {
      fin = boosted(sp, sims, alpha);
      tk = dd;
    }
    v[c] = ~(((u64)tie_hi(fin, false) << 32) | sec_key(tk));
  }
  u64* xb = (u64*)smem;
  u64* cand = xb + 2 * N;
  u64* list = cand + N;
  cluster_arrive();                       // this CTA runs
  const int fin_at = cluster_select<E>(v, xb, cand, list, KK, CL);
  cluster_arrive();                       // my reads of the others are done
  if (rank == 0) {
    const u64* fin = list + fin_at;
    int32_t* o = out + (int64_t)slot * 2 * kk;
    for (int i = t; i < kk; i += T) {
      const u64 x = ~fin[i];
      // the high half is the negated final in unsigned order
      const int32_t neg = (int32_t)((uint32_t)(x >> 32) ^ 0x80000000u);
      o[i] = (int32_t)(0u - (uint32_t)neg);
      o[kk + i] = (int32_t)((uint32_t)x ^ 0x80000000u);
    }
  }
  cluster_wait();                         // no CTA leaves while read
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

// ann_fuse_cl's cluster size on a device: 16 where
// cudaOccupancyMaxActiveClusters finds room for a cluster of 16 at E =
// 8's shared memory, else 8; both kernels' shared memory raised once.
static int af_cluster[64];

static int64_t af_smem(int E, int CL, int KK) {
  return 24LL * E * CS_THREADS + 8LL * cs_list(CL, KK);
}

static cudaError_t af_prepare(int* cl) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!af_cluster[dev]) {
    const void* ks[2] = {(const void*)ann_fuse_cl<8>,
                         (const void*)ann_fuse_cl<16>};
    const int es[2] = {8, 16};
    for (int i = 0; i < 2; ++i) {
      e = cudaFuncSetAttribute(ks[i],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)af_smem(es[i], 16, AF_CL_KK));
      if (e != cudaSuccess) return e;
      e = cudaFuncSetAttribute(
          ks[i], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 16;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(16 * 16);
    cfg.blockDim = dim3(CS_THREADS);
    cfg.dynamicSmemBytes = (size_t)af_smem(8, 16, AF_CL_KK);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int room = 0;
    e = cudaOccupancyMaxActiveClusters(&room, (const void*)ann_fuse_cl<8>,
                                       &cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();   // a size the card refuses is an answer
      room = 0;
    }
    af_cluster[dev] = room > 0 ? 16 : 8;
  }
  *cl = af_cluster[dev];
  return cudaSuccess;
}

// The one-launch route's shape for (nb, kk): CL, E and kk' (KK); false
// where the two-kernel route takes the call.
static cudaError_t af_shape(int nb, int kk, bool* one, int* CL, int* E,
                            int* KK) {
  int most = 0;
  const cudaError_t e = af_prepare(&most);
  if (e != cudaSuccess) return e;
  int kp = 16;
  while (kp < kk) kp <<= 1;
  int cl = nb / AF_MIN_LANES;
  cl = cl < 1 ? 1 : (cl > most ? most : cl);
  const int lanes = nb / cl;
  const int need = (lanes > kp ? lanes : kp) / CS_THREADS;
  *one = kp <= AF_CL_KK && need <= 16;
  *CL = cl;
  *E = need <= 8 ? 8 : 16;
  *KK = kp;
  return cudaSuccess;
}

// The bytes of key buffer a K15 call (bs, nb, kk) needs: 0 where it is
// one launch (kk <= 2048), bs * nb * 3 / 2 uint64 on the two-kernel route.
extern "C" int64_t yt_ann_fuse_scratch_bytes(int64_t bs, int64_t nb,
                                             int64_t kk) {
  bool one = false;
  int CL = 0, E = 0, KK = 0;
  if (nb < 16 || nb > (1 << 30) || kk < 1 || kk > nb ||
      af_shape((int)nb, (int)kk, &one, &CL, &E, &KK) != cudaSuccess)
    return -1;
  return one ? 0 : bs * nb * 3 / 2 * 8;
}

template <int E>
static cudaError_t af_launch(const void* slab, const void* scales,
                             const void* sdocids, int64_t cap,
                             const void* qd, int bs, int nb, int CL, int kk,
                             int KK, void* out, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(CL * bs));
  cfg.blockDim = dim3(CS_THREADS);
  cfg.dynamicSmemBytes = (size_t)af_smem(E, CL, KK);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, ann_fuse_cl<E>, (const int8_t*)slab, (const __half*)scales,
      (const int32_t*)sdocids, cap, (const int32_t*)qd, nb, CL, kk, KK,
      (int32_t*)out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// keys: yt_ann_fuse_scratch_bytes of scratch (none where that is 0: the
// one-launch route)
extern "C" int yt_ann_fuse(const void* slab, const void* scales,
                           const void* sdocids, int64_t cap, const void* qd,
                           int bs, int nb, int kk, void* keys, void* out,
                           void* stream) {
  if (bs < 1 || cap < 1 || nb < 16 || (nb & (nb - 1)) || kk < 1 || kk > nb ||
      kk > AF_MAX_CHUNK / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  bool one = false;
  int CL = 0, E = 0, KK = 0;
  cudaError_t e = af_shape(nb, kk, &one, &CL, &E, &KK);
  if (e != cudaSuccess) return (int)e;
  if (one) {
    if ((int64_t)CL * bs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    e = E == 8 ? af_launch<8>(slab, scales, sdocids, cap, qd, bs, nb, CL, kk,
                              KK, out, s)
               : af_launch<16>(slab, scales, sdocids, cap, qd, bs, nb, CL,
                               kk, KK, out, s);
    return (int)e;
  }
  if (keys == nullptr || bs > 65535) return (int)cudaErrorInvalidValue;
  const int64_t warps = (int64_t)bs * (nb / AN_LANES);
  unsigned long long* buf[2] = {
      (unsigned long long*)keys,
      (unsigned long long*)keys + (int64_t)bs * nb};
  ann_fuse_keys<<<(unsigned)((warps + AN_WARPS - 1) / AN_WARPS), AN_THREADS,
                  0, s>>>((const int8_t*)slab, (const __half*)scales,
                          (const int32_t*)sdocids, cap, (const int32_t*)qd,
                          bs, nb, buf[0]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  static bool raised[64];
  e = allow_smem(ann_fuse_round, AF_MAX_CHUNK * 8, raised);
  if (e != cudaSuccess) return (int)e;
  int KR = 1;
  while (KR < kk) KR <<= 1;
  const int C = KR * 2 > AF_CHUNK ? KR * 2 : AF_CHUNK;
  int64_t m = nb;
  int cur = 0;
  while (m > C) {
    const int64_t chunks = m / C;
    ann_fuse_round<<<dim3((unsigned)chunks, bs), AF_THREADS, C * 8, s>>>(
        buf[cur], m, C, KR, buf[cur ^ 1], kk, nullptr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    m = chunks * KR;
    cur ^= 1;
  }
  const int last = m < 2 ? 2 : (int)m;
  ann_fuse_round<<<dim3(1, bs), AF_THREADS, last * 8, s>>>(
      buf[cur], m, last, KR, nullptr, kk, (int32_t*)out);
  return (int)cudaGetLastError();
}
