// K5 `pruned_tile`: the devstore's b = 1 pruned query, a batch of slots.
// Replaces index/devstore._rank_pruned_batch1_kernel and its packed twin
// _rank_pruned_batch1_packed_kernel (JAX package, devstore.py:897,
// :1009), and _rank_pruned_kernel / _rank_pruned_batch_kernel at b = 1
// (:866, :959, body _pruned_span_topk :799). Each slot of the fused
// descriptor (_pack_batch1_fused's layout) scores the first TILE =
// 32,768 rows of its span's proxy-sorted extent against the span's
// frozen statistics, keeps the kk best by (score descending, arena
// position ascending), gathers their docids and checks that no tail tile
// of the span, bounded by its pmax row, can beat the kk-th score.
// Output [bs, 2kk + 1] int32: scores, docids, ok.
//
// `init` selects the general kernel's form: its running merge starts
// from kk entries (-(2^31-1), docid -1) that precede every row, so where
// the kk-th row scores -(2^31-1) or less those entries take its place.
// Without `init` (the batched kernel) such places keep the rows' docids.
//
// Bound: bytes, 42 B a row read (34 B features, flags, docid) and the
// tombstone bytes the docids hit: 1.38 MB a slot. That is far under an
// empty launch's time, so the design is simple: a scoring kernel of 32
// blocks a slot (1,024 rows each, one 64-row chunk a warp staged by
// cp.async, the scorer kernel 2 uses) writes the tile's scores to a
// scratch buffer [bs, TILE] that stays in the L2; a selection kernel of
// one 1,024-thread block a slot loads them into shared memory and finds
// the kk-th smallest 47-bit key (the score's descending key above the
// row's 15-bit position) by six 8-bit radix passes, each row adding to
// a shared histogram (warp aggregation by __match_any_sync was 1.4x
// slower on an H100); the kk keys at or below it are sorted by a bitonic
// sort, and the tail is checked with int32 arithmetic as the JAX code
// does (:939-951, the saturating cap leaves room for the language term).
// The descriptor travels by value in the launch's parameters (up to
// SLOTS slots a launch; more slots take more launches), so a query
// uploads nothing before its kernels and the host never waits on a copy
// from pageable memory.
//
// K5bp `pruned_tile_bp` is the same query over a bit-packed span
// (replaces _rank_pruned_batch1_bp_kernel, devstore.py:1151): the score
// and select kernels are instantiated with the packed row source, which
// decodes each row of the slot's first tile from the packed-words store
// (common.cuh unpack_row) where K5 stages the int16 arena's chunk; the
// select decodes the winners' docids. The slot's word base takes the
// start's place in the descriptor, and each slot's meta vector follows
// the fused layout; BP_SLOTS slots a launch keep the parameters under
// 4 KB. Bound: bytes, the tile's packed payload (row_bits / 8 a row,
// 34 B at make_term's 272 bits) and the tombstone bytes; the decode's
// two word reads a value hit the L1 for a warp's 32 rows of a column.
//
// `topk_finish` is the tail of the other routes: after kernel 3 (index
// mode) over K7's buffer it maps each winner's row back to its docid (an
// arena row's, or a RAM delta row's where the winner lies in the delta's
// region after the extents), applies the init entries' rule and writes
// either the tail check's ok (the b > 1 escalation of _pruned_span_topk)
// or the scan's statistics (_rank_spans_packed_kernel's [2kk + 36]
// output). `topk_finish_batch` does the same for a wave of batched scans
// (_rank_scan_batch_packed_kernel's [bs, 2kk] output), one block a slot.
#include "common.cuh"

namespace yt {

constexpr int TILE = 32768;                 // devstore TILE
constexpr int TILE_BITS = 15;
constexpr int SCORE_WARPS = 16;             // one 64-row chunk a warp
constexpr int BLOCK_ROWS = SCORE_WARPS * CH;  // 1,024 rows a block
constexpr int SEL_THREADS = 1024;
constexpr int MAX_KK = 2048;
constexpr int SLOTS = 16;                   // slots a launch (2.6 KB)
constexpr int32_t INT32_MAX_ = 2147483647;

// Up to SL slots of a descriptor, by value: the fused layout
// (_pack_batch1_fused: [bound_shift, lang_term, starts[bs], counts[bs],
// tstarts[bs], tcounts[bs], cmins[bs][17], cmaxs[bs][17], tf_mins[bs]
// (f32 bits), tf_maxs[bs] (f32 bits)]) cut into slot-major fields. The
// packed form (BpDesc) holds each slot's word base in `start` and its
// meta vector, which follow the fused layout as metas[bs][META_LEN].
template <int SL>
struct DescT {
  int32_t shift, lang;
  int32_t start[SL], count[SL], tstart[SL], tcount[SL];
  int32_t cmin[SL][NF], cmax[SL][NF];
  int32_t tmin[SL], tmax[SL];
};
using Desc = DescT<SLOTS>;
constexpr int BP_SLOTS = 8;                 // packed slots a launch (3.1 KB)
struct BpDesc : DescT<BP_SLOTS> {
  int32_t meta[BP_SLOTS][META_LEN];
};

// slots [first, first + n) of the fused descriptor q of bs slots
template <class D>
__host__ inline void fused_fields(const int32_t* q, int bs, int first, int n,
                                  D& d) {
  d.shift = q[0];
  d.lang = q[1];
  for (int j = 0; j < n; ++j) {
    const int i = first + j;
    d.start[j] = q[2 + i];
    d.count[j] = q[2 + bs + i];
    d.tstart[j] = q[2 + 2 * bs + i];
    d.tcount[j] = q[2 + 3 * bs + i];
    for (int c = 0; c < NF; ++c) {
      d.cmin[j][c] = q[2 + 4 * bs + i * NF + c];
      d.cmax[j][c] = q[2 + 4 * bs + bs * NF + i * NF + c];
    }
    d.tmin[j] = q[2 + 4 * bs + 2 * bs * NF + i];
    d.tmax[j] = q[2 + 5 * bs + 2 * bs * NF + i];
  }
}

__host__ inline Desc desc_of(const int32_t* q, int bs, int first, int n) {
  Desc d = {};
  fused_fields(q, bs, first, n, d);
  return d;
}

// the packed descriptor: the fused layout, then metas[bs][META_LEN]
__host__ inline BpDesc bp_desc_of(const int32_t* q, int bs, int first,
                                  int n) {
  BpDesc d = {};
  fused_fields(q, bs, first, n, d);
  const int32_t* metas = q + 2 + (4 + 2 * NF + 2) * bs;
  for (int j = 0; j < n; ++j)
    for (int c = 0; c < META_LEN; ++c)
      d.meta[j][c] = metas[(int64_t)(first + j) * META_LEN + c];
  return d;
}

// Where a slot's rows come from: the int16 arena (K5: feats, flags,
// docids) or the packed-words store of nw words (K5bp: words). The
// fields of the other source are null.
struct TileSrc {
  const int16_t* feats;
  const int32_t* flags;
  const int32_t* docids;
  const uint32_t* words;
  int64_t nw;
};

// The docid of tile row `row` of slot `slot`.
__device__ __forceinline__ int32_t tile_docid(const TileSrc& src,
                                              const Desc& q, int slot,
                                              int row) {
  return src.docids[(int64_t)q.start[slot] + row];
}
__device__ __forceinline__ int32_t tile_docid(const TileSrc& src,
                                              const BpDesc& q, int slot,
                                              int row) {
  return unpack_col(src.words, src.nw, q.start[slot], q.meta[slot], C_DOCIDS,
                    row);
}

// One block scores 1,024 rows of one slot's tile into scratch: K5 stages
// its int16 chunk by cp.async, K5bp (BP) decodes its rows.
template <bool BP, class D>
__global__ void __launch_bounds__(SCORE_WARPS * 32)
tile_score(const TileSrc src, const uint8_t* __restrict__ dead,
           int64_t doc_cap, const D q, const int32_t* __restrict__ consts,
           int32_t* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ScoreConsts k;
  __shared__ int32_t s_st[STATS_LEN];
  __shared__ int32_t s_meta[BP ? META_LEN : 1];
  constexpr int SB = stage_bytes<int16_t>();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int slot = blockIdx.y;
  const int32_t start = q.start[slot], count = q.count[slot];
  const int16_t* f0 = BP ? nullptr : src.feats + (int64_t)start * NF;
  const int32_t* fl0 = BP ? nullptr : src.flags + start;
  const int32_t* d0 = BP ? nullptr : src.docids + start;
  unsigned char* mine = smem + warp * SB;
  const int64_t chunk = (int64_t)blockIdx.x * SCORE_WARPS + warp;
  if constexpr (BP) {
    if (t < META_LEN) s_meta[t] = q.meta[slot][t];
  } else {
    issue_chunk<int16_t>(f0, fl0, nullptr, d0, TILE, chunk, mine, lane);
    cp_async_commit();
  }

  if (t < NF) {
    s_st[S_COL_MIN + t] = q.cmin[slot][t];
    s_st[S_COL_MAX + t] = q.cmax[slot][t];
  }
  if (t == 0) {
    s_st[S_TF_MIN] = q.tmin[slot];
    s_st[S_TF_MAX] = q.tmax[slot];
    s_st[S_HOST_MAX] = 0;
    s_st[S_NAN] = 0;
  }
  __syncthreads();
  fill_consts(k, s_st, consts, t);
  __syncthreads();
  RegConsts rk;
  load_consts(k, rk);

  int32_t* out = scratch + (int64_t)blockIdx.y * TILE + chunk * CH;
  if constexpr (BP) {
#pragma unroll
    for (int m = 0; m < CH / 32; ++m) {
      const int j = lane + 32 * m;
      const int64_t r = chunk * CH + j;
      int32_t score = SMALL;
      if (r < count) {   // before any read through a decoded docid
        int32_t f[NF], fl, d;
        unpack_row(src.words, src.nw, start, s_meta, r, f, fl, d);
        if (row_live(d, dead, doc_cap))
          score = score_row<int32_t, true>(f, fl, rk, false, 0);
      }
      out[j] = score;
    }
  } else {
    cp_async_wait<0>();
    __syncwarp();
    const Stage<int16_t> sg(mine, f0, fl0, d0, nullptr);
#pragma unroll
    for (int m = 0; m < CH / 32; ++m) {
      const int j = lane + 32 * m;
      int32_t score = SMALL;
      if (chunk * CH + j < count && row_live(sg.host(j), dead, doc_cap))
        score = score_row<int16_t, true>(sg.row(j), sg.flag(j), rk, false, 0);
      out[j] = score;
    }
  }
}

// Is the tail tile with bound row pm beaten by theta? (devstore.py:939-951:
// cap leaves headroom for the language term; pm << pos only where
// pm <= cap >> pos; >> neg arithmetic; the sum wraps as int32.)
__device__ __forceinline__ bool tail_ok(int32_t pm, int32_t bound_shift,
                                        int32_t lang_term, int32_t theta) {
  const int pos = bound_shift > 0 ? bound_shift : 0;
  const int neg = bound_shift < 0 ? -bound_shift : 0;
  const int32_t cap =
      (int32_t)((uint32_t)(INT32_MAX_ - 2048) - (uint32_t)lang_term);
  int32_t shifted = pm > (cap >> pos) ? cap : (int32_t)((uint32_t)pm << pos);
  shifted >>= neg;
  return (int32_t)((uint32_t)shifted + (uint32_t)lang_term) <= theta;
}

// inclusive warp scan
__device__ __forceinline__ uint32_t warp_incl(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// One block a slot: the kk best of its tile's scores, their docids (the
// arena's, or decoded from the packed block) and the tail check.
template <class D>
__global__ void __launch_bounds__(SEL_THREADS, 1)
tile_select(const int32_t* __restrict__ scratch, const TileSrc src,
            const int32_t* __restrict__ pmax, const D q, int kk, int init,
            int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* keys = (uint32_t*)smem;                           // [TILE]
  unsigned long long* cand =
      (unsigned long long*)(smem + TILE * sizeof(uint32_t));   // [kk]
  __shared__ uint32_t hist[256];
  __shared__ unsigned long long s_prefix;
  __shared__ uint32_t s_need, s_n;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int slot = blockIdx.x;
  const int32_t* sc = scratch + (int64_t)slot * TILE;
  for (int i = t; i < TILE; i += SEL_THREADS)
    keys[i] = topk_hi(sc[i], false);   // smaller is better
  if (t == 0) {
    s_prefix = 0ull;
    s_need = (uint32_t)kk;
    s_n = 0u;
  }
  __syncthreads();

  // radix select of the kk-th smallest 47-bit key (key << 15 | row),
  // MSB first, 8 bits a pass (the first pass holds bits 40-46)
  unsigned long long mask = 0ull;
  for (int shift = 40; shift >= 0; shift -= 8) {
    if (t < 256) hist[t] = 0u;
    __syncthreads();
    const unsigned long long prefix = s_prefix;
    for (int i = t; i < TILE; i += SEL_THREADS) {
      const unsigned long long key =
          ((unsigned long long)keys[i] << TILE_BITS) | (unsigned)i;
      if ((key & mask) == prefix)
        atomicAdd(&hist[(uint32_t)(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 8l..8l+7; find the bin where the count reaches
      // the rank still needed (every lane reads s_need before the one
      // lane whose bins hold that rank rewrites it)
      const uint32_t need = s_need;
      uint32_t b[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b[j] = hist[8 * lane + j];
        sum += b[j];
      }
      const uint32_t incl = warp_incl(sum, lane);
      __syncwarp();
      uint32_t before = incl - sum;
      if (before < need && need <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (before < need && need <= before + b[j]) {
            s_prefix = prefix | ((unsigned long long)(8 * lane + j) << shift);
            s_need = need - before;
          }
          before += b[j];
        }
      }
    }
    __syncthreads();
    mask |= 255ull << shift;
  }
  // exactly kk keys are at or below the kk-th (the keys are distinct)
  const unsigned long long kth = s_prefix;
  for (int i = t; i < TILE; i += SEL_THREADS) {
    const unsigned long long key =
        ((unsigned long long)keys[i] << TILE_BITS) | (unsigned)i;
    if (key <= kth) cand[atomicAdd(&s_n, 1u)] = key;
  }
  __syncthreads();
  // bitonic sort of the kk (a power of two) keys, ascending
  for (int size = 2; size <= kk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < kk / 2; i += SEL_THREADS) {
        const int lo = 2 * stride * (i / stride) + (i % stride);
        const int hi = lo + stride;
        const unsigned long long a = cand[lo], b = cand[hi];
        if ((a > b) == ((lo & size) == 0)) {
          cand[lo] = b;
          cand[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  int32_t* o = out + (int64_t)slot * (2 * kk + 1);
  for (int i = t; i < kk; i += SEL_THREADS) {
    const unsigned long long key = cand[i];
    const int row = (int)(key & (TILE - 1));
    int32_t s = (int32_t)(~(uint32_t)(key >> TILE_BITS) ^ 0x80000000u);
    int32_t d = tile_docid(src, q, slot, row);
    if (init && s <= SMALL) {
      s = SMALL;
      d = -1;
    }
    o[i] = s;
    o[kk + i] = d;
  }
  int32_t theta =
      (int32_t)(~(uint32_t)(cand[kk - 1] >> TILE_BITS) ^ 0x80000000u);
  if (init && theta < SMALL) theta = SMALL;
  const int32_t tstart = q.tstart[slot], tcount = q.tcount[slot];
  bool ok = true;
  for (int j = 1 + t; j < tcount; j += SEL_THREADS)
    ok = ok && tail_ok(pmax[(int64_t)tstart + j], q.shift, q.lang, theta);
  ok = __syncthreads_and(ok);
  if (t == 0) o[2 * kk] = ok ? 1 : 0;
}

// One block: the kk winners of kernel 3 (index mode) over a K7 buffer,
// mapped back to docids (the extents', then the delta's), with the init
// entries' rule; then either ok of the tail [j0, tcount) (stats null) or
// the scan's statistics [0, 36).
__global__ void __launch_bounds__(SEL_THREADS)
topk_finish(const int32_t* __restrict__ top_s,
            const int32_t* __restrict__ top_rows, int kk, const Extents x,
            const int32_t* __restrict__ pmax, int64_t tstart, int64_t j0,
            int64_t tcount, int32_t bound_shift, int32_t lang_term,
            const int32_t* __restrict__ stats, int32_t* __restrict__ out) {
  const int t = threadIdx.x;
  for (int i = t; i < kk; i += SEL_THREADS) {
    int32_t s = top_s[i];
    int32_t d = docid_at(x, top_rows[i]);
    if (s <= SMALL) {
      s = SMALL;
      d = -1;
    }
    out[i] = s;
    out[kk + i] = d;
  }
  if (stats) {
    if (t < 2 * NF + 2) out[2 * kk + t] = stats[t];
    return;
  }
  int32_t theta = top_s[kk - 1];
  if (theta < SMALL) theta = SMALL;
  bool ok = true;
  for (int64_t j = j0 + t; j < tcount; j += SEL_THREADS)
    ok = ok && tail_ok(pmax[tstart + j], bound_shift, lang_term, theta);
  ok = __syncthreads_and(ok);
  if (t == 0) out[2 * kk] = ok ? 1 : 0;
}

// The finish of the packed exact scan (and of K5bp's kk > 2048 form):
// kernel 3's kk winners over a K7bp buffer of one packed span of
// `count` rows, the docid of each decoded from the block (rows past the
// count, or scores at or below -(2^31-1), give (-(2^31-1), -1)); then
// nothing (tstart < 0: the scan, [2kk]) or the ok of the tail [1,
// tcount) against theta = max(kk-th score, -(2^31-1)) ([2kk + 1]).
__global__ void __launch_bounds__(SEL_THREADS)
topk_finish_bp(const int32_t* __restrict__ top_s,
               const int32_t* __restrict__ top_rows, int kk,
               const uint32_t* __restrict__ words, int64_t nw, int64_t wbase,
               const PackMeta m, int64_t count,
               const int32_t* __restrict__ pmax, int64_t tstart,
               int64_t tcount, int32_t bound_shift, int32_t lang_term,
               int32_t* __restrict__ out) {
  __shared__ int32_t s_meta[META_LEN];
  const int t = threadIdx.x;
  if (t < META_LEN) s_meta[t] = m.v[t];
  __syncthreads();
  for (int i = t; i < kk; i += SEL_THREADS) {
    int32_t s = top_s[i];
    const int64_t r = top_rows[i];
    int32_t d = -1;
    if (s <= SMALL || r < 0 || r >= count)
      s = SMALL;
    else
      d = unpack_col(words, nw, wbase, s_meta, C_DOCIDS, r);
    out[i] = s;
    out[kk + i] = d;
  }
  if (tstart < 0) return;
  int32_t theta = top_s[kk - 1];
  if (theta < SMALL) theta = SMALL;
  bool ok = true;
  for (int64_t j = 1 + t; j < tcount; j += SEL_THREADS)
    ok = ok && tail_ok(pmax[tstart + j], bound_shift, lang_term, theta);
  ok = __syncthreads_and(ok);
  if (t == 0) out[2 * kk] = ok ? 1 : 0;
}

// One block a slot of a wave of batched scans: slot s's kk winners
// (top_s / top_rows [bs, kk]) mapped back to docids over its extents,
// (-(2^31-1), -1) at or below -(2^31-1); out [bs, 2kk]: scores, docids.
__global__ void __launch_bounds__(SEL_THREADS)
topk_finish_batch(const int32_t* __restrict__ top_s,
                  const int32_t* __restrict__ top_rows, int kk,
                  const int16_t* __restrict__ feats,
                  const int32_t* __restrict__ flags,
                  const int32_t* __restrict__ docids, const ScanBatch b,
                  int32_t* __restrict__ out) {
  __shared__ Extents x;
  __shared__ Filter q;
  if (threadIdx.x == 0) slot_extents(b, blockIdx.x, feats, flags, docids, x, q);
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kk;
  int32_t* o = out + 2 * base;
  for (int i = threadIdx.x; i < kk; i += SEL_THREADS) {
    int32_t s = top_s[base + i];
    int32_t d = docid_at(x, top_rows[base + i]);
    if (s <= SMALL) {
      s = SMALL;
      d = -1;
    }
    o[i] = s;
    o[kk + i] = d;
  }
}

}  // namespace yt

using namespace yt;

// The launches of K5 or K5bp over bs slots of the descriptor q (host
// memory), SL slots a launch.
template <bool BP, class D, int SL, class Of>
static int launch_tiles(const TileSrc& src, const void* dead, int64_t doc_cap,
                        const void* pmax, const void* desc, int bs, int kk,
                        int init, const void* consts, void* scratch,
                        void* out, cudaStream_t s, Of desc_fn) {
  if (bs < 1 || kk < 16 || kk > MAX_KK || (kk & (kk - 1)))
    return (int)cudaErrorInvalidValue;
  const int score_smem = BP ? 0 : SCORE_WARPS * stage_bytes<int16_t>();
  const int sel_smem = TILE * 4 + MAX_KK * 8;
  static bool raised[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(tile_select<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sel_smem);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  for (int first = 0; first < bs; first += SL) {
    const int n = bs - first < SL ? bs - first : SL;
    const D q = desc_fn((const int32_t*)desc, bs, first, n);
    int32_t* sc = (int32_t*)scratch + (int64_t)first * TILE;
    tile_score<BP, D><<<dim3(TILE / BLOCK_ROWS, n), SCORE_WARPS * 32,
                        score_smem, s>>>(src, (const uint8_t*)dead, doc_cap,
                                         q, (const int32_t*)consts, sc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    tile_select<D><<<n, SEL_THREADS, sel_smem, s>>>(
        sc, src, (const int32_t*)pmax, q, kk, init,
        (int32_t*)out + (int64_t)first * (2 * kk + 1));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// K5: feats [cap, 17] int16, flags/docids [cap] int32 (every slot's
// start + TILE <= cap: the arena's spare tile), dead [doc_cap] bool,
// pmax int32, desc the fused descriptor of bs slots in HOST memory
// (copied into the launches' parameters), consts int32[44]; scratch
// [bs, TILE] int32; out [bs, 2kk + 1] int32; kk a power of two in
// [16, 2048].
extern "C" int yt_pruned_tile(const void* feats, const void* flags,
                              const void* docids, const void* dead,
                              int64_t doc_cap, const void* pmax,
                              const void* desc, int bs, int kk, int init,
                              const void* consts, void* scratch, void* out,
                              void* stream) {
  const TileSrc src = {(const int16_t*)feats, (const int32_t*)flags,
                       (const int32_t*)docids, nullptr, 0};
  return launch_tiles<false, Desc, SLOTS>(src, dead, doc_cap, pmax, desc, bs,
                                          kk, init, consts, scratch, out,
                                          (cudaStream_t)stream, desc_of);
}

// K5bp: words [nw] int32 (the packed-words store), dead [doc_cap] bool,
// pmax int32, desc the packed descriptor of bs slots in HOST memory (the
// fused layout with each slot's word base as its start, then
// metas[bs][57]), consts int32[44]; scratch [bs, TILE] int32; out [bs,
// 2kk + 1] int32 (scores, docids, ok; the batched form: no init
// entries); kk a power of two in [16, 2048].
extern "C" int yt_pruned_tile_bp(const void* words, int64_t nw,
                                 const void* dead, int64_t doc_cap,
                                 const void* pmax, const void* desc, int bs,
                                 int kk, const void* consts, void* scratch,
                                 void* out, void* stream) {
  if (nw < 1) return (int)cudaErrorInvalidValue;
  const TileSrc src = {nullptr, nullptr, nullptr, (const uint32_t*)words, nw};
  return launch_tiles<true, BpDesc, BP_SLOTS>(
      src, dead, doc_cap, pmax, desc, bs, kk, 0, consts, scratch, out,
      (cudaStream_t)stream, bp_desc_of);
}

// The finish of the b > 1 and scan routes: top_s / top_rows [kk] (kernel
// 3's scores and rows over a K7 buffer of the n_ext arena extents in
// `ext`, host memory, then the delta block's dn rows with docids
// ddocids); stats int32[38] or null; out [2kk + 1] (stats null) or
// [2kk + 36] int32.
extern "C" int yt_topk_finish(const void* top_s, const void* top_rows,
                              int kk, const void* docids, const int64_t* ext,
                              int n_ext, const void* ddocids, int64_t dn,
                              const void* pmax, int64_t tstart, int64_t j0,
                              int64_t tcount, int bound_shift, int lang_term,
                              const void* stats, void* out, void* stream) {
  if (kk < 1 || n_ext < 0 || n_ext > MAX_EXT || dn < 0)
    return (int)cudaErrorInvalidValue;
  // only the docids are read (the feature and flag pointers are not)
  const Extents x = make_extents(docids, nullptr, docids, ext, n_ext,
                                 ddocids, nullptr, ddocids, dn);
  topk_finish<<<1, SEL_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)top_s, (const int32_t*)top_rows, kk, x,
      (const int32_t*)pmax, tstart, j0, tcount, bound_shift, lang_term,
      (const int32_t*)stats, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The finish of a wave of bs <= 16 batched scans (common.cuh
// scan_batch_of, host memory): top_s / top_rows [bs, kk]; docids the
// arena's; out [bs, 2kk] int32.
extern "C" int yt_topk_finish_batch(const void* top_s, const void* top_rows,
                                    int kk, const void* docids,
                                    const int32_t* slots, int bs, void* out,
                                    void* stream) {
  if (kk < 1 || bs < 1 || bs > BATCH_SLOTS) return (int)cudaErrorInvalidValue;
  ScanBatch b{};
  if (!scan_batch_of(slots, bs, &b)) return (int)cudaErrorInvalidValue;
  topk_finish_batch<<<bs, SEL_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)top_s, (const int32_t*)top_rows, kk,
      (const int16_t*)docids, (const int32_t*)docids,
      (const int32_t*)docids, b, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The packed finish: top_s / top_rows [kk] (kernel 3 over a K7bp buffer
// of the packed span of `count` rows at word wbase of words [nw], meta
// the block's 57 int32 in host memory); tstart < 0: out [2kk]; else out
// [2kk + 1] with the tail check over pmax[tstart + 1, tstart + tcount).
extern "C" int yt_topk_finish_bp(const void* top_s, const void* top_rows,
                                 int kk, const void* words, int64_t nw,
                                 int64_t wbase, const int32_t* meta,
                                 int64_t count, const void* pmax,
                                 int64_t tstart, int64_t tcount,
                                 int bound_shift, int lang_term, void* out,
                                 void* stream) {
  if (kk < 1 || nw < 1 || count < 0) return (int)cudaErrorInvalidValue;
  PackMeta m;
  for (int c = 0; c < META_LEN; ++c) m.v[c] = meta[c];
  topk_finish_bp<<<1, SEL_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)top_s, (const int32_t*)top_rows, kk,
      (const uint32_t*)words, nw, wbase, m, count, (const int32_t*)pmax,
      tstart, tcount, bound_shift, lang_term, (int32_t*)out);
  return (int)cudaGetLastError();
}
