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
// Every row has a 64-bit key, smaller is better: the order key of the
// score above, the docid (tie mode) or the row (index mode) below. The
// key is never stored for the whole array. A radix select finds the k-th
// key digit by digit (11, 11, 10 bits a 32-bit half), then the k winners
// are sorted and written.
//
// Bound: bytes, 4n for the scores, in tie mode 4 more for each row whose
// score equals the k-th (only those need their docid to be ranked), and
// 16k for the winners' payload in and the outputs.
// What held the first version back was launches and passes: eight 8-bit
// passes over all n scores, each a launch followed by a one-thread pick
// kernel, 256 shared bins that serialise on a constant score, and a
// global atomic per selected row. This design:
//   - one cooperative kernel (every block resident, one of 1024 threads
//     per SM) runs every pass. A pass histograms one digit into COPIES
//     interleaved shared histograms (lanes l and l + 8 share a copy), so
//     a constant score meets at most 4 lanes to an address. The last
//     block to finish a pass (an atomic ticket after __threadfence) picks
//     the digit on the device and releases the others: the host never
//     synchronises inside the call;
//   - two digits from the first pass: cardinal scores sit in a handful of
//     top-digit bins, so the k-th key's bucket is large (4 % to 50 % of
//     the rows). A sample (the first round of each block's share) guesses
//     that bucket, and the first pass histograms digit 1 of the guessed
//     bucket's rows beside digit 0. When the guess holds, the pick takes
//     both digits at once and the bucket left is small; when it misses,
//     the select goes on digit by digit;
//   - candidate compaction: once the chosen bucket fits a buffer of
//     max(TAIL_CAP, n/16) entries, the next pass writes the rows above it
//     straight to the winners and stages the rows inside it in shared
//     memory (one warp scan and one shared atomic a round), histogramming
//     the next digit of those rows on the way; each block writes its
//     stage out with one global atomic. Later passes read that buffer
//     alone, and once it holds at most TAIL_CAP = 16384 rows the picking
//     block finishes the select in shared memory. A bucket too large for
//     the buffer (all scores equal, say) keeps the passes on the full
//     array;
//   - in tie mode a docid is read only where the low half of the key
//     decides a pass; the tail and the sort set it from the row (full_key);
//   - the same block then sorts the k winners in registers and shared
//     memory and writes the outputs (k <= 2048); larger k sorts by a
//     bitonic network in device memory.
// Launches per call for k <= 2048: one memset of the state and one kernel.
// On the smoke's cardinal scores the select reads the scores twice: the
// first pass histograms, the second collects the winners (or compacts a
// bucket that is still large); what remains over the bound is that second
// read, and the launch and the sort. Equal keys (same score and same
// docid) are interchangeable in every output but the row index.
//
// Built with -DYT_TRACE (YT_KERNEL_TRACE=1 for build.py), the picking
// block records, per pass, the device clock and the state it left in a
// trace of the last call (yt_tie_topk_trace, read by
// kernels/bench.topk_trace; chip_smoke.py prints it). Without the define
// the trace costs nothing.
#include "common.cuh"

namespace yt {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 2048;            // 11-bit digits
constexpr int NDIG = 6;               // 11+11+10 bits a 32-bit half
constexpr int TAIL_CAP = 16384;       // candidates one block finishes
constexpr int SHARED_SORT_MAX = 2048;
constexpr int SMEM_BYTES = TAIL_CAP * 12 + BINS * 4;
static_assert(SHARED_SORT_MAX * 12 <= SMEM_BYTES, "sort fits");
constexpr int64_t STATE_BYTES = 256;
constexpr int SAMPLE = NDIG;          // ghist slot of the sample's digit 0
constexpr int64_t HDR_BYTES = STATE_BYTES + (int64_t)(NDIG + 1) * BINS * 4;

__host__ __device__ constexpr int dig_shift(int p) {
  return p == 0 ? 53 : p == 1 ? 42 : p == 2 ? 32 : p == 3 ? 21
         : p == 4 ? 10 : 0;
}
__host__ __device__ constexpr int dig_bits(int p) {
  return (p == 2 || p == 5) ? 10 : 11;
}

// The select's state between passes. src: 0 the input arrays, 1 or 2 the
// candidate buffer C0 or C1 (m rows). compact: this pass moves the
// bucket's rows to the other buffer and the better rows to the winners.
// done: the bucket is settled; this pass collects. sampled: the sample
// has been histogrammed and guess is its bucket of digit 0 (scount rows).
struct SelState {
  unsigned long long prefix, mask;
  uint32_t rem, digit, done, finished, compact, src, m, sampled, guess;
  uint32_t scount, wcount, eqtaken, ccount[2], arrive, gen;
  unsigned long long first_arrive;
};
static_assert(sizeof(SelState) <= STATE_BYTES, "state fits its slot");

struct SelArgs {
  const int32_t* scores;
  const int32_t* sec;       // docids (tie mode) or null (index mode)
  const int32_t* payload;
  int64_t n, k, capg;
  int vec_s, sort_here;
  SelState* st;
  uint32_t* ghist;          // [NDIG + 1][BINS]
  unsigned long long* wk;   // winners [P]
  uint32_t* wr;
  unsigned long long* ck[2];  // candidate buffers [capg]
  uint32_t* cr[2];
  int32_t* out_s;
  int32_t* out_sec;
  int32_t* out_idx;
};

struct Snap {
  unsigned long long prefix, mask;
  uint32_t rem, digit, done, finished, compact, src, m, sampled, guess;
};

// Trace of the last call, compiled only with -DYT_TRACE (build.py sets it
// when YT_KERNEL_TRACE=1): per pick, the device clock (ns) and the state
// it left; slot 0 the start, the last slot the end.
constexpr int TRACE_SLOTS = 16;
#ifdef YT_TRACE
__device__ unsigned long long g_trace[TRACE_SLOTS][4];
__device__ uint32_t g_trace_n;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void trace(unsigned long long a,
                                      unsigned long long b,
                                      unsigned long long c) {
  uint32_t i = g_trace_n;
  if (i < TRACE_SLOTS) {
    g_trace[i][0] = now_ns();
    g_trace[i][1] = a;
    g_trace[i][2] = b;
    g_trace[i][3] = c;
    g_trace_n = i + 1;
  }
}
#else
__device__ __forceinline__ void trace(unsigned long long, unsigned long long,
                                      unsigned long long) {}
#endif

__device__ __forceinline__ uint32_t ld_volatile(const uint32_t* p) {
  return *(const volatile uint32_t*)p;
}

// one slot per lane whose predicate holds, by one atomic per warp; every
// lane of the warp must call it
__device__ __forceinline__ uint32_t warp_slot(bool pred, uint32_t* counter) {
  unsigned b = __ballot_sync(0xffffffffu, pred);
  if (!b) return 0;
  int lane = threadIdx.x & 31;
  int leader = __ffs(b) - 1;
  uint32_t base = 0;
  if (lane == leader) base = atomicAdd(counter, (uint32_t)__popc(b));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + (uint32_t)__popc(b & ((1u << lane) - 1u));
}

// add one to bin for every lane where pred holds: lanes on one bin are
// merged into one shared atomic. Every lane of the warp must call it.
__device__ __forceinline__ void warp_hist(bool pred, uint32_t bin,
                                          uint32_t* h) {
  unsigned act = __ballot_sync(0xffffffffu, pred);
  if (pred) {
    unsigned peers = __match_any_sync(act, bin);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(h + bin, (uint32_t)__popc(peers));
  }
}

template <bool TIE, bool FLT>
__device__ __forceinline__ uint32_t hi_of(int32_t s) {
  return TIE ? tie_hi(s, FLT) : topk_hi(s, FLT);
}

// The bucket of the rem-th smallest key over h[0, nbins): writes
// (digit, rows before it, rows in it) to out. All THREADS threads call it.
template <bool GLOBAL>
__device__ void find_bucket(const uint32_t* h, int nbins, uint32_t rem,
                            uint32_t* s_warp, uint32_t* out) {
  constexpr int PER = BINS / THREADS;
  __syncthreads();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t c[PER], sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    int b = t * PER + j;
    c[j] = b < nbins ? (GLOBAL ? __ldcg(h + b) : h[b]) : 0u;
    sum += c[j];
  }
  uint32_t x = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    uint32_t y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t v = lane < WARPS ? s_warp[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      uint32_t y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    s_warp[lane] = v;
  }
  __syncthreads();
  uint32_t cum = x - sum + (warp ? s_warp[warp - 1] : 0u);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (cum < rem && cum + c[j] >= rem) {
      out[0] = (uint32_t)(t * PER + j);
      out[1] = cum;
      out[2] = c[j];
    }
    cum += c[j];
  }
  __syncthreads();
}

// A pass's shared memory: COPIES interleaved histograms, then a staging
// area for the bucket rows the pass moves (keys, then rows).
constexpr int COPIES = 8;
constexpr int HIST_BYTES = BINS * COPIES * 4;
constexpr int STAGE_CAP = (SMEM_BYTES - HIST_BYTES) / 12 / 1024 * 1024;

struct PassSmem {
  uint32_t* h;
  unsigned long long* sk;
  uint32_t* sr;
  uint32_t* count;          // rows staged by this block
};

// one add to bin for every lane where pred holds, into the lane's copy
// of the histogram (lanes l and l + 8 share a copy), so that lanes on
// one bin meet at most 4 to an address
__device__ __forceinline__ void pass_hist(bool pred, uint32_t bin,
                                          uint32_t* h) {
  if (pred) atomicAdd(h + bin * COPIES + (threadIdx.x & (COPIES - 1)), 1u);
}

// Where a warp's round of winners and moving rows go: the winners' next
// slot (ow), the stage's next slot (om), and for stage slots past
// STAGE_CAP, which go to device memory directly, the first such slot and
// its device position (gb).
struct Claim {
  uint32_t ow, om, first_over, gb;
  bool over;
};

// One warp-wide scan of x (winners << 16 | moving rows, at most 32 * 8
// each) a lane, and one atomic a counter for the warp. Returns false when
// the warp has nothing to place. Every lane of the warp calls it.
__device__ __forceinline__ bool warp_claim(const SelArgs& a, const Snap& S,
                                           uint32_t x, int dst,
                                           const PassSmem& ps, Claim& cl) {
  const int lane = threadIdx.x & 31;
  uint32_t inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  const uint32_t tot = __shfl_sync(0xffffffffu, inc, 31);
  if (tot == 0) return false;
  const uint32_t tw = tot >> 16, tm = tot & 0xffffu;
  uint32_t bw = 0, bm = 0;
  if (lane == 0) {
    if (tw) bw = atomicAdd(&a.st->wcount, tw);
    if (tm) bm = atomicAdd(ps.count, tm);
  }
  bw = __shfl_sync(0xffffffffu, bw, 0);
  bm = __shfl_sync(0xffffffffu, bm, 0);
  cl.first_over = max(bm, (uint32_t)STAGE_CAP);
  const uint32_t nover =
      bm + tm > cl.first_over ? bm + tm - cl.first_over : 0u;
  cl.gb = 0;
  if (nover) {
    if (lane == 0)
      cl.gb = atomicAdd(S.done ? &a.st->eqtaken : &a.st->ccount[dst], nover);
    cl.gb = __shfl_sync(0xffffffffu, cl.gb, 0);
  }
  cl.over = nover != 0;
  const uint32_t excl = inc - x;
  cl.ow = bw + (excl >> 16);
  cl.om = bm + (excl & 0xffffu);
  return true;
}

// A moving row at position pos of the pass's output: to the candidate
// buffer, or, once the bucket is settled, to the winners' tail while it
// is short of rem rows.
__device__ __forceinline__ void spill(const SelArgs& a, const Snap& S,
                                      int dst, uint32_t pos,
                                      unsigned long long key, uint32_t row) {
  if (!S.done) {
    __stcg(a.ck[dst] + pos, key);
    __stcg(a.cr[dst] + pos, row);
  } else if (pos < S.rem) {
    const int64_t o = a.k - (int64_t)S.rem + pos;
    __stcg(a.wk + o, key);
    __stcg(a.wr + o, row);
  }
}

// the next moving row of the warp's claim: into the stage, or past
// STAGE_CAP straight out
__device__ __forceinline__ void stage_row(const SelArgs& a, const Snap& S,
                                          int dst, const PassSmem& ps,
                                          Claim& cl, unsigned long long key,
                                          uint32_t row) {
  const uint32_t om = cl.om++;
  if (om < (uint32_t)STAGE_CAP) {
    ps.sk[om] = key;
    ps.sr[om] = row;
  } else {
    spill(a, S, dst, cl.gb + (om - cl.first_over), key, row);
  }
}

__device__ __forceinline__ void put_winner(const SelArgs& a, Claim& cl,
                                           unsigned long long key,
                                           uint32_t row) {
  __stcg(a.wk + cl.ow, key);
  __stcg(a.wr + cl.ow, row);
  ++cl.ow;
}

// Histogram, and move, a group of G classified keys a thread (c: 0 out,
// 1 better than the bucket, 2 in the bucket). Every lane of the warp calls
// it. Winners go straight to their slots; bucket rows that move (to the
// candidate buffer, or taken when the bucket is settled) are staged in
// shared memory and written out by the block at the end of the pass with
// one global atomic. One warp-wide scan places a whole round, so a warp
// makes one atomic a round on each counter.
template <int G>
__device__ __forceinline__ void place_group(
    const SelArgs& a, const Snap& S, const unsigned long long* key,
    const uint32_t* row, const int* c, int dst, int shift, uint32_t dmask,
    const PassSmem& ps) {
  if (!S.done) {
#pragma unroll
    for (int j = 0; j < G; ++j)
      pass_hist(c[j] == 2, (uint32_t)(key[j] >> shift) & dmask, ps.h);
  }
  if (!(S.compact || S.done)) return;
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < G; ++j) x += c[j] == 1 ? 0x10000u : (c[j] == 2);
  Claim cl;
  if (!warp_claim(a, S, x, dst, ps, cl)) return;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (c[j] == 1) put_winner(a, cl, key[j], row[j]);
    else if (c[j] == 2) stage_row(a, S, dst, ps, cl, key[j], row[j]);
  }
}

// place_group for a full-array round given as masks over the thread's 8
// rows (row j at i0 + (j / 4) * 4 THREADS + j % 4): histogram and move
// only the rows whose bit is set
__device__ __forceinline__ void place_masks(
    const SelArgs& a, const Snap& S, const uint32_t* hi8,
    const uint32_t* lo8, uint32_t win, uint32_t inb, int64_t i0, int dst,
    int shift, uint32_t dmask, const PassSmem& ps) {
  if (!S.done) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t bin = shift >= 32 ? hi8[j] >> (shift - 32)
                                       : lo8[j] >> shift;
      pass_hist((inb >> j) & 1u, bin & dmask, ps.h);
    }
  }
  if (!(S.compact || S.done)) return;
  Claim cl;
  if (!warp_claim(a, S, ((uint32_t)__popc(win) << 16) | (uint32_t)__popc(inb),
                  dst, ps, cl))
    return;
  // winners are at most k over the whole select: most threads skip
  if (win) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if ((win >> j) & 1u)
        put_winner(a, cl, ((unsigned long long)hi8[j] << 32) | lo8[j],
                   (uint32_t)(i0 + (j >> 2) * (THREADS * 4) + (j & 3)));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (!((inb >> j) & 1u)) continue;
    const unsigned long long key = ((unsigned long long)hi8[j] << 32) | lo8[j];
    const uint32_t row = (uint32_t)(i0 + (j >> 2) * (THREADS * 4) + (j & 3));
    if (!cl.over) {
      // the warp's rows all fit the stage: no test a row
      ps.sk[cl.om] = key;
      ps.sr[cl.om] = row;
      ++cl.om;
    } else {
      stage_row(a, S, dst, ps, cl, key, row);
    }
  }
}

// the block's staged rows out to the candidate buffer or the winners
__device__ void flush_stage(const SelArgs& a, const Snap& S, int dst,
                            const PassSmem& ps, uint32_t* s_base) {
  const uint32_t cnt = min(*ps.count, (uint32_t)STAGE_CAP);
  if (threadIdx.x == 0)
    *s_base = cnt ? atomicAdd(S.done ? &a.st->eqtaken : &a.st->ccount[dst],
                              cnt)
                  : 0u;
  __syncthreads();
  const uint32_t base = *s_base;
  for (uint32_t i = threadIdx.x; i < cnt; i += THREADS)
    spill(a, S, dst, base + i, ps.sk[i], ps.sr[i]);
}

__device__ __forceinline__ void load4(const int32_t* p, int64_t i0,
                                      int64_t m, bool vec, int32_t v[4]) {
  if (vec && i0 + 3 < m) {
    int4 q = __ldg((const int4*)(p + i0));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i0 + j < m ? __ldg(p + i0 + j) : 0;
  }
}

// a block's COPIES interleaved histograms of nbins bins into gh
__device__ void merge_hist(const uint32_t* h, uint32_t* gh, int nbins) {
  for (int b = threadIdx.x; b < nbins; b += THREADS) {
    const uint4* q = (const uint4*)(h + b * COPIES);
    const uint4 x = q[0], y = q[1];
    const uint32_t v = x.x + x.y + x.z + x.w + y.x + y.y + y.z + y.w;
    if (v) atomicAdd(gh + b, v);
  }
}

// a block's share of the scores: [beg, end), beg a multiple of 4 rows
__device__ __forceinline__ void block_share(int64_t m, int64_t* beg,
                                            int64_t* end) {
  *beg = (m * blockIdx.x / gridDim.x) & ~(int64_t)3;
  *end = blockIdx.x + 1 == gridDim.x
             ? m
             : (m * (blockIdx.x + 1) / gridDim.x) & ~(int64_t)3;
}

// The sample: digit 0 of the first round (8 rows a thread) of every
// block's share, from which the picking block guesses the bucket of the
// k-th key, so that the first pass can histogram that bucket's next digit
// too (two digits picked after one pass over the scores).
template <bool TIE, bool FLT>
__device__ void run_sample(const SelArgs& a, unsigned char* smem) {
  uint32_t* h = (uint32_t*)smem;
  for (int b = threadIdx.x; b < BINS * COPIES; b += THREADS) h[b] = 0;
  __syncthreads();
  int64_t beg, end;
  block_share(a.n, &beg, &end);
  end = min(end, beg + (int64_t)THREADS * 8);
  const int64_t i0 = beg + threadIdx.x * 4;
  int32_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0;
  if (i0 < end) {
    load4(a.scores, i0, end, a.vec_s, v);
    load4(a.scores, i0 + THREADS * 4, end, a.vec_s, v + 4);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t r = i0 + (j >> 2) * (THREADS * 4) + (j & 3);
    pass_hist(r < end, hi_of<TIE, FLT>(v[j]) >> (dig_shift(0) - 32), h);
  }
  __syncthreads();
  merge_hist(h, a.ghist + (size_t)SAMPLE * BINS, BINS);
  if (threadIdx.x == 0 && end > beg)
    atomicAdd(&a.st->scount, (uint32_t)(end - beg));
}

// One pass of every block over the current source.
template <bool TIE, bool FLT>
__device__ void run_pass(const SelArgs& a, const Snap& S,
                         unsigned char* smem, uint32_t* s_misc) {
  const bool from_in = S.src == 0;
  const int64_t m = from_in ? a.n : (int64_t)S.m;
  const int p = S.digit < NDIG ? (int)S.digit : NDIG - 1;
  const int shift = dig_shift(p);
  const uint32_t dmask = (1u << dig_bits(p)) - 1u;
  const int dst = S.src == 1 ? 1 : 0;   // C1 when reading C0, else C0
  PassSmem ps;
  ps.h = (uint32_t*)smem;
  ps.sk = (unsigned long long*)(smem + HIST_BYTES);
  ps.sr = (uint32_t*)(smem + HIST_BYTES + STAGE_CAP * 8);
  ps.count = s_misc;
  // the first pass (digit 0, histograms only) also histograms digit 1
  // of the rows in the sample's guessed bucket, in the stage's room
  const bool two = S.digit == 0;
  uint32_t* h2 = (uint32_t*)(smem + HIST_BYTES);
  static_assert(2 * HIST_BYTES <= SMEM_BYTES, "two histograms fit");
  if (!S.done)
    for (int b = threadIdx.x; b < BINS * COPIES; b += THREADS) ps.h[b] = 0;
  if (two)
    for (int b = threadIdx.x; b < BINS * COPIES; b += THREADS) h2[b] = 0;
  if (threadIdx.x == 0) *ps.count = 0;
  __syncthreads();
  // In tie mode a row's docid is read only where the key's low half
  // decides this pass: the state has picked low digits, or the digit
  // histogrammed is a low one. Rows moved without it carry the low half
  // they came with (zero from the scores), which a later pass that needs
  // it reads again, and the tail and the sort set (full_key).
  const uint32_t mlo = (uint32_t)S.mask;
  const bool lo_needed = mlo != 0u || (!S.done && shift < 32);
  if (from_in) {
    const uint32_t mhi = (uint32_t)(S.mask >> 32);
    const uint32_t phi = (uint32_t)(S.prefix >> 32);
    const uint32_t plo = (uint32_t)S.prefix;
    const bool moving = S.compact || S.done;
    // a pass that only histograms a digit of the score half needs no key
    const bool hist_only = !moving && !lo_needed;
    const int hshift = shift - 32;
    // each block takes an equal contiguous share (a multiple of 4 rows),
    // in rounds of 8 rows a thread: 16-byte loads of neighbouring lanes,
    // the next round's 8 scores in flight while this round's are placed
    constexpr int64_t PER = (int64_t)THREADS * 8;
    int64_t beg, end;
    block_share(m, &beg, &end);
    int32_t nx[8];
    int64_t i0 = beg + threadIdx.x * 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) nx[j] = 0;
    if (i0 < end) {
      load4(a.scores, i0, end, a.vec_s, nx);
      load4(a.scores, i0 + THREADS * 4, end, a.vec_s, nx + 4);
    }
    for (int64_t base = beg; base < end; base += PER, i0 += PER) {
      int32_t s8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) s8[j] = nx[j];
      if (i0 + PER < end) {
        load4(a.scores, i0 + PER, end, a.vec_s, nx);
        load4(a.scores, i0 + PER + THREADS * 4, end, a.vec_s, nx + 4);
      }
      if (hist_only) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int64_t r = i0 + (j >> 2) * (THREADS * 4) + (j & 3);
          const uint32_t hi = hi_of<TIE, FLT>(s8[j]);
          const bool in = r < end && (hi & mhi) == phi;
          pass_hist(in, (hi >> hshift) & dmask, ps.h);
          if (two)
            pass_hist(in && hi >> (dig_shift(0) - 32) == S.guess,
                      (hi >> (dig_shift(1) - 32)) & (BINS - 1), h2);
        }
        continue;
      }
      // classify by the score half into two masks of this thread's 8
      // rows (better than the bucket, in the bucket), then by the low
      // half where the state has picked low digits
      uint32_t hi8[8], win = 0, inb = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t r = i0 + (j >> 2) * (THREADS * 4) + (j & 3);
        hi8[j] = hi_of<TIE, FLT>(s8[j]);
        const uint32_t hm = hi8[j] & mhi;
        const bool valid = r < end;
        win |= (uint32_t)(valid && hm < phi) << j;
        inb |= (uint32_t)(valid && hm == phi) << j;
      }
      uint32_t lo8[8];
      const uint32_t need = lo_needed ? inb : 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        lo8[j] = TIE ? 0u
                     : (uint32_t)(i0 + (j >> 2) * (THREADS * 4) + (j & 3));
      if (TIE && need) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t row =
              (uint32_t)(i0 + (j >> 2) * (THREADS * 4) + (j & 3));
          if ((need >> j) & 1u) lo8[j] = sec_key(__ldg(a.sec + row));
        }
      }
      if (mlo) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if ((inb >> j) & 1u) {
            const uint32_t ml = lo8[j] & mlo;
            if (ml != plo) inb &= ~(1u << j);
            if (ml < plo) win |= 1u << j;
          }
        }
      }
      place_masks(a, S, hi8, lo8, win, inb, i0, dst, shift, dmask, ps);
    }
  } else {
    // each block takes an equal contiguous share of the buffer, 4
    // entries a thread in flight
    const unsigned long long* sk = a.ck[S.src - 1];
    const uint32_t* sr = a.cr[S.src - 1];
    const int64_t beg = m * blockIdx.x / gridDim.x;
    const int64_t end = m * (blockIdx.x + 1) / gridDim.x;
    for (int64_t base = beg; base < end; base += THREADS * 4) {
      unsigned long long key[4];
      uint32_t row[4];
      int c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t i = base + j * THREADS + threadIdx.x;
        key[j] = i < end ? __ldcg(sk + i) : ~0ull;
        row[j] = i < end ? __ldcg(sr + i) : 0u;
      }
      if (TIE && lo_needed) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (base + j * THREADS + threadIdx.x < end)
            key[j] = (key[j] & ~0xffffffffull) |
                     sec_key(__ldg(a.sec + row[j]));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned long long mk = key[j] & S.mask;
        c[j] = base + j * THREADS + threadIdx.x >= end
                   ? 0
                   : (mk < S.prefix ? 1 : (mk == S.prefix ? 2 : 0));
      }
      place_group<4>(a, S, key, row, c, dst, shift, dmask, ps);
    }
  }
  __syncthreads();
  if (S.compact || S.done) flush_stage(a, S, dst, ps, s_misc + 1);
  if (!S.done) merge_hist(ps.h, a.ghist + (size_t)p * BINS, (int)dmask + 1);
  if (two) merge_hist(h2, a.ghist + (size_t)BINS, BINS);
}

// One digit of the pick: the bucket of the N.rem-th key over digit
// N.digit's histogram, and the state it leaves in N. Every thread calls it;
// returns whether the first pass's second histogram holds the next digit
// of the chosen bucket (the sample's guess held).
__device__ bool pick_digit(const SelArgs& a, uint32_t guess, Snap& N,
                           uint32_t* s_warp, uint32_t* s_out) {
  const int p = (int)N.digit;
  find_bucket<true>(a.ghist + (size_t)p * BINS, 1 << dig_bits(p), N.rem,
                    s_warp, s_out);
  const uint32_t d = s_out[0], cnt = s_out[2];
  const uint32_t rem = N.rem - s_out[1];
  const bool done = cnt == rem || p == NDIG - 1;
  __syncthreads();   // every thread has read N and s_out
  if (threadIdx.x == 0) {
    const bool shrinks = N.src == 0 ? (int64_t)cnt < a.n : cnt < N.m;
    N.rem = rem;
    N.done = done;
    N.compact = !done && (int64_t)cnt <= a.capg && shrinks;
    N.prefix |= (unsigned long long)d << dig_shift(p);
    N.mask |= (unsigned long long)((1u << dig_bits(p)) - 1u) << dig_shift(p);
    N.digit = (uint32_t)p + 1;
    trace(p, N.src, ((unsigned long long)N.m << 32) | cnt);
  }
  __syncthreads();
  return p == 0 && d == guess && !done;
}

// The picking block's step after a pass: choose the digit (two after the
// first pass when the sample's guess held; after the sample, only the
// guess), move the state.
__device__ void pick(const SelArgs& a, const Snap& S, uint32_t* s_warp,
                     uint32_t* s_out) {
  SelState* st = a.st;
  if (S.done) {
    if (threadIdx.x == 0) {
      st->finished = 1;
      s_out[3] = 1;
      trace(100, S.src, S.m);
    }
    return;
  }
  if (!S.sampled) {
    // the bucket of the k-th key's share of the sample (at least one row)
    const uint32_t t = __ldcg(&st->scount);
    const uint32_t ks = (uint32_t)(((int64_t)a.k * t + a.n - 1) / a.n);
    find_bucket<true>(a.ghist + (size_t)SAMPLE * BINS, BINS,
                      ks < 1u ? 1u : ks, s_warp, s_out);
    if (threadIdx.x == 0) {
      st->guess = s_out[0];
      st->sampled = 1;
      s_out[3] = 0;
      trace(400, s_out[0], t);
    }
    return;
  }
  __shared__ Snap N;
  if (threadIdx.x == 0) {
    N = S;
    if (S.mask == 0ull) N.rem = (uint32_t)a.k;
    if (S.compact) {
      N.src = S.src == 1 ? 2u : 1u;
      N.m = __ldcg(&st->ccount[N.src - 1]);
    }
  }
  __syncthreads();
  if (pick_digit(a, S.guess, N, s_warp, s_out)) {
    pick_digit(a, S.guess, N, s_warp, s_out);
  } else if (S.digit == 0) {
    // the guess missed: digit 1's histogram starts from zero
    for (int b = threadIdx.x; b < BINS; b += THREADS) a.ghist[BINS + b] = 0;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (N.compact) st->ccount[N.src == 1 ? 1 : 0] = 0;
    st->prefix = N.prefix;
    st->mask = N.mask;
    st->rem = N.rem;
    st->digit = N.digit;
    st->done = N.done;
    st->compact = N.compact;
    st->src = N.src;
    st->m = N.m;
    // a buffer small enough is finished by this block alone
    st->finished = s_out[3] = N.src != 0 && N.m <= (uint32_t)TAIL_CAP;
  }
}

// Grid barrier with the pick in the middle: the last block to arrive
// (atomic ticket after __threadfence) picks, then releases the others.
// Needs every block resident (cooperative launch). A wait that outlasts
// any real pass by far traps (the call fails loudly, never with a wrong
// answer). Returns whether this block picked and settled the select
// (s_out[3]).
__device__ bool barrier_pick(const SelArgs& a, const Snap& S,
                             uint32_t* s_warp, uint32_t* s_out,
                             uint32_t* s_flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t g = ld_volatile(&a.st->gen);
    __threadfence();
#ifdef YT_TRACE
    atomicMax(&a.st->first_arrive, ~now_ns());   // the earliest arrival
#endif
    const uint32_t t = atomicAdd(&a.st->arrive, 1u);
    s_flag[0] = t == gridDim.x - 1;
    s_flag[1] = g;
  }
  __syncthreads();
  const bool picker = s_flag[0] != 0;
  bool settled = false;
  if (picker) {
    __threadfence();
#ifdef YT_TRACE
    if (threadIdx.x == 0) {
      trace(300, ~__ldcg(&a.st->first_arrive), 0);
      a.st->first_arrive = 0;
    }
#endif
    pick(a, S, s_warp, s_out);
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicExch(&a.st->arrive, 0u);
      __threadfence();
      atomicAdd(&a.st->gen, 1u);
    }
    settled = s_out[3] != 0;
  } else if (threadIdx.x == 0) {
    uint32_t spins = 0;
    while (ld_volatile(&a.st->gen) == s_flag[1]) {
      __nanosleep(100);
      if (++spins > (1u << 25)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
  return settled;
}

// In tie mode a key moved by a pass over the scores may carry a zero low
// half (the docid is read there only where the pass needs it): the tail
// and the sort, which compare whole keys, set it from the row.
__device__ __forceinline__ unsigned long long full_key(
    const int32_t* sec, unsigned long long key, uint32_t row) {
  return sec ? (key & ~0xffffffffull) | sec_key(__ldg(sec + row)) : key;
}

__device__ __forceinline__ bool pair_gt(unsigned long long ka, uint32_t ia,
                                        unsigned long long kb, uint32_t ib) {
  return ka > kb || (ka == kb && ia > ib);
}

// bitonic sort of P (a power of two) (key, row) pairs in shared memory
__device__ void sort_pairs(unsigned long long* sk, uint32_t* si, uint32_t P) {
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
}

__device__ __forceinline__ void write_out(const SelArgs& a, uint32_t i,
                                          uint32_t r) {
  a.out_s[i] = a.scores[r];
  a.out_sec[i] = a.payload ? a.payload[r] : (a.sec ? a.sec[r] : (int32_t)r);
  a.out_idx[i] = (int32_t)r;
}

// sort the k <= SHARED_SORT_MAX winners and write the outputs. Up to
// THREADS winners a bitonic network runs in registers, one pair a
// thread: exchanges within a warp by shuffles, wider ones through shared
// memory. More winners sort in shared memory.
__device__ void sort_output(const SelArgs& a, unsigned char* smem) {
  uint32_t P = 32;
  while ((int64_t)P < a.k) P <<= 1;
  unsigned long long* sk = (unsigned long long*)smem;
  uint32_t* si = (uint32_t*)(smem + SHARED_SORT_MAX * 8);
  const uint32_t t = threadIdx.x;
  __syncthreads();
  if (P > (uint32_t)THREADS) {
    for (uint32_t i = t; i < P; i += blockDim.x) {
      bool in = (int64_t)i < a.k;
      si[i] = in ? __ldcg(a.wr + i) : 0xffffffffu;
      sk[i] = in ? full_key(a.sec, __ldcg(a.wk + i), si[i]) : ~0ull;
    }
    __syncthreads();
    sort_pairs(sk, si, P);
    for (uint32_t i = t; (int64_t)i < a.k; i += blockDim.x)
      write_out(a, i, si[i]);
    return;
  }
  // P is a multiple of 32: a warp holds pairs or idles whole, and idle
  // warps only meet the barriers
  const bool mine = t < P;
  const bool in = (int64_t)t < a.k;
  uint32_t row = in ? __ldcg(a.wr + t) : 0xffffffffu;
  unsigned long long key = in ? full_key(a.sec, __ldcg(a.wk + t), row)
                              : ~0ull;
  // two exchange buffers in turn: one barrier an exchange
  int buf = 0;
  for (uint32_t size = 2; size <= P; size <<= 1) {
    for (uint32_t j = size >> 1; j > 0; j >>= 1) {
      unsigned long long pk = 0;
      uint32_t pr = 0;
      if (j >= 32) {
        unsigned long long* xk = sk + buf * THREADS;
        uint32_t* xi = si + buf * THREADS;
        buf ^= 1;
        if (mine) {
          xk[t] = key;
          xi[t] = row;
        }
        __syncthreads();
        if (mine) {
          pk = xk[t ^ j];
          pr = xi[t ^ j];
        }
      } else if (mine) {
        pk = __shfl_xor_sync(0xffffffffu, key, j);
        pr = __shfl_xor_sync(0xffffffffu, row, j);
      }
      if (mine) {
        const bool keep_min = ((t & j) == 0) == ((t & size) == 0);
        const bool take = keep_min ? pair_gt(key, row, pk, pr)
                                   : pair_gt(pk, pr, key, row);
        if (take) {
          key = pk;
          row = pr;
        }
      }
    }
  }
  if (in) write_out(a, t, row);
}

// Finish the select over the at most TAIL_CAP candidates of the current
// buffer in shared memory: the remaining digits, then the winners.
__device__ void tail(const SelArgs& a, unsigned char* smem,
                     uint32_t* s_warp, uint32_t* s_out) {
  unsigned long long* tk = (unsigned long long*)smem;
  uint32_t* tr = (uint32_t*)(smem + TAIL_CAP * 8);
  uint32_t* h = (uint32_t*)(smem + TAIL_CAP * 12);
  const SelState* st = a.st;
  const uint32_t src = __ldcg(&st->src), m = __ldcg(&st->m);
  unsigned long long prefix = __ldcg(&st->prefix), mask = __ldcg(&st->mask);
  uint32_t rem = __ldcg(&st->rem), done = __ldcg(&st->done);
  int p = (int)__ldcg(&st->digit);
  for (uint32_t i = threadIdx.x; i < m; i += THREADS) {
    tr[i] = __ldcg(a.cr[src - 1] + i);
    tk[i] = full_key(a.sec, __ldcg(a.ck[src - 1] + i), tr[i]);
  }
  __syncthreads();
  while (!done) {
    const int shift = dig_shift(p), nb = 1 << dig_bits(p);
    for (int b = threadIdx.x; b < nb; b += THREADS) h[b] = 0;
    __syncthreads();
    for (uint32_t r0 = 0; r0 < m; r0 += THREADS) {
      const uint32_t i = r0 + threadIdx.x;
      const bool in = i < m && (tk[i] & mask) == prefix;
      warp_hist(in, in ? (uint32_t)(tk[i] >> shift) & (nb - 1) : 0u, h);
    }
    find_bucket<false>(h, nb, rem, s_warp, s_out);
    prefix |= (unsigned long long)s_out[0] << shift;
    mask |= (unsigned long long)(nb - 1) << shift;
    rem -= s_out[1];
    done = s_out[2] == rem || p == NDIG - 1;
    ++p;
  }
  for (uint32_t r0 = 0; r0 < m; r0 += THREADS) {
    const uint32_t i = r0 + threadIdx.x;
    const unsigned long long mk = i < m ? (tk[i] & mask) : ~0ull;
    const bool wapp = i < m && mk < prefix;
    const bool take = i < m && mk == prefix;
    const uint32_t ws = warp_slot(wapp, &a.st->wcount);
    if (wapp) {
      __stcg(a.wk + ws, tk[i]);
      __stcg(a.wr + ws, tr[i]);
    }
    const uint32_t ts = warp_slot(take, &a.st->eqtaken);
    if (take && ts < rem) {
      const int64_t o = a.k - (int64_t)rem + ts;
      __stcg(a.wk + o, tk[i]);
      __stcg(a.wr + o, tr[i]);
    }
  }
  __threadfence();
  __syncthreads();
}

template <bool TIE, bool FLT>
__global__ void __launch_bounds__(THREADS, 1) select_kernel(SelArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_warp[32], s_out[4], s_flag[2], s_misc[2];
  __shared__ Snap S;
#ifdef YT_TRACE
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    g_trace_n = 0;
    trace(a.n, a.k, gridDim.x);
  }
#endif
  while (true) {
    if (threadIdx.x == 0) {
      const SelState* st = a.st;
      S.prefix = __ldcg(&st->prefix);
      S.mask = __ldcg(&st->mask);
      S.rem = __ldcg(&st->rem);
      S.digit = __ldcg(&st->digit);
      S.done = __ldcg(&st->done);
      S.finished = __ldcg(&st->finished);
      S.compact = __ldcg(&st->compact);
      S.src = __ldcg(&st->src);
      S.m = __ldcg(&st->m);
      S.sampled = __ldcg(&st->sampled);
      S.guess = __ldcg(&st->guess);
    }
    __syncthreads();
    if (S.finished) return;
    if (S.sampled)
      run_pass<TIE, FLT>(a, S, smem, s_misc);
    else
      run_sample<TIE, FLT>(a, smem);
    if (barrier_pick(a, S, s_warp, s_out, s_flag)) {
      // the picking block goes on alone once the select is settled
      if (!S.done) tail(a, smem, s_warp, s_out);
      if (threadIdx.x == 0) trace(201, 0, 0);
      if (a.sort_here) sort_output(a, smem);
      if (threadIdx.x == 0) trace(200, 0, 0);
      return;
    }
  }
}

// the k winners' whole keys (full_key), then padding up to P
__global__ void sort_prep(unsigned long long* ck, uint32_t* ci,
                          const int32_t* sec, uint32_t k, uint32_t P) {
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < k) {
    ck[i] = full_key(sec, ck[i], ci[i]);
  } else if (i < P) {
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

__global__ void sel_output(SelArgs a) {
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if ((int64_t)i < a.k) write_out(a, i, a.wr[i]);
}

static uint32_t pow2_at_least(int64_t k) {
  uint32_t p = 1;
  while ((int64_t)p < k) p <<= 1;
  return p;
}

static int64_t cap_g(int64_t n) {
  if (n <= TAIL_CAP) return n;
  return n / 16 > TAIL_CAP ? n / 16 : TAIL_CAP;
}

using KernelFn = void (*)(SelArgs);

static KernelFn kernel_for(bool tie, bool flt) {
  if (tie) return flt ? select_kernel<true, true> : select_kernel<true, false>;
  return flt ? select_kernel<false, true> : select_kernel<false, false>;
}

// resident blocks of the select kernel on the current device (cached;
// the four instances use the same resources)
static cudaError_t grid_limit(int* out) {
  static int cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0, coop = 0;
  for (int v = 0; v < 4; ++v) {
    KernelFn f = kernel_for(v & 1, v & 2);
    e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return e;
    int b = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, f, THREADS,
                                                      SMEM_BYTES);
    if (e != cudaSuccess) return e;
    per_sm = v == 0 || b < per_sm ? b : per_sm;
  }
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

// scratch bytes the wrapper must allocate for a top-k of size k of n rows
extern "C" int64_t yt_tie_topk_scratch_bytes(int64_t n, int64_t k) {
  int64_t P = pow2_at_least(k < 1 ? 1 : k);
  return HDR_BYTES + P * 12 + cap_g(n) * 24;
}

// The trace of the last call (TRACE_SLOTS x 4 u64: device ns, then three
// words of state per pick) into host memory; returns the slots written,
// 0 when built without YT_TRACE, -1 on a CUDA error.
extern "C" int yt_tie_topk_trace(void* host) {
#ifdef YT_TRACE
  uint32_t n = 0;
  if (cudaMemcpyFromSymbol(&n, g_trace_n, sizeof(n)) != cudaSuccess ||
      cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace)) != cudaSuccess)
    return -1;
  return (int)n;
#else
  (void)host;
  return 0;
#endif
}

// scores [n] int32 (or f32 bits, is_float); secondary [n] int32 or null
// (index mode); payload [n] int32 or null: out_sec is payload[row] when
// given, else secondary[row], else the row. 1 <= k <= n < 2^31.
extern "C" int yt_tie_topk(const void* scores, int is_float,
                           const void* secondary, const void* payload,
                           int64_t n, int64_t k, void* scratch,
                           void* out_scores, void* out_sec, void* out_idx,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k < 1 || k > n || n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t e = grid_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const uint32_t P = pow2_at_least(k);
  const int64_t capg = cap_g(n);
  char* base = (char*)scratch;
  SelArgs a;
  a.scores = (const int32_t*)scores;
  a.sec = (const int32_t*)secondary;
  a.payload = (const int32_t*)payload;
  a.n = n;
  a.k = k;
  a.capg = capg;
  a.vec_s = ((uintptr_t)scores % 16) == 0;
  a.sort_here = P <= (uint32_t)SHARED_SORT_MAX;
  a.st = (SelState*)base;
  a.ghist = (uint32_t*)(base + STATE_BYTES);
  unsigned long long* k64 = (unsigned long long*)(base + HDR_BYTES);
  a.wk = k64;
  a.ck[0] = k64 + P;
  a.ck[1] = k64 + P + capg;
  uint32_t* r32 = (uint32_t*)(k64 + P + 2 * capg);
  a.wr = r32;
  a.cr[0] = r32 + P;
  a.cr[1] = r32 + P + capg;
  a.out_s = (int32_t*)out_scores;
  a.out_sec = (int32_t*)out_sec;
  a.out_idx = (int32_t*)out_idx;

  int64_t want = (n + THREADS * 8 - 1) / (THREADS * 8);
  int grid = (int)(want < limit ? want : limit);
  e = cudaMemsetAsync(scratch, 0, HDR_BYTES, s);
  if (e != cudaSuccess) return (int)e;
  void* kargs[] = {&a};
  e = cudaLaunchCooperativeKernel(
      (const void*)kernel_for(secondary != nullptr, is_float != 0),
      dim3(grid), dim3(THREADS), kargs, SMEM_BYTES, s);
  if (e != cudaSuccess) return (int)e;
  if (!a.sort_here) {
    uint32_t blocks = (P + 255) / 256;
    sort_prep<<<blocks, 256, 0, s>>>(a.wk, a.wr, a.sec, (uint32_t)k, P);
    for (uint32_t size = 2; size <= P; size <<= 1)
      for (uint32_t j = size >> 1; j > 0; j >>= 1)
        sort_step<<<blocks, 256, 0, s>>>(a.wk, a.wr, P, j, size);
    sel_output<<<((uint32_t)k + 255) / 256, 256, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
