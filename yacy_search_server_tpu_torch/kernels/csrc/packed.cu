// K12 `unpack_rows` and K13 `pack_block_batch`: the bit-packed block
// format's decode and its device build (ops/packed.py).
//
// K12 replaces ops/packed.unpack_rows_dev of the JAX package (packed.py:
// 205). The scorers fuse the decode itself (common.cuh unpack_value, in
// K5bp, K6bp, K7bp and the packed finish); this standalone launch
// decodes `rows` rows from row `row0` of one block into int32 feats [rows,
// 17], flags and docids, as the reference function returns them: the
// store's promotion probe decodes a promoted block's first row with it,
// and the checks decode whole blocks. A thread decodes one value: the
// feature values in the output's row-major order (coalesced writes),
// then the flags and the docids. Bound: bytes, the block's words read
// once and 76 B a row written.
//
// K13 replaces ingest/devbuild._pack_block_batch_kernel (devbuild.py:71):
// B blocks of rows [B, rows] (int16 features [B, rows, 17], int32 flags
// and docids; lane b's first n[b] rows valid) bit-packed as
// ops/packed.pack_block packs them. Three steps, no atomics, so the
// words are the same on every run:
//   1. pack_minmax, one block a (column, lane): the column's min and max
//      over the lane's valid rows, the width max(1, 32 - clz(uint32(max -
//      min))) (the subtraction wraps: an int32 column's spread fits
//      uint32); an empty lane gives min = max = 0 and width 1.
//   2. pack_words, a thread an output word: the lane's word offsets are
//      the exclusive prefix of ceil(n w / 32) over its columns (each
//      block recomputes the 19 of its lane; block 0 of the lane writes
//      the meta vector and the total); the thread finds its word's column
//      and ORs in the at most ceil(32 / w) + 1 values whose bits overlap
//      the word. Words past the total are 0, as in the reference.
// The words equal the host pack's OR fold and the reference's scatter-
// add (distinct values own disjoint bits). Bound: bytes, the valid rows'
// 42 B read (twice: the reduction, then the lay-down) and the words
// written.
#include "common.cuh"

namespace yt {

constexpr int UNPACK_THREADS = 256;
constexpr int MM_THREADS = 256;
constexpr int PW_THREADS = 256;

__global__ void __launch_bounds__(UNPACK_THREADS)
unpack_rows(const uint32_t* __restrict__ words, int64_t nw, int64_t wbase,
            const PackMeta m, int64_t row0, int64_t rows,
            int32_t* __restrict__ feats, int32_t* __restrict__ flags,
            int32_t* __restrict__ docids) {
  __shared__ int32_t s_meta[META_LEN];
  if (threadIdx.x < META_LEN) s_meta[threadIdx.x] = m.v[threadIdx.x];
  __syncthreads();
  const int64_t nf = rows * NF;
  const int64_t total = nf + 2 * rows;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += step) {
    if (g < nf) {
      const int64_t r = g / NF;
      feats[g] = unpack_col(words, nw, wbase, s_meta, (int)(g - r * NF),
                            row0 + r);
    } else if (g < nf + rows) {
      flags[g - nf] = unpack_col(words, nw, wbase, s_meta, C_FLAGS,
                                 row0 + g - nf);
    } else {
      docids[g - nf - rows] = unpack_col(words, nw, wbase, s_meta, C_DOCIDS,
                                         row0 + g - nf - rows);
    }
  }
}

// value of row r, column c of lane b (rows per lane `rows`)
__device__ __forceinline__ int32_t lane_value(const int16_t* __restrict__ f16,
                                              const int32_t* __restrict__ fl,
                                              const int32_t* __restrict__ dd,
                                              int64_t rows, int b, int c,
                                              int64_t r) {
  const int64_t i = (int64_t)b * rows + r;
  if (c < NF) return (int32_t)f16[i * NF + c];
  return c == C_FLAGS ? fl[i] : dd[i];
}

// per (column, lane): min, width -> mw[b][c] = (min, width)
__global__ void __launch_bounds__(MM_THREADS)
pack_minmax(const int16_t* __restrict__ f16, const int32_t* __restrict__ fl,
            const int32_t* __restrict__ dd, const int32_t* __restrict__ n,
            int64_t rows, int32_t* __restrict__ mw) {
  const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int64_t nb = n[b];
  int32_t lo = 2147483647, hi = -2147483647 - 1;
  for (int64_t r = t; r < nb; r += MM_THREADS) {
    const int32_t v = lane_value(f16, fl, dd, rows, b, c, r);
    lo = min(lo, v);
    hi = max(hi, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  __shared__ int32_t s_lo[MM_THREADS / 32], s_hi[MM_THREADS / 32];
  if ((t & 31) == 0) {
    s_lo[t >> 5] = lo;
    s_hi[t >> 5] = hi;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < MM_THREADS / 32; ++w) {
      lo = min(lo, s_lo[w]);
      hi = max(hi, s_hi[w]);
    }
    if (nb <= 0) lo = hi = 0;
    const uint32_t spread = (uint32_t)hi - (uint32_t)lo;
    const int width = max(1, 32 - __clz(spread));
    mw[((int64_t)b * NCOLS + c) * 2] = lo;
    mw[((int64_t)b * NCOLS + c) * 2 + 1] = width;
  }
}

// a thread an output word of lane blockIdx.y: words [B, rows * NCOLS],
// meta [B, META_LEN], totals [B]
__global__ void __launch_bounds__(PW_THREADS)
pack_words(const int16_t* __restrict__ f16, const int32_t* __restrict__ fl,
           const int32_t* __restrict__ dd, const int32_t* __restrict__ n,
           int64_t rows, const int32_t* __restrict__ mw,
           int32_t* __restrict__ words, int32_t* __restrict__ meta,
           int32_t* __restrict__ totals) {
  __shared__ int64_t s_off[NCOLS + 1];
  __shared__ int32_t s_min[NCOLS], s_w[NCOLS];
  const int b = blockIdx.y, t = threadIdx.x;
  const int64_t nb = n[b];
  if (t < NCOLS) {
    s_min[t] = mw[((int64_t)b * NCOLS + t) * 2];
    s_w[t] = mw[((int64_t)b * NCOLS + t) * 2 + 1];
  }
  __syncthreads();
  if (t == 0) {
    int64_t off = 0;
    for (int c = 0; c < NCOLS; ++c) {
      s_off[c] = off;
      off += (nb * s_w[c] + 31) >> 5;
    }
    s_off[NCOLS] = off;
  }
  __syncthreads();
  if (blockIdx.x == 0 && t < NCOLS) {
    int32_t* mb = meta + (int64_t)b * META_LEN;
    mb[t] = (int32_t)s_off[t];
    mb[NCOLS + t] = s_w[t];
    mb[2 * NCOLS + t] = s_min[t];
    if (t == 0) totals[b] = (int32_t)s_off[NCOLS];
  }
  const int64_t nwords = rows * NCOLS;
  const int64_t g = (int64_t)blockIdx.x * PW_THREADS + t;
  if (g >= nwords) return;
  uint32_t word = 0u;
  if (g < s_off[NCOLS]) {
    int c = 0;
    while (c + 1 < NCOLS && g >= s_off[c + 1]) ++c;
    const int64_t w = s_w[c];
    const uint32_t vmin = (uint32_t)s_min[c];
    const int64_t bit0 = (g - s_off[c]) * 32;   // the word's first bit
    const int64_t r0 = bit0 / w;
    int64_t r1 = (bit0 + 31) / w;
    if (r1 > nb - 1) r1 = nb - 1;
    for (int64_t r = r0; r <= r1; ++r) {
      const uint32_t v =
          (uint32_t)lane_value(f16, fl, dd, rows, b, c, r) - vmin;
      const int64_t p = r * w - bit0;            // in (-w, 32)
      word |= p >= 0 ? (v << p) : (v >> -p);
    }
  }
  words[(int64_t)b * nwords + g] = (int32_t)word;
}

}  // namespace yt

using namespace yt;

// K12: words [nw] int32 (the packed-words store), the block at word
// wbase with meta (57 int32, host memory); rows rows from row0 into
// feats [rows, 17], flags [rows] and docids [rows], int32.
extern "C" int yt_unpack_rows(const void* words, int64_t nw, int64_t wbase,
                              const int32_t* meta, int64_t row0,
                              int64_t rows, void* feats, void* flags,
                              void* docids, void* stream) {
  if (nw < 1 || rows < 0 || row0 < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  PackMeta m;
  for (int c = 0; c < META_LEN; ++c) m.v[c] = meta[c];
  const int64_t total = rows * (NF + 2);
  int64_t grid = (total + UNPACK_THREADS - 1) / UNPACK_THREADS;
  if (grid > 4096) grid = 4096;
  unpack_rows<<<(int)grid, UNPACK_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, nw, wbase, m, row0, rows, (int32_t*)feats,
      (int32_t*)flags, (int32_t*)docids);
  return (int)cudaGetLastError();
}

// K13: f16 [B, rows, 17] int16, fl and dd [B, rows] int32, n [B] int32
// (valid rows a lane, <= rows); scratch [B, 19, 2] int32; out words
// [B, rows * 19], meta [B, 57] and totals [B], int32.
extern "C" int yt_pack_block_batch(const void* f16, const void* fl,
                                   const void* dd, const void* n, int nb,
                                   int64_t rows, void* scratch, void* words,
                                   void* meta, void* totals, void* stream) {
  if (nb < 1 || nb > 65535 || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  pack_minmax<<<dim3(NCOLS, nb), MM_THREADS, 0, s>>>(
      (const int16_t*)f16, (const int32_t*)fl, (const int32_t*)dd,
      (const int32_t*)n, rows, (int32_t*)scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (rows * NCOLS + PW_THREADS - 1) / PW_THREADS;
  if (blocks > 2147483647) return (int)cudaErrorInvalidValue;
  pack_words<<<dim3((unsigned)blocks, nb), PW_THREADS, 0, s>>>(
      (const int16_t*)f16, (const int32_t*)fl, (const int32_t*)dd,
      (const int32_t*)n, rows, (const int32_t*)scratch, (int32_t*)words,
      (int32_t*)meta, (int32_t*)totals);
  return (int)cudaGetLastError();
}
