#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build the port's CUDA kernels from kernels/csrc (nvcc, sm_90a);
2. hold every kernel against its plain PyTorch version on the card:
   kernels 1-2 on a 10M-row compact block and a 10M-row int32 block under
   the default and authority=15 profiles, a ragged last tile, a view
   that starts off 16 bytes, a block with no valid row, and column bounds
   and features at the edges of the int32 arithmetic; kernel 3 at
   k = 10, 100, 1000 with int32 and f32 scores and constructed ties, 10M
   equal scores, scores on which the sampled guess misses, k = n,
   k = 2049, n = 1, 7, 1023, int32 -2^31 and f32 NaN, -0.0 and -inf in
   both modes; kernel 1 at n = 0, 1, 63, 64, 65, 257 and 200,003 with
   0, 1, 1000, n and 4M host bins (more than a cluster's shared bins)
   and ids outside them, an offset view, no valid row, one host inside
   and beyond the shared bins, NaN and +-inf term frequencies, each call
   twice;
   kernel 4 over 1, 2, 8, 16 and 32 sorted runs (one a shard; 32,000
   rows are more than a block stages), f32 and int32, runs shorter than
   k, ties and padding rows across runs, special values, and a run out
   of order; the devstore kernels on an edge store
   (kernels/bench.devstore_edges): K5 pruned_tile at bs = 1, 16 and 20
   with pad slots and kk = 16, 128, 1024, 2048 in both forms, under the
   default profile and one whose bound fails, K5 and K5bp
   pruned_tile_bp on the tile edges (kernels/bench.TILE_EDGE_TERMS: a
   span shorter than kk, one of one tile, one all dead, equal scores
   across the CTAs' boundaries) at kk = 16, 128, 2048, K6 span_stats and K7
   span_score over 1, 2 and 8 extents (offset, ragged, all dead, empty),
   and topk_finish in both forms; K8 join_member on a join edge store
   (kernels/bench.join_edges: excludes only, a partner meeting no row
   and one holding every row, bitmap, sort and mixed partners, five
   partners and six excludes, tombstoned rare rows, docids past the
   bitmaps' coverage and at and above 2^29, each filter alone and all
   four; four docids at or above 2^29, one tombstoned, for the clip
   rule) and K6/K7 under each filter, K7 also on statistics handed in
   as a filtered-stats cache hit does; K6, K7 and topk_finish with a
   RAM delta block (7, 50,000 and 300,000 rows: span docids, tombstoned
   ones, new ones) and a 4M-bit facet bitmap, with and without a
   filter; the batched scan (span_stats_batch, span_topk_batch, its
   lists in device memory past kk 2048) over waves of 1, 3 and 16 edge
   scans at kk 16 and 1024 (and 4096 and 8192 at 16), each slot also
   equal to the solo scan and to the CPU's; the batched join
   (join_member_batch, join_stats_batch, join_score_batch over each
   slot's rows, join_batch_query's slots equal to the solo join_query's)
   on the join edge store's waves (kernels/bench.join_edge_waves: 16
   bitmap slots, mixed modes, the clip rows in every slot as partner and
   as exclude, five partners and six excludes; every filter, a slot of
   no row) and, on the main path's store, 16 bitmap slots of joinA &
   headline (no filter, lang en, a flag bit, a date range in turn), 4
   sort-mode slots of term1000000 against joinB and 4 slots of
   term1000000 & headline & -joinB; the dense rerank's kernels on a
   forward index of 65,536 unit rows: K9 `dense_dot` in gather mode and
   K10 `rerank_sort` over waves at nb = 16, 128, 1024 (bs = 16), 128 (bs
   = 1 and 20) and 16,384 (bs = 2), ragged, with pad slots and lanes,
   docids -1 and past the rows, alpha 0, 0.5 and 1; K9's block mode over
   1,000 f16 rows; its similarity mode for 1, 16 and 33 queries and K11
   `hybrid_blend` on them; K17 `power_iterate` on edge lists of 1, 31,
   33, 1000 and 300,001 hosts, one with a 50,000-in-edge hub, one of only
   dangling hosts, damping 0.85 and 0.5, and the realistic host graph
   (kernels/bench.host_graph: 1,000,000 hosts, about 5M edges), each
   against the plain version on the CPU to the bit, trip count included;
   K7's docid column under each filter and K18 `xjoin` (each case's
   probes term by term, then the apply, unfiltered and under all four
   filters) on the join edge store (kernels/bench.xjoin_edge_cases: the
   clip rows, an empty window, one at the table's end, includes then an
   exclude, excludes only); K4 batched over 4 cells' runs in K5's order
   (random, all tied, two cells without the term) at bs 1 and 8, kk 16
   and 2048; K16's halves over a 1M x 4 block split over 2 x 2 cells;
3. drive three main paths at the headline size, a 10M-posting term, each
   with the launch counts reset before it and read after: the placed
   step (CardinalRanker.rank (k = 10 and 100), MeshRanker.place once and
   50 rank_placed queries, MeshBM25.topk at 1M docs x 4 terms (K16 and
   kernel 3, k = 100),
   and stream_score_topk over the 10M block in 2M-row chunks; every
   result checked against the port's numpy twins); then the device
   store: an RWIIndex run of the 10M term and terms of 1M, 100k and 20k
   postings packed into a DeviceSegmentStore on the card and a twin on
   the CPU; first the conjunctions (the run also holds joinA, 4M
   postings drawn from [0, 40M), joinB, 30,000 drawn the same way, and
   joinC, 2M drawn from [0, 80M), past the join bitmaps' coverage):
   K8 at a rare span of MAX_JOIN_ROWS against its plain version, then
   rank_join over joinA & headline, joinA & headline & term1000000,
   term1000000 & headline & -joinB, joinA & joinB, term1000000 & joinC
   (a sort-mode partner of 2M rows), joinA & headline under a language
   and date filter, a "plain" degraded join, and filtered rank_term on
   the headline term cold and from the filtered-stats cache, each equal
   to the twin's and (joinA & joinB, term1000000 & joinC and the plain
   join) to the numpy oracle (kernels/bench.devjoin_oracle,
   devstore_oracle); then, counts read and reset, the batched joins: the
   six conjunctions x 2 profiles x k = 10 and 100 x {no filter, lang en}
   sent one at a time, from 16 threads, and from 16 threads through the
   batcher (once untimed first), then one group of them (joinA &
   headline, lang en, k = 100) the same ways, every answer the twin's
   (the default profile's without a filter) or the card's solo answer,
   with q/s, p50/p95, live slots a join_member_batch launch (the one
   group's must average more than one) and the peak device memory; then
   a join a RAM delta declines, and the join path's walls (median of 50
   after a warm-up); then,
   the result cache off, rank_term's 50 pruned queries (k = 10 and
   100), a query on each
   other term, the escalating profile, k = 1000, a delete (the exact
   scan over one span) and a second run (over two), every answer equal
   to the twin's and (the smaller terms') to the numpy oracle
   (kernels/bench.devstore_oracle), and the filtered query after them;
   between the k = 1000 query and the
   delete, counts reset, the batched path's part 1: a result-cache hit
   equal to the cold answer, then a pruned mix (the store's 7 terms, two
   profiles, two languages, k = 10 and 100), its default/en/k = 100
   queries alone (one K5 group, so that waves can fill) and a
   filtered-scan mix (the 1M, 100k and 20k terms and joinB, whose RAM
   delta keeps it out of the waves; four filters; the 20k term also at
   k = 3000, kk 4096: the batched K7's lists in device memory) sent one
   at a time
   without the batcher, from 16 threads without it, and from 16 threads
   through it (`enable_batching`, scan batching on), every answer equal
   to the solo card answer and the twin's (the filtered scans' at k = 100),
   with q/s and p50/p95 of each
   and the live slots a launch; the batcher must have served
   (dispatches, no timeout, no exception) and K5 and the batched scan
   must have launched with more than one live slot; then up to 256
   deletes of the scan mix's answers (none of the 10M term's) land
   while 16 threads send the scan mix through the batcher, and the
   card's tombstone bitmap and the mix's answers must equal the twin's,
   and up to 256 deletes of joinA's docids (none of the single-term
   terms') land while 16 threads send joinC & joinA conjunctions through
   the batcher, with the same checks;
   after the filtered query, the batched path's part 2: a site:-style
   facet bitmap over the 20M docid space admitting 2 %, alone and with a
   language filter, and RAM deltas of 50,000 and 300,000 postings on the
   10M term, each equal to the numpy oracle, with their
   walls (median of 50 after a warm-up); every kernel of each path must
   have launched; then, counts reset, the hybrid rerank on the same
   store: a forward index of 2^21 unit vectors (dim 256, f16: the
   default 1 GiB budget, full) loaded by convert.dense_from_numpy on the
   card and on the twin; a mix of 54 reranks (the sparse answers of the
   store's 7 terms x 2 profiles x k = 10, 100, 1000 and of joinA &
   headline and term1000000 & headline, taken on the join path, at alpha
   0.5, query vectors from the port's HashingEncoder) sent one at a time
   without a batcher, from 16 threads without one and from 16 threads
   through it (after an untimed pass), every answer the twin's, with q/s,
   p50/p95 and the live slots of each K9 launch (more than one needed);
   a hybrid-cache hit equal to its cold answer with no device work; 1,000
   vector writes (one patch) and the mix again; hybrid_rerank_topk(_batch)
   over the whole index (B = 1 and 16) against their plain versions; and
   a put at docid 2^21, which grows the block past its budget:
   rerank_boost declines (counted) and the host fallback (get_block,
   dense_boost_topk, the re-sort) equals the twin's; then, counts reset,
   the dense-first path on the same store: 2^21 clustered unit
   vectors (1024 centres, noise 0.15) in a DenseVectorStore, an
   AnnVectorIndex built from it on the card at the JAX defaults (1024
   clusters, nprobe 8, 2^15 probe lanes, a 1 GiB budget: every cluster
   hot) and a CPU twin index of its layout; a mix of 54 dense-first
   queries (a vector near a corpus row with the sparse answer of each
   hybrid-mix query, its k, alpha 0.5) sent one at a time, from 16
   threads and from 16 threads through the batcher (K14 `ann_assign` and
   K15 `ann_fuse` waves, live slots logged), every answer the twin's to
   the bit; recall@10 against exact_topk; a dense-first cache hit and its
   invalidation when the index is laid out again; a probe-lane budget
   that drops whole clusters (counted, the twin's answers); a query while
   the device is lost (search_host's numpy answer to the bit); and the
   tier ladder: the same layout under a 2^28-byte budget, rounds of the
   mix through the batcher until no promotion is left (warm clusters on
   the host, promotions through the `promote` kind, a cache entry
   re-keyed by them), every answer then a CPU twin's in the same tiers to
   the bit and within 64 units of the all-hot answers; then device loss, on
   a store of its own (the 1M term
   and a 200,000-posting term meeting it): one injected
   `device.transfer_fail` charge (a counted retry, the same answers), a
   streak (the loss declared, rank_term and rank_join answering None,
   counted, the result cache's entry dead), the rebuild recovering with
   answers bit-identical to those before the loss, a rerank while lost
   answering None counted in rerank_fallbacks only (and after the
   rebuild its answer from before), and 16 batched
   waiters under a loss all returning, then recovered again; then, counts
   reset, the packed path: a fresh RWIIndex of the same run (17,150,000
   rows), a packed store on the card (DeviceSegmentStore(...,
   packed_residency=True), the device build on: K13 packs the blocks of
   64 to 2^18 rows) and an int16 store on the card beside it, each pack
   timed; the 50 queries, the other terms, the escalating profile, k =
   1000, four filters on every term and the filtered query at k = 3000
   (past K7bp's selection: its buffer, kernel 3 and topk_finish_bp),
   every answer the int16 store's;
   the pruned mix (448 sent) one at a time, from 16 threads and from 16
   threads through the batcher (K5bp waves, live slots logged); a device
   loss whose rebuild promotes every block again through the batcher's
   `promote` kind (K12 decoding each promoted block's first row), the
   mix's answers the same after it; the tier ladder: the budget cut to
   hold the 10M term's block but not every block, a second loss whose
   rebuild places the blocks under it, 16 clients sending the mix's
   queries through the batcher (warm hits, promotions through the
   batcher, LRU demotions, compactions; every answer the int16 store's or
   a counted miss), the 10M term served again, a flush with no warm
   budget (blocks evicted cold) and a cold promotion, and a delete (the
   packed exact scan); then K13 at a flush's shape: a run of 256 terms of
   log-uniform sizes in [64, 262,144] rows packed on the card and by the
   CPU twin's host pack, every block word for word the twin's, and
   queries on two of its terms (pruned, filtered, after a delete) the
   twin's; then, counts reset, the BlockRank path on the port's stores:
   5,000 documents over 1,000 hosts, 10 anchors each, in a
   WebStructureGraph, a WebgraphStore and two MetadataStores,
   power_iterate_sparse over the realistic host graph (equal to phase 2's
   plain ranks), and postprocessing_p with run=1 with the webgraph empty
   (the host matrix) and full (the edges), on the card and on the CPU:
   equal pages, host ranks and metadata rows; then one more document
   whose edge rows carry the new cr_host_norm_i; then, counts reset, the
   mesh path: the run re-keyed under word2hash of its terms' names (the
   same arrays, 17,150,000 rows, on both term rows of a 2 x 2 mesh) in a
   MeshSegmentStore with its four cells on the card (budget 8 GiB) and
   its CPU twin on four CPU cells (kernels/bench.mesh_twin); the headline
   term pruned, term1000000 escalating, every term pruned, a wave of 8
   pruned queries through the batcher (kernels/bench.mesh_wave), joinA &
   headline and term1000000 & headline & -joinB (cross-row, K18), joinA
   & joinB and term1000000 & joinC (column-local), then on term1000000
   the language filter, a tombstone (the exact scan) and a RAM delta of
   50,000 rows, every answer and the counters the twin's; MeshRanker
   over the 10M term and MeshBM25 at 2 x 2 cells against the placed
   step's answers. Every other phase must end with no transfer failure,
   retry or loss;
4. check kernel 3 on the inputs it is timed on (the step's scores and
   the default profile's scores of the compact block, k = 10, 100, 1000,
   both modes), then time each kernel at the main path's shapes beside
   its plain version, its bound and, for kernel 3, torch.topk: `ms` is
   the call time (the median of 20 calls, each between two CUDA events
   from an idle queue, kernels/bench.call_ms), `device_ms`
   the device time (the calls queued behind a spin kernel,
   kernels/bench.device_ms). First at the shapes of
   MeshRanker.rank_placed (the int32 block under authority=15 with 10M
   host bins; tie_topk in tie mode on that step's scores at k = 10, 100,
   1000, and in index mode; gather_topk on one shard's run of 100 beside
   an empty kernel's launch), then at the compact shapes, kernel 4 on
   8 and 16 sorted runs of 1000, and kernel 1 at the rank_placed shape
   with its host ids drawn Zipf (s = 1.1) over 50,000 hosts and all on
   one host (each checked first); then, on a fresh store of the 10M term,
   K5 at bs = 1 and 16, K7 over the escalating profile's prefix, and the
   exact scan's K6, K7, kernel 3 and topk_finish (each checked first),
   and rank_term's wall per query (median of 50 after a warm-up) pruned,
   escalating and, after a tombstone, the exact scan; K6 and K7 under a
   filter over the 10M term, K6 and K7 with RAM deltas of 50,000 and
   300,000 rows and with the 2 % facet bitmap (alone and with the
   language filter), and K8 at the joinA & headline shape beside
   torch.searchsorted and a gather on the same partner segment; K8 at
   term1000000 against joinB's sorted segment, and join_member_batch,
   join_stats_batch and join_score_batch at 16 bitmap slots of joinA &
   headline and at 4 sort slots of term1000000 & joinB, each wave's
   K8 beside the solo K8 on each of its slots, and join_batch_query's
   wall beside the solo join_query's; K5 at 16
   slots over 16 queries' spans as the batcher launches it, and the
   batched scan at 16 slots (the 10M and 1M terms under the mix's four
   filters, k = 10 and 100) beside 16 solo scans, and its K7 at kk 128
   and 4096 at 16 and 7 slots; K9 (gather mode) and
   K10 over the hybrid mix's 16-query waves at nb = 16, 128, 1024, one
   query, 2 slots of 16,384 and a solo rerank of 9,000 candidates as
   rerank_boost issues it (16 slots of 16,384, 15 of them pad slots; the
   bound reads a row that several lanes share once), each wave's
   rerank_fwd_batch_packed with
   its fetch beside a gather + einsum + sort; K9's block mode at
   dense_boost_topk's k = 100 and 1000; K9's similarity mode and K11 for
   B = 16 and 1 over the 2^21-row index, each held to its plain version
   on every row, beside torch.matmul in bf16; K14 over 16 of the
   dense-first mix's queries against the 1024 centroids (beside a bf16
   matmul and topk), K15 over a 16-slot wave of the mix's commonest lane
   bucket and one slot at nb = 32768 (beside a gather, a bf16 einsum and
   a sort), and K16 `bm25_pass` over MeshBM25's placed 1M x 4 block, each
   held to its plain version first; the packed path's kernels
   beside their int16 counterparts' call times (`int16_ms`): K12 over
   every row of the 10M term's block (held to the host unpack_block too),
   K5bp at 1 and 16 slots of its first tile, K6bp, K7bp with its
   selection (`span_topk_bp`), K7bp's buffer and topk_finish_bp over the
   10M term without and with the filtered rank_term's filter, and K13
   over the 256-term flush's 2^18-row lanes;
   the mesh path's kernels on its cells: K7 with the docid column over
   the 10M term's cell, K4 batched at the wave's 8 slots x 4 cells (kk
   16 and 128), K16's halves over one MeshBM25 cell, K18's probe (beside
   torch.searchsorted and a gather) and apply at joinA & headline, K8
   in sort mode on the cell of a column-local join that holds the
   largest partner segment (beside torch.searchsorted and a gather),
   and the summed bounds of MeshRanker's and MeshBM25's kernels at 2 x 2;
   K17 over the realistic host graph (a launch over a prepared layout,
   beside the whole call, the plain version and cuSPARSE's CSR mat-vec
   with the sum and the update in torch, and its device busy time from a
   profiler trace);
   rank_placed's wall per query over 50 queries after a warm-up; and,
   last, the device
   operations one call of each timed kernel issues, with their device
   times (a profiler trace; K18's probe must be one).

With YT_KERNEL_TRACE=1 the kernels are built with tie_topk's per-pass
trace, which phase 4 prints.

Prints the card's name and power limit, one JSON line of kernel
measurements, and last `{"ok": true, "device": {...}}`. Needs a CUDA
device and the repository around it; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
import types
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

N = 10_000_000            # postings of the headline term
CHUNK = 2_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
OPS_PER_S = 67e12          # H100 SXM non-tensor f32 peak (simple-op bound)
# the profile of the JAX package's devstore tests whose pruning bound fails
# at one tile (tests/test_devstore.py), so its queries escalate
ESCALATING = dict(worddistance=2, appemph=15, urllength=12, tf=3)
DS_TERMS = (1_000_000, 100_000, 20_000)   # the run's terms beside the 10M
SECOND_RUN = 100_000                      # the 10M term's second run
# the run's join terms: postings, docid draw range. joinA meets about a
# quarter of the headline term's odd docids; joinB is below
# JOIN_BITMAP_MIN (a sort-mode partner); joinC reaches past the bitmaps'
# coverage, which the headline term sets (2^21 words), so it is a
# sort-mode partner of 2M rows
JOIN_TERMS = {b"joinAAAAAAAA": (4_000_000, 40_000_000),
              b"joinBAAAAAAA": (30_000, 40_000_000),
              b"joinCAAAAAAA": (2_000_000, 80_000_000)}
# the kernels each main path must launch
PLACED_KERNELS = ("cardinal_stats", "cardinal_score", "tie_topk",
                  "gather_topk", "bm25_pass")
DEVSTORE_KERNELS = ("pruned_tile", "span_stats", "span_score", "tie_topk",
                    "topk_finish")
JOIN_KERNELS = ("join_member", "cardinal_stats", "cardinal_score",
                "tie_topk", "topk_finish", "span_stats", "span_score")
BATCHED_KERNELS = ("pruned_tile", "span_stats", "span_score", "tie_topk",
                   "topk_finish", "span_stats_batch", "span_topk_batch")
# the filtered-scan mix's k past KD.FUSED_KK = 2048: kk = 4096, whose
# waves the batched K7 serves with its lists in device memory (and the
# packed path's K7bp with its buffer, kernel 3 and topk_finish_bp)
PAST_FUSED_K = 3000
MIX_THREADS = 16     # client threads of the concurrent mixes
MIX_REPEATS = 8      # each distinct query of a mix sent this many times
# the batched joins: each distinct conjunction sent this many times, and
# the one-group part's queries
JOIN_MIX_REPEATS = 8
JOIN_ONE_GROUP = 512
BATCHED_JOIN_KERNELS = ("join_member_batch", "join_stats_batch",
                        "join_score_batch", "tie_topk", "topk_finish_batch")
# the hybrid rerank: the forward index's rows (dim 256, f16: the default
# 1 GiB budget, full), each distinct query of its mix sent this many
# times, and the kernels its path must launch
DENSE_ROWS = 1 << 21
HYBRID_REPEATS = 8
HYBRID_KERNELS = ("dense_dot", "rerank_sort", "hybrid_blend", "tie_topk")
# the dense-first path: a corpus of 2^21 clustered vectors, the
# mix sent this many times, recall over this many queries, a probe-lane
# budget of about two clusters, the ladder's budget and its rounds, the
# bar of host-scored against device-scored fused scores
DF_ROWS = 1 << 21
DF_REPEATS = 4
DF_RECALL_QUERIES = 2
DF_SMALL_LANES = 4096
DF_LADDER_BUDGET = 1 << 28
DF_LADDER_ROUNDS = 6
DF_TOL = 64
DF_KERNELS = ("ann_assign", "ann_fuse")
# the packed path's kernels (K7bp's buffer, kernel 3 and topk_finish_bp
# past K7bp's selection, at PAST_FUSED_K)
PACKED_KERNELS = ("unpack_rows", "pruned_tile_bp", "span_stats_bp",
                  "span_topk_bp", "span_score_bp", "topk_finish_bp",
                  "pack_block_batch", "tie_topk")
# the BlockRank path: the postprocessing path's documents, their hosts and
# anchors a document (kernels/bench.link_docs), the servlet's page size,
# and the kernel the path must launch
BR_DOCS, BR_HOSTS, BR_ANCHORS = 5000, 1000, 10
BR_MAXHOSTS = 25
BLOCKRANK_KERNELS = ("power_iterate",)
# the mesh path: MeshSegmentStore on 2 x 2 cells of the card, MeshRanker
# and MeshBM25 at 2 x 2
MESH_KERNELS = ("pruned_tile", "gather_topk_batch", "span_stats",
                "span_score_docids", "tie_topk", "join_member",
                "xjoin_probe", "xjoin_apply", "cardinal_stats",
                "cardinal_score", "bm25_sums", "bm25_rows", "gather_topk")
# the counters that must read 0 outside the device-loss phase: nothing
# fell back to the host behind a check's back
LOSS_COUNTERS = ("transfer_failures", "transfer_retries", "device_losses")


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def walls_of(fn, reps: int = 50, warm: int = 5) -> list:
    """The wall of each of `reps` calls of fn after `warm` calls, in ms."""
    for _ in range(warm):
        fn()
    out = []
    for _ in range(reps):
        tq = time.perf_counter()
        fn()
        out.append((time.perf_counter() - tq) * 1e3)
    return out


def run_mix(stream, fn, threads: int):
    """Send the queries of `stream` through fn from `threads` client
    threads (each its share, in order; one: one at a time): ({query:
    [answers]}, {n, wall, qps, p50, p95} with each query's wall in ms)."""
    import numpy as np
    ans, lat, errors = {}, [], []
    lock = threading.Lock()

    def worker(mine):
        try:
            for q in mine:
                tq = time.perf_counter()
                a = fn(q)
                dt = (time.perf_counter() - tq) * 1e3
                with lock:
                    lat.append(dt)
                    ans.setdefault(q, []).append(a)
        except Exception as ex:  # noqa: BLE001 - failed below
            errors.append(ex)
    t0 = time.perf_counter()
    if threads == 1:
        worker(stream)
    else:
        ts = [threading.Thread(target=worker, args=(stream[i::threads],))
              for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        if any(t.is_alive() for t in ts):
            fail("a client thread of a mix did not finish")
    wall = time.perf_counter() - t0
    if errors:
        fail(f"a mix query raised: {errors[0]!r}")
    return ans, {"n": len(lat), "wall": wall, "qps": len(lat) / wall,
                 "p50": float(np.percentile(lat, 50)),
                 "p95": float(np.percentile(lat, 95))}


def check_mix(name, ans, refs):
    """Every answer of a mix equal to its query's reference answer."""
    import numpy as np
    for q, got in ans.items():
        want = refs[q]
        for a in got:
            if a is None or not (np.array_equal(a[0], want[0])
                                 and np.array_equal(a[1], want[1])
                                 and a[2] == want[2]):
                fail(f"mix {name}: {q[0].decode()} {q[1:]} answered "
                     "differently from its solo answer")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from yacy_search_server_tpu_torch import convert
    from yacy_search_server_tpu_torch.index import devstore as TD
    from yacy_search_server_tpu_torch.index import postings as P
    from yacy_search_server_tpu_torch.index.rwi import RWIIndex
    from yacy_search_server_tpu_torch.kernels import (LAUNCHES, SLOTS, WIDE,
                                                      build)
    from yacy_search_server_tpu_torch.kernels import bench as KB
    from yacy_search_server_tpu_torch.kernels import cardinal as KC
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    from yacy_search_server_tpu_torch.kernels import devstore as KD
    from yacy_search_server_tpu_torch.kernels import reset_launches
    from yacy_search_server_tpu_torch.kernels import topk as KT
    from yacy_search_server_tpu_torch.ops import dense as DN
    from yacy_search_server_tpu_torch.ops import ranking as R
    from yacy_search_server_tpu_torch.ops import streaming as S
    from yacy_search_server_tpu_torch.parallel import mesh as M
    from yacy_search_server_tpu_torch.kernels import blockrank as KBr
    from yacy_search_server_tpu_torch.ops import blockrank as BRo

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.time()

    # -- phase 1: build ----------------------------------------------------
    tb = time.time()
    build.library()
    log(f"build: {time.time() - tb:.1f} s (nvcc, sm_90a, "
        f"{len(list(build.CSRC.glob('*.cu')))} sources in parallel)")

    # -- data: a 10M-posting term from the seed ----------------------------
    # random columns in their real ranges, 50,000 hosts, and the best row
    # repeated: equal scores reach the top-k on purpose
    feats, docids, hostids, rng = KB.make_term(N)
    feats16, flags = R.compact_feats(feats)
    valid = np.ones(N, bool)
    valid[::1013] = False
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    f16_d, fl_d, f32_d = put(feats16), put(flags), put(feats)
    v_d, h_d, d_d = put(valid), put(hostids), put(docids)
    lang = P.pack_language("en")
    profiles = {"default": R.RankingProfile(),
                "authority15": R.RankingProfile(authority=15)}
    consts = {k: R.profile_consts(p, lang, dev) for k, p in profiles.items()}
    log(f"data: {N} postings, {feats16.nbytes / 1e6:.0f} MB compact, "
        f"{feats.nbytes / 1e6:.0f} MB int32")

    # -- phase 2: every kernel against its plain version --------------------
    err = {k: 0.0 for k in LAUNCHES}

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    def diff(a, b):
        a, b = bits(a).to(torch.int64), bits(b).to(torch.int64)
        if a.shape != b.shape:
            return float("inf")
        return float((a - b).abs().max()) if a.numel() else 0.0

    for pname, c in consts.items():
        for label, f_d, flg, fast in (("compact", f16_d, fl_d, True),
                                      ("int32", f32_d, None, False)):
            nh = N if profiles[pname].authority > 12 else 0
            st, cnt = KC.cardinal_stats(f_d, v_d, h_d, nh)
            pst, pcnt = KC.cardinal_stats_plain(f_d, v_d, h_d, nh)
            torch.cuda.synchronize()
            e1 = max(diff(st, pst), diff(cnt, pcnt))
            sc = KC.cardinal_score(f_d, flg, v_d, h_d, st, cnt, c, fast)
            psc = KC.cardinal_score_plain(f_d, flg, v_d, h_d, st, cnt, c,
                                          fast)
            torch.cuda.synchronize()
            e2 = diff(sc, psc)
            log(f"check cardinal_stats+score {label} {pname}: "
                f"stats err {e1} score err {e2}")
            if e1 or e2:
                fail(f"cardinal kernels disagree ({label}, {pname})")
            err["cardinal_stats"] = max(err["cardinal_stats"], e1)
            err["cardinal_score"] = max(err["cardinal_score"], e2)
            del psc, pst

    tie_scores = {
        "int32": (torch.from_numpy(rng.integers(0, 5000, N, dtype=np.int32))
                  .to(dev)),
        "f32": (torch.from_numpy((rng.integers(0, 5000, N) * 0.25)
                                 .astype(np.float32)).to(dev)),
    }
    tie_scores["f32"][::7] = -0.0
    tie_scores["f32"][::11] = float("-inf")
    for dname, s in tie_scores.items():
        for k in (10, 100, 1000):
            for mode in ("index", "tie"):
                sec = d_d if mode == "tie" else None
                pay = None if mode == "tie" else d_d
                g = KT.tie_topk(s, k, secondary=sec, payload=pay)
                w = KT.tie_topk_plain(s, k, secondary=sec, payload=pay)
                torch.cuda.synchronize()
                e = max(diff(g[0], w[0]), diff(g[1], w[1]),
                        diff(g[2], w[2]) if mode == "index" else 0.0)
                log(f"check tie_topk {dname} k={k} {mode}: err {e}")
                if e:
                    fail(f"tie_topk disagrees ({dname}, k={k}, {mode})")
                err["tie_topk"] = max(err["tie_topk"], e)

    # the new paths of kernel 3: the candidate buffer's overflow (10M
    # equal scores), k = n, k = 2049 (the sort in device memory), tiny n,
    # and the special values in both modes
    def check_topk(label, s, k, sec_all):
        for mode in ("index", "tie"):
            sec = sec_all if mode == "tie" else None
            pay = None if mode == "tie" else sec_all
            g = KT.tie_topk(s, k, secondary=sec, payload=pay)
            w = KT.tie_topk_plain(s, k, secondary=sec, payload=pay)
            torch.cuda.synchronize()
            e = max(diff(g[0], w[0]), diff(g[1], w[1]),
                    diff(g[2], w[2]) if mode == "index" else 0.0)
            log(f"check tie_topk {label} k={k} {mode}: err {e}")
            if e:
                fail(f"tie_topk disagrees ({label}, k={k}, {mode})")
            err["tie_topk"] = max(err["tie_topk"], e)

    check_topk("10M equal int32", torch.full((N,), 7, dtype=torch.int32,
                                             device=dev), 100, d_d)
    # scores rising with the row: the bucket guessed from the sample (the
    # first round of each block's share) misses the k-th key's
    rising = (torch.arange(2_000_000, dtype=torch.int64, device=dev)
              * 1024).to(torch.int32)
    check_topk("2M rising int32 (sample guess misses)", rising, 100,
               d_d[:2_000_000])
    for n_e, k_e in ((1, 1), (7, 7), (7, 3), (1023, 1023), (1023, 1),
                     (5000, 2049), (2049, 2049)):
        si = rng.integers(-3, 4, n_e).astype(np.int32)
        si[::3] = -(2**31)
        sf = (rng.integers(-3, 4, n_e) * 0.5).astype(np.float32)
        sf[::3] = np.nan
        sf[1::4] = -0.0
        sf[2::5] = -np.inf
        de = rng.permutation(n_e).astype(np.int32)
        de[::4] = 5
        for lbl, arr in (("int32 -2^31", si), ("f32 nan/-0/-inf", sf)):
            check_topk(f"{lbl} n={n_e}", put(arr), k_e, put(de))

    # kernel 1 one pass: row counts around the 64-row chunk and the
    # block, host bins from none to one a row, ids below 0 and at or above
    # num_hosts, an offset view, no valid row, one host, NaN and +-inf term
    # frequencies; every call twice (its accumulator and ticket reset)
    def stats_diff(a, b):
        a, b = a.cpu().clone(), b.cpu().clone()
        tf = slice(KC.S_TF_MIN, KC.S_TF_MAX + 1)
        both = torch.isnan(a[tf].view(torch.float32)) & torch.isnan(
            b[tf].view(torch.float32))
        a[tf][both] = 0
        b[tf][both] = 0
        return diff(a, b)

    def check_stats(label, f, v, h, nh):
        got = [KC.cardinal_stats(f, v, h, nh) for _ in range(2)]
        pst, pcnt = KC.cardinal_stats_plain(f, v, h, nh)
        torch.cuda.synchronize()
        e = max(max(stats_diff(st, pst), diff(cnt, pcnt)) for st, cnt in got)
        log(f"check cardinal_stats {label} num_hosts={nh}: err {e}")
        if e:
            fail(f"cardinal_stats disagrees ({label}, num_hosts={nh})")
        err["cardinal_stats"] = max(err["cardinal_stats"], e)
        return got[0]

    # 4M host bins: more than a cluster's shared bins hold (~300,000), so
    # the ids above them are added in device memory
    many = 4_000_000
    for label, f_d in (("compact", f16_d), ("int32", f32_d)):
        for n_s in (0, 1, 63, 64, 65, 257, 200_003):
            for nh in (0, 1, 1000, n_s, many):
                hh = (torch.remainder(h_d[:n_s].to(torch.int64) * 97,
                                      max(nh, 1) + 6) - 3).to(torch.int32)
                check_stats(f"{label} n={n_s}", f_d[:n_s], v_d[:n_s], hh, nh)
    nr = 100_003
    ef = feats[:nr].copy()
    ef[::101, P.F_WORDS_IN_TEXT] = -1
    ef[::101, P.F_WORDS_IN_TITLE] = 0
    ef[::101, P.F_HITCOUNT] = np.where(np.arange(len(ef[::101])) % 2, 5, -5)
    ef_nan = ef.copy()
    ef_nan[202, P.F_HITCOUNT] = 0
    all_v = torch.ones(nr, dtype=torch.bool, device=dev)
    compact = lambda a: R.compact_feats(a)[0]  # noqa: E731
    for label, f_d, conv in (("compact", f16_d, compact),
                             ("int32", f32_d, lambda a: a)):
        fv = f_d[1:nr + 1]
        if fv.data_ptr() % 16 == 0:
            fail("the offset view starts on 16 bytes")
        check_stats(f"{label} offset view n={nr}", fv, v_d[1:nr + 1],
                    h_d[1:nr + 1], 50_000)
        check_stats(f"{label} all invalid n={nr}", f_d[:nr],
                    torch.zeros(nr, dtype=torch.bool, device=dev), h_d[:nr],
                    50_000)
        for host, nh in ((17, 1000), (many - 1, many)):
            st, _ = check_stats(f"{label} one host ({host}) n={nr}",
                                f_d[:nr], v_d[:nr],
                                torch.full((nr,), host, dtype=torch.int32,
                                           device=dev), nh)
            if int(st[KC.S_HOST_MAX]) != int(v_d[:nr].sum()):
                fail("cardinal_stats: one host's count is not the valid "
                     "count")
        for tf_label, arr in (("+-inf tf", ef), ("NaN tf", ef_nan)):
            check_stats(f"{label} {tf_label} n={nr}", put(conv(arr)), all_v,
                        h_d[:nr], 1000)

    # the tile edges of kernel 2: a ragged last tile, a view that starts
    # 34 / 68 bytes into its storage, and a block with no valid row
    c15 = consts["authority15"]
    for label, f_d, flg, fast in (("compact", f16_d, fl_d, True),
                                  ("int32", f32_d, None, False)):
        no_valid = torch.zeros(nr, dtype=torch.bool, device=dev)
        for case, sl, vv in (("ragged", slice(0, nr), v_d[:nr]),
                             ("offset view", slice(1, nr + 1),
                              v_d[1:nr + 1]),
                             ("all invalid", slice(0, nr), no_valid)):
            fv = f_d[sl]
            fg = flg[sl] if flg is not None else None
            hv = h_d[sl]
            if case == "offset view" and fv.data_ptr() % 16 == 0:
                fail("the offset view starts on 16 bytes")
            st, cnt = KC.cardinal_stats_plain(fv, vv, hv, 50_000)
            sc = KC.cardinal_score(fv, fg, vv, hv, st, cnt, c15, fast)
            psc = KC.cardinal_score_plain(fv, fg, vv, hv, st, cnt, c15, fast)
            torch.cuda.synchronize()
            e2 = diff(sc, psc)
            log(f"check cardinal_score {label} {case} n={nr}: err {e2}")
            if e2:
                fail(f"cardinal_score disagrees ({label}, {case})")
            err["cardinal_score"] = max(err["cardinal_score"], e2)

    # the int32 arithmetic's edges: column spans of 0, 1, 2, 2^31-1 and
    # wrapped ones, and (f - min) * 256 on and beside both wrap boundaries
    ef, emin, emax = KB.edge_block(nr)
    ef_d = put(ef)
    st, cnt = KC.cardinal_stats_plain(ef_d, v_d[:nr], h_d[:nr], 50_000)
    st[KC.S_COL_MIN:KC.S_COL_MIN + P.NF] = put(emin)
    st[KC.S_COL_MAX:KC.S_COL_MAX + P.NF] = put(emax)
    for pname, c in consts.items():
        for fast in (False, True):
            sc = KC.cardinal_score(ef_d, None, v_d[:nr], h_d[:nr], st, cnt, c,
                                   fast)
            psc = KC.cardinal_score_plain(ef_d, None, v_d[:nr], h_d[:nr], st,
                                          cnt, c, fast)
            torch.cuda.synchronize()
            e2 = diff(sc, psc)
            log(f"check cardinal_score int32 edges {pname} fast_div={fast}: "
                f"err {e2}")
            if e2:
                fail(f"cardinal_score disagrees (int32 edges, {pname})")
            err["cardinal_score"] = max(err["cardinal_score"], e2)
    del ef_d

    # kernel 4 on sorted runs, one a shard, as the fusion gathers them:
    # 1, 2, 8, 16 and 32 runs, runs shorter than k, ties across runs, padding
    # rows repeated in every run, f32 NaN / -0.0 / +0.0 / -inf and int32
    # -2^31, and a run out of order (the kernel's all-pairs path)
    def check_gather(label, block, k, is_float, run_len):
        b = block.to(dev)
        g = KT.gather_topk(b[:, 0], b[:, 1], k, is_float, run_len=run_len)
        w = KT.gather_topk_plain(b[:, 0], b[:, 1], k, is_float,
                                 run_len=run_len)
        torch.cuda.synchronize()
        e = max(diff(g[0], w[0]), diff(g[1], w[1]))
        log(f"check gather_topk {label} k={k} float={is_float}: err {e}")
        if e:
            fail(f"gather_topk disagrees ({label}, k={k})")
        err["gather_topk"] = max(err["gather_topk"], e)

    for is_float in (False, True):
        for shards, rows, k in ((1, 1000, 1000), (1, 100, 7), (2, 1000, 1000),
                                (8, 1000, 1000), (16, 1000, 1000),
                                (8, 30, 100), (32, 1000, 1000)):
            check_gather(f"{shards} sorted runs x {rows}",
                         KB.sorted_runs(shards, rows, is_float, rng),
                         min(k, shards * rows), is_float, rows)
        for shards in (1, 2, 8, 16):
            blk = KB.sorted_runs(shards, 64, is_float, rng, pad=20,
                                 special=True)
            for k in (1, 50, shards * 64):
                check_gather(f"{shards} runs x 64, padding and special "
                             "values", blk, k, is_float, 64)
        blk = KB.sorted_runs(8, 100, is_float, rng, pad=10, special=True)
        blk[700:] = blk[700:][torch.from_numpy(rng.permutation(100))]
        check_gather("8 runs x 100, the last out of order", blk, 100,
                     is_float, 100)
    del tie_scores

    # the devstore kernels on an edge store (kernels/bench.devstore_edges:
    # a ragged last tile, a term one tile short, docids past the bitmap
    # that stay alive, tombstones in the first tile and on every row of a
    # term, a constant column, the best row repeated so that scores tie):
    # K5 at bs = 1, 16 and 20 (two pad slots; 20 slots take two launches)
    # and kk = 16, 128, 1024, 2048,
    # with and without the init entries, under the default profile and
    # one whose bound fails; K6 and K7 over 1, 2 and 8 extents (whole,
    # offset, ragged, all dead, empty) and buffers longer than the rows;
    # topk_finish in both forms
    edge, _edge_idx = KB.devstore_edges(dev)
    ea = (*edge.arena.arrays(), edge.arena.dead_array(), edge.arena._pmax)
    ds_profiles = {"default": R.RankingProfile(),
                   "escalating": R.RankingProfile(**ESCALATING)}
    ds_consts = {k: R.profile_consts(p, lang, dev)
                 for k, p in ds_profiles.items()}

    def note(name, label, e):
        log(f"check {name} {label}: err {e}")
        if e:
            fail(f"{name} disagrees ({label})")
        err[name] = max(err[name], e)

    for pname, prof in ds_profiles.items():
        shift, lterm = (int(v) for v in TD.prune_bound_consts(prof))
        for bs in (1, 16, 20):
            desc = KD.pack_desc(KB.edge_slots(edge, bs), shift, lterm)
            for kk in (16, 128, 1024, 2048):
                for init in (False, True):
                    g = KD.pruned_tile(*ea, desc, kk, ds_consts[pname], init)
                    w = KD.pruned_tile_plain(*ea, desc, kk, ds_consts[pname],
                                             init)
                    torch.cuda.synchronize()
                    note("pruned_tile", f"edges {pname} bs={bs} kk={kk} "
                         f"init={init}", diff(g, w))
                    if pname == "escalating" and kk == 16 \
                            and int(g[0, 2 * kk]) != 0:
                        fail("pruned_tile: the big edge term's bound "
                             "should fail under the escalating profile")
    # K5 and K5bp on the tile edges (kernels/bench.TILE_EDGE_TERMS: places
    # past a short span's count, a whole tile, every row dead, equal scores
    # across the CTAs' boundaries), an int16 store and a packed one, the
    # four spans in one descriptor
    from yacy_search_server_tpu_torch.kernels import packed as KP
    log(f"K5 / K5bp cluster (CTAs a slot, clusters the card holds): "
        f"{KD.pruned_tile_cluster(dev)}, "
        f"{KD.pruned_tile_cluster(dev, packed=True)}")
    shift, lterm = (int(v) for v in TD.prune_bound_consts(
        ds_profiles["default"]))
    for packed in (False, True):
        tes = KB.tile_edges(RWIIndex(), lambda idx, p_=packed: (
            TD.DeviceSegmentStore(idx, device=dev, packed_residency=p_)))
        sps = [tes.spans_for(th)[0] for th in KB.TILE_EDGE_TERMS]
        slots = [(sp.pbase if packed else sp.start, sp.count, sp.tstart,
                  sp.tcount, sp.stats["col_min"], sp.stats["col_max"],
                  sp.stats["tf_min"], sp.stats["tf_max"]) for sp in sps]
        dead_t, pmax_t = tes.arena.dead_array(), tes.arena._pmax
        for kk in (16, 128, 2048):
            if packed:
                desc = KP.pack_desc_bp(slots, [sp.pmeta for sp in sps],
                                       shift, lterm)
                pw_t = tes.arena.packed_array()
                forms = [("pruned_tile_bp",
                          KP.pruned_tile_bp(pw_t, dead_t, pmax_t, desc, kk,
                                            ds_consts["default"]),
                          KP.pruned_tile_bp_plain(pw_t, dead_t, pmax_t, desc,
                                                  kk, ds_consts["default"]))]
            else:
                desc = KD.pack_desc(slots, shift, lterm)
                ta_t = (*tes.arena.arrays(), dead_t, pmax_t)
                forms = [("pruned_tile",
                          KD.pruned_tile(*ta_t, desc, kk,
                                         ds_consts["default"], init),
                          KD.pruned_tile_plain(*ta_t, desc, kk,
                                               ds_consts["default"], init))
                         for init in (False, True)]
            torch.cuda.synchronize()
            for name, g, w in forms:
                note(name, f"tile edges kk={kk}", diff(g, w))
        del tes
    for n_ext in (1, 2, 8):
        ext = KB.edge_extents(edge, n_ext)
        st = KD.span_stats(ea[0], ea[2], ea[3], ext)
        note("span_stats", f"edges {n_ext} extents",
             stats_diff(st, KD.span_stats_plain(ea[0], ea[2], ea[3], ext)))
        rows_e = sum(c for _s, c in ext)
        for pname, c in ds_consts.items():
            for out_len in (rows_e, rows_e + 1000):
                g = KD.span_score(*ea[:4], ext, st, c, out_len)
                w = KD.span_score_plain(*ea[:4], ext, st, c, out_len)
                torch.cuda.synchronize()
                note("span_score", f"edges {n_ext} extents {pname} "
                     f"out_len={out_len}", diff(g, w))
    for ext in ([], KB.edge_extents(edge, 8)[3:5]):
        st = KD.span_stats(ea[0], ea[2], ea[3], ext)
        note("span_stats", f"no live row ({len(ext)} extents)",
             stats_diff(st, KD.span_stats_plain(ea[0], ea[2], ea[3], ext)))
        if int(st[KC.S_COL_MIN]) != KC.BIG:
            fail("span_stats: no live row must leave the identity")
    ext = KB.edge_extents(edge, 8)
    big = edge.spans_for(b"bigAAAAAAAAA")[0]
    st = KD.span_stats(ea[0], ea[2], ea[3], ext)
    for kk in (16, 1024, 4096):
        buf = KD.span_score(*ea[:4], ext, st, ds_consts["default"],
                            max(sum(c for _s, c in ext), kk))
        top_s, top_r, _ = KT.tie_topk(buf, kk)
        g = KD.topk_finish(top_s, top_r, ea[2], ext, stats=st)
        w = KD.topk_finish_plain(top_s, top_r, ea[2], ext, stats=st)
        torch.cuda.synchronize()
        note("topk_finish", f"edges scan kk={kk}", diff(g, w))
        for j0 in (0, 1, big.tcount):
            tail = (big.tstart, j0, big.tcount, *map(
                int, TD.prune_bound_consts(ds_profiles["default"])))
            g = KD.topk_finish(top_s, top_r, ea[2], ext, pmax=ea[4],
                               tail=tail)
            w = KD.topk_finish_plain(top_s, top_r, ea[2], ext, pmax=ea[4],
                                     tail=tail)
            torch.cuda.synchronize()
            note("topk_finish", f"edges tail kk={kk} j0={j0}", diff(g, w))
    # K6, K7 and topk_finish with a RAM delta block (span docids,
    # tombstoned ones, docids past the tombstone bitmap; below the first
    # bucket, 50,000 rows and past the last bucket) and a facet bitmap of
    # 4M bits admitting 30 % (docids past it too), with and without a
    # filter; then the batched scan pair and its finish over waves of 1,
    # 3 and 16 edge scans (1, 2 and 8 extents, five filters), each slot
    # also against the solo scan
    ext8 = KB.edge_extents(edge, 8)
    allow_e = convert.bitmap_from_numpy(KB.facet_bitmap(1 << 22, 0.3), dev)
    for n_d in (7, 50_000, 300_000):
        dl = convert.delta_from_numpy(*KB.edge_delta(edge, n_d), dev)
        for alw in (None, allow_e):
            for filt in (None, (P.pack_language("en"), 7, 5_000, 25_000)):
                kw = dict(filt=filt, delta=dl, allow=alw)
                lbl = (f"edges 8 extents, delta {n_d}, bitmap "
                       f"{alw is not None}, filter {filt is not None}")
                st = KD.span_stats(ea[0], ea[2], ea[3], ext8, flags=ea[1],
                                   **kw)
                note("span_stats", lbl, stats_diff(st, KD.span_stats_plain(
                    ea[0], ea[2], ea[3], ext8, flags=ea[1], **kw)))
                n_r = sum(c for _s, c in ext8) + dl[2].shape[0]
                g = KD.span_score(*ea[:4], ext8, st, ds_consts["default"],
                                  n_r + 7, **kw)
                w = KD.span_score_plain(*ea[:4], ext8, st,
                                        ds_consts["default"], n_r + 7, **kw)
                torch.cuda.synchronize()
                note("span_score", lbl, diff(g, w))
                for kk in (16, 1024):
                    top_s, top_r, _ = KT.tie_topk(g, kk)
                    gf = KD.topk_finish(top_s, top_r, ea[2], ext8, stats=st,
                                        delta_docids=dl[2])
                    wf = KD.topk_finish_plain(top_s, top_r, ea[2], ext8,
                                              stats=st, delta_docids=dl[2])
                    torch.cuda.synchronize()
                    note("topk_finish", f"{lbl}, kk={kk}", diff(gf, wf))
    ea_cpu = tuple(t.cpu() for t in ea)
    for bs in (1, 3, 16):
        scans = KB.scan_wave(edge, bs)
        desc = KD.scan_batch_desc(scans)
        for pname, c in ds_consts.items():
            st = KD.span_stats_batch(ea[0], ea[1], ea[2], ea[3], desc)
            pst = KD.span_stats_batch_plain(ea[0], ea[1], ea[2], ea[3], desc)
            note("span_stats_batch", f"edges wave of {bs} ({pname})",
                 max(stats_diff(st[i], pst[i]) for i in range(bs)))
            for kk in (16, 1024) + ((4096, 8192) if bs == 16 else ()):
                g = KD.span_topk_batch(*ea[:4], desc, st, c, kk)
                w = KD.span_topk_batch_plain(*ea[:4], desc, pst, c, kk)
                torch.cuda.synchronize()
                note("span_topk_batch", f"edges wave of {bs} ({pname}), "
                     f"kk={kk}", diff(g, w))
                whole = TD.scan_batch_query(ea, scans, c, kk)
                solo = torch.stack([TD.scan_query(ea, e, c, kk, f)[:2 * kk]
                                    for e, f in scans])
                cpu = TD.scan_batch_query(ea_cpu, scans, c.cpu(), kk)
                torch.cuda.synchronize()
                e_w = max(diff(whole, solo), diff(whole.cpu(), cpu))
                log(f"check batched scan = solo scan = CPU, edges wave of "
                    f"{bs} ({pname}), kk={kk}: err {e_w}")
                if e_w:
                    fail("the batched scan differs from the solo scan")
    del edge, _edge_idx, ea, ea_cpu, allow_e

    # K8 on the join edge store (kernels/bench.join_edges; each case's
    # partner modes as the store chose them), every output twice, and K6
    # and K7 under each filter over 1 and 3 of its extents (random
    # languages, lastmods and flags), K7 on K6's statistics and on a copy
    # of the plain ones, as a filtered-stats cache hit hands them in
    jstore, _jidx = KB.join_edges(dev)
    ja = (*jstore.arena.arrays(), jstore.arena.dead_array())
    jt = (*jstore.arena.join_arrays(), jstore.arena.bitmap_array())
    for label, rare, parts, n_inc, filt in KB.join_edge_cases(jstore):
        w = KD.join_member_plain(*ja, rare.start, rare.count, *jt, parts,
                                 n_inc, filt)
        for rep in range(2):
            g = KD.join_member(*ja, rare.start, rare.count, *jt, parts,
                               n_inc, filt)
            torch.cuda.synchronize()
            note("join_member", f"edges, {label} ({int(w[2].sum())} of "
                 f"{rare.count} rows valid, modes "
                 f"{['bitmap' if p[2] >= 0 else 'sort' for p in parts]}) "
                 f"call {rep + 1}", max(diff(a, b) for a, b in zip(g, w)))

    def check_join_wave(label, arr, jtab, desc, n_inc, cs, kks):
        """A join wave's batched K8, kernel 1 and kernel 2 against their
        plain versions over each slot's rows (kernel 2 under each consts
        of `cs`), then join_batch_query's slots against the solo
        join_query's after the keep mask (kk of `kks`)"""
        off = KD.join_wave_offsets(desc)
        bs = desc.shape[0]

        def rows_of(t):
            return KD.wave_rows(t, desc, off)
        g = KD.join_member_batch(*arr[:4], *jtab, desc, n_inc, off)
        w = KD.join_member_batch_plain(*arr[:4], *jtab, desc, n_inc, off)
        torch.cuda.synchronize()
        nvalid = int(rows_of(w[2]).sum())
        note("join_member_batch", f"{label} ({bs} slots, {nvalid} of "
             f"{int(desc[:, 1].sum())} rows valid)",
             max(diff(rows_of(a), rows_of(b)) for a, b in zip(g, w)))
        del g
        st = KD.join_stats_batch(w[0], w[2], desc, off)
        pst = KD.join_stats_batch_plain(w[0], w[2], desc, off)
        note("join_stats_batch", label,
             max(stats_diff(st[i], pst[i]) for i in range(bs)))
        for c in cs:
            sc = KD.join_score_batch(*w, desc, off, pst, c)
            psc = KD.join_score_batch_plain(*w, desc, off, pst, c)
            torch.cuda.synchronize()
            note("join_score_batch", label, diff(rows_of(sc), rows_of(psc)))
            del sc, psc
            for kk_ in kks:
                whole = TD.join_batch_query(arr, jtab, desc, n_inc, c,
                                            kk_).cpu().numpy()
                e_w = 0
                for i, (start, count, filt, parts) in enumerate(
                        KD.join_wave_slots(desc, n_inc)):
                    s_, d_ = whole[i, :kk_], whole[i, kk_:]
                    keep = (d_ >= 0) & (s_ > TD.NEG_INF32)
                    if not count:
                        e_w = max(e_w, int(keep.sum()))
                        continue
                    solo = TD.join_query(arr, jtab, start, count, parts,
                                         n_inc, c, kk_, filt).cpu().numpy()
                    n_ = min(kk_, count)
                    sk = (solo[n_:2 * n_] >= 0) & (solo[:n_] > TD.NEG_INF32)
                    if not (np.array_equal(s_[keep], solo[:n_][sk])
                            and np.array_equal(d_[keep], solo[n_:2 * n_][sk])):
                        e_w = 1
                log(f"check join_batch_query = solo join_query, {label}, "
                    f"kk={kk_}: err {e_w}")
                if e_w:
                    fail(f"the batched join differs from the solo join "
                         f"({label}, kk={kk_})")
        del w, st, pst

    # the batched join's kernels on the same store (kernels/bench.
    # join_edge_waves: 16 bitmap slots, mixed modes, the clip rows in
    # every slot as partner and as exclude, five partners and six
    # excludes; every filter, a slot of no row and one of 100 rows)
    for label, desc, n_inc in KB.join_edge_waves(jstore):
        check_join_wave(f"edges, {label}",
                        (*ja, jstore.arena._pmax), jt, desc, n_inc,
                        list(ds_consts.values()), (16, 1024))
    jsp = [jstore.spans_for(th)[0] for th in KB.JOIN_EDGE_TERMS]
    for name, filt in KB.JOIN_EDGE_FILTERS.items():
        for ext in ([(jsp[1].start, jsp[1].count)],
                    [(jsp[0].start + 5, 70_001), (jsp[1].start, jsp[1].count),
                     (jsp[5].start, jsp[5].count)]):
            st = KD.span_stats(ja[0], ja[2], ja[3], ext, flags=ja[1],
                               filt=filt)
            pst = KD.span_stats_plain(ja[0], ja[2], ja[3], ext, flags=ja[1],
                                      filt=filt)
            note("span_stats", f"filter {name}, {len(ext)} extents",
                 stats_diff(st, pst))
            rows_j = sum(c for _s, c in ext)
            for pname, c in ds_consts.items():
                for slabel, stx in (("K6's", st), ("cached", pst.clone())):
                    g = KD.span_score(*ja, ext, stx, c, rows_j + 7, filt=filt)
                    w = KD.span_score_plain(*ja, ext, stx, c, rows_j + 7,
                                            filt=filt)
                    torch.cuda.synchronize()
                    note("span_score", f"filter {name}, {len(ext)} extents, "
                         f"{pname}, {slabel} statistics", diff(g, w))
    # K7's docid column (the mesh store's per-cell scan) under each filter
    # over 2 extents, and K18 `xjoin` (its cross-row join) over the
    # store's rare span: each case's probes term by term (each taking the
    # earlier terms' outputs, kernels/bench.xjoin_edge_cases), then the
    # apply, unfiltered and under all four filters
    for name, filt in KB.JOIN_EDGE_FILTERS.items():
        ext = [(jsp[0].start + 5, 70_001), (jsp[1].start, jsp[1].count)]
        pst = KD.span_stats_plain(ja[0], ja[2], ja[3], ext, flags=ja[1],
                                  filt=filt)
        rows_j = sum(c for _s, c in ext)
        g = KD.span_score(*ja, ext, pst, ds_consts["default"], rows_j + 7,
                          filt=filt, with_docids=True)
        w = KD.span_score_plain(*ja, ext, pst, ds_consts["default"],
                                rows_j + 7, filt, None, None, True)
        torch.cuda.synchronize()
        note("span_score_docids", f"filter {name}, 2 extents",
             max(diff(a, b) for a, b in zip(g, w)))
    for label, rare, wins, n_inc in KB.xjoin_edge_cases(jstore):
        jd_, jp_ = KB.xjoin_table(jstore, wins)
        cand = ja[2][rare.start:rare.start + rare.count]
        contrib = torch.empty((len(wins), KD.XJOIN_ROWS, rare.count),
                              dtype=torch.int32, device=dev)
        for j_, (lo, cnt) in enumerate(wins):
            prior = contrib[:j_] if j_ else None
            g = KD.xjoin_probe(cand, ja[3], prior, n_inc, jd_, jp_, lo, cnt,
                               ja[0], ja[1])
            w = KD.xjoin_probe_plain(cand, ja[3], prior, n_inc, jd_, jp_, lo,
                                     cnt, ja[0], ja[1])
            torch.cuda.synchronize()
            note("xjoin_probe", f"edges, {label}, term {j_ + 1} "
                 f"({int(w[0].sum())} of {rare.count} found)", diff(g, w))
            contrib[j_].copy_(w)
        for filt in (None, KB.JOIN_EDGE_FILTERS["all four"]):
            g = KD.xjoin_apply(*ja, rare.start, rare.count, contrib, n_inc,
                               filt)
            w = KD.xjoin_apply_plain(*ja, rare.start, rare.count, contrib,
                                     n_inc, filt)
            torch.cuda.synchronize()
            note("xjoin_apply", f"edges, {label}, "
                 f"{'all four filters' if filt else 'no filter'} "
                 f"({int(w[2].sum())} of {rare.count} valid)",
                 max(diff(a, b) for a, b in zip(g, w)))
    del jstore, _jidx, ja, jt

    # the dense rerank's kernels against their plain versions on a forward
    # index of 65,536 unit rows (every 97th a copy of row 5: equal boosts):
    # K9's gather mode and K10 over waves at nb = 16, 128, 1024 (bs = 16),
    # 128 (bs = 1 and 20) and 16,384 (bs = 2, the shared-memory limit),
    # ragged slots, pad slots and pad lanes, docids -1 and past the rows,
    # alpha 0, 0.5 and 1; K9's block mode over 1,000 f16 rows; its
    # similarity mode for 1, 16 and 33 queries (two passes) and K11 on
    # those similarities with a slot of no valid lane
    drng = np.random.default_rng(KB.SEED + 60)
    fcap = 1 << 16
    fwd_s = KB.unit_vectors(fcap, drng)
    fwd_s[::97] = fwd_s[5]
    fwd_sd = put(fwd_s)
    for bs_, nb_ in ((16, 16), (16, 128), (16, 1024), (1, 128), (20, 128),
                     (2, 16384)):
        for alpha in (0.0, 0.5, 1.0):
            ns = drng.integers(0, nb_ + 1, bs_)
            ns[0] = nb_
            ns[1::5] = 0
            qi, nb_w, _sl = KB.rerank_wave(drng, fcap, ns, nb_, alpha)
            qd = KDn.upload_desc(qi, dev)
            fin = KDn.dense_gather_boost(fwd_sd, qd, nb_w)
            note("dense_dot", f"gather bs={bs_} nb={nb_} alpha={alpha}",
                 diff(fin, KDn.dense_gather_boost_plain(fwd_sd, qd, nb_w)))
            srt = KDn.rerank_sort(fin, qd, nb_w)
            note("rerank_sort", f"bs={bs_} nb={nb_} alpha={alpha}",
                 diff(srt, KDn.rerank_sort_plain(fin, qd, nb_w)))
    blk = fwd_sd[:1000]
    qv = put(KB.unit_vectors(1, drng, dtype=np.float32)[0])
    spv = put(drng.integers(0, 1 << 20, 1000).astype(np.int32))
    vv = put(drng.random(1000) < 0.9)
    note("dense_dot", "block of 1000 rows",
         diff(KDn.dense_rows_boost(blk, qv, spv, vv, 0.5),
              KDn.dense_rows_boost_plain(blk, qv, spv, vv, 0.5)))
    for nq in (1, 16, 33, 40):
        qs = put(KB.unit_vectors(nq, drng, dtype=np.float32))
        sims = KDn.dense_sims(fwd_sd, qs)
        note("dense_dot", f"similarities of {nq} queries",
             diff(sims, KDn.dense_sims_plain(fwd_sd, qs)))
        rg = fwd_sd[:fcap - 5]          # a ragged last tile
        note("dense_dot", f"similarities of {nq} queries, {fcap - 5} rows",
             diff(KDn.dense_sims(rg, qs), KDn.dense_sims_plain(rg, qs)))
        spf = put(drng.integers(0, 1000, (nq, fcap)).astype(np.float32))
        vf = put(drng.random((nq, fcap)) < 0.9)
        vf[0] = False
        for alpha in (0.0, 0.5):
            note("hybrid_blend", f"{nq} slots alpha={alpha}",
                 diff(KDn.hybrid_blend(sims, spf, vf, alpha),
                      KDn.hybrid_blend_plain(sims, spf, vf, alpha)))
    del fwd_s, fwd_sd, sims, rg

    # K17 `power_iterate` on the card against its plain version on the CPU
    # (exact there: index_add_ adds in index order): the ranks to the bit
    # and the same trip count. Uniform edge lists (one host; 31 and 33
    # hosts, no window and two; n of no block's multiple; a dangling mass
    # over several tree levels), a 50,000-in-edge hub, only dangling
    # hosts, damping 0.5, and the realistic graph (kernels/bench.host_graph:
    # 1,000,000 hosts, about 5M edges), whose plain answer phase 3 reuses
    def k17_check(label, g, damping=BRo.DAMPING):
        n_ = len(g[3])
        cpu_ = [torch.from_numpy(np.ascontiguousarray(a)) for a in g]
        want, want_steps = KBr.power_iterate_plain(*cpu_, damping, n_)
        got, got_steps = KBr.power_iterate(*(a.to(dev) for a in cpu_),
                                           damping, n_)
        torch.cuda.synchronize()
        if got_steps != want_steps:
            fail(f"power_iterate {label}: {got_steps} steps, the plain "
                 f"version {want_steps}")
        note("power_iterate", f"{label}, {got_steps} steps",
             diff(got.cpu(), want))
        return want, want_steps

    for n_, e_, hub_, dmp in ((1, 1, 0, 0.85), (31, 100, 0, 0.85),
                              (33, 40, 0, 0.5), (1000, 7000, 0, 0.85),
                              (300_001, 3_000_000, 0, 0.85),
                              (100_003, 300_000, 50_000, 0.85),
                              (70_001, 0, 0, 0.85)):
        k17_check(f"{n_} hosts, {e_} edges + a hub of {hub_}, damping "
                  f"{dmp}", KB.edge_list(n_, e_, KB.SEED + n_, hub_), dmp)
    # the work tiers at their edges, a graph that stops after one step and
    # one that runs all 50 (kernels/bench.k17_graphs)
    for label_, g_, dmp_, steps_ in KB.k17_graphs(KBr.HUB_MIN):
        got_ = k17_check(label_, g_, dmp_)[1]
        if steps_ is not None and got_ != steps_:
            fail(f"power_iterate {label_}: {got_} steps, not {steps_}")
    tq = time.time()
    hg = KB.host_graph()
    hg_want, hg_steps = k17_check(
        f"realistic graph, {len(hg[3])} hosts, {len(hg[0])} edges", hg)
    log(f"K17 realistic graph: made and checked in {time.time() - tq:.1f} s"
        f", {hg_steps} steps, max in-degree "
        f"{int(np.bincount(hg[1], minlength=len(hg[3])).max())}, "
        f"{int(hg[3].sum())} dangling hosts")

    # K4 batched (the mesh store's pruned waves) over 4 cells' runs in
    # K5's order (kernels/bench.pruned_runs: random, all tied, two cells
    # without the term) at bs 1 and 8, kk 16 and 2048, with the ok pmin
    # and whole; K16's halves over a 1M x 4 block split over 2 x 2 cells
    # (each half's sums, their total, each cell's rows over its 2 columns)
    mrng = np.random.default_rng(KB.SEED + 120)
    for bs_ in (1, 8):
        for kk_ in (16, 2048):
            for case in ("random", "tied", "empty"):
                gb = KB.pruned_runs(bs_, 4, kk_, mrng, tied=case == "tied",
                                    empty=(0, 3) if case == "empty" else ())
                gbd = gb.to(dev)
                for k_, ok_ in ((kk_, 2 * kk_), (4 * kk_, None)):
                    g = KT.gather_topk_batch(gbd, kk_, k_, False, kk_, ok_)
                    w = KT.gather_topk_batch_plain(gb, kk_, k_, False, kk_,
                                                   ok_)
                    note("gather_topk_batch", f"{bs_} slots of 4 runs of "
                         f"{kk_}, {case}, k={k_}", diff(g.cpu(), w))
    nb_, tb_ = 1_000_000, 4
    tf_ = mrng.integers(0, 9, (nb_, tb_)).astype(np.float32)
    dl_ = mrng.integers(40, 800, nb_).astype(np.int32)
    df_ = mrng.integers(1, nb_, tb_).astype(np.int32)
    v_ = mrng.random(nb_) < 0.9
    halves = np.array_split(np.arange(nb_), 2)
    t_ = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    accs = []
    for i, r_ in enumerate(halves):
        accs.append(R.bm25_sums(put(dl_[r_]), put(v_[r_])))
        note("bm25_sums", f"doc column {i} of 2, {len(r_)} rows",
             diff(accs[-1].cpu(), R.bm25_sums_plain(t_(dl_[r_]),
                                                    t_(v_[r_]))))
    acc_ = accs[0] + accs[1]
    for i, r_ in enumerate(halves):
        for cols in (slice(0, 2), slice(2, 4)):
            g = R.bm25_rows(put(tf_[r_][:, cols]), put(dl_[r_]),
                            put(df_[cols]), nb_, put(v_[r_]), acc_)
            w = R.bm25_rows_plain(t_(tf_[r_][:, cols]), t_(dl_[r_]),
                                  t_(df_[cols]), nb_, t_(v_[r_]), acc_.cpu())
            note("bm25_rows", f"doc column {i}, columns {cols.start}-"
                 f"{cols.stop - 1}", diff(g.cpu(), w))
    del tf_, dl_, df_, v_, gb, gbd

    log(f"phase 2: done at {time.time() - t0:.1f} s")
    # -- phase 3: the main path ---------------------------------------------
    ref_scores = {}
    for pname, prof in profiles.items():
        ref_scores[pname] = R.cardinal_scores_host(
            feats, prof, "en", hostids if prof.authority > 12 else None)
    best_d = {}

    def ref_topk(pname, k, rows=None):
        s = ref_scores[pname] if rows is None else ref_scores[pname][rows]
        d = docids if rows is None else docids[rows]
        order = np.lexsort((d, -s))[:k]
        return s[order], d[order]

    def expect(name, got_s, got_d, want_s, want_d):
        if not (np.array_equal(got_s, want_s)
                and np.array_equal(got_d, want_d)):
            fail(f"{name}: result differs from the numpy twin")

    plist = P.PostingsList(docids, feats)
    torch.cuda.synchronize()
    reset_launches()
    tm = time.time()
    walls = {}

    # CardinalRanker.rank (the host branch's device dispatch)
    for pname, k in (("default", 10), ("authority15", 100)):
        r = R.CardinalRanker(profiles[pname], "en")
        tq = time.time()
        s, d = r.rank(plist, hostids if pname == "authority15" else None,
                      k=k)
        walls[f"CardinalRanker.rank {pname} k={k}"] = time.time() - tq
        expect(f"CardinalRanker.rank {pname}", s, d, *ref_topk(pname, k))
        best_d[pname] = d

    # MeshRanker: place once, then 50 queries
    mesh = M.make_mesh()
    mr = M.MeshRanker(mesh, profiles["authority15"])
    tq = time.time()
    placed = mr.place(plist, hostids)
    torch.cuda.synchronize()
    walls["MeshRanker.place"] = time.time() - tq
    tq = time.time()
    for q in range(50):
        s, d = mr.rank_placed(placed, k=10 if q % 2 else 100)
    walls["MeshRanker.rank_placed x50"] = time.time() - tq
    expect("MeshRanker.rank_placed", s, d, *ref_topk("authority15", 10))

    # MeshBM25 at 1M docs x 4 terms
    nb, t = 1_000_000, 4
    tf = rng.integers(0, 9, (nb, t)).astype(np.float32)
    dl = rng.integers(40, 800, nb).astype(np.int32)
    df = rng.integers(1, nb, t).astype(np.int32)
    bd = np.arange(nb, dtype=np.int32)
    tq = time.time()
    bs, bdd = M.MeshBM25(mesh).topk(tf, dl, df, nb, bd, k=100)
    walls["MeshBM25.topk 1Mx4 k=100"] = time.time() - tq
    bm_in = (tf, dl, df, nb, bd)     # K16's inputs, timed in phase 4
    ref = R.bm25_scores_np(tf, dl, df, nb)
    order = np.argsort(-ref, kind="stable")[:100]
    if bs.shape != (100,) or not np.isfinite(bs).all():
        fail("MeshBM25: wrong shape or non-finite scores")
    if not np.allclose(bs, ref[order], rtol=1e-5):
        fail("MeshBM25: scores differ from the float64 oracle")
    # docids must agree wherever a score is apart from both neighbours
    gap = np.abs(np.diff(ref[order])) > 1e-4 * np.abs(ref[order][1:])
    sep = np.ones(100, bool)
    sep[1:] &= gap
    sep[:-1] &= gap
    if not np.array_equal(bdd[sep], order[sep]):
        fail("MeshBM25: docids differ from the oracle where scores differ")
    bm_ref = (bs, bdd, sep)          # the mesh path's 2 x 2 MeshBM25

    # stream_score_topk over the 10M block in 2M chunks
    tq = time.time()
    ss, sd = S.stream_score_topk(feats16, flags, docids, hostids,
                                 consts["default"], k=100, chunk=CHUNK)
    walls["stream_score_topk 10M/2M k=100"] = time.time() - tq
    expect("stream_score_topk", ss, sd, *ref_topk("default", 100))

    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"main path: {time.time() - tm:.1f} s; launches {launches}")
    for name, w in walls.items():
        log(f"  wall {name}: {w * 1e3:.2f} ms")
    missing = [k for k in PLACED_KERNELS if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    # -- phase 3, the device store's path: DeviceSegmentStore.rank_term ----
    # a port RWIIndex whose one run holds the 10M-posting term and terms
    # of 1M, 100k and 20k postings; a store on the card and its twin on
    # the CPU (the plain versions) fed by one listener. Every answer must
    # equal the twin's and the numpy oracle's (kernels/bench.
    # devstore_oracle: all rows scored against their statistics, ranked
    # by score then arena position)
    hl = b"headlineAAAA"
    ds_terms = {hl: (feats, docids)}
    for i, n_t in enumerate(DS_TERMS):
        f_t, d_t, _h, _r = KB.make_term(n_t, KB.SEED + 1 + i)
        ds_terms[b"term%08d" % n_t] = (f_t, d_t)
    jrng = np.random.default_rng(KB.SEED + 20)
    for i, (th, (n_t, hi)) in enumerate(JOIN_TERMS.items()):
        f_t, _d, _h, _r = KB.make_term(n_t, KB.SEED + 21 + i)
        ds_terms[th] = (f_t, KB.draw_docids(n_t, hi, jrng))
    idx = RWIIndex()
    for th, (f_t, d_t) in ds_terms.items():
        idx.add_many(th, P.PostingsList(d_t, f_t))
    tq = time.time()
    idx.flush()
    ds_walls = {"flush (host)": time.time() - tq}
    # the twin packs in a thread of its own while the card store packs:
    # both walls read with the other pack beside them (the twin's 33 s
    # alone went to make room for the mesh path)
    tq = time.time()
    twin_box = {}

    def pack_twin():
        twin_box["hs"] = TD.DeviceSegmentStore(idx, device="cpu")
        twin_box["wall"] = time.time() - tq
    tw_th = threading.Thread(target=pack_twin)
    tw_th.start()
    gs = TD.DeviceSegmentStore(idx, device=dev)
    torch.cuda.synchronize()
    ds_walls["pack, store on the card (the twin beside it)"] = \
        time.time() - tq
    tw_th.join()
    if "hs" not in twin_box:
        fail("the twin's pack raised")
    hs = twin_box["hs"]
    ds_walls["pack, twin on the CPU (beside the card's)"] = twin_box["wall"]
    idx.listener = KB.Fanout(gs, hs)
    sp_hl = gs.spans_for(hl)[0]
    log(f"devstore: {gs.arena.used_rows} rows packed, the 10M term in "
        f"{sp_hl.tcount} tiles; " + ", ".join(
            f"{k} {v:.1f} s" for k, v in ds_walls.items()))
    hl_rows = KB.arena_rows(feats, docids)
    # the 10M term's queries are held to the CPU twin alone (its numpy
    # oracles, 60-70 s of the host, went to make room for the mesh path;
    # the smaller terms' and the bitmap's, delta's and joins' stay)
    ended, ends = {}, {}

    # -- phase 3, the device store's join path: DeviceSegmentStore.rank_join
    # K8 first at a rare span of MAX_JOIN_ROWS rows of the headline term's
    # extent against joinA (bitmap) and joinB (sort), beside its plain
    # version (not counted); then, counts reset, the conjunctions and the
    # filtered single-term queries on the card and on the twin, each
    # equal to the numpy oracle
    jA, jB, jC = JOIN_TERMS
    t1m = b"term%08d" % DS_TERMS[0]
    nslots = gs.arena.bitmap_array().shape[0]
    modes = {}
    for th in [hl, t1m, *JOIN_TERMS]:
        sp_t = gs.spans_for(th)[0]
        modes[th] = ("bitmap" if 0 <= sp_t.jslot < nslots else "sort",
                     sp_t.count)
    log("join partner modes as the store chose them: " + ", ".join(
        f"{th.decode()} {m} ({n} rows)" for th, (m, n) in modes.items()))
    if not any(m == "bitmap" and n >= 1_000_000 for m, n in modes.values()) \
            or not any(m == "sort" and n >= 1_000_000
                       for m, n in modes.values()):
        fail("both membership modes must occur at >= 1M partner rows")
    garr = (*gs.arena.arrays(), gs.arena.dead_array())
    gjoin = (*gs.arena.join_arrays(), gs.arena.bitmap_array())

    def jpart(th):
        sp_t = gs.spans_for(th)[0]
        return (sp_t.jstart, sp_t.count,
                sp_t.jslot if 0 <= sp_t.jslot < nslots else -1)
    nmax = TD.DeviceSegmentStore.MAX_JOIN_ROWS
    for label, parts, n_inc in (
            ("joinA (bitmap), joinB (sort)", [jpart(jA), jpart(jB)], 2),
            ("joinC (sort), exclude term1000000 (bitmap)",
             [jpart(jC), jpart(t1m)], 1)):
        g = KD.join_member(*garr, sp_hl.start, nmax, *gjoin, parts, n_inc)
        w = KD.join_member_plain(*garr, sp_hl.start, nmax, *gjoin, parts,
                                 n_inc)
        torch.cuda.synchronize()
        note("join_member", f"a rare span of MAX_JOIN_ROWS = {nmax} rows "
             f"of the headline extent, {label} ({int(w[2].sum())} valid)",
             max(diff(a, b) for a, b in zip(g, w)))
    del g, w
    # the batched join's kernels at the store's shapes (not counted): 16
    # bitmap slots of joinA & headline under the filters in turn (none,
    # lang en, flag bit 5, days 8000-24000), 4 slots of term1000000's
    # span against joinB (a sort-mode partner), and 4 slots of
    # term1000000 & headline excluding joinB
    en_ = P.pack_language("en")
    wave_filts = [None, (en_, TD.NO_FLAG, TD.DAYS_NONE_LO, TD.DAYS_NONE_HI),
                  (TD.NO_LANG, 5, TD.DAYS_NONE_LO, TD.DAYS_NONE_HI),
                  (TD.NO_LANG, TD.NO_FLAG, 8_000, 24_000)]
    sp_a, sp_1m = gs.spans_for(jA)[0], gs.spans_for(t1m)[0]

    def wave_of(bs, sp_r, parts, n_inc):
        return KD.join_wave_desc(
            [(sp_r.start, sp_r.count, wave_filts[i % 4], parts)
             for i in range(bs)], n_inc, len(parts) - n_inc)
    big_waves = {
        "16 bitmap slots of joinA & headline": (
            wave_of(16, sp_a, [jpart(hl)], 1), 1),
        "4 sort slots of term1000000 & joinB": (
            wave_of(4, sp_1m, [jpart(jB)], 1), 1),
        "4 slots of term1000000 & headline & -joinB": (
            wave_of(4, sp_1m, [jpart(hl), jpart(jB)], 1), 1)}
    garr5 = (*garr, gs.arena._pmax)
    for label, (desc, n_inc) in big_waves.items():
        check_join_wave(label, garr5, gjoin, desc, n_inc,
                        [ds_consts["default"]], (128,))
    join_rows = {th: hl_rows if th == hl else KB.arena_rows(*ds_terms[th])
                 for th in (hl, t1m, *JOIN_TERMS)}
    dead_docs: set[int] = set()
    de, en = P.pack_language("de"), P.pack_language("en")
    jfilt = (de, TD.NO_FLAG, 8_000, 24_000)
    filt_kw = dict(lang_filter=de, from_days=8_000, to_days=24_000)
    hfilt = (en, 5, 3_000, 27_000)         # the filtered rank_term's
    hfilt_kw = dict(lang_filter=en, flag_bit=5, from_days=3_000,
                    to_days=27_000)

    def filtered(parts, filt):
        """Rows of (feats16, flags, docids) parts that pass `filt`."""
        out = []
        for f_p, fl_p, d_p in parts:
            ok = KD.constraint_valid(torch.from_numpy(f_p),
                                     torch.from_numpy(fl_p), filt).numpy()
            out.append((f_p[ok], fl_p[ok], d_p[ok]))
        return out
    join_walls = {}

    def clean(label, *stores):
        """No hidden fallback: outside the device-loss phase no fetch
        failed, was retried or declared the device lost."""
        for s_ in stores:
            c_ = s_.counters()
            bad = {k: c_[k] for k in LOSS_COUNTERS if c_[k]}
            if bad:
                fail(f"{label}: {bad} (a fetch failed behind the checks)")

    def same(label, got, twin, want):
        if got is None or twin is None:
            fail(f"{label}: no answer")
        if not (np.array_equal(got[0], twin[0])
                and np.array_equal(got[1], twin[1]) and got[2] == twin[2]):
            fail(f"{label}: the card and the CPU twin differ")
        if want is None:        # held to the twin alone
            return
        expect(label, got[0], got[1], want[0], want[1])
        if len(want) > 2 and got[2] != want[2]:
            fail(f"{label}: considered {got[2]}, the oracle {want[2]}")

    def join_q(label, inc, exc, k=100, filt=None, oracle=True, **kw):
        tq = time.perf_counter()
        got = gs.rank_join(inc, exc, ds_profiles["default"], k=k, **kw)
        wall = (time.perf_counter() - tq) * 1e3
        tq = time.time()
        twin = hs.rank_join(inc, exc, ds_profiles["default"], k=k, **kw)
        t_twin = time.time() - tq
        tq = time.time()
        want = KB.devjoin_oracle(join_rows, inc, exc, dead_docs,
                                 ds_profiles["default"], k,
                                 filt or KD.NO_FILTER) if oracle else None
        same(f"rank_join {label}", got, twin, want)
        log(f"  rank_join {label}: {len(got[1])} answers of "
            f"{got[2]} rare rows, first wall {wall:.3f} ms (the twin "
            f"{t_twin:.1f} s, the oracle {time.time() - tq:.1f} s)")
        return got

    torch.cuda.synchronize()
    reset_launches()
    tm = time.time()
    join_q("joinA & headline", [jA, hl], [], oracle=False)
    # four conjunctions held to the twin alone (their numpy oracles,
    # 16 s, went to make room for the BlockRank path, joinA & headline's,
    # 7.5 s, for the mesh path)
    join_q("joinA & headline & term1000000", [jA, hl, t1m], [], k=10,
           oracle=False)
    join_q("term1000000 & headline & -joinB", [t1m, hl], [jB],
           oracle=False)
    join_q("joinA & joinB", [jA, jB], [], k=1000)
    join_q("term1000000 & joinC (sort partner)", [t1m, jC], [])
    join_q("joinA & headline, lang de, days 8000-24000", [jA, hl], [],
           filt=jfilt, oracle=False, **filt_kw)
    # every exclude names a term with no postings: rank_term serves it
    nowhere = b"nowhereAAAAA"
    got = gs.rank_join([jB], [nowhere], ds_profiles["default"], k=10)
    twin = hs.rank_join([jB], [nowhere], ds_profiles["default"], k=10)
    same("rank_join joinB & -nowhere (plain)", got, twin,
         KB.devstore_oracle([join_rows[jB]], ds_profiles["default"], 10))
    # filtered rank_term on the headline term: cold, then from the cache
    k6_0 = LAUNCHES["span_stats"]
    want_f = None        # held to the twin alone (the oracle: 9 s)
    for label in ("cold", "filtered-stats cache hit"):
        got = gs.rank_term(hl, ds_profiles["default"], k=100, **hfilt_kw)
        twin = hs.rank_term(hl, ds_profiles["default"], k=100, **hfilt_kw)
        same(f"filtered rank_term {label}", got, twin, want_f)
    if LAUNCHES["span_stats"] != k6_0 + 1:
        fail("the filtered-stats cache hit ran K6")
    # the join path's counts (the RAM-delta decline below launches
    # nothing) and counters, before the batched joins
    torch.cuda.synchronize()
    launches_join = dict(LAUNCHES)
    t_join = time.time() - tm
    jc = lambda s_: (s_.join_served, s_.join_fallbacks,  # noqa: E731
                     s_.join_degraded_plain, s_.queries_served,
                     s_.stream_scans, s_.fallbacks)
    jc0 = (jc(gs), jc(hs))

    # -- phase 3, the batched joins: rank_join through the batcher --------
    # the join path's six conjunctions (the last without its language
    # filter) x 2 profiles x k 10 / 100 x {no filter, lang en}, each sent
    # JOIN_MIX_REPEATS times one at a time and from 16 threads without the
    # batcher, then from 16 threads through it (enable_batching(16, 8));
    # and one group (joinA & headline, the default profile, lang en, k =
    # 100) JOIN_ONE_GROUP times the same three ways, whose launches
    # through the batcher must average more than one live slot. Through
    # the batcher each mix is sent once untimed first: each dispatcher's
    # stream allocates its waves' buffers (up to 4.7 GB a 16-slot wave of
    # joinA's rows) on its first waves, which the timed run then reuses
    # from the caching allocator. Every
    # answer equal to its reference, taken once for each distinct query
    # at k = 100 (the answer at k = 10 is its first 10): the CPU twin's
    # under the default profile without a filter, the card's solo answer
    # otherwise (the same kernels; the twin's 24 answers took 41 s).
    # Counts reset before, read after
    torch.cuda.synchronize()
    reset_launches()
    tb = time.time()
    jprofs = {"default": ds_profiles["default"],
              "light": R.RankingProfile(domlength=8, tf=5)}
    jshapes = {b"joinA & headline": ([jA, hl], [], {}),
               b"joinA & headline & term1000000": ([jA, hl, t1m], [], {}),
               b"term1000000 & headline & -joinB": ([t1m, hl], [jB], {}),
               b"joinA & joinB": ([jA, jB], [], {}),
               b"term1000000 & joinC": ([t1m, jC], [], {}),
               b"joinA & headline, days 8000-24000": (
                   [jA, hl], [], dict(from_days=8_000, to_days=24_000))}
    jlangs = {"none": {}, "en": dict(lang_filter=en)}

    def jask(store, q, k=None):
        inc, exc, kw = jshapes[q[0]]
        return store.rank_join(inc, exc, jprofs[q[1]], k=k or q[3],
                               **kw, **jlangs[q[2]])
    jqs = [(name, pn, lf, k) for name in jshapes for pn in jprofs
           for lf in jlangs for k in (10, 100)]
    tq = time.time()
    twin100 = {q[:3]: jask(hs if q[1:3] == ("default", "none") else gs, q)
               for q in jqs if q[3] == 100}
    if any(a is None for a in twin100.values()):
        fail("a batched join's reference answer declined")
    jrefs = {q: (twin100[q[:3]] if q[3] == 100 else
                 (twin100[q[:3]][0][:10], twin100[q[:3]][1][:10],
                  twin100[q[:3]][2])) for q in jqs}
    log(f"batched joins: the references of {len(twin100)} queries (the "
        f"twin's {len(twin100) // 4}) {time.time() - tq:.1f} s")
    one_group = (b"joinA & headline", "default", "en", 100)
    jmixes = {"joins": [q for _ in range(JOIN_MIX_REPEATS) for q in jqs],
              "joins, one group": [one_group] * JOIN_ONE_GROUP}
    jfn = lambda q: jask(gs, q)  # noqa: E731
    jstats, jwaves = {}, {}
    for mname, stream in jmixes.items():
        for mode, threads in (("one at a time, no batcher", 1),
                              (f"{MIX_THREADS} threads, no batcher",
                               MIX_THREADS)):
            ans, st_ = run_mix(stream, jfn, threads)
            check_mix(mname, ans, jrefs)
            jstats[(mname, mode)] = st_
    gs.enable_batching(max_batch=16, dispatchers=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mname, stream in jmixes.items():
        ans, st_ = run_mix(stream, jfn, MIX_THREADS)
        check_mix(mname, ans, jrefs)
        jstats[(mname, f"{MIX_THREADS} threads, batcher, warm-up")] = st_
        l0, w0, s0 = dict(LAUNCHES), dict(WIDE), dict(SLOTS)
        ans, st_ = run_mix(stream, jfn, MIX_THREADS)
        check_mix(mname, ans, jrefs)
        jstats[(mname, f"{MIX_THREADS} threads, batcher")] = st_
        jwaves[mname] = tuple(d_[k_] - d0[k_] for d_, d0 in (
            (LAUNCHES, l0), (WIDE, w0), (SLOTS, s0))
            for k_ in ("join_member_batch",))
    torch.cuda.synchronize()
    peak_bj = torch.cuda.max_memory_allocated()
    bc = gs.counters()
    gs.close()
    launches_bj = dict(LAUNCHES)
    log(f"batched joins: {time.time() - tb:.1f} s (the twin's answers "
        f"included); launches {launches_bj}; peak device memory through "
        f"the batcher (torch.cuda.max_memory_allocated) {peak_bj} bytes; "
        "counters " + ", ".join(f"{k} {bc[k]}" for k in (
            "batch_dispatches", "batch_exceptions", "batch_timeouts",
            "batch_ineligible", "device_round_trips", "join_served")))
    for (mname, mode), st_ in jstats.items():
        log(f"mix {mname}, {mode}: {st_['n']} queries, {st_['qps']:.1f} "
            f"q/s, p50 {st_['p50']:.4f} ms, p95 {st_['p95']:.4f} ms, wall "
            f"{st_['wall']:.3f} s")
    for mname, (n_, w_, sl_) in jwaves.items():
        log(f"mix {mname} through the batcher: join_member_batch {n_} "
            f"launches, {w_} with more than one live slot, "
            f"{sl_ / max(n_, 1):.2f} live slots a launch")
    if bc["batch_timeouts"] or bc["batch_exceptions"]:
        fail("the batcher did not serve the joins cleanly")
    n_, _w, sl_ = jwaves["joins, one group"]
    if not n_ or sl_ / n_ <= 1.0:
        fail(f"the one-group joins averaged {sl_ / max(n_, 1):.2f} live "
             "slots a join_member_batch launch, not more than one")
    missing = [k for k in BATCHED_JOIN_KERNELS if launches_bj[k] == 0]
    if missing:
        fail(f"kernels never launched on the batched joins: {missing}")
    clean("the batched joins", gs)
    jc1 = (jc(gs), jc(hs))

    # a RAM delta declines (the caller's host join serves)
    idx.add_many(jB, P.PostingsList(np.array([39_999_999], np.int32),
                                    ds_terms[jB][0][:1]))
    if (gs.rank_join([jA, jB], [], ds_profiles["default"]) is not None
            or hs.rank_join([jA, jB], [], ds_profiles["default"])
            is not None):
        fail("rank_join with a RAM delta must decline")
    # the join path's counters: the batched joins' taken out
    jcp = [tuple(a - b + c for a, b, c in zip(jc(s_), jc1[i], jc0[i]))
           for i, s_ in enumerate((gs, hs))]
    log(f"join main path: {t_join:.1f} s (the CPU twin's and the "
        f"oracle's answers included); launches {launches_join}; counters "
        f"join_served, join_fallbacks, join_degraded_plain, queries_served, "
        f"stream_scans, fallbacks: {jcp[0]}")
    if jcp[0] != jcp[1]:
        fail(f"join counters differ: card {jcp[0]}, CPU twin {jcp[1]}")
    if jcp[0][:3] != (6, 1, 1):
        fail(f"join counters {jcp[0][:3]}, expected (6, 1, 1)")
    missing = [k for k in JOIN_KERNELS if launches_join[k] == 0]
    if missing:
        fail(f"kernels never launched on the join path: {missing}")
    # walls, card store only (median of 50 after a warm-up of 5); the
    # counts are read
    for label, fn in (
            ("rank_join joinA & headline", lambda: gs.rank_join(
                [jA, hl], [], ds_profiles["default"], k=100)),
            ("rank_join joinA & headline & term1000000", lambda: gs.rank_join(
                [jA, hl, t1m], [], ds_profiles["default"], k=100)),
            ("rank_join term1000000 & joinC (sort partner, 1M lanes)",
             lambda: gs.rank_join([t1m, jC], [], ds_profiles["default"],
                                  k=100)),
            ("filtered rank_term, cold (K6 each query)", lambda: (
                gs._span_stats_cache.clear(),
                gs.rank_term(hl, ds_profiles["default"], k=100,
                             **hfilt_kw))),
            ("filtered rank_term, filtered-stats cache hit", lambda:
             gs.rank_term(hl, ds_profiles["default"], k=100, **hfilt_kw))):
        for _ in range(5):
            fn()
        w = []
        for _ in range(50):
            tq = time.perf_counter()
            fn()
            w.append((time.perf_counter() - tq) * 1e3)
        join_walls[label] = w
        log(f"{label}, per query: median {float(np.median(w)):.4f} ms, "
            f"mean {float(np.mean(w)):.4f} ms, min {min(w):.4f} ms over 50 "
            "after 5")
    # the hybrid phase's conjunctions (their sparse answers at k = 10, 100
    # and 1000 under both join profiles), taken while the headline term
    # is one span: a second run would make joins with it decline
    hy_joins = {}
    for jname, inc in ((b"joinA & headline", [jA, hl]),
                       (b"term1000000 & headline", [t1m, hl])):
        for pn, prof in jprofs.items():
            for k in (10, 100, 1000):
                a = gs.rank_join(inc, [], prof, k=k)
                if a is None or not len(a[1]):
                    fail(f"rank_join {jname.decode()} gave no answer")
                hy_joins[(jname, pn, k)] = a
    clean("the join path", gs, hs)
    # the three joins' shapes (rare span, partners), kept for phase 4:
    # the arena's rows and join tables stay where they are
    join_shapes = {
        "joinA & headline": (gs.spans_for(jA)[0], [jpart(hl)], 1),
        "joinA & headline & term1000000": (gs.spans_for(t1m)[0],
                                           [jpart(jA), jpart(hl)], 2),
        "term1000000 & joinC (sort partner)": (gs.spans_for(t1m)[0],
                                               [jpart(jC)], 1)}

    def ds_query(label, th, pname, k, want):
        """One rank_term on the card and on the twin: equal answers, equal
        to the oracle's `want` (scores, docids); returns where it ended."""
        r0, t0s = gs.prune_rounds, gs.stream_scans
        tq = time.perf_counter()
        got = gs.rank_term(th, ds_profiles[pname], k=k)
        wall = (time.perf_counter() - tq) * 1e3
        twin = hs.rank_term(th, ds_profiles[pname], k=k)
        if got is None or twin is None:
            fail(f"rank_term {label}: no answer")
        if not (np.array_equal(got[0], twin[0])
                and np.array_equal(got[1], twin[1]) and got[2] == twin[2]):
            fail(f"rank_term {label}: the card and the CPU twin differ")
        if want is not None:
            expect(f"rank_term {label}", got[0], got[1], want[0][:k],
                   want[1][:k])
        rounds = gs.prune_rounds - r0
        end = ("exact scan" if gs.stream_scans > t0s
               else f"b={TD._PRUNE_B[rounds - 1]}")
        ended.setdefault(f"{label} -> {end}", []).append(wall)
        ends[label] = end
        return got

    # the counters compared below are this path's own: the join path's
    # walls ran on the card store alone
    counters = lambda s_: (s_.prune_rounds, s_.pruned_tiles,  # noqa: E731
                           s_.stream_scans, s_.queries_served, s_.fallbacks)
    base_g, base_h = counters(gs), counters(hs)
    # the result cache off on both stores: each of these queries reaches
    # the device path it is checked on (the batched path checks the cache)
    gs._topk_cache.enabled = hs._topk_cache.enabled = False
    torch.cuda.synchronize()
    reset_launches()
    tm = time.time()
    for q in range(50):
        k = 10 if q % 2 else 100
        ds_query(f"10M default k={k}", hl, "default", k, None)
    for i, n_t in enumerate(DS_TERMS):
        th = b"term%08d" % n_t
        ds_query(f"{n_t} default k=10", th, "default", 10,
                 KB.devstore_oracle([KB.arena_rows(*ds_terms[th])],
                                    ds_profiles["default"], 10))
    ds_query("10M escalating k=100", hl, "escalating", 100, None)
    got = ds_query("10M default k=1000", hl, "default", 1000, None)
    torch.cuda.synchronize()
    launches_ds1 = dict(LAUNCHES)
    mid_g, mid_h = counters(gs), counters(hs)
    gs._topk_cache.enabled = hs._topk_cache.enabled = True

    # -- phase 3, the batched path, part 1: the batcher and the cache -------
    # the same store and twin, every term still one prunable span; counts
    # reset. A cold query and its result-cache hit; then, the cache off,
    # a pruned mix (every term, two profiles, two languages, k = 10 and
    # 100) and a filtered-scan mix (the 1M, 100k and 20k terms and joinB,
    # whose RAM delta keeps it out of the waves; four filters; k = 10 and
    # 100, and the 20k term at PAST_FUSED_K), each sent one query at a
    # time (no batcher), from 16 threads
    # (no batcher), and from 16 threads through the batcher (scan
    # batching on); every answer equal to the first solo card answer and
    # to the twin's (the filtered scans' at k = 100)
    torch.cuda.synchronize()
    reset_launches()
    tb = time.time()
    bt_walls = {}
    c0 = gs.rank_term(t1m, ds_profiles["default"], k=100)
    hits0 = gs.counters()["rank_cache_hits"]
    c1 = gs.rank_term(t1m, ds_profiles["default"], k=100)
    same("result cache hit", c1, hs.rank_term(t1m, ds_profiles["default"],
                                             k=100), c0)
    if gs.counters()["rank_cache_hits"] != hits0 + 1:
        fail("the repeat of an unconstrained query was not a cache hit")
    bt_walls["rank_term, result cache hit (1M term, k=100)"] = walls_of(
        lambda: gs.rank_term(t1m, ds_profiles["default"], k=100))
    # the second profile weighs no signal more than the pack-time proxy
    # profile, so its bound holds as the default's does
    mix_profiles = {"default": ds_profiles["default"],
                    "light": R.RankingProfile(domlength=8, tf=5)}
    bt_terms = [hl, *(b"term%08d" % n for n in DS_TERMS), *JOIN_TERMS]
    scan_filters = [hfilt_kw, dict(lang_filter=de),
                    dict(flag_bit=7, to_days=20_000),
                    dict(from_days=10_000)]
    pruned_qs = [(th, pn, lg, k) for th in bt_terms for pn in mix_profiles
                 for lg in ("en", "de") for k in (10, 100)]
    pruned_fn = lambda q: gs.rank_term(  # noqa: E731
        q[0], mix_profiles[q[1]], language=q[2], k=q[3])
    scan_fn = lambda q: gs.rank_term(  # noqa: E731
        q[0], ds_profiles["default"], k=q[2], **scan_filters[q[1]])
    scan_twin = lambda q: hs.rank_term(  # noqa: E731
        q[0], ds_profiles["default"], k=q[2], **scan_filters[q[1]])
    # name: (distinct queries, times each is sent, card, twin or the mix
    # whose references hold its answers)
    mixes = {
        "pruned": (pruned_qs, MIX_REPEATS, pruned_fn,
                   lambda q: hs.rank_term(q[0], mix_profiles[q[1]],
                                          language=q[2], k=q[3])),
        # one (profile, language, kk) group, so that every concurrent
        # query can share a K5 wave: the pruned mix's default/en/k=100
        # queries, as often as the whole pruned mix sends queries
        "pruned, one group": ([q for q in pruned_qs
                               if q[1:] == ("default", "en", 100)],
                              8 * MIX_REPEATS, pruned_fn, "pruned"),
        "filtered scan": ([(th, f, k) for th in (
                               t1m, *(b"term%08d" % n for n in DS_TERMS[1:]),
                               jB) for f in range(len(scan_filters))
                           for k in (10, 100)]
                          + [(b"term%08d" % DS_TERMS[2], f, PAST_FUSED_K)
                             for f in range(len(scan_filters))],
                          MIX_REPEATS, scan_fn, scan_twin)}
    gs._topk_cache.enabled = False
    refs, mix_stats, waves = {}, {}, {}
    for mname, (qs, reps, fn, twin_fn) in mixes.items():
        stream = [q for _ in range(reps) for q in qs]
        ans, st_ = run_mix(stream, fn, 1)
        refs[mname] = {q: a[0] for q, a in ans.items()}
        mix_stats[(mname, "one at a time, no batcher")] = st_
        check_mix(mname, ans, refs[mname])
        if isinstance(twin_fn, str):
            check_mix(mname, {q: [refs[mname][q]] for q in qs},
                      refs[twin_fn])
        else:
            tq = time.time()
            # the filtered scans' twin at k = 100 only (10 s for all 32)
            twin_qs = [q for q in qs
                       if mname != "filtered scan" or q[2] == 100]
            for q in twin_qs:
                twin = twin_fn(q)
                same(f"{mname} {q[0].decode()} {q[1:]} (solo card, twin)",
                     refs[mname][q], twin, twin)
            log(f"mix {mname}: the twin's {len(twin_qs)} answers "
                f"{time.time() - tq:.1f} s")
        ans, st_ = run_mix(stream, fn, MIX_THREADS)
        mix_stats[(mname, f"{MIX_THREADS} threads, no batcher")] = st_
        check_mix(mname, ans, refs[mname])
    gs.enable_batching(max_batch=16, dispatchers=8, scan_batching=True)
    wide0 = dict(WIDE)
    for mname, (qs, reps, fn, _t) in mixes.items():
        stream = [q for _ in range(reps) for q in qs]
        l0, w0, s0 = dict(LAUNCHES), dict(WIDE), dict(SLOTS)
        ans, st_ = run_mix(stream, fn, MIX_THREADS)
        mix_stats[(mname, f"{MIX_THREADS} threads, batcher")] = st_
        check_mix(mname, ans, refs[mname])
        waves[mname] = {k: (LAUNCHES[k] - l0[k], WIDE[k] - w0[k],
                            SLOTS[k] - s0[k])
                        for k in ("pruned_tile", "span_stats_batch")}
    bc = gs.counters()
    log("batched path counters: " + ", ".join(
        f"{k} {bc[k]}" for k in (
            "batch_dispatches", "batch_dispatch_ms_max", "batch_exceptions",
            "batch_timeouts", "batch_ineligible", "dispatch_ms_p50",
            "dispatch_ms_p95", "kernel_ms_p50", "kernel_ms_p95",
            "device_round_trips", "queries_served", "rank_cache_hits")))
    log(f"launches with more than one live slot: "
        f"{ {k: WIDE[k] - wide0[k] for k in WIDE if WIDE[k] > wide0[k]} }")
    for mname, per in waves.items():
        log(f"mix {mname} through the batcher: " + "; ".join(
            f"{k} {n} launches, {w} with more than one live slot, "
            f"{sl / max(n, 1):.2f} live slots a launch"
            for k, (n, w, sl) in per.items()))
    if (bc["batch_dispatches"] == 0 or bc["batch_timeouts"]
            or bc["batch_exceptions"]):
        fail("the batcher did not serve cleanly: " + str(
            {k: bc[k] for k in ("batch_dispatches", "batch_timeouts",
                                "batch_exceptions")}))
    for name in ("pruned_tile", "span_stats_batch", "span_topk_batch"):
        if WIDE[name] == wide0[name]:
            fail(f"no {name} launch took more than one live slot")
    # deletes landing while 16 threads send the filtered-scan mix through
    # the batcher, whose dispatchers apply the pending tombstones they
    # find: then the card's tombstone bitmap must equal the twin's and the
    # mix's answers through the batcher the twin's. The docids deleted are
    # the mix's answers' and none of the 10M term's (its oracles stand)
    scan_qs = mixes["filtered scan"][0]
    cand = np.unique(np.concatenate([refs["filtered scan"][q][1]
                                     for q in scan_qs]))
    doomed = cand[~np.isin(cand, hl_rows[2])][:256]

    def deleter():
        for x in doomed:
            idx.delete_doc(int(x))
            time.sleep(0.0005)
    dth = threading.Thread(target=deleter)
    dth.start()
    run_mix([q for _ in range(4 * MIX_REPEATS) for q in scan_qs], scan_fn,
            MIX_THREADS)
    dth.join(timeout=120)
    if dth.is_alive():
        fail("the deletes did not finish")
    dead_g, dead_h = gs.arena.dead_array().cpu(), hs.arena.dead_array()
    if not torch.equal(dead_g, dead_h) or int(dead_h.sum()) != len(doomed):
        fail("tombstones deleted under the batcher are missing on the card")
    tq = time.time()
    after = {q: scan_twin(q) for q in scan_qs}
    ans, _st = run_mix(scan_qs * 2, scan_fn, MIX_THREADS)
    check_mix("filtered scan after the deletes", ans, after)
    log(f"{len(doomed)} deletes under 16 batched clients: the tombstone "
        f"bitmaps equal, {len(scan_qs)} answers equal to the twin's "
        f"({time.time() - tq:.1f} s)")
    # deletes of joinA's docids in none of the single-term mixes' terms
    # (even, or past the headline's) while 16 threads send joinC & joinA
    # (joinA a bitmap partner) through the batcher; then the tombstone
    # bitmaps equal and the answers through the batcher the twin's
    dj_qs = [(b"joinC & joinA", "none", k) for k in (10, 100)] + [
        (b"joinC & joinA & -term1000000", "en", k) for k in (10, 100)]
    dj_shapes = {b"joinC & joinA": ([jC, jA], []),
                 b"joinC & joinA & -term1000000": ([jC, jA], [t1m])}

    def dj_fn(q, store=gs, k=None):
        inc, exc = dj_shapes[q[0]]
        return store.rank_join(inc, exc, ds_profiles["default"],
                               k=k or q[2], **jlangs[q[1]])
    cand = np.unique(np.concatenate([dj_fn(q)[1] for q in dj_qs]))
    hl_ids = hl_rows[2]
    doomed_j = cand[~np.isin(cand, hl_ids)][:256]
    n_dead0 = int(hs.arena.dead_array().sum())

    def deleter_j():
        for x in doomed_j:
            idx.delete_doc(int(x))
            time.sleep(0.0005)
    dth = threading.Thread(target=deleter_j)
    dth.start()
    run_mix([q for _ in range(4 * MIX_REPEATS) for q in dj_qs], dj_fn,
            MIX_THREADS)
    dth.join(timeout=120)
    if dth.is_alive():
        fail("the deletes under the batched joins did not finish")
    dead_g, dead_h = gs.arena.dead_array().cpu(), hs.arena.dead_array()
    if not torch.equal(dead_g, dead_h) or \
            int(dead_h.sum()) != n_dead0 + len(doomed_j):
        fail("tombstones deleted under batched joins are missing on the card")
    tq = time.time()
    twin_j = {q: dj_fn(q, hs, 100) for q in dj_qs if q[2] == 100}
    after_j = {q: (twin_j[(q[0], q[1], 100)] if q[2] == 100 else
                   tuple(x[:10] for x in twin_j[(q[0], q[1], 100)][:2])
                   + (twin_j[(q[0], q[1], 100)][2],)) for q in dj_qs}
    ans, _st = run_mix(dj_qs * 8, dj_fn, MIX_THREADS)
    check_mix("batched joins after the deletes", ans, after_j)
    if set(doomed_j.tolist()) & {int(x) for a in ans.values() for r in a
                                 for x in r[1]}:
        fail("a deleted docid came back from a batched join")
    log(f"{len(doomed_j)} deletes of joinA's docids under 16 batched join "
        f"clients: the tombstone bitmaps equal, {len(dj_qs)} answers equal "
        f"to the twin's ({time.time() - tq:.1f} s)")
    clean("the batched path, part 1", gs, hs)
    gs._topk_cache.enabled = True
    gs.close()          # the batcher stops; the fanout keeps the store fed
    for (mname, mode), st_ in mix_stats.items():
        log(f"mix {mname}, {mode}: {st_['n']} queries, "
            f"{st_['qps']:.1f} q/s, p50 {st_['p50']:.4f} ms, p95 "
            f"{st_['p95']:.4f} ms, wall {st_['wall']:.3f} s")
    torch.cuda.synchronize()
    launches_bt1 = dict(LAUNCHES)
    log(f"batched path, part 1: {time.time() - tb:.1f} s; launches "
        f"{launches_bt1}")

    # back on the device store's path: counts reset, summed with part 1;
    # its counters compared as this path's own deltas
    torch.cuda.synchronize()
    reset_launches()
    base2_g, base2_h = counters(gs), counters(hs)
    gs._topk_cache.enabled = hs._topk_cache.enabled = False
    # a tombstone newer than the span: the exact scan over one extent
    gone = int(got[1][0])
    idx.delete_doc(gone)
    live = hl_rows[2] != gone
    hl_live = tuple(a[live] for a in hl_rows)
    ds_query("10M after a delete, default k=100", hl, "default", 100, None)
    # a second run of the 10M term: two spans, the exact scan over both
    f2, _d, _h, _r = KB.make_term(SECOND_RUN, KB.SEED + 9)
    d2 = (2 * np.arange(SECOND_RUN)).astype(np.int32)  # even: new docids
    idx.add_many(hl, P.PostingsList(d2, f2))
    idx.flush()
    two = [hl_live, KB.arena_rows(f2, d2)]
    for pname, k in (("default", 100), ("escalating", 1000)):
        ds_query(f"10M + {SECOND_RUN} (2 runs), {pname} k={k}", hl, pname,
                 k, None)
    torch.cuda.synchronize()
    launches_ds = {k: launches_ds1[k] + v for k, v in LAUNCHES.items()}
    log(f"devstore main path: {time.time() - tm:.1f} s (the CPU twin's "
        f"answers and the batched path's part 1 included); launches "
        f"{launches_ds}")
    dg = tuple(a - b + c - d for a, b, c, d in zip(mid_g, base_g,
                                                    counters(gs), base2_g))
    dh = tuple(a - b + c - d for a, b, c, d in zip(mid_h, base_h,
                                                    counters(hs), base2_h))
    log(f"devstore counters of this path: prune_rounds, pruned_tiles, "
        f"stream_scans, queries_served, fallbacks {dg}")
    if dg != dh:
        fail(f"devstore counters differ: card {dg}, CPU twin {dh}")
    for label, ws in ended.items():
        log(f"  rank_term {label}: {len(ws)} queries, wall median "
            f"{float(np.median(ws)):.3f} ms (the first {ws[0]:.3f} ms)")
    missing = [k for k in DEVSTORE_KERNELS if launches_ds[k] == 0]
    if missing:
        fail(f"kernels never launched on the devstore path: {missing}")
    clean("the devstore path", gs, hs)
    # the join path's filtered query after that delete and second run:
    # its cached statistics are stale (K6 runs again), the answer the
    # twin's and the oracle's over both spans
    k6_0 = LAUNCHES["span_stats"]
    got = gs.rank_term(hl, ds_profiles["default"], k=100, **hfilt_kw)
    twin = hs.rank_term(hl, ds_profiles["default"], k=100, **hfilt_kw)
    same("filtered rank_term after a delete and a second run", got, twin,
         None)
    if LAUNCHES["span_stats"] != k6_0 + 1:
        fail("a stale filtered-stats cache entry was served")

    # -- phase 3, the batched path, part 2: facet bitmaps and RAM deltas ----
    # on the 10M term (two spans now, one tombstone: exact scans), counts
    # reset: a site:-style facet bitmap over the 20M docid space admitting
    # 2 % of it, alone and with a language filter; RAM deltas of 50,000
    # postings (a hot term between flushes: new docids and 1,000 of the
    # term's own) and of 300,000 (past the last bucket); each equal to
    # the numpy oracle, the 300,000 delta to the twin's instead (the twin
    # costs 12-14 s of the CPU a query: the bitmap's and the 50,000
    # delta's answers are the oracle's alone); then their walls, the card
    # store alone
    torch.cuda.synchronize()
    reset_launches()
    tb = time.time()
    fac_ids = np.sort(jrng.choice(2 * N, 2 * N // 50, replace=False))
    fkey = ((("site", "smoke.example"),), 0, 2 * N)
    g_bm = gs.filter_bitmap(fkey, lambda: fac_ids)

    masks = [np.isin(d_p, fac_ids) for _f, _fl, d_p in two]
    two_in = [tuple(a[m] for a in p_) for p_, m in zip(two, masks)]
    en_only = (en, TD.NO_FLAG, TD.DAYS_NONE_LO, TD.DAYS_NONE_HI)
    for label, kw, filt in (("facet bitmap 2 %", {}, KD.NO_FILTER),
                            ("facet bitmap 2 %, lang en",
                             dict(lang_filter=en), en_only)):
        got = gs.rank_term(hl, ds_profiles["default"], k=100,
                           allow_bitmap=g_bm, **kw)
        tq = time.time()
        want = KB.devstore_oracle(filtered(two_in, filt),
                                  ds_profiles["default"], 100)
        log(f"rank_term {label}: the oracle {time.time() - tq:.1f} s")
        same(f"rank_term {label}", got, got, want)
        bt_walls[f"rank_term {label} (10M term, two spans, k=100; "
                 "statistics from the filtered-stats cache)"] = walls_of(
            lambda kw=kw: gs.rank_term(hl, ds_profiles["default"], k=100,
                                       allow_bitmap=g_bm, **kw))
    drng = np.random.default_rng(KB.SEED + 50)
    d_new = (2 * np.arange(SECOND_RUN, SECOND_RUN + 300_000)).astype(
        np.int32)
    d_old = drng.choice(hl_live[2], 1_000, replace=False)
    f_d, _dd, _h, _r = KB.make_term(300_000, KB.SEED + 51)
    for n_d, lo, hi in ((50_000, 0, 50_000), (300_000, 50_000, 300_000)):
        blk = np.concatenate([d_new[lo:hi - (1_000 if lo == 0 else 0)],
                              d_old if lo == 0 else d_old[:0]])
        idx.add_many(hl, P.PostingsList(blk.astype(np.int32),
                                        f_d[lo:hi]))
        ram = idx._ram_postings(hl)
        if len(ram) != n_d:
            fail(f"the RAM delta holds {len(ram)} postings, not {n_d}")
        got = gs.rank_term(hl, ds_profiles["default"], k=100)
        # the numpy oracle (8-9 s over 10.1M rows; the twin's delta scan
        # took 15 s)
        tq = time.time()
        r16, rfl = R.compact_feats(ram.feats)
        want = KB.devstore_oracle(two + [(r16, rfl, ram.docids)],
                                  ds_profiles["default"], 100)
        same(f"rank_term with a RAM delta of {n_d}", got, got, want)
        log(f"rank_term with a RAM delta of {n_d}: the oracle "
            f"{time.time() - tq:.1f} s")
        if got[2] != sum(len(p_[2]) for p_ in two) + 1 + n_d:
            fail(f"considered {got[2]} with a delta of {n_d}")
        bt_walls[f"rank_term with a RAM delta of {n_d} (10M term, two "
                 "spans, k=100)"] = walls_of(
            lambda: gs.rank_term(hl, ds_profiles["default"], k=100))
    torch.cuda.synchronize()
    launches_bt = {k: launches_bt1[k] + v for k, v in LAUNCHES.items()}
    log(f"batched path, part 2: {time.time() - tb:.1f} s; launches of the "
        f"whole batched path {launches_bt}")
    missing = [k for k in BATCHED_KERNELS if launches_bt[k] == 0]
    if missing:
        fail(f"kernels never launched on the batched path: {missing}")
    clean("the batched path, part 2", gs, hs)
    for label, w in bt_walls.items():
        log(f"wall {label}: median {float(np.median(w)):.4f} ms, mean "
            f"{float(np.mean(w)):.4f} ms, min {min(w):.4f} ms over 50 after 5")
    gs._topk_cache.enabled = True

    # -- phase 3, the hybrid rerank: rerank_boost, its batcher kind, the
    # hybrid cache and the host fallback, on the headline store ----------
    # the forward index: 2^21 unit vectors (dim 256, f16, from the seed),
    # the default 1 GiB budget, full, through convert.dense_from_numpy on
    # the card and on the CPU twin. The mix: the sparse answers of the
    # store's 7 terms x 2 profiles x k = 10, 100, 1000 (rank_term) and of
    # joinA & headline and term1000000 & headline (rank_join, taken on the
    # join path), each reranked at alpha 0.5 with a query vector from the
    # port's HashingEncoder; sent one at a time with no batcher, from 16
    # threads with none, and from 16 threads through it (after an untimed
    # pass), every answer the twin's to the bit. Then a hybrid-cache hit
    # equal to its cold answer with no device work; 1,000 vector writes
    # (the patch path) and the mix again; the bench path's
    # hybrid_rerank_topk(_batch) over the whole index (B = 1 and 16, K11);
    # and one put at docid 2^21, which grows the block past its budget:
    # rerank_boost declines (counted) and SearchEvent's host fallback
    # (get_block, dense_boost_topk, the re-sort) must equal the twin's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    tq = time.time()
    hy_time = {}
    vecs = KB.unit_vectors(DENSE_ROWS, np.random.default_rng(KB.SEED + 70))
    hy_time["vectors (host)"] = time.time() - tq
    tq = time.time()
    g_dense = convert.dense_from_numpy(vecs, DENSE_ROWS, device=dev)
    torch.cuda.synchronize()
    hy_time["dense_from_numpy, the card"] = time.time() - tq
    tq = time.time()
    h_dense = convert.dense_from_numpy(vecs, DENSE_ROWS, device="cpu")
    hy_time["dense_from_numpy, the twin"] = time.time() - tq
    del vecs
    gs.attach_dense(g_dense)
    hs.attach_dense(h_dense)
    if gs.counters()["dense_fwd_bytes"] != DENSE_ROWS * DN.DIM * 2:
        fail(f"the forward index holds {gs.counters()['dense_fwd_bytes']} "
             f"bytes on the card, not {DENSE_ROWS} rows")
    enc = DN.HashingEncoder()
    hy_in = {}
    for th in bt_terms:
        for pn, prof in mix_profiles.items():
            for k in (10, 100, 1000):
                a = gs.rank_term(th, prof, k=k)
                if a is None or not len(a[1]):
                    fail(f"rank_term {th.decode()} gave no answer")
                hy_in[(th, pn, k)] = a
    hy_in.update(hy_joins)
    hy_in = {q: (enc.encode(f"{q[0].decode()} {q[1]} hybrid"),
                 a[0].astype(np.int32), a[1].astype(np.int32))
             for q, a in hy_in.items()}
    cov = {q: (d < DENSE_ROWS).mean() for q, (_v, _s, d) in hy_in.items()}
    if min(cov[(t1m, pn, k)] for pn in mix_profiles
           for k in (10, 100, 1000)) != 1.0:
        fail("a docid of the 1M term lies past the forward index")
    if not 0 < cov[(hl, "default", 1000)] < 1 or \
            not 0 < cov[(b"joinA & headline", "default", 1000)] < 1:
        fail("the 10M term and joinA must be covered in part")
    hy_qs = list(hy_in)
    hy_fn = lambda q: gs.rerank_boost(*hy_in[q], 0.5)  # noqa: E731
    hy_stream = [q for _ in range(HYBRID_REPEATS) for q in hy_qs]

    def hy_twins():
        return {q: hs.rerank_boost(*hy_in[q], 0.5) for q in hy_qs}

    def hy_check(label, ans, refs):
        for q, got in ans.items():
            for a in got:
                if a is None or not (np.array_equal(a[0], refs[q][0])
                                     and np.array_equal(a[1], refs[q][1])):
                    fail(f"hybrid {label}: {q[0].decode()} {q[1:]} differs "
                         "from the twin's")
    tq = time.time()
    hy_refs = hy_twins()
    hy_time["the twin's answers"] = time.time() - tq
    for q, (v, sp_, d_) in hy_in.items():
        r = hy_refs[q]
        if r is None or sorted(r[1].tolist()) != sorted(d_.tolist()):
            fail(f"the twin's rerank of {q} lost candidates")
    torch.cuda.synchronize()
    reset_launches()
    th_ = time.time()
    hy_stats = {}
    for mode, threads in (("one at a time, no batcher", 1),
                          (f"{MIX_THREADS} threads, no batcher",
                           MIX_THREADS)):
        ans, st_ = run_mix(hy_stream, hy_fn, threads)
        hy_check(mode, ans, hy_refs)
        hy_stats[mode] = st_
    gs.enable_batching(max_batch=16, dispatchers=8, rerank_batching=True)
    for mode in ("untimed pass", "timed"):
        l0, w0, s0 = dict(LAUNCHES), dict(WIDE), dict(SLOTS)
        ans, st_ = run_mix(hy_stream, hy_fn, MIX_THREADS)
        hy_check(f"through the batcher, {mode}", ans, hy_refs)
        hy_stats[f"{MIX_THREADS} threads, batcher, {mode}"] = st_
        hy_wave = (LAUNCHES["dense_dot"] - l0["dense_dot"],
                   WIDE["dense_dot"] - w0["dense_dot"],
                   SLOTS["dense_dot"] - s0["dense_dot"])
        log(f"hybrid mix through the batcher, {mode}: dense_dot "
            f"{hy_wave[0]} launches, {hy_wave[1]} with more than one live "
            f"slot, {hy_wave[2] / max(hy_wave[0], 1):.2f} live slots a "
            "launch")
    if hy_wave[1] == 0:
        fail("no dense_dot launch took more than one live slot")
    hc = gs.counters()
    if hc["batch_timeouts"] or hc["batch_exceptions"]:
        fail(f"the batcher did not serve the hybrid mix cleanly: {hc}")
    gs.close()
    for mode, st_ in hy_stats.items():
        log(f"hybrid mix ({len(hy_qs)} distinct reranks), {mode}: "
            f"{st_['n']} queries, {st_['qps']:.1f} q/s, p50 "
            f"{st_['p50']:.4f} ms, p95 {st_['p95']:.4f} ms, wall "
            f"{st_['wall']:.3f} s")
    # a hybrid-cache hit: the full answer with no device work
    hq = (t1m, "default", 100)
    sp_a = hy_in[hq]
    epoch0, dv0 = gs.arena_epoch, gs.hybrid_vector_version()
    cold = gs.rerank_boost(*sp_a, 0.5)
    gs.hybrid_cache_put(t1m, mix_profiles["default"], "en", 100, 0.5, epoch0,
                        cold[0], cold[1], 1_000_000, dv0=dv0)
    c0, l0 = gs.counters(), dict(LAUNCHES)
    hit = gs.hybrid_cache_get(t1m, mix_profiles["default"], "en", 100, 0.5)
    c1 = gs.counters()
    if hit is None or not (np.array_equal(hit[0], cold[0])
                           and np.array_equal(hit[1], cold[1])):
        fail("the hybrid-cache hit differs from its cold answer")
    if (c1["rerank_cache_hits"] != c0["rerank_cache_hits"] + 1
            or c1["device_round_trips"] != c0["device_round_trips"]
            or dict(LAUNCHES) != l0):
        fail("the hybrid-cache hit did device work")
    hy_walls = {"hybrid_cache_get, a hit (1M term, k=100)": walls_of(
        lambda: gs.hybrid_cache_get(t1m, mix_profiles["default"], "en", 100,
                                    0.5))}
    hy_walls["rerank_boost solo, 1M term k=100 (nb=128)"] = walls_of(
        lambda: gs.rerank_boost(*sp_a, 0.5))
    hy_walls["rerank_boost solo, 10M term k=1000 (nb=1024)"] = walls_of(
        lambda: gs.rerank_boost(*hy_in[(hl, "default", 1000)], 0.5))
    # 1,000 vector writes: the patch path, then the mix against the twin
    wrng = np.random.default_rng(KB.SEED + 71)
    w_ids = wrng.choice(DENSE_ROWS, 1000, replace=False)
    w_vecs = KB.unit_vectors(1000, wrng)
    for d_, v_ in zip(w_ids.tolist(), w_vecs):
        g_dense.put(d_, v_)
        h_dense.put(d_, v_)
    p0 = g_dense.patches
    if gs.hybrid_cache_get(t1m, mix_profiles["default"], "en", 100,
                           0.5) is not None:
        fail("a hybrid-cache entry survived a vector write")
    tq = time.time()
    hy_refs2 = hy_twins()
    ans, _st = run_mix(hy_qs * 2, hy_fn, MIX_THREADS)
    hy_check("after 1,000 vector writes", ans, hy_refs2)
    if g_dense.patches != p0 + 1 or g_dense.uploads != 1:
        fail(f"the writes did not take the patch path (patches "
             f"{g_dense.patches}, uploads {g_dense.uploads})")
    log(f"1,000 vector writes: one patch, the mix's {len(hy_qs)} answers "
        f"equal to the twin's ({time.time() - tq:.1f} s)")
    # the bench path: hybrid_rerank_topk(_batch) over the whole index
    fwd_g = g_dense.device_block(dev)[0]
    hrng = np.random.default_rng(KB.SEED + 72)
    hq16 = put(np.stack([enc.encode(f"hybrid bench query {i}")
                         for i in range(16)]))
    hsp16 = put(hrng.integers(0, 1 << 20, (16, DENSE_ROWS)).astype(
        np.float32))
    hv16 = put(hrng.random((16, DENSE_ROWS)) < 0.9)
    for b_, (gsc, gix) in (
            (16, DN.hybrid_rerank_topk_batch(hq16, fwd_g, hsp16, hv16, 0.5,
                                             100)),
            (1, tuple(x[None] for x in DN.hybrid_rerank_topk(
                hq16[0], fwd_g, hsp16[0], hv16[0], 0.5, 100)))):
        sims_p = KDn.dense_sims_plain(fwd_g, hq16[:b_])
        fin_p = KDn.hybrid_blend_plain(sims_p, hsp16[:b_], hv16[:b_], 0.5)
        for i in range(b_):
            ws_, _w, wi_ = KT.tie_topk_plain(fin_p[i], 100)
            if not (torch.equal(gsc[i], ws_) and torch.equal(gix[i], wi_)):
                fail(f"hybrid_rerank_topk B={b_} slot {i} differs from "
                     "its plain version")
        del sims_p, fin_p
    log(f"hybrid_rerank_topk over {DENSE_ROWS} rows: B = 16 and 1 equal to "
        "their plain versions")
    # the fallback: a put at docid 2^21 grows the bucket past the budget
    rf0 = gs.counters()["rerank_fallbacks"]
    if rf0:
        fail(f"{rf0} reranks fell back outside the fallback check")
    g_dense.put(DENSE_ROWS, w_vecs[0])
    h_dense.put(DENSE_ROWS, w_vecs[0])
    for q in ((t1m, "default", 1000), (hl, "light", 1000),
              (b"joinA & headline", "default", 100)):
        qv, s_, d_ = hy_in[q]
        if gs.rerank_boost(qv, s_, d_, 0.5) is not None:
            fail("rerank_boost answered over the forward index's budget")
        outs = []
        for dv_ in (dev, "cpu"):
            fs, fi = DN.dense_boost_topk(qv, g_dense.get_block(d_), s_,
                                         np.ones(len(d_), bool), 0.5,
                                         len(d_), device=dv_)
            fd = d_[fi.cpu().numpy()]
            order = np.lexsort((fd, -fs.cpu().numpy().astype(np.int64)))
            outs.append((fs.cpu().numpy()[order], fd[order]))
        if not (np.array_equal(outs[0][0], outs[1][0])
                and np.array_equal(outs[0][1], outs[1][1])):
            fail(f"the host fallback of {q} differs from the twin's")
    hc = gs.counters()
    if hc["rerank_fallbacks"] != 3 or hc["dense_fwd_bytes"] != 0:
        fail(f"over budget: rerank_fallbacks {hc['rerank_fallbacks']}, "
             f"dense_fwd_bytes {hc['dense_fwd_bytes']}")
    torch.cuda.synchronize()
    launches_hy = dict(LAUNCHES)
    log(f"hybrid path: {time.time() - th_:.1f} s; launches {launches_hy}; "
        "set-up " + ", ".join(f"{k} {v:.1f} s" for k, v in hy_time.items()))
    missing = [k for k in HYBRID_KERNELS if launches_hy[k] == 0]
    if missing:
        fail(f"kernels never launched on the hybrid path: {missing}")
    log(f"hybrid path: device memory {mem0} bytes before the forward "
        f"index, peak {torch.cuda.max_memory_allocated()} "
        "(torch.cuda.max_memory_allocated)")
    log("hybrid counters: " + ", ".join(
        f"{k} {hc[k]}" for k in ("rerank_dispatches", "rerank_queries",
                                 "rerank_cache_hits", "rerank_fallbacks",
                                 "dense_fwd_bytes")))
    for label, w in hy_walls.items():
        log(f"wall {label}: median {float(np.median(w)):.4f} ms, mean "
            f"{float(np.mean(w)):.4f} ms, min {min(w):.4f} ms over 50 after 5")
    clean("the hybrid path", gs, hs)
    hy_shapes = {k: hy_in[k] for k in ((t1m, "default", 10),
                                       (t1m, "default", 100),
                                       (hl, "default", 1000))}
    del h_dense, hy_refs, hy_refs2

    # -- phase 3, the dense-first path: dense_first_topk, the batcher's
    # `ann` kind, the ANN tier ladder and the hybrid cache, on the
    # headline store ------------------------------------------------------
    # 2^21 clustered unit vectors (1024 centres, noise 0.15: the JAX
    # package's tests/test_ann.py corpus, from the seed) in a
    # DenseVectorStore and an AnnVectorIndex built from it at the JAX
    # defaults (C = n // 2048 = 1024 clusters, a 65,536-row sample, 3
    # k-means rounds; nprobe 8, 2^15 probe lanes, a 1 GiB budget: every
    # cluster hot, 2^21 rows of 262 B on the card), a CPU twin index
    # adopting its layout. The mix: a query vector near a corpus row with
    # the sparse answer of each of the hybrid mix's 54 queries (rank_term
    # over the store's terms, the two joins; most docids past the 2^21
    # vectors: sparse + 0), its k, alpha 0.5; sent one at a time, from 16
    # threads and from 16 threads through the batcher (after an untimed
    # pass), every answer the twin's to the bit. Then recall@10 against
    # exact_topk; a cache hit and its invalidation when the index is laid
    # out again; a probe-lane budget that drops clusters; a query while
    # the device is lost (search_host, the twin index's numpy path to the
    # bit); the ladder: an index of the same layout under a 2^28-byte
    # budget, warm clusters scored on the host, promoted through the
    # batcher's `promote` kind until no more fit, the answers then equal
    # to a CPU twin in the same tier state to the bit and within the bar
    # of the all-hot answers, and a cache entry re-keyed by a promotion
    from yacy_search_server_tpu_torch.index.annstore import AnnVectorIndex
    from yacy_search_server_tpu_torch.ops import ann as AN
    torch.cuda.synchronize()
    reset_launches()
    tdf = time.time()
    df_time = {}
    tq = time.time()
    drng = np.random.default_rng(KB.SEED + 80)
    dvecs, _dcent = KB.clustered_vectors(DF_ROWS, drng, dtype=np.float16)
    # host memory only: a budget of 0 keeps the forward index off
    df_dense = convert.dense_from_numpy(dvecs, DF_ROWS, device="cpu",
                                        budget_bytes=0)
    df_time["vectors and the dense store (host)"] = time.time() - tq
    tq = time.time()
    g_ann = AnnVectorIndex(DN.DIM, device=dev)
    g_ann.build_from_dense(df_dense)
    df_time["build_from_dense (k-means, assignment, int8)"] = \
        time.time() - tq
    layout = [getattr(g_ann, a) for a in (
        "centroids", "_slab", "_scales", "_sdocids", "_cstart", "_ccount",
        "_row_of")]
    h_ann = AnnVectorIndex(DN.DIM, device="cpu")
    h_ann.adopt(*layout)
    n_cl = DF_ROWS // 2048       # the JAX build's cluster count
    if g_ann.n_clusters() != n_cl or len(g_ann._hot_map) != n_cl:
        fail(f"the index holds {g_ann.n_clusters()} clusters, "
             f"{len(g_ann._hot_map)} of them hot: expected {n_cl}, all")
    gs.attach_ann(g_ann)
    hs.attach_ann(h_ann)
    df_in = {}
    for key, r in zip(hy_in, drng.integers(0, DF_ROWS, len(hy_in))):
        qv = dvecs[r].astype(np.float32) + 0.05 * drng.standard_normal(
            DN.DIM, dtype=np.float32)
        _v, s_, d_ = hy_in[key]
        df_in[key] = ((qv / np.linalg.norm(qv)).astype(np.float32), s_,
                      d_, key[2])
    del dvecs, df_dense
    df_qs = list(df_in)

    def df_ask(store, q, **kw):
        qv, s_, d_, k_ = df_in[q]
        return store.dense_first_topk(qv, s_, d_, 0.5, k_, **kw)

    def df_same(a, b):
        return a is not None and b is not None and \
            np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    def df_check(label, ans, refs):
        for q, got in ans.items():
            for a in got:
                if not df_same(a, refs[q]):
                    fail(f"dense-first {label}: {q[0].decode()} {q[1:]} "
                         "differs from the twin's")
    df_fn = lambda q: df_ask(gs, q)  # noqa: E731
    df_stream = [q for _ in range(DF_REPEATS) for q in df_qs]
    tq = time.time()
    df_refs = {q: df_ask(hs, q) for q in df_qs}
    df_time["the twin's answers"] = time.time() - tq
    for q, (qv, s_, d_, k_) in df_in.items():
        got = df_refs[q]
        if len(got[1]) != k_ or len(set(got[1].tolist())) != k_:
            fail(f"the twin's dense-first answer of {q} is not {k_} "
                 "distinct docids")
    df_stats = {}
    for mode, threads in (("one at a time, no batcher", 1),
                          (f"{MIX_THREADS} threads, no batcher",
                           MIX_THREADS)):
        ans, st_ = run_mix(df_stream, df_fn, threads)
        df_check(mode, ans, df_refs)
        df_stats[mode] = st_
    gs.enable_batching(max_batch=16, dispatchers=8, rerank_batching=True)
    for mode in ("untimed pass", "timed"):
        l0, w0, s0 = dict(LAUNCHES), dict(WIDE), dict(SLOTS)
        ans, st_ = run_mix(df_stream, df_fn, MIX_THREADS)
        df_check(f"through the batcher, {mode}", ans, df_refs)
        df_stats[f"{MIX_THREADS} threads, batcher, {mode}"] = st_
        df_wave = {n_: (LAUNCHES[n_] - l0[n_], WIDE[n_] - w0[n_],
                        SLOTS[n_] - s0[n_]) for n_ in DF_KERNELS}
        log(f"dense-first mix through the batcher, {mode}: " + "; ".join(
            f"{n_} {v[0]} launches, {v[1]} with more than one live slot, "
            f"{v[2] / max(v[0], 1):.2f} live slots a launch"
            for n_, v in df_wave.items()))
    if df_wave["ann_fuse"][1] == 0 or df_wave["ann_assign"][1] == 0:
        fail("no ann_assign or ann_fuse launch took more than one slot")
    dc = gs.counters()
    if dc["batch_timeouts"] or dc["batch_exceptions"]:
        fail(f"the batcher did not serve the dense-first mix cleanly: {dc}")
    gs.close()
    for mode, st_ in df_stats.items():
        log(f"dense-first mix ({len(df_qs)} distinct queries), {mode}: "
            f"{st_['n']} queries, {st_['qps']:.1f} q/s, p50 "
            f"{st_['p50']:.4f} ms, p95 {st_['p95']:.4f} ms, wall "
            f"{st_['wall']:.3f} s")
    # recall@10 of the probes (alpha 1, no sparse candidate) against the
    # exact scan of the whole quantized corpus
    tq = time.time()
    hits = 0
    for q in df_qs[:DF_RECALL_QUERIES]:
        qv = df_in[q][0]
        _s, d_ = gs.dense_first_topk(qv, [], [], 1.0, 10)
        hits += len(set(d_.tolist()) & set(g_ann.exact_topk(qv, 10)[1]
                                           .tolist()))
    recall = hits / (10 * DF_RECALL_QUERIES)
    log(f"dense-first recall@10 against exact_topk: {recall:.3f} over "
        f"{DF_RECALL_QUERIES} queries (nprobe 8 of {n_cl} clusters; "
        f"{time.time() - tq:.1f} s)")
    if recall == 0:
        fail("the dense-first probes found none of the exact neighbours")
    # a hybrid-cache hit, then the index laid out again (build's last
    # step, without its k-means) re-keys the entry
    q0 = (t1m, "default", 100)
    p0 = mix_profiles["default"]
    epoch0, dv0, cv0 = (gs.arena_epoch, gs.hybrid_vector_version(),
                        gs.ann_centroid_version())
    cold = df_fn(q0)
    gs.hybrid_cache_put(t1m, p0, "en", 100, 0.5, epoch0, cold[0], cold[1],
                        1_000_000, dv0=dv0, dense_first=True, cv0=cv0)
    c0, l0 = gs.counters(), dict(LAUNCHES)
    hit = gs.hybrid_cache_get(t1m, p0, "en", 100, 0.5, dense_first=True)
    c1 = gs.counters()
    if hit is None or not df_same(hit, cold):
        fail("the dense-first cache hit differs from its cold answer")
    if (c1["rerank_cache_hits"] != c0["rerank_cache_hits"] + 1
            or c1["device_round_trips"] != c0["device_round_trips"]
            or dict(LAUNCHES) != l0):
        fail("the dense-first cache hit did device work")
    if gs.hybrid_cache_get(t1m, p0, "en", 100, 0.5) is not None:
        fail("a dense-first entry answered a plain hybrid lookup")
    df_walls = {"hybrid_cache_get dense-first, a hit": walls_of(
        lambda: gs.hybrid_cache_get(t1m, p0, "en", 100, 0.5,
                                    dense_first=True))}
    for q in ((t1m, "default", 10), (t1m, "default", 100),
              (hl, "default", 1000)):
        df_walls[f"dense_first_topk solo, {q[0].decode()} k={q[2]}"] = \
            walls_of(lambda q=q: df_fn(q))
    g_ann.adopt(*layout)
    if gs.hybrid_cache_get(t1m, p0, "en", 100, 0.5,
                           dense_first=True) is not None:
        fail("a dense-first entry survived a new layout of the index")
    if not df_same(df_fn(q0), cold):
        fail("the index laid out again answers differently")
    # a probe-lane budget of two clusters' rows: whole clusters dropped
    gs.ann_probe_lanes = hs.ann_probe_lanes = DF_SMALL_LANES
    ld0 = g_ann.lane_drops
    for q in df_qs[:8]:
        if not df_same(df_fn(q), df_ask(hs, q)):
            fail(f"dense-first under {DF_SMALL_LANES} probe lanes: {q} "
                 "differs from the twin's")
    if g_ann.lane_drops - ld0 < 8:
        fail(f"{g_ann.lane_drops - ld0} clusters dropped by a "
             f"{DF_SMALL_LANES}-lane budget in 8 queries")
    log(f"probe lanes {DF_SMALL_LANES}: {g_ann.lane_drops - ld0} whole "
        "clusters dropped in 8 queries, every answer the twin's")
    gs.ann_probe_lanes = hs.ann_probe_lanes = AN.ANN_DEFAULT_PROBE_LANES
    # the device lost: search_host, the numpy path
    gs.device_lost = True
    hq0 = gs.counters()["ann_host_queries"]
    for q in df_qs[:4]:
        qv, s_, d_, k_ = df_in[q]
        want = h_ann.search_host(qv, d_, s_, 0.5, k_, AN.ANN_DEFAULT_NPROBE,
                                 AN.ANN_DEFAULT_PROBE_LANES)
        if not df_same(df_fn(q), want):
            fail(f"dense-first while the device is lost: {q} differs from "
                 "search_host")
    gs.device_lost = False
    if gs.counters()["ann_host_queries"] != hq0 + 4:
        fail("the lost-device queries were not counted in ann_host_queries")
    # the ladder: the same layout under a 2^28-byte budget
    tq = time.time()
    l_ann = AnnVectorIndex(DN.DIM, device=dev,
                           device_budget_bytes=DF_LADDER_BUDGET)
    l_ann.adopt(*layout)
    n_hot0 = len(l_ann._hot_map)
    gs.attach_ann(l_ann)
    gs.enable_batching(max_batch=16, dispatchers=8, rerank_batching=True)
    epoch0, cv0 = gs.arena_epoch, gs.ann_centroid_version()
    cold = df_fn(q0)
    gs.hybrid_cache_put(t1m, p0, "en", 100, 0.5, epoch0, cold[0], cold[1],
                        1_000_000, dense_first=True, cv0=cv0)
    rounds, last = 0, None
    while rounds < DF_LADDER_ROUNDS:
        rounds += 1
        run_mix(df_qs, df_fn, MIX_THREADS)
        deadline = time.time() + 60
        while (l_ann._promote_inflight or l_ann._hot_pending) and \
                time.time() < deadline:
            time.sleep(0.05)
        now = (l_ann.promotions, l_ann._hot_used)
        if now == last:
            break
        last = now
    else:
        fail(f"the ladder still promoted after {rounds} rounds")
    lc = gs.counters()
    if gs.hybrid_cache_get(t1m, p0, "en", 100, 0.5,
                           dense_first=True) is not None:
        fail("a dense-first entry survived a promotion")
    if not (lc["ann_tier_warm_hits"] and lc["ann_promotions"]
            and lc["tier_promote_async"] and l_ann.patches):
        fail(f"the ladder did not promote through the batcher: {lc}")
    hl_ann = convert.ann_from_numpy(
        *layout, l_ann._hot_slab, l_ann._hot_scales, l_ann._hot_docids,
        l_ann._hot_map, device="cpu", device_budget_bytes=DF_LADDER_BUDGET)
    hl_ann.PROMOTE_AFTER = 1 << 30     # the twin holds the card's tiers
    hs.attach_ann(hl_ann)
    l_refs = {q: df_ask(hs, q) for q in df_qs}
    ans, _st = run_mix(df_qs * 2, df_fn, MIX_THREADS)
    if (l_ann.promotions, l_ann._hot_used) != last:
        fail("the ladder promoted during its compared round")
    df_check("the ladder, through the batcher", ans, l_refs)
    worst = 0
    for q, got in ans.items():
        s_, d_ = got[0]
        ws_, wd_ = df_refs[q]
        kth = int(ws_[-1])
        w = dict(zip(wd_.tolist(), ws_.tolist()))
        for s1, d1 in zip(s_.tolist(), d_.tolist()):
            if d1 in w:
                worst = max(worst, abs(s1 - w[d1]))
            elif s1 > kth + DF_TOL:
                fail(f"the ladder's {q}: docid {d1} ({s1}) is not among "
                     "the all-hot answer's and above its last by more "
                     "than the bar")
    if worst > DF_TOL:
        fail(f"the ladder's answers differ from the all-hot ones by "
             f"{worst} units (bar {DF_TOL})")
    dc = gs.counters()
    if dc["batch_timeouts"] or dc["batch_exceptions"]:
        fail(f"the batcher did not serve the ladder cleanly: {dc}")
    gs.close()
    log(f"ladder: {n_hot0} of {n_cl} clusters hot at a {DF_LADDER_BUDGET}-"
        f"byte budget, {rounds} rounds of the mix through the batcher: "
        f"{lc['ann_tier_warm_hits']} warm hits, {lc['ann_promotions']} "
        f"promotions ({l_ann.patches} patches), "
        f"{lc['ann_promote_failures']} refused (arena full), "
        f"{len(l_ann._hot_map)} clusters hot; every answer the twin's in "
        f"the same tiers, within {worst} units of the all-hot answers "
        f"({time.time() - tq:.1f} s)")
    gs.attach_ann(g_ann)
    hs.attach_ann(h_ann)
    del l_ann, hl_ann, l_refs
    torch.cuda.synchronize()
    launches_df = dict(LAUNCHES)
    dc = gs.counters()
    log(f"dense-first path: {time.time() - tdf:.1f} s; launches "
        f"{launches_df}; set-up " + ", ".join(
            f"{k} {v:.1f} s" for k, v in df_time.items()))
    log("dense-first counters: " + ", ".join(
        f"{k} {dc[k]}" for k in (
            "ann_dispatches", "ann_queries", "ann_fallbacks",
            "ann_host_queries", "ann_vectors", "ann_clusters",
            "ann_centroid_version", "ann_hot_bytes", "ann_tier_hot_hits",
            "ann_tier_warm_hits", "ann_promotions", "ann_lane_drops")))
    for label, w in df_walls.items():
        log(f"wall {label}: median {float(np.median(w)):.4f} ms, mean "
            f"{float(np.mean(w)):.4f} ms, min {min(w):.4f} ms over 50 after 5")
    missing = [k for k in DF_KERNELS if launches_df[k] == 0]
    if missing:
        fail(f"kernels never launched on the dense-first path: {missing}")
    clean("the dense-first path", gs, hs)
    del hs, idx, hl_live, two, join_rows

    # -- phase 3, device loss (a store of its own: the 1M term and a term
    # of 200,000 postings meeting it) ------------------------------------
    # one injected `device.transfer_fail` charge: a counted retry, the
    # same answers; a streak (no retries, a streak of two): the loss
    # declared, rank_term and rank_join answer None, counted, the result
    # cache's entry dead with the epoch; the rebuild's probes drain the
    # charges left and it recovers, the answers after it equal to those
    # before, bit for bit; then 16 batched waiters under a loss all
    # return, and the store recovers again
    from yacy_search_server_tpu_torch.utils import faultinject
    tl = time.time()
    point = "device.transfer_fail"
    lidx = RWIIndex()
    f_1m, d_1m = ds_terms[t1m]
    pair = b"lossPairAAAA"
    f_p, _d, _h, _r = KB.make_term(200_000, KB.SEED + 80)
    lidx.add_many(t1m, P.PostingsList(d_1m, f_1m))
    lidx.add_many(pair, P.PostingsList(
        KB.draw_docids(200_000, 2_000_000, jrng), f_p))
    lidx.flush()
    ls = TD.DeviceSegmentStore(lidx, device=dev)
    ls._topk_cache.enabled = False
    prof_l = ds_profiles["default"]
    # the store module's loss settings, tightened for this phase only
    loss_defaults = (TD.TRANSFER_RETRIES, TD.LOSS_STREAK,
                     TD.REBUILD_BACKOFF_S)

    def ask_l():
        return (ls.rank_term(t1m, prof_l, k=100),
                ls.rank_join([pair, t1m], [], prof_l, k=100))

    def loss_state():
        c_ = ls.counters()
        return tuple(c_[k] for k in (
            "device_lost", "device_losses", "device_loss_recoveries",
            "device_lost_queries", "transfer_failures", "transfer_retries"))

    def same_l(label, got, want):
        for g_, w_ in zip(got, want):
            if g_ is None or not (np.array_equal(g_[0], w_[0])
                                  and np.array_equal(g_[1], w_[1])
                                  and g_[2] == w_[2]):
                fail(f"device loss: {label}: the answer differs")

    def recovered(timeout=120.0):
        t_end = time.time() + timeout
        while ls.device_lost and time.time() < t_end:
            time.sleep(0.05)
        if ls.device_lost:
            fail("device loss: the rebuild did not recover")
    before = ask_l()
    if before[0] is None or before[1] is None or not len(before[1][1]):
        fail("device loss: no answer before the loss")
    # a forward index for the rerank under the loss
    ls.attach_dense(convert.dense_from_numpy(
        KB.unit_vectors(1 << 16, np.random.default_rng(KB.SEED + 81)),
        device=dev))
    rr_in = (enc.encode("device loss rerank"), before[0][0], before[0][1])
    rr_before = ls.rerank_boost(*rr_in, 0.5)
    if rr_before is None:
        fail("device loss: no rerank before the loss")
    faultinject.set_fault(point, 1)
    same_l("one injected charge", ask_l(), before)
    if loss_state() != (0, 0, 0, 0, 0, 1):
        fail(f"device loss: one charge gave {loss_state()}")
    TD.TRANSFER_RETRIES, TD.LOSS_STREAK, TD.REBUILD_BACKOFF_S = 0, 2, 0.05
    ls._topk_cache.enabled = True
    ls.rank_term(t1m, prof_l, k=100)         # the cache's entry
    if ls.rank_cache_get(t1m, prof_l, k=100) is None:
        fail("device loss: no result-cache entry before the loss")
    ls._topk_cache.enabled = False
    epoch0 = ls.arena_epoch
    # two failed fetches (the streak), then three failed rebuild probes
    faultinject.set_fault(point, 5)
    if ls.rank_term(t1m, prof_l, k=100) is not None or ls.device_lost:
        fail("device loss: the first failed fetch must not declare it")
    if ls.rank_term(t1m, prof_l, k=100) is not None or not ls.device_lost:
        fail("device loss: the streak did not declare the loss")
    if any(a is not None for a in ask_l()):
        fail("device loss: an entry point answered while the device is lost")
    lq0 = ls.counters()
    if ls.rerank_boost(*rr_in, 0.5) is not None:
        fail("device loss: rerank_boost answered while the device is lost")
    lq1 = ls.counters()
    if (lq1["rerank_fallbacks"] != lq0["rerank_fallbacks"] + 1
            or lq1["device_lost_queries"] != lq0["device_lost_queries"]
            or lq1["rerank_queries"] != lq0["rerank_queries"]):
        fail("device loss: a rerank while lost must count in "
             "rerank_fallbacks only")
    ls._topk_cache.enabled = True
    if ls.arena_epoch == epoch0 or \
            ls.rank_cache_get(t1m, prof_l, k=100) is not None:
        fail("device loss: the result cache survived the loss")
    ls._topk_cache.enabled = False
    lost = loss_state()
    recovered()
    same_l("after the rebuild", ask_l(), before)
    rr_after = ls.rerank_boost(*rr_in, 0.5)
    if rr_after is None or not (np.array_equal(rr_after[0], rr_before[0])
                                and np.array_equal(rr_after[1],
                                                   rr_before[1])):
        fail("device loss: the rerank after the rebuild differs")
    st1 = loss_state()
    log(f"device loss: one charge retried; a streak declared the loss "
        f"{lost}; recovered {st1}, the answers equal to those before")
    if lost[:2] != (1, 1) or lost[3:5] != (4, 2) or st1[:3] != (0, 1, 1):
        fail(f"device loss: counters {lost}, then {st1}")
    TD.LOSS_STREAK = 1
    ls.enable_batching(max_batch=16, dispatchers=8)
    faultinject.set_fault(point, 1_000_000)
    outs, lerr = [], []

    def waiter(i):
        try:
            outs.append(ls.rank_term(t1m, prof_l, k=100) if i % 2 else
                        ls.rank_join([pair, t1m], [], prof_l, k=100))
        except Exception as ex:  # noqa: BLE001 - failed below
            lerr.append(ex)
    tw = time.time()
    ths = [threading.Thread(target=waiter, args=(i,)) for i in range(16)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=120)
    if any(th.is_alive() for th in ths) or lerr or len(outs) != 16:
        fail(f"device loss: batched waiters hung or raised: {lerr[:1]}")
    if any(o is not None for o in outs) or not ls.device_lost:
        fail("device loss: a batched waiter answered from the lost device")
    t_wait = time.time() - tw
    faultinject.clear()
    recovered()
    same_l("after the second rebuild", ask_l(), before)
    st2 = loss_state()
    ls.close()
    TD.TRANSFER_RETRIES, TD.LOSS_STREAK, TD.REBUILD_BACKOFF_S = loss_defaults
    log(f"device loss: 16 batched waiters under a loss returned in "
        f"{t_wait:.3f} s; recovered {st2}; the answers equal to those "
        f"before; the phase {time.time() - tl:.1f} s")
    if st2[1:3] != (2, 2) or st2[3] != st1[3] + 16:
        fail(f"device loss: counters after the batched loss {st2}")
    del ls, lidx

    # -- phase 3, the packed path: packed residency, its tier ladder and the
    # device pack build -------------------------------------------------------
    # a fresh RWIIndex of the device branch's run (the 10M term, the 1M,
    # 100k and 20k terms and joinA, joinB, joinC: 17,150,000 rows), a packed
    # store on the card with the device build on (K13 packs the blocks of
    # 64 to 2^18 rows, the host the others) and an int16 store on the card
    # beside it, the reference: the device branch's single-term queries,
    # the filtered scans and the pruned mix (one at a time, from 16
    # threads, and through the batcher: K5bp waves) on the packed store,
    # every answer the int16 store's; a device loss (the rebuild demotes
    # every block and promotes it again through the batcher's `promote`
    # kind, K12 decoding each promoted block's first row); the tier ladder
    # (the budget cut to hold the 10M term's block but not every block,
    # the rebuild under it, warm hits and promotions through the batcher
    # under 16 clients, LRU demotions and compactions, a cold promotion
    # after a flush with no warm budget) and a delete; then K13 at a
    # flush's shape (a run of 256 terms of 64 to 262,144 rows, every block
    # word for word the CPU twin's host pack, a few queries the twin's)
    from yacy_search_server_tpu_torch.kernels import packed as KP
    from yacy_search_server_tpu_torch.ops import packed as PK
    torch.cuda.synchronize()
    reset_launches()
    tp = time.time()
    # the packed exact scans counted by span rows and route (K7bp's
    # selection at kk <= KD.FUSED_KK, its buffer past it)
    pk_scans = {}
    scan_bp0 = TD.scan_query_bp

    def counted_scan_bp(words, dead, sp_, consts_, kk_, filt=None):
        key = (sp_.count, "selection" if kk_ <= KD.FUSED_KK else "buffer")
        pk_scans[key] = pk_scans.get(key, 0) + 1
        return scan_bp0(words, dead, sp_, consts_, kk_, filt)
    TD.scan_query_bp = counted_scan_bp
    pk_walls = {}
    pidx = RWIIndex()
    for th, (f_t, d_t) in ds_terms.items():
        pidx.add_many(th, P.PostingsList(d_t, f_t))
    ps = TD.DeviceSegmentStore(pidx, device=dev, packed_residency=True)
    ps.ingest_device_build = True
    pidx.listener = None       # the packs below are timed side by side
    tq = time.time()
    pidx.flush()
    pk_walls["flush (host)"] = time.time() - tq
    prun = pidx._runs[0]
    # the int16 store packs in a thread of its own while the packed store
    # packs: both walls read with the other pack beside them (one after
    # the other they took 44.5 and 29.1 s)
    tq = time.time()
    i16_box = {}

    def pack_int16():
        i16_box["g2"] = TD.DeviceSegmentStore(pidx, device=dev)
        torch.cuda.synchronize()
        i16_box["wall"] = time.time() - tq
    i16_th = threading.Thread(target=pack_int16)
    i16_th.start()
    ps.on_run_added(prun)
    torch.cuda.synchronize()
    pk_walls["pack, packed store on the card (the int16 store beside it)"] \
        = time.time() - tq
    i16_th.join()
    if "g2" not in i16_box:
        fail("the int16 store's pack raised")
    g2 = i16_box["g2"]
    pk_walls["pack, int16 store on the card (beside the packed one)"] = \
        i16_box["wall"]
    pidx.listener = KB.Fanout(ps, g2)
    if LAUNCHES["pack_block_batch"] == 0 or ps.ingest_device_builds == 0:
        fail("the packed store's build never went through K13")
    row_bits = {th.decode(): sp_[0].row_bits for th in ds_terms
                for sp_ in [ps.spans_for(th)]}
    log(f"packed store: {ps.arena._pw_used} words, compression "
        f"{ps.packed_compression_ratio()}, tier bytes {ps.tier_bytes()}, "
        f"{ps.ingest_device_builds} blocks by K13; row bits {row_bits}; "
        + ", ".join(f"{k} {v:.1f} s" for k, v in pk_walls.items()))
    if any(not e["hot"] for e in ps._pblocks.values()):
        fail("a block of the packed store is not hot under the full budget")
    ps._topk_cache.enabled = g2._topk_cache.enabled = False

    def pk_same(label, got, want):
        if got is None or want is None:
            fail(f"packed path: {label}: no answer")
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1]) and got[2] == want[2]):
            fail(f"packed path: {label}: the packed store differs from "
                 "the int16 store")

    def pk_query(label, th, prof, k, **kw):
        got = ps.rank_term(th, prof, k=k, **kw)
        pk_same(label, got, g2.rank_term(th, prof, k=k, **kw))
        return got

    pk_terms = [hl, *(b"term%08d" % n for n in DS_TERMS), *JOIN_TERMS]
    for q in range(50):
        k = 10 if q % 2 else 100
        pk_query(f"10M default k={k}", hl, ds_profiles["default"], k)
    for th in pk_terms[1:]:
        pk_query(f"{th.decode()} default k=10", th, ds_profiles["default"],
                 10)
    pk_query("10M escalating k=100", hl, ds_profiles["escalating"], 100)
    pk_query("10M default k=1000", hl, ds_profiles["default"], 1000)
    pk_filters = [hfilt_kw, dict(lang_filter=de),
                  dict(flag_bit=7, to_days=20_000), dict(from_days=10_000)]
    for th in pk_terms:
        for f_kw in pk_filters:
            pk_query(f"{th.decode()} filtered {f_kw}", th,
                     ds_profiles["default"], 100, **f_kw)
    # past K7bp's selection (kk 4096): its buffer, kernel 3, the finish
    pk_query(f"10M filtered k={PAST_FUSED_K}", hl, ds_profiles["default"],
             PAST_FUSED_K, **hfilt_kw)
    pc = ps.counters()
    log("packed store after the single-term queries: " + ", ".join(
        f"{k} {pc[k]}" for k in ("queries_served", "prune_rounds",
                                 "pruned_tiles", "stream_scans", "fallbacks",
                                 "tier_hot_hits")))
    if pc["pruned_tiles"] == 0 or pc["fallbacks"]:
        fail("packed path: no pruned query, or a fallback")

    # the pruned mix: the 7 terms x 2 profiles x 2 languages x k = 10, 100,
    # each sent MIX_REPEATS times, its answers the int16 store's
    pk_profiles = {"default": ds_profiles["default"],
                   "light": R.RankingProfile(domlength=8, tf=5)}
    pk_qs = [(th, pn, lg, k) for th in pk_terms for pn in pk_profiles
             for lg in ("en", "de") for k in (10, 100)]
    pk_refs = {q: g2.rank_term(q[0], pk_profiles[q[1]], language=q[2],
                               k=q[3]) for q in pk_qs}
    pk_fn = lambda q: ps.rank_term(  # noqa: E731
        q[0], pk_profiles[q[1]], language=q[2], k=q[3])
    pk_stream = [q for _ in range(MIX_REPEATS) for q in pk_qs]
    pk_stats = {}
    for mode, thr in (("one at a time, no batcher", 1),
                      (f"{MIX_THREADS} threads, no batcher", MIX_THREADS)):
        ans, pk_stats[mode] = run_mix(pk_stream, pk_fn, thr)
        check_mix("packed pruned", ans, pk_refs)
    ps.enable_batching(max_batch=16, dispatchers=8)
    n0, w0, s0 = (LAUNCHES["pruned_tile_bp"], WIDE["pruned_tile_bp"],
                  SLOTS["pruned_tile_bp"])
    mode = f"{MIX_THREADS} threads, batcher"
    ans, pk_stats[mode] = run_mix(pk_stream, pk_fn, MIX_THREADS)
    check_mix("packed pruned", ans, pk_refs)
    n1, w1, s1 = (LAUNCHES["pruned_tile_bp"] - n0,
                  WIDE["pruned_tile_bp"] - w0, SLOTS["pruned_tile_bp"] - s0)
    for mode, st_ in pk_stats.items():
        log(f"mix packed pruned ({len(pk_qs)} distinct), {mode}: "
            f"{st_['n']} queries, {st_['qps']:.1f} q/s, p50 "
            f"{st_['p50']:.4f} ms, p95 {st_['p95']:.4f} ms")
    log(f"mix packed pruned through the batcher: pruned_tile_bp {n1} "
        f"launches, {w1} with more than one live slot, "
        f"{s1 / max(n1, 1):.2f} live slots a launch")
    bc = ps.counters()
    if (bc["batch_dispatches"] == 0 or bc["batch_timeouts"]
            or bc["batch_exceptions"] or w1 == 0):
        fail("packed path: the batcher did not serve K5bp waves cleanly")
    # the 10M term's block as it stands now, kept for phase 4's timings
    pk_keep = (ps.arena.packed_array(), ps.arena.dead_array(),
               ps.arena._pmax, ps.spans_for(hl)[0],
               ps._pblocks[(id(prun), hl)]["block"])

    def settled(timeout=300.0):
        t_end = time.time() + timeout
        while ((ps.device_lost or ps._promote_inflight)
               and time.time() < t_end):
            time.sleep(0.02)
        if ps.device_lost or ps._promote_inflight:
            fail("packed path: the promotions did not settle")

    def tiers():
        c_ = ps.counters()
        return {k: c_[k] for k in c_ if k.startswith("tier_")}

    # a device loss under the packed store (the loss phase's settings):
    # two filtered queries (solo: their fetches take the two charges)
    TD.TRANSFER_RETRIES, TD.LOSS_STREAK, TD.REBUILD_BACKOFF_S = 0, 2, 0.05
    exc0 = ps.counters()["batch_exceptions"]

    def lose():
        faultinject.set_fault(point, 2)
        for th in (hl, t1m):
            if ps.rank_term(th, ds_profiles["default"], k=100,
                            lang_filter=en) is not None:
                fail("packed path: a query answered under the streak")
        if not ps.device_lost:
            fail("packed path: the streak did not declare the loss")
    lose()
    tq = time.time()
    settled()
    pk_walls["loss, rebuild and re-promotion"] = time.time() - tq
    faultinject.clear()
    ans, _st = run_mix(pk_qs, pk_fn, MIX_THREADS)
    check_mix("packed pruned after the rebuild", ans, pk_refs)
    log(f"packed path, device loss: recovered in "
        f"{pk_walls['loss, rebuild and re-promotion']:.1f} s, every block "
        f"promoted again through the batcher; the mix's answers equal to "
        f"those before; {tiers()}")
    if ps.counters()["batch_exceptions"] != exc0:
        fail("packed path: a promotion or its probe failed")

    # the tier ladder: the budget cut to hold the 10M term's block beside
    # some of the others but not all, then a loss: the rebuild promotes
    # every block again under the cut budget
    blocks_w = {th: len(e["block"].words)
                for (_r, th), e in ps._pblocks.items()}
    cap_w = TD._PW_INITIAL_WORDS
    while cap_w < TD._bucket_rows(blocks_w[hl]):
        cap_w *= 2
    if sum(blocks_w.values()) <= cap_w:
        fail("packed path: the cut budget would hold every block")
    ps.arena.budget_bytes = (ps.arena._cap * ps.arena.row_bytes()
                             + ps.arena._doc_cap + 4 * cap_w)
    compactions = [0]
    repack0 = ps._repack_packed_locked

    def counted_repack():
        compactions[0] += 1
        repack0()
    ps._repack_packed_locked = counted_repack
    lose()
    settled()
    faultinject.clear()
    hot0 = sorted(th.decode() for (_r, th), e in ps._pblocks.items()
                  if e["hot"])
    log(f"packed path, tier ladder: budget {ps.arena.budget_bytes} bytes "
        f"({cap_w} words); after the rebuild hot {hot0}; {tiers()}; "
        f"{compactions[0]} compactions")
    # 16 clients send the pruned mix's distinct queries through the
    # batcher, twice each: a query on a warm block is a counted miss (None:
    # the caller's host path) whose promotion rides the batcher; every
    # other answer the int16 store's
    t0_ = tiers()
    served = missed = 0
    ans, st_ = run_mix(pk_qs * 2, pk_fn, MIX_THREADS)
    for q, got in ans.items():
        for a in got:
            if a is None:
                missed += 1
            else:
                served += 1
                pk_same(f"tier ladder {q[0].decode()} {q[1:]}", a,
                        pk_refs[q])
    settled()
    t1_ = tiers()
    log(f"packed path, tier ladder under {MIX_THREADS} clients: {served} "
        f"answers the int16 store's, {missed} misses; "
        + ", ".join(f"{k} +{t1_[k] - t0_[k]}" for k in t1_
                    if t1_[k] != t0_[k]) + f"; {compactions[0]} compactions")
    if (t1_["tier_warm_hits"] == t0_["tier_warm_hits"]
            or t1_["tier_promote_async"] == t0_["tier_promote_async"]
            or t1_["tier_demotions_hot_warm"]
            == t0_["tier_demotions_hot_warm"] or compactions[0] == 0):
        fail("packed path: the ladder saw no warm hit, promotion through "
             "the batcher, demotion or compaction")
    # the 10M term served again after its promotion
    for _ in range(200):
        got = ps.rank_term(hl, ds_profiles["default"], k=100)
        if got is not None:
            break
        settled()
    pk_same("10M default k=100 after its promotion", got,
            pk_refs[(hl, "default", "en", 100)])
    # a cold promotion: no warm budget, a new run flushed (its pack
    # evicts every warm block), then a query on an evicted term
    ps.warm_budget_bytes = 0
    f_n, _d, _h, _r = KB.make_term(1_000, KB.SEED + 90)
    pidx.add_many(b"ladderAAAAAA", P.PostingsList(
        (1 + 2 * np.arange(1_000)).astype(np.int32), f_n))
    pidx.flush()
    cold = [th for th in pk_terms if not any(
        k_[1] == th for k_ in ps._pblocks)]
    t2_ = tiers()
    if not cold or t2_["tier_evictions_warm_cold"] == 0:
        fail("packed path: no block went cold")
    cth = min(cold, key=lambda th: len(ds_terms[th][1]))
    if ps.rank_term(cth, ds_profiles["default"], k=100) is not None:
        fail("packed path: a cold term answered before its promotion")
    settled()
    pk_same(f"{cth.decode()} after its cold promotion",
            ps.rank_term(cth, ds_profiles["default"], k=100),
            pk_refs[(cth, "default", "en", 100)])
    t3_ = tiers()
    log(f"packed path, cold promotion of {cth.decode()}: " + ", ".join(
        f"{k} +{t3_[k] - t2_[k]}" for k in t3_ if t3_[k] != t2_[k]))
    if t3_["tier_cold_hits"] == t2_["tier_cold_hits"] or \
            t3_["tier_promotions_cold_hot"] == t2_["tier_promotions_cold_hot"]:
        fail("packed path: no cold hit or cold promotion")
    # a delete: the exact packed scan over the term (its frozen stats are
    # stale), the int16 store's answer
    gone_p = int(pk_refs[(cth, "default", "en", 100)][1][0])
    pidx.delete_doc(gone_p)
    s0_ = ps.stream_scans
    got = pk_query(f"{cth.decode()} after a delete", cth,
                   ds_profiles["default"], 100)
    if gone_p in got[1] or ps.stream_scans != s0_ + 1:
        fail("packed path: the delete was not served by the exact scan")
    ps.close()
    g2.close()
    TD.TRANSFER_RETRIES, TD.LOSS_STREAK, TD.REBUILD_BACKOFF_S = loss_defaults
    del g2

    # K13 at a flush's shape: a second RWIIndex, one run of 256 terms of
    # log-uniform sizes in [64, 262,144] rows; a packed store on the card
    # (the device build: K13) and its CPU twin (the host pack): every block
    # word for word the twin's, and a few queries the twin's
    krng = np.random.default_rng(KB.SEED + 95)
    ksizes = np.clip(np.round(np.exp(krng.uniform(
        np.log(64), np.log(262_144), 256))), 64, 262_144).astype(np.int64)
    kidx = RWIIndex()
    kc = TD.DeviceSegmentStore(kidx, device=dev, packed_residency=True)
    kc.ingest_device_build = True
    kt = TD.DeviceSegmentStore(kidx, device="cpu", packed_residency=True)
    kidx.listener = KB.Fanout(kc, kt)
    kterms = {}
    for i, n_k in enumerate(ksizes):
        f_k, d_k, _h, _r = KB.make_term(int(n_k), KB.SEED + 100 + i)
        kterms[b"k%011d" % i] = (f_k, d_k)
        kidx.add_many(b"k%011d" % i, P.PostingsList(d_k, f_k))
    tq = time.time()
    kidx.flush()
    torch.cuda.synchronize()
    pk_walls[f"flush of 256 terms ({int(ksizes.sum())} rows), card "
             "(K13) and CPU twin (host) packs"] = time.time() - tq
    nwords = 0
    for key, ent in kt._pblocks.items():
        a, b = kc._pblocks[key]["block"], ent["block"]
        nwords += len(a.words)
        if not (np.array_equal(a.words, b.words)
                and np.array_equal(a.meta_vector(), b.meta_vector())):
            fail(f"K13's block of {key[1]!r} differs from the host pack")
    note("pack_block_batch", f"256 blocks, {nwords} words, against the "
         "host pack", 0.0)
    if kc.ingest_device_builds != 256 or len(kt._pblocks) != 256:
        fail(f"K13 packed {kc.ingest_device_builds} of the 256 blocks")
    kq = [b"k%011d" % i for i in (int(np.argmax(ksizes)),
                                  int(np.argsort(ksizes)[128]))]
    for th in kq:
        for kw in ({}, dict(lang_filter=en, from_days=3_000)):
            got = kc.rank_term(th, ds_profiles["default"], k=100, **kw)
            twin = kt.rank_term(th, ds_profiles["default"], k=100, **kw)
            pk_same(f"{th.decode()} {kw} (card, CPU twin)", got, twin)
    kidx.delete_doc(int(got[1][0]))
    pk_same(f"{kq[-1].decode()} after a delete (card, CPU twin)",
            kc.rank_term(kq[-1], ds_profiles["default"], k=100),
            kt.rank_term(kq[-1], ds_profiles["default"], k=100))
    torch.cuda.synchronize()
    TD.scan_query_bp = scan_bp0
    launches_pk = dict(LAUNCHES)
    log(f"packed path: {time.time() - tp:.1f} s; launches {launches_pk}; "
        + ", ".join(f"{k} {v:.1f} s" for k, v in pk_walls.items()))
    log("packed path, exact scans by span rows and route: " + ", ".join(
        f"{n} rows {route} {c}" for (n, route), c in sorted(pk_scans.items())))
    missing = [k for k in PACKED_KERNELS if launches_pk[k] == 0]
    if missing:
        fail(f"kernels never launched on the packed path: {missing}")
    # the biggest row bucket's lanes of that flush, kept for phase 4
    k13_lanes = [th for th in kterms
                 if len(kterms[th][1]) > (1 << 17) and
                 len(kterms[th][1]) <= (1 << 18)]
    kc.close()
    kt.close()
    del kc, kt, kidx, ps, pidx

    # -- phase 3, the BlockRank path: citation-rank postprocessing ---------
    # the port's stores only: BR_DOCS documents over BR_HOSTS hosts,
    # BR_ANCHORS anchors each (kernels/bench.link_docs), into a
    # WebStructureGraph, a WebgraphStore and two equal MetadataStores (the
    # card's and the CPU twin's: postprocessing writes the metadata; the
    # link graphs are only read). Counts reset: power_iterate_sparse over
    # the realistic graph (the ops-level entry point; its ranks equal to
    # phase 2's plain answer to the bit), then postprocessing_p with run=1
    # once with the webgraph empty (the host matrix) and once full (the
    # edges), on the card and with sb.torch_device = "cpu"; the pages and
    # every metadata row equal, the ranks in (0, 1] with the peak 1; then
    # one more document, whose edge rows carry the new cr_host_norm_i
    from yacy_search_server_tpu_torch.document.document import Anchor
    from yacy_search_server_tpu_torch.document.signature import (
        exact_signature, fuzzy_signature)
    from yacy_search_server_tpu_torch.index.metadata import (
        MetadataStore, metadata_from_parsed)
    from yacy_search_server_tpu_torch.index.webgraph import WebgraphStore
    from yacy_search_server_tpu_torch.server.objects import ServerObjects
    from yacy_search_server_tpu_torch.server.servlets import \
        lookup as servlet_lookup
    from yacy_search_server_tpu_torch.utils.hashes import url2hash
    from yacy_search_server_tpu_torch.webstructure import WebStructureGraph
    tbr = time.time()
    br_walls = {}
    br_docs = KB.link_docs(BR_DOCS, BR_HOSTS, BR_ANCHORS)
    br_ws, br_wg = WebStructureGraph(), WebgraphStore()
    br_meta = {"card": MetadataStore(), "cpu": MetadataStore()}
    for url, title, text, links in br_docs:
        fields = dict(host_s=url.split("/")[2], description_txt=text[:16],
                      exact_signature_l=exact_signature(text),
                      fuzzy_signature_l=fuzzy_signature(title))
        for m_ in br_meta.values():
            docid = m_.put(metadata_from_parsed(url2hash(url), url, title,
                                                text, **fields))
        br_wg.add_document_edges(docid, url, [Anchor(u, x, r)
                                              for u, x, r in links])
        br_ws.add_document(url, [u for u, _x, _r in links])
    br_walls["set-up: documents into the stores (host)"] = time.time() - tbr
    post_fn = servlet_lookup("postprocessing_p")
    torch.cuda.synchronize()
    reset_launches()
    tm = time.time()
    tq = time.time()
    r_ops = BRo.power_iterate_sparse(*hg, BRo.DAMPING, len(hg[3]))
    torch.cuda.synchronize()
    br_walls["power_iterate_sparse, realistic graph (card)"] = \
        time.time() - tq
    note("power_iterate", "power_iterate_sparse, the realistic graph, "
         "against phase 2's plain answer", diff(r_ops.cpu(), hg_want))
    pages, segs = {}, {}
    for where in ("card", "cpu"):
        seg = types.SimpleNamespace(webgraph=WebgraphStore(),
                                    metadata=br_meta[where])
        sb = types.SimpleNamespace(index=seg, web_structure=br_ws)
        if where == "cpu":
            sb.torch_device = "cpu"
        for src_label in ("hostmatrix", "webgraph"):
            if src_label == "webgraph":
                seg.webgraph = br_wg
            tq = time.time()
            page = post_fn({}, ServerObjects(
                {"run": "1", "maxhosts": str(BR_MAXHOSTS)}), sb).as_dict()
            if where == "card":
                torch.cuda.synchronize()
            br_walls[f"postprocessing_p run=1, {src_label} ({where})"] = \
                time.time() - tq
            if page.get("source") != src_label:
                fail(f"postprocessing_p: source {page.get('source')}, "
                     f"expected {src_label}")
            if int(page.get("updated", 0)) <= 0 \
                    or int(page.get("hosts", 0)) != BR_MAXHOSTS:
                fail(f"postprocessing_p {src_label}: {page.get('updated')} "
                     f"docs updated, {page.get('hosts')} hosts")
            pages[(where, src_label)] = page
        segs[where] = seg
    torch.cuda.synchronize()
    launches_br = dict(LAUNCHES)
    tq = time.time()
    for src_label in ("hostmatrix", "webgraph"):
        if pages[("card", src_label)] != pages[("cpu", src_label)]:
            fail(f"postprocessing_p {src_label}: the card's page differs "
                 "from the CPU's")
    card_ranks, cpu_ranks = segs["card"]._host_ranks, segs["cpu"]._host_ranks
    if list(card_ranks.items()) != list(cpu_ranks.items()):
        fail("postprocessing_p: the card's host ranks differ from the CPU's")
    if max(card_ranks.values()) != 1.0 \
            or not all(0.0 < v <= 1.0 for v in card_ranks.values()):
        fail("postprocessing_p: ranks outside (0, 1] or a peak other than 1")
    mc, mt = br_meta["card"], br_meta["cpu"]
    rows_differ = sum(mc.get(d_).fields != mt.get(d_).fields
                      for d_ in range(mc.capacity()))
    note("power_iterate", "postprocessing_p: metadata rows that differ "
         "between the card and the CPU", rows_differ)
    if not mc.int_column("cr_host_norm_i").any():
        fail("postprocessing_p wrote no cr_host_norm_i")
    # one more document on the top host, written after the pass: its edge
    # rows carry both endpoints' partitions of the new ranks
    top_host = pages[("card", "webgraph")]["hosts_0_host"]
    url_new = f"http://{top_host}/after-the-pass.html"
    targets = [f"http://{h}/x" for h in list(card_ranks)[:BR_ANCHORS]]
    n0 = br_wg.edge_count_total()
    n_new = br_wg.add_document_edges(
        mc.capacity(), url_new, [Anchor(u, "after") for u in targets],
        host_ranks=segs["card"]._host_ranks)
    bad_rows = 0
    for i in range(n0, n0 + n_new):
        e_ = br_wg.edge(i)
        bad_rows += (e_["source_cr_host_norm_i"]
                     != int(round(cpu_ranks.get(e_["source_host_s"], 0.0)
                                  * 10))
                     or e_["target_cr_host_norm_i"]
                     != int(round(cpu_ranks.get(e_["target_host_s"], 0.0)
                                  * 10)))
    if n_new == 0 or br_wg.edge(n0)["source_cr_host_norm_i"] != 10:
        fail("the document after the pass wrote no edge of its top host")
    note("power_iterate", "edge rows after the pass whose "
         "cr_host_norm_i differs from the CPU ranks'", bad_rows)
    br_walls["checks (host)"] = time.time() - tq
    log(f"BlockRank path: {time.time() - tbr:.1f} s (main path "
        f"{time.time() - tm:.1f} s); launches {launches_br}; "
        f"{br_wg.edge_count_total()} edges, {len(card_ranks)} hosts ranked,"
        f" {pages[('card', 'webgraph')]['updated']} docs updated, "
        f"{pages[('card', 'webgraph')]['uniqueness_updated']} uniqueness "
        f"flags changed; top hosts "
        f"{[pages[('card', 'webgraph')][f'hosts_{i}_host'] for i in range(3)]}"
        "; " + ", ".join(f"{k} {v:.2f} s" for k, v in br_walls.items()))
    missing = [k for k in BLOCKRANK_KERNELS if launches_br[k] == 0]
    if missing:
        fail(f"kernels never launched on the BlockRank path: {missing}")
    del r_ops, br_docs, br_meta, segs

    # -- phase 3, the mesh path: MeshSegmentStore on 2 x 2 cells ----------
    # the smoke's run (17,150,000 rows, the same PostingsList arrays)
    # re-keyed under word2hash of its terms' names, so that they land on
    # both term rows at n_term = 2 (headline, term20000 on row 1; the
    # others on row 0), in a fresh RWIIndex; a MeshSegmentStore with its
    # four cells on the card (budget 8 GiB: the 2 GiB default's worst-case
    # check would skip the run) and its CPU twin on four CPU cells sharing
    # the store's host mirrors (kernels/bench.mesh_twin). Counts reset:
    # the headline term pruned (b = 1), term1000000 escalating, the other
    # terms pruned, a wave of 8 pruned queries through the batcher (held until
    # all 8 are queued, so that both stores form one wave), the four
    # joins (two cross-row, one with an exclude, two column-local), then
    # on term1000000 the language filter, a tombstone (the unfiltered
    # exact scan) and a RAM delta of 50,000 rows; every answer and the
    # counters equal to the twin's; then MeshRanker and MeshBM25 at 2 x 2
    # against the placed step's references
    from yacy_search_server_tpu_torch.index import meshstore as TMS
    from yacy_search_server_tpu_torch.utils.hashes import word2hash
    tmsh = time.time()
    mesh_names = {hl: "headline", b"joinAAAAAAAA": "joinA",
                  b"joinBAAAAAAA": "joinB", b"joinCAAAAAAA": "joinC"}
    for n_t in DS_TERMS:
        mesh_names[b"term%08d" % n_t] = f"term{n_t}"
    mk = {name: word2hash(name) for name in mesh_names.values()}
    rows_of = {name: TMS.term_shard(th, 2) for name, th in mk.items()}
    mi = RWIIndex()
    for th, (f_t, d_t) in ds_terms.items():
        mi.add_many(mk[mesh_names[th]], P.PostingsList(d_t, f_t))
    mi.flush()
    m_walls = {"flush (host)": time.time() - tmsh}
    tq = time.time()
    msh = TMS.MeshSegmentStore(mi, devices=[dev] * 4, n_term=2,
                               budget_bytes=8 << 30)
    m_walls["pack (host mirrors)"] = time.time() - tq
    if msh.live_rows() != sum(len(d_t) for _f, d_t in ds_terms.values()):
        fail(f"mesh store: {msh.live_rows()} rows packed, the run holds "
             f"{sum(len(d_t) for _f, d_t in ds_terms.values())}")
    mtw, m_lis = KB.mesh_twin(msh, ["cpu"] * 4)
    mi.listener = m_lis
    tq = time.time()
    with msh._lock:
        msh._device_cells()
    torch.cuda.synchronize()
    m_walls["device sync (4 cells on the card)"] = time.time() - tq
    tq = time.time()
    with mtw._lock:
        mtw._device_cells()
    m_walls["device sync (the twin)"] = time.time() - tq
    m_prof, m_esc = ds_profiles["default"], ds_profiles["escalating"]
    m_card, m_twin = {}, {}
    m_keys = ("prune_rounds", "pruned_tiles", "fallbacks",
              "batch_dispatches")

    def m_same(label, fn):
        msh._topk_cache.clear()
        mtw._topk_cache.clear()
        tq_ = time.time()
        got = fn(msh)
        m_card[label] = time.time() - tq_
        tq_ = time.time()
        tw = fn(mtw)
        m_twin[label] = time.time() - tq_
        same(f"mesh {label}", got, tw, None)
        if not len(got[0]):
            fail(f"mesh {label}: an empty answer")
        return got

    torch.cuda.synchronize()
    reset_launches()
    tm3 = time.time()
    hl_m = mk["headline"]
    m_same("headline pruned k=100",
           lambda s_: s_.rank_term(hl_m, m_prof, k=100))
    if msh.pruned_tiles == 0:
        fail("mesh: the headline query pruned no tile")
    # the escalating profile on term1000000 (31 tiles: the ladder to
    # b = 64): on the 10M term the twin's plain escalation took 13-18 s
    m_same("term1000000 escalating k=100",
           lambda s_: s_.rank_term(mk["term1000000"], m_esc, k=100))
    m_solo = {}
    for name in ("headline", "term1000000", "term100000", "term20000"):
        m_solo[mk[name]] = m_same(
            f"{name} pruned k=10",
            lambda s_, t_=mk[name]: s_.rank_term(t_, m_prof, k=10))
    # the wave: 8 pruned queries (4 terms x 2) queued before the
    # dispatcher forms its wave (kernels/bench.mesh_wave), on each store
    wave = list(m_solo) * 2
    for s_ in (msh, mtw):
        s_._topk_cache.enabled = False
        s_.enable_batching(max_batch=8)
        tq = time.time()
        ans = KB.mesh_wave(s_, [lambda t_=th: s_.rank_term(t_, m_prof, k=10)
                                for th in wave])
        (m_card if s_ is msh else m_twin)["wave of 8 (batcher)"] = \
            time.time() - tq
        for th, a in zip(wave, ans):
            same("mesh wave", a, m_solo[th], None)
        s_._topk_cache.enabled = True
    mjoins = {"joinA & headline (cross-row)": ([mk["joinA"], hl_m], []),
              "term1000000 & headline - joinB (cross-row)":
                  ([mk["term1000000"], hl_m], [mk["joinB"]]),
              "joinA & joinB (column-local)": ([mk["joinA"], mk["joinB"]],
                                               []),
              "term1000000 & joinC (column-local)":
                  ([mk["term1000000"], mk["joinC"]], [])}
    for label, (inc, exc) in mjoins.items():
        m_same(label, lambda s_, i_=inc, e_=exc: s_.rank_join(
            i_, e_, m_prof, k=100))
    # the language filter, a tombstone and a RAM delta on term1000000: on
    # the 10M term the twin's plain exact scans took 15-18 s each
    m_t1m = mk["term1000000"]
    m_same("term1000000 language de k=100",
           lambda s_: s_.rank_term(m_t1m, m_prof, k=100, lang_filter=0x6465))
    mi.delete_doc(int(m_solo[m_t1m][1][0]))
    m_same("term1000000 after a tombstone (exact scan) k=100",
           lambda s_: s_.rank_term(m_t1m, m_prof, k=100))
    m_delta = KB.make_term(50_000, KB.SEED + 130)[0]
    mi.add_many(m_t1m, P.PostingsList(
        (np.arange(50_000, dtype=np.int32) * 2 + 30_000_001), m_delta))
    m_same("term1000000 with a RAM delta of 50,000 rows k=100",
           lambda s_: s_.rank_term(m_t1m, m_prof, k=100))
    ca, cb = msh.counters(), mtw.counters()
    if {k: ca[k] for k in m_keys} != {k: cb[k] for k in m_keys}:
        fail(f"mesh counters differ: card {[ca[k] for k in m_keys]}, "
             f"twin {[cb[k] for k in m_keys]}")
    if ca["batch_dispatches"] < 1 or ca["fallbacks"]:
        fail(f"mesh: {ca['batch_dispatches']} wave dispatches, "
             f"{ca['fallbacks']} fallbacks")
    clean("mesh path", msh, mtw)
    msh.close()
    mtw.close()
    # MeshRanker and MeshBM25 at 2 x 2 cells of the card
    m22 = M.make_mesh(2, 2, devices=[dev] * 4)
    tq = time.time()
    mr22 = M.MeshRanker(m22, profiles["authority15"])
    s, d = mr22.rank(plist, hostids, k=10)
    m_card["MeshRanker.rank 2x2, 10M, k=10"] = time.time() - tq
    expect("MeshRanker 2x2", s, d, *ref_topk("authority15", 10))
    tq = time.time()
    bs22, bd22 = M.MeshBM25(m22).topk(*bm_in, k=100)
    m_card["MeshBM25.topk 2x2, 1Mx4, k=100"] = time.time() - tq
    if not (np.allclose(bs22, bm_ref[0], rtol=1e-5)
            and np.array_equal(bd22[bm_ref[2]], bm_ref[1][bm_ref[2]])):
        fail("MeshBM25 2x2 differs from the one-cell answer")
    torch.cuda.synchronize()
    launches_mesh = dict(LAUNCHES)
    missing = [k for k in MESH_KERNELS if launches_mesh[k] == 0]
    per_row = {r: sum(len(ds_terms[th][1]) for th in mesh_names
                      if rows_of[mesh_names[th]] == r) for r in (0, 1)}
    log(f"mesh path: {time.time() - tmsh:.1f} s ({time.time() - tm3:.1f} s"
        f" of queries); rows a term row {per_row}; "
        f"cells' rows {[c.used for c in msh._cells]}; counters "
        f"{ {k: ca[k] for k in m_keys} }; launches "
        f"{ {k: v for k, v in launches_mesh.items() if v} }; "
        + ", ".join(f"{k} {v:.2f} s" for k, v in m_walls.items()))
    for label in m_card:
        log(f"  mesh wall {label}: card {m_card[label] * 1e3:.2f} ms"
            + (f", twin {m_twin[label] * 1e3:.1f} ms" if label in m_twin
               else ""))
    if missing:
        fail(f"kernels never launched on the mesh path: {missing}")
    m_keep = (msh, hl_m, mk)        # phase 4 times the mesh kernels on it
    del mtw, m_lis

    # -- phase 4: kernel times at the main path's shapes ---------------------
    log(f"phase 3: done at {time.time() - t0:.1f} s")
    # `ms`: the call time, the median of 20 calls each between two CUDA
    # events from an idle queue (the device time plus the host's issue
    # time); `device_ms`: the median of 20 calls queued
    # behind a spin kernel, so that the host's issue time is not counted.
    # The shapes of MeshRanker.rank_placed, which makes 50 of the 57
    # score/stats launches and 50 of the 63 top-k launches: the int32
    # block under authority=15 with one host bin per padded row, and
    # tie_topk in tie mode on that step's scores, keyed on the docids
    (pf, pd, pv, ph), npad = placed[0][0], placed[1]
    pst, pcnt = KC.cardinal_stats(pf, pv, ph, npad)
    p_scores = KC.cardinal_score(pf, None, pv, ph, pst, pcnt, mr._consts[0],
                                 False)
    hosts_used = int(torch.unique(ph[pv]).numel())
    c0 = consts["default"]
    st, cnt = KC.cardinal_stats(f16_d, v_d, h_d, 0)
    # the default profile's scores of the compact block (CardinalRanker,
    # the streaming path), whose top digit holds half the rows
    sc16 = KC.cardinal_score(f16_d, fl_d, v_d, h_d, st, cnt, c0, True)
    # kernel 3 on the very inputs it is timed on (launches after the main
    # path's run do not count)
    for k in (10, 100, 1000):
        check_topk(f"rank_placed scores n={npad}", p_scores, k, pd)
        check_topk("compact default-profile scores", sc16, k, d_d)
    # one shard's sorted run (its local tie_topk) of 100 f32 rows, as
    # rank_placed's fusion hands it to kernel 4 in two columns
    bm, bd, _ = KT.tie_topk_plain(
        torch.from_numpy(rng.random(100).astype(np.float32)).to(dev), 100,
        secondary=d_d[:100])
    g_s, g_d = bm.view(torch.int32), bd
    n16 = N * P.NF * 2
    n32 = npad * P.NF * 4
    rows = []
    timed = []  # each row's kernel call, traced once all timing is done

    def ops_per_call(fn):
        """The device operations one call issues (kernels and memsets) with
        their device times, from a profiler trace; None where the trace
        shows none."""
        try:
            names = KB.device_ops(fn)
        except Exception as ex:  # noqa: BLE001 - a reading aid, not a phase
            return None, [f"profiler failed: {ex!r}"]
        return len(names) or None, names

    def measure(name, replaces, src, kern, plain, lib, nbytes, nops, shape,
                path="placed", plain_reps=3, plain_ms=None, slots=None):
        # plain_ms: the plain version's time from its one checked call
        ms, dev_ms = KB.call_ms(kern), KB.device_ms(kern)
        if plain_ms is None:
            plain_ms = KB.call_ms(plain, reps=plain_reps)
        lib_ms = KB.call_ms(lib) if lib is not None else None
        lib_dev = KB.device_ms(lib) if lib is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        log(f"kernel {name} [{shape}]: {ms:.4f} ms a call (device "
            f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms"
            f", bound {bound:.4f} ms ({nbytes} bytes / 3.35 TB/s"
            f"{'' if not nops else f', {nops:.0f} ops / 67 Tops/s'})"
            + (f", library {lib_ms:.4f} ms a call (device {lib_dev:.4f} ms)"
               if lib_ms is not None else ""))
        timed.append(kern)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"yacy_search_server_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": {"placed": launches, "devstore": launches_ds,
                         "join": launches_join, "batched": launches_bt,
                         "batched_join": launches_bj,
                         "hybrid": launches_hy,
                         "dense_first": launches_df,
                         "packed": launches_pk,
                         "blockrank": launches_br,
                         "mesh": launches_mesh}[path][name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev, "shape": shape, "path": path,
            "slots": slots})

    def gather_work(m, run_len, k):
        """kernel 4's bytes (8 a row in, 8 a winner out) and the merge's
        comparisons: m * ceil(log2 run_len) for each other run"""
        runs = m // run_len
        return (8 * m + 8 * k,
                m * (runs - 1) * math.ceil(math.log2(run_len))
                if runs > 1 else 0)

    def topk_bytes(sc, k, mode, ids):
        """The bytes tie_topk must move: the scores, in tie mode the docids
        of the rows whose score equals the k-th (only those are ranked by
        docid), and 16 a winner (its payload in, three words out)."""
        if mode == "index":
            return 4 * sc.numel() + 16 * k
        kth = KT.tie_topk_plain(sc, k, secondary=ids)[0][-1]
        return 4 * sc.numel() + 4 * int((sc == kth).sum()) + 16 * k

    def log_trace(label):
        passes = KB.topk_trace()
        if passes:
            log(f"tie_topk passes [{label}]: {passes}")

    def topk_fns(sc, k, mode, ids):
        sec = ids if mode == "tie" else None
        pay = None if mode == "tie" else ids
        return (lambda: KT.tie_topk(sc, k, secondary=sec, payload=pay),
                lambda: KT.tie_topk_plain(sc, k, secondary=sec, payload=pay),
                lambda: torch.topk(sc, k))

    stats_src = ("cardinal_stats", "yacy_search_server_tpu/ops/ranking.py:193",
                 "cardinal_stats.cu")
    score_src = ("cardinal_score", "yacy_search_server_tpu/ops/ranking.py:242",
                 "cardinal_score.cu")
    topk_src = ("tie_topk", "yacy_search_server_tpu/parallel/mesh.py:115",
                "tie_topk.cu")
    # one row per kernel at the main path's dominant shape ...
    measure(*stats_src,
            lambda: KC.cardinal_stats(pf, pv, ph, npad),
            lambda: KC.cardinal_stats_plain(pf, pv, ph, npad), None,
            n32 + npad + 4 * npad + 4 * npad + KC.STATS_LEN * 4, 0.0,
            f"{npad} x 17 int32 + valid + host ids, {npad} host bins "
            "(rank_placed, authority=15)")
    measure(*score_src,
            lambda: KC.cardinal_score(pf, None, pv, ph, pst, pcnt,
                                      mr._consts[0], False),
            lambda: KC.cardinal_score_plain(pf, None, pv, ph, pst, pcnt,
                                            mr._consts[0], False), None,
            n32 + npad + 4 * npad + 4 * npad + 4 * hosts_used
            + (KC.STATS_LEN + KC.CONSTS_LEN) * 4, 0.0,
            f"{npad} x 17 int32 + valid + host ids -> int32, authority=15 "
            f"over {npad} host bins ({hosts_used} used) (rank_placed)")
    measure(*topk_src, *topk_fns(p_scores, 100, "tie", pd),
            topk_bytes(p_scores, 100, "tie", pd), 0.0,
            f"{npad} int32 scores of rank_placed, k=100, tie mode (docids)")
    log_trace("rank_placed, k=100, tie mode")
    gather_src = ("gather_topk", "yacy_search_server_tpu/parallel/mesh.py:147",
                  "gather_topk.cu")
    measure(*gather_src,
            lambda: KT.gather_topk(g_s, g_d, 100, True, run_len=100),
            lambda: KT.gather_topk_plain(g_s, g_d, 100, True, run_len=100),
            None, *gather_work(100, 100, 100),
            "one shard's sorted run of 100 f32 rows, k=100 (two columns)")
    # the floor of a call that the 1,600-byte bound cannot show
    e_call, e_dev = KB.call_ms(KB.empty_launch), KB.device_ms(KB.empty_launch)
    log(f"empty kernel launch: {e_call:.4f} ms a call (device {e_dev:.4f} "
        "ms)")
    # the multi-card merge's shapes: 8 and 16 cards' sorted runs of 1000
    for shards in (8, 16):
        blk = KB.sorted_runs(shards, 1000, False, rng).to(dev)
        measure(*gather_src,
                lambda b=blk: KT.gather_topk(b[:, 0], b[:, 1], 1000, False,
                                             run_len=1000),
                lambda b=blk: KT.gather_topk_plain(b[:, 0], b[:, 1], 1000,
                                                   False, run_len=1000),
                None, *gather_work(shards * 1000, 1000, 1000),
                f"{shards} sorted int32 runs x 1000 rows ([m, 2] block), "
                "k=1000")
    for row in rows:
        if row["name"] == "gather_topk":
            row["empty_launch_ms"] = e_call
            row["empty_launch_device_ms"] = e_dev
    # ... and extra rows: the compact shapes, and tie_topk at every k in
    # both modes, beside torch.topk
    measure(*stats_src,
            lambda: KC.cardinal_stats(f16_d, v_d, h_d, 0),
            lambda: KC.cardinal_stats_plain(f16_d, v_d, h_d, 0), None,
            n16 + N + KC.STATS_LEN * 4 + 4, 0.0,
            "10M x 17 int16 + valid, no host counts (default profile)")
    # the host counts under skew: rank_placed's block with its host ids
    # drawn Zipf (s = 1.1) over 50,000 hosts, and all on one host
    for mix, hosts in (("zipf", "Zipf over 50,000 hosts"),
                       ("one", "all on one host")):
        hm = put(KB.host_mix(mix, npad, rng))
        check_stats(f"int32 rank_placed, host ids {hosts}", pf, pv, hm, npad)
        measure(*stats_src,
                lambda h=hm: KC.cardinal_stats(pf, pv, h, npad),
                lambda h=hm: KC.cardinal_stats_plain(pf, pv, h, npad), None,
                n32 + npad + 4 * npad + 4 * npad + KC.STATS_LEN * 4, 0.0,
                f"{npad} x 17 int32 + valid + host ids, {npad} host bins, "
                f"host ids {hosts}")
    measure(*score_src,
            lambda: KC.cardinal_score(f16_d, fl_d, v_d, h_d, st, cnt, c0,
                                      True),
            lambda: KC.cardinal_score_plain(f16_d, fl_d, v_d, h_d, st, cnt,
                                            c0, True), None,
            n16 + 4 * N + N + 4 * N, 0.0,
            "10M compact rows + flags + valid -> int32 scores")
    for mode in ("tie", "index"):
        for k in (10, 100, 1000):
            if mode == "tie" and k == 100:
                continue
            measure(*topk_src, *topk_fns(p_scores, k, mode, pd),
                    topk_bytes(p_scores, k, mode, pd), 0.0,
                    f"{npad} int32 scores of rank_placed, k={k}, {mode} mode")
    # the compact block's default-profile scores; index mode, docids as
    # payload
    measure(*topk_src, *topk_fns(sc16, 100, "index", d_d),
            topk_bytes(sc16, 100, "index", d_d), 0.0,
            "10M int32 scores of the compact block, default profile, k=100, "
            "index mode")
    log_trace("compact default profile, k=100, index mode")

    # the device store's kernels at the shapes of rank_term's queries on a
    # fresh store holding the 10M term alone (the main path's store has a
    # tombstone, which turns pruning off): K5 at bs = 1 and at bs = 16
    # (slots on the span's first 16 tiles), K7 over the escalating
    # profile's prefix, and the exact scan's K6, K7, kernel 3 and
    # topk_finish over the 10M rows; each checked first on the inputs it
    # is timed on
    ti = RWIIndex()
    ti.add_many(hl, P.PostingsList(docids, feats))
    ti.flush()
    ts = TD.DeviceSegmentStore(ti, device=dev)
    sp = ts.spans_for(hl)[0]
    ta = (*ts.arena.arrays(), ts.arena.dead_array(), ts.arena._pmax)
    cd = ds_consts["default"]
    shift, lterm = (int(v) for v in TD.prune_bound_consts(
        ds_profiles["default"]))
    kk = 128                               # rank_term's kk at k = 100
    src_k5 = ("pruned_tile", "yacy_search_server_tpu/index/devstore.py:897",
              "pruned_tile.cu")
    src_k6 = ("span_stats", "yacy_search_server_tpu/index/devstore.py:338",
              "cardinal_stats.cu")
    src_k7 = ("span_score", "yacy_search_server_tpu/index/devstore.py:338",
              "cardinal_score.cu")
    src_fin = ("topk_finish", "yacy_search_server_tpu/index/devstore.py:799",
               "pruned_tile.cu")
    row_b = P.NF * 2 + 4 + 4 + 1      # features, flags, docid, dead byte
    for bs in (1, 16):
        desc = KD.pack_desc(KB.tile_slots(sp, bs), shift, lterm)
        k5 = lambda d=desc: KD.pruned_tile(*ta, d, kk, cd, True)  # noqa: E731
        k5p = lambda d=desc: KD.pruned_tile_plain(*ta, d, kk, cd,  # noqa: E731
                                                  True)
        g, w = k5(), k5p()
        torch.cuda.synchronize()
        note("pruned_tile", f"10M term bs={bs} kk={kk}", diff(g, w))
        measure(*src_k5, k5, k5p, None,
                bs * (TD.TILE * row_b + 4 * (sp.tcount - 1)
                      + 4 * KD.DESC_SLOT_WORDS + 4 * (2 * kk + 1))
                + 8 + 4 * KC.CONSTS_LEN, 0.0,
                f"{bs} slot(s) x one 32,768-row tile of the 10M term, "
                f"kk={kk}, {sp.tcount}-tile pmax tail (rank_term, pruned)",
                path="devstore", slots=bs)
    esc_end = ends["10M escalating k=100"]
    b_esc = (int(esc_end[2:]) if esc_end.startswith("b=")
             else TD._PRUNE_B[-1])
    ext_p = [(sp.start, min(sp.count, b_esc * TD.TILE))]
    frozen = put(sp.stats38())
    ce = ds_consts["escalating"]
    scan_ext = [(sp.start, sp.count)]
    st10 = KD.span_stats(ta[0], ta[2], ta[3], scan_ext)
    note("span_stats", "10M term", stats_diff(
        st10, KD.span_stats_plain(ta[0], ta[2], ta[3], scan_ext)))
    for label, ext, st_x, c_x in (
            (f"escalating prefix of {b_esc} tiles", ext_p, frozen, ce),
            ("exact scan", scan_ext, st10, cd)):
        n_x = ext[0][1]
        k7 = lambda e=ext, s_=st_x, c_=c_x, n_=n_x: (  # noqa: E731
            KD.span_score(*ta[:4], e, s_, c_, n_))
        k7p = lambda e=ext, s_=st_x, c_=c_x, n_=n_x: (  # noqa: E731
            KD.span_score_plain(*ta[:4], e, s_, c_, n_))
        g, w = k7(), k7p()
        torch.cuda.synchronize()
        note("span_score", f"10M term, {label}", diff(g, w))
        measure(*src_k7, k7, k7p, None,
                n_x * (row_b + 4) + 4 * (KC.STATS_LEN + KC.CONSTS_LEN), 0.0,
                f"{n_x} rows of the 10M term in place ({label})",
                path="devstore")
    measure(*src_k6, lambda: KD.span_stats(ta[0], ta[2], ta[3], scan_ext),
            lambda: KD.span_stats_plain(ta[0], ta[2], ta[3], scan_ext), None,
            sp.count * (P.NF * 2 + 4 + 1) + 4 * KC.STATS_LEN, 0.0,
            f"{sp.count} rows of the 10M term in place (exact scan)",
            path="devstore")
    buf10 = KD.span_score(*ta[:4], scan_ext, st10, cd, sp.count)
    check_topk("exact scan buffer of the 10M term", buf10, kk,
               ta[2][sp.start:sp.start + sp.count])
    measure(*topk_src, *topk_fns(buf10, kk, "index", None),
            4 * sp.count + 16 * kk, 0.0,
            f"{sp.count} int32 scores of the exact scan, k={kk}, index mode",
            path="devstore")
    top_s, top_r, _ = KT.tie_topk(buf10, kk)
    for label, kw in (("the exact scan's statistics", dict(stats=st10)),
                      ("the tail check of a 1-tile prefix", dict(
                          pmax=ta[4], tail=(sp.tstart, 1, sp.tcount, shift,
                                            lterm)))):
        fin = lambda kw=kw: KD.topk_finish(top_s, top_r, ta[2],  # noqa: E731
                                           scan_ext, **kw)
        finp = lambda kw=kw: KD.topk_finish_plain(  # noqa: E731
            top_s, top_r, ta[2], scan_ext, **kw)
        g, w = fin(), finp()
        torch.cuda.synchronize()
        note("topk_finish", f"10M term, kk={kk}, {label}", diff(g, w))
        extra = (4 * (2 * P.NF + 2) if "stats" in kw
                 else 4 * (sp.tcount - 1))
        measure(*src_fin, fin, finp, None,
                kk * 12 + 4 * g.numel() + extra, 0.0,
                f"kk={kk} winners of the 10M term's exact scan, {label}",
                path="devstore")
    del buf10

    # K6 and K7 under the filtered rank_term's filter over the 10M term
    # (K7 on statistics handed in, as a filtered-stats cache hit runs it)
    stf = KD.span_stats(ta[0], ta[2], ta[3], scan_ext, flags=ta[1],
                        filt=hfilt)
    note("span_stats", "10M term, filtered", stats_diff(
        stf, KD.span_stats_plain(ta[0], ta[2], ta[3], scan_ext, flags=ta[1],
                                 filt=hfilt)))
    measure(*src_k6, lambda: KD.span_stats(ta[0], ta[2], ta[3], scan_ext,
                                           flags=ta[1], filt=hfilt),
            lambda: KD.span_stats_plain(ta[0], ta[2], ta[3], scan_ext,
                                        flags=ta[1], filt=hfilt), None,
            sp.count * (P.NF * 2 + 4 + 4 + 1) + 4 * KC.STATS_LEN, 0.0,
            f"{sp.count} rows of the 10M term in place, filter lang en, flag "
            "5, days 3000-27000 (filtered exact scan, cold)", path="join")
    k7f = lambda: KD.span_score(*ta[:4], scan_ext, stf, cd,  # noqa: E731
                                sp.count, filt=hfilt)
    k7fp = lambda: KD.span_score_plain(*ta[:4], scan_ext, stf,  # noqa: E731
                                       cd, sp.count, filt=hfilt)
    g, w = k7f(), k7fp()
    torch.cuda.synchronize()
    note("span_score", "10M term, filtered", diff(g, w))
    measure(*src_k7, k7f, k7fp, None,
            sp.count * (row_b + 4) + 4 * (KC.STATS_LEN + KC.CONSTS_LEN), 0.0,
            f"{sp.count} rows of the 10M term in place, the same filter, "
            "statistics handed in (filtered exact scan, cache hit)",
            path="join")

    # the packed path's kernels at its shapes, each checked first on the
    # inputs it is timed on, each beside its int16 counterpart's call time
    # at the same shape (`int16_ms`; no PyTorch call computes a bit-unpack,
    # so `library_ms` is null): K12 over every row of the 10M term's block
    # as the packed store held it (against the host unpack_block too), K5bp
    # at 1 slot and at a 16-slot wave of that block's first tile, K6bp, K7bp
    # and topk_finish_bp over the 10M term, without and with the filtered
    # rank_term's filter, and K13 over the 2^18-row bucket's lanes of the
    # 256-term flush
    pw, pdead, ppmax, psp, pblk = pk_keep
    pbytes = psp.row_bits / 8 + 1          # packed payload + a dead byte
    # K6bp's: every feature column and the docids, the flags column only
    # where the filter tests a flag, and a dead byte
    pwid = np.asarray(psp.pmeta[PK.NCOLS:2 * PK.NCOLS])

    def k6bytes(q):
        flags = q is not None and q[1] != KD.NO_FLAG
        return (int(pwid.sum()) - (0 if flags else int(pwid[PK.C_FLAGS]))) \
            / 8 + 1
    # K7bp's: the scored columns (not the doctype nor the flags feature
    # column), the flags and the docids, and a dead byte
    k7bytes = (int(pwid.sum()) - int(pwid[4]) - int(pwid[P.F_FLAGS])) / 8 + 1
    src_k12 = ("unpack_rows", "yacy_search_server_tpu/ops/packed.py:205",
               "packed.cu")
    src_k5bp = ("pruned_tile_bp",
                "yacy_search_server_tpu/index/devstore.py:1151",
                "pruned_tile.cu")
    src_k6bp = ("span_stats_bp",
                "yacy_search_server_tpu/index/devstore.py:1213",
                "cardinal_stats.cu")
    src_k7bp = ("span_score_bp",
                "yacy_search_server_tpu/index/devstore.py:1213",
                "cardinal_score.cu")
    src_k7sel = ("span_topk_bp",
                 "yacy_search_server_tpu/index/devstore.py:1213",
                 "cardinal_score.cu")
    src_finbp = ("topk_finish_bp",
                 "yacy_search_server_tpu/index/devstore.py:1213",
                 "pruned_tile.cu")
    src_k13 = ("pack_block_batch",
               "yacy_search_server_tpu/ingest/devbuild.py:71", "packed.cu")

    def beside(fn, shape):
        """The int16 counterpart's call time on the last measured row."""
        rows[-1]["int16_ms"] = KB.call_ms(fn)
        rows[-1]["int16_shape"] = shape
        log(f"  int16 counterpart [{shape}]: {rows[-1]['int16_ms']:.4f} ms "
            "a call")

    n10 = psp.count
    k12 = lambda: KP.unpack_rows(pw, psp.pbase, psp.pmeta, 0, n10)  # noqa: E731
    g12 = k12()
    want12 = PK.unpack_block(pblk)
    torch.cuda.synchronize()
    note("unpack_rows", "the 10M term's block against the host unpack_block",
         max(float(np.abs(g12[0].cpu().numpy() - want12[0].astype(np.int32))
                   .max()),
             float(np.abs(g12[1].cpu().numpy().astype(np.int64)
                          - want12[1]).max()),
             float(np.abs(g12[2].cpu().numpy().astype(np.int64)
                          - want12[2]).max())))
    w12 = KP.unpack_rows_plain(pw, psp.pbase, psp.pmeta, 0, 300_000)
    note("unpack_rows", "the block's first 300,000 rows against the plain "
         "decode", max(diff(a[:300_000], b) for a, b in zip(g12, w12)))
    del g12, want12, w12
    measure(*src_k12, k12,
            lambda: KP.unpack_rows_plain(pw, psp.pbase, psp.pmeta, 0, n10),
            None, n10 * (psp.row_bits / 8 + 76), 0.0,
            f"{n10} rows of the 10M term's block ({psp.row_bits} bits a "
            "row) -> int32 feats, flags, docids", path="packed",
            plain_reps=1)
    beside(lambda: (ta[0][sp.start:sp.start + n10].to(torch.int32),
                    ta[1][sp.start:sp.start + n10].clone(),
                    ta[2][sp.start:sp.start + n10].clone()),
           "the same rows' int16 features widened to int32, flags and "
           "docids copied")
    for bs in (1, 16):
        slot = (psp.pbase, psp.count, psp.tstart, psp.tcount,
                psp.stats["col_min"], psp.stats["col_max"],
                psp.stats["tf_min"], psp.stats["tf_max"])
        desc = KP.pack_desc_bp([slot] * bs, [psp.pmeta] * bs, shift, lterm)
        k5 = lambda d=desc: KP.pruned_tile_bp(pw, pdead, ppmax, d, kk,  # noqa: E731
                                              cd)
        k5p = lambda d=desc: KP.pruned_tile_bp_plain(  # noqa: E731
            pw, pdead, ppmax, d, kk, cd)
        g, w = k5(), k5p()
        torch.cuda.synchronize()
        note("pruned_tile_bp", f"10M term's block bs={bs} kk={kk}",
             diff(g, w))
        measure(*src_k5bp, k5, k5p, None,
                TD.TILE * pbytes + 4 * (psp.tcount - 1)
                + bs * (4 * KP.BP_SLOT_WORDS + 4 * (2 * kk + 1))
                + 4 * KC.CONSTS_LEN, 0.0,
                f"{bs} slot(s) of the 10M term's block, its first "
                f"32,768-row tile decoded ({psp.row_bits} bits a row), "
                f"kk={kk}, {psp.tcount}-tile pmax tail", path="packed",
                slots=bs)
        d16 = KD.pack_desc([(sp.start, sp.count, sp.tstart, sp.tcount,
                             sp.stats["col_min"], sp.stats["col_max"],
                             sp.stats["tf_min"], sp.stats["tf_max"])] * bs,
                           shift, lterm)
        beside(lambda d=d16: KD.pruned_tile(*ta, d, kk, cd, False),
               f"K5, {bs} slot(s) of the 10M term's first int16 tile")
    for label, q, st_i16 in (("no filter", None, st10), ("the filtered "
                             "rank_term's filter", hfilt, stf)):
        st_bp = KP.span_stats_bp(pw, pdead, psp.pbase, psp.pmeta, n10, q)
        note("span_stats_bp", f"10M term's block, {label}", stats_diff(
            st_bp, KP.span_stats_bp_plain(pw, pdead, psp.pbase, psp.pmeta,
                                          n10, q)))
        measure(*src_k6bp,
                lambda q=q: KP.span_stats_bp(pw, pdead, psp.pbase,
                                             psp.pmeta, n10, q),
                lambda q=q: KP.span_stats_bp_plain(pw, pdead, psp.pbase,
                                                   psp.pmeta, n10, q),
                None, n10 * k6bytes(q) + 4 * KC.STATS_LEN, 0.0,
                f"{n10} rows of the 10M term's block, {label} (the packed "
                "exact scan)", path="packed", plain_reps=1)
        beside(lambda q=q: KD.span_stats(ta[0], ta[2], ta[3], scan_ext,
                                         flags=ta[1], filt=q),
               f"K6 over the same int16 rows, {label}")
        k7s = lambda q=q, s_=st_bp: KP.span_topk_bp(  # noqa: E731
            pw, pdead, psp.pbase, psp.pmeta, n10, s_, cd, kk, q)
        k7sp = lambda q=q, s_=st_bp: KP.span_topk_bp_plain(  # noqa: E731
            pw, pdead, psp.pbase, psp.pmeta, n10, s_, cd, kk, q)
        note("span_topk_bp", f"10M term's block, kk={kk}, {label}",
             diff(k7s(), k7sp()))
        measure(*src_k7sel, k7s, k7sp, None,
                n10 * k7bytes + 4 * (KC.STATS_LEN + KC.CONSTS_LEN) + 8 * kk,
                0.0, f"{n10} rows of the 10M term's block -> its kk={kk} "
                f"best, docids decoded, {label} (the packed exact scan's "
                "second pass)", path="packed", plain_reps=1)

        def i16_select(q=q, s_=st_i16):
            t_ = KT.tie_topk(KD.span_score(*ta[:4], scan_ext, s_, cd,
                                           sp.count, filt=q), kk)
            return KD.topk_finish(t_[0], t_[1], ta[2], scan_ext, stats=s_)
        beside(i16_select, f"K7, kernel 3 and topk_finish over the same "
               f"int16 rows, {label}")
        k7 = lambda q=q, s_=st_bp: KP.span_score_bp(  # noqa: E731
            pw, pdead, psp.pbase, psp.pmeta, n10, s_, cd, n10, q)
        buf = k7()
        note("span_score_bp", f"10M term's block, {label}", diff(
            buf, KP.span_score_bp_plain(pw, pdead, psp.pbase, psp.pmeta,
                                        n10, st_bp, cd, n10, q)))
        measure(*src_k7bp, k7,
                lambda q=q, s_=st_bp: KP.span_score_bp_plain(
                    pw, pdead, psp.pbase, psp.pmeta, n10, s_, cd, n10, q),
                None, n10 * (k7bytes + 4)
                + 4 * (KC.STATS_LEN + KC.CONSTS_LEN), 0.0,
                f"{n10} rows of the 10M term's block -> int32 scores, "
                f"{label} (K7bp's buffer, past its selection's kk)",
                path="packed", plain_reps=1)
        beside(lambda q=q, s_=st_i16: KD.span_score(
            *ta[:4], scan_ext, s_, cd, sp.count, filt=q),
            f"K7 over the same int16 rows, {label}")
        top_s, top_r, _ = KT.tie_topk(buf, kk)
        fin = lambda a=top_s, b=top_r: KP.topk_finish_bp(  # noqa: E731
            a, b, pw, psp.pbase, psp.pmeta, n10)
        g = fin()
        note("topk_finish_bp", f"10M term's block, kk={kk}, {label}", diff(
            g, KP.topk_finish_bp_plain(top_s, top_r, pw, psp.pbase,
                                       psp.pmeta, n10)))
        measure(*src_finbp, fin,
                lambda a=top_s, b=top_r: KP.topk_finish_bp_plain(
                    a, b, pw, psp.pbase, psp.pmeta, n10), None,
                kk * (8 + 8 + 8), 0.0,
                f"kk={kk} winners of the 10M term's packed scan, {label}, "
                "docids decoded", path="packed")
        i16_top = KT.tie_topk(KD.span_score(*ta[:4], scan_ext, st_i16, cd,
                                            sp.count, filt=q), kk)
        beside(lambda a=i16_top: KD.topk_finish(a[0], a[1], ta[2], scan_ext,
                                                stats=st_i16),
               f"topk_finish over the int16 scan's winners, {label}")
        del buf
    # K13 over the 2^18-row bucket's lanes of the 256-term flush (the
    # rows in arrival order: the pack's cost does not depend on it)
    nb13 = len(k13_lanes)
    f13 = np.zeros((nb13, 1 << 18, P.NF), np.int16)
    fl13 = np.zeros((nb13, 1 << 18), np.int32)
    dd13 = np.zeros((nb13, 1 << 18), np.int32)
    n13 = np.zeros(nb13, np.int32)
    for j_, th in enumerate(k13_lanes):
        f_k, d_k = kterms[th]
        c16, cfl = R.compact_feats(f_k)
        m_ = len(d_k)
        f13[j_, :m_], fl13[j_, :m_], dd13[j_, :m_], n13[j_] = c16, cfl, d_k, m_
    a13 = [put(a) for a in (f13, fl13, dd13, n13)]
    k13 = lambda: KP.pack_block_batch(*a13)  # noqa: E731
    g, w = k13(), KP.pack_block_batch_plain(*a13)
    torch.cuda.synchronize()
    note("pack_block_batch", f"{nb13} lanes of 2^18 rows",
         max(diff(a, b) for a, b in zip(g, w)))
    words13 = int(g[2].sum())
    measure(*src_k13, k13, lambda: KP.pack_block_batch_plain(*a13), None,
            int(n13.sum()) * (P.NF * 2 + 8) + 4 * words13
            + 4 * nb13 * (PK.META_LEN + 1), 0.0,
            f"{nb13} blocks of {int(n13.min())}-{int(n13.max())} rows in "
            f"2^18-row lanes ({int(n13.sum())} rows -> {words13} words; "
            "the 256-term flush's biggest bucket)", path="packed",
            plain_reps=1)
    beside(lambda: [a.clone() for a in a13[:3]],
           "a device copy of the same lanes' int16 rows (the int16 arena's "
           "write)")
    del g, w, f13, fl13, dd13         # a13 stays for the trace below

    # K6 and K7 with a RAM delta block of 50,000 and of 300,000 rows (new
    # docids, staged as the store stages them) after the 10M term's rows,
    # and with the 2 % facet bitmap, alone and under the language filter
    # (the bitmap's words read once: those the live docids hit)
    for n_d in (50_000, 300_000):
        dblk = convert.delta_from_numpy(*KB.delta_block(
            n_d, (2 * np.arange(n_d)).astype(np.int32), KB.SEED + 60), dev)
        nb = dblk[2].shape[0]
        k6d = lambda dl=dblk: KD.span_stats(  # noqa: E731
            ta[0], ta[2], ta[3], scan_ext, flags=ta[1], delta=dl)
        k6dp = lambda dl=dblk: KD.span_stats_plain(  # noqa: E731
            ta[0], ta[2], ta[3], scan_ext, flags=ta[1], delta=dl)
        st_d = k6d()
        note("span_stats", f"10M term + a delta of {n_d}",
             stats_diff(st_d, k6dp()))
        measure(*src_k6, k6d, k6dp, None,
                (sp.count + nb) * (P.NF * 2 + 4 + 1) + 4 * KC.STATS_LEN, 0.0,
                f"{sp.count} rows of the 10M term in place + a RAM delta of "
                f"{n_d} ({nb} rows staged) (exact scan with a delta)",
                path="batched")
        k7d = lambda dl=dblk, s_=st_d, n_=sp.count + nb: KD.span_score(  # noqa: E731
            *ta[:4], scan_ext, s_, cd, n_, delta=dl)
        k7dp = lambda dl=dblk, s_=st_d, n_=sp.count + nb: (  # noqa: E731
            KD.span_score_plain(*ta[:4], scan_ext, s_, cd, n_, delta=dl))
        g, w = k7d(), k7dp()
        torch.cuda.synchronize()
        note("span_score", f"10M term + a delta of {n_d}", diff(g, w))
        measure(*src_k7, k7d, k7dp, None,
                (sp.count + nb) * (row_b + 4)
                + 4 * (KC.STATS_LEN + KC.CONSTS_LEN), 0.0,
                f"{sp.count} rows of the 10M term in place + a RAM delta of "
                f"{n_d} ({nb} rows staged) (exact scan with a delta)",
                path="batched")
    words10 = np.zeros(1 << 20, np.uint32)
    np.bitwise_or.at(words10, fac_ids >> 5,
                     np.uint32(1) << (fac_ids & 31).astype(np.uint32))
    allow10 = convert.bitmap_from_numpy(words10, dev)
    hit_words = int(np.unique(docids >> 5).size)
    for label, filt in (("facet bitmap 2 %", None),
                        ("facet bitmap 2 %, lang en", en_only)):
        k6b = lambda f_=filt: KD.span_stats(  # noqa: E731
            ta[0], ta[2], ta[3], scan_ext, flags=ta[1], filt=f_,
            allow=allow10)
        k6bp = lambda f_=filt: KD.span_stats_plain(  # noqa: E731
            ta[0], ta[2], ta[3], scan_ext, flags=ta[1], filt=f_,
            allow=allow10)
        st_b = k6b()
        note("span_stats", f"10M term, {label}", stats_diff(st_b, k6bp()))
        measure(*src_k6, k6b, k6bp, None,
                sp.count * (P.NF * 2 + 4 + 1) + 4 * hit_words
                + 4 * KC.STATS_LEN, 0.0,
                f"{sp.count} rows of the 10M term in place, {label} "
                f"({hit_words} bitmap words hit)", path="batched")
        k7b = lambda f_=filt, s_=st_b: KD.span_score(  # noqa: E731
            *ta[:4], scan_ext, s_, cd, sp.count, filt=f_, allow=allow10)
        k7bp = lambda f_=filt, s_=st_b: KD.span_score_plain(  # noqa: E731
            *ta[:4], scan_ext, s_, cd, sp.count, filt=f_, allow=allow10)
        g, w = k7b(), k7bp()
        torch.cuda.synchronize()
        note("span_score", f"10M term, {label}", diff(g, w))
        measure(*src_k7, k7b, k7bp, None,
                sp.count * (row_b + 4) + 4 * hit_words
                + 4 * (KC.STATS_LEN + KC.CONSTS_LEN), 0.0,
                f"{sp.count} rows of the 10M term in place, {label}",
                path="batched")

    # K8 at the joinA & headline shape of the join path's store (its arena
    # rows and join tables are where the join path left them): 4M rare
    # rows against the headline term's bitmap, beside torch.searchsorted
    # and a gather of the partner rows on the headline's sorted segment
    rare, k8_parts, k8_inc = join_shapes["joinA & headline"]
    garr = (*gs.arena.arrays(), gs.arena.dead_array())
    gjoin = (*gs.arena.join_arrays(), gs.arena.bitmap_array())
    k8 = lambda: KD.join_member(*garr, rare.start, rare.count,  # noqa: E731
                                *gjoin, k8_parts, k8_inc)
    k8p = lambda: KD.join_member_plain(  # noqa: E731
        *garr, rare.start, rare.count, *gjoin, k8_parts, k8_inc)
    g, w = k8(), k8p()
    torch.cuda.synchronize()
    note("join_member", "joinA & headline shape (timed inputs)",
         max(diff(a, b) for a, b in zip(g, w)))
    found = int(w[2].sum())
    del g, w
    js, jn = k8_parts[0][0], k8_parts[0][1]
    seg_d, seg_p = gjoin[0][js:js + jn], gjoin[1][js:js + jn]
    keys = garr[2][rare.start:rare.start + rare.count]

    def k8_library():
        i = torch.searchsorted(seg_d, keys).clamp_(max=jn - 1)
        return seg_p[i]
    # bytes: the rare rows' features, flags, docid and tombstone byte;
    # for each live lane, its bitmap pair (8 B), and for each lane found,
    # the partner's arena row, posintext, hitcount and flags (12 B); the
    # merged block, flags and valid byte written
    lanes = int(KD.live_rows(keys, garr[3]).sum())
    k8_bytes = (rare.count * (P.NF * 2 + 4 + 4 + 1) + lanes * 8 + found * 12
                + rare.count * (P.NF * 4 + 4 + 1))
    measure("join_member", "yacy_search_server_tpu/index/devstore.py:736",
            "join.cu", k8, k8p, k8_library, k8_bytes, 0.0,
            f"{rare.count} rare rows (joinA) against the headline term's "
            f"bitmap ({jn} rows), {lanes} live lanes, {found} found "
            "(rank_join joinA & headline); library: torch.searchsorted of "
            "the rare docids in the headline's sorted segment + the jpos "
            "gather", path="join")
    del seg_d, seg_p, keys

    routes = {}     # dispatch functions timed with their fetch, below
    # the batched join's kernels at the batcher's shapes on the same
    # store: 16 bitmap slots of joinA & headline (the filters in turn)
    # and 4 slots of term1000000's span against joinB (a sort-mode
    # partner); each checked first on the inputs it is timed on, its
    # bound the slots' bytes summed. Beside them the solo K8 at the sort
    # slot's shape (the bitmap slot's is the row above)
    garr = (*gs.arena.arrays(), gs.arena.dead_array())
    gjoin = (*gs.arena.join_arrays(), gs.arena.bitmap_array())
    rare1m, part_b = gs.spans_for(t1m)[0], jpart(jB)
    k8s = lambda: KD.join_member(  # noqa: E731
        *garr, rare1m.start, rare1m.count, *gjoin, [part_b], 1)
    k8sp = lambda: KD.join_member_plain(  # noqa: E731
        *garr, rare1m.start, rare1m.count, *gjoin, [part_b], 1)
    g, w = k8s(), k8sp()
    torch.cuda.synchronize()
    note("join_member", "term1000000 & joinB (sort) shape (timed inputs)",
         max(diff(a, b) for a, b in zip(g, w)))
    keys = garr[2][rare1m.start:rare1m.start + rare1m.count]
    lanes = int(KD.live_rows(keys, garr[3]).sum())
    found = int(w[2].sum())
    seg_d = gjoin[0][part_b[0]:part_b[0] + part_b[1]]
    seg_p = gjoin[1][part_b[0]:part_b[0] + part_b[1]]

    def k8s_library():
        i = torch.searchsorted(seg_d, keys).clamp_(max=part_b[1] - 1)
        return seg_p[i]
    measure("join_member", "yacy_search_server_tpu/index/devstore.py:736",
            "join.cu", k8s, k8sp, k8s_library,
            rare1m.count * (P.NF * 2 + 4 + 4 + 1) + lanes * 8 + found * 12
            + rare1m.count * (P.NF * 4 + 4 + 1), 0.0,
            f"{rare1m.count} rare rows (term1000000) against joinB's "
            f"sorted segment ({part_b[1]} rows), {lanes} live lanes, "
            f"{found} valid (the sort wave's slot); library: "
            "torch.searchsorted + the jpos gather", path="join")
    del g, w, keys, seg_d, seg_p
    for wlabel, (desc_j, ninc_j), src_line in (
            ("16 bitmap slots of joinA & headline",
             big_waves["16 bitmap slots of joinA & headline"], 1068),
            ("4 sort slots of term1000000 & joinB",
             big_waves["4 sort slots of term1000000 & joinB"], 1049)):
        off_j = KD.join_wave_offsets(desc_j)
        bs_j = desc_j.shape[0]
        slots_j = KD.join_wave_slots(desc_j, ninc_j)
        rows_j = int(desc_j[:, 1].sum())
        kb8 = lambda d_=desc_j, n_=ninc_j, o_=off_j: (  # noqa: E731
            KD.join_member_batch(*garr, *gjoin, d_, n_, o_))
        kb8p = lambda d_=desc_j, n_=ninc_j, o_=off_j: (  # noqa: E731
            KD.join_member_batch_plain(*garr, *gjoin, d_, n_, o_))
        g, w = kb8(), kb8p()
        torch.cuda.synchronize()
        note("join_member_batch", f"{wlabel} (timed inputs)", max(
            diff(KD.wave_rows(a, desc_j, off_j), KD.wave_rows(b, desc_j,
                                                               off_j))
            for a, b in zip(g, w)))
        del g
        keys_j = torch.cat([garr[2][st_:st_ + c_] for st_, c_, _f, _p
                            in slots_j])
        # the bound's reads: slots that share a rare span read its rows
        # once, and slots that share a span and its partners look its
        # lanes up once (8 B a live lane) and read the partner rows found
        # once (12 B each, the most any of those slots found); every
        # slot writes its own region
        spans_j, looks_j = {}, {}
        for s_, (st_, c_, _f, p_) in enumerate(slots_j):
            spans_j[(st_, c_)] = c_
            found_s = int(w[2][int(off_j[s_]):int(off_j[s_]) + c_].sum())
            key_j = (st_, c_, tuple(p_))
            looks_j[key_j] = max(looks_j.get(key_j, 0), found_s)
        read_rows = sum(spans_j.values())
        lanes = sum(int(KD.live_rows(garr[2][st_:st_ + c_], garr[3]).sum())
                    for st_, c_, _p in looks_j)
        found = sum(looks_j.values())
        pj = slots_j[0][3][0]
        seg_d = gjoin[0][pj[0]:pj[0] + pj[1]]
        seg_p = gjoin[1][pj[0]:pj[0] + pj[1]]

        def kb8_library(keys_j=keys_j, seg_d=seg_d, seg_p=seg_p, n_=pj[1]):
            i = torch.searchsorted(seg_d, keys_j).clamp_(max=n_ - 1)
            return seg_p[i]
        measure("join_member_batch",
                f"yacy_search_server_tpu/index/devstore.py:{src_line}",
                "join.cu", kb8, kb8p, kb8_library,
                read_rows * (P.NF * 2 + 4 + 4 + 1) + lanes * 8 + found * 12
                + rows_j * (P.NF * 4 + 4 + 1) + 4 * desc_j.size, 0.0,
                f"{wlabel}: {rows_j} rare rows in {bs_j} slots over "
                f"{len(spans_j)} distinct spans ({read_rows} rows read), "
                f"{lanes} distinct live lanes, {found} distinct partner rows "
                "found; library: torch.searchsorted of every slot's docids "
                "in the partner's sorted segment + the jpos gather",
                path="batched_join", plain_reps=2)
        del keys_j, seg_d, seg_p
        # the solo K8 once for each slot of the wave, on the same inputs
        solo8 = lambda s_=slots_j, n_=ninc_j: [  # noqa: E731
            KD.join_member(*garr, a_, b_, *gjoin, p_, n_, f_)
            for a_, b_, f_, p_ in s_]
        log(f"{bs_j} x join_member on the slots of [{wlabel}]: "
            f"{KB.call_ms(solo8):.4f} ms a call (device "
            f"{KB.device_ms(solo8):.4f} ms), beside join_member_batch's "
            f"{rows[-1]['ms']:.4f} ms (device {rows[-1]['device_ms']:.4f} "
            "ms) above")
        kb1 = lambda w=w, d_=desc_j, o_=off_j: KD.join_stats_batch(  # noqa: E731
            w[0], w[2], d_, o_)
        kb1p = lambda w=w, d_=desc_j, o_=off_j: (  # noqa: E731
            KD.join_stats_batch_plain(w[0], w[2], d_, o_))
        st_j, pst_j = kb1(), kb1p()
        note("join_stats_batch", f"{wlabel} (timed inputs)",
             max(stats_diff(st_j[i], pst_j[i]) for i in range(bs_j)))
        measure("join_stats_batch", "yacy_search_server_tpu/ops/ranking.py:193",
                "cardinal_stats.cu", kb1, kb1p, None,
                rows_j * (P.NF * 4 + 1) + bs_j * 4 * KC.STATS_LEN, 0.0,
                f"{wlabel}: {rows_j} merged int32 rows + valid bytes in "
                f"{bs_j} regions, no host counts", path="batched_join",
                plain_reps=2)
        kb2 = lambda w=w, d_=desc_j, o_=off_j, s_=pst_j: (  # noqa: E731
            KD.join_score_batch(*w, d_, o_, s_, cd))
        kb2p = lambda w=w, d_=desc_j, o_=off_j, s_=pst_j: (  # noqa: E731
            KD.join_score_batch_plain(*w, d_, o_, s_, cd))
        g2, w2 = kb2(), kb2p()
        torch.cuda.synchronize()
        note("join_score_batch", f"{wlabel} (timed inputs)",
             diff(KD.wave_rows(g2, desc_j, off_j),
                  KD.wave_rows(w2, desc_j, off_j)))
        del g2, w2
        measure("join_score_batch", "yacy_search_server_tpu/ops/ranking.py:242",
                "cardinal_score.cu", kb2, kb2p, None,
                rows_j * (P.NF * 4 + 4 + 1 + 4)
                + 4 * (bs_j * KC.STATS_LEN + KC.CONSTS_LEN), 0.0,
                f"{wlabel}: {rows_j} merged int32 rows + flags + valid bytes "
                f"-> int32 scores in {bs_j} regions (the int32 path)",
                path="batched_join", plain_reps=2)
        routes[f"join_batch_query, {wlabel} + one fetch"] = (
            lambda d_=desc_j, n_=ninc_j: TD.join_batch_query(
                (*garr, None), gjoin, d_, n_, cd, kk).cpu())
        routes[f"{bs_j} x join_query, {wlabel} + {bs_j} fetches"] = (
            lambda s_=slots_j, n_=ninc_j: [TD.join_query(
                (*garr, None), gjoin, a_, b_, p_, n_, cd, kk, f_).cpu()
                for a_, b_, f_, p_ in s_])
        del w, st_j, pst_j

    # the batcher's shapes on the join path's store: K5 at 16 slots over
    # 16 queries' spans (the store's one-span terms in turn), bound the
    # slots' bytes summed; the batched scan's K6 and K7 with its selection
    # at shape A (16 slots: the 10M term's two spans and the 1M term
    # under the filtered-scan mix's four filters, k = 10 and 100) and B
    # (one slot a term of the run), both also at kk = 4096 (the lists in
    # device memory), and the join waves' finish on shape A's winners
    garr5 = (*gs.arena.arrays(), gs.arena.dead_array(), gs.arena._pmax)
    one_span = [gs.spans_for(th)[0] for th in bt_terms[1:]]
    slots16 = [one_span[i % len(one_span)] for i in range(16)]
    desc16 = KD.pack_desc([(s_.start, s_.count, s_.tstart, s_.tcount,
                            s_.stats["col_min"], s_.stats["col_max"],
                            s_.stats["tf_min"], s_.stats["tf_max"])
                           for s_ in slots16], shift, lterm)
    k5w = lambda: KD.pruned_tile(*garr5, desc16, kk, cd, False)  # noqa: E731
    k5wp = lambda: KD.pruned_tile_plain(  # noqa: E731
        *garr5, desc16, kk, cd, False)
    g, w = k5w(), k5wp()
    torch.cuda.synchronize()
    note("pruned_tile", "16 queries' spans, the batcher's wave", diff(g, w))
    measure(*src_k5, k5w, k5wp, None,
            sum(min(s_.count, TD.TILE) * row_b + 4 * (s_.tcount - 1)
                for s_ in slots16)
            + 16 * (4 * KD.DESC_SLOT_WORDS + 4 * (2 * kk + 1))
            + 4 * KC.CONSTS_LEN, 0.0,
            f"16 slots over 16 queries' spans ({len(one_span)} terms of "
            f"{min(s_.count for s_ in one_span)}-"
            f"{max(s_.count for s_ in one_span)} rows in turn), kk={kk}, "
            "the batcher's K5 wave (no init entries)", path="batched",
            slots=16)

    def filt_of(kw):
        lo, hi = kw.get("from_days"), kw.get("to_days")
        return (kw.get("lang_filter", TD.NO_LANG),
                kw.get("flag_bit", TD.NO_FLAG),
                TD.DAYS_NONE_LO if lo is None else lo,
                TD.DAYS_NONE_HI if hi is None else hi)
    scans16 = [([(s_.start, s_.count) for s_ in gs.spans_for(th)],
                filt_of(scan_filters[f]))
               for th in (hl, t1m) for f in range(len(scan_filters))
               for _k in (10, 100)]
    # shape B: one slot a term of the run under the mix's first filter, no
    # span shared by two slots
    scans7 = [([(s_.start, s_.count) for s_ in gs.spans_for(th)],
               filt_of(scan_filters[0])) for th in bt_terms]
    desc_s = KD.scan_batch_desc(scans16)
    src_b6 = ("span_stats_batch",
              "yacy_search_server_tpu/index/devstore.py:465",
              "cardinal_stats.cu")
    src_bt = ("span_topk_batch",
              "yacy_search_server_tpu/index/devstore.py:465 (the running "
              "top-k :540-548), :1032 (packed output)", "cardinal_score.cu")
    src_bf = ("topk_finish_batch",
              "yacy_search_server_tpu/index/devstore.py:1032",
              "pruned_tile.cu")

    def plain_once(fn):
        """fn's answer and the ms of that one call (a plain version, timed
        once: its check is its timing)"""
        torch.cuda.synchronize()
        tq = time.perf_counter()
        out_ = fn()
        torch.cuda.synchronize()
        return out_, (time.perf_counter() - tq) * 1e3

    # the bounds: each group's distinct rows read once (KB.scan_wave_work),
    # the statistics, the consts and [bs, 2kk]; K6's fold and K7's
    # score_row a live row and slot whose filter it passes. K7 with its
    # selection also at kk = 4096 (the mix's k = 3000: its lists in device
    # memory)
    for wname, scans_w in (("A", scans16), ("B", scans7)):
        desc_w = KD.scan_batch_desc(scans_w)
        rows_w = [sum(c for _a, c in e) for e, _f in scans_w]
        work = KB.scan_wave_work(garr5, desc_w, kk)
        shape_w = (f"shape {wname}: {len(scans_w)} filtered scans of "
                   f"{min(rows_w)}-{max(rows_w)} rows ({work['slot_rows']} "
                   f"slot-rows, {work['distinct_rows']} distinct in "
                   f"{len(KD.scan_groups(desc_w))} groups, "
                   f"{work['scored']} (row, slot) pairs live and passing), "
                   f"kk={kk}")
        k6w = lambda d=desc_w: KD.span_stats_batch(  # noqa: E731
            *garr5[:4], d)
        k6wp = lambda d=desc_w: KD.span_stats_batch_plain(  # noqa: E731
            *garr5[:4], d)
        st_w = k6w()
        pst_w, p_ms = plain_once(k6wp)
        note("span_stats_batch", f"shape {wname}",
             max(stats_diff(st_w[i], pst_w[i]) for i in range(len(rows_w))))
        measure(*src_b6, k6w, k6wp, None, work["k6_bytes"], work["k6_ops"],
                shape_w, path="batched", plain_ms=p_ms)
        ktw = lambda d=desc_w, st_=st_w: KD.span_topk_batch(  # noqa: E731
            *garr5[:4], d, st_, cd, kk)
        ktwp = lambda d=desc_w, st_=pst_w: (  # noqa: E731
            KD.span_topk_batch_plain(*garr5[:4], d, st_, cd, kk))
        g = ktw()
        w, p_ms = plain_once(ktwp)
        note("span_topk_batch", f"shape {wname}", diff(g, w))
        measure(*src_bt, ktw, ktwp, None, work["k7_bytes"], work["k7_ops"],
                f"{shape_w}; {KB.SCORE_ROW_OPS} ops a pair, "
                f"{KB.SCORE_ROW_F32_OPS} of them f32", path="batched",
                plain_ms=p_ms)
        kb = 1 << (PAST_FUSED_K - 1).bit_length()
        ktb = lambda d=desc_w, st_=st_w: KD.span_topk_batch(  # noqa: E731
            *garr5[:4], d, st_, cd, kb)
        ktbp = lambda d=desc_w, st_=pst_w: (  # noqa: E731
            KD.span_topk_batch_plain(*garr5[:4], d, st_, cd, kb))
        g = ktb()
        w, p_ms = plain_once(ktbp)
        note("span_topk_batch", f"shape {wname}, kk={kb}", diff(g, w))
        measure(*src_bt, ktb, ktbp, None,
                work["k7_bytes"] + 4 * len(scans_w) * 2 * (kb - kk),
                work["k7_ops"], f"{shape_w.replace(f'kk={kk}', f'kk={kb}')}"
                "; the lists in device memory", path="batched",
                plain_ms=p_ms)
        if wname == "A":
            st16 = st_w
    # topk_finish_batch (the join waves' finish) on the kk winners of each
    # of shape A's slots, from K7 and kernel 3 a slot
    top16 = torch.empty((3, 16, kk), dtype=torch.int32, device=dev)
    for i, (e_, f_) in enumerate(scans16):
        buf_ = KD.span_score(*garr5[:4], e_, st16[i], cd,
                             max(sum(c for _a, c in e_), kk), filt=f_)
        KT.tie_topk(buf_, kk, out=(top16[0, i], top16[1, i], top16[2, i]))
    del buf_
    fw = lambda: KD.topk_finish_batch(  # noqa: E731
        top16[0], top16[2], garr5[2], desc_s)
    fwp = lambda: KD.topk_finish_batch_plain(  # noqa: E731
        top16[0], top16[2], garr5[2], desc_s)
    g, w = fw(), fwp()
    torch.cuda.synchronize()
    note("topk_finish_batch", "16 slots of the filtered-scan mix", diff(g, w))
    measure(*src_bf, fw, fwp, None, 16 * kk * 12 + 16 * 2 * kk * 4, 0.0,
            f"the kk={kk} winners of 16 filtered scans -> [16, {2 * kk}]",
            path="batched")
    del g, w, pst_w

    # the dense rerank's kernels at the hybrid path's shapes, each checked
    # first on the inputs it is timed on: K9 (gather mode) and K10 over the
    # hybrid mix's waves (16 of its queries at k = 10, 100 and 1000: nb =
    # 16, 128, 1024), one query (bs = 1, nb = 128) and 2 slots of 16,384
    # candidates, over the 2^21-row forward index; K9's block mode at
    # dense_boost_topk's k = 100 and 1000 (the host fallback's get_block);
    # K9's similarity mode and K11 for B = 16 and 1 over the whole index
    # (hybrid_rerank_topk(_batch)). Yardsticks: a gather and torch.einsum
    # in bf16 (K9 gather), torch.sort of the same keys (K10), torch.matmul
    # in bf16 (K9's other modes); none for K11
    bf = torch.bfloat16
    dense_src = ("yacy_search_server_tpu/ops/dense.py:290 "
                 "_rerank_fwd_batch_packed_kernel (dot; :218, :150, :177)",
                 "dense.cu")
    dd_src = ("dense_dot", *dense_src)
    rs_src = ("rerank_sort", "yacy_search_server_tpu/ops/dense.py:290 "
              "_rerank_fwd_batch_packed_kernel (lax.sort)", "dense.cu")
    hb_src = ("hybrid_blend", "yacy_search_server_tpu/ops/dense.py:150 "
              "hybrid_rerank_topk / :177 hybrid_rerank_topk_batch (blend)",
              "dense.cu")
    cap_g = fwd_g.shape[0]
    waves = {}
    for k in (10, 100, 1000):
        qs_k = [q for q in hy_qs if q[2] == k][:16]
        nb_k = DN.rerank_bucket(k)
        waves[f"16 mix queries at k={k} (nb={nb_k})"] = np.stack([
            DN.pack_rerank_row(*hy_in[q], 0.5, nb_k) for q in qs_k])
    q1 = (t1m, "default", 100)
    waves["1 query at k=100 (nb=128)"] = DN.pack_rerank_row(
        *hy_in[q1], 0.5, 128)[None, :]
    big, nb_big, _sl = KB.rerank_wave(np.random.default_rng(KB.SEED + 73),
                                      cap_g, (16384, 16384), 16384)
    waves["2 synthetic slots of 16,384 (nb=16384)"] = big
    # a solo rerank of 9,000 candidates as rerank_boost issues it: the
    # batcher's 16 slots, 15 of them pad slots
    solo, _nb, _sl = KB.rerank_wave(np.random.default_rng(KB.SEED + 74),
                                    cap_g, (9000,) + (0,) * 15, 16384)
    waves["serving solo: 16 slots of nb=16384, one live of 9,000"] = solo
    for label, qi in waves.items():
        nb_w = (qi.shape[1] - 2 - DN.DIM) // 2
        qd = KDn.upload_desc(qi, dev)
        nval = qi[:, 0]
        lanes = np.arange(nb_w)[None, :] < nval[:, None]
        dids = qi[:, 2:2 + nb_w]
        cov = lanes & (dids >= 0) & (dids < cap_g)
        # the bound reads a row that several lanes share once
        read, covered = int(np.unique(dids[cov]).size), int(cov.sum())
        live = int((nval > 0).sum())
        log(f"gather, {label}: {read} distinct rows read for {covered} "
            "covered lanes")
        fin = KDn.dense_gather_boost(fwd_g, qd, nb_w)
        note("dense_dot", f"gather, {label}",
             diff(fin, KDn.dense_gather_boost_plain(fwd_g, qd, nb_w)))
        srt = KDn.rerank_sort(fin, qd, nb_w)
        note("rerank_sort", label, diff(srt, KDn.rerank_sort_plain(fin, qd,
                                                                   nb_w)))
        idx_l = torch.from_numpy(dids.astype(np.int64)).to(dev).clamp(
            0, cap_g - 1)
        qb = torch.from_numpy(qi[:, 2 + 2 * nb_w:].copy().view(
            np.float32)).to(dev).to(bf)
        key = (KDn._wrap32(-fin.to(torch.int64)).to(torch.int64) * 2**32
               + qd[:, 2:2 + nb_w].to(torch.int64) + 2**31)
        measure(*dd_src,
                lambda f=fwd_g, q=qd, n_=nb_w, lv=live:
                KDn.dense_gather_boost(f, q, n_, lv),
                lambda f=fwd_g, q=qd, n_=nb_w:
                KDn.dense_gather_boost_plain(f, q, n_),
                lambda i=idx_l, q=qb: torch.einsum(
                    "bd,bnd->bn", q, fwd_g[i].to(bf)),
                read * 512 + qi.nbytes + fin.numel() * 4, 2.0 * covered * 256,
                f"gather mode, {label} ({read} distinct rows read, "
                f"{covered} covered lanes)", path="hybrid")
        measure(*rs_src,
                lambda x=fin, q=qd, n_=nb_w, lv=live:
                KDn.rerank_sort(x, q, n_, lv),
                lambda x=fin, q=qd, n_=nb_w: KDn.rerank_sort_plain(x, q, n_),
                lambda x=key: torch.sort(x, dim=1, stable=True),
                fin.numel() * 16, 0.0, label, path="hybrid")
        w = walls_of(lambda f=fwd_g, q=qi, n_=nb_w:
                     DN.rerank_fwd_batch_packed(f, q, n_).cpu())
        yard = KB.call_ms(lambda i=idx_l, q=qb, x=key: (
            torch.einsum("bd,bnd->bn", q, fwd_g[i].to(bf)),
            torch.sort(x, dim=1, stable=True)))
        log(f"wall rerank_fwd_batch_packed + fetch, {label}: median "
            f"{float(np.median(w)):.4f} ms, min {min(w):.4f} ms over 50 "
            f"after 5; yardstick gather + einsum + sort {yard:.4f} ms a "
            "call")
    qv0, _s0, d0 = hy_in[(t1m, "default", 1000)]
    blk_all = put(g_dense.get_block(d0))
    qv_d = put(qv0)
    for k in (100, 1000):
        blk = blk_all[:k]
        spk = put(_s0[:k])
        vk = torch.ones(k, dtype=torch.bool, device=dev)
        note("dense_dot", f"block mode k={k}",
             diff(KDn.dense_rows_boost(blk, qv_d, spk, vk, 0.5),
                  KDn.dense_rows_boost_plain(blk, qv_d, spk, vk, 0.5)))
        measure(*dd_src,
                lambda b_=blk, s_=spk, v_=vk:
                KDn.dense_rows_boost(b_, qv_d, s_, v_, 0.5),
                lambda b_=blk, s_=spk, v_=vk:
                KDn.dense_rows_boost_plain(b_, qv_d, s_, v_, 0.5),
                lambda b_=blk: torch.matmul(b_.to(bf), qv_d.to(bf)),
                k * 512 + 1024 + k * 9, 2.0 * k * 256,
                f"block mode, dense_boost_topk k={k} (the host fallback's "
                "get_block)", path="hybrid")
        whole = KB.call_ms(lambda b_=blk, s_=spk, v_=vk, k_=k:
                           DN.dense_boost_topk(qv_d, b_, s_, v_, 0.5, k_))
        log(f"dense_boost_topk k={k}: {whole:.4f} ms a call (K9 and kernel "
            "3)")
    fwd_b16 = fwd_g.to(bf)
    # a query element near 1e-35: its pass takes K9's mul + add variant
    # (the others the leaf fma), both held against the plain version
    qs_t = hq16[:16].clone()
    qs_t[3, ::5] = 1e-35
    note("dense_dot", f"similarities, B=16 over all {cap_g} rows, a query "
         "element of 1e-35 (mul + add)",
         diff(KDn.dense_sims(fwd_g, qs_t), KDn.dense_sims_plain(fwd_g, qs_t)))
    del qs_t
    for b_ in (16, 1):
        qs_b = hq16[:b_].contiguous()
        sims = KDn.dense_sims(fwd_g, qs_b)
        note("dense_dot", f"similarities, B={b_} over all {cap_g} rows",
             diff(sims, KDn.dense_sims_plain(fwd_g, qs_b)))
        measure(*dd_src, lambda q=qs_b: KDn.dense_sims(fwd_g, q),
                lambda q=qs_b: KDn.dense_sims_plain(fwd_g, q),
                lambda q=qs_b: torch.matmul(q.to(bf), fwd_b16.T),
                cap_g * 512 + b_ * 1024 + b_ * cap_g * 4,
                2.0 * b_ * cap_g * 256,
                f"similarity mode, B={b_} over {cap_g} rows "
                "(hybrid_rerank_topk" + ("_batch)" if b_ > 1 else ")"),
                path="hybrid", plain_reps=1)
        spb, vb = hsp16[:b_].contiguous(), hv16[:b_].contiguous()
        note("hybrid_blend", f"B={b_} over {cap_g} lanes",
             diff(KDn.hybrid_blend(sims, spb, vb, 0.5),
                  KDn.hybrid_blend_plain(sims, spb, vb, 0.5)))
        measure(*hb_src, lambda x=sims, s_=spb, v_=vb:
                KDn.hybrid_blend(x, s_, v_, 0.5),
                lambda x=sims, s_=spb, v_=vb:
                KDn.hybrid_blend_plain(x, s_, v_, 0.5), None,
                b_ * cap_g * 13, 5.0 * b_ * cap_g,
                f"[{b_}, {cap_g}] f32 similarities, sparse and valid",
                path="hybrid")
        whole = KB.call_ms(lambda q=qs_b, s_=spb, v_=vb:
                           DN.hybrid_rerank_topk_batch(q, fwd_g, s_, v_, 0.5,
                                                       100))
        log(f"hybrid_rerank_topk{'_batch' if b_ > 1 else ''} B={b_} over "
            f"{cap_g} rows, k=100: {whole:.4f} ms a call (K9, K11, kernel 3 "
            "a slot)")
        del sims
    del fwd_b16, hsp16, hv16

    # the dense-first path's kernels at its shapes: K14 over 16 of the
    # mix's query vectors against the index's centroid block, K15 over a
    # 16-slot wave of the mix's commonest (nb, kk) group and over one slot
    # at nb = 32768 (the solo path), each held to its plain version first
    # and timed beside a PyTorch yardstick (a bf16 matmul and topk; a
    # gather, a bf16 einsum and a sort of the (score, docid) keys). The
    # bound counts each in-slab lane's row, scale and docid once (rows
    # that several slots probe: once), the descriptors and the output
    from yacy_search_server_tpu_torch.kernels import ann as KA
    an_src = ("ann_assign", "yacy_search_server_tpu/ops/ann.py:82",
              "ann.cu")
    af_src = ("ann_fuse", "yacy_search_server_tpu/ops/ann.py:151",
              "ann.cu")
    cent_g, cev = g_ann.centroid_block(dev)
    TD.DeviceArena.wait_written(cev)
    c_pad = cent_g.shape[0]
    qv16 = put(np.stack([df_in[q][0] for q in df_qs[:16]]))
    note("ann_assign", f"B=16 x C={n_cl} (C_pad {c_pad})",
         diff(KA.ann_assign(cent_g, qv16, 8, n_cl),
              KA.ann_assign_plain(cent_g, qv16, 8, n_cl)))
    cent_b = cent_g.to(bf)
    measure(*an_src, lambda: KA.ann_assign(cent_g, qv16, 8, n_cl),
            lambda: KA.ann_assign_plain(cent_g, qv16, 8, n_cl),
            lambda: torch.topk(torch.matmul(qv16.to(bf), cent_b.T).float(),
                               8),
            c_pad * 512 + 16 * 1024 + 16 * 8 * 4, 2.0 * 16 * n_cl * 256,
            f"B=16 x C={n_cl} x 256, np_=8", path="dense_first")
    df_slots = [{"qvec": qv, "ss": s_, "sd": d_, "alpha": 0.5, "k": k_,
                 "nprobe": AN.ANN_DEFAULT_NPROBE}
                for qv, s_, d_, k_ in (df_in[q] for q in df_qs)]
    df_groups, _hs, _pr = gs._ann_prepare_wave(df_slots)
    (nb_c, kk_c), its_c = max(df_groups.items(), key=lambda kv: len(kv[1]))
    waves = [(f"a 16-slot wave of the mix's commonest group (nb={nb_c}, "
              f"kk={kk_c}, {len(its_c)} distinct queries)", nb_c, kk_c,
              [its_c[i % len(its_c)] for i in range(16)])]
    big = [(key, its) for key, its in df_groups.items() if key[0] == 32768]
    if not big:
        fail("no dense-first query of the mix took nb = 32768")
    waves.append((f"one slot at nb=32768 (kk={big[0][0][1]})", 32768,
                   big[0][0][1], big[0][1][:1]))
    hb_g = its_c[0]["hb"]
    cap_a = hb_g[0].shape[0]
    for label, nb_w, kk_w, its in waves:
        qi = np.stack([it["qrow"] for it in its])
        qd = KDn.upload_desc(qi, dev)
        n_v = qi[:, 0]
        rows_all = qi[:, 2:2 + nb_w]
        live = np.arange(nb_w)[None, :] < n_v[:, None]
        in_slab = live & (rows_all >= 0) & (rows_all < cap_a)
        distinct = int(np.unique(rows_all[in_slab]).size)
        note("ann_fuse", label,
             diff(KA.ann_fuse(*hb_g, qd, nb_w, kk_w),
                  KA.ann_fuse_plain(*hb_g, qd, nb_w, kk_w)))
        idx_a = torch.from_numpy(np.clip(rows_all, 0, cap_a - 1).astype(
            np.int64)).to(dev)
        q_b = torch.from_numpy(qi[:, 2 + 3 * nb_w:].copy().view(
            np.float32)).to(dev).to(bf)
        key_a = torch.from_numpy(rows_all.astype(np.int64)).to(dev)
        measure(*af_src,
                lambda h=hb_g, q=qd, n_=nb_w, k_=kk_w, lv=len(its):
                KA.ann_fuse(*h, q, n_, k_, lv),
                lambda h=hb_g, q=qd, n_=nb_w, k_=kk_w:
                KA.ann_fuse_plain(*h, q, n_, k_),
                lambda i=idx_a, q=q_b, x=key_a: (
                    torch.einsum("bd,bnd->bn", q, hb_g[0][i].to(bf)),
                    torch.sort(x, dim=1)),
                distinct * 262 + qi.nbytes + len(its) * 2 * kk_w * 4,
                2.0 * 256 * int(in_slab.sum()),
                f"{label}: {int(in_slab.sum())} in-slab lanes, {distinct} "
                "distinct rows", path="dense_first")
        w = walls_of(lambda h=hb_g, q=qi, n_=nb_w, k_=kk_w:
                     AN.ann_fuse_batch_packed(*h, q, n_, k_).cpu())
        log(f"wall ann_fuse_batch_packed + fetch, {label}: median "
            f"{float(np.median(w)):.4f} ms, min {min(w):.4f} ms over 50 "
            "after 5")
    del cent_b, idx_a, q_b, key_a

    # K17 at the realistic graph (1,000,000 hosts, about 5M edges): the
    # row times `launch` over a prepared layout (the fill, the zero and one
    # persistent kernel, no host sync); the whole call (layout, steps, the
    # one fetch) beside it. Bound: 12 bytes an edge and 8 a host each step
    # (the JAX roofline's cost model); the chain bound logged beside it:
    # the largest in-degree's dependent adds, 4 cycles each at the card's
    # maximum SM clock. Yardstick: the same steps with cuSPARSE's CSR mat-vec
    # (torch.sparse on the CSR by destination), the dangling sum and the
    # update in torch
    hg_d = [put(a) for a in hg]
    n_h, e_h = len(hg[3]), len(hg[0])
    lay = KBr.layout(*hg_d, n_h)
    d_h, inv_h, tele_h, r0_h, _tol = KBr.step_consts(BRo.DAMPING, n_h)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # torch.sparse's beta notices
        csr = torch.sparse_csr_tensor(lay["rowptr"].long(),
                                      lay["src_s"].long(), lay["w_s"],
                                      size=(n_h, n_h))

    def k17_library():
        r_ = torch.full((n_h,), float(r0_h), device=dev)
        for _ in range(hg_steps):
            dm_ = torch.where(hg_d[3], r_, 0.0).sum() * float(inv_h)
            r2_ = float(tele_h) + float(d_h) * (csr @ r_ + dm_)
            (r2_ - r_).abs().max()
            r_ = r2_
        return r_

    KBr.launch(lay, BRo.DAMPING)
    st_h = lay["state"].cpu()
    note("power_iterate", "the timed layout's launch against phase 2's "
         "plain answer", diff(lay["rb"][int(st_h[4])].cpu(), hg_want))
    if int(st_h[1]) != hg_steps:
        fail("power_iterate: the timed launch took another trip count")
    whole = KB.call_ms(lambda: KBr.power_iterate(*hg_d, BRo.DAMPING, n_h))
    lay_ms = KB.call_ms(lambda: KBr.layout(*hg_d, n_h))
    measure("power_iterate", "yacy_search_server_tpu/ops/blockrank.py:28",
            "blockrank.cu", lambda: KBr.launch(lay, BRo.DAMPING),
            lambda: KBr.power_iterate_plain(*hg_d, BRo.DAMPING, n_h),
            k17_library, (12 * e_h + 8 * n_h) * hg_steps, 0.0,
            f"{n_h} hosts, {e_h} edges, {hg_steps} steps (realistic host "
            "graph; launch over a prepared layout)", path="blockrank",
            plain_reps=3)
    rows[-1]["steps"] = hg_steps
    rows[-1]["whole_call_ms"] = whole
    rows[-1]["layout_ms"] = lay_ms
    max_in = int(np.bincount(hg[1], minlength=n_h).max())
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=30).stdout.split()[0])
    chain_ms = max_in * hg_steps * 4 / (mhz * 1e3)
    log(f"K17 chain bound: {max_in} dependent adds a step x {hg_steps} "
        f"steps x 4 cycles at {mhz:.0f} MHz: {chain_ms:.4f} ms (bytes "
        f"bound {rows[-1]['bound_ms']:.4f} ms)")
    # the device's busy time in one launch, from a profiler trace: the
    # fill, the zero and the kernel that runs every step
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof_:
        KBr.launch(lay, BRo.DAMPING)
        torch.cuda.synchronize()
    k_us = {}
    for ev in prof_.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k_us.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
    busy = sum(sum(v) for v in k_us.values()) / 1e3
    rows[-1]["device_busy_ms"] = busy
    n_ops = sum(len(v) for v in k_us.values())
    rows[-1]["device_ops_in_trace"] = n_ops
    if n_ops > 3:
        fail(f"power_iterate: {n_ops} device operations in one launch's "
             "trace, more than the fill, the zero and the kernel")
    log(f"K17 device busy in one launch: {busy:.4f} ms over "
        f"{n_ops} device operations; by "
        "kernel (count, sum us, first steps' us): " + "; ".join(
            f"{k}: {len(v)}, {sum(v):.1f}, {[round(x, 1) for x in v[:hg_steps]]}"
            for k, v in k_us.items()))
    log(f"K17 whole call (layout, {hg_steps} steps, the fetch): {whole:.4f} "
        f"ms; the layout alone {lay_ms:.4f} ms; the plain version on the "
        "card sums in atomics' order (a time, not a check)")
    del csr      # `lay` stays: the profiler trace at the end calls launch

    # K16 at the placed step's shape: MeshBM25's placed 1M x 4 block
    bm_src = ("bm25_pass", "yacy_search_server_tpu/ops/ranking.py:653",
              "bm25.cu")
    bmp = M.MeshBM25(mesh).place(bm_in[0], bm_in[1], bm_in[2], bm_in[3],
                                 bm_in[4])
    b_tf, b_dl, b_df, b_nd, b_v, _b_d = bmp[0]
    n_b, t_b = b_tf.shape
    note("bm25_pass", f"{n_b} x {t_b} f32 tf (MeshBM25.place)",
         diff(R.bm25_scores(b_tf, b_dl, b_df, b_nd, b_v),
              R.bm25_scores_plain(b_tf, b_dl, b_df, b_nd, b_v)))
    measure(*bm_src, lambda: R.bm25_scores(b_tf, b_dl, b_df, b_nd, b_v),
            lambda: R.bm25_scores_plain(b_tf, b_dl, b_df, b_nd, b_v), None,
            n_b * t_b * 4 + n_b * 4 + n_b + t_b * 4 + n_b * 4,
            n_b * (6.0 * t_b + 4.0),
            f"{n_b} x {t_b} f32 tf + doclen + valid (MeshBM25.topk)")

    # the mesh path's kernels at its shapes, on its store's cells (four on
    # the card): K7 with its docid column over the headline term's extent
    # in the cell holding most of it (its docids are odd: at n_doc = 2 all
    # of them are in doc column 1) against its statistics; K4 batched over
    # a wave of 8 slots of 4 cells' pruned runs at kk 16 (k = 10) and 128;
    # K16's halves over one cell of MeshBM25 at 2 x 2 (500,000 rows, 2
    # columns); K18's probe of the joinA & headline join in that doc
    # column (joinA's candidates on term row 0 against headline's window),
    # beside torch.searchsorted and a gather on the same window, and its
    # apply
    msh, hl_m, mk = m_keep
    with msh._lock:
        mcells = msh._device_cells()
    sp_m = msh.spans_for(hl_m)[0]
    c10 = int(np.argmax(sp_m.counts))
    ext_m = [(int(sp_m.starts[c10]), int(sp_m.counts[c10]))]
    mc = mcells[c10]
    m_consts = msh._profile_consts(m_prof, "en")[c10]
    st_m = KD.span_stats(mc.feats16, mc.docids, mc.dead, ext_m,
                         flags=mc.flags)
    n_m = ext_m[0][1]
    note("span_score_docids", f"headline's extent in cell {c10}, {n_m} "
         "rows (mesh path)",
         max(diff(a, b) for a, b in zip(
             KD.span_score(*mc.arrays()[:4], ext_m, st_m, m_consts, n_m,
                           with_docids=True),
             KD.span_score_plain(*mc.arrays()[:4], ext_m, st_m, m_consts,
                                 n_m, None, None, None, True))))
    measure("span_score_docids", "yacy_search_server_tpu/index/meshstore.py"
            ":1978", "cardinal_score.cu",
            lambda: KD.span_score(*mc.arrays()[:4], ext_m, st_m, m_consts,
                                  n_m, with_docids=True),
            lambda: KD.span_score_plain(*mc.arrays()[:4], ext_m, st_m,
                                        m_consts, n_m, None, None, None,
                                        True), None,
            n_m * (P.NF * 2 + 4 + 4 + 1) + n_m * 8, n_m * 60.0,
            f"{n_m} rows of one cell, scores and docids (mesh exact scan)",
            path="mesh", plain_reps=2)
    for kk_ in (16, 128):
        gb = KB.pruned_runs(8, 4, kk_, mrng).to(dev)
        m_g = 4 * kk_
        note("gather_topk_batch", f"8 slots of 4 runs of {kk_} (mesh wave)",
             diff(KT.gather_topk_batch(gb, kk_, kk_, False, kk_, 2 * kk_),
                  KT.gather_topk_batch_plain(gb, kk_, kk_, False, kk_,
                                             2 * kk_)))
        measure("gather_topk_batch", "yacy_search_server_tpu/index/"
                "meshstore.py:1876", "gather_topk.cu",
                lambda g_=gb, k_=kk_: KT.gather_topk_batch(
                    g_, k_, k_, False, k_, 2 * k_),
                lambda g_=gb, k_=kk_: KT.gather_topk_batch_plain(
                    g_, k_, k_, False, k_, 2 * k_), None,
                8 * 4 * (2 * kk_ + 1) * 4 + 8 * (2 * kk_ + 1) * 4,
                8.0 * m_g * m_g,
                f"8 slots x 4 cells' pruned runs of {kk_} (K5 order: the "
                f"all-pairs path), k={kk_}, ok pmin (mesh wave)",
                path="mesh")
    b22 = M.MeshBM25(m22).place(*bm_in)[0]
    n_b2, t_b2 = b22[0].shape
    acc_b = R.bm25_sums(b22[1], b22[4])
    measure("bm25_sums", "yacy_search_server_tpu/parallel/mesh.py:288",
            "bm25.cu", lambda: R.bm25_sums(b22[1], b22[4]),
            lambda: R.bm25_sums_plain(b22[1], b22[4]), None,
            n_b2 * 5 + 16, 2.0 * n_b2,
            f"{n_b2} rows of one cell (MeshBM25 2 x 2)", path="mesh")
    measure("bm25_rows", "yacy_search_server_tpu/parallel/mesh.py:292",
            "bm25.cu",
            lambda: R.bm25_rows(b22[0], b22[1], b22[2], b22[3], b22[4],
                                acc_b),
            lambda: R.bm25_rows_plain(b22[0], b22[1], b22[2], b22[3], b22[4],
                                      acc_b), None,
            n_b2 * t_b2 * 4 + n_b2 * 9 + t_b2 * 4, n_b2 * (6.0 * t_b2 + 4.0),
            f"{n_b2} x {t_b2} f32 tf of one cell (MeshBM25 2 x 2)",
            path="mesh")
    sp_a = msh.spans_for(mk["joinA"])[0]
    c00 = msh.mesh.cell(TMS.term_shard(mk["joinA"], 2), c10 % msh.n_doc)
    n_x = int(sp_a.counts[c00])
    cand_x = mcells[c00].docids[int(sp_a.starts[c00]):
                                int(sp_a.starts[c00]) + n_x]
    lo_x, cnt_x = int(sp_m.jstarts[c10]), int(sp_m.counts[c10])
    mx = mcells[c10]
    probe = lambda: KD.xjoin_probe(  # noqa: E731
        cand_x, mx.dead, None, 1, mx.jdocids, mx.jpos, lo_x, cnt_x,
        mx.feats16, mx.flags)
    probe_plain = lambda: KD.xjoin_probe_plain(  # noqa: E731
        cand_x, mx.dead, None, 1, mx.jdocids, mx.jpos, lo_x, cnt_x,
        mx.feats16, mx.flags)
    xo = probe()
    note("xjoin_probe", f"joinA's {n_x} candidates against headline's "
         f"window of {cnt_x} (mesh path)", diff(xo, probe_plain()))
    found_x = int(xo[0].sum())
    win_x = mx.jdocids[lo_x:lo_x + cnt_x]

    def search_gather():
        i = torch.searchsorted(win_x, cand_x).clamp_(max=cnt_x - 1)
        return mx.jpos[lo_x:lo_x + cnt_x][i], win_x[i] == cand_x
    measure("xjoin_probe", "yacy_search_server_tpu/index/meshstore.py:1779",
            "join.cu", probe, probe_plain, search_gather,
            n_x * 5 + cnt_x * 8 + found_x * 8 + n_x * 20,
            n_x * math.ceil(math.log2(max(cnt_x, 2))),
            f"{n_x} candidates of cell {c00} against a window of {cnt_x} "
            f"in cell {c10}, {found_x} found (joinA & headline); library: "
            "torch.searchsorted and a gather", path="mesh", plain_reps=2)
    ma = mcells[c00]
    contrib_x = xo[None].clone()
    apply = lambda: KD.xjoin_apply(  # noqa: E731
        ma.feats16, ma.flags, ma.docids, ma.dead, int(sp_a.starts[c00]),
        n_x, contrib_x, 1)
    apply_plain = lambda: KD.xjoin_apply_plain(  # noqa: E731
        ma.feats16, ma.flags, ma.docids, ma.dead, int(sp_a.starts[c00]),
        n_x, contrib_x, 1)
    note("xjoin_apply", f"joinA's {n_x} rows (mesh path)",
         max(diff(a, b) for a, b in zip(apply(), apply_plain())))
    measure("xjoin_apply", "yacy_search_server_tpu/index/meshstore.py:1792",
            "join.cu", apply, apply_plain, None,
            n_x * (P.NF * 2 + 9) + n_x * 20 + n_x * (P.NF * 4 + 5),
            n_x * 20.0, f"{n_x} rare rows of cell {c00}, one partner "
            "(joinA & headline)", path="mesh", plain_reps=2)
    # K8 in sort mode on a cell (_mesh_join_shard): of the column-local
    # joins, the cell that holds the largest partner segment against its
    # rare rows (the rarest include, as rank_join picks it)
    mbest = None
    for jname in ("joinA & joinB (column-local)",
                  "term1000000 & joinC (column-local)"):
        inc_j = [msh.spans_for(t_)[0] for t_ in mjoins[jname][0]]
        r_j = min(range(2), key=lambda i_: int(inc_j[i_].counts.sum()))
        k8_r, k8_p = inc_j[r_j], inc_j[1 - r_j]
        for c_ in range(msh.n_cells):
            if int(k8_r.counts[c_]) and (
                    mbest is None or int(k8_p.counts[c_]) > mbest[0]):
                mbest = (int(k8_p.counts[c_]), c_, jname, k8_r, k8_p)
    jc_m, c_m, jname_m, k8_rare, k8_part = mbest
    mj = mcells[c_m]
    k8_start, n_mj = int(k8_rare.starts[c_m]), int(k8_rare.counts[c_m])
    part_m = [(int(k8_part.jstarts[c_m]), jc_m, -1)]
    path_m = ("the segment staged whole" if jc_m <= KD.join_stage_most(dev)
              else "searched through a fence table")
    k8m = lambda: KD.join_member(  # noqa: E731
        *mj.arrays()[:4], k8_start, n_mj, mj.jdocids, mj.jpos, mj.bmtab,
        part_m, 1)
    k8mp = lambda: KD.join_member_plain(  # noqa: E731
        *mj.arrays()[:4], k8_start, n_mj, mj.jdocids, mj.jpos, mj.bmtab,
        part_m, 1)
    g, w = k8m(), k8mp()
    torch.cuda.synchronize()
    note("join_member", f"{jname_m} on mesh cell {c_m} (sort mode)",
         max(diff(a, b) for a, b in zip(g, w)))
    keys_m = mj.docids[k8_start:k8_start + n_mj]
    lanes_m = int(KD.live_rows(keys_m, mj.dead).sum())
    found_m = int(w[2].sum())
    seg_md = mj.jdocids[part_m[0][0]:part_m[0][0] + jc_m]
    seg_mp = mj.jpos[part_m[0][0]:part_m[0][0] + jc_m]
    del g, w

    def k8m_library():
        i = torch.searchsorted(seg_md, keys_m).clamp_(max=jc_m - 1)
        return seg_mp[i]
    measure("join_member", "yacy_search_server_tpu/index/meshstore.py:1630",
            "join.cu", k8m, k8mp, k8m_library,
            n_mj * (P.NF * 2 + 4 + 4 + 1) + lanes_m * 8 + found_m * 12
            + n_mj * (P.NF * 4 + 4 + 1), 0.0,
            f"{n_mj} rare rows of mesh cell {c_m} against a sorted partner "
            f"segment of {jc_m} entries, {path_m} ({jname_m}), {lanes_m} "
            f"live lanes, {found_m} valid; library: torch.searchsorted + "
            "the jpos gather", path="mesh", plain_reps=2)
    del keys_m, seg_md, seg_mp
    # the whole calls' bounds, their kernels' summed: MeshRanker's cells
    # split rank_placed's rows (kernels 1-3 at those rows, rows 0-2 above;
    # K4 over 2 x 10 rows is below a nanosecond), MeshBM25's four cells
    # each run K16's halves at the cell shape timed above
    bm_rows = {r_["name"]: r_["bound_ms"] for r_ in rows
               if r_["path"] == "mesh" and r_["name"] in ("bm25_sums",
                                                          "bm25_rows")}
    log(f"summed bounds: MeshRanker 2 x 2 over {npad} rows (kernels 1-3 at "
        f"rank_placed's rows) {sum(r_['bound_ms'] for r_ in rows[:3]):.4f} "
        f"ms; MeshBM25 2 x 2 (4 cells x (bm25_sums + bm25_rows)) "
        f"{4 * sum(bm_rows.values()):.5f} ms")
    del gb, xo   # b22 and contrib_x stay for the device-ops trace

    # the device part of the join and the filtered scan: the store's
    # dispatch functions and the one fetch, without the host work of
    # rank_join / rank_term around them; each one's device operations
    # are traced at the end
    for label, (r_sp, r_parts, r_inc) in join_shapes.items():
        routes[f"join_query {label} + fetch"] = (
            lambda a=r_sp, b=r_parts, c=r_inc: TD.join_query(
                (*garr, None), gjoin, a.start, a.count, b, c, cd,
                kk).cpu())
    routes["scan_query filtered, cold (K6, K7, kernel 3, topk_finish) + "
           "fetch"] = lambda: TD.scan_query(ta, scan_ext, cd, kk,
                                            hfilt).cpu()
    routes["scan_query filtered, statistics handed in (K7, kernel 3, "
           "topk_finish) + fetch"] = lambda: TD.scan_query(
               ta, scan_ext, cd, kk, hfilt, stf).cpu()
    routes["scan_batch_query, 16 filtered scans (batched K6, K7 with its "
           "selection) + one fetch"] = lambda: TD.scan_batch_query(
               garr5, scans16, cd, kk).cpu()
    routes["scan_batch_query, shape B: 7 filtered scans, one a term + one "
           "fetch"] = lambda: TD.scan_batch_query(garr5, scans7, cd,
                                                  kk).cpu()
    routes["16 x scan_query, the same 16 filtered scans + 16 fetches"] = (
        lambda: [TD.scan_query(garr5, e, cd, kk, f).cpu()
                 for e, f in scans16])
    for label, fn in routes.items():
        for _ in range(5):
            fn()
        w = []
        for _ in range(50):
            tq = time.perf_counter()
            fn()
            w.append((time.perf_counter() - tq) * 1e3)
        log(f"{label}, kk={kk}: median {float(np.median(w)):.4f} ms, min "
            f"{min(w):.4f} ms over 50 after 5")

    # rank_term's wall per query (median of 50 after a warm-up) for the
    # three kinds of query, the same store: pruned, escalating, and, after
    # a tombstone, the exact scan
    def rank_walls(label, prof, k):
        # the result cache off: every query runs on the card
        ts._topk_cache.enabled = False
        for _ in range(5):
            ts.rank_term(hl, prof, k=k)
        r0, t0s, p0 = ts.prune_rounds, ts.stream_scans, ts.pruned_tiles
        w = []
        for _ in range(50):
            tq = time.perf_counter()
            ts.rank_term(hl, prof, k=k)
            w.append((time.perf_counter() - tq) * 1e3)
        log(f"rank_term per query, 10M term, {label}, k={k}: median "
            f"{float(np.median(w)):.4f} ms, mean {float(np.mean(w)):.4f} ms,"
            f" min {min(w):.4f} ms over 50 after 5; per query "
            f"{(ts.prune_rounds - r0) / 50:g} prune rounds, "
            f"{(ts.pruned_tiles - p0) / 50:g} pruned tiles, "
            f"{(ts.stream_scans - t0s) / 50:g} exact scans")
        ts._topk_cache.enabled = True

    # the device part of the pruned and the exact-scan query: the store's
    # dispatch functions and the one fetch, without rank_term's host work
    # around them (profile, spans, descriptor, the answer's filtering)
    for label, fn in (
            ("pruned_query (K5) + fetch", lambda: TD.pruned_query(
                ta, sp, shift, lterm, cd, kk, 1).cpu()),
            ("scan_query (K6, K7, kernel 3, topk_finish) + fetch",
             lambda: TD.scan_query(ta, scan_ext, cd, kk).cpu())):
        for _ in range(5):
            fn()
        w = []
        for _ in range(50):
            tq = time.perf_counter()
            fn()
            w.append((time.perf_counter() - tq) * 1e3)
        log(f"{label}, 10M term, kk={kk}: median {float(np.median(w)):.4f}"
            f" ms, min {min(w):.4f} ms over 50 after 5")
    rank_walls("pruned (default profile)", ds_profiles["default"], 100)
    rank_walls("escalating profile", ds_profiles["escalating"], 100)
    ti.delete_doc(int(docids[7]))
    rank_walls("after a tombstone: exact scan", ds_profiles["default"], 100)

    # the step itself: rank_placed's wall per query after a warm-up
    for q in range(5):
        mr.rank_placed(placed, k=100)
    q_walls = []
    for q in range(50):
        tq = time.perf_counter()
        mr.rank_placed(placed, k=10 if q % 2 else 100)
        q_walls.append((time.perf_counter() - tq) * 1e3)
    log(f"rank_placed per query: {walls['MeshRanker.rank_placed x50'] * 20:.4f}"
        f" ms over the main path's 50 (first queries included); over 50 "
        f"after a warm-up: median "
        f"{float(np.median(q_walls)):.4f} ms, mean "
        f"{float(np.mean(q_walls)):.4f} ms, min {min(q_walls):.4f} ms")

    # the device operations one call of each timed kernel issues, from a
    # profiler trace: traced last, since after a trace the host's launch
    # path may stay slower for the rest of the process
    tt = time.time()
    for row, kern in zip(rows, timed):
        row["device_ops_per_call"], names = ops_per_call(kern)
        log(f"device ops a call, {row['name']} [{row['shape']}]: "
            f"{row['device_ops_per_call']} {names}")
        # K18's probe is one launch a call (no memset, no second pass); a
        # trace that caught no event is taken again
        for _ in range(2):
            if row["name"] != "xjoin_probe" or row["device_ops_per_call"]:
                break
            row["device_ops_per_call"], names = ops_per_call(kern)
            log(f"device ops a call, traced again: {names}")
        if row["name"] == "xjoin_probe" and row["device_ops_per_call"] != 1:
            fail(f"xjoin_probe: {row['device_ops_per_call']} device "
                 f"operations a call, not 1: {names}")
        # K5 and K5bp: one launch of up to 16 (8) slots, no memset
        per = {"pruned_tile": KD.SLOTS, "pruned_tile_bp": KP.BP_SLOTS}
        if row["name"] in per and row["slots"] \
                and row["device_ops_per_call"] is not None \
                and row["device_ops_per_call"] != -(
                    -row["slots"] // per[row["name"]]):
            fail(f"{row['name']} [{row['shape']}]: "
                 f"{row['device_ops_per_call']} device operations a call: "
                 f"{names}")
    for label, fn in routes.items():
        log(f"device ops of one {label}: {ops_per_call(fn)[1]}")
    log(f"phase 4's traces: {time.time() - tt:.1f} s")

    for label, w in join_walls.items():
        log(f"wall {label}: median {float(np.median(w)):.4f} ms over 50 "
            "after 5 (join path)")
    clean("phase 4", gs, ts)
    log(f"total: {time.time() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
