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
   default profile and one whose bound fails, K6 span_stats and K7
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
   filter; the batched scan (span_stats_batch, span_score_batch,
   topk_finish_batch) over waves of 1, 3 and 16 edge scans, each slot
   also equal to the solo scan and to the CPU's; the batched join
   (join_member_batch, join_stats_batch, join_score_batch over each
   slot's rows, join_batch_query's slots equal to the solo join_query's)
   on the join edge store's waves (kernels/bench.join_edge_waves: 16
   bitmap slots, mixed modes, the clip rows in every slot as partner and
   as exclude, five partners and six excludes; every filter, a slot of
   no row) and, on the main path's store, 16 bitmap slots of joinA &
   headline (no filter, lang en, a flag bit, a date range in turn), 4
   sort-mode slots of term1000000 against joinB and 4 slots of
   term1000000 & headline & -joinB;
3. drive three main paths at the headline size, a 10M-posting term, each
   with the launch counts reset before it and read after: the placed
   step (CardinalRanker.rank (k = 10 and 100), MeshRanker.place once and
   50 rank_placed queries, MeshBM25.topk at 1M docs x 4 terms (k = 100),
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
   to the twin's and to the numpy oracle (kernels/bench.devjoin_oracle,
   devstore_oracle); then, counts read and reset, the batched joins: the
   six conjunctions x 2 profiles x k = 10 and 100 x {no filter, lang en}
   sent one at a time, from 16 threads, and from 16 threads through the
   batcher (once untimed first), then one group of them (joinA &
   headline, lang en, k = 100) the same ways, every answer the twin's,
   with q/s, p50/p95, live slots a join_member_batch launch (the one
   group's must average more than one) and the peak device memory; then
   a join a RAM delta declines, and the join path's walls (median of 50
   after a warm-up); then,
   the result cache off, rank_term's 50 pruned queries (k = 10 and
   100), a query on each
   other term, the escalating profile, k = 1000, a delete (the exact
   scan over one span) and a second run (over two), every answer equal
   to the twin's and to the numpy oracle (kernels/bench.devstore_oracle),
   and the filtered query after them; between the k = 1000 query and the
   delete, counts reset, the batched path's part 1: a result-cache hit
   equal to the cold answer, then a pruned mix (the store's 7 terms, two
   profiles, two languages, k = 10 and 100), its default/en/k = 100
   queries alone (one K5 group, so that waves can fill) and a
   filtered-scan mix (the 1M, 100k and 20k terms and joinB, whose RAM
   delta keeps it out of the waves; four filters) sent one at a time
   without the batcher, from 16 threads without it, and from 16 threads
   through it (`enable_batching`, scan batching on), every answer equal
   to the solo card answer and the twin's, with q/s and p50/p95 of each
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
   10M term, each equal to the twin's (and, but the last, to the numpy
   oracle), with their
   walls (median of 50 after a warm-up); every kernel of each path must
   have launched; then device loss, on a store of its own (the 1M term
   and a 200,000-posting term meeting it): one injected
   `device.transfer_fail` charge (a counted retry, the same answers), a
   streak (the loss declared, rank_term and rank_join answering None,
   counted, the result cache's entry dead), the rebuild recovering with
   answers bit-identical to those before the loss, and 16 batched
   waiters under a loss all returning, then recovered again. Every other
   phase must end with no transfer failure, retry or loss;
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
   filters, k = 10 and 100) beside 16 solo scans;
   rank_placed's wall per query over 50 queries after a warm-up; and,
   last, the device
   operations one call of each timed kernel issues, with their device
   times (a profiler trace).

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
                  "gather_topk")
DEVSTORE_KERNELS = ("pruned_tile", "span_stats", "span_score", "tie_topk",
                    "topk_finish")
JOIN_KERNELS = ("join_member", "cardinal_stats", "cardinal_score",
                "tie_topk", "topk_finish", "span_stats", "span_score")
BATCHED_KERNELS = ("pruned_tile", "span_stats", "span_score", "tie_topk",
                   "topk_finish", "span_stats_batch", "span_score_batch",
                   "topk_finish_batch")
MIX_THREADS = 16     # client threads of the concurrent mixes
MIX_REPEATS = 16     # each distinct query of a mix sent this many times
# the batched joins: each distinct conjunction sent this many times, and
# the one-group part's queries
JOIN_MIX_REPEATS = 16
JOIN_ONE_GROUP = 1024
BATCHED_JOIN_KERNELS = ("join_member_batch", "join_stats_batch",
                        "join_score_batch", "tie_topk", "topk_finish_batch")
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
    from yacy_search_server_tpu_torch.kernels import devstore as KD
    from yacy_search_server_tpu_torch.kernels import reset_launches
    from yacy_search_server_tpu_torch.kernels import topk as KT
    from yacy_search_server_tpu_torch.ops import ranking as R
    from yacy_search_server_tpu_torch.ops import streaming as S
    from yacy_search_server_tpu_torch.parallel import mesh as M

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
            for kk in (16, 1024):
                off = KD.scan_batch_offsets(desc, kk)
                g = KD.span_score_batch(*ea[:4], desc, st, c, off)
                w = KD.span_score_batch_plain(*ea[:4], desc, pst, c, off)
                torch.cuda.synchronize()
                note("span_score_batch", f"edges wave of {bs} ({pname}), "
                     f"kk={kk}", diff(g, w))
                top = torch.empty((3, bs, kk), dtype=torch.int32, device=dev)
                for i, (e, _f) in enumerate(scans):
                    n = max(sum(c_ for _s, c_ in e), kk)
                    KT.tie_topk(g[int(off[i]):int(off[i]) + n], kk,
                                out=(top[0, i], top[1, i], top[2, i]))
                gf = KD.topk_finish_batch(top[0], top[2], ea[2], desc)
                wf = KD.topk_finish_batch_plain(top[0], top[2], ea[2], desc)
                torch.cuda.synchronize()
                note("topk_finish_batch", f"edges wave of {bs} ({pname}), "
                     f"kk={kk}", diff(gf, wf))
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
    del jstore, _jidx, ja, jt

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
    tq = time.time()
    gs = TD.DeviceSegmentStore(idx, device=dev)
    torch.cuda.synchronize()
    ds_walls["pack, store on the card"] = time.time() - tq
    tq = time.time()
    hs = TD.DeviceSegmentStore(idx, device="cpu")
    ds_walls["pack, twin on the CPU"] = time.time() - tq
    idx.listener = KB.Fanout(gs, hs)
    sp_hl = gs.spans_for(hl)[0]
    log(f"devstore: {gs.arena.used_rows} rows packed, the 10M term in "
        f"{sp_hl.tcount} tiles; " + ", ".join(
            f"{k} {v:.1f} s" for k, v in ds_walls.items()))
    tq = time.time()
    hl_rows = KB.arena_rows(feats, docids)
    oracles = {pname: KB.devstore_oracle([hl_rows], prof, 1000)
               for pname, prof in ds_profiles.items()}
    log(f"devstore oracles: {time.time() - tq:.1f} s")
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
        expect(label, got[0], got[1], want[0], want[1])
        if len(want) > 2 and got[2] != want[2]:
            fail(f"{label}: considered {got[2]}, the oracle {want[2]}")

    def join_q(label, inc, exc, k=100, filt=None, **kw):
        tq = time.perf_counter()
        got = gs.rank_join(inc, exc, ds_profiles["default"], k=k, **kw)
        wall = (time.perf_counter() - tq) * 1e3
        tq = time.time()
        twin = hs.rank_join(inc, exc, ds_profiles["default"], k=k, **kw)
        t_twin = time.time() - tq
        tq = time.time()
        want = KB.devjoin_oracle(join_rows, inc, exc, dead_docs,
                                 ds_profiles["default"], k,
                                 filt or KD.NO_FILTER)
        same(f"rank_join {label}", got, twin, want)
        log(f"  rank_join {label}: {len(got[1])} answers of "
            f"{got[2]} rare rows, first wall {wall:.3f} ms (the twin "
            f"{t_twin:.1f} s, the oracle {time.time() - tq:.1f} s)")
        return got

    torch.cuda.synchronize()
    reset_launches()
    tm = time.time()
    join_q("joinA & headline", [jA, hl], [])
    join_q("joinA & headline & term1000000", [jA, hl, t1m], [], k=10)
    join_q("term1000000 & headline & -joinB", [t1m, hl], [jB])
    join_q("joinA & joinB", [jA, jB], [], k=1000)
    join_q("term1000000 & joinC (sort partner)", [t1m, jC], [])
    join_q("joinA & headline, lang de, days 8000-24000", [jA, hl], [],
           filt=jfilt, **filt_kw)
    # every exclude names a term with no postings: rank_term serves it
    nowhere = b"nowhereAAAAA"
    got = gs.rank_join([jB], [nowhere], ds_profiles["default"], k=10)
    twin = hs.rank_join([jB], [nowhere], ds_profiles["default"], k=10)
    same("rank_join joinB & -nowhere (plain)", got, twin,
         KB.devstore_oracle([join_rows[jB]], ds_profiles["default"], 10))
    # filtered rank_term on the headline term: cold, then from the cache
    k6_0 = LAUNCHES["span_stats"]
    want_f = KB.devstore_oracle(filtered([hl_rows], hfilt),
                                ds_profiles["default"], 100)
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
    # answer equal to the CPU twin's, taken once for each distinct query
    # at k = 100 (the answer at k = 10 is its first 10). Counts reset
    # before, read after
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
    twin100 = {q[:3]: jask(hs, q) for q in jqs if q[3] == 100}
    if any(a is None for a in twin100.values()):
        fail("a batched join's twin answer declined")
    jrefs = {q: (twin100[q[:3]] if q[3] == 100 else
                 (twin100[q[:3]][0][:10], twin100[q[:3]][1][:10],
                  twin100[q[:3]][2])) for q in jqs}
    log(f"batched joins: the twin's {len(twin100)} answers "
        f"{time.time() - tq:.1f} s")
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
        ds_query(f"10M default k={k}", hl, "default", k, oracles["default"])
    for i, n_t in enumerate(DS_TERMS):
        th = b"term%08d" % n_t
        ds_query(f"{n_t} default k=10", th, "default", 10,
                 KB.devstore_oracle([KB.arena_rows(*ds_terms[th])],
                                    ds_profiles["default"], 10))
    ds_query("10M escalating k=100", hl, "escalating", 100,
             oracles["escalating"])
    got = ds_query("10M default k=1000", hl, "default", 1000,
                   oracles["default"])
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
    # 100), each sent one query at a time (no batcher), from 16 threads
    # (no batcher), and from 16 threads through the batcher (scan
    # batching on); every answer equal to the first solo card answer and
    # to the twin's
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
                           for k in (10, 100)], MIX_REPEATS, scan_fn,
                          scan_twin)}
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
            for q in qs:
                twin = twin_fn(q)
                same(f"{mname} {q[0].decode()} {q[1:]} (solo card, twin)",
                     refs[mname][q], twin, twin)
            log(f"mix {mname}: the twin's {len(qs)} answers "
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
    for name in ("pruned_tile", "span_stats_batch", "span_score_batch"):
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
    ds_query("10M after a delete, default k=100", hl, "default", 100,
             KB.devstore_oracle([hl_live], ds_profiles["default"], 100))
    # a second run of the 10M term: two spans, the exact scan over both
    f2, _d, _h, _r = KB.make_term(SECOND_RUN, KB.SEED + 9)
    d2 = (2 * np.arange(SECOND_RUN)).astype(np.int32)  # even: new docids
    idx.add_many(hl, P.PostingsList(d2, f2))
    idx.flush()
    two = [hl_live, KB.arena_rows(f2, d2)]
    for pname, k in (("default", 100), ("escalating", 1000)):
        ds_query(f"10M + {SECOND_RUN} (2 runs), {pname} k={k}", hl, pname,
                 k, KB.devstore_oracle(two, ds_profiles[pname], k))
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
         KB.devstore_oracle(filtered(two, hfilt), ds_profiles["default"],
                            100))
    if LAUNCHES["span_stats"] != k6_0 + 1:
        fail("a stale filtered-stats cache entry was served")

    # -- phase 3, the batched path, part 2: facet bitmaps and RAM deltas ----
    # on the 10M term (two spans now, one tombstone: exact scans), counts
    # reset: a site:-style facet bitmap over the 20M docid space admitting
    # 2 % of it, alone and with a language filter; RAM deltas of 50,000
    # postings (a hot term between flushes: new docids and 1,000 of the
    # term's own) and of 300,000 (past the last bucket); each equal to
    # the twin's and, but the 300,000 delta, to the numpy oracle; then
    # their walls, the card store alone
    torch.cuda.synchronize()
    reset_launches()
    tb = time.time()
    fac_ids = np.sort(jrng.choice(2 * N, 2 * N // 50, replace=False))
    fkey = ((("site", "smoke.example"),), 0, 2 * N)
    g_bm = gs.filter_bitmap(fkey, lambda: fac_ids)
    h_bm = hs.filter_bitmap(fkey, lambda: fac_ids)

    masks = [np.isin(d_p, fac_ids) for _f, _fl, d_p in two]
    two_in = [tuple(a[m] for a in p_) for p_, m in zip(two, masks)]
    en_only = (en, TD.NO_FLAG, TD.DAYS_NONE_LO, TD.DAYS_NONE_HI)
    for label, kw, filt in (("facet bitmap 2 %", {}, KD.NO_FILTER),
                            ("facet bitmap 2 %, lang en",
                             dict(lang_filter=en), en_only)):
        got = gs.rank_term(hl, ds_profiles["default"], k=100,
                           allow_bitmap=g_bm, **kw)
        tq = time.time()
        twin = hs.rank_term(hl, ds_profiles["default"], k=100,
                            allow_bitmap=h_bm, **kw)
        t_twin = time.time() - tq
        tq = time.time()
        want = KB.devstore_oracle(filtered(two_in, filt),
                                  ds_profiles["default"], 100)
        log(f"rank_term {label}: the twin {t_twin:.1f} s, the oracle "
            f"{time.time() - tq:.1f} s")
        same(f"rank_term {label}", got, twin, want)
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
        tq = time.time()
        twin = hs.rank_term(hl, ds_profiles["default"], k=100)
        t_twin = time.time() - tq
        tq = time.time()
        if n_d == 50_000:   # the numpy oracle once (8-9 s over 10.1M rows)
            r16, rfl = R.compact_feats(ram.feats)
            want = KB.devstore_oracle(two + [(r16, rfl, ram.docids)],
                                      ds_profiles["default"], 100)
        else:
            want = twin
        same(f"rank_term with a RAM delta of {n_d}", got, twin, want)
        log(f"rank_term with a RAM delta of {n_d}: the twin {t_twin:.1f} s,"
            f" the oracle {time.time() - tq:.1f} s")
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
    del hs, idx, hl_live, two, oracles, join_rows

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
    ls._topk_cache.enabled = True
    if ls.arena_epoch == epoch0 or \
            ls.rank_cache_get(t1m, prof_l, k=100) is not None:
        fail("device loss: the result cache survived the loss")
    ls._topk_cache.enabled = False
    lost = loss_state()
    recovered()
    same_l("after the rebuild", ask_l(), before)
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

    # -- phase 4: kernel times at the main path's shapes ---------------------
    # `ms`: the call time, the median of 20 calls each between two CUDA
    # events from an idle queue (the device time plus the host's issue
    # time); `device_ms`: the median of 20 calls queued
    # behind a spin kernel, so that the host's issue time is not counted.
    # The shapes of MeshRanker.rank_placed, which makes 50 of the 57
    # score/stats launches and 50 of the 63 top-k launches: the int32
    # block under authority=15 with one host bin per padded row, and
    # tie_topk in tie mode on that step's scores, keyed on the docids
    pf, pd, pv, ph, npad = placed
    pst, pcnt = KC.cardinal_stats(pf, pv, ph, npad)
    p_scores = KC.cardinal_score(pf, None, pv, ph, pst, pcnt, mr._consts,
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
                path="placed", plain_reps=5):
        ms, dev_ms = KB.call_ms(kern), KB.device_ms(kern)
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
                         "batched_join": launches_bj}[path][name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev, "shape": shape, "path": path})

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
                                      mr._consts, False),
            lambda: KC.cardinal_score_plain(pf, None, pv, ph, pst, pcnt,
                                            mr._consts, False), None,
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
                path="devstore")
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
        k7 = lambda e=ext, s_=st_x, c_=c_x: KD.span_score(  # noqa: E731
            *ta[:4], e, s_, c_, n_x)
        k7p = lambda e=ext, s_=st_x, c_=c_x: KD.span_score_plain(  # noqa: E731
            *ta[:4], e, s_, c_, n_x)
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
    # 16 queries' spans (the store's one-span terms in turn), and the
    # batched scan at 16 slots (the 10M term's two spans and the 1M term
    # under the filtered-scan mix's four filters, k = 10 and 100),
    # K6 and K7 of the wave and its finish; each bound the slots' bytes
    # summed
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
            "the batcher's K5 wave (no init entries)", path="batched")

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
    desc_s = KD.scan_batch_desc(scans16)
    rows16 = [sum(c for _a, c in e) for e, _f in scans16]
    flag16 = sum(4 * r for r, (_e, f_) in zip(rows16, scans16)
                 if f_[1] != TD.NO_FLAG)
    off16 = KD.scan_batch_offsets(desc_s, kk)
    src_b6 = ("span_stats_batch",
              "yacy_search_server_tpu/index/devstore.py:465",
              "cardinal_stats.cu")
    src_b7 = ("span_score_batch",
              "yacy_search_server_tpu/index/devstore.py:465",
              "cardinal_score.cu")
    src_bf = ("topk_finish_batch",
              "yacy_search_server_tpu/index/devstore.py:1032",
              "pruned_tile.cu")
    k6w = lambda: KD.span_stats_batch(*garr5[:4], desc_s)  # noqa: E731
    k6wp = lambda: KD.span_stats_batch_plain(*garr5[:4], desc_s)  # noqa: E731
    st16, pst16 = k6w(), k6wp()
    note("span_stats_batch", "16 slots of the filtered-scan mix",
         max(stats_diff(st16[i], pst16[i]) for i in range(16)))
    shape16 = (f"16 filtered scans of {min(rows16)}-{max(rows16)} rows "
               f"({sum(rows16)} in all; the 10M term's two spans, the 1M "
               "term) under four filters")
    measure(*src_b6, k6w, k6wp, None,
            sum(rows16) * (P.NF * 2 + 4 + 1) + flag16
            + 16 * 4 * KC.STATS_LEN, 0.0, shape16, path="batched")
    k7w = lambda: KD.span_score_batch(  # noqa: E731
        *garr5[:4], desc_s, st16, cd, off16)
    k7wp = lambda: KD.span_score_batch_plain(  # noqa: E731
        *garr5[:4], desc_s, st16, cd, off16)
    g, w = k7w(), k7wp()
    torch.cuda.synchronize()
    note("span_score_batch", "16 slots of the filtered-scan mix", diff(g, w))
    # every slot's rows read, its whole region (rows, kk's pad and the
    # alignment) written
    measure(*src_b7, k7w, k7wp, None,
            sum(rows16) * row_b + 4 * int(off16[-1])
            + 4 * (16 * KC.STATS_LEN + KC.CONSTS_LEN), 0.0, shape16,
            path="batched")
    top16 = torch.empty((3, 16, kk), dtype=torch.int32, device=dev)
    for i, r_ in enumerate(rows16):
        KT.tie_topk(g[int(off16[i]):int(off16[i]) + max(r_, kk)], kk,
                    out=(top16[0, i], top16[1, i], top16[2, i]))
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
    del g, w, pst16

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
    routes["scan_batch_query, 16 filtered scans (batched K6, K7, 16 x "
           "kernel 3, finish) + one fetch"] = lambda: TD.scan_batch_query(
               garr5, scans16, cd, kk).cpu()
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
    for row, kern in zip(rows, timed):
        row["device_ops_per_call"], names = ops_per_call(kern)
        log(f"device ops a call, {row['name']} [{row['shape']}]: "
            f"{row['device_ops_per_call']} {names}")
    for label, fn in routes.items():
        log(f"device ops of one {label}: {ops_per_call(fn)[1]}")

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
