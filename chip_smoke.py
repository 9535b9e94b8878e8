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
   of order;
3. drive the main path at the headline size, a 10M-posting term:
   CardinalRanker.rank (k = 10 and 100), MeshRanker.place once and 50
   rank_placed queries, MeshBM25.topk at 1M docs x 4 terms (k = 100), and
   stream_score_topk over the 10M block in 2M-row chunks; every result is
   checked against the port's numpy twins, and every kernel's launch
   count must move;
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
   one host (each checked first); rank_placed's wall per query over 50
   queries after a warm-up; and, last, the device operations one call of
   each timed kernel issues (a profiler trace).

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
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

N = 10_000_000            # postings of the headline term
CHUNK = 2_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
OPS_PER_S = 67e12          # H100 SXM non-tensor f32 peak (simple-op bound)


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from yacy_search_server_tpu_torch.index import postings as P
    from yacy_search_server_tpu_torch.kernels import LAUNCHES, build
    from yacy_search_server_tpu_torch.kernels import bench as KB
    from yacy_search_server_tpu_torch.kernels import cardinal as KC
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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

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
        """The device operations one call issues (kernels and memsets),
        from a profiler trace; None where the trace shows none."""
        try:
            names = KB.device_ops(fn)
        except Exception as ex:  # noqa: BLE001 - a reading aid, not a phase
            return None, [f"profiler failed: {ex!r}"]
        return len(names) or None, names

    def measure(name, replaces, src, kern, plain, lib, nbytes, nops, shape):
        ms, dev_ms = KB.call_ms(kern), KB.device_ms(kern)
        plain_ms = KB.call_ms(plain, reps=5)
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
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev, "shape": shape})

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

    log(f"total: {time.time() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
