#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build the port's CUDA kernels from kernels/csrc (nvcc, sm_90a);
2. hold every kernel against its plain PyTorch version on the card:
   kernels 1-2 on a 10M-row compact block and a 10M-row int32 block under
   the default and authority=15 profiles; kernel 3 at k = 10, 100, 1000
   with int32 and f32 scores and constructed ties; kernel 4 over 1, 8 and
   16 shards' blocks, f32 and int32, with cross-shard ties;
3. drive the main path at the headline size, a 10M-posting term:
   CardinalRanker.rank (k = 10 and 100), MeshRanker.place once and 50
   rank_placed queries, MeshBM25.topk at 1M docs x 4 terms (k = 100), and
   stream_score_topk over the 10M block in 2M-row chunks; every result is
   checked against the port's numpy twins, and every kernel's launch
   count must move;
4. time each kernel at the main path's shapes (CUDA events, median),
   beside its plain version, its bound and, for kernel 3, torch.topk.

Prints the card's name and power limit, one JSON line of kernel
measurements, and last `{"ok": true, "device": {...}}`. Needs a CUDA
device and the repository around it; imports nothing of JAX.
"""

from __future__ import annotations

import json
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
SEED = 20261016


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
    rng = np.random.default_rng(SEED)
    feats = rng.integers(0, 30000, (N, P.NF), dtype=np.int32)
    feats[:, P.F_FLAGS] = rng.integers(0, 2**30, N, dtype=np.int32)
    feats[:, P.F_HITCOUNT] = rng.integers(0, 256, N, dtype=np.int32)
    feats[:, P.F_DOMLENGTH] = rng.integers(0, 256, N, dtype=np.int32)
    feats[:, P.F_LANGUAGE] = np.where(rng.random(N) < 0.5, 0x656E, 0x6465)
    docids = np.arange(N, dtype=np.int32) * 2 + 1
    hostids = rng.integers(0, 50_000, N, dtype=np.int32)
    # the best row repeated: equal scores reach the top-k on purpose
    best = np.argmax(R.cardinal_scores_host(feats[:100_000],
                                            R.RankingProfile()))
    feats[::500_009] = feats[best]
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
    scores_main = sc

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

    for shards in (1, 8, 16):
        for is_float in (False, True):
            k = 1000
            vals = rng.integers(0, 40, shards * k)
            col = ((vals * 0.5).astype(np.float32).view(np.int32)
                   if is_float else vals.astype(np.int32))
            dids = rng.integers(-1, 100_000, shards * k, dtype=np.int32)
            block = put(np.stack([col, dids], 1))
            g = KT.gather_topk(block, k, is_float)
            w = KT.gather_topk_plain(block, k, is_float)
            torch.cuda.synchronize()
            e = max(diff(g[0], w[0]), diff(g[1], w[1]))
            log(f"check gather_topk shards={shards} float={is_float}: "
                f"err {e}")
            if e:
                fail(f"gather_topk disagrees (shards={shards})")
            err["gather_topk"] = max(err["gather_topk"], e)
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
    def cuda_ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return float(np.median(out))

    c0 = consts["default"]
    st, cnt = KC.cardinal_stats(f16_d, v_d, h_d, 0)
    k_main = 100
    bm = torch.from_numpy(rng.random(k_main).astype(np.float32)).to(dev)
    g_block = torch.stack([bm.view(torch.int32), d_d[:k_main]], 1)
    n16 = N * P.NF * 2
    rows = []
    specs = [
        ("cardinal_stats", "yacy_search_server_tpu/ops/ranking.py:193",
         "cardinal_stats.cu",
         lambda: KC.cardinal_stats(f16_d, v_d, h_d, 0),
         lambda: KC.cardinal_stats_plain(f16_d, v_d, h_d, 0),
         None, n16 + N + KC.STATS_LEN * 4 + 4, 0.0,
         "10M x 17 int16 + valid, no host counts (default profile)"),
        ("cardinal_score", "yacy_search_server_tpu/ops/ranking.py:242",
         "cardinal_score.cu",
         lambda: KC.cardinal_score(f16_d, fl_d, v_d, h_d, st, cnt, c0, True),
         lambda: KC.cardinal_score_plain(f16_d, fl_d, v_d, h_d, st, cnt, c0,
                                         True),
         None, n16 + 4 * N + N + 4 * N, 0.0,
         "10M compact rows + flags + valid -> int32 scores"),
        ("tie_topk", "yacy_search_server_tpu/ops/ranking.py:410",
         "tie_topk.cu",
         lambda: KT.tie_topk(scores_main, k_main, payload=d_d),
         lambda: KT.tie_topk_plain(scores_main, k_main, payload=d_d),
         lambda: torch.topk(scores_main, k_main),
         4 * N + 4 * k_main + 12 * k_main, 0.0,
         "10M int32 scores, k=100, docid payload"),
        ("gather_topk", "yacy_search_server_tpu/parallel/mesh.py:147",
         "gather_topk.cu",
         lambda: KT.gather_topk(g_block, k_main, True),
         lambda: KT.gather_topk_plain(g_block, k_main, True),
         None, 8 * k_main + 8 * k_main, 2.0 * k_main * k_main,
         "one shard's (100, 2) f32 block, k=100"),
    ]
    for (name, replaces, src, kern, plain, lib, nbytes, nops,
         shape) in specs:
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain, reps=5)
        lib_ms = cuda_ms(lib) if lib is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        log(f"kernel {name} [{shape}]: {ms:.4f} ms, plain {plain_ms:.4f} ms"
            f", bound {bound:.4f} ms ({nbytes} bytes / 3.35 TB/s"
            f"{'' if not nops else f', {nops:.0f} ops / 67 Tops/s'})"
            + (f", library {lib_ms:.4f} ms" if lib_ms is not None else ""))
        rows.append({
            "name": name, "route": "cuda",
            "source": f"yacy_search_server_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms})
    # extra shapes of the other paths, for PERF.md
    for shards in (8, 16):
        blk = torch.stack([
            torch.randint(0, 40, (shards * 1000,), device=dev,
                          dtype=torch.int32),
            torch.arange(shards * 1000, device=dev, dtype=torch.int32)], 1)
        log(f"kernel gather_topk [{shards} shards x 1000, k=1000]: "
            f"{cuda_ms(lambda: KT.gather_topk(blk, 1000, False)):.4f} ms")
    for k in (10, 1000):
        log(f"kernel tie_topk [10M int32, k={k}]: "
            f"{cuda_ms(lambda: KT.tie_topk(scores_main, k, payload=d_d)):.4f}"
            f" ms, torch.topk "
            f"{cuda_ms(lambda: torch.topk(scores_main, k)):.4f} ms")
    log("kernel cardinal_stats [10M x 17 int32, 10M host bins]: "
        f"{cuda_ms(lambda: KC.cardinal_stats(f32_d, v_d, h_d, N)):.4f} ms")

    log(f"total: {time.time() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
