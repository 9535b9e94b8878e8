"""The batched exact scan alone at two shapes and three kk, on a
synthetic arena of the smoke's run on the card: K6 `span_stats_batch`
and K7 with its selection `span_topk_batch` (a tree whose K7 selects only
up to its FUSED_KK takes its former route past it: K7
`span_score_batch` into a region a slot, kernel 3 a slot and
`topk_finish_batch`). Each wave's answer is held against an oracle
built from the plain versions both trees have; then each kernel's call
ms and device ms, the wave's device operations and the wall of
`scan_batch_query` with its one fetch.

    python -m yacy_search_server_tpu_torch.kernels.scan_batch_bench
        [--tag T] [--out FILE] [--arena FILE] [--check] [--kk 128,4096]
    python -P yacy_search_server_tpu_torch/kernels/scan_batch_bench.py
        --tree DIR [--arena FILE]

--tree times the package of another checkout (a parent commit) in place
of this one (-P keeps this file's folder off the import path); --arena
keeps the arena in a file (a git-ignored path): the first run writes it,
the next ones read it, so that the trees of one call meet the same
bytes; --check holds the answers and times nothing; --kk the kk of the
waves (default 128, 2048, 4096).

The arena: the smoke's run, each term `bench.make_term(n, SEED + i)` in
the store's packing order (`bench.arena_rows`), one after another behind
5 pad rows: the headline term's two runs (10,000,000 and 100,000 rows),
1M, 100k, 20k, joinA (4M), joinB (30,000), joinC (2M); 1,000 docids
tombstoned. Shape A: the smoke's 16-slot wave (the headline term's two
spans and the 1M term, each under the filtered-scan mix's four filters
at k = 10 and 100: 88.8M slot-rows, 11.1M distinct). Shape B: one slot
a term under the mix's first filter, no span shared. Each at kk = 128
(the mix's k = 100), 2048 and 4096 (the mix's k = 3000).
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

TERMS = (("10M", 10_000_000), ("10M, run 2", 100_000), ("1M", 1_000_000),
         ("100k", 100_000), ("20k", 20_000), ("joinA", 4_000_000),
         ("joinB", 30_000), ("joinC", 2_000_000))
PAD = 5
EN, DE = 0x656E, 0x6465
LO, HI = -(2**30), 2**30
# the smoke's filtered-scan mix: its filtered query's filter, a
# language, a flag bit and a range, a start day
FILTERS = ((EN, 5, 3_000, 27_000), (DE, -1, LO, HI), (0, 7, LO, 20_000),
           (0, -1, 10_000, HI))
KKS = (128, 2048, 4096)


def make_arena(scale: float = 1.0, seed=None):
    """((feats16 [n, 17] int16, flags, docids, dead) numpy, spans: term ->
    (start, count)) of the synthetic arena, each term's rows scaled by
    `scale`."""
    from yacy_search_server_tpu_torch.kernels import bench as KB
    seed = KB.SEED if seed is None else seed
    rng = np.random.default_rng(seed)
    parts, spans, at = [], {}, PAD
    for i, (name, n) in enumerate(TERMS):
        n = max(1, int(n * scale))
        feats, docids, _h, _r = KB.make_term(n, seed + i)
        parts.append(KB.arena_rows(feats, docids))
        spans[name] = (at, n)
        at += n
    f16 = np.concatenate([np.zeros((PAD, 17), np.int16)]
                         + [p[0] for p in parts])
    fl = np.concatenate([np.zeros(PAD, np.int32)] + [p[1] for p in parts])
    d = np.concatenate([np.full(PAD, -1, np.int32)] + [p[2] for p in parts])
    dead = np.zeros(int(d.max()) + 1, bool)
    dead[rng.choice(dead.size, min(1_000, dead.size), replace=False)] = True
    return (f16, fl, d, dead), spans


def wave_shapes(spans) -> dict:
    """name -> the wave's scans, each (extents, filter)."""
    def ext(*names):
        return [spans[n] for n in names]
    head = ext("10M", "10M, run 2")
    return {
        "A": [(e, FILTERS[f]) for e in (head, ext("1M"))
              for f in range(len(FILTERS)) for _k in (10, 100)],
        "B": [(e, FILTERS[0]) for e in (
            head, ext("1M"), ext("100k"), ext("20k"), ext("joinA"),
            ext("joinB"), ext("joinC"))],
    }


def oracle(arrays, scans, consts, kk: int):
    """[bs, 2kk] from the plain versions of K6, K7 and kernel 3 and the
    finish's rule, slot by slot (functions every tree of the port has)."""
    from yacy_search_server_tpu_torch.kernels import devstore as KD
    from yacy_search_server_tpu_torch.kernels import topk as KT
    f, fl, d, dead = arrays
    out = []
    for ext, filt in scans:
        st = KD.span_stats_plain(f, d, dead, ext, flags=fl, filt=filt)
        n = sum(c for _s, c in ext)
        buf = KD.span_score_plain(f, fl, d, dead, ext, st, consts,
                                  max(n, kk), filt)
        top_s, _sec, top_r = KT.tie_topk_plain(buf, kk)
        out.append(torch.cat(KD._winners_plain(top_s, top_r, d, ext)))
    return torch.stack(out)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def wall_ms(fn, reps: int = 50) -> float:
    for _ in range(5):
        fn()
    w = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        w.append((time.perf_counter() - t) * 1e3)
    return float(np.median(w))


def run_shape(label, scans, arrays, consts, kk: int, check_only: bool):
    from yacy_search_server_tpu_torch.index import devstore as TD
    from yacy_search_server_tpu_torch.kernels import bench as KB
    from yacy_search_server_tpu_torch.kernels import devstore as KD
    from yacy_search_server_tpu_torch.kernels import topk as KT
    f, fl, d, dead = arrays
    desc = KD.scan_batch_desc(scans)
    bs = len(scans)
    arr5 = (f, fl, d, dead, None)
    got = TD.scan_batch_query(arr5, scans, consts, kk)
    want = oracle(arrays, scans, consts, kk)
    torch.cuda.synchronize()
    err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    row = {"shape": label, "slots": bs, "kk": kk, "err": err,
           "sha1": hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()}
    if check_only:
        return row
    k6 = lambda: KD.span_stats_batch(f, fl, d, dead, desc)  # noqa: E731
    st = k6()
    fns = {"k6": k6}
    if not (hasattr(KD, "span_score_batch") and kk > KD.FUSED_KK):
        fns["k7_select"] = lambda: KD.span_topk_batch(  # noqa: E731
            f, fl, d, dead, desc, st, consts, kk)
    else:
        off = KD.scan_batch_offsets(desc, kk)
        top = torch.empty((3, bs, kk), dtype=torch.int32, device=f.device)
        buf = KD.span_score_batch(f, fl, d, dead, desc, st, consts, off)

        def k3(buf=buf):
            for i, (ext, _f) in enumerate(scans):
                n = max(sum(c for _s, c in ext), kk)
                KT.tie_topk(buf[int(off[i]):int(off[i]) + n], kk,
                            out=(top[0, i], top[1, i], top[2, i]))

        def k7_select():
            k3(KD.span_score_batch(f, fl, d, dead, desc, st, consts, off))
        k3()
        fns["k7"] = lambda: KD.span_score_batch(  # noqa: E731
            f, fl, d, dead, desc, st, consts, off)
        fns["k3"] = k3
        fns["k7_select"] = k7_select
        fns["finish"] = lambda: KD.topk_finish_batch(  # noqa: E731
            top[0], top[2], d, desc)
    fns["wave"] = lambda: TD.scan_batch_query(  # noqa: E731
        arr5, scans, consts, kk)
    for name, fn in fns.items():
        row[f"{name}_ms"] = KB.call_ms(fn)
        row[f"{name}_device_ms"] = KB.device_ms(fn)
    ops = KB.device_ops(fns["wave"])
    row["wave_ops"] = len(ops)
    row["wave_op_list"] = ops
    row["route_wall_ms"] = wall_ms(lambda: TD.scan_batch_query(
        arr5, scans, consts, kk).cpu())
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="scan")
    ap.add_argument("--tree", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--arena", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--kk", default=",".join(str(k) for k in KKS))
    args = ap.parse_args(argv)
    # this checkout's root, or the other tree's
    sys.path.insert(0, args.tree or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    from yacy_search_server_tpu_torch.ops import ranking as R
    if not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        return 2
    t0 = time.time()
    dev = torch.device("cuda")
    if args.arena and os.path.exists(args.arena):
        z = np.load(args.arena)
        host = (z["f16"], z["fl"], z["d"], z["dead"])
        spans = {n: tuple(int(v) for v in z["spans"][i])
                 for i, (n, _c) in enumerate(TERMS)}
    else:
        host, spans = make_arena()
        if args.arena:
            np.savez(args.arena, f16=host[0], fl=host[1], d=host[2],
                     dead=host[3], spans=np.asarray(
                         [spans[n] for n, _c in TERMS], np.int64))
    arrays = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in host)
    consts = R.profile_consts(R.RankingProfile(), EN, dev)
    print(f"[{args.tag}] {card()}; set-up {time.time() - t0:.1f} s",
          flush=True)
    out = []
    for kk in (int(k) for k in args.kk.split(",")):
        for label, scans in wave_shapes(spans).items():
            row = {"tag": args.tag, **run_shape(label, scans, arrays, consts,
                                                kk, args.check)}
            print(json.dumps(row), flush=True)
            out.append(row)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(f"[{args.tag}] done {time.time() - t0:.1f} s", flush=True)
    return 0 if all(r["err"] == 0 for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
