"""The packed exact scan alone, on the card: K6bp `span_stats_bp` and K7bp
with its selection `span_topk_bp` (a tree without it: K7bp
`span_score_bp`, kernel 3 in index mode and `topk_finish_bp`), over the
smoke's terms packed into one words store. Each scan's answer is held
against an oracle built from the plain versions both trees have; then
each kernel's call ms and device ms, the scan's device operations and
the wall of `scan_query_bp` with its one fetch.

    python -m yacy_search_server_tpu_torch.kernels.packed_scan_bench
        [--tag T] [--out FILE] [--arena FILE] [--check]
    python -P yacy_search_server_tpu_torch/kernels/packed_scan_bench.py
        --tree DIR [--arena FILE]

--tree times the package of another checkout (a parent commit) in place
of this one (-P keeps this file's folder off the import path); --arena
keeps the store in a file (a git-ignored path): the first run writes it,
the next ones read it, so that the trees of one call meet the same
words; --check holds the answers and times nothing.

The store: the smoke's terms 10M, 1M, 20k and joinA (4M), each
`bench.make_term(n, SEED + i)` (i its place in scan_batch_bench.TERMS)
in the store's packing order (`bench.arena_rows`), packed by
`ops/packed.pack_block` one after another behind 5 pad words; 1,000
docids tombstoned. Shapes, all at kk = 128: the 10M block with no
filter and under the filtered rank_term's filter (scan_batch_bench.
FILTERS[0]), the 1M and 20k blocks under that filter.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

BLOCKS = (("10M", 10_000_000, 0), ("1M", 1_000_000, 2),
          ("20k", 20_000, 4), ("joinA", 4_000_000, 5))
PAD = 5
KK = 128


def make_store(scale: float = 1.0, seed=None):
    """(words int32, dead bool, {name: (wbase, count, meta int32[57],
    row_bits)}) of the packed store, each term's rows scaled by
    `scale`."""
    from yacy_search_server_tpu_torch.kernels import bench as KB
    from yacy_search_server_tpu_torch.ops import packed as TPK
    seed = KB.SEED if seed is None else seed
    rng = np.random.default_rng(seed)
    parts, spans, at, top = [], {}, 0, 0
    for name, n, i in BLOCKS:
        n = max(1, int(n * scale))
        feats, docids, _h, _r = KB.make_term(n, seed + i)
        blk = TPK.pack_block(*KB.arena_rows(feats, docids))
        parts += [np.zeros(PAD, np.int32), blk.words]
        at += PAD
        spans[name] = (at, n, blk.meta_vector(), blk.row_bits)
        at += len(blk.words)
        top = max(top, int(docids.max()))
    dead = np.zeros(top + 1, bool)
    dead[rng.choice(dead.size, min(1_000, dead.size), replace=False)] = True
    return np.concatenate(parts), dead, spans


def shapes() -> dict:
    """label -> (block, filter)."""
    from yacy_search_server_tpu_torch.kernels import scan_batch_bench as SBB
    hf = SBB.FILTERS[0]
    return {"10M, no filter": ("10M", None), "10M, filtered": ("10M", hf),
            "1M, filtered": ("1M", hf), "20k, filtered": ("20k", hf)}


def oracle(words, dead, wbase, meta, count, consts, kk, filt):
    """[2kk] from the plain versions of K6bp, K7bp, kernel 3 and the
    finish (functions every tree of the port has)."""
    from yacy_search_server_tpu_torch.kernels import packed as KP
    from yacy_search_server_tpu_torch.kernels import topk as KT
    st = KP.span_stats_bp_plain(words, dead, wbase, meta, count, filt)
    buf = KP.span_score_bp_plain(words, dead, wbase, meta, count, st,
                                 consts, max(count, kk), filt)
    top_s, top_r, _ = KT.tie_topk_plain(buf, kk)
    return KP.topk_finish_bp_plain(top_s, top_r, words, wbase, meta, count)


def run_shape(label, block, filt, store, consts, kk: int, check_only: bool):
    from yacy_search_server_tpu_torch.index import devstore as TD
    from yacy_search_server_tpu_torch.index import postings as P
    from yacy_search_server_tpu_torch.kernels import bench as KB
    from yacy_search_server_tpu_torch.kernels import devstore as KD
    from yacy_search_server_tpu_torch.kernels import packed as KP
    from yacy_search_server_tpu_torch.kernels import topk as KT
    from yacy_search_server_tpu_torch.kernels import scan_batch_bench as SBB
    from yacy_search_server_tpu_torch.ops import packed as TPK
    words, dead, spans = store
    wbase, n, meta, row_bits = spans[block]
    sp = TD.Span(start=-1, count=n, pbase=wbase, pmeta=meta,
                 row_bits=row_bits)
    got = TD.scan_query_bp(words, dead, sp, consts, kk, filt)
    want = oracle(words, dead, wbase, meta, n, consts, kk, filt)
    torch.cuda.synchronize()
    err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    row = {"shape": label, "rows": n, "row_bits": row_bits, "kk": kk,
           "err": err, "live": int((got[:kk] > -(2**31 - 1)).sum())}
    if check_only:
        return row
    k6 = lambda: KP.span_stats_bp(words, dead, wbase, meta, n,  # noqa: E731
                                  filt)
    st = k6()
    fns = {"k6": k6}
    if hasattr(KP, "span_topk_bp"):
        fns["k7_select"] = lambda: KP.span_topk_bp(  # noqa: E731
            words, dead, wbase, meta, n, st, consts, kk, filt)
    else:
        buf = KP.span_score_bp(words, dead, wbase, meta, n, st, consts,
                               max(n, kk), filt)
        top = KT.tie_topk(buf, kk)

        def k7_select():
            b = KP.span_score_bp(words, dead, wbase, meta, n, st, consts,
                                 max(n, kk), filt)
            t = KT.tie_topk(b, kk)
            return KP.topk_finish_bp(t[0], t[1], words, wbase, meta, n)
        fns["k7"] = lambda: KP.span_score_bp(  # noqa: E731
            words, dead, wbase, meta, n, st, consts, max(n, kk), filt)
        fns["k3"] = lambda: KT.tie_topk(buf, kk)  # noqa: E731
        fns["finish"] = lambda: KP.topk_finish_bp(  # noqa: E731
            top[0], top[1], words, wbase, meta, n)
        fns["k7_select"] = k7_select
    fns["scan"] = lambda: TD.scan_query_bp(  # noqa: E731
        words, dead, sp, consts, kk, filt)
    for name, fn in fns.items():
        row[f"{name}_ms"] = KB.call_ms(fn)
        row[f"{name}_device_ms"] = KB.device_ms(fn)
    ops = KB.device_ops(fns["scan"])
    row["scan_ops"] = len(ops)
    row["scan_op_list"] = ops
    row["route_wall_ms"] = SBB.wall_ms(lambda: TD.scan_query_bp(
        words, dead, sp, consts, kk, filt).cpu())
    # the bytes each pass must move at 3.35 TB/s: the columns it stages
    # and a tombstone byte a row. K6bp: every feature column and the
    # docids, the flags where the filter tests one; the selection: the
    # scored columns (not the doctype nor the flags feature column), the
    # flags and the docids
    wid = np.asarray(meta[TPK.NCOLS:2 * TPK.NCOLS], np.int64)
    flags = filt is not None and filt[1] != KD.NO_FLAG
    k6_bits = int(wid.sum()) - (0 if flags else int(wid[TPK.C_FLAGS]))
    k7_bits = int(wid.sum()) - int(wid[4]) - int(wid[P.F_FLAGS])
    for name, bits in (("k6", k6_bits), ("k7_select", k7_bits)):
        row[f"{name}_bound_ms"] = n * (bits / 8 + 1) / 3.35e12 * 1e3
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="packed")
    ap.add_argument("--tree", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--arena", default=None)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    # this checkout's root, or the other tree's
    sys.path.insert(0, args.tree or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    from yacy_search_server_tpu_torch.kernels import scan_batch_bench as SBB
    from yacy_search_server_tpu_torch.ops import ranking as R
    if not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        return 2
    t0 = time.time()
    dev = torch.device("cuda")
    if args.arena and os.path.exists(args.arena):
        z = np.load(args.arena)
        words, dead = z["words"], z["dead"]
        spans = {name: (int(z["spans"][i, 0]), int(z["spans"][i, 1]),
                        z["metas"][i], int(z["spans"][i, 2]))
                 for i, (name, _n, _s) in enumerate(BLOCKS)}
    else:
        words, dead, spans = make_store()
        if args.arena:
            np.savez(args.arena, words=words, dead=dead,
                     spans=np.asarray([(spans[b][0], spans[b][1],
                                        spans[b][3]) for b, _n, _s in BLOCKS],
                                      np.int64),
                     metas=np.stack([spans[b][2] for b, _n, _s in BLOCKS]))
    store = (torch.from_numpy(words).to(dev), torch.from_numpy(dead).to(dev),
             spans)
    consts = R.profile_consts(R.RankingProfile(), SBB.EN, dev)
    print(f"[{args.tag}] {SBB.card()}; set-up {time.time() - t0:.1f} s",
          flush=True)
    out = []
    for label, (block, filt) in shapes().items():
        row = {"tag": args.tag, **run_shape(label, block, filt, store,
                                            consts, KK, args.check)}
        print(json.dumps(row), flush=True)
        out.append(row)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(f"[{args.tag}] done {time.time() - t0:.1f} s", flush=True)
    return 0 if all(r["err"] == 0 for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
