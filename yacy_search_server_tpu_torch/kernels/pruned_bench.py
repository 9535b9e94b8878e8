"""K5 `pruned_tile` and K5bp `pruned_tile_bp` alone, on the card: the
pruned query's first tile of the smoke's 10M term (chip_smoke phase 4's
fresh store), int16 and bit-packed. Each shape's answer is held against
the kernel's plain version; then each kernel's call ms and device ms,
its device operations a call (a profiler trace), the wall of
`pruned_query` / `pruned_query_bp` with their one fetch, and an empty
kernel's call and device ms on the same queue (the latency floor beside
the bytes bound).

    python -m yacy_search_server_tpu_torch.kernels.pruned_bench
        [--tag T] [--out FILE] [--arena FILE] [--check] [--shapes S]
    python -P yacy_search_server_tpu_torch/kernels/pruned_bench.py
        --tree DIR [--arena FILE]

--tree times the package of another checkout (a parent commit) in place
of this one (-P keeps this file's folder off the import path); --arena
keeps the store in a file (a git-ignored path): the first run writes it,
the next ones read it, so that the trees of one call meet the same rows;
--check holds the answers and times nothing; --shapes takes a subset,
as "1x128,16x128" (bs x kk); --cluster 8 or 16 sets the CTAs a slot of
both kernels (`devstore.pruned_tile_cluster`), where the tree has it.

The store: `bench.make_term(10M)` in a DeviceSegmentStore built on the
CPU (the smoke's phase 4 store: no tombstone, so the bound is live), and
the same rows packed by `ops/packed.pack_block` in the store's order
(`bench.arena_rows`) behind 5 pad words. Shapes: bs 1, 2 and 16 at kk
16, 128 and 2048. K5's slots sit on the span's first bs tiles
(`bench.tile_slots`, as the smoke's); K5bp's are the block's first tile
bs times (a packed span is read from its first row).
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

N = 10_000_000
PAD = 5
SHAPES = [(bs, kk) for bs in (1, 2, 16) for kk in (16, 128, 2048)]


def make_store():
    """The arrays (feats16, flags, docids, dead, pmax), the span's fields
    (start, count, tstart, tcount, col_min, col_max, tf_min, tf_max) and
    the packed words with the block's (wbase, meta, row_bits)."""
    from yacy_search_server_tpu_torch.index import devstore as TD
    from yacy_search_server_tpu_torch.index import postings as P
    from yacy_search_server_tpu_torch.index.rwi import RWIIndex
    from yacy_search_server_tpu_torch.kernels import bench as KB
    from yacy_search_server_tpu_torch.ops import packed as TPK
    feats, docids, _h, _r = KB.make_term(N)
    idx = RWIIndex()
    idx.add_many(b"headlineAAAA", P.PostingsList(docids, feats))
    idx.flush()
    st = TD.DeviceSegmentStore(idx, device="cpu")
    sp = st.spans_for(b"headlineAAAA")[0]
    arrays = [np.asarray(a.numpy()) for a in st.arena.arrays()]
    arrays += [st.arena.dead_array().numpy(), st.arena._pmax.numpy()]
    s = sp.stats
    span = (sp.start, sp.count, sp.tstart, sp.tcount,
            np.asarray(s["col_min"], np.int32),
            np.asarray(s["col_max"], np.int32), np.float32(s["tf_min"]),
            np.float32(s["tf_max"]))
    blk = TPK.pack_block(*KB.arena_rows(feats, docids))
    words = np.concatenate([np.zeros(PAD, np.int32), blk.words])
    return arrays, span, (words, PAD, blk.meta_vector(), blk.row_bits)


def save(path, arrays, span, packed):
    np.savez(path, **{f"a{i}": a for i, a in enumerate(arrays)},
             span=np.asarray(span[:4], np.int64), cmin=span[4],
             cmax=span[5], tf=np.asarray(span[6:], np.float32),
             words=packed[0], meta=packed[2],
             pk=np.asarray([packed[1], packed[3]], np.int64))


def load(path):
    z = np.load(path)
    arrays = [z[f"a{i}"] for i in range(5)]
    s = z["span"]
    span = (int(s[0]), int(s[1]), int(s[2]), int(s[3]), z["cmin"],
            z["cmax"], z["tf"][0], z["tf"][1])
    return arrays, span, (z["words"], int(z["pk"][0]), z["meta"],
                          int(z["pk"][1]))


def run_shape(bs, kk, dev, arrays, span, packed, consts, shift, lang,
              check_only: bool):
    from yacy_search_server_tpu_torch.index import devstore as TD
    from yacy_search_server_tpu_torch.index import postings as P
    from yacy_search_server_tpu_torch.kernels import bench as KB
    from yacy_search_server_tpu_torch.kernels import cardinal as KC
    from yacy_search_server_tpu_torch.kernels import devstore as KD
    from yacy_search_server_tpu_torch.kernels import packed as KP
    from yacy_search_server_tpu_torch.kernels import scan_batch_bench as SBB
    words, wbase, meta, row_bits = packed
    start, count, tstart, tcount = span[:4]
    stats = {"col_min": span[4], "col_max": span[5], "tf_min": span[6],
             "tf_max": span[7]}
    sp = TD.Span(start, count, tstart, tcount, stats)
    desc = KD.pack_desc(KB.tile_slots(sp, bs), shift, lang)
    slot = (wbase, count, tstart, tcount, *span[4:])
    desc_bp = KP.pack_desc_bp([slot] * bs, [meta] * bs, shift, lang)
    fns = {
        "k5": (lambda: KD.pruned_tile(*arrays, desc, kk, consts, True),
               lambda: KD.pruned_tile_plain(*arrays, desc, kk, consts,
                                            True)),
        "k5bp": (lambda: KP.pruned_tile_bp(words, arrays[3], arrays[4],
                                           desc_bp, kk, consts),
                 lambda: KP.pruned_tile_bp_plain(words, arrays[3],
                                                 arrays[4], desc_bp, kk,
                                                 consts)),
    }
    row = {"bs": bs, "kk": kk, "row_bits": row_bits}
    for name, (kern, plain) in fns.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        row[f"{name}_err"] = float((got.to(torch.int64)
                                    - want.to(torch.int64)).abs().max())
    if check_only:
        return row
    for name, (kern, _plain) in fns.items():
        row[f"{name}_ms"] = KB.call_ms(kern)
        row[f"{name}_device_ms"] = KB.device_ms(kern)
        ops = KB.device_ops(kern)
        row[f"{name}_ops"] = len(ops)
        row[f"{name}_op_list"] = ops
    # the bytes each call must move at 3.35 TB/s: K5 a tile a slot (34 B
    # features, flags, docid, a tombstone byte a row), K5bp the one tile
    # once (row_bits / 8 and a tombstone byte a row); both the pmax tail,
    # the descriptor's slots and the output rows
    tail = 4 * (tcount - 1) + 4 * KC.CONSTS_LEN
    row_b = P.NF * 2 + 4 + 4 + 1
    out_b = 4 * (2 * kk + 1)
    row["k5_bound_ms"] = (bs * (TD.TILE * row_b + 4 * KD.DESC_SLOT_WORDS
                                + out_b) + tail) / 3.35e12 * 1e3
    row["k5bp_bound_ms"] = (TD.TILE * (row_bits / 8 + 1) + tail
                            + bs * (4 * KP.BP_SLOT_WORDS + out_b)) \
        / 3.35e12 * 1e3
    if bs == 1:
        psp = TD.Span(-1, count, tstart, tcount, stats, pbase=wbase,
                      pmeta=meta, row_bits=row_bits)
        row["route_wall_ms"] = SBB.wall_ms(lambda: TD.pruned_query(
            arrays, sp, shift, lang, consts, kk, 1).cpu())
        row["route_bp_wall_ms"] = SBB.wall_ms(lambda: TD.pruned_query_bp(
            words, arrays[3], arrays[4], psp, shift, lang, consts,
            kk).cpu())
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="pruned")
    ap.add_argument("--tree", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--arena", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--cluster", type=int, default=None)
    args = ap.parse_args(argv)
    shapes = SHAPES if not args.shapes else [
        tuple(int(v) for v in x.split("x")) for x in args.shapes.split(",")]
    # this checkout's root, or the other tree's
    sys.path.insert(0, args.tree or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    from yacy_search_server_tpu_torch.index import devstore as TD
    from yacy_search_server_tpu_torch.kernels import bench as KB
    from yacy_search_server_tpu_torch.kernels import scan_batch_bench as SBB
    from yacy_search_server_tpu_torch.ops import ranking as R
    if not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        return 2
    t0 = time.time()
    dev = torch.device("cuda")
    if args.arena and os.path.exists(args.arena):
        arrays, span, packed = load(args.arena)
    else:
        arrays, span, packed = make_store()
        if args.arena:
            save(args.arena, arrays, span, packed)
    arrays = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in arrays]
    packed = (torch.from_numpy(packed[0]).to(dev), *packed[1:])
    from yacy_search_server_tpu_torch.kernels import devstore as KD
    if args.cluster and hasattr(KD, "pruned_tile_cluster"):
        for packed_ in (False, True):
            KD.pruned_tile_cluster(dev, packed=packed_, size=args.cluster)
    prof = R.RankingProfile()
    consts = R.profile_consts(prof, SBB.EN, dev)
    shift, lang = (int(v) for v in TD.prune_bound_consts(prof))
    print(f"[{args.tag}] {SBB.card()}; set-up {time.time() - t0:.1f} s",
          flush=True)
    out = []
    if not args.check:
        empty = {"tag": args.tag, "empty_ms": KB.call_ms(KB.empty_launch),
                 "empty_device_ms": KB.device_ms(KB.empty_launch)}
        if hasattr(KD, "pruned_tile_cluster"):
            empty["clusters"] = [KD.pruned_tile_cluster(dev, packed=p_)
                                 for p_ in (False, True)]
        print(json.dumps(empty), flush=True)
    for bs, kk in shapes:
        row = {"tag": args.tag, **run_shape(bs, kk, dev, arrays, span,
                                            packed, consts, shift, lang,
                                            args.check)}
        print(json.dumps(row), flush=True)
        out.append(row)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(f"[{args.tag}] done {time.time() - t0:.1f} s", flush=True)
    return 0 if all(r["k5_err"] == 0 and r["k5bp_err"] == 0
                    for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
