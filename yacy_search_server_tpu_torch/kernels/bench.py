"""The smoke's data and timers for the port's kernels on one CUDA card.

`make_term` makes the smoke's 10M-posting term from its seed,
`edge_block` a block at the edges of `cardinal_score`'s int32
arithmetic, `sorted_runs` the gathered block of a fusion (one sorted
run a shard), `devstore_edges` a device store whose arena holds the
devstore kernels' edge cases (`edge_slots`, `edge_extents`,
`tile_slots` address it), `join_edges` a store whose join tables hold
K8's edge cases (`join_edge_cases` lists them), `arena_rows` /
`devstore_oracle` the numpy answer `rank_term` must give and
`devjoin_oracle` the one `rank_join` must give; `clustered_vectors`
the dense-first path's corpus and `ann_wave` a K15 wave's descriptors;
`edge_list` a BlockRank edge list of uniform edges (and a hub),
`host_graph` BlockRank's host link graph at one node's WebStructureGraph
limit and `link_docs` the documents of the postprocessing path.
`call_ms` times one call between two
CUDA events as the host issues it from an idle queue (the `ms` of
chip_smoke.py);
`device_ms` times the device alone, the calls queued behind a spin
kernel. `empty_launch` launches an empty kernel (the floor of a call),
`device_ops` lists the device operations one call issues with their
device times (a profiler trace). `topk_trace` reads `tie_topk`'s per-pass trace, which the kernel
library holds only when built with YT_KERNEL_TRACE=1.
"""

from __future__ import annotations

import statistics
import time

import numpy as np

SEED = 20261016


def make_term(n: int, seed: int = SEED):
    """(feats int32 [n, 17], docids int32 [n], hostids int32 [n], rng) of
    the smoke's synthetic term: random columns in their real ranges, 50,000
    hosts, and the best row of the first 100,000 repeated every 500,009
    rows so that equal scores reach the top-k."""
    from ..index import postings as P
    from ..ops import ranking as R
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 30000, (n, P.NF), dtype=np.int32)
    feats[:, P.F_FLAGS] = rng.integers(0, 2**30, n, dtype=np.int32)
    feats[:, P.F_HITCOUNT] = rng.integers(0, 256, n, dtype=np.int32)
    feats[:, P.F_DOMLENGTH] = rng.integers(0, 256, n, dtype=np.int32)
    feats[:, P.F_LANGUAGE] = np.where(rng.random(n) < 0.5, 0x656E, 0x6465)
    docids = np.arange(n, dtype=np.int32) * 2 + 1
    hostids = rng.integers(0, 50_000, n, dtype=np.int32)
    best = np.argmax(R.cardinal_scores_host(feats[:min(n, 100_000)],
                                            R.RankingProfile()))
    feats[::500_009] = feats[best]
    return feats, docids, hostids, rng


def host_mix(mix: str, n: int, rng, hosts: int = 50_000):
    """int32 host ids of n postings, each drawn on its own: "uniform" over
    `hosts` hosts (make_term's), "zipf" over `hosts` hosts with
    P(rank r) ~ r^-1.1 (the exponent of the repo's Zipf query mixes,
    CHAOS_r02.json) and the ranks given random ids, or "one" host."""
    if mix == "uniform":
        return rng.integers(0, hosts, n, dtype=np.int32)
    if mix == "zipf":
        p = np.arange(1, hosts + 1, dtype=np.float64) ** -1.1
        ids = rng.permutation(hosts).astype(np.int32)
        return ids[rng.choice(hosts, n, p=p / p.sum())]
    if mix == "one":
        return np.full(n, hosts // 2, np.int32)
    raise ValueError(f"unknown host mix {mix!r}")


# cardinal_score's int32 edges: column spans (max - min, wrapping), column
# minima, and offsets from the minimum, whose (f - min) * 256 lands on and
# beside both int32 wrap boundaries (2^23 * 256 = 2^31)
EDGE_SPANS = (1, 2, 2**31 - 1, 0, 3, 2**31 - 2, -5, 255, 65537, 1)
EDGE_MINS = (-2**31, -2**31 + 1, -2**23, -1, 0, 1, 2**31 - 1, -2**23 + 100)
EDGE_DELTAS = (0, 1, -1, 2**23 - 1, 2**23, 2**23 + 1, -2**23 - 1, -2**23,
               -2**23 + 1, 2**24 - 1, 2**31 - 1, -2**31, 255, 256)


def edge_block(n: int, seed: int = SEED):
    """(feats int32 [n, 17], col_min int32 [17], col_max int32 [17]) at the
    edges of cardinal_score's int32 arithmetic, to stand in for the
    statistics' column bounds: spans of 0, 1, 2, 3, 2^31-2, 2^31-1 and a
    wrapped negative one, minima at both ends of int32, and features at
    offsets from the minimum whose product by 256 wraps or just does not.
    The term-frequency columns keep their real values (their minima are
    the extremes), so the tf sum does not wrap."""
    from ..index import postings as P
    feats, _, _, rng = make_term(n, seed)
    wrap = lambda x: ((np.asarray(x, np.int64) + 2**31) % 2**32  # noqa: E731
                      - 2**31)
    tf_cols = (P.F_WORDS_IN_TITLE, P.F_WORDS_IN_TEXT, P.F_HITCOUNT)
    free = [c for c in range(P.NF)
            if c not in tf_cols and c not in (4, P.F_LANGUAGE, P.F_FLAGS,
                                              P.F_DOMLENGTH)]
    cmin = np.zeros(P.NF, np.int64)
    cmax = np.zeros(P.NF, np.int64)
    for i, c in enumerate(free + list(tf_cols)):
        cmin[c] = EDGE_MINS[i % len(EDGE_MINS)]
        cmax[c] = wrap(cmin[c] + EDGE_SPANS[i % len(EDGE_SPANS)])
    for c in free:
        d = rng.choice(np.array(EDGE_DELTAS, np.int64), n)
        wild = rng.random(n) < 0.25
        d[wild] = rng.integers(-2**31, 2**31, int(wild.sum()))
        feats[:, c] = wrap(cmin[c] + d)
    return feats, cmin.astype(np.int32), cmax.astype(np.int32)


def sorted_runs(shards: int, rows: int, is_float: bool, rng, pad: int = 0,
                special: bool = False):
    """A gathered [shards * rows, 2] int32 block (CPU) of `shards` sorted
    runs, as the fusion gathers them: each run the tie_topk_plain of
    random scores with few values (so that scores tie within and across
    runs), its last `pad` rows padding (docid -1, score -inf or
    -(2^31-1)), and with `special` f32 NaN, -0.0, +0.0 and -inf or int32
    -2^31 among the scores."""
    import torch
    from .topk import tie_topk_plain
    cols = []
    for _ in range(shards):
        if is_float:
            s = (rng.integers(0, 50, rows) * 0.5).astype(np.float32)
            if special:
                s[::5] = np.nan
                s[1::7] = -0.0
                s[2::7] = 0.0
                s[3::11] = -np.inf
        else:
            s = rng.integers(0, 50, rows).astype(np.int32)
            if special:
                s[::5] = -(2**31)
        d = rng.integers(0, 5000, rows).astype(np.int32)
        if pad:
            s[rows - pad:] = -np.inf if is_float else -(2**31 - 1)
            d[rows - pad:] = -1
        ts, td, _ = tie_topk_plain(torch.from_numpy(s), rows,
                                   secondary=torch.from_numpy(d))
        cols.append(torch.stack([ts.view(torch.int32) if is_float else ts,
                                 td], 1))
    return torch.cat(cols)


# the spans of devstore_edges: rows, docid start and step, tie period
EDGE_TERMS = {
    b"bigAAAAAAAAA": (3 * 32_768 + 123, 0, 2, 97),   # ragged last tile
    b"almostAAAAAA": (32_768 - 5, 1, 2, 31),
    b"shortAAAAAAA": (700, 200_001, 5, 0),
    b"deadAAAAAAAA": (40, 3, 1000, 0),               # every row tombstoned
}
EDGE_DEAD = (0, 2, 4, 64, 1_000, 3_003, 40_003)


def devstore_edges(device, seed: int = SEED):
    """(store, rwi) over EDGE_TERMS in one run on `device`: make_term's
    columns with one column constant, the best row repeated every `tie`
    rows (equal scores ranked by arena position), docids past the
    bitmap's 65,536 slots that stay alive, and tombstones after the pack
    (EDGE_DEAD and every row of the dead term)."""
    from ..index.devstore import DeviceSegmentStore
    from ..index.postings import F_LASTMOD, PostingsList
    from ..index.rwi import RWIIndex
    from ..ops import ranking as R
    idx = RWIIndex()
    for i, (th, (n, base, step, tie)) in enumerate(EDGE_TERMS.items()):
        feats, _, _, _ = make_term(n, seed + i)
        feats[:, F_LASTMOD] = 4321
        if tie:
            feats[::tie] = feats[np.argmax(R.cardinal_scores_host(
                feats, R.RankingProfile()))]
        idx.add_many(th, PostingsList(
            (base + step * np.arange(n)).astype(np.int32), feats))
    idx.flush()
    store = DeviceSegmentStore(idx, device=device)
    n, base, step, _ = EDGE_TERMS[b"deadAAAAAAAA"]
    for d in EDGE_DEAD + tuple(range(base, base + n * step, step)):
        idx.delete_doc(d)
    return store, idx


def edge_slots(store, bs: int):
    """K5 slots over the edge spans, repeated to bs - 2, then two pad
    slots (all fields 0, tcount 0)."""
    spans = [store.spans_for(th)[0] for th in EDGE_TERMS]
    zero = np.zeros(17, np.int32)
    out = []
    for i in range(max(bs - 2, 1)):
        sp = spans[i % len(spans)]
        st = sp.stats
        out.append((sp.start, sp.count, sp.tstart, sp.tcount,
                    st["col_min"], st["col_max"], st["tf_min"],
                    st["tf_max"]))
    return (out + [(0, 0, 0, 0, zero, zero, np.float32(0),
                    np.float32(0))] * 2)[:bs]


# K5's tile edges: rows, docid base. A span shorter than every kk (its
# places past the count keep the tile's docids), one of exactly one tile,
# one whose every row is tombstoned (across the first CTA's 2,048 rows),
# and one of equal scores whose live places straddle the CTA boundaries
# at 2,048 and 4,096 (TIES_LIVE; its other rows tombstoned).
TILE_EDGE_TERMS = {
    b"tinyAAAAAAAA": (9, 1_000_000),
    b"onetileAAAAA": (32_768, 2_000_000),
    b"deadtileAAAA": (2_100, 3_000_000),
    b"tiesAAAAAAAA": (5_000, 4_000_000),
}
TIES_LIVE = ((2_040, 2_050), (4_090, 4_100))


def tile_edges(rwi, make_store, plist=None, seed: int = SEED):
    """TILE_EDGE_TERMS added to `rwi` (the port's RWIIndex, or the JAX
    package's with its PostingsList as `plist`) in one run, the store
    built by make_store(rwi), then the
    tombstones: every row of the dead term and the tied term's rows
    outside TIES_LIVE, read from the store's own arena (its packing
    order). Returns the store."""
    from ..index.postings import PostingsList
    plist = plist or PostingsList
    for i, (th, (n, base)) in enumerate(TILE_EDGE_TERMS.items()):
        feats, _, _, _ = make_term(n, seed + 10 + i)
        if th == b"tiesAAAAAAAA":
            feats[:] = feats[0]
        rwi.add_many(th, plist(
            (base + 3 * np.arange(n)).astype(np.int32), feats))
    rwi.flush()
    store = make_store(rwi)
    n, base = TILE_EDGE_TERMS[b"deadtileAAAA"]
    gone = list(range(base, base + 3 * n, 3))
    sp = store.spans_for(b"tiesAAAAAAAA")[0]
    host = lambda a: (a.cpu().numpy() if hasattr(a, "cpu")  # noqa: E731
                      else np.asarray(a))
    if getattr(sp, "pbase", -1) >= 0:      # a packed block
        import torch
        from ..ops.packed import C_DOCIDS, unpack_col_plain
        d = unpack_col_plain(torch.from_numpy(np.array(host(
            store.arena.packed_array()))), sp.pbase, sp.pmeta, C_DOCIDS,
            torch.arange(sp.count)).numpy()
    else:
        d = host(store.arena.arrays()[2])[sp.start:sp.start + sp.count]
    keep = np.zeros(sp.count, bool)
    for a, b in TIES_LIVE:
        keep[a:b] = True
    gone += [int(x) for x in d[~keep]]
    for x in gone:
        rwi.delete_doc(x)
    return store


def edge_extents(store, n: int):
    """1, 2 or 8 arena extents over the edge spans: whole, offset and
    ragged, all dead, and empty ones."""
    sp = {th: store.spans_for(th)[0] for th in EDGE_TERMS}
    big, almost = sp[b"bigAAAAAAAAA"], sp[b"almostAAAAAA"]
    short, dead = sp[b"shortAAAAAAA"], sp[b"deadAAAAAAAA"]
    pool = [(big.start, big.count), (almost.start + 7, 5_001),
            (short.start, short.count), (dead.start, dead.count),
            (big.start + 3, 0), (big.start + 70_001, 1),
            (almost.start, almost.count), (short.start + 1, 63)]
    return pool[:n]


class Fanout:
    """One RWIIndex listener that forwards every call to several stores:
    a store on the card and its twin on the CPU, or the JAX package's
    store and the port's."""

    def __init__(self, *stores):
        self.stores = stores

    def __getattr__(self, name):
        return lambda *a: [getattr(s, name)(*a) for s in self.stores]


def draw_docids(n: int, hi: int, rng) -> np.ndarray:
    """n distinct docids drawn from [0, hi), sorted: a term's postings
    meeting another term's only in part."""
    return np.sort(rng.choice(hi, n, replace=False)).astype(np.int32)


# join_edges' terms, packed in this order: rows, docid draw range (the
# first big term sets the bitmaps' coverage: 2^15 words over [0, 200,000))
JOIN_EDGE_TERMS = {
    b"jbitmapAAAAA": (100_000, 200_000),   # bitmap partner
    b"jrareAAAAAAA": (40_000, 200_000),    # the streamed side
    b"jsortbigAAAA": (80_000, 200_000),    # big, 2^29 past the coverage
    b"jallAAAAAAAA": (0, 0),               # every rare docid and more
    b"jnoneAAAAAAA": (70_000, 0),          # bitmap, meets no rare docid
    b"jsmallAAAAAA": (5_000, 200_000),     # sort partner
}
# rare docids: four at or above 2^29, which the sort-mode clip makes equal
# (2^29 + 11 tombstoned after the pack: three stay valid), and one past
# the bitmaps' coverage
JOIN_EDGE_HIGH = (2**29, 2**29 + 3, 2**29 + 11, 2**29 + 20, 3_000_000)
JOIN_EDGE_HIGH_DEAD = 2**29 + 11


def join_edges(device, seed: int = SEED):
    """(store, rwi) over JOIN_EDGE_TERMS in one run on `device`:
    make_term's columns (random languages, lastmods and flags for the
    filters), the rare term with docids at and above 2^29 (three of them
    valid after the pack, so the sort-mode clip rule picks the last) and
    past the bitmaps' coverage, a sort-mode partner of more than
    JOIN_BITMAP_MIN rows holding 2^29 (so past the coverage) and one
    without it (jsmall), a partner holding every rare docid, a bitmap
    partner meeting none, and tombstones on rare rows after the pack."""
    from ..index.devstore import DeviceSegmentStore
    from ..index.postings import PostingsList
    from ..index.rwi import RWIIndex
    rng = np.random.default_rng(seed + 77)
    ids = {}
    for th, (n, hi) in JOIN_EDGE_TERMS.items():
        if th == b"jrareAAAAAAA":
            ids[th] = np.concatenate([
                draw_docids(n - len(JOIN_EDGE_HIGH), hi, rng),
                np.array(sorted(JOIN_EDGE_HIGH), np.int32)])
        elif th == b"jsortbigAAAA":
            ids[th] = np.append(draw_docids(n - 1, hi, rng),
                                np.int32(2**29))
        elif th == b"jallAAAAAAAA":
            rare = ids[b"jrareAAAAAAA"]
            ids[th] = np.union1d(rare, draw_docids(9_000, 200_000, rng))
        elif th == b"jnoneAAAAAAA":
            ids[th] = (300_001 + 2 * np.arange(n)).astype(np.int32)
        else:
            ids[th] = draw_docids(n, hi, rng)
    idx = RWIIndex()
    for i, (th, d) in enumerate(ids.items()):
        feats, _, _, _ = make_term(len(d), seed + 40 + i)
        idx.add_many(th, PostingsList(d.astype(np.int32), feats))
    idx.flush()
    store = DeviceSegmentStore(idx, device=device)
    for d in ids[b"jrareAAAAAAA"][::37][:500]:
        idx.delete_doc(int(d))
    idx.delete_doc(JOIN_EDGE_HIGH_DEAD)
    return store, idx


JOIN_EDGE_FILTERS = {
    "language": (0x6465, -1, -(2**30), 2**30),
    "flag": (0, 7, -(2**30), 2**30),
    "flag bit 40 (the sign)": (0, 40, -(2**30), 2**30),
    "from days": (0, -1, 15_000, 2**30),
    "to days": (0, -1, -(2**30), 12_000),
    "all four": (0x656E, 3, 5_000, 25_000),
}


def join_edge_cases(store):
    """K8's cases over join_edges' store: (label, rare span, parts,
    n_inc, filter) with parts as join_member takes them and each term's
    mode as the store would choose it."""
    sp = {th: store.spans_for(th)[0] for th in JOIN_EDGE_TERMS}
    nslots = store.arena.bitmap_array().shape[0]

    def part(th):
        s = sp[th]
        return (s.jstart, s.count, s.jslot if 0 <= s.jslot < nslots else -1)
    rare = sp[b"jrareAAAAAAA"]
    mixed = [part(b"jbitmapAAAAA"), part(b"jsortbigAAAA"),
             part(b"jsmallAAAAAA")]
    cases = [
        ("excludes only (bitmap, sort)", rare,
         [part(b"jbitmapAAAAA"), part(b"jsmallAAAAAA")], 0, None),
        ("a bitmap partner meeting no row", rare, [part(b"jnoneAAAAAAA")],
         1, None),
        ("a sort partner holding every row", rare,
         [part(b"jallAAAAAAAA")], 1, None),
        ("mixed: bitmap and sort partners, sort exclude", rare, mixed, 2,
         None),
        ("bitmap partner, 2^29 sort partner, every-row exclude", rare,
         [part(b"jbitmapAAAAA"), part(b"jsortbigAAAA"),
          part(b"jallAAAAAAAA")], 2, None),
        ("five partners, six excludes", rare,
         [part(b"jbitmapAAAAA"), part(b"jsortbigAAAA"),
          part(b"jallAAAAAAAA"), part(b"jbitmapAAAAA"),
          part(b"jsortbigAAAA")] + [part(b"jnoneAAAAAAA")] * 6, 5, None),
        ("the bitmap term streamed", sp[b"jbitmapAAAAA"],
         [part(b"jsortbigAAAA"), part(b"jsmallAAAAAA")], 1, None),
    ]
    cases += [(f"mixed, filter {name}", rare, mixed, 2, filt)
              for name, filt in JOIN_EDGE_FILTERS.items()]
    return cases


def join_edge_waves(store):
    """The batched K8's cases over join_edges' store: (label, wave
    descriptor (devstore.join_wave_desc), n_inc). The filters of
    JOIN_EDGE_FILTERS one a slot in turn; a slot of no row and one of the
    rare span's first 100 rows beside whole rare spans; the clip rows in
    every slot against the 2^29 sort partner."""
    from .devstore import join_wave_desc
    sp = {th: store.spans_for(th)[0] for th in JOIN_EDGE_TERMS}
    nslots = store.arena.bitmap_array().shape[0]

    def part(th):
        s = sp[th]
        return (s.jstart, s.count, s.jslot if 0 <= s.jslot < nslots else -1)
    rare = sp[b"jrareAAAAAAA"]
    filters = [None, *JOIN_EDGE_FILTERS.values()]

    def wave(bs, parts, n_inc, short=True):
        slots = []
        for i in range(bs):
            start, count = rare.start, rare.count
            if short and i == 2:
                start, count = 0, 0
            elif short and i == 3:
                count = 100
            slots.append((start, count, filters[i % len(filters)], parts))
        return join_wave_desc(slots, n_inc, len(parts) - n_inc)
    mixed = [part(b"jbitmapAAAAA"), part(b"jsortbigAAAA"),
             part(b"jsmallAAAAAA")]
    return [
        ("16 bitmap slots (a bitmap partner, a bitmap exclude)",
         wave(16, [part(b"jbitmapAAAAA"), part(b"jnoneAAAAAAA")], 1), 1),
        ("9 slots of mixed modes (bitmap and sort partners, a sort "
         "exclude)", wave(9, mixed, 2), 2),
        ("7 slots, the clip rows against the 2^29 sort partner in each",
         wave(7, [part(b"jsortbigAAAA")], 1, short=False), 1),
        ("7 slots excluding the 2^29 sort partner",
         wave(7, [part(b"jsortbigAAAA")], 0, short=False), 0),
        ("4 slots, five partners and six excludes",
         wave(4, [part(b"jbitmapAAAAA"), part(b"jsortbigAAAA"),
                  part(b"jallAAAAAAAA"), part(b"jbitmapAAAAA"),
                  part(b"jsortbigAAAA")] + [part(b"jnoneAAAAAAA")] * 6, 5),
         5),
    ]


def delta_block(n: int, docids, seed: int = SEED):
    """A RAM delta block as the store stages it: make_term's columns
    compacted, `docids` (n of them), padded with docid -1 to
    devstore.bucket_delta(n) rows: (feats16, flags, docids) numpy."""
    from ..ops import ranking as R
    from .devstore import bucket_delta
    feats, _d, _h, _r = make_term(n, seed)
    b = bucket_delta(n)
    f16 = np.zeros((b, 17), np.int16)
    fl = np.zeros(b, np.int32)
    dd = np.full(b, -1, np.int32)
    f16[:n], fl[:n] = R.compact_feats(feats)
    dd[:n] = docids
    return f16, fl, dd


def edge_delta(store, n: int, seed: int = SEED):
    """A delta block over devstore_edges' store: docids of its spans
    (duplicates of span rows), tombstoned ones (EDGE_DEAD), ones past the
    tombstone bitmap and new ones."""
    rng = np.random.default_rng(seed + 5)
    sp = store.spans_for(b"bigAAAAAAAAA")[0]
    old = store.arena.arrays()[2][sp.start:sp.start + sp.count].cpu().numpy()
    pool = np.concatenate([rng.choice(old, n // 4), np.asarray(EDGE_DEAD),
                           100_000 + rng.choice(4_000_000, n, replace=False)])
    return delta_block(n, pool[:n].astype(np.int32), seed + 6)


def facet_bitmap(nbits: int, share: float, seed: int = SEED):
    """A facet bitmap's uint32 words over [0, nbits) (a multiple of 32)
    admitting about `share` of the docids, as filter_bitmap builds one."""
    rng = np.random.default_rng(seed + 9)
    allowed = rng.choice(nbits, int(nbits * share),
                         replace=False).astype(np.int64)
    words = np.zeros(nbits // 32, np.uint32)
    np.bitwise_or.at(words, allowed >> 5,
                     np.uint32(1) << (allowed & 31).astype(np.uint32))
    return words


# the filters of a scan wave, one a slot in turn (language, flag bit,
# from and to days): none, a language, a flag, the sign bit, a range
WAVE_FILTERS = ((0, -1, -(2**30), 2**30), (0x656E, -1, -(2**30), 2**30),
                (0, 7, -(2**30), 2**30), (0, 40, 10_000, 2**30),
                (0x6465, 3, 5_000, 25_000))


def scan_wave(store, bs: int):
    """bs exact scans over devstore_edges' store, each (extents, filter):
    1, 2 and 8 of edge_extents' extents in turn (whole, offset, ragged,
    all dead, empty), the WAVE_FILTERS in turn."""
    return [(edge_extents(store, (1, 2, 8)[i % 3]),
             WAVE_FILTERS[i % len(WAVE_FILTERS)]) for i in range(bs)]


# Operations of the batched scan a (live row, slot) whose filter the row
# passes, counted from the CUDA source (common.cuh score_row on the
# compact path, constraint_ok, cardinal_stats.cu Fold): K7's are 13
# normalised columns of 14 (the widening multiply-add; the f32 estimate:
# convert, multiply, convert; the remainder's multiply and subtract, two
# compares and two adds; the contribution's subtract, the shift, the
# add), the domlength term (3), the tf term (subtract, multiply, divide,
# convert, shift, add), the language match (2), 11 flag terms of 4
# (shift, and, multiply, add), the filter test (6) and the key and its
# threshold test (4); of them f32: the 13 columns' three and the tf
# term's four. K6's are the filter test, 34 column minima and maxima and
# the tf key's NaN test and minimum and maximum.
SCORE_ROW_F32_OPS = 13 * 3 + 4
SCORE_ROW_OPS = 13 * 14 + 3 + 6 + 2 + 11 * 4 + 6 + 4
STATS_ROW_OPS = 6 + 34 + 3
ROW_BYTES = 17 * 2 + 4 + 4 + 1   # features, flags, docid, tombstone byte


def scan_wave_work(arrays, desc, kk: int) -> dict:
    """The work of a batched scan wave (kernels/devstore.scan_batch_desc)
    at kk, whatever implements it: each group's distinct rows (identical
    extent lists, KD.scan_groups) read once, 43 B a row for K7 and K6 (4
    B of flags less where no slot of the group tests a flag); K6 writes
    the statistics, K7 reads them and the profile's consts and writes
    [bs, 2kk]; the operations of each live row that passes a slot's
    filter (counted on the card from `arrays`, (feats16, flags, docids,
    dead)). Returns {"k6_bytes", "k6_ops", "k7_bytes", "k7_ops",
    "k7_f32_ops", "scored", "distinct_rows", "slot_rows"}."""
    from . import cardinal as KC
    from . import devstore as KD
    feats16, flags, docids, dead = arrays[:4]
    scans = KD.desc_scans(desc)
    bs = len(scans)
    rows = [sum(c for _a, c in ext) for ext, _f in scans]
    k6b = k7b = distinct = 0
    for grp in KD.scan_groups(desc):
        n = rows[grp[0]]
        distinct += n
        flag = any(scans[s][1][1] != KD.NO_FLAG for s in grp)
        k6b += n * (ROW_BYTES - (0 if flag else 4))
        k7b += n * ROW_BYTES
    scored = 0
    for ext, filt in scans:
        d = KD._rows(docids, ext)
        v = KD.live_rows(d, dead) & KD.constraint_valid(
            KD._rows(feats16, ext), KD._rows(flags, ext), filt)
        scored += int(v.sum())
    stats_b = 4 * bs * KC.STATS_LEN
    return {"k6_bytes": k6b + stats_b, "k6_ops": scored * STATS_ROW_OPS,
            "k7_bytes": k7b + stats_b + 4 * KC.CONSTS_LEN
            + 4 * bs * 2 * kk,
            "k7_ops": scored * SCORE_ROW_OPS,
            "k7_f32_ops": scored * SCORE_ROW_F32_OPS, "scored": scored,
            "distinct_rows": distinct, "slot_rows": sum(rows)}


def tile_slots(span, bs: int):
    """bs K5 slots over consecutive tiles of one span: slot i the span's
    rows from its tile i on (a proxy-sorted extent of its own, bounded by
    the same pmax rows), each under the span's frozen statistics."""
    TILE = 32_768
    if span.tcount < bs:
        raise ValueError(f"span of {span.tcount} tiles, {bs} slots")
    st = span.stats
    return [(span.start + i * TILE, span.count - i * TILE, span.tstart + i,
             span.tcount - i, st["col_min"], st["col_max"], st["tf_min"],
             st["tf_max"]) for i in range(bs)]


def arena_rows(feats, docids):
    """(feats16, flags, docids) of one term's postings (ascending unique
    docids) in the order the device store packs them: compact, sorted by
    the pack-time proxy score, best first, ties in docid order."""
    from ..index.devstore import pack_prune_stats
    from ..ops import ranking as R
    f16, fl = R.compact_feats(feats)
    _st, proxy = pack_prune_stats(f16, fl)
    order = np.argsort(-proxy, kind="stable")
    return f16[order], fl[order], docids[order]


def devstore_oracle(parts, prof, k: int, language: str = "en"):
    """numpy (scores, docids) that DeviceSegmentStore.rank_term must
    return over the rows of `parts` (each (feats16, flags, docids) of a
    span in arena order, tombstoned rows removed, spans oldest first):
    statistics over all those rows, the kk = max(16, pow2(k)) best by
    (score descending, position ascending), those above -(2^31-1), the
    first of each docid, then k."""
    from ..index import postings as P
    from ..ops import ranking as R
    f16 = np.concatenate([a for a, _, _ in parts])
    fl = np.concatenate([b for _, b, _ in parts])
    dd = np.concatenate([c for _, _, c in parts])
    st = R.pack_stats_host(f16, fl)
    sc = R.cardinal_from_stats_host(f16, fl, st, prof,
                                    P.pack_language(language))
    kk = max(16, 1 << (max(k, 1) - 1).bit_length())
    top = np.argsort(-sc.astype(np.int64), kind="stable")[:kk]
    s, d = sc[top].astype(np.int32), dd[top]
    keep = s > -(2**31 - 1)
    s, d = s[keep], d[keep]
    _, first = np.unique(d, return_index=True)
    sel = np.sort(first)
    return s[sel][:k], d[sel][:k]


def devjoin_oracle(terms, inc, exc, dead, prof, k: int,
                   filt=(0, -1, -(2**30), 2**30), language: str = "en"):
    """numpy (scores, docids, considered) that DeviceSegmentStore.rank_join
    must return. `terms` maps a termhash to its one span's (feats16,
    flags, docids) in arena order (arena_rows), all rows; `dead` the
    tombstoned docids. The include with the fewest rows (the first on a
    tie) is streamed: each of its live rows whose docid is in every other
    include and in no exclude merges them (worddistance = max - min
    posintext, hitcount = min, flags = OR) and must pass the filter;
    statistics over those rows, scores on the int32 path, the kk =
    max(16, pow2(k)) best by (score, position in the span), then k."""
    from ..index import postings as P
    from ..ops import ranking as R
    rare_th = min(inc, key=lambda th: len(terms[th][2]))
    f16, fl, dd = terms[rare_th]
    v = ~np.isin(dd, np.asarray(sorted(dead), np.int32))
    merged = f16.astype(np.int32)
    fo = fl.copy()
    pmin = pmax = merged[:, P.F_POSINTEXT].copy()
    for th in inc:
        if th == rare_th:
            continue
        pf, pfl, pd = terms[th]
        order = np.argsort(pd, kind="stable")
        i = np.searchsorted(pd[order], dd).clip(max=len(pd) - 1)
        found = v & (pd[order][i] == dd)
        row = order[i]
        pp = pf[row, P.F_POSINTEXT].astype(np.int32)
        pmin = np.where(found, np.minimum(pmin, pp), pmin)
        pmax = np.where(found, np.maximum(pmax, pp), pmax)
        merged[:, P.F_HITCOUNT] = np.where(found, np.minimum(
            merged[:, P.F_HITCOUNT], pf[row, P.F_HITCOUNT]),
            merged[:, P.F_HITCOUNT])
        fo = np.where(found, fo | pfl[row], fo)
        v = found
    for th in exc:
        v &= ~np.isin(dd, terms[th][2])
    merged[:, P.F_WORDDISTANCE] = pmax - pmin
    lang, flag, lo, hi = filt
    lastmod = merged[:, P.F_LASTMOD]
    if lang != 0:
        v &= merged[:, P.F_LANGUAGE] == lang
    if flag != -1:
        v &= ((fo.astype(np.int64) >> min(max(flag, 0), 31)) & 1) == 1
    if lo != -(2**30):
        v &= lastmod >= lo
    if hi != 2**30:
        v &= lastmod <= hi
    if not v.any():
        return np.empty(0, np.int32), np.empty(0, np.int32), len(dd)
    st = R.pack_stats_host(merged[v], fo[v])
    sc = R.cardinal_from_stats_host(merged, fo, st, prof,
                                    P.pack_language(language))
    sc = np.where(v, sc, -(2**31 - 1)).astype(np.int64)
    kk = max(16, 1 << (max(k, 1) - 1).bit_length())
    top = np.argsort(-sc, kind="stable")[:kk]
    top = top[sc[top] > -(2**31 - 1)]
    return sc[top].astype(np.int32)[:k], dd[top][:k], len(dd)


def unit_vectors(n: int, rng, dim: int = 256, dtype=np.float16,
                 chunk: int = 1 << 18) -> np.ndarray:
    """n L2-normalised rows of f32 normals, stored as `dtype`, made in
    chunks (2^21 x 256 f16 is 1 GiB)."""
    out = np.empty((n, dim), dtype)
    for r0 in range(0, n, chunk):
        v = rng.standard_normal((min(chunk, n - r0), dim), dtype=np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        out[r0:r0 + len(v)] = v
    return out


def rerank_wave(rng, cap: int, ns, nb: int | None = None,
                alpha: float = 0.5, dim: int = 256):
    """One rerank wave's descriptors (ops/dense.pack_rerank_row): slot i
    holds ns[i] candidates (0: a pad slot), distinct docids drawn from
    [-1, cap + cap // 8) (so -1, docids past the forward index's rows and
    covered ones), a third of each slot's sparse scores equal, unit query
    vectors. Returns (qi [len(ns), 2 + 2nb + dim] int32, nb, [(qvec,
    sparse, docids) a slot])."""
    from ..ops import dense as DN
    nb = nb or max(DN.rerank_bucket(n) for n in ns)
    qi = np.zeros((len(ns), 2 + 2 * nb + dim), np.int32)
    slots = []
    for i, n in enumerate(ns):
        q = unit_vectors(1, rng, dim, np.float32)[0]
        sp = rng.integers(0, 1 << 20, n).astype(np.int32)
        sp[:n // 3] = sp[0] if n else 0
        dd = (rng.choice(cap + cap // 8 + 1, size=n, replace=False)
              - 1).astype(np.int32)
        qi[i] = DN.pack_rerank_row(q, sp, dd, alpha, nb)
        slots.append((q, sp, dd))
    return qi, nb, slots


def clustered_vectors(n: int, rng, n_clusters: int = 1024, dim: int = 256,
                      noise: float = 0.15, chunk: int = 1 << 18,
                      dtype=np.float32):
    """(n unit rows stored as `dtype`, the unit f32 centres): each row a
    random centre of `n_clusters` plus `noise` times a normal vector,
    normalised in f32 (the JAX package's tests/test_ann.py corpus), made
    in chunks."""
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    lab = rng.integers(0, n_clusters, n)
    out = np.empty((n, dim), dtype)
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        v = centers[lab[r0:r1]] + noise * rng.standard_normal(
            (r1 - r0, dim), dtype=np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        out[r0:r1] = v
    return out, centers


def ann_wave(rng, cap: int, ns, nb: int, alpha: float = 0.5,
             dim: int = 256):
    """One K15 wave's descriptors (ops/ann.pack_ann_fuse_row): slot i holds
    ns[i] lanes (0: a slot with no valid lane): a sixth sparse lanes with
    docids of their own (a third of those without a hot row, one repeating
    a probe lane's row), the rest probe lanes, rows drawn from [-2, cap +
    cap // 16) so that a few fall outside the slab, a third of the sparse
    scores equal; unit query vectors. Returns [len(ns), 2 + 3nb + dim]
    int32."""
    from ..ops import ann as A
    qi = np.zeros((len(ns), 2 + 3 * nb + dim), np.int32)
    for i, n in enumerate(ns):
        q = unit_vectors(1, rng, dim, np.float32)[0]
        rows = (rng.integers(0, cap + cap // 16 + 2, n) - 2).astype(np.int32)
        dd = np.full(n, -1, np.int32)
        sp = np.zeros(n, np.int32)
        m = n // 6
        dd[:m] = rng.integers(0, 1 << 30, m)
        sp[:m] = rng.integers(0, 1 << 24, m)
        sp[:m // 3] = sp[0] if m else 0
        rows[:m // 3] = -1
        if m and n > m:
            rows[m - 1] = rows[n - 1]
        qi[i] = A.pack_ann_fuse_row(q, rows, dd, sp, alpha, nb)
    return qi


def edge_list(n: int, e: int, seed: int = SEED, hub: int = 0):
    """(srcs, dsts, weights, dangling) of a host edge list as
    host_ranks_from_edges builds it: srcs, dsts uniform in [0, n) (and,
    with `hub`, that many more edges into host 0 from hosts 1..hub, mixed
    in), counts in 1..4, normalised per source with f32 out totals."""
    rng = np.random.default_rng(seed)
    srcs = rng.integers(0, n, e).astype(np.int32)
    dsts = rng.integers(0, n, e).astype(np.int32)
    if hub:
        srcs = np.concatenate([srcs, np.arange(1, hub + 1, dtype=np.int32)])
        dsts = np.concatenate([dsts, np.zeros(hub, np.int32)])
        order = rng.permutation(len(srcs))
        srcs, dsts = srcs[order], dsts[order]
    counts = rng.integers(1, 5, len(srcs)).astype(np.float32)
    out_total = np.zeros(n, np.float32)
    np.add.at(out_total, srcs, counts)
    return srcs, dsts, counts / out_total[srcs], out_total == 0.0


def host_graph(seed: int = SEED, n: int = 1_000_000,
               sources: int = 50_000, mean_degree: float = 165.0,
               max_degree: int = 2000, no_links: float = 0.05):
    """(srcs int32 [e], dsts int32 [e], weights f32 [e], dangling bool
    [n]): one YaCy node's host link graph at the WebStructureGraph limit
    (`max_hosts` source hosts, webstructure.py:29) over a vocabulary of n
    hosts, as BlockRank's power iteration takes it.

    `sources` hosts drawn at random record links; `no_links` of them have
    none. The others draw a heavy-tailed number of targets (log-normal,
    sigma 1.25, mean about `mean_degree`, in [1, max_degree]): every host
    that is no source once (so that each of the n hosts is in the graph),
    the rest from a Zipf popularity (s = 1.1, the exponent of the repo's
    Zipf query mixes, over a random ranking of the n hosts), so that hubs
    reach in-degrees near the number of sources. Duplicate (src, dst)
    pairs and self-links are dropped (at the defaults about 5M distinct
    pairs remain, ~105 a linking source); the edges are ordered by (src,
    dst). Edge counts are in
    1..16, normalised per source as host_ranks_from_edges does (f32 out
    totals, weights = counts / out_total[srcs]); every host without an
    out-link is dangling."""
    rng = np.random.default_rng(seed)
    src_ids = rng.choice(n, sources, replace=False).astype(np.int64)
    sigma = 1.25
    mu = np.log(mean_degree) - sigma * sigma / 2
    deg = np.clip(np.rint(rng.lognormal(mu, sigma, sources)), 1,
                  max_degree).astype(np.int64)
    deg[rng.random(sources) < no_links] = 0
    total = int(deg.sum())
    is_src = np.zeros(n, bool)
    is_src[src_ids] = True
    others = np.flatnonzero(~is_src)
    others = others[rng.permutation(len(others))]
    zipf_w = np.arange(1, n + 1, dtype=np.float64) ** -1.1
    cdf = np.cumsum(zipf_w)
    cdf /= cdf[-1]
    ranked = rng.permutation(n)
    k = max(total - len(others), 0)
    drawn = ranked[np.minimum(np.searchsorted(cdf, rng.random(k)), n - 1)]
    targets = np.concatenate([others[:total], drawn])
    targets = targets[rng.permutation(len(targets))]
    srcs = np.repeat(src_ids, deg)[:len(targets)]
    keep = srcs != targets
    key = np.unique(srcs[keep] * n + targets[keep])
    srcs = (key // n).astype(np.int32)
    dsts = (key % n).astype(np.int32)
    counts = rng.integers(1, 17, len(srcs)).astype(np.float32)
    out_total = np.zeros(n, dtype=np.float32)
    np.add.at(out_total, srcs, counts)
    weights = counts / out_total[srcs]
    return srcs, dsts, weights, out_total == 0.0


def link_docs(n_docs: int, n_hosts: int, anchors: int = 10,
              seed: int = SEED, hub_share: float = 0.3):
    """The postprocessing path's documents: [(url, title, text, [(target
    url, link text, rel), ...])] over `n_hosts` hosts, `anchors` links a
    document: a `hub_share` of them to the few hub hosts, the others to
    random hosts, some in-host, some rel="nofollow"; titles and texts
    repeat so that the uniqueness pass finds duplicates."""
    rng = np.random.default_rng(seed)
    hosts = [f"host{i:05d}.test" for i in range(n_hosts)]
    hubs = hosts[:max(1, n_hosts // 100)]
    out = []
    for d in range(n_docs):
        h = hosts[int(rng.integers(0, n_hosts))]
        url = f"http://{h}/page{d}.html"
        links = []
        for a in range(anchors):
            u = rng.random()
            if u < hub_share:
                t = hubs[int(rng.integers(0, len(hubs)))]
            elif u < hub_share + 0.1:
                t = h
            else:
                t = hosts[int(rng.integers(0, n_hosts))]
            rel = "nofollow" if rng.random() < 0.05 else ""
            links.append((f"http://{t}/p{int(rng.integers(0, 50))}"
                          f"?q={a}", f"link {a} to {t}", rel))
        title = f"title {int(rng.integers(0, n_docs // 2 + 1))}"
        text = f"body text {int(rng.integers(0, n_docs // 2 + 1))} of {h}"
        out.append((url, title, text, links))
    return out


def device_ms(fn, reps: int = 20) -> float:
    """Median device time of one call of `fn`, in ms.

    A spin kernel holds the stream while the host queues every call, so
    the events around each call time the device alone, not the host's
    Python and launch work between calls. Calls follow each other: inputs
    that fit the L2 cache (tie_topk's 40 MB of scores) may be found there,
    as in the ranking step, where the scores were just written."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    # about 2 GHz: cycles enough for the host to queue every call
    torch.cuda._sleep(int(min(1.0, 2.0 * host_s * reps + 0.002) * 2e9))
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def call_ms(fn, reps: int = 20) -> float:
    """Median time between two events around one call issued from an idle
    queue: the device time plus the host's issue time."""
    import torch
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
    return statistics.median(out)


def empty_launch() -> None:
    """One launch of an empty kernel on the current stream: the floor of
    any kernel's call and device time."""
    import torch
    from . import build as B
    B.check(B.library().yt_empty_launch(
        B.stream_ptr(torch.device("cuda"))), "empty")


def device_ops(fn, traces: int = 3) -> list:
    """The device operations (kernels, memsets, copies) one call of `fn`
    issues, each as "name: its device time in us", read from a
    torch.profiler trace of the call: the longest of `traces` traces (a
    trace on the card sometimes misses some of a call's operations; it
    never adds one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best: list = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [f"{e.name}: {e.time_range.elapsed_us():.1f} us"
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        best = ops if len(ops) > len(best) else best
    return best


def topk_trace() -> list:
    """The passes of the last tie_topk call, from the kernel's trace slots
    (device clock, us since the kernel's start): for each pass the first
    block's arrival at the grid barrier and the pick that ends it (after
    the sample, the guessed bucket of digit 0; after a pass, each digit
    picked, the source the next pass reads: 0 the scores, 1-2 a
    candidate buffer of `m` rows, and the rows in the chosen bucket),
    then the end of the select and of the sort. Empty when the library
    was built without the trace."""
    import ctypes
    from . import build as B
    buf = (ctypes.c_uint64 * 64)()
    got = B.library().yt_tie_topk_trace(buf)
    if got < 0:
        raise RuntimeError("tie_topk trace: cudaMemcpyFromSymbol failed")
    rows = [tuple(buf[4 * i:4 * i + 4]) for i in range(max(got, 0))]
    t0 = rows[0][0] if rows else 0
    us = lambda t: round((t - t0) / 1e3, 2)  # noqa: E731
    out = []
    for t, a, b, c in rows[1:]:
        if a == 300:
            out.append({"us": us(t), "first_arrival_us": us(b)})
        elif a == 400:
            out.append({"us": us(t), "guess": b, "sample_rows": c})
        elif a == 100:
            out.append({"us": us(t), "collected_from": b})
        elif a in (200, 201):
            out.append({"us": us(t), "end": "sort" if a == 200 else "select"})
        else:
            out.append({"us": us(t), "digit": a, "src": b, "m": c >> 32,
                        "bucket": c & 0xFFFFFFFF})
    return out


# ---------------------------------------------------------------------------
# the mesh store: a twin on other cells, words on chosen term rows, a corpus
# of edge cases
# ---------------------------------------------------------------------------

class _NoRuns:
    """An RWI with nothing in it (a twin's construction packs nothing)."""
    _tombstones: tuple = ()
    _runs: tuple = ()
    listener = None


class MeshTwinListener:
    """The RWI listener of a mesh store and its twin (mesh_twin): every
    call goes to the store, which packs; the twin takes the store's host
    mirrors and span registry again and marks its device tensors stale;
    deletes reach both."""

    def __init__(self, store, twin):
        self.store, self.twin = store, twin

    def on_doc_deleted(self, docid: int) -> None:
        self.store.on_doc_deleted(docid)
        self.twin.on_doc_deleted(docid)

    def __getattr__(self, name):
        def call(*a):
            getattr(self.store, name)(*a)
            tw = self.twin
            with tw._lock:
                tw._cells, tw._packed = self.store._cells, self.store._packed
                tw._dirty = True
            tw._bump_epoch()
        return call


def mesh_twin(store, devices):
    """A second MeshSegmentStore over `store`'s RWI on the cells `devices`
    (the CPU twin of a store on the card) that shares its host mirrors and
    span registry instead of packing every run again, and the listener
    that feeds both (set it as the RWI's listener). A reading aid for
    checks, not a store API."""
    from ..index.meshstore import MeshSegmentStore
    twin = MeshSegmentStore(_NoRuns(), devices=devices, n_term=store.n_term,
                            budget_bytes=store.budget_bytes)
    twin.rwi = store.rwi
    twin._cells, twin._packed = store._cells, store._packed
    twin._dead_host = store._dead_host.copy()
    return twin, MeshTwinListener(store, twin)


def words_on_rows(n_term: int, prefix: str = "mesh", per_row: int = 3):
    """{row: [words]}: the first `per_row` words `prefix`0, `prefix`1, ...
    whose word2hash lands on each term row of an n_term mesh."""
    from ..index.meshstore import term_shard
    from ..utils.hashes import word2hash
    rows: dict[int, list[str]] = {r: [] for r in range(n_term)}
    i = 0
    while any(len(v) < per_row for v in rows.values()):
        w = f"{prefix}{i}"
        r = term_shard(word2hash(w), n_term)
        if len(rows[r]) < per_row:
            rows[r].append(w)
        i += 1
    return rows


# mesh_edges' terms: name -> (term row, rows, docid draw range); the
# rare term also holds docids at and above 2^29 (MESH_EDGE_HIGH), of which
# the sort-mode clip leaves the last valid one to match "part"'s 2^29
MESH_EDGE_TERMS = {"big": (0, 140_000, 2_000_000),
                   "rare": (1, 6_000, 400_000),
                   "part": (0, 20_000, 400_000),
                   "part2": (1, 15_000, 400_000),
                   "excl": (0, 3_000, 400_000),
                   "all": (0, 0, 0)}
MESH_EDGE_HIGH = (2**29, 2**29 + 7, 2**29 + 1_000, 2**30 + 3)


def mesh_edges(devices, n_term: int = 2, seed: int = SEED):
    """(store, rwi, {name: termhash}) of a MeshSegmentStore on `devices`
    over MESH_EDGE_TERMS in one run: make_term's columns (its repeated best
    row: ties), "big" of several tiles a cell, the rare term on the other
    term row with docids at and above 2^29 (two of them tombstoned after
    the pack), "part" holding 2^29, "all" every rare docid and more, and
    tombstones on rare rows after the pack."""
    from ..index.meshstore import MeshSegmentStore
    from ..index.postings import PostingsList
    from ..index.rwi import RWIIndex
    from ..utils.hashes import word2hash
    rows = words_on_rows(n_term, per_row=len(MESH_EDGE_TERMS))
    rng = np.random.default_rng(seed + 91)
    ths, ids = {}, {}
    for i, (name, (row, n, hi)) in enumerate(MESH_EDGE_TERMS.items()):
        ths[name] = word2hash(rows[row % n_term][i])
        if name == "all":
            ids[name] = np.union1d(ids["rare"], draw_docids(9_000, 400_000,
                                                            rng))
        elif name == "rare":
            ids[name] = np.concatenate([
                draw_docids(n - len(MESH_EDGE_HIGH), hi, rng),
                np.array(MESH_EDGE_HIGH, np.int32)])
        elif name == "part":
            ids[name] = np.append(draw_docids(n - 1, hi, rng),
                                  np.int32(2**29))
        else:
            ids[name] = draw_docids(n, hi, rng)
    idx = RWIIndex()
    for i, (name, d) in enumerate(ids.items()):
        feats, _, _, _ = make_term(len(d), seed + 60 + i)
        idx.add_many(ths[name], PostingsList(d.astype(np.int32), feats))
    idx.flush()
    store = MeshSegmentStore(idx, devices=devices, n_term=n_term)
    return store, idx, ths


def mesh_edge_queries(ths) -> list:
    """(label, fn of a store) of mesh_edges' queries: rank_term pruned,
    escalating, at k = 1000 and under each filter; the column-local and
    cross-row joins, with excludes, partners on both rows and a filter."""
    from ..ops.ranking import RankingProfile
    prof, esc = RankingProfile(), RankingProfile(
        worddistance=2, appemph=15, urllength=12, tf=3)
    t = ths
    qs = [("term big", lambda s: s.rank_term(t["big"], prof, k=10)),
          ("term big escalating", lambda s: s.rank_term(t["big"], esc,
                                                        k=100)),
          ("term big k=1000", lambda s: s.rank_term(t["big"], prof,
                                                    k=1000)),
          ("term rare", lambda s: s.rank_term(t["rare"], prof, k=50))]
    for label, filt in JOIN_EDGE_FILTERS.items():
        kw = dict(lang_filter=filt[0], flag_bit=filt[1],
                  from_days=None if filt[2] == -(2**30) else filt[2],
                  to_days=None if filt[3] == 2**30 else filt[3])
        qs.append((f"term big {label}",
                   lambda s, kw=kw: s.rank_term(t["big"], prof, k=100,
                                                **kw)))
    joins = {"column-local big & part": ([t["big"], t["part"]], []),
             "column-local rare & part2": ([t["rare"], t["part2"]], []),
             "cross-row big & rare": ([t["big"], t["rare"]], []),
             "cross-row rare & part & all - excl":
                 ([t["rare"], t["part"], t["all"]], [t["excl"]]),
             "cross-row big & part2 - excl": ([t["big"], t["part2"]],
                                              [t["excl"]]),
             "cross-row rare - excl - big": ([t["rare"]],
                                             [t["excl"], t["big"]])}
    for label, (inc, exc) in joins.items():
        qs.append((label, lambda s, i=inc, e=exc: s.rank_join(
            i, e, prof, k=100)))
    qs.append(("cross-row big & rare, language filter",
               lambda s: s.rank_join([t["big"], t["rare"]], [], prof, k=20,
                                     lang_filter=0x6465)))
    return qs


def pruned_runs(bs: int, runs: int, kk: int, rng, tied: bool = False,
                empty=()):
    """A gathered [bs, runs, 2kk + 1] int32 block (CPU) as the mesh store's
    pruned cells leave it for K4 batched: each run kk (score, docid) rows
    in K5's (score DESC, tile row) order (docids unordered among equal
    scores: K4's out-of-order path), trailing init rows (-(2^31-1), -1),
    an ok word; the runs in `empty` all init rows (a cell holding none of
    the term); `tied`: every real score equal."""
    import torch
    small = -(2**31 - 1)
    g = torch.empty((bs, runs, 2 * kk + 1), dtype=torch.int32)
    for b in range(bs):
        for r in range(runs):
            if r in empty:
                s = np.full(kk, small, np.int32)
                d = np.full(kk, -1, np.int32)
            else:
                s = (np.full(kk, 7, np.int32) if tied else
                     -np.sort(-rng.integers(0, 20, kk)).astype(np.int32))
                d = rng.choice(100_000, kk, replace=False).astype(np.int32)
                cut = rng.integers(kk // 2, kk + 1)
                s[cut:], d[cut:] = small, -1
            g[b, r, :kk] = torch.from_numpy(s)
            g[b, r, kk:2 * kk] = torch.from_numpy(d)
            g[b, r, 2 * kk] = int(rng.random() < 0.8)
    return g


def xjoin_edge_cases(store) -> list:
    """(label, rare span, windows [(lo, cnt)], n_inc) of K18 over the join
    edge store's arena (join_edges): the rare span (docids at and above
    2^29, tombstoned rows) against the sort-mode segments of its partners
    (one holding 2^29), an empty window, a window at the end of the join
    table (xjoin_table cuts the table there), two includes and an
    exclude, excludes only."""
    sp = {th: store.spans_for(th)[0] for th in JOIN_EDGE_TERMS}
    rare = sp[b"jrareAAAAAAA"]

    def seg(th):
        return sp[th].jstart, sp[th].count
    last = max(sp.values(), key=lambda s: s.jstart)
    return [
        ("sort partner holding 2^29", rare, [seg(b"jsortbigAAAA")], 1),
        ("every rare docid", rare, [seg(b"jallAAAAAAAA")], 1),
        ("empty window", rare, [(0, 0)], 1),
        ("window at the table's end", rare, [(last.jstart, last.count)], 1),
        ("two includes, an exclude", rare,
         [seg(b"jsortbigAAAA"), seg(b"jallAAAAAAAA"),
          seg(b"jsmallAAAAAA")], 2),
        ("excludes only", rare, [seg(b"jsmallAAAAAA"), seg(b"jnoneAAAAAAA")],
         0),
    ]


def xjoin_table(store, wins):
    """The join edge store's (jdocids, jpos) cut at the end of the last of
    `wins`: the case's window then ends at the table's last entry."""
    jd, jp = store.arena.join_arrays()
    end = max(1, max(lo + c for lo, c in wins))
    return jd[:end], jp[:end]


def mesh_wave(store, fns, timeout: float = 600.0) -> list:
    """Call each of `fns` (a rank_term through `store`'s mesh batcher)
    from a thread of its own, with the batcher's dispatcher held until
    every call is queued, so that they form one wave (up to its
    max_batch) on every run: the answers, in order. The hold is an item
    already claimed whose lock this function holds: the dispatcher takes
    it off its queue and waits on the lock; released once the calls are
    queued, it finds the item taken and forms the next wave from them."""
    import threading
    b = store._batcher
    gate = {"lk": threading.Lock(), "taken": True}
    gate["lk"].acquire()
    out, errors = [None] * len(fns), []
    try:
        b._q.put(gate)
        t0 = time.time()
        while b._q.qsize() and time.time() - t0 < timeout:
            time.sleep(0.001)          # the dispatcher holds the gate

        def run(i, fn):
            try:
                out[i] = fn()
            except Exception as e:  # noqa: BLE001 - raised below
                errors.append(e)
        ts = [threading.Thread(target=run, args=(i, fn))
              for i, fn in enumerate(fns)]
        for t in ts:
            t.start()
        # every call queued, or answered without the batcher
        while (b._q.qsize() + sum(not t.is_alive() for t in ts) < len(fns)
               and time.time() - t0 < timeout):
            time.sleep(0.001)
    finally:
        gate["lk"].release()
    for t in ts:
        t.join(timeout)
    if errors:
        raise errors[0]
    return out
