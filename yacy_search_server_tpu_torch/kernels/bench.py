"""The smoke's data and timers for the port's kernels on one CUDA card.

`make_term` makes the smoke's 10M-posting term from its seed,
`edge_block` a block at the edges of `cardinal_score`'s int32
arithmetic, `sorted_runs` the gathered block of a fusion (one sorted
run a shard), `devstore_edges` a device store whose arena holds the
devstore kernels' edge cases (`edge_slots`, `edge_extents`,
`tile_slots` address it), `join_edges` a store whose join tables hold
K8's edge cases (`join_edge_cases` lists them), `arena_rows` /
`devstore_oracle` the numpy answer `rank_term` must give and
`devjoin_oracle` the one `rank_join` must give. `call_ms` times one call between two
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


def device_ops(fn) -> list:
    """The device operations (kernels, memsets, copies) one call of `fn`
    issues, each as "name: its device time in us", read from a
    torch.profiler trace of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [f"{e.name}: {e.time_range.elapsed_us():.1f} us"
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


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
