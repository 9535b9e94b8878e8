"""The port's device conjunction (`rank_join`, K8 `join_member`) against
the JAX package's, on the CPU.

One RWI feeds a JAX store and a port store (`device="cpu"`, the plain
versions) through `kernels/bench.Fanout`, on tests/test_devjoin.py's
corpora built with the same seeds: `seg3` (every partner sort-merge),
`seg_bm` (every term a join bitmap) and `seg_mixed` (only the big term
one). `rank_join` must return the JAX store's scores, docids, order and
`considered`, with equal join counters; the join side-tables, the spans'
join fields and the bitmap table must equal the JAX arena's, before and
after `repack`; `join_member_plain` on the JAX arena's own bytes must
give `_join_topk`'s merged rows and validity where they are valid. No
tolerance: every output is int32 or bool, equal to the bit.
"""

import numpy as np
import pytest
import torch

from yacy_search_server_tpu.index import devstore as JD
from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.index.rwi import RWIIndex as JRWI
from yacy_search_server_tpu.ops.ranking import RankingProfile as JProf
from yacy_search_server_tpu.utils.hashes import word2hash
from yacy_search_server_tpu_torch import convert
from yacy_search_server_tpu_torch.index import devstore as TD
from yacy_search_server_tpu_torch.kernels import bench as KB
from yacy_search_server_tpu_torch.kernels import devstore as KD
from yacy_search_server_tpu_torch.ops import ranking as TR

A, B, C = (word2hash(w) for w in ("aa", "bb", "cc"))
DE = JP.pack_language("de")
# tests/test_devjoin.py's fixtures: seed and JOIN_BITMAP_MIN
CORPORA = {"seg3": (3, 65_536), "seg_bm": (11, 1_000),
           "seg_mixed": (12, 15_000)}
COUNTERS = ("join_served", "join_fallbacks", "join_degraded_plain",
            "fallbacks", "queries_served", "stream_scans", "prune_rounds")


def _plist(rng, n, id_pool):
    """tests/test_devjoin.py's postings."""
    docids = np.sort(rng.choice(id_pool, n, replace=False)).astype(np.int32)
    feats = np.zeros((n, JP.NF), np.int32)
    feats[:, JP.F_HITCOUNT] = rng.integers(1, 60, n)
    feats[:, JP.F_WORDS_IN_TEXT] = rng.integers(50, 3000, n)
    feats[:, JP.F_LASTMOD] = rng.integers(18000, 21000, n)
    feats[:, JP.F_POSINTEXT] = rng.integers(1, 4000, n)
    feats[:, JP.F_WORDS_IN_TITLE] = rng.integers(0, 10, n)
    feats[:, JP.F_LANGUAGE] = np.where(
        rng.random(n) < 0.7, JP.pack_language("en"), DE)
    feats[:, JP.F_FLAGS] = rng.integers(0, 2**26, n)
    return JP.PostingsList(docids, feats)


def _pair(monkeypatch, name):
    """(rwi, JAX store, port store) over the corpus `name`: three
    overlapping terms in one ingested run."""
    seed, bm_min = CORPORA[name]
    for cls in (JD.DeviceSegmentStore, TD.DeviceSegmentStore):
        monkeypatch.setattr(cls, "JOIN_BITMAP_MIN", bm_min)
    idx = JRWI()
    j = JD.DeviceSegmentStore(idx)
    t = TD.DeviceSegmentStore(idx, device="cpu")
    idx.listener = KB.Fanout(j, t)
    rng = np.random.default_rng(seed)
    pool = np.arange(60_000)
    idx.ingest_run({A: _plist(rng, 20_000, pool), B: _plist(rng, 9_000, pool),
                    C: _plist(rng, 5_000, pool)})
    return idx, j, t


def _join_both(j, t, inc, exc, prof=None, k=50, **kw):
    """rank_join on both stores: equal answers and join counters."""
    j._topk_cache._d.clear()     # the "plain" route's rank_term
    t._topk_cache.clear()
    prof = prof or JProf()
    want = j.rank_join(inc, exc, prof, "en", k=k, **kw)
    got = t.rank_join(inc, exc, prof, "en", k=k, **kw)
    if want is None:
        assert got is None
    else:
        assert got is not None
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    assert [getattr(t, c) for c in COUNTERS] == \
        [getattr(j, c) for c in COUNTERS]
    return got


QUERIES = {
    "two_terms": ([A, B], [], {}),
    "three_terms_exclusion": ([B, A, C], [], {}),
    "two_terms_exclusion": ([A, B], [C], {}),
    "single_include_exclusion": ([A], [C], {}),
    "rare_first_exclusion": ([C, B], [A], {}),
    "language": ([A, B], [], dict(lang_filter=DE)),
    "flag": ([A, B], [C], dict(flag_bit=4)),
    "date_range": ([A, B], [], dict(from_days=19_000, to_days=20_000)),
    "all_filters": ([A, B, C], [], dict(lang_filter=DE, flag_bit=2,
                                        from_days=18_500, to_days=20_500)),
    "authority15": ([A, B], [C], dict(prof=JProf(authority=15))),
    "k1000": ([A, B], [], dict(k=1000)),
}


@pytest.mark.parametrize("query", list(QUERIES))
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_rank_join_matches_jax(monkeypatch, corpus, query):
    _idx, j, t = _pair(monkeypatch, corpus)
    inc, exc, kw = QUERIES[query]
    got = _join_both(j, t, inc, exc, **kw)
    assert got is not None and t.join_served == 1 and len(got[1]) > 0


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_rank_join_with_tombstones_matches_jax(monkeypatch, corpus):
    idx, j, t = _pair(monkeypatch, corpus)
    joined = _join_both(j, t, [A, B], [], k=1000)
    victims = joined[1][:40].tolist()
    for d in victims:
        idx.delete_doc(int(d))
    got = _join_both(j, t, [A, B], [], k=50)
    assert not set(victims) & set(got[1].tolist())
    _join_both(j, t, [C, A], [B])


def test_plain_route_matches_jax(monkeypatch):
    """Every exclude names a term with no postings: rank_term serves it
    (join_degraded_plain); a plain single-term shape is no join."""
    _idx, j, t = _pair(monkeypatch, "seg3")
    got = _join_both(j, t, [A], [word2hash("nowhere")])
    assert t.join_degraded_plain == 1 and t.queries_served == 1
    assert len(got[1]) == 50
    _join_both(j, t, [A], [word2hash("nowhere")], lang_filter=DE)
    assert _join_both(j, t, [A], []) is None
    assert t.join_degraded_plain == 2 and t.join_served == 0


def test_declines_match_jax(monkeypatch):
    """A RAM delta, a multi-span include (merge_wanted), an exclude that
    has postings but no packed span, more than MAX_JOIN_TERMS, and an
    empty intersection (served, empty)."""
    idx, j, t = _pair(monkeypatch, "seg3")
    many = [word2hash(f"t{i}") for i in range(7)]
    assert _join_both(j, t, many, []) is None        # not a join shape
    assert _join_both(j, t, [A], many) is None
    idx.add_many(word2hash("fresh"), JP.PostingsList(
        np.array([7], np.int32), np.zeros((1, JP.NF), np.int32)))
    assert _join_both(j, t, [A, word2hash("fresh")], []) is None
    assert _join_both(j, t, [A, B], [word2hash("fresh")]) is None
    idx.add_many(A, JP.PostingsList(np.array([70_001], np.int32),
                                    np.zeros((1, JP.NF), np.int32)))
    assert _join_both(j, t, [A, B], []) is None      # RAM delta
    idx.flush()                                      # A now has two spans
    assert _join_both(j, t, [A, B], []) is None
    assert t.merge_wanted and j.merge_wanted
    assert t.join_fallbacks == 4 and t.join_served == 0
    assert idx.merge_runs(max_runs=1)
    _join_both(j, t, [A, B], [])
    rng = np.random.default_rng(9)
    idx.ingest_run({word2hash("zz"): _plist(
        rng, 6_000, np.arange(10**6, 10**6 + 50_000))})
    got = _join_both(j, t, [A, word2hash("zz")], [])
    assert len(got[1]) == 0 and t.join_served == 2


def _join_state(s):
    jd, jp = (np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy()
              for a in s.arena.join_arrays())
    bm = s.arena.bitmap_array()
    bm = bm.numpy() if isinstance(bm, torch.Tensor) else np.asarray(bm)
    spans = {th: [(sp.start, sp.count, sp.jstart, sp.jslot)
                  for sp in s.spans_for(th)] for th in (A, B, C)}
    return jd, jp, bm, spans


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_join_tables_match_jax_before_and_after_repack(monkeypatch, corpus):
    """tests/test_devjoin.py::test_bitmap_repack_rebuilds_slots: the join
    side-tables, the bitmap table and the spans' join fields equal the
    JAX arena's, and again after a second run and a repack."""
    idx, j, t = _pair(monkeypatch, corpus)
    for step in range(3):
        jj, tt = _join_state(j), _join_state(t)
        for a, b in zip(jj[:3], tt[:3]):
            np.testing.assert_array_equal(b, a)
        assert tt[3] == jj[3]
        if step == 0:
            rng = np.random.default_rng(40)
            idx.ingest_run({word2hash("dd"): _plist(
                rng, 3_000, np.arange(80_000))})
        elif step == 1:
            j.repack()
            t.repack()
    slots = [sp[0][3] for sp in tt[3].values()]
    if corpus == "seg_bm":
        assert all(s >= 0 for s in slots)
    _join_both(j, t, [A, C], [])


def _jax_merged(j, inc_spans, exc_spans, filt):
    """_join_topk's merged rows and validity up to its statistics, from
    the JAX package's own membership functions on its arena."""
    import jax.numpy as jnp
    f16, fl, dd_all = j.arena.arrays()
    jdocids, jpos = j.arena.join_arrays()
    bmtab, dead = j.arena.bitmap_array(), j.arena.dead_array()
    rare, partners = inc_spans[0], inc_spans[1:]
    r = rare.count
    f = jnp.asarray(f16)[rare.start:rare.start + r].astype(jnp.int32)
    flr = jnp.asarray(fl)[rare.start:rare.start + r]
    dd = jnp.asarray(dd_all)[rare.start:rare.start + r]
    v = JD._tile_valid(dd, dead, jnp.ones(r, bool))
    pos_min = pos_max = f[:, JP.F_POSINTEXT]
    hit_min, flags_or = f[:, JP.F_HITCOUNT], flr

    def member(sp):
        if 0 <= sp.jslot < bmtab.shape[0]:
            return JD._membership_bitmap(bmtab, sp.jslot, jpos, sp.jstart, dd)
        m = JD._bucket_rows(sp.count)
        return JD._membership_sorted(jdocids, jpos, sp.jstart, m, dd, v,
                                     sp.count)
    for sp in partners:
        found, prow = member(sp)
        v &= found
        pp = jnp.asarray(f16)[prow, JP.F_POSINTEXT].astype(jnp.int32)
        pos_min, pos_max = jnp.minimum(pos_min, pp), jnp.maximum(pos_max, pp)
        hit_min = jnp.minimum(
            hit_min, jnp.asarray(f16)[prow, JP.F_HITCOUNT].astype(jnp.int32))
        flags_or = flags_or | jnp.where(found, jnp.asarray(fl)[prow], 0)
    for sp in exc_spans:
        found, _ = member(sp)
        v &= ~found
    merged = f.at[:, JP.F_WORDDISTANCE].set(pos_max - pos_min)
    merged = merged.at[:, JP.F_HITCOUNT].set(hit_min)
    v &= JD._constraint_valid(merged, flags_or, *filt)
    return np.asarray(merged), np.asarray(flags_or), np.asarray(v)


@pytest.mark.parametrize("filt", [KD.NO_FILTER, (DE, 3, 18_500, 20_500)],
                         ids=["no_filter", "all_filters"])
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_join_member_plain_on_jax_bytes_matches_join_topk(monkeypatch, corpus,
                                                          filt):
    """join_member_plain fed the JAX arena's bytes (convert.py) gives
    _join_topk's merged rows and flags where they are valid, and its
    validity everywhere, over a tombstoned rare span (C) joined to B and A
    and excluding nothing, and C joined to B excluding A."""
    idx, j, _t = _pair(monkeypatch, corpus)
    for d in range(0, 60_000, 97):
        idx.delete_doc(d)
    arrays = convert.arena_from_numpy(
        *(np.asarray(a) for a in j.arena.arrays()),
        np.asarray(j.arena.dead_array()), np.asarray(j.arena._pmax), "cpu")
    join = convert.join_from_numpy(
        *(np.asarray(a) for a in j.arena.join_arrays()),
        np.asarray(j.arena.bitmap_array()), "cpu")
    nslots = join[2].shape[0]
    sp = {th: j.spans_for(th)[0] for th in (A, B, C)}
    for inc, exc in (([C, B, A], []), ([C, B], [A])):
        want = _jax_merged(j, [sp[th] for th in inc], [sp[th] for th in exc],
                           filt)
        parts = [(sp[th].jstart, sp[th].count,
                  sp[th].jslot if 0 <= sp[th].jslot < nslots else -1)
                 for th in inc[1:] + exc]
        got = KD.join_member_plain(arrays[0], arrays[1], arrays[2], arrays[3],
                                   sp[C].start, sp[C].count, *join, parts,
                                   len(inc) - 1, filt)
        merged, fo, v = (x.numpy() for x in got)
        np.testing.assert_array_equal(v, want[2])
        assert 0 < v.sum() < len(v)
        np.testing.assert_array_equal(merged[v], want[0][v])
        np.testing.assert_array_equal(fo[v], want[1][v])
        # and the route on those bytes gives the JAX kernel's answer
        consts = TR.profile_consts(TR.RankingProfile(), JP.pack_language("en"),
                                   "cpu")
        out = TD.join_query(arrays, join, sp[C].start, sp[C].count, parts,
                            len(inc) - 1, consts, 64, filt).numpy()
        n = min(64, sp[C].count)
        s_, d_ = out[:n], out[n:2 * n]
        keep = (d_ >= 0) & (s_ > TD.NEG_INF32)
        j._topk_cache._d.clear()
        ref = j.rank_join(inc, exc, JProf(), "en", k=64,
                          lang_filter=filt[0], flag_bit=filt[1],
                          from_days=filt[2], to_days=filt[3])
        np.testing.assert_array_equal(s_[keep], ref[0])
        np.testing.assert_array_equal(d_[keep], ref[1])


def _docid_edges_pair(monkeypatch):
    """A rare term holding docids at the sort-mode clip (2^29 and one
    above it) and a partner holding 2^29: the clipped match of the
    reference, as the JAX store gives it."""
    for cls in (JD.DeviceSegmentStore, TD.DeviceSegmentStore):
        monkeypatch.setattr(cls, "JOIN_BITMAP_MIN", 1 << 30)
    rng = np.random.default_rng(21)
    idx = JRWI()
    j = JD.DeviceSegmentStore(idx)
    t = TD.DeviceSegmentStore(idx, device="cpu")
    idx.listener = KB.Fanout(j, t)
    pool = np.arange(5_000)
    rare, big = _plist(rng, 300, pool), _plist(rng, 2_000, pool)
    rare.docids[-1] = 2**29 + 5
    big.docids[-1] = 2**29
    idx.ingest_run({A: rare, B: big})
    return idx, j, t


def test_docid_clip_matches_jax(monkeypatch):
    _idx, j, t = _docid_edges_pair(monkeypatch)
    got = _join_both(j, t, [A, B], [], k=300)
    assert 2**29 + 5 in got[1].tolist()


HIGH = (2**29, 2**29 + 5, 2**29 + 77)   # rare docids the clip makes equal


@pytest.mark.parametrize("mode", ["include", "exclude"])
@pytest.mark.parametrize("partner_cap", [True, False],
                         ids=["partner_holds_2^29", "partner_without"])
@pytest.mark.parametrize("dead", ["none", "last_row", "first_row"])
@pytest.mark.parametrize("n_high", [2, 3])
def test_docid_clip_many_rows_matches_jax(monkeypatch, n_high, dead,
                                          partner_cap, mode):
    """Two and three live rare rows at or above 2^29 against a sort-mode
    partner holding exactly 2^29 (or not), one of them tombstoned (the
    last or the first in row order) or none, as an include partner and
    as an exclude: of the still-valid rows the clip makes equal only the
    last in row order matches, as the JAX store's co-sort decides."""
    for cls in (JD.DeviceSegmentStore, TD.DeviceSegmentStore):
        monkeypatch.setattr(cls, "JOIN_BITMAP_MIN", 1 << 30)
    rng = np.random.default_rng(22 + n_high)
    idx = JRWI()
    j = JD.DeviceSegmentStore(idx)
    t = TD.DeviceSegmentStore(idx, device="cpu")
    idx.listener = KB.Fanout(j, t)
    pool = np.arange(5_000)
    rare, big = _plist(rng, 300, pool), _plist(rng, 2_000, pool)
    rare.docids[-n_high:] = HIGH[:n_high]
    big.docids[-1] = 2**29 if partner_cap else 2**29 + 1
    idx.ingest_run({A: rare, B: big})
    sp = t.spans_for(A)[0]
    rows = t.arena.arrays()[2][sp.start:sp.start + sp.count].numpy()
    order = [int(d) for d in rows if d >= 2**29]   # row order
    assert len(order) == n_high
    if dead != "none":
        idx.delete_doc(order[-1] if dead == "last_row" else order[0])
    live = [d for d in order if d not in idx._tombstones]
    inc, exc = ([A, B], []) if mode == "include" else ([A], [B])
    got = _join_both(j, t, inc, exc, k=300)
    high = [d for d in got[1].tolist() if d >= 2**29]
    if mode == "include":
        assert high == ([live[-1]] if partner_cap else [])
    else:
        assert sorted(high) == sorted(live[:-1] if partner_cap else live)
    # K8's plain twin on the JAX arena's own bytes: the same rule
    parts = [(t.spans_for(B)[0].jstart, t.spans_for(B)[0].count, -1)]
    _m, _fo, v = KD.join_member_plain(
        *(a for a in t.arena.arrays()), t.arena.dead_array(), sp.start,
        sp.count, *t.arena.join_arrays(), t.arena.bitmap_array(), parts,
        1 if mode == "include" else 0)
    valid_high = sorted(int(d) for d in rows[v.numpy()] if d >= 2**29)
    assert valid_high == sorted(high)


def test_searchevent_two_word_query_with_port_store_matches_jax_store(
        monkeypatch):
    """SearchEvent's page for a two-word query with the port store as
    segment.devstore equals the JAX store's, served by the port's
    rank_join."""
    from yacy_search_server_tpu.document.document import Document
    from yacy_search_server_tpu.index.segment import Segment
    from yacy_search_server_tpu.ops import ranking
    from yacy_search_server_tpu.search.query import QueryParams
    from yacy_search_server_tpu.search.searchevent import SearchEvent
    monkeypatch.setattr(ranking, "SMALL_RANK_N", 0)

    def segment():
        seg = Segment(max_ram_postings=50)
        rng = np.random.default_rng(8)
        for i in range(60):
            words = "gondola lift" if i % 3 else "gondola"
            seg.store_document(Document(
                url=f"http://h{i % 7}.example/p{i}.html",
                title=f"{words} {i}",
                text=f"{words} station {i} " * (1 + int(rng.integers(1, 5)))))
        seg.rwi.flush()
        while seg.rwi.merge_runs(max_runs=1):
            pass
        return seg

    def page(seg, qs, n=10):
        ev = SearchEvent(QueryParams.parse(qs, item_count=n), seg)
        return [(r.docid, r.score) for r in ev.results()]

    jseg, tseg = segment(), segment()
    jseg.enable_device_serving()
    tseg.devstore = TD.DeviceSegmentStore(tseg.rwi, device="cpu")
    want = page(jseg, "gondola lift")
    assert page(tseg, "gondola lift") == want and len(want) == 10
    assert tseg.devstore.join_served == jseg.devstore.join_served == 1
    assert page(tseg, "gondola -lift") == page(jseg, "gondola -lift")
    assert tseg.devstore.join_served == jseg.devstore.join_served
