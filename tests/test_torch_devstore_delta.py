"""RAM deltas, facet bitmaps, the top-k result cache and the counters of
the port's device store against the JAX package's, on the CPU.

One RWI feeds a JAX store and a port store (`device="cpu"`, the plain
versions) through `kernels/bench.Fanout`. `rank_term` with a term's
unflushed postings (the RAM delta: K6/K7 read it after the extents) and
with a facet docid bitmap (`filter_bitmap`, the with_filter branch)
must return the JAX store's scores, docids, order and `considered`, with
equal counters; the plain K6/K7/topk_finish with a delta block and a
bitmap must equal `_rank_spans_packed_kernel` on the JAX arena's own
bytes; `rank_cache_get` must serve the cold answer and go stale exactly
when the JAX store's does. No tolerance: every output is int32.
"""

import numpy as np
import pytest
import torch

from yacy_search_server_tpu.index import devstore as JD
from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.index.rwi import RWIIndex as JRWI
from yacy_search_server_tpu.ops.ranking import RankingProfile as JProf
from yacy_search_server_tpu_torch import convert
from yacy_search_server_tpu_torch.index import devstore as TD
from yacy_search_server_tpu_torch.kernels import bench as KB
from yacy_search_server_tpu_torch.kernels import devstore as KD
from yacy_search_server_tpu_torch.ops import ranking as TR

TILE = JD.TILE
TH = b"deltatermAAA"
DE = JP.pack_language("de")
COUNTERS = ("prune_rounds", "pruned_tiles", "stream_scans", "queries_served",
            "fallbacks", "filtered_served")


def _plist(rng, n, base=0, step=1, lang="en"):
    docids = (base + step * np.arange(n)).astype(np.int32)
    feats = rng.integers(0, 1000, (n, JP.NF)).astype(np.int32)
    feats[:, JP.F_FLAGS] = rng.integers(0, 2 ** 20, n)
    feats[:, JP.F_DOMLENGTH] = rng.integers(0, 256, n)
    feats[:, JP.F_LANGUAGE] = JP.pack_language(lang)
    feats[::3, JP.F_LANGUAGE] = DE
    feats[:, JP.F_LASTMOD] = rng.integers(100, 300, n)
    return JP.PostingsList(docids, feats)


def _stores(idx):
    j = JD.DeviceSegmentStore(idx)
    t = TD.DeviceSegmentStore(idx, device="cpu")
    idx.listener = KB.Fanout(j, t)
    return j, t


def _both(j, t, *a, **kw):
    """rank_term on both stores without their result caches: equal
    answers and counters."""
    j._topk_cache._d.clear()
    t._topk_cache.clear()
    want = j.rank_term(*a, **kw)
    got = t.rank_term(*a, **kw)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    assert [getattr(t, c) for c in COUNTERS] == \
        [getattr(j, c) for c in COUNTERS]
    return got


def _corpus(rng, n=3_000, runs=1):
    idx = JRWI()
    j, t = _stores(idx)
    for r in range(runs):
        idx.add_many(TH, _plist(rng, n, base=10 * r, step=3))
        idx.flush()
    return idx, j, t


# ---------------------------------------------------------------------------
# RAM deltas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_delta", [7, 256, 1024, 262_145],
                         ids=["below_first_bucket", "bucket_edge_256",
                              "bucket_edge_1024", "past_last_bucket"])
def test_delta_matches_jax(n_delta):
    """A RAM delta below the first bucket, at two bucket edges and past
    262,144 rows (a TILE-rounded block): the exact scan over the span and
    the delta, `considered` counting both, and no fallback."""
    rng = np.random.default_rng(60)
    idx, j, t = _corpus(rng, runs=1)
    idx.add_many(TH, _plist(rng, n_delta, base=1_000_000))
    for k in (10, 300):
        got = _both(j, t, TH, JProf(), k=k)
        assert got[2] == 3_000 + n_delta
    assert t.stream_scans == 2 and t.prune_rounds == 0 and t.fallbacks == 0
    assert KD.bucket_delta(n_delta) == JD._bucket_delta(n_delta)


def test_delta_duplicates_and_tombstones_match_jax():
    """A delta holding docids of the span (both rows scored, the better
    kept), and tombstoned docids in the span and in the delta."""
    rng = np.random.default_rng(61)
    idx, j, t = _corpus(rng, runs=2)
    idx.add_many(TH, _plist(rng, 500, base=0, step=6))   # span docids
    _both(j, t, TH, JProf(), k=1000)
    for d in (0, 6, 12, 9, 3_003):
        idx.delete_doc(d)
    idx.add_many(TH, _plist(rng, 40, base=9_000))
    got = _both(j, t, TH, JProf(), k=1000)
    assert not {0, 6, 12, 9, 3_003} & set(got[1].tolist())
    _both(j, t, TH, JProf(worddistance=2, appemph=15, urllength=12, tf=3),
          k=50)


FILTERS = {
    "language": dict(lang_filter=DE),
    "flag": dict(flag_bit=3),
    "flag_sign": dict(flag_bit=40),
    "date_range": dict(from_days=150, to_days=200),
    "all_four": dict(lang_filter=DE, flag_bit=5, from_days=120, to_days=260),
}


@pytest.mark.parametrize("name", list(FILTERS))
def test_delta_under_each_filter_matches_jax(name):
    """A delta under each constraint filter: the filter in K6/K7 on the
    delta's rows too; a delta query never touches the filtered-stats
    cache."""
    rng = np.random.default_rng(62)
    idx, j, t = _corpus(rng)
    idx.add_many(TH, _plist(rng, 600, base=50_000))
    _both(j, t, TH, JProf(), k=200, **FILTERS[name])
    _both(j, t, TH, JProf(), k=200, **FILTERS[name])
    assert not t._span_stats_cache


def test_delta_only_term_matches_jax():
    """A term no run holds, only RAM rows: served by the delta alone."""
    rng = np.random.default_rng(63)
    idx, j, t = _corpus(rng)
    other = b"ramonlyAAAAA"
    idx.add_many(other, _plist(rng, 90, base=7))
    got = _both(j, t, other, JProf(), k=20)
    assert got[2] == 90 and len(got[1]) == 20
    _both(j, t, other, JProf(), k=20, lang_filter=DE)


def test_delta_plain_kernels_match_jax_kernel():
    """K6 -> K7 -> kernel 3 -> topk_finish with a delta block and a bitmap
    on the JAX arena's own bytes against _rank_spans_packed_kernel's whole
    [2kk + 36] vector."""
    rng = np.random.default_rng(64)
    idx = JRWI()
    for r in range(2):
        idx.add_many(TH, _plist(rng, TILE + 77 if r == 0 else 900,
                                base=r * 5, step=2))
        idx.flush()
    j = JD.DeviceSegmentStore(idx)
    for d in (1, 4, 1_000_003):
        idx.delete_doc(d)
    spans = j.spans_for(TH)
    delta = _plist(rng, 300, base=999_000, step=7)
    delta.docids[::5] = 2 * np.arange(60)       # docids of the spans
    b = JD._bucket_delta(len(delta))
    df = np.zeros((b, JP.NF), np.int16)
    dfl = np.zeros(b, np.int32)
    ddd = np.full(b, -1, np.int32)
    cf, cfl = TR.compact_feats(delta.feats)
    df[:300], dfl[:300], ddd[:300] = cf, cfl, delta.docids
    words = np.zeros(1 << 16, np.uint32)
    allowed = rng.choice(1 << 20, 200_000, replace=False)
    np.bitwise_or.at(words, allowed >> 5,
                     np.uint32(1) << (allowed & 31).astype(np.uint32))
    prof = JProf()
    f, fl, dd = j.arena.arrays()
    starts = np.zeros(JD.DeviceSegmentStore.MAX_SPANS, np.int32)
    counts = np.zeros_like(starts)
    for i, sp in enumerate(spans):
        starts[i], counts[i] = sp.start, sp.count
    zero = np.zeros(JP.NF, np.int32)
    consts = TR.profile_consts(convert.profile_from_jax(
        prof.to_external_string()), TR.P.pack_language("en"), "cpu")
    arrays = convert.arena_from_numpy(
        *(np.asarray(a) for a in (f, fl, dd)),
        np.asarray(j.arena.dead_array()), np.asarray(j.arena._pmax), "cpu")
    tdelta = convert.delta_from_numpy(df, dfl, ddd, "cpu")
    for kk in (16, 1024):
        for filt, with_filter in ((JD.NO_LANG, False), (DE, True)):
            want = np.asarray(JD._rank_spans_packed_kernel(
                f, fl, dd, j.arena.dead_array(), starts, counts, df, dfl,
                ddd, words, np.int32(filt), np.int32(JD.NO_FLAG),
                np.int32(JD.DAYS_NONE_LO), np.int32(JD.DAYS_NONE_HI), zero,
                zero, np.float32(0), np.float32(0),
                *j._profile_consts(prof, "en"), k=kk,
                n_spans=JD.DeviceSegmentStore.MAX_SPANS, with_delta=True,
                with_filter=with_filter))
            got = TD.scan_query(
                arrays, [(sp.start, sp.count) for sp in spans], consts, kk,
                (filt, KD.NO_FLAG, KD.DAYS_NONE_LO, KD.DAYS_NONE_HI),
                delta=tdelta,
                allow=convert.bitmap_from_numpy(words, "cpu")
                if with_filter else None)
            np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# facet bitmaps
# ---------------------------------------------------------------------------

def _bitmaps(j, t, allowed, capacity, combo=(("site", "a.example"),),
             version=0):
    key = (combo, version, capacity)
    return (j.filter_bitmap(key, lambda: allowed),
            t.filter_bitmap(key, lambda: allowed))


@pytest.mark.parametrize("extra", ["alone", "with_filter", "with_delta",
                                   "filter_and_delta"])
def test_facet_bitmap_matches_jax(extra):
    """A facet bitmap alone, with a constraint filter, with a RAM delta and
    with both: only allowed docids, the JAX store's answer, counted in
    filtered_served; docids past the bitmap (capacity 40,000: 2048 words
    cover 65,536) excluded."""
    rng = np.random.default_rng(65)
    idx, j, t = _corpus(rng, n=30_000)            # docids to 90,000
    allowed = np.sort(rng.choice(90_000, 9_000, replace=False))
    jb, tb = _bitmaps(j, t, allowed, 40_000)
    assert tb.dtype == torch.int32 and tb.shape[0] == 2048
    np.testing.assert_array_equal(tb.numpy().view(np.uint32),
                                  np.asarray(jb))
    kw = dict(lang_filter=DE) if "filter" in extra else {}
    if "delta" in extra:
        idx.add_many(TH, _plist(rng, 700, base=20_001, step=11))
    j._topk_cache._d.clear()
    want = j.rank_term(TH, JProf(), k=500, allow_bitmap=jb, **kw)
    got = t.rank_term(TH, JProf(), k=500, allow_bitmap=tb, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and len(got[1]) > 50
    ok = set(allowed[allowed < 40_000].tolist())
    assert set(got[1].tolist()) <= ok
    assert [getattr(t, c) for c in COUNTERS] == \
        [getattr(j, c) for c in COUNTERS]
    assert t.filtered_served == 1 and t.fallbacks == 0


def test_facet_bitmap_stats_cache_matches_jax(monkeypatch):
    """A repeated bitmap query takes its statistics from the filtered-stats
    cache (K6 not run); another bitmap of the same combo count is another
    entry; a tombstone makes the entry stale; answers equal the JAX
    store's each time."""
    rng = np.random.default_rng(66)
    idx, j, t = _corpus(rng, n=5_000)
    calls = []
    real = KD.span_stats
    monkeypatch.setattr(KD, "span_stats", lambda *a, **kw: (
        calls.append(1), real(*a, **kw))[1])
    allowed = np.arange(0, 15_000, 4)
    jb, tb = _bitmaps(j, t, allowed, 15_000)

    def both():
        j._topk_cache._d.clear()
        want = j.rank_term(TH, JProf(), k=100, allow_bitmap=jb)
        got = t.rank_term(TH, JProf(), k=100, allow_bitmap=tb)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        return got
    cold = both()
    hot = both()
    assert len(calls) == 1
    np.testing.assert_array_equal(hot[1], cold[1])
    jb2, tb2 = _bitmaps(j, t, np.arange(1, 15_000, 4), 15_000,
                        combo=(("site", "b.example"),))
    j._topk_cache._d.clear()
    want = j.rank_term(TH, JProf(), k=100, allow_bitmap=jb2)
    got = t.rank_term(TH, JProf(), k=100, allow_bitmap=tb2)
    np.testing.assert_array_equal(got[1], want[1])
    assert len(calls) == 2 and len(t._span_stats_cache) == 2
    idx.delete_doc(int(cold[1][0]))
    after = both()
    assert len(calls) == 3 and int(cold[1][0]) not in after[1].tolist()


def test_filter_bitmap_cache_ttl_and_single_flight():
    """filter_bitmap: one build per combo under 8 concurrent callers, a
    newer facet version within FILTER_TTL_S served from the cache, at
    most FILTER_CACHE_MAX combos kept."""
    import threading
    import time
    rng = np.random.default_rng(67)
    _idx, _j, t = _corpus(rng, n=100)
    builds = []

    def fn():
        builds.append(1)
        time.sleep(0.2)
        return np.arange(0, 500, 3)
    key = ((("ft", "pdf"),), 0, 500)
    got = []
    ts = [threading.Thread(target=lambda: got.append(
        t.filter_bitmap(key, fn))) for _ in range(8)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=30)
    assert len(builds) == 1 and all(g is got[0] for g in got)
    assert t.filter_bitmap(((("ft", "pdf"),), 1, 500), fn) is got[0]
    assert len(builds) == 1
    for i in range(20):
        t.filter_bitmap(((("site", f"h{i}"),), 0, 500), fn)
    assert len(t._filter_cache) == t.FILTER_CACHE_MAX


# ---------------------------------------------------------------------------
# the top-k result cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change", ["flush", "delete", "merge", "term_drop"])
def test_rank_cache_hit_and_stale_match_jax(change):
    """A repeat is a cache hit equal to the cold answer with no device
    work; every epoch change makes the entry stale (the next query
    recomputes it), in step with the JAX store's cache counters."""
    rng = np.random.default_rng(68)
    idx, j, t = _corpus(rng, n=4_000)
    cold = (j.rank_term(TH, JProf(), k=30), t.rank_term(TH, JProf(), k=30))
    rounds = t.prune_rounds
    hot = (j.rank_term(TH, JProf(), k=30), t.rank_term(TH, JProf(), k=30))
    for a, b in ((cold[1], hot[1]), (cold[0], cold[1]), (hot[0], hot[1])):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert t.prune_rounds == rounds
    assert t._topk_cache.hits == j._topk_cache.hits == 1
    if change == "flush":
        idx.add_many(b"otherAAAAAAA", _plist(rng, 50))
        idx.flush()
    elif change == "delete":
        idx.delete_doc(int(cold[1][1][0]))
    elif change == "merge":
        idx.add_many(TH, _plist(rng, 50, base=100_000))
        idx.flush()
        assert idx.merge_runs(max_runs=1)
    else:
        idx.remove_term(TH)
    again = (j.rank_term(TH, JProf(), k=30), t.rank_term(TH, JProf(), k=30))
    np.testing.assert_array_equal(again[1][0], again[0][0])
    np.testing.assert_array_equal(again[1][1], again[0][1])
    assert t._topk_cache.stale == j._topk_cache.stale == 1
    c = t.counters()
    assert c["rank_cache_hits"] == 1 and c["rank_cache_stale"] == 1


def test_rank_cache_delta_gate_and_stale_ok_match_jax():
    """A RAM delta gates rank_cache_get (None while the term has
    unflushed rows; the query itself is served fresh, never cached);
    stale_ok answers from an epoch-stale entry and keeps it."""
    rng = np.random.default_rng(69)
    idx, j, t = _corpus(rng, n=2_000)
    cold = t.rank_term(TH, JProf(), k=20)
    j.rank_term(TH, JProf(), k=20)
    idx.add_many(TH, _plist(rng, 5, base=800_000))
    assert t.rank_cache_get(TH, JProf(), "en", 20) is None
    assert j.rank_cache_get(TH, JProf(), "en", 20) is None
    got = t.rank_cache_get(TH, JProf(), "en", 20, stale_ok=True)
    np.testing.assert_array_equal(got[1], cold[1])
    fresh = (j.rank_term(TH, JProf(), k=20), t.rank_term(TH, JProf(), k=20))
    np.testing.assert_array_equal(fresh[1][1], fresh[0][1])
    assert fresh[1][2] == 2_005
    idx.flush()                         # epoch moves; the delta is gone
    assert t.rank_cache_get(TH, JProf(), "en", 20) is None
    assert j.rank_cache_get(TH, JProf(), "en", 20) is None
    assert (t._topk_cache.stale, t._topk_cache.stale_served) == \
        (j._topk_cache.stale, j._topk_cache.stale_served)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

def test_counters_have_every_jax_key():
    """counters() carries every key of the JAX store's, so /metrics and the
    health rules resolve against the port's store; the keys this slice
    serves hold its counts."""
    rng = np.random.default_rng(70)
    idx, j, t = _corpus(rng, n=1_000)
    _both(j, t, TH, JProf(), k=10)
    jc, tc = j.counters(), t.counters()
    assert set(jc) <= set(tc), sorted(set(jc) - set(tc))
    for key in ("queries_served", "fallbacks", "prune_rounds",
                "pruned_tiles", "stream_scans", "filtered_served",
                "arena_epoch", "batch_dispatches", "batch_timeouts"):
        assert tc[key] == jc[key], key
    assert tc["device_round_trips"] >= 1
