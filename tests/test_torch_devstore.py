"""The port's devstore slice A against the JAX package's, on the CPU.

The same numpy-seeded postings feed both packages: the arena, the spans
and the pmax side-table the port packs must equal the JAX store's; the
plain versions of the devstore kernels (K5 `pruned_tile`, the b > 1
route, K6 -> K7 -> kernel 3 -> `topk_finish`), run on the JAX store's
own arena bytes (convert.arena_from_numpy), must equal the JAX kernels'
raw outputs; and `rank_term` must return the same (scores, docids,
considered) with the same prune/scan counters on the corpora of
tests/test_devstore.py. No tolerance: every output is int32, equal to the
bit.
"""

import numpy as np
import pytest

from yacy_search_server_tpu.index import devstore as JD
from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.index.rwi import RWIIndex as JRWI
from yacy_search_server_tpu.ops.ranking import RankingProfile as JProf
from yacy_search_server_tpu_torch import convert
from yacy_search_server_tpu_torch.index import devstore as TD
from yacy_search_server_tpu_torch.index import postings as TP
from yacy_search_server_tpu_torch.index.rwi import RWIIndex as TRWI
from yacy_search_server_tpu_torch.kernels import bench as KB
from yacy_search_server_tpu_torch.kernels import devstore as KD
from yacy_search_server_tpu_torch.ops import ranking as TR

TILE = JD.TILE
TH = b"devtermAAAAA"
NONDEFAULT = dict(worddistance=2, appemph=15, urllength=12, tf=3)


def _plist(rng, n, base=0, lang="en", step=1):
    """tests/test_devstore.py's postings: random columns, docids from
    `base` every `step`."""
    docids = (base + step * np.arange(n)).astype(np.int32)
    feats = rng.integers(0, 1000, (n, JP.NF)).astype(np.int32)
    feats[:, JP.F_FLAGS] = rng.integers(0, 2 ** 20, n)
    feats[:, JP.F_DOMLENGTH] = rng.integers(0, 256, n)
    feats[:, JP.F_LANGUAGE] = JP.pack_language(lang)
    return JP.PostingsList(docids, feats)


def _tied(p, every=97):
    """Hold one column constant (a zero-span column) and repeat the best
    row every `every` rows: equal scores fill the top-k, ranked by arena
    position."""
    p.feats[:, JP.F_LASTMOD] = 4321
    p.feats[::every] = p.feats[np.argmax(TR.cardinal_scores_host(
        p.feats, TR.RankingProfile()))]
    return p


def _stores(idx, **kw):
    j = JD.DeviceSegmentStore(idx, **kw)
    t = TD.DeviceSegmentStore(idx, device="cpu", **kw)
    idx.listener = KB.Fanout(j, t)
    return j, t


def _jax_rank(j, *a, **kw):
    """The JAX store's rank_term without its result cache (a cache hit
    would skip the counters compared; _rank_both clears the port's)."""
    j._topk_cache._d.clear()
    return j.rank_term(*a, **kw)


def _same_answer(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def _counters(s):
    return (s.prune_rounds, s.pruned_tiles, s.stream_scans,
            s.queries_served, s.fallbacks)


def _arrays(j):
    """The JAX store's arena as the port's CPU tensors, and its consts."""
    f, fl, d = (np.asarray(a) for a in j.arena.arrays())
    return convert.arena_from_numpy(f, fl, d, np.asarray(j.arena.dead_array()),
                                    np.asarray(j.arena._pmax), "cpu")


def _tspan(sp):
    return convert.span_from_fields(sp.start, sp.count, sp.tstart, sp.tcount,
                                    sp.stats, sp.dead_seq)


# ---------------------------------------------------------------------------
# arena, spans and pmax
# ---------------------------------------------------------------------------

def _corpus_one(idx, rng):
    idx.add_many(TH, _tied(_plist(rng, 2 * TILE + 77)))
    idx.flush()


def _corpus_several(idx, rng):
    for i, n in enumerate((500, TILE + 5_000, 3, 1_000)):
        idx.add_many(b"term%08d" % i, _plist(rng, n, base=7 * i, step=3))
    idx.flush()


def _corpus_two_runs(idx, rng):
    _corpus_several(idx, rng)
    idx.add_many(TH, _plist(rng, 40_000, base=100_000))
    idx.add_many(b"term00000001", _plist(rng, 900, base=1))
    idx.flush()
    idx.delete_doc(21)
    idx.delete_doc(150_001)


@pytest.mark.parametrize("corpus", [_corpus_one, _corpus_several,
                                    _corpus_two_runs],
                         ids=["one_term", "several_terms", "two_runs"])
def test_arena_spans_and_pmax_match_jax(corpus):
    idx = JRWI()
    j, t = _stores(idx)
    corpus(idx, np.random.default_rng(30))
    jf, jfl, jd = (np.asarray(a) for a in j.arena.arrays())
    tf, tfl, td = (a.numpy() for a in t.arena.arrays())
    assert t.arena.used_rows == j.arena.used_rows
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tfl, jfl)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(t.arena.dead_array().numpy(),
                                  np.asarray(j.arena.dead_array()))
    np.testing.assert_array_equal(t.arena._pmax.numpy(),
                                  np.asarray(j.arena._pmax))
    terms = set().union(*(r.term_hashes() for r in idx._runs))
    for th in terms:
        js, ts = j.spans_for(th), t.spans_for(th)
        assert len(js) == len(ts) >= 1
        for a, b in zip(js, ts):
            assert (a.start, a.count, a.tstart, a.tcount, a.dead_seq) == \
                (b.start, b.count, b.tstart, b.tcount, b.dead_seq)
            for key in ("col_min", "col_max", "tf_min", "tf_max"):
                np.testing.assert_array_equal(b.stats[key], a.stats[key])


# ---------------------------------------------------------------------------
# the kernels' plain versions on the JAX store's arena bytes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kstore():
    """A JAX store over three terms (a ragged multi-tile one with ties, a
    short one, one of TILE - 5 rows) in one run, docids past the 65,536
    bitmap slots, and tombstones after the pack (in the first tile, and
    one short term's every row)."""
    rng = np.random.default_rng(31)
    idx = JRWI()
    idx.add_many(b"bigAAAAAAAAA", _tied(_plist(rng, 3 * TILE + 123,
                                               step=2)))
    idx.add_many(b"shortAAAAAAA", _plist(rng, 700, base=200_001, step=5))
    idx.add_many(b"almostAAAAAA", _tied(_plist(rng, TILE - 5, base=1,
                                               step=2), every=31))
    idx.add_many(b"deadAAAAAAAA", _plist(rng, 40, base=3, step=1000))
    idx.flush()
    j = JD.DeviceSegmentStore(idx)
    for d in (0, 2, 4, 64, 1_000, 3_003, 40_003):
        idx.delete_doc(d)
    for d in range(3, 40_000, 1000):
        idx.delete_doc(d)
    return idx, j


def _jconsts(j, prof, lang="en"):
    return j._profile_consts(prof, lang)


def _tconsts(prof, lang="en"):
    return TR.profile_consts(convert.profile_from_jax(
        prof.to_external_string()), TP.pack_language(lang), "cpu")


def _slots(j, names, bs):
    """The spans of `names`, then pad slots up to bs (all-zero fields,
    tcount 0): per slot (start, count, tstart, tcount, cmin, cmax, tmin,
    tmax)."""
    out = []
    for th in names:
        sp = j.spans_for(th)[0]
        st = sp.stats
        out.append((sp.start, sp.count, sp.tstart, sp.tcount,
                    st["col_min"], st["col_max"], st["tf_min"],
                    st["tf_max"]))
    zero = np.zeros(JP.NF, np.int32)
    out += [(0, 0, 0, 0, zero, zero, np.float32(0), np.float32(0))] * (
        bs - len(out))
    return out


NAMES = [b"bigAAAAAAAAA", b"almostAAAAAA", b"shortAAAAAAA"]


@pytest.fixture(scope="module")
def tile_edge_store():
    """A JAX store over kernels/bench.TILE_EDGE_TERMS: a span shorter
    than every kk, one of exactly one tile, one all dead, one of equal
    scores live across places 2,047/2,048 and 4,095/4,096."""
    return KB.tile_edges(JRWI(), JD.DeviceSegmentStore,
                         plist=JP.PostingsList)


@pytest.mark.parametrize("kk", [16, 128, 1024, 2048])
@pytest.mark.parametrize("bs", [1, 4, "tile_edges"])
def test_pruned_tile_batch1_matches_jax(request, kstore, bs, kk):
    """K5 without init: _rank_pruned_batch1_packed_kernel, pad slots
    included (raw docids of masked rows, vacuous ok); "tile_edges": the
    four edge spans in one descriptor (places past a short span's count,
    a whole tile, every row dead, ties across K5's CTA boundaries)."""
    _idx, j = kstore
    prof = JProf()
    if bs == "tile_edges":
        j = request.getfixturevalue("tile_edge_store")
        bs = len(KB.TILE_EDGE_TERMS)
        slots = _slots(j, list(KB.TILE_EDGE_TERMS), bs)
    else:
        slots = _slots(j, NAMES[:bs - 1] if bs > 1 else NAMES[:1], bs)
    shift, lang = JD.prune_bound_consts(prof)
    cols = list(zip(*slots))
    qiq, nbs = JD._pack_batch1_fused(
        *(np.asarray(c, np.int32) for c in cols[:4]),
        np.stack(cols[4]), np.stack(cols[5]),
        np.asarray(cols[6], np.float32), np.asarray(cols[7], np.float32),
        shift, lang)
    desc = KD.pack_desc(slots, int(shift), int(lang))
    np.testing.assert_array_equal(desc, qiq)
    f, fl, d = j.arena.arrays()
    want = np.asarray(JD._rank_pruned_batch1_packed_kernel(
        f, fl, d, j.arena.dead_array(), j.arena._pmax, qiq,
        *_jconsts(j, prof), k=kk, maxt=JD._pmax_window(j._max_tcount),
        bs=nbs))
    got = KD.pruned_tile(*_arrays(j), desc, kk, _tconsts(prof), init=False)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_pruned(j, sp, prof, kk, b):
    f, fl, d = j.arena.arrays()
    shift, lang = JD.prune_bound_consts(prof)
    st = sp.stats
    s, dd, ok = JD._rank_pruned_kernel(
        f, fl, d, j.arena.dead_array(), j.arena._pmax, np.int32(sp.start),
        np.int32(sp.count), np.int32(sp.tstart), np.int32(sp.tcount),
        st["col_min"], st["col_max"], st["tf_min"], st["tf_max"], shift,
        lang, *_jconsts(j, prof), k=kk, b=b)
    return np.concatenate([np.asarray(s), np.asarray(dd),
                           [int(bool(ok))]]).astype(np.int32)


@pytest.mark.parametrize("kk", [16, 128, 1024])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("name", NAMES + [b"deadAAAAAAAA"])
def test_pruned_route_matches_jax(kstore, name, b, kk):
    """The store's pruned route (K5 with init at b = 1; K7 -> kernel 3 ->
    topk_finish at b = 8) against _rank_pruned_kernel."""
    _idx, j = kstore
    prof = JProf()
    sp = j.spans_for(name)[0]
    shift, lang = JD.prune_bound_consts(prof)
    got = TD.pruned_query(_arrays(j), _tspan(sp), shift, lang,
                          _tconsts(prof), kk, b)
    np.testing.assert_array_equal(got.numpy(), _jax_pruned(j, sp, prof, kk, b))


def test_pruned_route_pad_slots_match_jax_batch(kstore):
    """_rank_pruned_batch_kernel at b = 1 and b = 8 over real and pad
    slots: K5 with init, and the b > 1 route slot by slot."""
    _idx, j = kstore
    prof, kk = JProf(), 128
    slots = _slots(j, NAMES[:2], 4)
    shift, lang = JD.prune_bound_consts(prof)
    cols = list(zip(*slots))
    f, fl, d = j.arena.arrays()
    arrays, consts = _arrays(j), _tconsts(prof)
    for b in (1, 8):
        s, dd, ok = JD._rank_pruned_batch_kernel(
            f, fl, d, j.arena.dead_array(), j.arena._pmax,
            *(np.asarray(c, np.int32) for c in cols[:4]),
            np.stack(cols[4]), np.stack(cols[5]),
            np.asarray(cols[6], np.float32), np.asarray(cols[7], np.float32),
            shift, lang, *_jconsts(j, prof), k=kk, b=b)
        want = np.concatenate([np.asarray(s), np.asarray(dd),
                               np.asarray(ok)[:, None].astype(np.int32)], 1)
        if b == 1:
            got = KD.pruned_tile(*arrays, KD.pack_desc(slots, int(shift),
                                                       int(lang)),
                                 kk, consts, init=True).numpy()
        else:
            got = np.stack([TD.pruned_query(
                arrays, TD.Span(*sl[:4], {"col_min": sl[4], "col_max": sl[5],
                                          "tf_min": sl[6],
                                          "tf_max": sl[7]}),
                shift, lang, consts, kk, b).numpy() for sl in slots])
        np.testing.assert_array_equal(got, want)


def test_pruned_route_bound_fails_like_jax(kstore):
    """A profile whose tail bound fails at b = 1 (ok = 0) and holds once
    the prefix covers the span."""
    _idx, j = kstore
    prof = JProf(**NONDEFAULT)
    sp = j.spans_for(b"bigAAAAAAAAA")[0]
    shift, lang = JD.prune_bound_consts(prof)
    oks = []
    for b in (1, 8):
        want = _jax_pruned(j, sp, prof, 16, b)
        got = TD.pruned_query(_arrays(j), _tspan(sp), shift, lang,
                              _tconsts(prof), 16, b).numpy()
        np.testing.assert_array_equal(got, want)
        oks.append(int(got[-1]))
    assert oks == [0, 1]


def _jax_scan(j, spans, prof, kk):
    f, fl, d = j.arena.arrays()
    starts = np.zeros(JD.DeviceSegmentStore.MAX_SPANS, np.int32)
    counts = np.zeros_like(starts)
    for i, sp in enumerate(spans):
        starts[i], counts[i] = sp.start, sp.count
    zero = np.zeros(JP.NF, np.int32)
    return np.asarray(JD._rank_spans_packed_kernel(
        f, fl, d, j.arena.dead_array(), starts, counts,
        np.zeros((1, JP.NF), np.int16), np.zeros(1, np.int32),
        np.full(1, -1, np.int32), np.zeros(1, np.uint32),
        np.int32(JD.NO_LANG), np.int32(JD.NO_FLAG),
        np.int32(JD.DAYS_NONE_LO), np.int32(JD.DAYS_NONE_HI),
        zero, zero, np.float32(0), np.float32(0), *_jconsts(j, prof),
        k=kk, n_spans=JD.DeviceSegmentStore.MAX_SPANS, with_delta=False))


@pytest.mark.parametrize("runs", [1, 2, 8])
@pytest.mark.parametrize("kk", [16, 1024])
def test_exact_scan_matches_jax(runs, kk):
    """K6 -> K7 -> kernel 3 -> topk_finish against
    _rank_spans_packed_kernel's whole [2kk + 36] vector, over 1, 2 and 8
    spans (ragged, one past a tile) with tombstones."""
    rng = np.random.default_rng(32)
    idx = JRWI()
    sizes = [TILE + 900, 300, 5, 2_000, 77, 4_097, 1, 640][:runs]
    for i, n in enumerate(sizes):
        idx.add_many(TH, _tied(_plist(rng, n, base=50_000 * i, step=3)))
        idx.flush()
    j = JD.DeviceSegmentStore(idx)
    for dd in (0, 3, 33, 50_001 + 3 * 7, 150_003):
        idx.delete_doc(dd)
    spans = j.spans_for(TH)
    assert len(spans) == runs
    prof = JProf()
    got = TD.scan_query(_arrays(j), [(sp.start, sp.count) for sp in spans],
                        _tconsts(prof), kk)
    np.testing.assert_array_equal(got.numpy(), _jax_scan(j, spans, prof, kk))


# ---------------------------------------------------------------------------
# rank_term on tests/test_devstore.py's corpora
# ---------------------------------------------------------------------------

def _rank_both(j, t, *a, **kw):
    want = _jax_rank(j, *a, **kw)
    t._topk_cache.clear()
    got = t.rank_term(*a, **kw)
    _same_answer(got, want)
    assert _counters(t) == _counters(j)
    return got


@pytest.mark.parametrize("n,k,lang,nondefault", [
    (500, 50, "en", False),
    (TILE + 5_000, 30, "en", False),
    (4 * TILE + 123, 100, "en", False),
    (2 * TILE + 77, 60, "en", True),
    (TILE + 500, 50, "de", False),
], ids=["500", "tile_plus_5000", "four_tiles", "nondefault_profile",
        "language_de"])
def test_rank_term_matches_jax(n, k, lang, nondefault):
    rng = np.random.default_rng(20)
    idx = JRWI()
    p = _plist(rng, n)
    if lang == "de":
        p.feats[::3, JP.F_LANGUAGE] = JP.pack_language("de")
    idx.add_many(TH, p)
    idx.flush()
    j, t = _stores(idx)
    prof = JProf(**NONDEFAULT) if nondefault else JProf()
    got = _rank_both(j, t, TH, prof, language=lang, k=k)
    assert got[2] == n and len(got[1]) == min(k, n)
    if n == 4 * TILE + 123:
        assert t.pruned_tiles >= 3
    if nondefault:
        assert t.prune_rounds >= 2, "the non-default profile escalates"


def test_rank_term_tombstone_until_merge_matches_jax():
    rng = np.random.default_rng(23)
    idx = JRWI()
    idx.add_many(TH, _plist(rng, 2 * TILE))
    idx.flush()
    j, t = _stores(idx)
    _rank_both(j, t, TH, JProf(), k=10)
    rounds0 = t.prune_rounds
    idx.delete_doc(3)
    _rank_both(j, t, TH, JProf(), k=10)
    assert t.prune_rounds == rounds0 and t.stream_scans == 1
    idx.add_many(TH, _plist(rng, 100, base=10 ** 6))
    idx.flush()
    _rank_both(j, t, TH, JProf(), k=12)       # two spans: exact scan
    assert idx.merge_runs(max_runs=1)
    _rank_both(j, t, TH, JProf(), k=10)       # pruning re-armed
    assert t.prune_rounds > rounds0 and t.stream_scans == 2


def test_rank_term_multi_run_matches_jax():
    rng = np.random.default_rng(2)
    idx = JRWI()
    j, t = _stores(idx)
    for i in range(3):
        idx.add_many(TH, _plist(rng, 200, base=i * 150))  # overlapping ids
        idx.flush()
    for d in (5, 17, 250):
        idx.delete_doc(d)
    got = _rank_both(j, t, TH, JProf(), k=40)
    assert got[2] == 600 and t.stream_scans == 1
    _rank_both(j, t, TH, JProf(), k=1000)


def test_rank_term_budget_skip_and_spans_over_max_match_jax():
    rng = np.random.default_rng(7)
    idx = JRWI()
    j, t = _stores(idx, budget_bytes=100_000)
    idx.add_many(TH, _plist(rng, 10_000))
    idx.flush()
    _rank_both(j, t, TH, JProf(), k=10)
    idx2 = JRWI()
    j2, t2 = _stores(idx2)
    for i in range(10):
        idx2.add_many(TH, _plist(rng, 100, base=i * 100))
        idx2.flush()
    _rank_both(j2, t2, TH, JProf(), k=20)     # 10 spans > MAX_SPANS
    assert idx2.merge_runs(max_runs=2)
    _rank_both(j2, t2, TH, JProf(), k=20)
    assert t.fallbacks == 1 and t2.fallbacks == 1


def test_rank_term_high_docids_match_jax():
    rng = np.random.default_rng(10)
    n = 70_000  # > the 65536 initial bitmap capacity
    idx = JRWI()
    idx.add_many(TH, _plist(rng, n))
    idx.flush()
    j, t = _stores(idx)
    idx.delete_doc(65_535)
    got = _rank_both(j, t, TH, JProf(), k=n)
    assert 65_535 not in set(got[1].tolist()) and len(got[1]) == n - 1


def test_rank_term_after_ingest_and_term_removal_matches_jax():
    """An ingested run (two spans: the exact scan), then the term taken
    out of every run (on_term_dropped: an empty answer)."""
    rng = np.random.default_rng(12)
    idx = JRWI()
    idx.add_many(TH, _plist(rng, TILE + 40))
    idx.add_many(b"otherAAAAAAA", _plist(rng, 300))
    idx.flush()
    j, t = _stores(idx)
    idx.ingest_run({TH: _plist(rng, 2_000, base=10 ** 6)})
    _rank_both(j, t, TH, JProf(), k=20)
    assert t.stream_scans == 1
    idx.remove_term(TH)
    got = _rank_both(j, t, TH, JProf(), k=20)
    assert got[2] == 0 and len(got[1]) == 0
    _rank_both(j, t, b"otherAAAAAAA", JProf(), k=20)


def test_rank_term_declines_filters_and_delta():
    """What the JAX store declines, the port declines, and no more: a
    conjunction with a RAM delta (the caller's host join), a term no run
    holds (an empty answer). The facet bitmap and the RAM delta of a
    single term, declined before this slice, are served, equal to the
    JAX store's (tests/test_torch_devstore_delta.py holds the cases)."""
    rng = np.random.default_rng(5)
    idx = JRWI()
    idx.add_many(TH, _plist(rng, 400))
    idx.flush()
    j, t = _stores(idx)
    allow = np.full(64, 0xFFFFFFFF, np.uint32)
    jallow = j.filter_bitmap((("site", "x"), 0, 2048), lambda: np.arange(
        0, 2048, 2))
    tallow = t.filter_bitmap((("site", "x"), 0, 2048), lambda: np.arange(
        0, 2048, 2))
    _same_answer(t.rank_term(TH, JProf(), allow_bitmap=tallow),
                 _jax_rank(j, TH, JProf(), allow_bitmap=jallow))
    _same_answer(t.rank_term(TH, JProf(), allow_bitmap=convert
                             .bitmap_from_numpy(allow, "cpu")),
                 _jax_rank(j, TH, JProf(), allow_bitmap=allow))
    idx.add_many(TH, _plist(rng, 7, base=5_000))
    _rank_both(j, t, TH, JProf(), lang_filter=0x6465)
    _rank_both(j, t, TH, JProf())
    assert t.fallbacks == 0 and t.queries_served == 4
    assert t.rank_join([TH], [], JProf()) is None
    assert t.rank_term(b"missingAAAAA", JProf())[2] == 0


# ---------------------------------------------------------------------------
# constraint filters (the exact scan with the filter in K6 and K7) and the
# filtered-stats cache, against the JAX store
# ---------------------------------------------------------------------------

DE, EN = JP.pack_language("de"), JP.pack_language("en")
FILTERS = {
    "language": dict(lang_filter=DE),
    "flag": dict(flag_bit=3),
    "flag_sign": dict(flag_bit=40),
    "from_days": dict(from_days=150),
    "date_range": dict(from_days=150, to_days=200),
    "all_four": dict(lang_filter=DE, flag_bit=5, from_days=120,
                     to_days=260),
}


def _filter_corpus(idx, rng, n=400):
    p = _plist(rng, n)
    p.feats[:n // 2, JP.F_LANGUAGE] = DE
    p.feats[:, JP.F_LASTMOD] = rng.integers(100, 300, n)
    p.feats[::7, JP.F_FLAGS] |= -(2 ** 31)     # sign bit set
    idx.add_many(TH, p)
    idx.flush()
    return p


@pytest.mark.parametrize("name", list(FILTERS))
def test_constraint_filters_match_jax(name):
    """tests/test_devstore.py::test_constraint_filters_in_kernel's checks,
    each filter alone and all four together, on one span and after a
    tombstone and a second run (two spans): the JAX store's answer and
    counters, and only rows that pass the filter."""
    rng = np.random.default_rng(5)
    idx = JRWI()
    j, t = _stores(idx)
    p = _filter_corpus(idx, rng)
    kw = FILTERS[name]
    got = _rank_both(j, t, TH, JProf(), k=400, **kw)
    fl = p.feats[:, JP.F_FLAGS].astype(np.int64)
    lastmod = p.feats[:, JP.F_LASTMOD]
    ok = np.ones(len(p), bool)
    if "lang_filter" in kw:
        ok &= p.feats[:, JP.F_LANGUAGE] == kw["lang_filter"]
    if "flag_bit" in kw:
        ok &= ((fl >> min(kw["flag_bit"], 31)) & 1) == 1
    ok &= lastmod >= kw.get("from_days", -(2 ** 30))
    ok &= lastmod <= kw.get("to_days", 2 ** 30)
    assert set(got[1].tolist()) == set(p.docids[ok].tolist())
    assert t.stream_scans == 1 and t.prune_rounds == 0
    idx.delete_doc(int(got[1][0]))
    _rank_both(j, t, TH, JProf(**NONDEFAULT), k=50, **kw)
    idx.add_many(TH, _plist(rng, 300, base=10_000))
    idx.flush()
    _rank_both(j, t, TH, JProf(), k=60, language="de", **kw)
    assert t.stream_scans == 3


def test_constraint_filter_of_no_row_matches_jax():
    """A filter no row passes: an empty answer, as the JAX store's."""
    rng = np.random.default_rng(6)
    idx = JRWI()
    j, t = _stores(idx)
    _filter_corpus(idx, rng)
    got = _rank_both(j, t, TH, JProf(), k=10, from_days=500)
    assert len(got[1]) == 0 and got[2] == 400


def _count_k6(monkeypatch):
    calls = []
    real = KD.span_stats

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(KD, "span_stats", counted)
    return calls


def test_filtered_stats_cache_hit_matches_jax(monkeypatch):
    """tests/test_devstore.py::test_filtered_stats_cache_hit_is_bit_identical
    against the JAX store: a repeat of a filtered query skips K6 and gives
    the cold answer; a tombstone makes the entry stale."""
    rng = np.random.default_rng(9)
    idx = JRWI()
    p = _plist(rng, 3000)
    p.feats[:1500, JP.F_LANGUAGE] = DE
    idx.add_many(TH, p)
    idx.flush()
    j, t = _stores(idx)
    k6 = _count_k6(monkeypatch)
    cold = _rank_both(j, t, TH, JProf(), k=50, lang_filter=DE)
    assert t._span_stats_cache and len(k6) == 1
    hot = _rank_both(j, t, TH, JProf(), k=50, lang_filter=DE)
    assert len(k6) == 1, "the repeat must skip K6"
    np.testing.assert_array_equal(hot[0], cold[0])
    np.testing.assert_array_equal(hot[1], cold[1])
    victim = int(cold[1][0])
    idx.delete_doc(victim)
    after = _rank_both(j, t, TH, JProf(), k=50, lang_filter=DE)
    assert victim not in after[1].tolist() and len(k6) == 2
    # another filter is another entry; the first one stays
    _rank_both(j, t, TH, JProf(), k=50, lang_filter=EN)
    _rank_both(j, t, TH, JProf(), k=50, lang_filter=DE)
    assert len(k6) == 3


def test_filtered_stats_cache_under_threads():
    """16 threads run two filtered queries at once on one store, with a
    short switch interval: every answer equals the solo one, and the
    cache holds one entry a filter."""
    import sys
    import threading
    rng = np.random.default_rng(15)
    idx = JRWI()
    p = _plist(rng, 3_000)
    p.feats[:1500, JP.F_LANGUAGE] = DE
    idx.add_many(TH, p)
    idx.flush()
    t = TD.DeviceSegmentStore(idx, device="cpu")
    kws = [dict(lang_filter=DE), dict(from_days=100, to_days=800)]
    solo = [t.rank_term(TH, JProf(), k=40, **kw) for kw in kws]
    t._span_stats_cache.clear()
    out, errors = [], []

    def worker(i):
        try:
            for q in range(4):
                kw = kws[(i + q) % 2]
                out.append(((i + q) % 2, t.rank_term(TH, JProf(), k=40,
                                                     **kw)))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ts) and not errors
    assert len(out) == 64 and len(t._span_stats_cache) == 2
    for which, got in out:
        np.testing.assert_array_equal(got[0], solo[which][0])
        np.testing.assert_array_equal(got[1], solo[which][1])
    assert t.queries_served == 66 and t.stream_scans == 66


@pytest.mark.parametrize("change", ["flush_same_term", "flush_other_term",
                                    "delete", "merge"])
def test_filtered_stats_cache_stale_after_in_place_change(monkeypatch,
                                                          change):
    """The arena appends and tombstones in place, so the cache must not
    trust the tensors' identity: between two equal filtered queries a
    flush (rows of this term, or of another term written past the used
    mark of the same tensors), a tombstone or a merge; each answer equal
    to the JAX store's, K6 run again."""
    rng = np.random.default_rng(14)
    idx = JRWI()
    idx.add_many(TH, _plist(rng, 2_000))
    idx.add_many(b"otherAAAAAAA", _plist(rng, 500))
    idx.flush()
    j, t = _stores(idx)
    kw = dict(from_days=200, to_days=700)
    k6 = _count_k6(monkeypatch)
    first = _rank_both(j, t, TH, JProf(), k=30, **kw)
    feats_before = t.arena.arrays()[0]
    if change == "flush_same_term":
        idx.add_many(TH, _plist(rng, 900, base=50_000))
        idx.flush()
    elif change == "flush_other_term":
        idx.add_many(b"otherAAAAAAA", _plist(rng, 900, base=50_000))
        idx.flush()
    elif change == "delete":
        idx.delete_doc(int(first[1][0]))
    else:
        idx.add_many(TH, _plist(rng, 900, base=50_000))
        idx.flush()
        assert idx.merge_runs(max_runs=1)
    if change.startswith("flush"):
        assert t.arena.arrays()[0] is feats_before, "appended in place"
    _rank_both(j, t, TH, JProf(), k=30, **kw)
    assert len(k6) == 2
    _rank_both(j, t, TH, JProf(), k=30, **kw)
    assert len(k6) == 2


# ---------------------------------------------------------------------------
# end to end: SearchEvent, and the port's RWIIndex
# ---------------------------------------------------------------------------

def _gondola_segment():
    from yacy_search_server_tpu.document.document import Document
    from yacy_search_server_tpu.index.segment import Segment
    seg = Segment(max_ram_postings=50)
    rng = np.random.default_rng(8)
    for i in range(60):
        seg.store_document(Document(
            url=f"http://h{i % 7}.example/p{i}.html",
            title=f"gondola {i}",
            text=f"gondola lift station {i} " * (1 + int(rng.integers(1, 5)))))
    seg.rwi.flush()
    while seg.rwi.merge_runs(max_runs=2):
        pass
    return seg


def test_searchevent_page_with_port_store_matches_jax_store(monkeypatch):
    from yacy_search_server_tpu.ops import ranking
    from yacy_search_server_tpu.search.query import QueryParams
    from yacy_search_server_tpu.search.searchevent import SearchEvent
    monkeypatch.setattr(ranking, "SMALL_RANK_N", 0)

    def page(seg, qs="gondola", n=10):
        ev = SearchEvent(QueryParams.parse(qs, item_count=n), seg)
        return [(r.docid, r.score) for r in ev.results()]

    jseg, tseg = _gondola_segment(), _gondola_segment()
    jseg.enable_device_serving()
    tseg.devstore = TD.DeviceSegmentStore(tseg.rwi, device="cpu")
    want = page(jseg)
    assert page(tseg) == want and len(want) == 10
    assert tseg.devstore.queries_served >= 1
    # conjunctions go to the host join
    assert len(page(tseg, "gondola lift", 5)) == 5


def _feed(idx, rng):
    for i in range(3):
        for t in range(4):
            idx.add_many(b"t%011d" % t,
                         _plist(rng, 50 + 30 * t, base=40 * i + t, step=2))
        idx.flush()
    idx.delete_doc(44)
    idx.ingest_run({b"t%011d" % 2: _plist(rng, 30, base=3, step=3),
                    b"t%011d" % 4: _plist(rng, 0)})
    idx.add_many(b"t%011d" % 1, _plist(rng, 9, base=44))  # RAM, unflushed
    idx.add_many(b"t%011d" % 3, _plist(rng, 5, base=60))
    idx.delete_doc(46)


def test_port_rwi_matches_jax_rwi():
    """Same adds (overlapping docids), flushes, an ingested run, deletes,
    a term removal, a merge and RAM rows: the same postings and count
    bounds."""
    j, t = JRWI(), TRWI()
    for idx in (j, t):
        _feed(idx, np.random.default_rng(40))
    a, b = j.remove_term(b"t%011d" % 3), t.remove_term(b"t%011d" % 3)
    np.testing.assert_array_equal(b.docids, a.docids)
    np.testing.assert_array_equal(b.feats, a.feats)
    assert len(a) > 0
    assert [r.n_postings for r in t._runs] == [r.n_postings for r in j._runs]
    for step in range(2):
        for th in [b"t%011d" % i for i in range(5)]:
            a, b = j.get(th), t.get(th)
            np.testing.assert_array_equal(b.docids, a.docids)
            np.testing.assert_array_equal(b.feats, a.feats)
            assert t.count_upper(th) == j.count_upper(th)
            ra, rb = j._ram_postings(th), t._ram_postings(th)
            assert (ra is None) == (rb is None)
            if ra is not None:
                np.testing.assert_array_equal(rb.docids, ra.docids)
        assert [r.dead_seq for r in t._runs] == [r.dead_seq for r in j._runs]
        if step == 0:
            assert j.merge_runs(max_runs=1) and t.merge_runs(max_runs=1)


def test_port_store_on_port_rwi_matches_jax():
    """The whole port (its RWIIndex and store) against the JAX pair fed
    the same postings."""
    j_idx, t_idx = JRWI(), TRWI()
    for idx in (j_idx, t_idx):
        rng = np.random.default_rng(41)
        idx.add_many(TH, _tied(_plist(rng, TILE + 300, step=3)))
        idx.add_many(b"otherAAAAAAA", _plist(rng, 3_000))
        idx.flush()
    j = JD.DeviceSegmentStore(j_idx)
    t = TD.DeviceSegmentStore(t_idx, device="cpu")
    for k in (10, 100):
        _rank_both(j, t, TH, JProf(), k=k)
    for idx in (j_idx, t_idx):
        idx.delete_doc(9)
    _rank_both(j, t, TH, JProf(), k=10)
    assert t.prune_rounds == 2 and t.stream_scans == 1
