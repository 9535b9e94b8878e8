"""The port's batched conjunctions against the JAX package's, on the CPU.

`join_batch_query` (the plain versions of the batched K8 and kernels 1-2,
kernel 3 a slot and the batched finish) on a JAX store's own arena and
join tables (convert.py) against `_rank_join_batch_packed_kernel` /
`_rank_join_bm_batch_packed_kernel` fed the identical `qargs_batch`, at
bs 1, 3, 4 and 16, on tests/test_devjoin.py's corpora (every membership
sort-mode, every one a bitmap, and mixed), with tombstones, includes with
an exclude and two partners, every filter, a slot of fewer rows than kk
and a slot of none, and two slots over one rare span holding docids at
and above 2^29 (the sort-mode clip rule) under different filters. Then
`rank_join` from 16 threads through the port's batcher against the JAX
store with its batcher on, deletes landing during batched join waves, and
a two-word SearchEvent page with batching on in both stores. No
tolerance: scores and docids equal to the bit after the keep mask.
"""

import sys
import threading

import numpy as np
import pytest

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
LO, HI = JD.DAYS_NONE_LO, JD.DAYS_NONE_HI
FILTERS = [(0, -1, LO, HI), (DE, -1, LO, HI), (0, 4, LO, HI),
           (0, -1, 19_000, 20_000), (DE, 2, 18_500, 20_500)]
JOIN_COUNTERS = ("join_served", "join_fallbacks", "join_degraded_plain")


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


def _wave_both(j, slots, n_inc, kk, prof=None):
    """One wave of `slots` ((start, count, filter, JAX spans of the
    partners then the excludes)) through the JAX batch kernel (the
    reference's qargs_batch, statics as rank_join derives them) and
    through join_batch_query on the JAX arena's bytes; each slot's kept
    scores and docids must be equal, and equal to the solo join_query's.
    Returns the kept docids of each slot."""
    f, fl, d = (np.asarray(a) for a in j.arena.arrays())
    jd, jp = (np.asarray(a) for a in j.arena.join_arrays())
    bm = np.asarray(j.arena.bitmap_array())
    dead = np.asarray(j.arena.dead_array())
    nslots = bm.shape[0]
    qb = np.asarray([[s, c, *filt]
                     + [sp.jstart for sp in parts[:n_inc]]
                     + [sp.count for sp in parts[:n_inc]]
                     + [sp.jslot for sp in parts[:n_inc]]
                     + [sp.jstart for sp in parts[n_inc:]]
                     + [sp.count for sp in parts[n_inc:]]
                     + [sp.jslot for sp in parts[n_inc:]]
                     for s, c, filt, parts in slots], np.int32)
    first = slots[0][3]
    modes = [0 <= sp.jslot < nslots for sp in first]
    for _s, _c, _f, parts in slots:      # one statics family a wave
        assert [0 <= sp.jslot < nslots for sp in parts] == modes
    n_exc = len(first) - n_inc
    inc_bm, exc_bm = tuple(modes[:n_inc]), tuple(modes[n_inc:])
    r = JD._bucket_rows_join(int(max(qb[:, 1].max(), 1)))
    assert (qb[:, 0] + r <= f.shape[0]).all()

    def window(p):
        if modes[p]:
            return 0
        m = max(JD._bucket_rows(int(parts[p].count))
                for _s, _c, _f, parts in slots)
        assert all(parts[p].jstart + m <= jd.shape[0]
                   for _s, _c, _f, parts in slots)
        return m
    ms = tuple(window(p) for p in range(len(first)))
    prof = prof or JProf()
    consts = j._profile_consts(prof, "en")
    kw = dict(k=kk, n_inc=n_inc, n_exc=n_exc, r=r, inc_ms=ms[:n_inc],
              exc_ms=ms[n_inc:])
    if any(modes):
        want = np.asarray(JD._rank_join_bm_batch_packed_kernel(
            f, fl, d, dead, jd, jp, bm, qb, *consts, inc_bm=inc_bm,
            exc_bm=exc_bm, **kw))
    else:
        want = np.asarray(JD._rank_join_batch_packed_kernel(
            f, fl, d, dead, jd, jp, qb, *consts, **kw))
    arrays = convert.arena_from_numpy(f, fl, d, dead,
                                      np.asarray(j.arena._pmax), "cpu")
    join = convert.join_from_numpy(jd, jp, bm, "cpu")
    tc = TR.profile_consts(convert.profile_from_jax(
        prof.to_external_string()), JP.pack_language("en"), "cpu")
    desc = convert.join_wave_from_numpy(qb, n_inc, inc_bm, exc_bm)
    got = TD.join_batch_query(arrays, join, desc, n_inc, tc, kk).numpy()
    assert got.shape == (len(slots), 2 * kk)
    half = want.shape[1] // 2
    kept = []
    for i, (start, count, filt, _p) in enumerate(KD.join_wave_slots(
            desc, n_inc)):
        ws, wd = want[i, :half], want[i, half:]
        gs, gd = got[i, :kk], got[i, kk:]
        wk = (wd >= 0) & (ws > TD.NEG_INF32)
        gk = (gd >= 0) & (gs > TD.NEG_INF32)
        np.testing.assert_array_equal(gs[gk], ws[wk])
        np.testing.assert_array_equal(gd[gk], wd[wk])
        if count:
            parts = KD.join_wave_slots(desc, n_inc)[i][3]
            solo = TD.join_query(arrays, join, start, count, parts, n_inc,
                                 tc, kk, filt).numpy()
            n = min(kk, count)
            sk = (solo[n:2 * n] >= 0) & (solo[:n] > TD.NEG_INF32)
            np.testing.assert_array_equal(gd[gk], solo[n:2 * n][sk])
        kept.append(gd[gk])
    return kept


SHAPES = {"partner_and_exclude": ([(C, (B,), (A,)), (B, (C,), (A,))], 1),
          "two_partners": ([(C, (B, A), ()), (B, (C, A), ())], 2)}


@pytest.mark.parametrize("bs", [1, 3, 4, 16])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_wave_plain_matches_jax_batch_kernel(monkeypatch, corpus, shape, bs):
    """Slots cycle over the shape's two rare/partner orders and the five
    filters; slot 2 streams ten rows of its rare span (fewer than kk),
    slot 3 none; tombstones on every 97th docid."""
    idx, j, _t = _pair(monkeypatch, corpus)
    for d in range(0, 60_000, 97):
        idx.delete_doc(d)
    orders, n_inc = SHAPES[shape]
    sp = {th: j.spans_for(th)[0] for th in (A, B, C)}
    slots = []
    for i in range(bs):
        rare, inc, exc = orders[i % 2]
        start, count = sp[rare].start, sp[rare].count
        if i == 2:
            count = 10
        elif i == 3:
            start, count = 0, 0
        slots.append((start, count, FILTERS[i % len(FILTERS)],
                      [sp[th] for th in inc + exc]))
    kept = _wave_both(j, slots, n_inc, 64)
    assert len(kept[0]) > 0
    if bs >= 4:
        assert len(kept[3]) == 0 and len(kept[2]) <= 10


HIGH = (2**29, 2**29 + 5, 2**29 + 77)   # rare docids the clip makes equal


@pytest.mark.parametrize("mode", ["include", "exclude"])
def test_wave_clip_rows_in_two_slots_matches_jax(monkeypatch, mode):
    """A rare span holding three docids at or above 2^29 (one
    tombstoned) against a sort-mode partner holding 2^29, in two slots
    of one wave under different filters, beside a slot of no row: each
    slot's clip rule decided on its own valid rows, as the reference's
    co-sort does a slot."""
    for cls in (JD.DeviceSegmentStore, TD.DeviceSegmentStore):
        monkeypatch.setattr(cls, "JOIN_BITMAP_MIN", 1 << 30)
    rng = np.random.default_rng(23)
    idx = JRWI()
    j = JD.DeviceSegmentStore(idx)
    pool = np.arange(5_000)
    rare, big = _plist(rng, 300, pool), _plist(rng, 2_000, pool)
    rare.docids[-3:] = HIGH
    rare.feats[-3:, JP.F_LANGUAGE] = (DE, JP.pack_language("en"), DE)
    big.docids[-1] = 2**29
    idx.ingest_run({A: rare, B: big})
    idx.delete_doc(2**29 + 5)
    sa, sb = j.spans_for(A)[0], j.spans_for(B)[0]
    slots = [(sa.start, sa.count, FILTERS[0], [sb]),
             (sa.start, sa.count, FILTERS[1], [sb]),
             (0, 0, FILTERS[0], [sb]),
             (sa.start, sa.count, FILTERS[3], [sb])]
    kept = _wave_both(j, slots, 1 if mode == "include" else 0, 512)
    high = [sorted(x for x in k.tolist() if x >= 2**29) for k in kept]
    # of the two valid clipped rows the last in row order alone matches
    # the partner's 2^29: one row joins, or one stays after the exclude
    assert len(high[0]) == 1 and high[2] == []


def _hammer(fn, jobs, threads=16):
    """Run fn(job) for every job from `threads` threads at once, with a
    short switch interval; returns [(job, answer)]."""
    out, errors = [], []
    lock = threading.Lock()
    start = threading.Barrier(threads)

    def worker(mine):
        try:
            start.wait()
            for job in mine:
                got = fn(job)
                with lock:
                    out.append((job, got))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=worker, args=(jobs[i::threads],))
              for i in range(threads)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert not any(th.is_alive() for th in ts)
    return out


def _same(got, want):
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def _wave_slots(monkeypatch):
    """The live slots of every join_member_batch call."""
    seen = []
    real = KD.join_member_batch

    def counted(*a, **kw):
        seen.append(int((np.asarray(a[7])[:, 1] > 0).sum()))
        return real(*a, **kw)
    monkeypatch.setattr(KD, "join_member_batch", counted)
    return seen


NOWHERE = word2hash("nowhere")
JOBS = [([A, B], [], {}), ([B, A, C], [], {}), ([A, B], [C], {}),
        ([C, B], [A], dict(lang_filter=DE)),
        ([A, B], [], dict(from_days=19_000, to_days=20_000)),
        ([A], [NOWHERE], {})]


def _ask(s, job, k):
    inc, exc, kw = JOBS[job]
    return s.rank_join(inc, exc, JProf(), "en", k=k, **kw)


def test_batched_rank_join_from_16_threads_matches_jax(monkeypatch):
    """16 threads of conjunctions (five join shapes of both modes, a
    degraded one, k 10 and 100) through the port's batcher and through
    the JAX store's with its batcher on: the same answers, the same join
    counters, and port waves of more than one live slot."""
    _idx, j, t = _pair(monkeypatch, "seg_mixed")
    slots = _wave_slots(monkeypatch)
    j.enable_batching(max_batch=16, dispatchers=2, prewarm=False)
    t.enable_batching(max_batch=16, dispatchers=2)
    j._topk_cache.enabled = t._topk_cache.enabled = False
    try:
        jobs = [(q, k) for q in range(len(JOBS)) for k in (10, 100)] * 4
        want = dict(_hammer(lambda job: _ask(j, *job), jobs))
        got = _hammer(lambda job: _ask(t, *job), jobs)
        for job, ans in got:
            _same(ans, want[job])
        assert [getattr(t, c) for c in JOIN_COUNTERS] == \
            [getattr(j, c) for c in JOIN_COUNTERS]
        assert t.join_served == 40 and t.join_degraded_plain == 8
        c = t.counters()
        assert max(slots) > 1 and c["batch_timeouts"] == 0
        assert c["batch_exceptions"] == 0 and c["transfer_failures"] == 0
    finally:
        j.close()
        t.close()


def test_deletes_during_batched_join_waves_match_jax(monkeypatch):
    """Deletes of joined docids landing while 16 threads send
    conjunctions through the port's batcher: afterwards every answer from
    16 threads equals the JAX store's solo answer and the port's
    tombstone bitmap holds every deleted docid and no other."""
    idx, j, t = _pair(monkeypatch, "seg3")
    t.enable_batching(max_batch=16, dispatchers=4)
    try:
        jobs = [(q, k) for q in range(5) for k in (10, 100)]
        gone = sorted({int(x) for job in jobs
                       for x in _ask(t, *job)[1][:6]})
        done = threading.Event()

        def deleter():
            for x in gone:
                idx.delete_doc(x)
            done.set()
        th = threading.Thread(target=deleter)
        th.start()
        _hammer(lambda job: _ask(t, *job), jobs * 3)
        th.join(timeout=60)
        assert done.is_set()
        want = {job: (j._topk_cache._d.clear(), _ask(j, *job))[1]
                for job in jobs}
        for job, ans in _hammer(lambda job: _ask(t, *job), jobs * 2):
            _same(ans, want[job])
            assert not set(gone) & set(ans[1].tolist())
        dead = t.arena.dead_array().numpy()
        assert sorted(np.flatnonzero(dead).tolist()) == gone
        c = t.counters()
        assert c["batch_timeouts"] == 0 and c["batch_exceptions"] == 0
    finally:
        t.close()


def test_searchevent_two_word_page_with_batching_matches_jax_store(
        monkeypatch):
    """SearchEvent's pages for two-word queries (a conjunction, one with
    an exclude) with the batcher on in both stores: the port store's
    page equals the JAX store's, served by the port's batched
    rank_join."""
    from yacy_search_server_tpu.document.document import Document
    from yacy_search_server_tpu.index.segment import Segment
    from yacy_search_server_tpu.ops import ranking
    from yacy_search_server_tpu.search.query import QueryParams
    from yacy_search_server_tpu.search.searchevent import SearchEvent
    monkeypatch.setattr(ranking, "SMALL_RANK_N", 0)
    slots = _wave_slots(monkeypatch)

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
    jseg.devstore.enable_batching(max_batch=8, dispatchers=2, prewarm=False)
    tseg.devstore = TD.DeviceSegmentStore(tseg.rwi, device="cpu")
    tseg.devstore.enable_batching(max_batch=8, dispatchers=2)
    try:
        for qs in ("gondola lift", "gondola -lift", "gondola lift"):
            want = page(jseg, qs)
            assert page(tseg, qs) == want and want
        assert tseg.devstore.join_served == jseg.devstore.join_served >= 2
        assert slots and tseg.devstore.counters()["batch_dispatches"] > 0
    finally:
        tseg.devstore.close()
        jseg.devstore.close()
