"""The port's query batcher (index/batcher.py) against the JAX store's
solo answers, on the CPU.

One RWI feeds a JAX store and a port store (`device="cpu"`) through
`kernels/bench.Fanout`; the port store has `enable_batching` on. Pruned
queries from 16 threads (mixed profiles, languages and k) ride K5 waves;
with `scan_batching`, filtered scans from 16 threads ride the batched
K6/K7 pair. Every answer must equal the JAX store's solo answer; the
plain batched scan must equal `_rank_scan_batch_packed_kernel` on the
same inputs. Also: a wave whose bound fails escalating solo, an
ineligible term in a wave, the watchdog's withdrawal, a failing launch
raised in its submitter, `set_tuning`, and a SearchEvent page for a
`site:` query with batching on.
"""

import sys
import threading

import numpy as np
import pytest

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
DE = JP.pack_language("de")
ESCALATING = dict(worddistance=2, appemph=15, urllength=12, tf=3)
TERMS = [b"bterm%07d" % i for i in range(4)]


def _plist(rng, n, base=0, step=1):
    docids = (base + step * np.arange(n)).astype(np.int32)
    feats = rng.integers(0, 1000, (n, JP.NF)).astype(np.int32)
    feats[:, JP.F_FLAGS] = rng.integers(0, 2 ** 20, n)
    feats[:, JP.F_DOMLENGTH] = rng.integers(0, 256, n)
    feats[:, JP.F_LANGUAGE] = JP.pack_language("en")
    feats[::3, JP.F_LANGUAGE] = DE
    feats[:, JP.F_LASTMOD] = rng.integers(100, 300, n)
    return JP.PostingsList(docids, feats)


@pytest.fixture
def served():
    """(rwi, JAX store, port store with the batcher on) over four terms
    of one run (one of 2 tiles), closed after the test."""
    rng = np.random.default_rng(80)
    idx = JRWI()
    for i, th in enumerate(TERMS):
        idx.add_many(th, _plist(rng, (2 * TILE + 99, 5_000, 900, 40)[i],
                                base=i, step=4))
    idx.flush()
    j = JD.DeviceSegmentStore(idx)
    t = TD.DeviceSegmentStore(idx, device="cpu")
    idx.listener = KB.Fanout(j, t)
    yield idx, j, t
    t.close()


def _solo(j, th, prof, k, **kw):
    j._topk_cache._d.clear()
    return j.rank_term(th, prof, k=k, **kw)


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


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


def _count_slots(monkeypatch, name):
    """The slots of every call of KD.<name> (a descriptor's slots)."""
    seen = []
    real = getattr(KD, name)

    def counted(*a, **kw):
        for x in a:
            if isinstance(x, np.ndarray) and x.dtype == np.int32:
                seen.append(KD.desc_slots(x) if name == "pruned_tile"
                            else x.shape[0])
                break
        return real(*a, **kw)
    monkeypatch.setattr(KD, name, counted)
    return seen


PROFILES = {"default": JProf(), "light": JProf(domlength=12, tf=5)}


def test_batched_pruned_from_16_threads_matches_jax(served, monkeypatch):
    """16 threads of pruned queries over the terms, two profiles, two
    languages and k of 10, 100 and 1000: every answer the JAX store's
    solo answer; waves of more than one slot; no timeout, no exception."""
    idx, j, t = served
    slots = _count_slots(monkeypatch, "pruned_tile")
    t.enable_batching(max_batch=16, dispatchers=2)
    # the plain waves of a loaded CPU outlast the 1 s watchdog: a window
    # they cannot reach, so that a timeout still means a lost wave
    monkeypatch.setattr(t._batcher, "WATCHDOG_S", 60.0)
    jobs = [(th, pname, lang, k) for th in TERMS[:3]
            for pname in PROFILES for lang in ("en", "de")
            for k in (10, 100, 1000)]
    want = {job: _solo(j, job[0], PROFILES[job[1]], job[3],
                       language=job[2]) for job in jobs}
    got = _hammer(lambda job: t.rank_term(job[0], PROFILES[job[1]],
                                          language=job[2], k=job[3]),
                  jobs * 2)
    for job, ans in got:
        _same(ans, want[job])
    c = t.counters()
    assert c["batch_dispatches"] > 0 and max(slots) > 1
    assert c["batch_timeouts"] == 0 and c["batch_exceptions"] == 0
    assert c["queries_served"] == len(got)


def test_wave_with_fewer_queries_than_slots_matches_jax(served):
    """Three concurrent queries in a batcher of 16 slots (the JAX
    batcher pads its wave to 16; the port's launch takes 3): the JAX
    store's batched answers."""
    idx, j, t = served
    j.enable_batching(max_batch=16, dispatchers=1, prewarm=False)
    t.enable_batching(max_batch=16, dispatchers=1)
    jobs = [(TERMS[i], 100) for i in range(3)]
    want = dict(_hammer(lambda job: (j._topk_cache._d.clear(),
                                     j.rank_term(job[0], JProf(),
                                                 k=job[1]))[1], jobs, 3))
    for job, ans in _hammer(lambda job: t.rank_term(job[0], JProf(),
                                                    k=job[1]), jobs, 3):
        _same(ans, want[job])
    j.close()


def test_prune_fail_wave_escalates_solo_like_jax(served, monkeypatch):
    """The escalating profile's bound fails at b = 1 in the wave: the
    query escalates solo from _PRUNE_B[1], as the JAX store's does, with
    the JAX store's answer and one solo round fewer than without the
    batcher."""
    idx, j, t = served
    j.enable_batching(max_batch=4, dispatchers=1, prewarm=False)
    t.enable_batching(max_batch=4, dispatchers=1)
    # a wave of a loaded CPU (the JAX store's first one compiles its
    # kernel) can outlast either store's 1 s watchdog, and a withdrawn
    # query escalates from _PRUNE_B[0], one round more: a window neither
    # reaches
    monkeypatch.setattr(t._batcher, "WATCHDOG_S", 60.0)
    monkeypatch.setattr(j._batcher, "WATCHDOG_S", 60.0)
    prof = JProf(**ESCALATING)
    for k in (10, 100):
        j._topk_cache._d.clear()
        want = j.rank_term(TERMS[0], prof, k=k)
        got = t.rank_term(TERMS[0], prof, k=k)
        _same(got, want)
    assert (t.prune_rounds, t.pruned_tiles) == (j.prune_rounds,
                                                j.pruned_tiles)
    assert t.counters()["batch_dispatches"] >= 2
    j.close()


def test_ineligible_terms_in_a_wave_go_solo_like_jax(served):
    """A term of two spans and a term with a RAM delta come back
    ineligible from the wave (counted in batch_ineligible) and are served
    solo: the JAX store's answers and counters."""
    idx, j, t = served
    rng = np.random.default_rng(81)
    idx.add_many(TERMS[1], _plist(rng, 300, base=100_000))
    idx.flush()                                    # TERMS[1]: two spans
    idx.add_many(TERMS[2], _plist(rng, 30, base=200_000))  # a RAM delta
    j.enable_batching(max_batch=16, dispatchers=1, prewarm=False)
    t.enable_batching(max_batch=16, dispatchers=1)
    for th in TERMS[1:3]:
        j._topk_cache._d.clear()
        _same(t.rank_term(th, JProf(), k=50), j.rank_term(th, JProf(), k=50))
    for key in ("batch_ineligible", "stream_scans", "queries_served"):
        assert t.counters()[key] == j.counters()[key], key
    assert t.counters()["batch_ineligible"] == 2
    j.close()


SCAN_FILTERS = [dict(lang_filter=DE), dict(flag_bit=3),
                dict(from_days=150, to_days=250), dict(flag_bit=40),
                dict(lang_filter=DE, flag_bit=5, from_days=120)]


def test_batched_scans_from_16_threads_match_jax(served, monkeypatch):
    """scan_batching: 16 threads of filtered scans (five filters, two
    terms of which one has two spans, k 10 and 100) ride the batched
    K6/K7 pair in waves; every answer the JAX store's solo answer."""
    idx, j, t = served
    rng = np.random.default_rng(82)
    idx.add_many(TERMS[1], _plist(rng, 700, base=300_000, step=3))
    idx.flush()
    slots = _count_slots(monkeypatch, "span_stats_batch")
    t.enable_batching(max_batch=16, dispatchers=2, scan_batching=True)
    monkeypatch.setattr(t._batcher, "WATCHDOG_S", 60.0)
    jobs = [(th, f, k) for th in TERMS[:2] for f in range(len(SCAN_FILTERS))
            for k in (10, 100)]
    want = {job: _solo(j, job[0], JProf(), job[2], **SCAN_FILTERS[job[1]])
            for job in jobs}
    got = _hammer(lambda job: t.rank_term(job[0], JProf(), k=job[2],
                                          **SCAN_FILTERS[job[1]]), jobs * 2)
    for job, ans in got:
        _same(ans, want[job])
    assert max(slots) > 1 and t.counters()["batch_timeouts"] == 0


def test_deletes_during_batched_waves_match_jax(served, monkeypatch):
    """Deletes landing while 16 threads send pruned queries and filtered
    scans through the batcher (each wave applies the pending tombstones
    it finds): afterwards every answer from 16 threads again equals the
    JAX store's solo answer, and the port's tombstone bitmap holds every
    deleted docid and no other."""
    idx, j, t = served
    t.enable_batching(max_batch=16, dispatchers=4, scan_batching=True)
    monkeypatch.setattr(t._batcher, "WATCHDOG_S", 60.0)
    jobs = ([(th, None, k) for th in TERMS for k in (10, 100)]
            + [(th, f, k) for th in TERMS[:2]
               for f in range(len(SCAN_FILTERS)) for k in (10, 100)])

    def ask(job):
        kw = SCAN_FILTERS[job[1]] if job[1] is not None else {}
        return t.rank_term(job[0], JProf(), k=job[2], **kw)
    # docids among the answers, so that each delete moves some of them
    gone = sorted({int(x) for job in jobs for x in ask(job)[1][:4]})
    done = threading.Event()

    def deleter():
        for x in gone:
            idx.delete_doc(x)
        done.set()
    th = threading.Thread(target=deleter)
    th.start()
    _hammer(ask, jobs * 3)
    th.join(timeout=60)
    assert done.is_set()
    for job, ans in _hammer(ask, jobs * 2):
        kw = SCAN_FILTERS[job[1]] if job[1] is not None else {}
        _same(ans, _solo(j, job[0], JProf(), job[2], **kw))
    dead = t.arena.dead_array().numpy()
    assert sorted(np.flatnonzero(dead).tolist()) == gone
    c = t.counters()
    assert c["batch_timeouts"] == 0 and c["batch_exceptions"] == 0


NO_F = (0, -1, KD.DAYS_NONE_LO, KD.DAYS_NONE_HI)
WAVE_F = [NO_F, (DE, -1, KD.DAYS_NONE_LO, KD.DAYS_NONE_HI),
          (0, 3, 120, KD.DAYS_NONE_HI), (0, 40, KD.DAYS_NONE_LO, 200),
          (DE, 5, 100, 280), NO_F, (0, -1, 500, KD.DAYS_NONE_HI)]
# the waves of test_batched_scan_plain_matches_jax_kernel: (slot spans,
# filter) by name over the arena's spans sp0 (three runs of TERMS[0]),
# sp1 (three of TERMS[1]) and tie (TERMS[2]'s block of equal rows)
SCAN_CASES = {
    # 1 to 8 extents a slot, each its own filter, a slot of no row
    "base": lambda sp0, sp1, tie: list(zip(
        [sp0, sp1, sp0[:1], sp1[1:], sp0 + sp1, [], sp0], WAVE_F)),
    # one span list under six different filters, another under two
    "shared": lambda sp0, sp1, tie: [(sp0, WAVE_F[i]) for i in
                                     (0, 1, 2, 3, 4, 6)]
    + [(sp1, WAVE_F[0]), (sp1, WAVE_F[1])],
    # two pairs of identical slots (extents and filter)
    "identical": lambda sp0, sp1, tie: [
        (sp0, WAVE_F[1]), (sp0, WAVE_F[1]), (sp1, WAVE_F[2]),
        (sp0 + sp1, WAVE_F[3]), (sp0 + sp1, WAVE_F[3])],
    # a filter that no row passes (lastmods lie in [100, 300))
    "rejects_all": lambda sp0, sp1, tie: [
        (sp0, WAVE_F[0]), (sp0, (0, -1, 10_000, KD.DAYS_NONE_HI)),
        (sp1, WAVE_F[1])],
    # a slot of 7 live rows and one of about 80 (kk 16 and 128 above them)
    "few_rows": lambda sp0, sp1, tie: [
        (sp0[2:], WAVE_F[0]), (sp1[:1], WAVE_F[1]), (sp0, WAVE_F[2])],
    # the best rows all equal, a block of them across the plain step's
    # chunk (KD._PLAIN_ROWS set inside it)
    "ties": lambda sp0, sp1, tie: [
        (tie, WAVE_F[0]), (tie, WAVE_F[2]), (sp0, WAVE_F[0])],
}


@pytest.mark.parametrize("kk,case", [
    pytest.param(k, c, id=str(k) if c == "base" else f"{c}-{k}")
    for c in SCAN_CASES for k in (16, 128)] + [
    # past KD.FUSED_KK (the k = 3000 waves): sp0 holds more than 4096
    # live rows, sp1 and the tie block fewer
    pytest.param(4096, "base", id="4096"),
    pytest.param(4096, "ties", id="ties-4096")])
def test_batched_scan_plain_matches_jax_kernel(kk, case, monkeypatch):
    """scan_batch_query's plain route (the batched K6, then the batched
    K7 with its selection) over a wave of SCAN_CASES[case] against
    _rank_scan_batch_packed_kernel on the JAX arena's bytes, and each
    slot against the solo scan's first 2kk entries."""
    rng = np.random.default_rng(83)
    idx = JRWI()
    for r in range(3):
        idx.add_many(TERMS[0], _plist(rng, (TILE + 40, 600, 7)[r],
                                      base=r, step=3))
        idx.add_many(TERMS[1], _plist(rng, 250, base=9 + r))
        idx.flush()
    if case == "ties":
        pl = _plist(rng, 3_000, base=11, step=5)
        best = int(np.argmax(TR.cardinal_scores_host(
            pl.feats, TR.RankingProfile())))
        pl.feats[:900] = pl.feats[best]
        idx.add_many(TERMS[2], pl)
        idx.flush()
    j = JD.DeviceSegmentStore(idx)
    idx.delete_doc(3)
    sp0, sp1 = j.spans_for(TERMS[0]), j.spans_for(TERMS[1])
    tie = j.spans_for(TERMS[2]) if case == "ties" else []
    if case == "ties":
        # the equal rows are the span's first 900 (the best proxy, then
        # docid order): the plain step's first cut falls inside them
        f16 = np.asarray(j.arena.arrays()[0])[tie[0].start:tie[0].start + 900]
        assert (f16 == f16[0]).all()
        monkeypatch.setattr(KD, "_PLAIN_ROWS", 450)
    wave = SCAN_CASES[case](sp0, sp1, tie)
    ns = JD.DeviceSegmentStore.MAX_SPANS
    bs = 8 if case == "base" else len(wave)
    qi = np.zeros((bs, 2 * ns + 4), np.int32)
    qi[:, 2 * ns + 1] = JD.NO_FLAG
    qi[:, 2 * ns + 2] = JD.DAYS_NONE_LO
    qi[:, 2 * ns + 3] = JD.DAYS_NONE_HI
    scans = []
    for i, (sps, filt) in enumerate(wave):
        for e, sp in enumerate(sps):
            qi[i, e], qi[i, ns + e] = sp.start, sp.count
        qi[i, 2 * ns:] = filt
        scans.append(([(sp.start, sp.count) for sp in sps], filt))
    prof = JProf()
    f, fl, d = j.arena.arrays()
    want = np.asarray(JD._rank_scan_batch_packed_kernel(
        f, fl, d, j.arena.dead_array(), qi, *j._profile_consts(prof, "en"),
        k=kk, n_spans=ns, bs=bs))
    arrays = convert.arena_from_numpy(
        *(np.asarray(a) for a in (f, fl, d)),
        np.asarray(j.arena.dead_array()), np.asarray(j.arena._pmax), "cpu")
    consts = TR.profile_consts(convert.profile_from_jax(
        prof.to_external_string()), JP.pack_language("en"), "cpu")
    got = TD.scan_batch_query(arrays, scans, consts, kk).numpy()
    np.testing.assert_array_equal(got, want[:len(scans)])
    for i, (ext, filt) in enumerate(scans):
        if ext:
            solo = TD.scan_query(arrays, ext, consts, kk, filt).numpy()
            np.testing.assert_array_equal(got[i], solo[:2 * kk])
    live = (got[:, kk:] >= 0).sum(1)
    if case == "rejects_all":
        assert live[1] == 0 and live[0] > 0
    if case == "few_rows":
        assert live[0] == 7 and live[1] < 128
    if case == "ties":
        # the tie block's 900 equal best rows
        assert (got[0, :min(kk, 900)] == got[0, 0]).all()


def test_watchdog_withdraws_to_solo(served, monkeypatch):
    """A wave that stalls past the watchdog: the query is served solo
    (the same answer), counted in batch_timeouts by its cause."""
    import time
    idx, j, t = served
    t.enable_batching(max_batch=4, dispatchers=1)
    b = t._batcher
    monkeypatch.setattr(b, "WATCHDOG_S", 0.05)
    real = b._dispatch
    monkeypatch.setattr(b, "_dispatch", lambda batch: (time.sleep(0.3),
                                                       real(batch)))
    _same(t.rank_term(TERMS[0], JProf(), k=20),
          _solo(j, TERMS[0], JProf(), 20))
    c = t.counters()
    assert c["batch_timeouts"] == 1
    assert c["batch_timeout_worker_stall"] + \
        c["batch_timeout_flush_deadline"] + c["batch_timeout_queue_full"] == 1


def test_failing_launch_raises_in_the_submitter(served, monkeypatch):
    """No fallback: a launch that raises in a dispatcher is counted and
    raised in the query's own thread, not served another way."""
    idx, j, t = served
    t.enable_batching(max_batch=4, dispatchers=1)

    def broken(*a, **kw):
        raise RuntimeError("CUDA kernel pruned_tile failed")
    monkeypatch.setattr(KD, "pruned_tile", broken)
    with pytest.raises(RuntimeError, match="pruned_tile"):
        t.rank_term(TERMS[0], JProf(), k=20)
    assert t.counters()["batch_exceptions"] == 1


def test_set_tuning_and_close(served):
    """set_tuning grows and shrinks the pools (floors at 1), queries keep
    their answers, close stops every thread."""
    idx, j, t = served
    t.enable_batching(max_batch=8, dispatchers=2)
    b = t._batcher
    assert t.set_tuning(dispatchers=4, completer_depth=3)["dispatchers"] == 4
    _same(t.rank_term(TERMS[0], JProf(), k=10), _solo(j, TERMS[0], JProf(),
                                                      10))
    assert t.set_tuning(dispatchers=0)["dispatchers"] == 1
    _same(t.rank_term(TERMS[1], JProf(), k=10), _solo(j, TERMS[1], JProf(),
                                                      10))
    threads = list(b._threads)
    t.close()
    assert t._batcher is None
    for th in threads:
        th.join(timeout=5)
    assert not any(th.is_alive() for th in threads)


def test_searchevent_site_page_with_batching_matches_jax_store(monkeypatch):
    """A SearchEvent page for a `site:` query (the facet bitmap) and a
    plain one, with the port store's batcher on, equal to the JAX
    store's with its batcher on."""
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
            seg.store_document(Document(
                url=f"http://h{i % 7}.example/p{i}.html",
                title=f"gondola {i}",
                text=f"gondola lift station {i} "
                     * (1 + int(rng.integers(1, 5)))))
        seg.rwi.flush()
        while seg.rwi.merge_runs(max_runs=1):
            pass
        return seg

    def page(seg, qs, n=10):
        ev = SearchEvent(QueryParams.parse(qs, item_count=n), seg)
        return [(r.docid, r.score) for r in ev.results()]

    jseg, tseg = segment(), segment()
    jseg.enable_device_serving()
    jseg.devstore.enable_batching(max_batch=8, dispatchers=2, prewarm=False,
                                  scan_batching=True)
    tseg.devstore = TD.DeviceSegmentStore(tseg.rwi, device="cpu")
    tseg.devstore.enable_batching(max_batch=8, dispatchers=2,
                                  scan_batching=True)
    try:
        for qs in ("gondola site:h3.example", "gondola", "gondola"):
            want = page(jseg, qs)
            assert page(tseg, qs) == want and want
        assert tseg.devstore.filtered_served == 1
        assert tseg.devstore.counters()["rank_cache_hits"] >= 1
    finally:
        tseg.devstore.close()
        jseg.devstore.close()
