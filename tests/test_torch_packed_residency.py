"""The port's packed residency and tier ladder against the JAX package's,
on the CPU.

A JAX `DeviceSegmentStore(rwi, packed_residency=True)`, the port's
(`device="cpu"`: the plain versions of K5bp, K6bp, K7bp, the packed
finish and K12) and the port's int16 store hang on one RWI through
`kernels/bench.Fanout`, over tests/test_packed_residency.py's corpora
(`_fill`, `_tiered_store`). Every answer (scores, docids, considered)
and every `tier_*` and serving counter equals the JAX store's, with both
result caches cleared before a compared query; and every packed answer
equals the port's int16 store's (the reference's own contract): the
solo pruned path, filtered exact scans, 12 threads through the batcher,
the result cache and its epoch, the oracle, warm promotion with LRU
demotion and compaction, cold promotion past a warm budget of 0, the
batcher's `promote` kind, a join on a packed term, scan batching, a
merge, the device build (K13's plain version) and an injected device
loss's rebuild.
"""

import threading
import time

import numpy as np
import pytest

from yacy_search_server_tpu.index import devstore as JD
from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.index.postings import PostingsList
from yacy_search_server_tpu.index.rwi import RWIIndex as JRWI
from yacy_search_server_tpu.ops.ranking import RankingProfile as JProf
from yacy_search_server_tpu.utils import faultinject as jfault
from yacy_search_server_tpu_torch.index import devstore as TD
from yacy_search_server_tpu_torch.kernels import bench as KB
from yacy_search_server_tpu_torch.ops import packed as TPK
from yacy_search_server_tpu_torch.ops import ranking as TR
from yacy_search_server_tpu_torch.utils import faultinject as tfault

TERMS = [f"term{t}0000000".encode()[:12] for t in range(3)]
N = 50_000
EN = JP.pack_language("en")
TIER = ("tier_hot_hits", "tier_warm_hits", "tier_cold_hits",
        "tier_promotions_warm_hot", "tier_promotions_cold_hot",
        "tier_demotions_hot_warm", "tier_evictions_warm_cold",
        "tier_promote_async", "tier_promote_failures", "tier_hot_bytes",
        "tier_warm_bytes", "tier_cold_bytes", "packed_compression_ratio")
SERVING = ("queries_served", "fallbacks", "prune_rounds", "pruned_tiles",
           "stream_scans", "join_served", "join_fallbacks",
           "join_degraded_plain", "batch_ineligible", "arena_epoch")


@pytest.fixture(autouse=True)
def _clean_faults():
    jfault.clear()
    tfault.clear()
    yield
    jfault.clear()
    tfault.clear()


def _fill(rwi, seed=7, n=N, n_terms=3):
    """tests/test_packed_residency.py's corpus: a run a term."""
    rng = np.random.default_rng(seed)
    for t in range(n_terms):
        docids = np.arange(n, dtype=np.int32)
        feats = rng.integers(0, 1000, (n, JP.NF)).astype(np.int32)
        feats[:, JP.F_FLAGS] = rng.integers(0, 2 ** 20, n)
        feats[:, JP.F_DOMLENGTH] = rng.integers(0, 256, n)
        feats[:, JP.F_LANGUAGE] = EN
        rwi.ingest_run({TERMS[t]: PostingsList(docids, feats)})
    return rwi


def _fill_tiered(rwi):
    """tests/test_packed_residency.py's _tiered_store corpus."""
    rng = np.random.default_rng(2)
    n = 60_000
    for t in range(3):
        docids = np.arange(n, dtype=np.int32)
        feats = rng.integers(0, 1000, (n, JP.NF)).astype(np.int32)
        feats[:, JP.F_LANGUAGE] = EN
        rwi.ingest_run({TERMS[t]: PostingsList(docids, feats)})
    return rwi


def _stores(fill=_fill, device_build=False, **kw):
    """(rwi, JAX packed store, port packed store, port int16 store) over
    one RWI; `kw` to both packed stores (budgets)."""
    rwi = JRWI()
    j = JD.DeviceSegmentStore(rwi, packed_residency=True, **kw)
    t = TD.DeviceSegmentStore(rwi, device="cpu", packed_residency=True, **kw)
    i16 = TD.DeviceSegmentStore(rwi, device="cpu")
    j.ingest_device_build = t.ingest_device_build = device_build
    rwi.listener = KB.Fanout(j, t, i16)
    fill(rwi)
    return rwi, j, t, i16


def _close(*stores):
    for s in stores:
        s.close()


def _same(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert got[2] == want[2]


def _counters_equal(j, t, keys=TIER + SERVING):
    jc, tc = j.counters(), t.counters()
    for key in keys:
        assert tc[key] == jc[key], (key, tc[key], jc[key])


def _query(j, t, i16, th, prof=None, k=10, **kw):
    """One query on the three stores, both result caches cleared first:
    the port's packed answer is the JAX store's and (where it is served)
    the int16 store's."""
    prof = prof or JProf()
    j._topk_cache._d.clear()
    t._topk_cache.clear()
    want = j.rank_term(th, prof, "en", k=k, **kw)
    got = t.rank_term(th, prof, "en", k=k, **kw)
    _same(got, want)
    if got is not None:
        i16._topk_cache.clear()
        _same(got, i16.rank_term(th, prof, "en", k=k, **kw))
    return got


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# -- the serving paths ---------------------------------------------------------

@pytest.mark.parametrize("k", [5, 10, 100, 3000])
def test_solo_pruned_path_matches_jax_and_int16(k):
    _rwi, j, t, i16 = _stores()
    try:
        for prof in (JProf(), JProf(domlength=15, tf=13)):
            for th in TERMS:
                assert _query(j, t, i16, th, prof, k=k) is not None
        _counters_equal(j, t)
        assert t.tier_hot_hits > 0 and t.prune_rounds > 0
        assert t.pruned_tiles > 0, "the packed path must prune"
    finally:
        _close(j, t, i16)


FILTERS = {"lang": dict(lang_filter=EN), "days": dict(from_days=100,
                                                      to_days=800),
           "flag": dict(flag_bit=3), "none_pass": dict(lang_filter=0x6465),
           "all": dict(lang_filter=EN, flag_bit=7, from_days=300)}


@pytest.mark.parametrize("name", list(FILTERS))
def test_filtered_scans_match_jax_and_int16(name):
    _rwi, j, t, i16 = _stores()
    try:
        for th in TERMS[:2]:
            for k in (20, 1000):
                _query(j, t, i16, th, k=k, **FILTERS[name])
        _counters_equal(j, t)
        assert t.stream_scans == 4
    finally:
        _close(j, t, i16)


def test_batched_threads_match_jax_and_int16():
    """12 threads through the batcher on each store: the same answers a
    term (K5bp waves here)."""
    _rwi, j, t, i16 = _stores()
    try:
        j.enable_batching(max_batch=8, dispatchers=2, prewarm=False)
        t.enable_batching(max_batch=8, dispatchers=2)
        for s in (j, t, i16):
            s._topk_cache.enabled = False
        prof = JProf()
        results = {}
        for tag, store in (("j", j), ("t", t), ("i16", i16)):
            out = []

            def worker(i, store=store, out=out):
                out.append((i % 3, store.rank_term(TERMS[i % 3], prof,
                                                   "en", k=10)))
            ts = [threading.Thread(target=worker, args=(i,))
                  for i in range(12)]
            for th in ts:
                th.start()
            for th in ts:
                th.join()
            results[tag] = out
        for i, got in results["t"]:
            _same(got, dict(results["j"])[i])
            _same(got, dict(results["i16"])[i])
        assert t.queries_served == j.queries_served == 12
        assert t.counters()["batch_dispatches"] > 0
        assert t.tier_hot_hits == j.tier_hot_hits == 12
    finally:
        _close(j, t, i16)


def test_cache_and_epoch_invalidation():
    _rwi, j, t, i16 = _stores()
    try:
        prof = JProf()
        r1 = t.rank_term(TERMS[2], prof, "en", k=10)
        hits0 = t._topk_cache.hits
        r2 = t.rank_term(TERMS[2], prof, "en", k=10)
        assert t._topk_cache.hits == hits0 + 1
        _same(r2, r1)
        _same(r1, j.rank_term(TERMS[2], prof, "en", k=10))
        t._bump_epoch()
        r3 = t.rank_term(TERMS[2], prof, "en", k=10)
        assert t._topk_cache.stale >= 1
        _same(r3, r2)
    finally:
        _close(j, t, i16)


def test_answers_match_the_oracle():
    _rwi, j, t, i16 = _stores()
    try:
        prof = JProf()
        tprof = TR.RankingProfile()
        s, d, _ = t.rank_term(TERMS[0], prof, "en", k=10)
        (_rid, _th), ent = next((k, e) for k, e in t._pblocks.items()
                                if k[1] == TERMS[0])
        os_, od = TPK.bp_topk_oracle(ent["block"], tprof, "en", 10,
                                     stats=ent["stats"])
        np.testing.assert_array_equal(d, od[:len(d)])
        np.testing.assert_array_equal(s.astype(np.int64), os_[:len(s)])
        s, d, _ = t.rank_term(TERMS[0], prof, "en", k=10, lang_filter=EN,
                              from_days=50)
        os_, od = TPK.bp_topk_oracle(ent["block"], tprof, "en", 10,
                                     lang_filter=EN, from_days=50)
        np.testing.assert_array_equal(d, od[:len(d)])
    finally:
        _close(j, t, i16)


# -- the tier ladder ------------------------------------------------------------

def test_warm_promotion_with_lru_demotion_and_compaction():
    """A budget that holds ~2 of the 3 terms: a warm hit promotes inline,
    demotes the LRU hot block and compacts; the victim round-trips back.
    Every step's counters, the arena's word layout and the answers equal
    the JAX store's, and the int16 store's."""
    _rwi, j, t, i16 = _stores(_fill_tiered, budget_bytes=7_500_000)
    try:
        warm = [th for (_r, th), e in t._pblocks.items() if not e["hot"]]
        assert warm and len(warm) < 3
        assert warm == [th for (_r, th), e in j._pblocks.items()
                        if not e["hot"]]
        _counters_equal(j, t)
        wth = warm[0]
        epoch0 = t.arena_epoch
        assert _query(j, t, i16, wth) is None      # host path + promotion
        _counters_equal(j, t)
        assert t.tier_warm_hits == 1 and t.tier_promotions_warm_hot == 1
        assert t.tier_demotions_hot_warm >= 1
        assert t.arena_epoch > epoch0
        assert t.arena.packed_garbage_words == 0   # compacted
        used = j.arena._pw_used
        assert t.arena._pw_used == used
        np.testing.assert_array_equal(
            t.arena.packed_array().numpy()[:used],
            np.asarray(j.arena.packed_array())[:used])
        assert _query(j, t, i16, wth) is not None
        demoted = [th for (_r, th), e in t._pblocks.items()
                   if not e["hot"]][0]
        assert _query(j, t, i16, demoted) is None
        assert _query(j, t, i16, demoted) is not None
        for th in TERMS:
            _query(j, t, i16, th, k=100)
        _counters_equal(j, t)
    finally:
        _close(j, t, i16)


def test_cold_promotion_after_warm_eviction():
    _rwi, j, t, i16 = _stores(_fill_tiered, budget_bytes=7_500_000,
                              warm_budget_bytes=0)
    try:
        assert t.tier_evictions_warm_cold >= 1
        cold = [th for th in TERMS
                if not any(k[1] == th for k in t._pblocks)]
        assert cold
        assert _query(j, t, i16, cold[0]) is None
        assert t.tier_cold_hits == 1 and t.tier_promotions_cold_hot == 1
        assert _query(j, t, i16, cold[0]) is not None
        _counters_equal(j, t)
    finally:
        _close(j, t, i16)


def test_tiering_toggle():
    _rwi, j, t, i16 = _stores(_fill_tiered, budget_bytes=7_500_000)
    try:
        j._tiering_enabled = t._tiering_enabled = False
        warm = [th for (_r, th), e in t._pblocks.items() if not e["hot"]]
        assert _query(j, t, i16, warm[0]) is None
        assert t.tier_warm_hits == t.tier_promotions_warm_hot == 0
        _counters_equal(j, t)
    finally:
        _close(j, t, i16)


def test_async_promotion_through_the_batcher():
    """With a batcher the promotion is its `promote` kind: the triggering
    query returns at once (host path); a later query serves packed."""
    _rwi, j, t, i16 = _stores(_fill_tiered, budget_bytes=7_500_000)
    try:
        j.enable_batching(max_batch=8, dispatchers=2, prewarm=False)
        t.enable_batching(max_batch=8, dispatchers=2)
        warm = [th for (_r, th), e in t._pblocks.items() if not e["hot"]]
        wth = warm[0]
        prof = JProf()
        assert j.rank_term(wth, prof, "en", k=10) is None
        assert t.rank_term(wth, prof, "en", k=10) is None
        assert t.tier_promote_async == j.tier_promote_async == 1
        assert _wait(lambda: t.tier_promotions_warm_hot == 1
                     and not t._promote_inflight)
        assert _wait(lambda: j.tier_promotions_warm_hot == 1
                     and not j._promote_inflight)
        assert t.counters()["batch_exceptions"] == 0
        _query(j, t, i16, wth, k=10)
        assert t.rank_term(wth, prof, "en", k=10) is not None
        _counters_equal(j, t, TIER)
    finally:
        _close(j, t, i16)


def test_promotion_probe_decodes_the_first_row():
    _rwi, j, t, i16 = _stores(_fill_tiered, budget_bytes=7_500_000)
    try:
        key = next(k for k, e in t._pblocks.items() if not e["hot"])
        run = next(r for r in t.rwi._runs if id(r) == key[0])
        t._promote_inflight.add(key)
        probe, want, words = t._promote_now(key, run)
        assert words is t.arena.packed_array()
        np.testing.assert_array_equal(probe.numpy(), want)
        f16, fl, dd = TPK.unpack_block(t._pblocks[key]["block"])
        np.testing.assert_array_equal(want, np.concatenate(
            [f16[0].astype(np.int32), fl[:1], dd[:1]]))
    finally:
        _close(j, t, i16)


# -- the other entry points -----------------------------------------------------

def test_rank_join_declines_packed_terms():
    _rwi, j, t, i16 = _stores()
    try:
        for inc, exc in (([TERMS[0], TERMS[1]], []), ([TERMS[0]], [TERMS[2]])):
            assert j.rank_join(inc, exc, JProf()) is None
            assert t.rank_join(inc, exc, JProf()) is None
        _counters_equal(j, t)
        assert t.join_fallbacks == 2 and i16.rank_join(
            [TERMS[0], TERMS[1]], [], JProf()) is not None
    finally:
        _close(j, t, i16)


def test_scan_batching_never_sees_packed_spans():
    _rwi, j, t, i16 = _stores()
    try:
        j.enable_batching(max_batch=4, dispatchers=1, prewarm=False,
                          scan_batching=True)
        t.enable_batching(max_batch=4, dispatchers=1, scan_batching=True)
        got = _query(j, t, i16, TERMS[0], k=10, lang_filter=EN)
        assert got is not None and len(got[0]) == 10
        assert t.stream_scans == 1
        assert t.counters()["batch_ineligible"] == 0
        _counters_equal(j, t)
    finally:
        _close(j, t, i16)


def test_multi_span_declines_then_a_merge_serves():
    """A second run makes TERMS[0] two spans: declined (merge wanted),
    its RAM delta too; after the merge the merged block serves packed and
    the retired blocks' words are garbage, as on the JAX store."""
    rwi, j, t, i16 = _stores()
    try:
        rng = np.random.default_rng(5)
        feats = rng.integers(0, 1000, (2_000, JP.NF)).astype(np.int32)
        feats[:, JP.F_LANGUAGE] = EN
        rwi.ingest_run({TERMS[0]: PostingsList(
            np.arange(N, N + 2_000, dtype=np.int32), feats)})
        assert _query(j, t, i16, TERMS[0]) is None
        assert t.merge_wanted and j.merge_wanted
        rwi.add_many(TERMS[1], PostingsList(
            np.asarray([N + 7], np.int32), feats[:1]))
        assert _query(j, t, i16, TERMS[1]) is None    # a RAM delta
        rwi.flush()
        assert rwi.merge_runs(max_runs=1)
        for th in TERMS:
            assert _query(j, t, i16, th, k=50) is not None
        _counters_equal(j, t)
        assert t.arena.packed_garbage_words == j.arena.packed_garbage_words
    finally:
        _close(j, t, i16)


def test_delete_turns_pruning_off_as_on_jax():
    rwi, j, t, i16 = _stores()
    try:
        base = _query(j, t, i16, TERMS[1], k=10)
        rwi.delete_doc(int(base[1][0]))
        got = _query(j, t, i16, TERMS[1], k=10)
        assert int(base[1][0]) not in got[1]
        _counters_equal(j, t)
        assert t.stream_scans == 1
    finally:
        _close(j, t, i16)


@pytest.mark.parametrize("device_build", [False, True])
def test_ingest_device_build_gives_the_same_blocks(device_build):
    """With ingest_device_build the blocks of [64, 2^18] rows come from
    K13 (its plain version here): the same words as the host pack, the
    same answers, and the JAX store's count of device-built blocks."""
    def fill(rwi):
        _fill(rwi, n=5_000)
        rng = np.random.default_rng(9)
        rwi.ingest_run({b"stubAAAAAAAA": PostingsList(
            np.arange(40, dtype=np.int32),
            rng.integers(0, 9, (40, JP.NF)).astype(np.int32))})
    _rwi, j, t, i16 = _stores(fill, device_build=device_build)
    try:
        assert t.ingest_device_builds == j.ingest_device_builds == (
            3 if device_build else 0)
        for key, ent in t._pblocks.items():
            blk = ent["block"]
            want = TPK.pack_block(*TPK.unpack_block(blk))
            np.testing.assert_array_equal(blk.words, want.words)
            np.testing.assert_array_equal(blk.words,
                                          j._pblocks[key]["block"].words)
        for th in TERMS + [b"stubAAAAAAAA"]:
            _query(j, t, i16, th, k=20)
        assert t.counters()["ingest_device_builds"] == t.ingest_device_builds
    finally:
        _close(j, t, i16)


def test_counters_have_every_jax_key():
    _rwi, j, t, i16 = _stores()
    try:
        _query(j, t, i16, TERMS[0])
        jc, tc = j.counters(), t.counters()
        assert set(jc) <= set(tc), sorted(set(jc) - set(tc))
        assert tc["packed_compression_ratio"] > 1.0
        assert tc["tier_hot_bytes"] > 0
        assert t.tier_bytes() == {"hot": jc["tier_hot_bytes"],
                                  "warm": jc["tier_warm_bytes"], "cold": 0}
    finally:
        _close(j, t, i16)


# -- device loss -----------------------------------------------------------------

def test_device_loss_rebuild_repromotes_to_the_same_answers(monkeypatch):
    """A streak of injected failed fetches declares the loss; the rebuild
    demotes every hot block and promotes it again (inline here, through
    the batcher on the card's smoke); the answers after it are those from
    before, and the loss and tier counters the JAX store's."""
    stores = []
    for cls, kw, fault in ((JD.DeviceSegmentStore, {}, jfault),
                           (TD.DeviceSegmentStore, {"device": "cpu"},
                            tfault)):
        rwi = JRWI()
        s = cls(rwi, packed_residency=True, **kw)
        _fill(rwi, n=5_000)
        s._topk_cache.enabled = False
        if cls is TD.DeviceSegmentStore:
            monkeypatch.setattr(TD, "TRANSFER_RETRIES", 0)
            monkeypatch.setattr(TD, "LOSS_STREAK", 2)
            monkeypatch.setattr(TD, "REBUILD_BACKOFF_S", 0.05)
        else:
            s.transfer_retry_limit = 0
            s.loss_streak = 2
            s.rebuild_backoff_s = 0.05
        before = {th: s.rank_term(th, JProf(), "en", k=20) for th in TERMS}
        fault.set_fault("device.transfer_fail", 2)
        assert s.rank_term(TERMS[0], JProf(), "en", k=20) is None
        assert s.rank_term(TERMS[1], JProf(), "en", k=20) is None
        assert s.device_lost
        assert _wait(lambda s=s: not s.device_lost)
        after = {th: s.rank_term(th, JProf(), "en", k=20) for th in TERMS}
        for th in TERMS:
            _same(after[th], before[th])
        stores.append((s, before))
    (j, jb), (t, tb) = stores
    for th in TERMS:
        _same(tb[th], jb[th])
    _counters_equal(j, t, TIER + ("device_losses", "device_loss_recoveries",
                                  "device_lost_queries", "transfer_failures",
                                  "queries_served", "fallbacks"))
    assert t.tier_promotions_warm_hot == 3
    _close(j, t)
