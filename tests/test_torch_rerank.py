"""The port's hybrid dense rerank on the device store (`rerank_boost`, the
batcher's `rerank` kind, the hybrid top-k cache) against the JAX
package's, on the CPU: tests/test_rerank_batching.py's cases.

One RWI feeds a JAX store and a port store (`device="cpu"`, the plain
versions) through `kernels/bench.Fanout`; the JAX DenseVectorStore's
vectors reach the port's through `convert.dense_from_numpy`. The port's
solo and batched answers must equal each other to the bit; against the
JAX store's they are held to its own bar for its kernel against its
oracle (the same docids, each score within 64 cardinal units, the port's
order (score DESC, docid ASC) on its own scores), since the two packages
sum the bf16 dot in different orders. End to end, the JAX SearchEvent
pages hybrid queries on a Segment that carries the port store and a port
DenseVectorStore.
"""

import threading

import numpy as np
import pytest
import torch

from yacy_search_server_tpu.index import devstore as JDS
from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.index.dense import DenseVectorStore as JStore
from yacy_search_server_tpu.index.rwi import RWIIndex as JRWI
from yacy_search_server_tpu.ops import dense as JD
from yacy_search_server_tpu.ops.ranking import RankingProfile
from yacy_search_server_tpu_torch import convert
from yacy_search_server_tpu_torch.index import devstore as TDS
from yacy_search_server_tpu_torch.kernels import bench as KB
from yacy_search_server_tpu_torch.ops import dense as TD
from yacy_search_server_tpu_torch.utils import faultinject

TH = b"rerankterm0A"
DIM = TD.DIM
TOL = 64


def _plist(rng, n, base=0):
    docids = np.arange(base, base + n, dtype=np.int32)
    feats = rng.integers(0, 1000, (n, JP.NF)).astype(np.int32)
    feats[:, JP.F_FLAGS] = rng.integers(0, 2 ** 20, n)
    feats[:, JP.F_DOMLENGTH] = rng.integers(0, 256, n)
    feats[:, JP.F_LANGUAGE] = JP.pack_language("en")
    return JP.PostingsList(docids, feats)


class Pair:
    """A JAX store and a port store over one RWI, each with its dense
    store (the JAX one's vectors: every other docid below n_vec, normal
    rows, so half the candidates have no vector)."""

    def __init__(self, n=4000, n_vec=1024, batching=True,
                 rerank_batching=True, max_batch=4):
        self.idx = JRWI()
        self.idx.add_many(TH, _plist(np.random.default_rng(1), n))
        self.idx.flush()
        self.j = JDS.DeviceSegmentStore(self.idx)
        self.t = TDS.DeviceSegmentStore(self.idx, device="cpu")
        self.idx.listener = KB.Fanout(self.j, self.t)
        jd = JStore(dim=DIM)
        rng = np.random.default_rng(2)
        for i in range(0, n_vec, 2):
            jd.put(i, rng.standard_normal(DIM).astype(np.float32))
        self.j.attach_dense(jd)
        self.t.attach_dense(convert.dense_from_numpy(jd._vecs, len(jd),
                                                     device="cpu"))
        if batching:
            self.j.enable_batching(max_batch=max_batch, dispatchers=2,
                                   prewarm=False,
                                   rerank_batching=rerank_batching)
            self.t.enable_batching(max_batch=max_batch, dispatchers=2,
                                   rerank_batching=rerank_batching)

    def put(self, docid, vec):
        self.j._dense.put(docid, vec)
        self.t._dense.put(docid, vec)

    def close(self):
        self.j.close()
        self.t.close()


@pytest.fixture
def pair():
    p = Pair()
    yield p
    p.close()


def _queries(n_q, rng):
    """(qvec, sparse, docids) rerank inputs: ragged n, forced ties,
    docids past the forward index's rows."""
    qs = []
    for _ in range(n_q):
        n = int(rng.integers(5, 200))
        dd = rng.choice(2048, size=n, replace=False).astype(np.int32)
        sp = rng.integers(0, 1 << 20, n).astype(np.int32)
        sp[: n // 4] = sp[0]
        qs.append((rng.standard_normal(DIM).astype(np.float32), sp, dd))
    return qs


def _close(label, got, want, tol=TOL):
    gs, gd = (np.asarray(a) for a in got)
    ws, wd = (np.asarray(a) for a in want)
    assert sorted(gd.tolist()) == sorted(wd.tolist()), label
    w = dict(zip(wd.tolist(), ws.tolist()))
    worst = max((abs(int(s) - w[d]) for s, d in zip(gs.tolist(),
                                                     gd.tolist())), default=0)
    print(f"{label}: largest |delta| {worst}")
    assert worst <= tol, label


def _ordered(scores, docids):
    s = np.asarray(scores, np.int64)
    d = np.asarray(docids, np.int64)
    assert np.all(s[:-1] >= s[1:])
    same = s[:-1] == s[1:]
    assert np.all(d[:-1][same] < d[1:][same])


def _same(a, b):
    return (np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
            and np.array_equal(np.asarray(a[1]), np.asarray(b[1])))


def _hammer(fn, args):
    """fn(*a) for each a of args, each on a thread of its own."""
    out, errs = [None] * len(args), []

    def worker(i):
        try:
            out[i] = fn(*args[i])
        except Exception as e:  # noqa: BLE001 - asserted below
            errs.append(e)
    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(len(args))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs
    return out


# -- solo and batched --------------------------------------------------------------

def test_solo_vs_batched_bit_identical_and_within_bar_of_jax():
    solo = Pair(rerank_batching=False)
    batched = Pair(rerank_batching=True)
    try:
        qs = _queries(12, np.random.default_rng(5))
        want = [solo.t.rerank_boost(*q, 0.5) for q in qs]
        jax_ans = [solo.j.rerank_boost(*q, 0.5) for q in qs]
        got = _hammer(lambda *q: batched.t.rerank_boost(*q, 0.5), qs)
        for i, q in enumerate(qs):
            assert _same(got[i], want[i])
            _ordered(*got[i])
            _close(f"query {i} vs the JAX store", got[i], jax_ans[i])
            fwd = np.asarray(solo.t._dense.device_block("cpu")[0])
            _close(f"query {i} vs the oracle", got[i],
                   TD.rerank_fwd_np(q[0], fwd, q[1], q[2], 0.5))
        cs, cb = solo.t.counters(), batched.t.counters()
        assert cs["rerank_queries"] == cs["rerank_dispatches"] == len(qs)
        assert cb["rerank_queries"] == len(qs)
        assert 1 <= cb["rerank_dispatches"] <= len(qs)
        assert cb["rerank_fallbacks"] == cs["rerank_fallbacks"] == 0
        # the JAX store counts the same
        assert solo.j.counters()["rerank_queries"] == len(qs)
    finally:
        solo.close()
        batched.close()


def test_solo_without_batcher_and_from_batcher_threads():
    p = Pair(batching=False)
    try:
        q = _queries(1, np.random.default_rng(6))[0]
        a = p.t.rerank_boost(*q, 0.5)
        p.t.enable_batching(max_batch=4, dispatchers=1)
        p.t._batcher._threads.append(threading.current_thread())
        b = p.t.rerank_boost(*q, 0.5)   # from a batcher thread: solo
        assert _same(a, b)
        assert p.t.counters()["rerank_dispatches"] == 2
    finally:
        p.t._batcher._threads.remove(threading.current_thread())
        p.close()


def test_counters_exact_under_32_thread_hammer():
    p = Pair(max_batch=8)
    try:
        threads, per = 32, 4
        qs = _queries(threads, np.random.default_rng(8))
        ref = [p.t.rerank_boost(*q, 0.5) for q in qs]
        c0 = p.t.counters()

        def worker(i):
            return [p.t.rerank_boost(*qs[i], 0.5) for _ in range(per)]
        outs = _hammer(worker, [(i,) for i in range(threads)])
        for i, got in enumerate(outs):
            assert all(_same(g, ref[i]) for g in got)
        c = p.t.counters()
        assert c["rerank_queries"] - c0["rerank_queries"] == threads * per
        n_disp = c["rerank_dispatches"] - c0["rerank_dispatches"]
        assert 1 <= n_disp <= threads * per + c["batch_timeouts"]
        assert c["rerank_fallbacks"] == 0 and c["batch_exceptions"] == 0
    finally:
        p.close()


def test_patch_racing_waves_never_mixes_versions():
    """Vector writes (patched blocks) land while 16 threads rerank
    through the batcher: every answer is the plain rerank over ONE of the
    blocks the store handed out, never a mix of two."""
    p = Pair(max_batch=8)
    try:
        dense = p.t._dense
        # each block handed out, held (so no id is reused) with a copy
        # taken when it was handed out (an in-place patch would change
        # the block after the copy)
        held, blocks, lock = [], [], threading.Lock()
        real = dense.device_snapshot

        def snap(device):
            got = real(device)
            with lock:
                if not any(b is got[0] for b in held):
                    held.append(got[0])
                    blocks.append(got[0].clone())
            return got
        dense.device_snapshot = snap
        rng = np.random.default_rng(9)
        qs = _queries(16, rng)
        stop = threading.Event()

        def writer():
            w = np.random.default_rng(10)
            while not stop.is_set():
                for d in w.choice(1024, 8, replace=False):
                    dense.put(int(d), w.standard_normal(DIM).astype(
                        np.float32))
        wt = threading.Thread(target=writer)
        wt.start()
        try:
            outs = _hammer(lambda i: [p.t.rerank_boost(*qs[i], 0.5)
                                      for _ in range(6)],
                           [(i,) for i in range(16)])
        finally:
            stop.set()
            wt.join()
        assert len(blocks) > 1
        for i, got in enumerate(outs):
            q = qs[i]
            nb = TD.rerank_bucket(len(q[2]))
            row = TD.pack_rerank_row(q[0], q[1], q[2], 0.5, nb)[None, :]
            exact = [TD.rerank_fwd_batch_packed(b, row, nb).numpy()[0]
                     for b in blocks]
            n = len(q[2])
            for g in got:
                assert any(np.array_equal(g[0], e[:n])
                           and np.array_equal(g[1], e[nb:nb + n])
                           for e in exact), "an answer mixes two blocks"
        assert all(torch.equal(h, b) for h, b in zip(held, blocks))
    finally:
        p.close()


# -- fallbacks --------------------------------------------------------------------

def test_fallbacks_counted():
    p = Pair(batching=False)
    try:
        rng = np.random.default_rng(9)
        qv = rng.standard_normal(DIM).astype(np.float32)
        n = TD.RERANK_MAX_N + 1
        dd = np.arange(n, dtype=np.int32)
        sp = rng.integers(0, 1 << 20, n).astype(np.int32)
        for s in (p.j, p.t):
            assert s.rerank_boost(qv, sp, dd, 0.5) is None
            got = s.rerank_boost(qv, sp[:0], dd[:0], 0.5)
            assert len(got[0]) == len(got[1]) == 0
        assert p.t.counters()["rerank_fallbacks"] == 1
        # no forward index: the block is over its budget
        p.t._dense.device_budget_bytes = 1
        p.j._dense.device_budget_bytes = 1
        for s in (p.j, p.t):
            assert s.rerank_boost(qv, sp[:10], dd[:10], 0.5) is None
        assert p.t.counters()["rerank_fallbacks"] == 2
        assert p.t.counters()["dense_fwd_bytes"] == 0
        # device lost: counted in rerank_fallbacks only
        p.t.device_lost = True
        c0 = p.t.counters()
        assert p.t.rerank_boost(qv, sp[:10], dd[:10], 0.5) is None
        c1 = p.t.counters()
        assert c1["rerank_fallbacks"] == c0["rerank_fallbacks"] + 1
        assert c1["device_lost_queries"] == c0["device_lost_queries"]
        p.t.device_lost = False
        # no dense store: None, uncounted
        p.t._dense = None
        assert p.t.rerank_boost(qv, sp[:10], dd[:10], 0.5) is None
        assert p.t.counters()["rerank_fallbacks"] == 3
    finally:
        p.close()


def test_failed_fetch_is_a_counted_fallback(monkeypatch):
    p = Pair(batching=False)
    try:
        monkeypatch.setattr(TDS, "TRANSFER_RETRIES", 0)
        monkeypatch.setattr(TDS, "LOSS_STREAK", 100)
        q = _queries(1, np.random.default_rng(3))[0]
        faultinject.set_fault("device.transfer_fail", 1)
        try:
            assert p.t.rerank_boost(*q, 0.5) is None
        finally:
            faultinject.clear()
        c = p.t.counters()
        assert c["rerank_fallbacks"] == 1 and c["transfer_failures"] == 1
        assert p.t.rerank_boost(*q, 0.5) is not None
    finally:
        p.close()


# -- the hybrid top-k cache ---------------------------------------------------------

def test_hybrid_cache_hit_bit_identical_zero_device_work(pair):
    prof = RankingProfile()
    q = _queries(1, np.random.default_rng(10))[0]
    s, d = pair.t.rerank_boost(*q, 0.5)
    pair.t.hybrid_cache_put(TH, prof, "en", 80, 0.5, pair.t.arena_epoch, s,
                            d, len(q[2]))
    c0 = pair.t.counters()
    hs, hd, hc = pair.t.hybrid_cache_get(TH, prof, "en", 80, 0.5)
    c1 = pair.t.counters()
    assert _same((hs, hd), (s, d)) and hc == len(q[2])
    assert c1["rerank_cache_hits"] == c0["rerank_cache_hits"] + 1
    for k in ("device_round_trips", "rerank_dispatches", "rerank_queries"):
        assert c1[k] == c0[k]
    assert pair.t.hybrid_cache_get(TH, prof, "en", 80, 0.9) is None
    assert pair.t.hybrid_cache_get(TH, prof, "en", 79, 0.5) is None
    # the JAX store keys the same way
    assert pair.t._hybrid_cache_key(TH, prof, "en", 80, 0.5, dv=7) == \
        pair.j._hybrid_cache_key(TH, prof, "en", 80, 0.5, dv=7)


def test_hybrid_cache_invalidated_by_encoder_swap(pair, monkeypatch):
    prof = RankingProfile()
    pair.t.hybrid_cache_put(TH, prof, "en", 80, 0.5, pair.t.arena_epoch,
                            np.arange(5, dtype=np.int32),
                            np.arange(5, dtype=np.int32), 5)
    assert pair.t.hybrid_cache_get(TH, prof, "en", 80, 0.5) is not None
    monkeypatch.setattr(TD, "ENCODER_VERSION", TD.ENCODER_VERSION + 1)
    assert pair.t.hybrid_cache_get(TH, prof, "en", 80, 0.5) is None


def test_hybrid_cache_invalidated_by_vector_write_and_epoch_bump(pair):
    prof = RankingProfile()
    t = pair.t

    def put_entry():
        t.hybrid_cache_put(TH, prof, "en", 80, 0.5, t.arena_epoch,
                           np.arange(5, dtype=np.int32),
                           np.arange(5, dtype=np.int32), 5)

    put_entry()
    assert t.hybrid_cache_get(TH, prof, "en", 80, 0.5) is not None
    pair.put(3, np.ones(DIM, np.float32))
    assert t.hybrid_cache_get(TH, prof, "en", 80, 0.5) is None
    put_entry()
    assert t.hybrid_cache_get(TH, prof, "en", 80, 0.5) is not None
    pair.idx.add_many(TH, _plist(np.random.default_rng(11), 300,
                                 base=100_000))
    c0 = t.counters()
    assert t.hybrid_cache_get(TH, prof, "en", 80, 0.5) is None  # RAM delta
    assert t.counters()["rank_cache_stale"] == c0["rank_cache_stale"]
    pair.idx.flush()
    assert t.hybrid_cache_get(TH, prof, "en", 80, 0.5) is None
    assert t.counters()["rank_cache_stale"] > c0["rank_cache_stale"]
    # a put keyed on a vector version snapshotted before a write is
    # unreachable after it
    dv0 = t.hybrid_vector_version()
    pair.put(4, np.ones(DIM, np.float32))
    t.hybrid_cache_put(TH, prof, "en", 80, 0.5, t.arena_epoch,
                       np.arange(5, dtype=np.int32),
                       np.arange(5, dtype=np.int32), 5, dv0=dv0)
    assert t.hybrid_cache_get(TH, prof, "en", 80, 0.5) is None
    assert t.ann_centroid_version() == -1


# -- end to end: SearchEvent ---------------------------------------------------------

def _segment():
    from yacy_search_server_tpu.document.document import Document
    from yacy_search_server_tpu.index.segment import Segment
    seg = Segment(max_ram_postings=50)
    rng = np.random.default_rng(8)
    for i in range(60):
        words = "gondola lift" if i % 3 else "gondola"
        seg.store_document(Document(
            url=f"http://h{i % 7}.example/p{i}.html", title=f"{words} {i}",
            text=f"{words} station {i} cable{i % 5} valley{i % 4} "
                 * (1 + int(rng.integers(1, 5)))))
    seg.rwi.flush()
    while seg.rwi.merge_runs(max_runs=1):
        pass
    return seg


def _spy(store, calls):
    real = store.rerank_boost

    def rb(qvec, sparse, docids, alpha):
        got = real(qvec, sparse, docids, alpha)
        calls.append(((np.array(qvec), np.array(sparse), np.array(docids),
                       alpha), got))
        return got
    store.rerank_boost = rb


@pytest.mark.parametrize("qs", ["gondola", "gondola lift"])
def test_searchevent_hybrid_pages_match_jax_store(monkeypatch, qs):
    from yacy_search_server_tpu.ops import ranking
    from yacy_search_server_tpu.search.query import QueryParams
    from yacy_search_server_tpu.search.searchevent import SearchEvent
    monkeypatch.setattr(ranking, "SMALL_RANK_N", 0)

    def page(seg):
        q = QueryParams.parse(qs, item_count=60)
        q.hybrid = True
        ev = SearchEvent(q, seg)
        return [(r.docid, r.score) for r in ev.results()]

    jseg, tseg = _segment(), _segment()
    jseg.enable_device_serving()
    tstore = TDS.DeviceSegmentStore(tseg.rwi, device="cpu")
    jax_dense = tseg.dense
    tdense = convert.dense_from_numpy(jax_dense._vecs, len(jax_dense),
                                      device="cpu")
    tseg.devstore, tseg.dense = tstore, tdense
    tstore.attach_dense(tdense)
    jcalls, tcalls, reranked = [], [], []
    _spy(jseg.devstore, jcalls)
    _spy(tstore, tcalls)
    real_rerank = SearchEvent._dense_rerank

    def dense_rerank(self, scores, docids):
        got = real_rerank(self, scores, docids)
        reranked.append(got)
        return got
    monkeypatch.setattr(SearchEvent, "_dense_rerank", dense_rerank)
    try:
        want, got = page(jseg), page(tseg)
        assert len(jcalls) == len(tcalls) == 1
        (ja, jgot), (ta, tgot) = jcalls[0], tcalls[0]
        # the sparse stage is the same to the bit; the rerank within the bar
        for x, y in zip(ja[:3], ta[:3]):
            assert np.array_equal(x, y)
        _close(f"{qs}: rerank_boost vs the JAX store", tgot, jgot)
        _ordered(*tgot)
        assert len(got) == len(want) > 10
        _close(f"{qs}: page vs the JAX store's", list(zip(*got))[::-1],
               list(zip(*want))[::-1])
        c0 = tstore.counters()
        assert c0["rerank_queries"] == 1 and c0["rerank_fallbacks"] == 0
        # the repeat: a single term's page from the hybrid cache
        assert page(tseg) == got
        c1 = tstore.counters()
        if qs == "gondola":
            assert c1["rerank_cache_hits"] == c0["rerank_cache_hits"] + 1
            assert c1["rerank_queries"] == c0["rerank_queries"]
            assert c1["device_round_trips"] == c0["device_round_trips"]
        else:
            assert c1["rerank_queries"] == c0["rerank_queries"] + 1
        # the budget shrunk: rerank_boost declines (counted) and the page
        # is SearchEvent's host fallback (get_block + dense_boost_topk),
        # equal within the bar to the port's dense_boost_topk on the same
        # get_block
        tdense.device_budget_bytes = 1
        tstore._topk_cache.clear()
        tcalls.clear()
        reranked.clear()
        fb = page(tseg)
        assert len(fb) == len(got)
        (qv, sp, dd, alpha), none = tcalls[0]
        assert none is None
        assert tstore.counters()["rerank_fallbacks"] == 1
        fs, fi = TD.dense_boost_topk(qv, tdense.get_block(dd), sp,
                                     np.ones(len(dd), bool), alpha, len(dd),
                                     device="cpu")
        fd = dd[fi.numpy()]
        order = np.lexsort((fd, -fs.numpy().astype(np.int64)))
        _close(f"{qs}: host fallback vs the port's dense_boost_topk",
               reranked[0], (fs.numpy()[order], fd[order]))
    finally:
        tseg.dense = jax_dense
        jseg.close()
        tseg.close()
