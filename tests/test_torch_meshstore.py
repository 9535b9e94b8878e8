"""The port's mesh-sharded store (index/meshstore.py) against the JAX
package's, on the CPU.

The JAX MeshSegmentStore runs on the 8 virtual CPU devices (conftest) at
n_term 2 and 1; the port's on 8 CPU cells (its plain versions). One RWI
feeds both through `kernels/bench.Fanout`. Every answer must be the JAX
store's to the bit (scores, docids, considered), with the same fallbacks
and counters: rank_term pruned (pruning engaged), escalating, at k =
1000, under each filter, with a RAM delta and after tombstones; the
column-local and the cross-row join with and without exclusions; merge
and repack; the batcher (batched equals solo, and it batches); a device
loss and the rebuild from the host mirrors. The port's
shard bodies also run on the JAX store's own arrays
(convert.mesh_cells_from_numpy), the cells' host mirrors must equal the
JAX store's, and the JAX `DeviceStore_p` page renders for a port mesh
store as for the JAX one.
"""

import threading
import time
import types

import jax
import numpy as np
import pytest

from yacy_search_server_tpu.index import meshstore as JMS
from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.index.rwi import RWIIndex as JRWI
from yacy_search_server_tpu.ops.ranking import RankingProfile as JProf
from yacy_search_server_tpu.server.objects import ServerObjects
from yacy_search_server_tpu.server.servlets import lookup
from yacy_search_server_tpu.utils.hashes import word2hash
from yacy_search_server_tpu_torch import convert
from yacy_search_server_tpu_torch.index import meshstore as TMS
from yacy_search_server_tpu_torch.kernels import bench as KB
from yacy_search_server_tpu_torch.ops import ranking as TR

N_DEV = 8
ESC = dict(worddistance=2, appemph=15, urllength=12, tf=3)
EN, DE = int(JP.pack_language("en")), int(JP.pack_language("de"))
FILTERS = ({"flag_bit": 3}, {"lang_filter": DE},
           {"from_days": 100, "to_days": 400},
           {"lang_filter": EN, "flag_bit": 5, "from_days": 50})


def _devices():
    devs = jax.devices("cpu")
    if len(devs) < N_DEV:
        pytest.skip(f"need {N_DEV} cpu devices")
    return devs[:N_DEV]


def _feats(rng, n, seed_best=True):
    f = rng.integers(0, 1000, (n, JP.NF)).astype(np.int32)
    f[:, JP.F_FLAGS] = rng.integers(0, 2 ** 20, n)
    f[:, JP.F_DOMLENGTH] = rng.integers(0, 256, n)
    f[:, JP.F_LASTMOD] = rng.integers(0, 500, n)
    f[:, JP.F_LANGUAGE] = np.where(rng.random(n) < 0.6, EN, DE)
    if seed_best:
        f[::997] = f[0]        # equal scores reach the top-k
    return f


def _words(n_term):
    """Word names on term rows: a big term and its partners on row 0, the
    rare term and an exclude on the last row."""
    rows = KB.words_on_rows(n_term, per_row=4)
    last = rows[n_term - 1]
    return {"big": rows[0][0], "part": rows[0][1], "excl0": rows[0][2],
            "rare": last[3], "part2": last[1] if n_term > 1 else rows[0][3],
            "excl1": last[2] if n_term > 1 else rows[0][2]}


def _pair(n_term, **kw):
    idx = JRWI()
    j = JMS.MeshSegmentStore(idx, devices=_devices(), n_term=n_term, **kw)
    t = TMS.MeshSegmentStore(idx, devices=["cpu"] * N_DEV, n_term=n_term,
                             **kw)
    idx.listener = KB.Fanout(j, t)
    return idx, j, t


def _corpus(idx, n_term, seed=7, big=300_000):
    rng = np.random.default_rng(seed)
    names = _words(n_term)
    sizes = {"big": (big, 2_000_000), "part": (30_000, 400_000),
             "excl0": (4_000, 400_000), "rare": (6_000, 400_000),
             "part2": (20_000, 400_000), "excl1": (3_000, 400_000)}
    terms = {}
    for name, (n, hi) in sizes.items():
        th = word2hash(names[name])
        if th in terms:
            continue
        d = np.sort(rng.choice(hi, n, replace=False)).astype(np.int32)
        terms[th] = JP.PostingsList(d, _feats(rng, n))
    idx.ingest_run(terms)
    return {k: word2hash(v) for k, v in names.items()}


@pytest.fixture(scope="module", params=[2, 1], ids=["n_term2", "n_term1"])
def stores(request):
    n_term = request.param
    idx, j, t = _pair(n_term)
    ths = _corpus(idx, n_term)
    yield n_term, idx, j, t, ths
    j.close()
    t.close()


COUNTERS = ("queries_served", "fallbacks", "prune_rounds", "pruned_tiles",
            "device_round_trips")


def _both(j, t, fn):
    j._topk_cache._d.clear()
    t._topk_cache.clear()
    want, got = fn(j), fn(t)
    if want is None:
        assert got is None
        return None
    assert got is not None
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[2] == want[2]
    return got


def _counters_equal(j, t):
    cj, ct = j.counters(), t.counters()
    assert set(ct) == set(cj)
    assert {k: ct[k] for k in COUNTERS} == {k: cj[k] for k in COUNTERS}


def test_rank_term_pruned_escalating_and_k1000(stores):
    """Pruning engaged on both (equal prune_rounds and pruned_tiles), the
    escalating profile's ladder, k = 1000, the rare term."""
    _n, _idx, j, t, ths = stores
    r0 = t.pruned_tiles
    _both(j, t, lambda s: s.rank_term(ths["big"], JProf(), k=25))
    assert t.pruned_tiles > r0 and t.prune_rounds >= 1
    for prof, k in ((JProf(**ESC), 100), (JProf(), 1000),
                    (JProf(authority=15), 10)):
        _both(j, t, lambda s: s.rank_term(ths["big"], prof, k=k))
    _both(j, t, lambda s: s.rank_term(ths["rare"], JProf(), k=50))
    _counters_equal(j, t)


@pytest.mark.parametrize("kw", FILTERS, ids=lambda kw: "-".join(kw))
def test_rank_term_filters(stores, kw):
    _n, _idx, j, t, ths = stores
    got = _both(j, t, lambda s: s.rank_term(ths["big"], JProf(), k=50, **kw))
    assert len(got[0])
    _counters_equal(j, t)


def test_joins_column_local_and_cross_row(stores):
    """Column-local joins (one term row) and cross-row joins (K18; at
    n_term 1 every join is column-local), with and without excludes and
    under a filter, no fallback."""
    _n, _idx, j, t, ths = stores
    fb = t.fallbacks
    cases = [([ths["big"], ths["part"]], []),
             ([ths["big"], ths["part"]], [ths["excl0"]]),
             ([ths["big"], ths["rare"]], []),
             ([ths["big"], ths["rare"]], [ths["excl1"]]),
             ([ths["rare"], ths["part"], ths["part2"]], [ths["excl0"]]),
             ([ths["rare"]], [ths["excl0"], ths["big"]])]
    for inc, exc in cases:
        for kw in ({}, {"lang_filter": EN}):
            got = _both(j, t, lambda s: s.rank_join(inc, exc, JProf(), k=40,
                                                    **kw))
            assert got is not None and len(got[0])
    assert t.fallbacks == fb
    _counters_equal(j, t)


def test_host_mirrors_and_spans_match_jax(stores):
    """The cells' host mirrors (feats16, flags, docids, jdocids, jpos,
    pmax) and every MeshSpan's fields equal the JAX store's."""
    _n, _idx, j, t, _ths = stores
    for cj, ct in zip(j._cells, t._cells):
        cj.materialize()
        ct.materialize()
        for name in ("feats16", "flags", "docids", "jdocids", "jpos",
                     "pmax"):
            np.testing.assert_array_equal(getattr(ct, name),
                                          getattr(cj, name))
        assert (ct.used, ct.jused, ct.tused) == (cj.used, cj.jused, cj.tused)
    assert set(t._packed) == set(j._packed)
    for rid, spans in j._packed.items():
        assert set(t._packed[rid]) == set(spans)
        for th, sj in spans.items():
            st = t._packed[rid][th]
            for name in ("starts", "counts", "jstarts", "tstarts",
                         "tcounts"):
                np.testing.assert_array_equal(getattr(st, name),
                                              getattr(sj, name))
            assert (st.total, st.dead_seq) == (sj.total, sj.dead_seq)
            for name in ("col_min", "col_max", "tf_min", "tf_max"):
                np.testing.assert_array_equal(st.stats[name],
                                              np.asarray(sj.stats[name]))
    assert t.live_rows() == j.live_rows()


def _page(store):
    sb = types.SimpleNamespace(index=types.SimpleNamespace(devstore=store))
    return lookup("DeviceStore_p")({}, ServerObjects(), sb).as_dict()


def test_device_store_page_renders_for_a_port_mesh_store(stores):
    _n, _idx, j, t, _ths = stores
    want, got = _page(j), _page(t)
    assert got == want and list(got) == list(want)
    assert got["kind"] == "MeshSegmentStore"
    rows = {got[f"rows_{i}_key"]: got[f"rows_{i}_value"]
            for i in range(int(got["rows"]))}
    assert int(rows["mesh_cells"]) == N_DEV
    assert int(rows["live_rows"]) == t.live_rows()


def test_shard_bodies_on_the_jax_placement(stores):
    """The port's shard bodies on the JAX store's own arrays
    (convert.mesh_cells_from_numpy of _dev_arrays, _dev_join, _dev_pmax):
    the pruned body at b = 1 and 8, the exact scan under a filter, a
    column-local and a cross-row join; each answer is the JAX store's."""
    n_term, _idx, j, t, ths = stores
    j._topk_cache._d.clear()
    j.rank_term(ths["big"], JProf(), k=16)         # the device sync
    arrays = [np.asarray(a) for a in (*j._dev_arrays, *j._dev_join,
                                      j._dev_pmax)]
    cells = convert.mesh_cells_from_numpy(*arrays, ["cpu"] * N_DEV,
                                          dead=j._dead_host)
    mesh = t.mesh
    prof = TR.RankingProfile()
    consts = [TR.profile_consts(prof, EN, "cpu")] * N_DEV

    def port_span(th):
        sp = j.spans_for(th)[0]
        return TMS.MeshSpan(sp.starts, sp.counts, sp.jstarts, sp.tstarts,
                            sp.tcounts, sp.stats, sp.dead_seq)

    def answer(out, k):
        host = out.numpy()
        kk = (host.shape[-1] - 1) // 2 if host.ndim == 2 else \
            host.shape[0] // 2
        row = host[0] if host.ndim == 2 else host
        s, d = row[:kk], row[kk:2 * kk]
        keep = (d >= 0) & (s > TMS.NEG_INF32)
        return s[keep][:k], d[keep][:k]

    shift, lang_term = TMS.prune_bound_consts(prof)
    for b in (1, 8):
        out = TMS._pruned_cells(mesh, cells, [port_span(ths["big"])], 32, b,
                                shift, lang_term, consts)
        assert int(out[0, -1]) == 1
        s, d = answer(out, 25)
        j._topk_cache._d.clear()
        want = j.rank_term(ths["big"], JProf(), k=25)
        np.testing.assert_array_equal(s, want[0])
        np.testing.assert_array_equal(d, want[1])
    filt = (DE, -1, TMS.DAYS_NONE_LO, TMS.DAYS_NONE_HI)
    out = TMS._scan_cells(mesh, cells, [port_span(ths["big"])], None, filt,
                          64, consts, full=False)
    s, d = answer(out, 50)
    want = j.rank_term(ths["big"], JProf(), k=50, lang_filter=DE)
    np.testing.assert_array_equal(s, want[0])
    np.testing.assert_array_equal(d, want[1])
    for inc, exc in (([ths["big"], ths["part"]], [ths["excl0"]]),
                     ([ths["big"], ths["rare"]], [ths["excl1"]])):
        spans = [port_span(th) for th in inc + exc]
        rare_i = min(range(len(inc)), key=lambda i: spans[i].total)
        others = [sp for i, sp in enumerate(spans) if i != rare_i]
        rows = {TMS.term_shard(th, n_term) for th in inc + exc}
        if len(rows) > 1:
            parts = t._xjoin_parts(cells, spans[rare_i],
                                   TMS.term_shard(inc[rare_i], n_term),
                                   others, len(inc) - 1, None)
        else:
            parts = t._join_parts(cells, spans[rare_i], others,
                                  len(inc) - 1, None)
        s, d = answer(TMS._join_score_cells(mesh, parts, 64, consts), 40)
        want = j.rank_join(inc, exc, JProf(), k=40)
        np.testing.assert_array_equal(s, np.asarray(want[0]))
        np.testing.assert_array_equal(d, np.asarray(want[1]))


def test_batched_equals_solo_and_batches(stores, monkeypatch):
    """8 concurrent pruned queries through the port's batcher: each the
    JAX store's solo answer, fewer dispatches than queries, no timeout
    or exception (the watchdog widened: a wave of plain versions on a
    loaded CPU can outlast 2 s)."""
    _n, _idx, j, t, ths = stores
    monkeypatch.setattr(TMS._MeshQueryBatcher, "WATCHDOG_S", 60.0)
    terms = [ths["big"], ths["part"], ths["part2"], ths["rare"]]
    prof = JProf()
    solo = {}
    for th in terms:
        j._topk_cache._d.clear()
        solo[th] = j.rank_term(th, prof, k=10)
    t.enable_batching(max_batch=8)
    t._topk_cache.enabled = False
    try:
        d0 = t._batcher.dispatches
        got, errors = {}, []

        def worker(i, th):
            try:
                got[i] = (th, t.rank_term(th, prof, k=10))
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(e)
        ts = [threading.Thread(target=worker, args=(i, th))
              for i, th in enumerate(terms * 2)]
        for x in ts:
            x.start()
        for x in ts:
            x.join()
        assert not errors and len(got) == len(ts)
        for th, res in got.values():
            np.testing.assert_array_equal(res[0], solo[th][0])
            np.testing.assert_array_equal(res[1], solo[th][1])
        n = t._batcher.dispatches - d0
        assert 1 <= n < len(ts)
        c = t.counters()
        assert c["batch_timeouts"] == 0 and c["batch_exceptions"] == 0
    finally:
        t._topk_cache.enabled = True
        t.close()
        t.rwi.listener = KB.Fanout(j, t)


def test_delta_tombstones_merge_and_repack():
    """A RAM delta (the exact scan with the delta on every cell and the
    host dedup), tombstones (pruning declined), a second run (two spans),
    merge and repack: every answer and counter the JAX store's."""
    n_term = 2
    idx, j, t = _pair(n_term)
    try:
        ths = _corpus(idx, n_term, seed=11, big=90_000)
        big = ths["big"]
        prof = JProf()
        _both(j, t, lambda s: s.rank_term(big, prof, k=25))
        rng = np.random.default_rng(12)
        old = idx.get(big).docids
        extra = np.concatenate([old[:50], np.arange(3_000_000, 3_000_450,
                                                    dtype=np.int32)])
        idx.add_many(big, JP.PostingsList(extra, _feats(rng, len(extra))))
        for kw in ({}, {"lang_filter": DE}):
            _both(j, t, lambda s: s.rank_term(big, prof, k=25, **kw))
        got = _both(j, t, lambda s: s.rank_term(big, prof, k=5))
        for dd in got[1][:3].tolist():
            idx.delete_doc(int(dd))
        r0 = t.prune_rounds
        after = _both(j, t, lambda s: s.rank_term(big, prof, k=25))
        assert not set(got[1][:3].tolist()) & set(after[1].tolist())
        idx.flush()
        _both(j, t, lambda s: s.rank_term(big, prof, k=25))
        assert t.prune_rounds == r0          # two spans: no pruning
        _both(j, t, lambda s: s.rank_join([big, ths["part"]], [], prof,
                                          k=20))   # two spans: declined
        assert idx.merge_runs(max_runs=1)
        _both(j, t, lambda s: s.rank_term(big, prof, k=25))
        j.repack()
        t.repack()
        _both(j, t, lambda s: s.rank_term(big, prof, k=25))
        _both(j, t, lambda s: s.rank_join([big, ths["rare"]], [], prof,
                                          k=20))
        assert t.live_rows() == j.live_rows()
        _counters_equal(j, t)
    finally:
        j.close()
        t.close()


def test_fallbacks_and_counters():
    """The declines, counted as in the JAX store: a join with a RAM delta,
    a run past the budget (skipped: its terms answer None), an exclude
    term that is not packed; every counters() key, equal values."""
    idx, j, t = _pair(2, budget_bytes=64 << 20)
    try:
        ths = _corpus(idx, 2, seed=13, big=60_000)
        prof = JProf()
        rng = np.random.default_rng(14)
        idx.add_many(ths["part"], JP.PostingsList(
            np.arange(5_000_000, 5_000_100, dtype=np.int32),
            _feats(rng, 100)))
        assert _both(j, t, lambda s: s.rank_join(
            [ths["big"], ths["part"]], [], prof, k=10)) is None
        idx.flush()
        # a run too big for the budget: skipped by both stores
        idx.ingest_run({word2hash("toobig"): JP.PostingsList(
            np.arange(600_000, dtype=np.int32), _feats(rng, 600_000))})
        assert _both(j, t, lambda s: s.rank_term(
            word2hash("toobig"), prof, k=10)) is None
        assert _both(j, t, lambda s: s.rank_join(
            [ths["big"], ths["rare"]], [word2hash("toobig")], prof,
            k=10)) is None
        assert t.fallbacks == j.fallbacks >= 3
        assert set(t.counters()) == set(j.counters())
        _counters_equal(j, t)
    finally:
        j.close()
        t.close()


def test_device_loss_and_rebuild_match_jax():
    """The mesh's device-loss ladder under one `device.transfer_fail`
    schedule, the JAX store under its package's fault point and the port's
    under its own: a transient failure retried, then a streak that
    declares the mesh lost (queries answer None, counted), the rebuild
    from the host mirrors, and the answers after it equal to those
    before; every device_lost* / transfer_* counter equal."""
    from yacy_search_server_tpu.utils import faultinject as jfault
    from yacy_search_server_tpu_torch.utils import faultinject as tfault
    loss = ("device_lost", "device_losses", "device_loss_recoveries",
            "device_lost_queries", "transfer_failures", "transfer_retries",
            "fallbacks")
    rng = np.random.default_rng(21)
    th = word2hash("lossterm")
    got = {}
    for name, cls, fault, kw in (
            ("jax", JMS.MeshSegmentStore, jfault,
             {"devices": _devices()}),
            ("port", TMS.MeshSegmentStore, tfault,
             {"devices": ["cpu"] * N_DEV})):
        rng = np.random.default_rng(21)
        idx = JRWI()
        idx.ingest_run({th: JP.PostingsList(
            np.arange(40_000, dtype=np.int32), _feats(rng, 40_000))})
        s = cls(idx, n_term=2, **kw)
        s._topk_cache.enabled = False
        s.rebuild_backoff_s = 0.05
        fault.clear()
        try:
            before = s.rank_term(th, JProf(), k=20)
            fault.set_fault("device.transfer_fail", 1)
            transient = s.rank_term(th, JProf(), k=20)
            fault.set_fault("device.transfer_fail",
                            2 * (s.transfer_retry_limit + 1))
            lost = [s.rank_term(th, JProf(), k=20) for _ in range(3)]
            lost_join = s.rank_join([th], [word2hash("nothing")], JProf(),
                                    k=20)
            state = {k: s.counters()[k] for k in loss}
            fault.clear()
            t0 = time.time()
            while s.device_lost and time.time() - t0 < 30:
                time.sleep(0.02)
            after = s.rank_term(th, JProf(), k=20)
            got[name] = (before, transient, lost, lost_join, state,
                         {k: s.counters()[k] for k in loss}, after)
        finally:
            fault.clear()
            s.close()
    j, t = got["jax"], got["port"]
    for a, b in ((j[0], t[0]), (j[1], t[1]), (j[6], t[6])):
        np.testing.assert_array_equal(b[0], np.asarray(a[0]))
        np.testing.assert_array_equal(b[1], np.asarray(a[1]))
    np.testing.assert_array_equal(t[6][1], t[0][1])
    assert [x is None for x in t[2]] == [x is None for x in j[2]]
    assert (t[3] is None) == (j[3] is None)
    assert t[4] == j[4] and t[4]["device_lost"] == 1
    assert t[5] == j[5] and t[5]["device_loss_recoveries"] == 1
