"""The port's dense-first IVF ANN (ops/ann.py, index/annstore.py, the
store's `dense_first_topk` and the batcher's `ann` kind) against the JAX
package's, on the CPU: tests/test_ann.py's cases.

The two packages build the same index from the same source and seed (the
build is numpy in both), and `convert.ann_from_numpy` carries a JAX index
over. K14's plain version gives the JAX assignment kernel's centroid ids;
K15's gives the JAX fuse kernel's candidates with each fused score within
64 units (the JAX package's own bar for its kernel against its oracle:
the two sum the bf16 dot in different orders), equal to the bit where
each dot has one nonzero product. The host paths (`search_host`,
`plan`, `host_score_parts`, `merge_fused`) are numpy in both and equal to
the bit. Within the port, solo and batched answers are equal to the bit.
The vectors are DIM = 256 wide: the port's dot kernels take no other
width.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax

from yacy_search_server_tpu.index import devstore as JDS
from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.index.annstore import AnnVectorIndex as JAnn
from yacy_search_server_tpu.index.rwi import RWIIndex as JRWI
from yacy_search_server_tpu.ops import ann as JA
from yacy_search_server_tpu_torch import convert
from yacy_search_server_tpu_torch.index import devstore as TDS
from yacy_search_server_tpu_torch.index.annstore import AnnVectorIndex as TAnn
from yacy_search_server_tpu_torch.kernels import ann as KA
from yacy_search_server_tpu_torch.kernels import bench as KB
from yacy_search_server_tpu_torch.ops import ann as TA
from yacy_search_server_tpu_torch.utils import faultinject

TH = b"denseterm0AB"
DIM = 256
TOL = 64


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.clear()
    yield
    faultinject.clear()


def _clustered(rng, n, dim, n_clusters, noise=0.15):
    """tests/test_ann.py's corpus: unit vectors around random centres."""
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    lab = rng.integers(0, n_clusters, n)
    v = centers[lab] + noise * rng.standard_normal((n, dim)) \
        .astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), centers


def _build(cls, vecs, C, budget, **kw):
    ix = cls(vecs.shape[1], device_budget_bytes=budget, **kw)
    ix.build(lambda a, b: vecs[a:b], len(vecs), n_clusters=C,
             sample_n=2048, iters=2, seed=3)
    return ix


def _pair_index(vecs, C, budget):
    return (_build(JAnn, vecs, C, budget),
            _build(TAnn, vecs, C, budget, device="cpu"))


def _layout(ix):
    return [np.asarray(a) for a in (
        ix.centroids, ix._slab, ix._scales, ix._sdocids, ix._cstart,
        ix._ccount, ix._row_of, ix._hot_slab, ix._hot_scales,
        ix._hot_docids)] + [ix._hot_map, ix._hot_used, ix._hot_cap]


def _same_layout(a, b):
    for x, y in zip(_layout(a), _layout(b)):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


def _jax_arrays(j):
    return (j.centroids, j._slab, j._scales, j._sdocids, j._cstart,
            j._ccount, j._row_of, j._hot_slab, j._hot_scales, j._hot_docids,
            j._hot_map)


def _close(label, got, want, tol=TOL):
    gs, gd = (np.asarray(a) for a in got)
    ws, wd = (np.asarray(a) for a in want)
    assert sorted(gd.tolist()) == sorted(wd.tolist()), label
    w = dict(zip(wd.tolist(), ws.tolist()))
    worst = max((abs(int(s) - w[d]) for s, d in zip(gs.tolist(),
                                                     gd.tolist())), default=0)
    assert worst <= tol, f"{label}: largest |delta| {worst}"


def _same(a, b):
    return (np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
            and np.array_equal(np.asarray(a[1]), np.asarray(b[1])))


def _ordered(scores, docids):
    s = np.asarray(scores, np.int64)
    d = np.asarray(docids, np.int64)
    assert np.all(s[:-1] >= s[1:])
    same = s[:-1] == s[1:]
    assert np.all(d[:-1][same] < d[1:][same])
    assert len(set(d.tolist())) == len(d)


# -- the build ----------------------------------------------------------------

@pytest.mark.parametrize("dim", [64, DIM])
@pytest.mark.parametrize("budget", [1 << 22, 40_000])
def test_build_equals_jax_build(dim, budget):
    """The same source and seed: every array of the layout, the hot
    mirror and its cluster map equal to the bit, at a budget that holds
    every cluster and one that holds a few."""
    vecs, _ = _clustered(np.random.default_rng(0), 3000, dim, 12)
    j, t = _pair_index(vecs, 12, budget)
    _same_layout(j, t)
    assert t.centroid_version == j.centroid_version == 1
    assert (len(t._hot_map) < 12) == (budget < (1 << 22))
    t.build(lambda a, b: vecs[a:b], len(vecs), n_clusters=12,
            sample_n=2048, iters=2, seed=3)
    assert t.centroid_version == 2


def test_build_from_dense_equals_jax():
    from yacy_search_server_tpu.index.dense import DenseVectorStore as JD
    vecs, _ = _clustered(np.random.default_rng(1), 2500, DIM, 8)
    jd = JD(dim=DIM)
    for i, v in enumerate(vecs):
        jd.put(i, v)
    td = convert.dense_from_numpy(jd._vecs, len(jd), device="cpu")
    j = JAnn(DIM, device_budget_bytes=1 << 22)
    t = TAnn(DIM, device="cpu", device_budget_bytes=1 << 22)
    j.build_from_dense(jd, n_clusters=8, sample_n=1024, iters=2, seed=5)
    t.build_from_dense(td, n_clusters=8, sample_n=1024, iters=2, seed=5)
    _same_layout(j, t)


def test_ann_from_numpy_carries_the_layout():
    vecs, _ = _clustered(np.random.default_rng(2), 3000, DIM, 12)
    j = _build(JAnn, vecs, 12, 400_000)
    t = convert.ann_from_numpy(*_jax_arrays(j), device="cpu",
                               device_budget_bytes=400_000)
    _same_layout(j, t)
    with pytest.raises(ValueError, match="budget"):
        convert.ann_from_numpy(*_jax_arrays(j), device="cpu")


@pytest.mark.parametrize("hot_limit", [None, 0, 900])
def test_plan_equals_jax_plan(hot_limit):
    """The port's plan (its sparse candidates in array form) gives the
    JAX loop's lanes to the bit: hot rows, host clusters, the promotion
    list, and the sparse lanes split hot / host, in order, on a half hot
    index: docids with a hot vector, a warm one, none, negative and past
    the corpus, repeated, before and after the device arena exists."""
    vecs, _ = _clustered(np.random.default_rng(12), 3000, DIM, 12)
    j, t = _pair_index(vecs, 12, 1500 * (DIM + 6))
    rng = np.random.default_rng(13)
    for with_arena in (False, True):
        if with_arena:
            j.hot_block(jax.devices()[0])
            t.hot_block()
        for q in range(6):
            cids = rng.permutation(12)[:5].tolist() + [-1, 99]
            sd = np.concatenate([rng.integers(-5, 3300, 40),
                                 [0, 0, 2999, 1 << 20]]).astype(np.int32)
            ss = rng.integers(0, 1 << 24, len(sd)).astype(np.int32)
            pj = j.plan(cids, sd, ss, 1 << 15, hot_limit=hot_limit)
            pt = t.plan(cids, sd, ss, 1 << 15, hot_limit=hot_limit)
            assert np.array_equal(pj["hot_rows"], pt["hot_rows"])
            assert pj["host_cids"] == pt["host_cids"]
            assert pj["promote"] == pt["promote"]
            for key in ("sp_hot", "sp_host"):
                for a, b in zip(pj[key], pt[key]):
                    assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert t.counters() == j.counters()


# -- K14 ann_assign -----------------------------------------------------------

def test_assign_plain_matches_jax_kernel():
    """Clustered queries, an anti-aligned one (every real similarity
    negative: the pad rows' mask decides), nprobe at C (np_ = C) and
    C not a power of two (pad rows in the block)."""
    vecs, centers = _clustered(np.random.default_rng(3), 6000, DIM, 12)
    j, t = _pair_index(vecs, 12, 1 << 22)
    jc = j.centroid_block(jax.devices()[0])
    tc, _ev = t.centroid_block()
    assert tc.shape == (16, DIM) and np.array_equal(np.asarray(jc),
                                                    tc.numpy())
    qv = np.stack([vecs[5], vecs[4321], vecs[77], -centers[3],
                   -vecs[9]]).astype(np.float32)
    for np_ in (1, 4, 12):
        want = np.asarray(JA._ann_assign_batch_kernel(
            jc, jax.device_put(qv), np_=np_, c_real=12))
        got = TA.ann_assign_batch(tc, qv, np_, 12).numpy()
        assert np.array_equal(got, want), np_
        assert (got < 12).all()
    # the host oracle (f32 centroids straight to bf16) equals the JAX one
    assert np.array_equal(TA.ann_assign_np(t.centroids, qv, 12),
                          JA.ann_assign_np(j.centroids, qv, 12))


def test_assign_ties_by_centroid_id():
    cent = np.zeros((16, DIM), np.float16)
    cent[:5, 0] = 1.0           # five equal centroids, then zero rows
    qv = np.zeros((2, DIM), np.float32)
    qv[0, 0] = 1.0
    got = KA.ann_assign_plain(torch.from_numpy(cent),
                              torch.from_numpy(qv), 8, 7).numpy()
    want = np.asarray(JA._ann_assign_batch_kernel(
        jax.device_put(cent), jax.device_put(qv), np_=8, c_real=7))
    assert np.array_equal(got, want)
    assert got[0].tolist()[:5] == [0, 1, 2, 3, 4]
    assert 7 not in got.tolist() and got[0, 5:7].tolist() == [5, 6]
    # every device function of the family has its numpy oracle
    assert {TA.ANN_ORACLES[n] for n in ("ann_assign_batch",
                                       "ann_fuse_batch_packed")} == \
        {TA.ann_assign_np, TA.ann_fuse_np}


# -- K15 ann_fuse -------------------------------------------------------------

def _fuse_both(hb, jhb, rows, dd, sp, q, alpha, nb, k, bs=2):
    qrow = TA.pack_ann_fuse_row(q, rows, dd, sp, alpha, nb)
    qi = np.zeros((bs, len(qrow)), np.int32)
    qi[0] = qrow
    want = np.asarray(JA._ann_fuse_batch_packed_kernel(
        *jhb, jax.device_put(qi), nb=nb, bs=bs, k=k))
    got = TA.ann_fuse_batch_packed(*hb, qi, nb, k).numpy()
    return got, want


def test_fuse_plain_matches_jax_kernel():
    """Probe lanes of four clusters and sparse lanes (with a hot vector,
    without any, and one that is also a probe lane): the same candidate
    set as the JAX kernel, each fused score within 64 units, pad lanes
    docid INT32_MAX in both."""
    vecs, _ = _clustered(np.random.default_rng(4), 6000, DIM, 16)
    j, t = _pair_index(vecs, 16, 1 << 22)
    jhb, _ = j.hot_block(jax.devices()[0])
    hb, _used, _ev = t.hot_block()
    q = vecs[123]
    cids = t.assign_host(q, 4)[0]
    plan = t.plan(cids, [5, 7, 1 << 20], [100, 200, 300], lanes_budget=8192)
    rows = np.concatenate([plan["sp_hot"][0], plan["hot_rows"]])
    dd = np.concatenate([plan["sp_hot"][1],
                         np.full(len(plan["hot_rows"]), -1, np.int32)])
    sp = np.concatenate([plan["sp_hot"][2],
                         np.zeros(len(plan["hot_rows"]), np.int32)])
    nb = TA.ann_lane_bucket(len(rows), 1 << 15)
    for k in (16, nb):
        got, want = _fuse_both(hb, jhb, rows, dd, sp, q, 0.5, nb, k)
        for out in (got, want):
            assert (out[1, k:] == KA.INT32_MAX).all()
            assert (out[1, :k] == KA.NEG).all()
        real = want[0, k:] != KA.INT32_MAX
        assert np.array_equal(got[0, k:] != KA.INT32_MAX, real)
        _close(f"k={k}", (got[0, :k][real], got[0, k:][real]),
               (want[0, :k][real], want[0, k:][real]))
        # the oracle over the same lanes, within the bar, and the sparse
        # lane without a vector scores sparse + 0
        es, ed = TA.ann_fuse_np(t._hot_slab, t._hot_scales, t._hot_docids,
                                rows, dd, sp, q, 0.5, k)
        _close(f"k={k} vs the oracle", (got[0, :k][real], got[0, k:][real]),
               (es, ed))
    i = got[0, nb:].tolist().index(1 << 20)
    assert got[0, i] == 300


def _onehot_index(n=600, budget=1 << 22):
    """Vectors with one nonzero element: every dot is one exact product."""
    rng = np.random.default_rng(6)
    vecs = np.zeros((n, DIM), np.float32)
    vecs[np.arange(n), rng.integers(0, DIM, n)] = rng.choice([-1.0, 1.0], n)
    return vecs, _pair_index(vecs, 4, budget)


def test_fuse_onehot_bit_identical_to_jax():
    vecs, (j, t) = _onehot_index()
    jhb, _ = j.hot_block(jax.devices()[0])
    hb, used, _ev = t.hot_block()
    q = np.random.default_rng(7).standard_normal(DIM).astype(np.float32)
    rows = np.arange(used, dtype=np.int32)
    nb = TA.ann_lane_bucket(len(rows) + 2, 1 << 15)
    rows = np.concatenate([[3, -1], rows]).astype(np.int32)
    dd = np.concatenate([[t._hot_docids[3], 99_999],
                         np.full(used, -1)]).astype(np.int32)
    sp = np.concatenate([[12345, 777], np.zeros(used)]).astype(np.int32)
    for alpha in (0.0, 0.5, 1.0):
        got, want = _fuse_both(hb, jhb, rows, dd, sp, q, alpha, nb, nb)
        assert np.array_equal(got, want), alpha


def test_fuse_docid_tie_order_and_pad_lanes():
    """Identical vectors, equal sparse scores: equal fused scores ordered
    by docid ASC, in both; a slot of pad lanes only."""
    v = np.zeros((8, DIM), np.float32)
    v[:, 0] = 1.0
    j = JAnn(DIM, device_budget_bytes=1 << 20)
    t = TAnn(DIM, device="cpu", device_budget_bytes=1 << 20)
    for ix in (j, t):
        ix.build(lambda a, b: v[a:b], 8, n_clusters=1, sample_n=8, iters=1,
                 seed=0)
    jhb, _ = j.hot_block(jax.devices()[0])
    hb, _used, _ev = t.hot_block()
    rows = np.arange(8, dtype=np.int32)[::-1].copy()
    got, want = _fuse_both(hb, jhb, rows, np.full(8, -1, np.int32),
                           np.zeros(8, np.int32), v[0], 1.0, 256, 16, bs=3)
    assert np.array_equal(got, want)
    assert len(set(got[0, :8].tolist())) == 1
    assert got[0, 16:24].tolist() == sorted(got[0, 16:24].tolist())
    assert (got[1:, 16:] == KA.INT32_MAX).all()


def test_fuse_plain_wide_buckets():
    """nb past 16384 (the card sorts in chunks there): the plain version
    still equals the numpy oracle's order on the valid lanes."""
    vecs, _ = _clustered(np.random.default_rng(8), 40_000, DIM, 4)
    t = _build(TAnn, vecs, 4, 1 << 24, device="cpu")
    hb, used, _ev = t.hot_block()
    rows = np.arange(min(used, 20_000), dtype=np.int32)
    nb = TA.ann_lane_bucket(len(rows), 1 << 15)
    assert nb == 32768
    q = vecs[11]
    qi = TA.pack_ann_fuse_row(q, rows, np.full(len(rows), -1, np.int32),
                              np.zeros(len(rows), np.int32), 0.5, nb)[None]
    got = TA.ann_fuse_batch_packed(*hb, qi, nb, 64).numpy()
    es, ed = TA.ann_fuse_np(t._hot_slab, t._hot_scales, t._hot_docids, rows,
                            np.full(len(rows), -1), np.zeros(len(rows)), q,
                            0.5, 64)
    _close("nb=32768", (got[0, :64], got[0, 64:]), (es, ed))


# -- the store: dense_first_topk ----------------------------------------------

def _plist(rng, n):
    docids = np.arange(n, dtype=np.int32)
    feats = rng.integers(0, 1000, (n, JP.NF)).astype(np.int32)
    feats[:, JP.F_FLAGS] = rng.integers(0, 2 ** 20, n)
    feats[:, JP.F_DOMLENGTH] = rng.integers(0, 256, n)
    feats[:, JP.F_LANGUAGE] = JP.pack_language("en")
    return JP.PostingsList(docids, feats)


class Stores:
    """A JAX store and a port store over one RWI, each with its own index
    of the same layout (built from the same source and seed)."""

    def __init__(self, n=3000, C=16, budget=1 << 22, max_batch=4,
                 batching=True):
        self.idx = JRWI()
        self.idx.add_many(TH, _plist(np.random.default_rng(0), n))
        self.idx.flush()
        self.j = JDS.DeviceSegmentStore(self.idx)
        self.t = TDS.DeviceSegmentStore(self.idx, device="cpu")
        self.idx.listener = KB.Fanout(self.j, self.t)
        self.vecs, self.centers = _clustered(np.random.default_rng(1), n,
                                             DIM, C)
        self.ja, self.ta = _pair_index(self.vecs, C, budget)
        self.j.attach_ann(self.ja)
        self.t.attach_ann(self.ta)
        if batching:
            self.j.enable_batching(max_batch=max_batch, dispatchers=2,
                                   prewarm=False)
            self.t.enable_batching(max_batch=max_batch, dispatchers=2)
            # the plain waves of a loaded CPU outlast the 1 s watchdog
            self.t._batcher.WATCHDOG_S = 60.0

    def close(self):
        self.j.close()
        self.t.close()


def _queries(st, n_q, rng):
    """(qvec, sparse scores, sparse docids) of dense-first queries: the
    corpus's own vectors, sparse candidates with and without a vector."""
    qs = []
    for _ in range(n_q):
        q = st.vecs[int(rng.integers(0, len(st.vecs)))]
        m = int(rng.integers(0, 12))
        sd = rng.choice(4000, size=m, replace=False).astype(np.int32)
        ss = rng.integers(0, 1 << 24, m).astype(np.int32)
        qs.append((q, ss, sd))
    return qs


def test_dense_first_matches_jax_solo_and_batched():
    """Solo (no batcher) and from 16 threads through the batcher: the
    port's answers equal each other to the bit, and the JAX store's
    within the bar."""
    solo = Stores(batching=False)
    st = Stores(max_batch=8)
    try:
        qs = _queries(st, 16, np.random.default_rng(3))
        want = [solo.t.dense_first_topk(*q, 0.7, 25) for q in qs]
        jax_ans = [solo.j.dense_first_topk(*q, 0.7, 25) for q in qs]
        out = [None] * len(qs)

        def worker(i):
            out[i] = st.t.dense_first_topk(*qs[i], 0.7, 25)
        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(len(qs))]
        for th in ts:
            th.start()
        for th in ts:
            th.join()
        for i in range(len(qs)):
            assert _same(out[i], want[i]), i
            _ordered(*out[i])
            _close(f"query {i}", out[i], jax_ans[i])
        c, cs = st.t.counters(), solo.t.counters()
        assert c["ann_queries"] == cs["ann_queries"] == len(qs)
        assert 1 <= c["ann_dispatches"] <= len(qs)
        assert cs["ann_dispatches"] == len(qs)
        assert c["batch_timeouts"] == 0 and c["batch_exceptions"] == 0
        assert c["ann_fallbacks"] == c["ann_host_queries"] == 0
        jc = solo.j.counters()
        for key in ("ann_tier_hot_hits", "ann_tier_warm_hits",
                    "ann_lane_drops", "ann_clusters", "ann_vectors",
                    "ann_hot_bytes"):
            assert cs[key] == jc[key], key
    finally:
        solo.close()
        st.close()


def test_sparse_candidate_without_vector_rides_at_sparse_plus_zero():
    st = Stores(n=500, C=4, batching=False)
    try:
        sd = np.array([499, 1 << 20], np.int32)
        ss = np.array([5, 2 ** 27], np.int32)
        for s in (st.j, st.t):
            sc, d = s.dense_first_topk(st.vecs[10], ss, sd, 0.5, 10)
            i = d.tolist().index(1 << 20)
            assert sc[i] == 2 ** 27
    finally:
        st.close()


def test_warm_clusters_promote_through_the_batcher():
    """A hot arena for about half the corpus: warm probes score on the
    host (equal to the JAX store's host scoring), a twice-probed cluster
    promotes through the batcher's `promote` kind and then serves on the
    device; the answers before and after equal the JAX store's within the
    bar, and the centroid version bumps."""
    n = 4000
    st = Stores(n=n, C=16, budget=(n // 2) * (DIM + 6), max_batch=4)
    try:
        t, ta = st.t, st.ta
        assert len(ta._hot_map) < 16
        cold = max(ta._hot_map) + 1
        q = np.asarray(ta.centroids[cold], np.float32)
        v0 = t.ann_centroid_version()
        first = t.dense_first_topk(q, [], [], 1.0, 10, nprobe=2)
        jfirst = st.j.dense_first_topk(q, [], [], 1.0, 10, nprobe=2)
        _close("warm", first, jfirst)
        for _ in range(3):
            t.dense_first_topk(q, [], [], 1.0, 10, nprobe=2)
            time.sleep(0.05)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and ta.promotions == 0:
            time.sleep(0.05)
        c = t.counters()
        assert c["ann_tier_warm_hits"] > 0 and c["ann_promotions"] >= 1
        assert c["tier_promote_async"] >= 1
        assert cold in ta._hot_map and t.ann_centroid_version() > v0
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and ta._hot_pending:
            time.sleep(0.05)
        hot0 = t.counters()["ann_tier_hot_hits"]
        after = t.dense_first_topk(q, [], [], 1.0, 10, nprobe=2)
        assert t.counters()["ann_tier_hot_hits"] > hot0
        _close("after the promotion", after, jfirst)
        assert ta.patches >= 1
    finally:
        st.close()


def test_lane_budget_drops_whole_clusters_counted():
    st = Stores(n=3000, C=4, batching=False)
    try:
        for s in (st.j, st.t):
            s.ann_probe_lanes = 16
        got = st.t.dense_first_topk(st.vecs[0], [1000], [7], 0.5, 10)
        want = st.j.dense_first_topk(st.vecs[0], [1000], [7], 0.5, 10)
        assert _same(got, want) and 7 in got[1].tolist()
        assert st.t.counters()["ann_lane_drops"] >= 1
        assert st.t.counters()["ann_lane_drops"] == \
            st.j.counters()["ann_lane_drops"]
    finally:
        st.close()


def test_device_loss_answers_on_the_host_like_jax(monkeypatch):
    """Every transfer failing: the query's fetch fails, the loss is
    declared, and both stores answer through search_host, equal to the
    bit to each other and to the numpy path."""
    st = Stores(batching=False)
    try:
        monkeypatch.setattr(TDS, "TRANSFER_RETRIES", 0)
        monkeypatch.setattr(TDS, "LOSS_STREAK", 1)
        monkeypatch.setattr(TDS, "REBUILD_BACKOFF_S", 60.0)
        st.j.transfer_retry_limit = 0
        st.j.loss_streak = 1
        q = st.vecs[50]
        want = st.ta.search_host(q, [3, 9], [10, 20], 0.8, 10, nprobe=8,
                                 lanes_budget=st.t.ann_probe_lanes)
        assert _same(want, st.ja.search_host(
            q, [3, 9], [10, 20], 0.8, 10, nprobe=8,
            lanes_budget=st.j.ann_probe_lanes))
        faultinject.set_fault("device.transfer_fail", 500)
        from yacy_search_server_tpu.utils import faultinject as jfi
        jfi.set_fault("device.transfer_fail", 500)
        try:
            for _ in range(2):
                got = st.t.dense_first_topk(q, [10, 20], [3, 9], 0.8, 10)
                jgot = st.j.dense_first_topk(q, [10, 20], [3, 9], 0.8, 10)
                assert _same(got, want) and _same(jgot, want)
        finally:
            jfi.clear()
        c = st.t.counters()
        assert st.t.device_lost and c["device_losses"] == 1
        assert c["ann_host_queries"] == 2 and c["ann_queries"] == 2
        assert c["transfer_failures"] == 1
    finally:
        st.close()


def test_no_index_returns_none_counted():
    idx = JRWI()
    idx.add_many(TH, _plist(np.random.default_rng(0), 500))
    idx.flush()
    t = TDS.DeviceSegmentStore(idx, device="cpu")
    assert t.dense_first_topk(np.zeros(DIM, np.float32), [1], [1], 0.5,
                              10) is None
    c = t.counters()
    assert c["ann_fallbacks"] == 1 and c["ann_centroid_version"] == 0
    assert t.ann_centroid_version() == -1
    t.attach_ann(TAnn(DIM, device="cpu"))       # attached, not built
    assert t.dense_first_topk(np.zeros(DIM, np.float32), [1], [1], 0.5,
                              10) is None
    assert t.counters()["ann_fallbacks"] == 2
    t.close()


def test_dense_first_cache_keys_on_the_centroid_version():
    from yacy_search_server_tpu.ops.ranking import RankingProfile
    st = Stores(batching=False)
    try:
        t, prof = st.t, RankingProfile()
        s, d = t.dense_first_topk(st.vecs[3], [], [], 0.5, 10)

        def put():
            t.hybrid_cache_put(TH, prof, "en", 10, 0.5, t.arena_epoch, s, d,
                               10, dense_first=True,
                               cv0=t.ann_centroid_version())

        def get():
            return t.hybrid_cache_get(TH, prof, "en", 10, 0.5,
                                      dense_first=True)
        put()
        hit = get()
        assert hit is not None and _same(hit[:2], (s, d))
        assert t.hybrid_cache_get(TH, prof, "en", 10, 0.5) is None
        assert t._hybrid_cache_key(TH, prof, "en", 10, 0.5, dv=3,
                                   dense_first=True, cv=2) == \
            st.j._hybrid_cache_key(TH, prof, "en", 10, 0.5, dv=3,
                                   dense_first=True, cv=2)
        # a rebuild re-keys
        st.ta.build(lambda a, b: st.vecs[a:b], len(st.vecs), n_clusters=16,
                    sample_n=2048, iters=2, seed=3)
        assert get() is None
        # a promotion re-keys
        put()
        assert get() is not None
        with st.ta._lock:
            st.ta.centroid_version += 1     # what promote_cluster does
        assert get() is None
    finally:
        st.close()


# -- end to end: SearchEvent --------------------------------------------------

def _hybrid_segment(port: bool):
    """tests/test_ann.py's segment: 24 docs on the term, 24 off it, and one
    doc the term index cannot reach that shares the query's features."""
    from yacy_search_server_tpu.document.document import Document
    from yacy_search_server_tpu.index.segment import Segment
    seg = Segment()
    for i in range(24):
        seg.store_document(Document(
            url=f"http://on{i}.test/", title=f"fast kernels {i}",
            text="fast kernels device ranking " * 6 + f"doc {i}"))
    seg.store_document(Document(
        url="http://recover.test/", title="rapid kernel device ranking",
        text="rapid kernel compute kernelized device ranking " * 6))
    for i in range(24):
        seg.store_document(Document(
            url=f"http://off{i}.test/", title=f"gardening {i}",
            text="tomato gardening spring weather soil " * 6 + str(i)))
    seg.rwi.flush()
    if not port:
        seg.enable_device_serving()
        seg.devstore.enable_batching(max_batch=4, dispatchers=2,
                                     prewarm=False)
        seg.devstore.small_rank_n = 0
        seg.build_ann_index(n_clusters=4, sample_n=1024, iters=2)
        return seg
    store = TDS.DeviceSegmentStore(seg.rwi, device="cpu")
    store.enable_batching(max_batch=4, dispatchers=2)
    store._batcher.WATCHDOG_S = 60.0
    store.small_rank_n = 0
    dense = convert.dense_from_numpy(seg.dense._vecs, len(seg.dense),
                                     device="cpu")
    ann = TAnn(DIM, device="cpu")
    ann.build_from_dense(dense, n_clusters=4, sample_n=1024, iters=2)
    # the JAX dense store goes back before close (the port's has none)
    seg.jax_dense = seg.dense
    seg.devstore, seg.dense, seg.ann = store, dense, ann
    store.attach_dense(dense)
    store.attach_ann(ann)
    return seg


def test_searchevent_dense_first_page_matches_jax(monkeypatch):
    from yacy_search_server_tpu.ops import ranking
    from yacy_search_server_tpu.search.query import QueryParams
    from yacy_search_server_tpu.search.searchevent import SearchEvent
    monkeypatch.setattr(ranking, "SMALL_RANK_N", 0)

    def page(seg, df=True):
        q = QueryParams.parse("kernels")
        q.hybrid = True
        q.dense_first = df
        q.hybrid_alpha = 0.9
        return [(r.url, r.score) for r in SearchEvent(q, seg).results(
            count=30)]

    jseg, tseg = _hybrid_segment(False), _hybrid_segment(True)
    try:
        _same_layout(jseg.ann, tseg.ann)
        want, got = page(jseg), page(tseg)
        assert "http://recover.test/" in [u for u, _ in got]
        assert "http://recover.test/" not in [u for u, _ in page(tseg,
                                                                  False)]
        assert sorted(u for u, _ in got) == sorted(u for u, _ in want)
        w = dict(want)
        assert max(abs(s - w[u]) for u, s in got) <= TOL
        c = tseg.devstore.counters()
        assert c["ann_queries"] == 1 and c["ann_fallbacks"] == 0
        # the repeat: from the hybrid cache, no probe
        assert page(tseg) == got
        c1 = tseg.devstore.counters()
        assert c1["ann_queries"] == 1
        assert c1["rerank_cache_hits"] == c["rerank_cache_hits"] + 1
    finally:
        tseg.dense = tseg.jax_dense
        jseg.close()
        tseg.close()
