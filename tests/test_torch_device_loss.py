"""The port store's device-loss contract against the JAX store's, on the
CPU: tests/test_device_loss.py's transient retry, loss streak, soak with
recovery and batched waiters, each run under the same
`device.transfer_fail` schedule on a JAX store (the JAX package's fault
point) and on a port store (the port's own copy of it), with equal
answers and equal `device_lost*` / `transfer_*` counters. Also: a
conjunction wave whose fetch fails retries solo and is counted as the
JAX store's is, and an error that is not a failed transfer still raises
in the submitter of a join wave, and an error at the fetch that is not a
failed transfer (a kernel's fault on the card) reaches the caller.
"""

import threading
import time

import numpy as np
import pytest

from yacy_search_server_tpu.index import devstore as JD
from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.index.rwi import RWIIndex as JRWI
from yacy_search_server_tpu.ops.ranking import RankingProfile as JProf
from yacy_search_server_tpu.utils import faultinject as jfault
from yacy_search_server_tpu_torch.index import devstore as TD
from yacy_search_server_tpu_torch.kernels import devstore as KD
from yacy_search_server_tpu_torch.utils import faultinject as tfault

TH = b"losttermAAAA"
TH2 = b"lostpairAAAA"
LOSS = ("device_lost", "device_losses", "device_loss_recoveries",
        "device_lost_queries", "transfer_failures", "transfer_retries")
POINT = "device.transfer_fail"


@pytest.fixture(autouse=True)
def _clean_faults():
    jfault.clear()
    tfault.clear()
    yield
    jfault.clear()
    tfault.clear()


def _plist(rng, n, base=0, step=1):
    """tests/test_device_loss.py's postings (every `step`-th docid)."""
    docids = np.arange(base, base + step * n, step, dtype=np.int32)
    feats = rng.integers(0, 1000, (n, JP.NF)).astype(np.int32)
    feats[:, JP.F_FLAGS] = rng.integers(0, 2 ** 20, n)
    feats[:, JP.F_DOMLENGTH] = rng.integers(0, 256, n)
    feats[:, JP.F_LANGUAGE] = JP.pack_language("en")
    return JP.PostingsList(docids, feats)


def _stores():
    """(JAX store, port store), each over its own RWI of TH (3,000
    postings) and TH2 (2,000 postings meeting a third of TH's), the
    result caches off: every query reaches the device path."""
    out = []
    for cls, dev in ((JD.DeviceSegmentStore, {}),
                     (TD.DeviceSegmentStore, {"device": "cpu"})):
        idx = JRWI()
        idx.add_many(TH, _plist(np.random.default_rng(0), 3000))
        idx.add_many(TH2, _plist(np.random.default_rng(1), 2000, step=3))
        idx.flush()
        s = cls(idx, **dev)
        s._topk_cache.enabled = False
        out.append(s)
    return out


def _tighten(s, monkeypatch, streak, backoff):
    """Retry-free fetches, a loss after `streak` failed ones and the
    rebuild's first probe after `backoff` s: per store on the JAX store,
    the port's module constants on the port's."""
    if isinstance(s, TD.DeviceSegmentStore):
        monkeypatch.setattr(TD, "TRANSFER_RETRIES", 0)
        monkeypatch.setattr(TD, "LOSS_STREAK", streak)
        monkeypatch.setattr(TD, "REBUILD_BACKOFF_S", backoff)
    else:
        s.transfer_retry_limit = 0
        s.loss_streak = streak
        s.rebuild_backoff_s = backoff


def _loss(s):
    c = s.counters()
    return [c[k] for k in LOSS]


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def _wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_transient_failure_retries_and_stays_bit_identical():
    """One injected failure inside the retry budget: the same answer,
    one retry counted, no loss; equal on both stores."""
    j, t = _stores()
    answers = []
    for s, fault in ((j, jfault), (t, tfault)):
        want = s.rank_term(TH, JProf(), k=10)
        fault.set_fault(POINT, 1)
        got = s.rank_term(TH, JProf(), k=10)
        _same(got, want)
        answers.append(got)
    _same(answers[1], answers[0])
    assert _loss(t) == _loss(j) == [0, 0, 0, 0, 0, 1]


def test_streak_declares_loss_then_host_fallback_counted(monkeypatch):
    """Retry-free fetches failing in a streak of two declare the loss:
    the epoch bumps, rank_term and rank_join answer None and count the
    queries; equal on both stores."""
    j, t = _stores()
    for s, fault in ((j, jfault), (t, tfault)):
        _tighten(s, monkeypatch, 2, 3600.0)      # hold the rebuild off
        assert s.rank_term(TH, JProf(), k=10) is not None
        epoch0 = s.arena_epoch
        fault.set_fault(POINT, 500)
        outs = [s.rank_term(TH, JProf(), k=10) for _ in range(4)]
        assert outs == [None] * 4 and s.device_lost
        assert s.arena_epoch > epoch0, "a loss bumps the arena epoch"
        assert s.rank_join([TH, TH2], [], JProf()) is None
        fault.clear()
    assert _loss(t) == _loss(j) == [1, 1, 0, 5, 2, 0]
    for key in ("fallbacks", "join_fallbacks", "join_served"):
        assert t.counters()[key] == j.counters()[key], key


def test_injected_loss_soak_answers_every_query_and_recovers(monkeypatch):
    """Under an injected loss every query of a 4-thread soak returns (None,
    counted), the background rebuild drains the rebuild probes' charges
    and restores device serving, and the answers after it equal those
    before the loss, bit for bit, on both stores."""
    j, t = _stores()
    before, after = [], []
    for s, fault in ((j, jfault), (t, tfault)):
        _tighten(s, monkeypatch, 1, 0.05)
        want = (s.rank_term(TH, JProf(), k=10),
                s.rank_join([TH, TH2], [], JProf(), k=10))
        # the declaring query burns one charge; the rebuild's probes the
        # other five, then the sixth probe round-trips
        fault.set_fault(POINT, 6)
        assert s.rank_term(TH, JProf(), k=10) is None
        assert s.device_lost
        outs = []

        def worker(s=s, outs=outs):
            for _ in range(5):
                outs.append(s.rank_term(TH, JProf(), k=10))
        ths = [threading.Thread(target=worker) for _ in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=30)
        assert len(outs) == 20 and all(o is None for o in outs)
        assert _wait(lambda s=s: not s.device_lost), "no recovery"
        got = (s.rank_term(TH, JProf(), k=10),
               s.rank_join([TH, TH2], [], JProf(), k=10))
        for g, w in zip(got, want):
            _same(g, w)
        before.append(want)
        after.append(got)
    for g, w in zip(after[1], after[0]):
        _same(g, w)
    assert _loss(t) == _loss(j) == [0, 1, 1, 21, 1, 0]


def test_batched_pipeline_loss_does_not_crash_waiters(monkeypatch):
    """A fetch dying in the batcher's completer: every one of 6 batched
    waiters returns None (ineligible, solo, the host fallback), none
    hangs, on both stores. Each query is counted once as a lost-device
    query whichever way it ended; how many fetches failed depends on how
    the waves formed, so those counts are compared only as present."""
    j, t = _stores()
    j.enable_batching(max_batch=4, dispatchers=1, prewarm=False)
    t.enable_batching(max_batch=4, dispatchers=1)
    try:
        for s, fault in ((j, jfault), (t, tfault)):
            _tighten(s, monkeypatch, 1, 3600.0)
            assert s.rank_term(TH, JProf(), k=10) is not None
            fault.set_fault(POINT, 200)
            t0 = time.monotonic()
            outs = []

            def q(s=s, outs=outs):
                outs.append(s.rank_term(TH, JProf(), k=10))
            ths = [threading.Thread(target=q) for _ in range(6)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=30)
            assert outs == [None] * 6
            assert time.monotonic() - t0 < 30
            fault.clear()
        lj, lt = _loss(j), _loss(t)
        assert lt[:4] == lj[:4] == [1, 1, 0, 6]
        assert lt[4] >= 1 and lj[4] >= 1 and lt[5] == lj[5] == 0
    finally:
        j.close()
        t.close()


def test_join_wave_fetch_failure_retries_solo_like_jax(monkeypatch):
    """One conjunction through the batcher, its wave's fetch failing: the
    wave answers ineligible, the solo join's fetch fails too and the
    query is counted (batch_ineligible, a lost-device query, a join
    fallback), as on the JAX store."""
    j, t = _stores()
    j.enable_batching(max_batch=4, dispatchers=1, prewarm=False)
    t.enable_batching(max_batch=4, dispatchers=1)
    try:
        for s, fault in ((j, jfault), (t, tfault)):
            _tighten(s, monkeypatch, 1, 3600.0)
            # the wave's shape once before the fault (the JAX store
            # compiles it), then the wave's fetch and the solo one fail
            assert s.rank_join([TH, TH2], [], JProf(), k=10) is not None
            fault.set_fault(POINT, 2)
            assert s.rank_join([TH, TH2], [], JProf(), k=10) is None
        for key in ("batch_ineligible", "join_fallbacks", "join_served",
                    "device_round_trips"):
            assert t.counters()[key] == j.counters()[key], key
        assert t.counters()["batch_ineligible"] == 1
        assert _loss(t) == _loss(j) == [1, 1, 0, 1, 2, 0]
    finally:
        j.close()
        t.close()


def test_join_wave_error_raises_in_the_submitter(monkeypatch):
    """No hidden fallback: a launch error in a join wave (not a failed
    transfer) is raised in the query's own thread; nothing counts as a
    lost device."""
    _j, t = _stores()
    t.enable_batching(max_batch=4, dispatchers=1)

    def broken(*a, **kw):
        raise RuntimeError("CUDA kernel join_member_batch failed")
    monkeypatch.setattr(KD, "join_member_batch", broken)
    try:
        with pytest.raises(RuntimeError, match="join_member_batch"):
            t.rank_join([TH, TH2], [], JProf(), k=10)
        c = t.counters()
        assert c["batch_exceptions"] == 1
        assert [c[k] for k in LOSS] == [0] * 6
    finally:
        t.close()


class _StickyEvent:
    """A wave's completion event whose wait fails as a kernel's fault on
    the card shows there (a CUDA runtime error, not a failed transfer)."""

    def synchronize(self):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")


@pytest.mark.parametrize("batched", [False, True], ids=["solo", "batched"])
def test_cuda_error_at_the_fetch_raises_in_the_caller(monkeypatch, batched):
    """No hidden fallback for a kernel's fault: an error at the fetch that
    is not a DeviceTransferError is neither retried nor counted as a
    failed transfer; it reaches rank_join's caller as it is, solo or
    through the batcher, and the device is not declared lost."""
    _j, t = _stores()
    if batched:
        t.enable_batching(max_batch=4, dispatchers=1)
    fetch = t.device_fetch
    monkeypatch.setattr(t, "device_fetch",
                        lambda out, done=None: fetch(out, _StickyEvent()))
    try:
        with pytest.raises(RuntimeError, match="illegal memory access") as e:
            t.rank_join([TH, TH2], [], JProf(), k=10)
        assert not isinstance(e.value, TD.DeviceTransferError)
        c = t.counters()
        assert [c[k] for k in LOSS] == [0] * 6
        assert c["join_fallbacks"] == 0 and c["join_served"] == 0
        assert c["batch_exceptions"] == (1 if batched else 0)
    finally:
        t.close()
