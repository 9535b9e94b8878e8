"""Mesh-sharded postings serving: the DHT axes as arena partitions.

Port of yacy_search_server_tpu/index/meshstore.py. The store partitions
the packed-extent arena of index/devstore.py over a ('term', 'doc') mesh
of cells (parallel/mesh.DocMesh: one device a cell, cell t * n_doc + d; a
device may repeat, so a 2 x 2 mesh fits on one card) and runs every
eligible query as the JAX store's SPMD program does, cell by cell from one
process:

    each cell's scan of its extent slice (the port's kernels on the
    cell's tensors)
    -> the statistics merged over the whole mesh (the mesh's
       pmin/pmax collective: one global min/max a query)
    -> each cell's scores and exact local top-k
    -> the cells' top-k copied into one buffer and merged by kernel 4
       under (score DESC, docid ASC)

Placement is the DHT math, as in the JAX store: a term's postings live on
the term row `term_shard(termhash, n_term)` (the horizontal ring position
scaled to the axis), each posting on doc column `docid % n_doc`, so
conjunctions are column-local; terms on different rows join through K18
`xjoin` (the rare row's candidates probed against every row's join
windows, the contributions reduced over the term axis). A RAM delta goes
to every cell, and duplicate docids of the gathered top-k dedup on the
host. Block-max pruning composes with the sharding: each cell packs its
slice proxy-sorted against the term's GLOBAL frozen pack statistics, and a
pruned query scores a prefix of every cell's tiles (K5, or K7 over a
longer prefix) and checks every cell's tail bound; one failed bound
escalates the prefix for all.

The kernels of the shard bodies: `_pruned_cells` (K5 or K7 + kernel 3 +
topk_finish a cell, then K4 batched over the cells' runs, with the pmin
of the cells' ok), `_scan_cells` (K6 a cell, the statistics' merge, K7
with its docid column, kernel 3 in tie mode, K4), the joins'
`MeshSegmentStore._join_parts` (K8 in sort mode a cell) or `_xjoin_parts`
(K18's probe and apply for a cross-row conjunction), then
`_join_score_cells` (kernel 1, the merge, kernel 2 and kernel 3 in tie
mode a cell, K4).
Every launch goes to the current stream of its cell's device; a query
holds the tensors of its snapshot until its answer is on the host.

Left out (the multi-process runtime's slice): the multi-process mode
(`multiprocess`, `rank_term_mp`, uploads by callback); the JAX store's
tracing and histogram hooks and ingest SLO stamps; the corrupt-run
quarantine.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..convert import profile_from_jax
from ..kernels import cardinal_score, cardinal_stats, tie_topk
from ..kernels import devstore as KD
from ..kernels.topk import gather_topk_batch
from ..ops.ranking import compact_feats, profile_consts
from ..parallel.distribution import horizontal_dht_position
from ..parallel.mesh import AXES, make_mesh
from ..utils import faultinject
from . import postings as P
from .devstore import (_PRUNE_B, DAYS_NONE_HI, DAYS_NONE_LO, LOSS_STREAK,
                       NEG_INF32, NO_FLAG, NO_LANG, TILE, TRANSFER_BACKOFF_S,
                       TRANSFER_RETRIES, DeviceTransferError, Span,
                       TopkCache, _bucket_rows, pack_prune_stats, pmax_table,
                       prune_bound_consts, pruned_query)

log = logging.getLogger("yacy.torch.meshstore")

INT32_MAX = 2 ** 31 - 1
XJOIN_ROWS = KD.XJOIN_ROWS


def term_shard(termhash: bytes, n_term: int) -> int:
    """Horizontal DHT ring position scaled to the term axis size."""
    return int((horizontal_dht_position(termhash) * n_term) >> 63)


class MeshSpan:
    """One run's extents for a term across every mesh cell."""

    __slots__ = ("starts", "counts", "total", "jstarts",
                 "tstarts", "tcounts", "stats", "dead_seq")

    def __init__(self, starts: np.ndarray, counts: np.ndarray,
                 jstarts: np.ndarray | None = None,
                 tstarts: np.ndarray | None = None,
                 tcounts: np.ndarray | None = None,
                 stats=None, dead_seq: int = -1):
        self.starts = starts          # int32 [n_cells] per-cell offsets
        self.counts = counts          # int32 [n_cells]
        self.jstarts = jstarts        # int32 [n_cells] join-table offsets
        self.tstarts = tstarts        # int32 [n_cells] pmax offsets
        self.tcounts = tcounts        # int32 [n_cells] pmax tile counts
        # GLOBAL pack-time normalization stats (whole term, all cells):
        # every cell prunes and scores in one normalized space
        self.stats = stats
        self.dead_seq = dead_seq      # tombstone count at pack
        self.total = int(counts.sum())

    def cell_span(self, c: int) -> Span:
        """Cell c's share as a devstore Span (the term's global stats)."""
        return Span(int(self.starts[c]), int(self.counts[c]),
                    int(self.tstarts[c]), int(self.tcounts[c]), self.stats)


class _CellBuf:
    """Host mirror of one mesh cell's packed rows (+ join side-table).

    Appends accumulate chunks and concatenate only at materialize time
    (once per device sync): per-append concatenation would copy the whole
    cell per (term, column)."""

    __slots__ = ("_parts", "used", "_jparts", "jused",
                 "_tparts", "tused",
                 "feats16", "flags", "docids", "jdocids", "jpos", "pmax")

    def __init__(self):
        self.used = 0
        self.jused = 0
        self.tused = 0
        self._parts: list[tuple] = []       # (f16, fl, dd) chunks
        self._jparts: list[tuple] = []      # (jdocids, jpos) chunks
        self._tparts: list[np.ndarray] = []  # per-tile pmax chunks
        self.feats16 = np.zeros((0, P.NF), np.int16)
        self.flags = np.zeros(0, np.int32)
        self.docids = np.zeros(0, np.int32)
        self.jdocids = np.zeros(0, np.int32)
        self.jpos = np.zeros(0, np.int32)
        self.pmax = np.zeros(0, np.int32)

    def append(self, f16, fl, dd) -> int:
        start = self.used
        self._parts.append((f16, fl, dd))
        self.used += len(dd)
        return start

    def append_join(self, jd, jp) -> int:
        start = self.jused
        self._jparts.append((jd, jp))
        self.jused += len(jd)
        return start

    def append_pmax(self, pm: np.ndarray) -> int:
        start = self.tused
        self._tparts.append(pm)
        self.tused += len(pm)
        return start

    def materialize(self) -> None:
        if self._parts:
            self.feats16 = np.concatenate(
                [self.feats16] + [p[0] for p in self._parts])
            self.flags = np.concatenate(
                [self.flags] + [p[1] for p in self._parts])
            self.docids = np.concatenate(
                [self.docids] + [p[2] for p in self._parts])
            self._parts = []
        if self._jparts:
            self.jdocids = np.concatenate(
                [self.jdocids] + [p[0] for p in self._jparts])
            self.jpos = np.concatenate(
                [self.jpos] + [p[1] for p in self._jparts])
            self._jparts = []
        if self._tparts:
            self.pmax = np.concatenate([self.pmax] + self._tparts)
            self._tparts = []


class _Cell:
    """One cell's tensors as the kernels read them: views of its device's
    [cells_on_device, ...] arrays, and its device's tombstone bitmap."""

    __slots__ = ("feats16", "flags", "docids", "jdocids", "jpos", "pmax",
                 "dead", "bmtab")

    def arrays(self):
        """(feats16, flags, docids, dead, pmax): devstore's query arrays."""
        return self.feats16, self.flags, self.docids, self.dead, self.pmax


def place_cells(arrays, devices, dead=None) -> list:
    """The mesh's cells from global [n_cells, ...] host arrays (feats16
    int16 [n, C, 17], flags and docids int32 [n, C], jdocids and jpos int32
    [n, JC], pmax int32 [n, TC]): one [cells_on_device, ...] tensor a
    device and array (a device's cells in one upload), each cell its
    views; `dead` (bool [doc_cap] or None) the tombstone bitmap, one
    tensor a device."""
    by_dev: dict = {}
    for i, dev in enumerate(devices):
        by_dev.setdefault(dev, []).append(i)
    cells: list = [None] * len(devices)
    for dev, idx in by_dev.items():
        run = idx == list(range(idx[0], idx[-1] + 1))
        t = [torch.from_numpy(np.ascontiguousarray(
            a[idx[0]:idx[-1] + 1] if run else a[idx])).to(dev)
            for a in arrays]
        bmtab = torch.zeros((1, 1, 2), dtype=torch.int32, device=dev)
        dd = (torch.from_numpy(np.array(dead, bool)).to(dev)
              if dead is not None else None)
        for j, i in enumerate(idx):
            cell = _Cell()
            (cell.feats16, cell.flags, cell.docids, cell.jdocids, cell.jpos,
             cell.pmax) = (a[j] for a in t)
            cell.dead, cell.bmtab = dd, bmtab
            cells[i] = cell
    return cells


# ---------------------------------------------------------------------------
# the shard bodies (each cell's kernels, the mesh's collectives between)
# ---------------------------------------------------------------------------

def _init_block(bs: int, n_cells: int, kk: int, dev, ok: bool):
    """The gathered buffer [bs, cells, 2kk (+1)], every run an empty cell's
    answer: (-(2^31-1), -1) rows (the pruned init entries), ok 1."""
    g = torch.empty((bs, n_cells, 2 * kk + int(ok)), dtype=torch.int32,
                    device=dev)
    g[:, :, :kk] = NEG_INF32
    g[:, :, kk:2 * kk] = -1
    if ok:
        g[:, :, 2 * kk] = 1
    return g


def _pruned_cells(mesh, cells, slots, kk: int, b: int, shift, lang_term,
                  consts):
    """_mesh_pruned_shard / _mesh_pruned_batch_shard at prefix b for the
    slots of a wave (a MeshSpan each, None: a free pad slot): each cell
    scores its share of each slot's span (K5 at b = 1 over all the cell's
    live slots in one launch, else K7 over the prefix, kernel 3 and
    topk_finish a slot), the cells' [bs, 2kk + 1] blocks are gathered into
    one buffer, and K4 batched merges each slot's runs and takes the pmin
    of the cells' ok. Returns [bs, 2kk + 1] on the mesh's first device:
    scores, docids, ok."""
    bs = len(slots)
    g = _init_block(bs, mesh.n_cells, kk, mesh.device, True)
    for c, cell in enumerate(cells):
        live = [i for i, sp in enumerate(slots)
                if sp is not None and sp.counts[c] > 0]
        if not live:
            continue          # no rows: its runs stay the init entries
        arrays, cst = cell.arrays(), consts[c]
        if b == 1 and kk <= KD.MAX_KK:
            desc = KD.pack_desc(
                [(int(slots[i].starts[c]), int(slots[i].counts[c]),
                  int(slots[i].tstarts[c]), int(slots[i].tcounts[c]),
                  slots[i].stats["col_min"], slots[i].stats["col_max"],
                  slots[i].stats["tf_min"], slots[i].stats["tf_max"])
                 for i in live], shift, lang_term)
            out = KD.pruned_tile(*arrays, desc, kk, cst, init=True)
            for j, i in enumerate(live):
                g[i, c].copy_(out[j])
        else:
            for i in live:
                g[i, c].copy_(pruned_query(arrays, slots[i].cell_span(c),
                                           shift, lang_term, cst, kk, b))
    return gather_topk_batch(g, kk, kk, False, d_off=kk, ok_off=2 * kk)


def _scan_cells(mesh, cells, spans, delta, filt, kk: int, consts,
                full: bool):
    """_mesh_rank_shard: each cell's K6 over its extents of the spans and
    the RAM delta (every cell gets the whole delta), the statistics merged
    over the mesh, K7 against them with the rows' docids beside their
    scores, kernel 3 in tie mode for the cell's kk best, then K4 over the
    cells' runs: [2k] scores ++ docids, k = kk, or every gathered row
    (`full`, with a delta: the host dedups)."""
    exts = [[(int(sp.starts[c]), int(sp.counts[c])) for sp in spans
             if sp.counts[c] > 0] for c in range(mesh.n_cells)]
    deltas = [None] * mesh.n_cells
    if delta is not None:
        for c, cell in enumerate(cells):
            deltas[c] = tuple(a.to(cell.feats16.device) for a in delta)
    st = [None] * mesh.n_cells
    for c, cell in enumerate(cells):
        if exts[c] or deltas[c] is not None:
            st[c] = {"stats": KD.span_stats(
                cell.feats16, cell.docids, cell.dead, exts[c],
                flags=cell.flags, filt=filt, delta=deltas[c]),
                "host_counts": torch.zeros(1, dtype=torch.int32,
                                           device=cell.feats16.device)}
    merged = mesh.pmerge_stats(st, AXES)
    g = _init_block(1, mesh.n_cells, kk, mesh.device, False)
    for c, cell in enumerate(cells):
        if st[c] is None:
            continue
        rows = sum(n for _s, n in exts[c]) + (
            deltas[c][2].shape[0] if deltas[c] is not None else 0)
        buf, bufd = KD.span_score(
            cell.feats16, cell.flags, cell.docids, cell.dead, exts[c],
            merged[c]["stats"], consts[c], max(rows, kk), filt=filt,
            delta=deltas[c], with_docids=True)
        tie_topk(buf, kk, secondary=bufd,
                 out=(g[0, c, :kk], g[0, c, kk:], torch.empty_like(
                     g[0, c, :kk])))
    k = mesh.n_cells * kk if full else kk
    return gather_topk_batch(g, kk, k, False, d_off=kk)[0]


def _join_score_cells(mesh, parts, kk: int, consts):
    """_join_score_gather: each cell's merged join rows (`parts[c]`:
    (merged, flags, valid, docids) or None for a cell with no candidate),
    kernel 1 without host counts, the statistics merged over the mesh,
    kernel 2 (the int32 path, the OR'd flags) and kernel 3 in tie mode a
    cell, K4 over the cells' runs: [2kk] scores ++ docids (the runs padded
    with (-(2^31-1), INT32_MAX), which sort last)."""
    st = [None] * mesh.n_cells
    for c, p in enumerate(parts):
        if p is not None:
            s, cnt = cardinal_stats(p[0], p[2], None, 0)
            st[c] = {"stats": s, "host_counts": cnt}
    merged = mesh.pmerge_stats(st, AXES)
    g = _init_block(1, mesh.n_cells, kk, mesh.device, False)
    g[0, :, kk:] = INT32_MAX
    for c, p in enumerate(parts):
        if p is None:
            continue
        m, fo, v, dd = p
        sc = cardinal_score(m, fo, v, None, merged[c]["stats"],
                            merged[c]["host_counts"], consts[c], False)
        n = min(kk, sc.shape[0])
        tie_topk(sc, n, secondary=dd, out=(
            g[0, c, :n], g[0, c, kk:kk + n], torch.empty_like(g[0, c, :n])))
    return gather_topk_batch(g, kk, kk, False, d_off=kk)[0]


def _xjoin_reduce(a, b):
    """The term axis' reduction of two cells' K18 probe outputs: psum of
    found, pmin/pmax of posintext, pmin of hitcount, psum of flags."""
    return torch.stack([a[0] + b[0], torch.minimum(a[1], b[1]),
                        torch.maximum(a[2], b[2]),
                        torch.minimum(a[3], b[3]), a[4] + b[4]])


def _neutral(n: int, dev):
    out = torch.empty((XJOIN_ROWS, n), dtype=torch.int32, device=dev)
    out[0] = 0
    out[1] = INT32_MAX
    out[2] = -INT32_MAX
    out[3] = INT32_MAX
    out[4] = 0
    return out


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

class _MeshQueryBatcher:
    """Cross-query batching for the mesh pruned path: concurrent
    single-term searches that share (profile, language, k) ride ONE wave
    (each cell's K5 over all the wave's slots, K4 batched over the cells'
    runs), issued by one dispatcher and completed by one completer. The
    former, the claim, the watchdog and the escalation ladder are the JAX
    store's _MeshQueryBatcher's."""

    WATCHDOG_S = 2.0
    MAX_BATCH = 8

    def __init__(self, store: "MeshSegmentStore",
                 max_batch: int = MAX_BATCH):
        self.store = store
        self.max_batch = max_batch
        self._q: _queue.Queue = _queue.Queue()
        self._ctr_lock = threading.Lock()
        self.dispatches = 0
        self.timeouts = 0
        self.timeout_queue_full = 0
        self.timeout_flush_deadline = 0
        self.timeout_worker_stall = 0
        self.exceptions = 0
        # one wave in the completer and one queued behind it at most
        self._inflight: _queue.Queue = _queue.Queue(maxsize=2)
        self._completer = threading.Thread(target=self._completer_loop,
                                           name="torch-meshstore-completer",
                                           daemon=True)
        self._completer.start()
        self._thread = threading.Thread(target=self._loop,
                                        name="torch-meshstore-batcher",
                                        daemon=True)
        self._thread.start()

    @staticmethod
    def _claim(item: dict, stage: str | None = None) -> bool:
        with item["lk"]:
            if item["taken"]:
                return False
            item["taken"] = True
            if stage is not None:
                item["stage"] = stage
            return True

    def submit(self, termhash: bytes, profile, language: str, kk: int):
        """Blocking; ("ok", scores, docids) | ("prune_fail",) |
        ("ineligible",) | ("timeout",)."""
        item = {"th": termhash, "profile": profile, "lang": language,
                "kk": kk, "ev": threading.Event(), "res": ("ineligible",),
                "lk": threading.Lock(), "taken": False}
        self._q.put(item)
        if item["ev"].wait(timeout=self.WATCHDOG_S):
            return item["res"]
        if self._claim(item):
            # never claimed off the queue: backlog, not a wedge
            with self._ctr_lock:
                self.timeouts += 1
                self.timeout_queue_full += 1
            return ("timeout",)
        if item["ev"].wait(timeout=self.WATCHDOG_S):
            return item["res"]
        with self._ctr_lock:
            self.timeouts += 1
            st = item.get("stage")
            ft = item.get("fetch_t0")
            if st == "dispatch" or (
                    st == "fetch" and ft is not None
                    and time.perf_counter() - ft > self.WATCHDOG_S):
                self.timeout_worker_stall += 1
            else:
                self.timeout_flush_deadline += 1
        return ("timeout",)

    def close(self) -> None:
        self._q.put(None)
        try:
            self._inflight.put(None, timeout=5.0)
        except _queue.Full:
            pass
        self._completer.join(timeout=10.0)
        self._thread.join(timeout=10.0)

    @staticmethod
    def _bucket(n: int) -> int:
        return 1 if n <= 1 else (4 if n <= 4 else _MeshQueryBatcher
                                 .MAX_BATCH)

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if not self._claim(item, stage="form"):
                continue
            batch = [item]
            while len(batch) < self.max_batch:
                try:
                    nxt = self._q.get_nowait()
                except _queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)
                    break
                if self._claim(nxt, stage="form"):
                    batch.append(nxt)
            for it in batch:
                it["stage"] = "dispatch"
            try:
                self._dispatch(batch)
            except Exception:
                with self._ctr_lock:
                    self.exceptions += 1
                log.exception("mesh batch dispatch failed (%d queries "
                              "retry solo)", len(batch))
                for it in batch:
                    if not it.get("issued") and not it["ev"].is_set():
                        it["res"] = ("ineligible",)
                        it["ev"].set()

    def _dispatch(self, batch: list[dict]) -> None:
        """Issue each group's first-bucket wave and hand it to the
        completer."""
        store = self.store
        with store._lock:
            cells = store._device_cells()
            spans = {it["th"]: store.spans_for(it["th"]) for it in batch}
        with store.rwi._lock:
            tomb = len(store.rwi._tombstones)
            has_delta = {th: bool(store.rwi._ram.get(th)) for th in spans}
        groups: dict[tuple, list[dict]] = {}
        for it in batch:
            sp = spans[it["th"]]
            if (sp is None or len(sp) != 1 or sp[0].tcounts is None
                    or sp[0].tcounts.max() <= 0
                    or sp[0].dead_seq != tomb or has_delta[it["th"]]):
                it["ev"].set()       # ("ineligible",): caller goes solo
                continue
            it["span"] = sp[0]
            key = (it["profile"].to_external_string(), it["lang"],
                   it["kk"])
            groups.setdefault(key, []).append(it)
        for (_, lang, kk), items in groups.items():
            prof = store._port_profile(items[0]["profile"])
            consts = store._profile_consts(prof, lang)
            shift, lang_term = prune_bound_consts(prof)
            bs = self._bucket(len(items))
            slots = [it["span"] for it in items] + [None] * (bs - len(items))
            out = _pruned_cells(store.mesh, cells, slots, kk, _PRUNE_B[0],
                                shift, lang_term, consts)
            rec = {"out": out, "items": items, "slots": slots,
                   "consts": consts, "shift": shift, "lang_term": lang_term,
                   "kk": kk, "cells": cells}
            for it in items:
                it["stage"] = "inflight"
                it["issued"] = True        # the completer owns the answer
            self._inflight.put(rec)

    def _completer_loop(self) -> None:
        while True:
            rec = self._inflight.get()
            if rec is None:
                return
            self._complete(rec)

    def _complete(self, rec: dict) -> None:
        """Fetch the first bucket's answer (one copy), distribute, and
        walk the escalation ladder for any slot whose bound failed."""
        store = self.store
        items = rec["items"]
        kk = rec["kk"]
        slots = list(rec["slots"])
        pending = list(range(len(items)))
        out = rec["out"]
        try:
            for b in _PRUNE_B:
                if out is None:     # escalation bucket: issue inline
                    out = _pruned_cells(store.mesh, rec["cells"], slots, kk,
                                        b, rec["shift"], rec["lang_term"],
                                        rec["consts"])
                tf0 = time.perf_counter()
                for it in items:
                    it["fetch_t0"] = tf0
                    it["stage"] = "fetch"
                host = store.device_fetch(out)
                out = None
                store.count_round_trip()
                s = host[:, :kk]
                d = host[:, kk:2 * kk]
                ok = host[:, 2 * kk] != 0
                with self._ctr_lock:
                    self.dispatches += 1
                with store._lock:
                    store.prune_rounds += 1
                still = []
                for i in pending:
                    if bool(ok[i]):
                        sp = items[i]["span"]
                        with store._lock:
                            store.pruned_tiles += int(
                                np.maximum(sp.tcounts - b, 0).sum())
                        items[i]["res"] = ("ok", s[i], d[i])
                        items[i]["ev"].set()
                        # a satisfied slot becomes a free pad slot for the
                        # escalation rounds
                        slots[i] = None
                    else:
                        still.append(i)
                pending = still
                if not pending:
                    break
            for i in pending:          # bound never held: solo full scan
                items[i]["res"] = ("prune_fail",)
                items[i]["ev"].set()
        except Exception:
            with self._ctr_lock:
                self.exceptions += 1
            log.exception("mesh batch completion failed (%d queries "
                          "retry solo)", len(items))
            for it in items:
                if not it["ev"].is_set():
                    it["res"] = ("ineligible",)
                    it["ev"].set()


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class MeshSegmentStore:
    """Span registry + query dispatch over a sharded arena.

    The JAX MeshSegmentStore's RWI listener protocol and `rank_term` /
    `rank_join` signatures. `devices`: one a cell in cell order (a device
    may repeat), divisible by n_term; None: one cell on the CUDA device
    (raising without one)."""

    MAX_SPANS = 8
    MAX_JOIN_TERMS = 6
    small_rank_n: int | None = None

    def __init__(self, rwi, devices=None, n_term: int = 1,
                 budget_bytes: int = 2 << 30):
        devs = list(devices) if devices is not None else [resolve_device()]
        self.mesh = make_mesh(n_term=n_term, devices=devs)
        self.n_term = self.mesh.n_term
        self.n_doc = self.mesh.n_doc
        self.n_cells = self.mesh.n_cells
        self.rwi = rwi
        self.budget_bytes = budget_bytes
        self._cells = [_CellBuf() for _ in range(self.n_cells)]
        self._packed: dict[int, dict[bytes, MeshSpan]] = {}
        self._lock = threading.RLock()
        self._garbage_rows = 0
        self.queries_served = 0
        self.fallbacks = 0
        self.device_lost = False
        self.device_losses = 0
        self.device_loss_recoveries = 0
        self.device_lost_queries = 0
        self.transfer_failures = 0
        self.transfer_retries = 0
        self._transfer_fail_streak = 0
        self.loss_streak = LOSS_STREAK
        self.transfer_retry_limit = TRANSFER_RETRIES
        self.rebuild_backoff_s = 0.5
        self._rebuild_thread: threading.Thread | None = None
        self.arena_epoch = 0
        self._topk_cache = TopkCache()
        self.device_round_trips = 0
        self._dev_cells: list[_Cell] | None = None
        self._dirty = True
        self.prune_rounds = 0
        self.pruned_tiles = 0
        self._dead_host = np.zeros(1 << 16, bool)
        self._dev_dead: dict | None = None
        self._dirty_dead = True
        self._consts: dict = {}
        self._profiles: dict = {}
        self._batcher: _MeshQueryBatcher | None = None
        for docid in rwi._tombstones:
            self.mark_dead(docid)
        for run in list(rwi._runs):
            self.on_run_added(run)
        rwi.listener = self

    # -- placement math ------------------------------------------------------

    def _cell_of(self, t: int, d: int) -> int:
        return t * self.n_doc + d

    def row_bytes(self) -> int:
        return P.NF * 2 + 4 + 4

    def _would_fit(self, extra_rows: int) -> bool:
        # worst case the whole run lands on one cell; budget the padded
        # global buffer that cell size would force
        worst = max(c.used for c in self._cells) + extra_rows
        cap = _bucket_rows(worst + TILE) + TILE
        return cap * self.n_cells * self.row_bytes() <= self.budget_bytes

    # -- packing (listener protocol) ----------------------------------------

    def _bump_epoch(self) -> None:
        with self._lock:
            self.arena_epoch += 1

    def count_round_trip(self) -> None:
        with self._lock:
            self.device_round_trips += 1

    def on_run_added(self, run) -> None:
        # the epoch bumps after the mutation: a racing result-cache insert
        # is then born stale, never live stale
        try:
            self._on_run_added_inner(run)
        finally:
            self._bump_epoch()

    def _on_run_added_inner(self, run) -> None:
        with self._lock:
            rid = id(run)
            if rid in self._packed:
                return
            rows = run.n_postings
            if rows == 0:
                self._packed[rid] = {}
                return
            if not self._would_fit(rows):
                return        # skipped: its terms fall back to the host
            spans: dict[bytes, MeshSpan] = {}
            for th in list(run.term_hashes()):
                p = run.get(th)
                if p is None or len(p) == 0:
                    continue
                f16, fl = compact_feats(np.ascontiguousarray(p.feats,
                                                             np.int32))
                dd = p.docids.astype(np.int32)
                # GLOBAL frozen stats + proxy scores over the whole term
                gstats, proxy = pack_prune_stats(f16, fl)
                t = term_shard(th, self.n_term)
                d_shard = dd % self.n_doc
                starts = np.zeros(self.n_cells, np.int32)
                counts = np.zeros(self.n_cells, np.int32)
                jstarts = np.zeros(self.n_cells, np.int32)
                tstarts = np.zeros(self.n_cells, np.int32)
                tcounts = np.zeros(self.n_cells, np.int32)
                for d in range(self.n_doc):
                    sel = d_shard == d
                    n = int(sel.sum())
                    if n == 0:
                        continue
                    cell = self._cell_of(t, d)
                    buf = self._cells[cell]
                    # rows pack proxy-sorted (the block-max prune layout)
                    order = np.argsort(-proxy[sel], kind="stable")
                    cell_dd = dd[sel][order]
                    start = buf.append(f16[sel][order], fl[sel][order],
                                       cell_dd)
                    tstarts[cell] = buf.append_pmax(
                        pmax_table(proxy[sel][order]))
                    tcounts[cell] = (n + TILE - 1) // TILE
                    # the column-local docid-sorted view (the join table):
                    # the j-th packed posting sits at cell row start + j
                    jorder = np.argsort(cell_dd, kind="stable")
                    jstarts[cell] = buf.append_join(
                        cell_dd[jorder].astype(np.int32),
                        (start + jorder).astype(np.int32))
                    starts[cell], counts[cell] = start, n
                spans[th] = MeshSpan(starts, counts, jstarts,
                                     tstarts, tcounts, gstats,
                                     getattr(run, "dead_seq", -1))
            self._packed[rid] = spans
            self._dirty = True

    def on_run_removed(self, run) -> None:
        with self._lock:
            spans = self._packed.pop(id(run), None)
            if spans:
                self._garbage_rows += sum(sp.total for sp in spans.values())
            self._bump_epoch()
            used = sum(c.used for c in self._cells)
            if (self._garbage_rows * 2 > max(used, 1)
                    and self._garbage_rows > 4 * TILE):
                self.repack()

    def on_run_swapped(self, old_run, new_run) -> None:
        with self._lock:
            spans = self._packed.pop(id(old_run), None)
            if spans is not None:
                live = set(new_run.term_hashes())
                self._packed[id(new_run)] = {
                    th: sp for th, sp in spans.items() if th in live}
            self._bump_epoch()

    def on_doc_deleted(self, docid: int) -> None:
        self.mark_dead(docid)

    def on_term_dropped(self, run, termhash: bytes) -> None:
        with self._lock:
            spans = self._packed.get(id(run))
            if spans is not None:
                sp = spans.pop(termhash, None)
                if sp is not None:
                    self._garbage_rows += sp.total
            self._bump_epoch()

    def mark_dead(self, docid: int) -> None:
        with self._lock:
            if docid >= len(self._dead_host):
                cap = len(self._dead_host)
                while cap <= docid:
                    cap *= 2
                grown = np.zeros(cap, bool)
                grown[:len(self._dead_host)] = self._dead_host
                self._dead_host = grown
            self._dead_host[docid] = True
            self._dirty_dead = True
            self._bump_epoch()

    def live_rows(self) -> int:
        with self._lock:
            return sum(sp.total for spans in self._packed.values()
                       for sp in spans.values())

    def repack(self) -> None:
        with self._lock:
            self._cells = [_CellBuf() for _ in range(self.n_cells)]
            self._packed.clear()
            self._garbage_rows = 0
            self._dirty = True
            for run in list(self.rwi._runs):
                self.on_run_added(run)      # bumps the epoch per run
            self._bump_epoch()              # the zero-run rebuild too

    def enable_batching(self, max_batch: int = 8, **_kw) -> None:
        """Cross-query batching for the pruned path: concurrent eligible
        searches share one wave, issued by one dispatcher and fetched by
        one completer. The JAX store's other keywords (pipeline,
        dispatchers, completer_depth) are accepted and ignored."""
        if self._batcher is None:
            self._batcher = _MeshQueryBatcher(
                self, max_batch=min(max_batch, _MeshQueryBatcher.MAX_BATCH))

    def rank_cache_get(self, termhash: bytes, profile,
                       language: str = "en", k: int = 100):
        """The versioned top-k cache's answer, valid only while the arena
        epoch is unchanged and the term carries no RAM delta."""
        kk = max(16, 1 << (max(k, 1) - 1).bit_length())
        key = (termhash, profile.to_external_string(), language, kk)
        with self.rwi._lock:
            if self.rwi._ram.get(termhash):
                return None
        with self._lock:
            epoch = self.arena_epoch
        got = self._topk_cache.get(key, epoch)
        if got is None:
            return None
        s, d, considered = got
        with self._lock:
            self.queries_served += 1
        return s[:k], d[:k], considered

    # -- device loss ----------------------------------------------------------

    def device_fetch(self, out: torch.Tensor) -> np.ndarray:
        """The host copy of a dispatch's answer with the JAX mesh store's
        transfer-failure ladder: transfer_retry_limit retries with
        backoff, then a counted failure (DeviceTransferError); loss_streak
        failures in a row declare the mesh lost. Only the
        `device.transfer_fail` fault point is a failed transfer: a CUDA
        runtime error raises as it is."""
        delay = TRANSFER_BACKOFF_S
        for attempt in range(self.transfer_retry_limit + 1):
            try:
                if faultinject.take("device.transfer_fail"):
                    raise DeviceTransferError(
                        "injected device.transfer_fail")
                host = out.cpu().numpy()
            except DeviceTransferError as e:
                if attempt < self.transfer_retry_limit:
                    with self._lock:
                        self.transfer_retries += 1
                    time.sleep(delay)
                    delay *= 2
                    continue
                self._note_transfer_failure(e)
                raise DeviceTransferError(
                    f"mesh transfer failed after "
                    f"{self.transfer_retry_limit + 1} attempts: "
                    f"{e!r}") from e
            with self._lock:
                self._transfer_fail_streak = 0
            return host
        raise DeviceTransferError(
            "unreachable: empty retry ladder")   # retry_limit < 0 guard

    def _note_transfer_failure(self, err) -> None:
        declare = False
        with self._lock:
            self.transfer_failures += 1
            self._transfer_fail_streak += 1
            if (not self.device_lost
                    and self._transfer_fail_streak >= self.loss_streak):
                declare = True
        if declare:
            self._declare_device_loss(err)

    def _declare_device_loss(self, err) -> None:
        with self._lock:
            if self.device_lost:
                return
            self.device_lost = True
            self.device_losses += 1
            self._transfer_fail_streak = 0
        self._bump_epoch()
        log.error("mesh lost after %d consecutive failed transfers (%r): "
                  "serving the host fallback; rebuild started",
                  self.loss_streak, err)
        self.start_rebuild()

    def start_rebuild(self) -> None:
        with self._lock:
            if not self.device_lost:
                return
            t = self._rebuild_thread
            if t is not None and t.is_alive():
                return
            t = threading.Thread(target=self._rebuild_loop,
                                 name="torch-meshstore-rebuild", daemon=True)
            self._rebuild_thread = t
        t.start()

    def _rebuild_loop(self) -> None:
        """Probe every cell device with backoff; once a one-word upload
        and fetch round-trips on each, drop the device tensors (the host
        mirrors are the source of truth: the next query uploads them
        again) and resume."""
        delay = self.rebuild_backoff_s
        while True:
            with self._lock:
                if not self.device_lost:
                    return
            time.sleep(delay)
            delay = min(delay * 2, 30.0)
            try:
                if faultinject.take("device.transfer_fail"):
                    raise DeviceTransferError(
                        "injected device.transfer_fail")
                for dev in dict.fromkeys(self.mesh.devices):
                    torch.zeros(1, dtype=torch.int32, device=dev).cpu()
            except Exception as e:  # noqa: BLE001 - the device is still down
                log.warning("mesh rebuild probe failed: %r", e)
                continue
            with self._lock:
                self._dev_cells = None
                self._dev_dead = None
                self._dirty = True
                self._dirty_dead = True
            with self._lock:
                self.device_lost = False
                self.device_loss_recoveries += 1
                self._transfer_fail_streak = 0
            self._bump_epoch()
            log.warning("mesh serving resumed after rebuild %d",
                        self.device_loss_recoveries)
            return

    def counters(self) -> dict:
        """Serving-health counters: every key of the JAX store's."""
        b = self._batcher
        with self._lock:
            return {
                "queries_served": self.queries_served,
                "fallbacks": self.fallbacks,
                "device_lost": 1 if self.device_lost else 0,
                "device_losses": self.device_losses,
                "device_loss_recoveries": self.device_loss_recoveries,
                "device_lost_queries": self.device_lost_queries,
                "transfer_failures": self.transfer_failures,
                "transfer_retries": self.transfer_retries,
                "rank_cache_hits": self._topk_cache.hits,
                "rank_cache_stale": self._topk_cache.stale,
                "arena_epoch": self.arena_epoch,
                "device_round_trips": self.device_round_trips,
                "prune_rounds": self.prune_rounds,
                "pruned_tiles": self.pruned_tiles,
                "batch_dispatches": b.dispatches if b else 0,
                "batch_timeouts": b.timeouts if b else 0,
                "batch_timeout_queue_full":
                    b.timeout_queue_full if b else 0,
                "batch_timeout_flush_deadline":
                    b.timeout_flush_deadline if b else 0,
                "batch_timeout_worker_stall":
                    b.timeout_worker_stall if b else 0,
                "batch_exceptions": b.exceptions if b else 0,
            }

    def close(self) -> None:
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None
        if self.rwi.listener is self:
            self.rwi.listener = None

    # -- device sync ---------------------------------------------------------

    def _sync_device(self) -> None:
        """The cells' tensors from the host mirrors: one [cells_on_device,
        C, ...] tensor a device and array, the cells its views. The
        padding is the JAX store's global C (rows), JC (join table) and TC
        (pmax rows), so a query declines exactly where it does there."""
        for c in self._cells:
            c.materialize()
        C = _bucket_rows(max(max(c.used for c in self._cells), 1)
                         + TILE) + TILE
        JC = 2 * _bucket_rows(
            max(max((c.jused for c in self._cells), default=1), 1))
        TC = max(max((c.tused for c in self._cells), default=1), 1)
        n = self.n_cells
        feats = np.zeros((n, C, P.NF), np.int16)
        flags = np.zeros((n, C), np.int32)
        docids = np.full((n, C), -1, np.int32)
        jdocids = np.full((n, JC), INT32_MAX, np.int32)
        jpos = np.zeros((n, JC), np.int32)
        pmax = np.full((n, TC), INT32_MAX, np.int32)
        for i, c in enumerate(self._cells):
            feats[i, :c.used] = c.feats16
            flags[i, :c.used] = c.flags
            docids[i, :c.used] = c.docids
            jdocids[i, :c.jused] = c.jdocids
            jpos[i, :c.jused] = c.jpos
            pmax[i, :c.tused] = c.pmax
        cells = place_cells((feats, flags, docids, jdocids, jpos, pmax),
                            self.mesh.devices)
        self._dev_cells = cells
        self._dirty = False
        self._dirty_dead = True

    def _device_cells(self) -> list:
        """The cells' tensors with the current tombstones (the caller
        holds the lock); a snapshot: a sync or a delete replaces them."""
        if self._dirty or self._dev_cells is None:
            self._sync_device()
        if self._dirty_dead or self._dev_dead is None:
            host = self._dead_host.copy()
            self._dev_dead = {dev: torch.from_numpy(host).to(dev)
                              for dev in dict.fromkeys(self.mesh.devices)}
            self._dirty_dead = False
            fresh = []
            for i, old in enumerate(self._dev_cells):
                cell = _Cell()
                for name in _Cell.__slots__:
                    if name != "dead":
                        setattr(cell, name, getattr(old, name))
                cell.dead = self._dev_dead[self.mesh.devices[i]]
                fresh.append(cell)
            self._dev_cells = fresh
        return self._dev_cells

    _CONSTS_CAP = 64

    def _port_profile(self, profile):
        """The port's profile of any profile with to_external_string()."""
        key = profile.to_external_string()
        with self._lock:
            got = self._profiles.get(key)
            if got is None:
                got = self._profiles[key] = profile_from_jax(key)
                while len(self._profiles) > 64:
                    self._profiles.pop(next(iter(self._profiles)))
            return got

    def _profile_consts(self, profile, language: str) -> list:
        """The profile's int32[44] constants, one tensor a cell (shared by
        the cells of a device)."""
        key = (profile.to_external_string(), language)
        with self._lock:
            got = self._consts.get(key)
            if got is not None:
                return got
        per_dev = {dev: profile_consts(profile, P.pack_language(language),
                                       dev)
                   for dev in dict.fromkeys(self.mesh.devices)}
        got = [per_dev[dev] for dev in self.mesh.devices]
        with self._lock:
            got = self._consts.setdefault(key, got)
            while len(self._consts) > self._CONSTS_CAP:
                self._consts.pop(next(iter(self._consts)))
            return got

    def _delta_block(self, delta) -> tuple:
        """A RAM delta's rows as K6/K7 read them, on the mesh's first
        device (each cell takes a copy): (feats16, flags, docids) padded
        to its bucket with docid -1."""
        n = len(delta)
        b = KD.bucket_delta(n)
        f16 = np.zeros((b, P.NF), np.int16)
        fl = np.zeros(b, np.int32)
        dd = np.full(b, -1, np.int32)
        cf, cfl = compact_feats(np.ascontiguousarray(delta.feats, np.int32))
        f16[:n], fl[:n], dd[:n] = cf, cfl, delta.docids
        return tuple(torch.from_numpy(a).to(self.mesh.device)
                     for a in (f16, fl, dd))

    # -- query dispatch ------------------------------------------------------

    def spans_for(self, termhash: bytes) -> list[MeshSpan] | None:
        with self._lock:
            out: list[MeshSpan] = []
            for run in list(self.rwi._runs):
                if not run.has(termhash):
                    continue
                spans = self._packed.get(id(run))
                if spans is None:
                    return None
                sp = spans.get(termhash)
                if sp is None:
                    return None
                out.append(sp)
            return out

    def rank_term(self, termhash: bytes, profile, language: str = "en",
                  k: int = 100,
                  lang_filter: int = NO_LANG, flag_bit: int = NO_FLAG,
                  from_days: int | None = None, to_days: int | None = None):
        """Single-term ranked top-k over the mesh: (scores, docids,
        considered), or None for the host fallback: counted while the
        mesh is declared lost or a transfer dies under the query, never
        an exception."""
        if self.device_lost:
            with self._lock:
                self.device_lost_queries += 1
                self.fallbacks += 1
            return None
        try:
            return self._rank_term_impl(termhash, profile, language, k,
                                        lang_filter, flag_bit,
                                        from_days, to_days)
        except DeviceTransferError:
            with self._lock:
                self.device_lost_queries += 1
                self.fallbacks += 1
            return None

    def _rank_term_impl(self, termhash: bytes, profile,
                        language: str = "en", k: int = 100,
                        lang_filter: int = NO_LANG,
                        flag_bit: int = NO_FLAG,
                        from_days: int | None = None,
                        to_days: int | None = None):
        cacheable = (lang_filter == NO_LANG and flag_bit == NO_FLAG
                     and from_days is None and to_days is None)
        if cacheable:
            got = self.rank_cache_get(termhash, profile, language, k)
            if got is not None:
                return got
        prof = self._port_profile(profile)
        with self._lock:
            spans = self.spans_for(termhash)
            if spans is None or len(spans) > self.MAX_SPANS:
                self.fallbacks += 1
                return None
            cells = self._device_cells()
            epoch0 = self.arena_epoch
        with self.rwi._lock:
            delta = self.rwi._ram_postings(termhash)
        if not spans and delta is None:
            return np.empty(0, np.int32), np.empty(0, np.int32), 0
        with_delta = delta is not None and len(delta) > 0
        considered = sum(sp.total for sp in spans) + (
            len(delta) if with_delta else 0)
        kk0 = max(16, 1 << (max(k, 1) - 1).bit_length())

        def cache_put(s, d):
            """Insert the final answer under the snapshot's epoch."""
            if cacheable and not with_delta:
                self._topk_cache.put(
                    (termhash, profile.to_external_string(), language,
                     kk0), epoch0, np.asarray(s), np.asarray(d),
                    considered)

        # the per-cell block-max pruned path: one span, no delta, no
        # filter, no tombstone newer than the pack
        if (cacheable and len(spans) == 1 and not with_delta
                and spans[0].tcounts is not None
                and spans[0].tcounts.max() > 0
                and spans[0].dead_seq == len(self.rwi._tombstones)):
            if (self._batcher is not None
                    and threading.current_thread()
                    is not self._batcher._thread):
                res = self._batcher.submit(termhash, profile, language, kk0)
                if res[0] == "ok":
                    s, d = res[1], res[2]
                    keep = (d >= 0) & (s > NEG_INF32)
                    s, d = s[keep], d[keep]
                    with self._lock:
                        self.queries_served += 1
                    cache_put(s, d)
                    return s[:k], d[:k], considered
                # prune_fail: the wave walked the whole ladder; ineligible
                # or timeout: the solo ladder below
                batch_prune_failed = res[0] == "prune_fail"
            else:
                batch_prune_failed = False
            sp = spans[0]
            consts = self._profile_consts(prof, language)
            shift, lang_term = prune_bound_consts(prof)
            for b in () if batch_prune_failed else _PRUNE_B:
                out = _pruned_cells(self.mesh, cells, [sp], kk0, b, shift,
                                    lang_term, consts)
                host = self.device_fetch(out)[0]
                self.count_round_trip()
                s, d, ok = host[:kk0], host[kk0:2 * kk0], host[2 * kk0] != 0
                with self._lock:
                    self.prune_rounds += 1
                    if ok:
                        self.pruned_tiles += int(
                            np.maximum(sp.tcounts - b, 0).sum())
                if ok:
                    keep = (d >= 0) & (s > NEG_INF32)
                    s, d = s[keep], d[keep]
                    with self._lock:
                        self.queries_served += 1
                    cache_put(s, d)
                    return s[:k], d[:k], considered
            # every bucket failed: the exact scan below

        filt = (lang_filter, flag_bit,
                DAYS_NONE_LO if from_days is None else from_days,
                DAYS_NONE_HI if to_days is None else to_days)
        consts = self._profile_consts(prof, language)
        dblk = self._delta_block(delta) if with_delta else None
        out = _scan_cells(self.mesh, cells, spans, dblk, filt, kk0, consts,
                          full=with_delta)
        host = self.device_fetch(out)
        self.count_round_trip()
        kf = host.shape[0] // 2
        s, d = host[:kf], host[kf:]
        keep = (d >= 0) & (s > NEG_INF32)
        s, d = s[keep], d[keep]
        # gathered candidates may repeat a docid (the replicated delta
        # rows, cross-run re-pushes): keep the best-scored instance
        _, first = np.unique(d, return_index=True)
        if len(first) != len(d):
            sel = np.sort(first)
            s, d = s[sel], d[sel]
        with self._lock:
            self.queries_served += 1
        cache_put(s, d)
        return s[:k], d[:k], considered

    def rank_join(self, include_hashes, exclude_hashes, profile,
                  language: str = "en", k: int = 100,
                  lang_filter: int = NO_LANG, flag_bit: int = NO_FLAG,
                  from_days: int | None = None, to_days: int | None = None):
        """Multi-term conjunctive ranked top-k over the mesh. Terms on one
        term row join column-locally (K8 in sort mode against each cell's
        docid-sorted side tables); terms on different rows join through
        K18 (the rare row's candidates probed against every row of their
        column, the contributions reduced over the term axis). None for
        the host fallback: multi-span terms, RAM deltas, windows that do
        not fit, a lost mesh (counted, never an exception)."""
        if self.device_lost:
            with self._lock:
                self.device_lost_queries += 1
                self.fallbacks += 1
            return None
        try:
            return self._rank_join_impl(include_hashes, exclude_hashes,
                                        profile, language, k,
                                        lang_filter, flag_bit,
                                        from_days, to_days)
        except DeviceTransferError:
            with self._lock:
                self.device_lost_queries += 1
                self.fallbacks += 1
            return None

    def _rank_join_impl(self, include_hashes, exclude_hashes, profile,
                        language: str = "en", k: int = 100,
                        lang_filter: int = NO_LANG,
                        flag_bit: int = NO_FLAG,
                        from_days: int | None = None,
                        to_days: int | None = None):
        include_hashes = list(include_hashes)
        exclude_hashes = list(exclude_hashes or [])
        if not include_hashes \
                or (len(include_hashes) == 1 and not exclude_hashes) \
                or len(include_hashes) > self.MAX_JOIN_TERMS \
                or len(exclude_hashes) > self.MAX_JOIN_TERMS:
            return None
        with self._lock:
            rows = set()
            inc_spans = []
            for th in include_hashes:
                spans = self.spans_for(th)
                if spans is None or len(spans) != 1:
                    self.fallbacks += 1
                    return None
                rows.add(term_shard(th, self.n_term))
                inc_spans.append(spans[0])
            exc_spans = []
            for th in exclude_hashes:
                spans = self.spans_for(th)
                if spans is None:
                    if self.rwi.has_term(th):
                        self.fallbacks += 1
                        return None
                    continue
                if len(spans) > 1:
                    self.fallbacks += 1
                    return None
                if spans:
                    rows.add(term_shard(th, self.n_term))
                    exc_spans.append(spans[0])
            cells = self._device_cells()
            C = int(cells[0].feats16.shape[0])
            JC = int(cells[0].jdocids.shape[0])
        with self.rwi._lock:
            ram_delta = any(self.rwi._ram.get(th)
                            for th in include_hashes + exclude_hashes)
        if ram_delta:
            with self._lock:
                self.fallbacks += 1
            return None

        rare_i = min(range(len(inc_spans)),
                     key=lambda i: inc_spans[i].total)
        rare = inc_spans[rare_i]
        partners = [sp for i, sp in enumerate(inc_spans) if i != rare_i]
        considered = rare.total
        # the JAX store's static windows must fit the padded tables
        r = _bucket_rows(max(int(rare.counts.max()), 1))
        if int((rare.starts + r).max()) > C:
            with self._lock:
                self.fallbacks += 1
            return None

        def fits(sp):
            m = _bucket_rows(max(int(sp.counts.max()), 1))
            return int((sp.jstarts + m).max()) <= JC

        if not all(fits(sp) for sp in partners + exc_spans):
            with self._lock:
                self.fallbacks += 1
            return None
        n_inc = len(partners)
        filt = (lang_filter, flag_bit,
                DAYS_NONE_LO if from_days is None else from_days,
                DAYS_NONE_HI if to_days is None else to_days)
        consts = self._profile_consts(self._port_profile(profile), language)
        kk = max(16, 1 << (max(k, 1) - 1).bit_length())
        if len(rows) > 1:
            parts = self._xjoin_parts(
                cells, rare, term_shard(include_hashes[rare_i], self.n_term),
                partners + exc_spans, n_inc, filt)
        else:
            parts = self._join_parts(cells, rare, partners + exc_spans,
                                     n_inc, filt)
        out = _join_score_cells(self.mesh, parts, kk, consts)
        host = self.device_fetch(out)
        self.count_round_trip()
        s, d = host[:kk], host[kk:]
        keep = (d >= 0) & (s > NEG_INF32)
        with self._lock:
            self.queries_served += 1
        return s[keep][:k], d[keep][:k], considered

    @staticmethod
    def _join_parts(cells, rare, others, n_inc: int, filt) -> list:
        """_mesh_join_shard's membership: K8 in sort mode on each cell
        holding rare rows, against the cell's own segments of every
        partner and exclude."""
        parts = []
        for c, cell in enumerate(cells):
            n = int(rare.counts[c])
            if n == 0:
                parts.append(None)
                continue
            start = int(rare.starts[c])
            segs = [(int(sp.jstarts[c]), int(sp.counts[c]), -1)
                    for sp in others]
            m, fo, v = KD.join_member(
                cell.feats16, cell.flags, cell.docids, cell.dead, start, n,
                cell.jdocids, cell.jpos, cell.bmtab, segs, n_inc, filt)
            parts.append((m, fo, v, cell.docids[start:start + n]))
        return parts

    def _xjoin_parts(self, cells, rare, row_rare: int, others, n_inc: int,
                     filt) -> list:
        """_mesh_xjoin_shard's exchange: in each doc column, the rare
        cell's candidates go to every cell of the column (the term axis'
        all-gather: a view where the devices repeat), K18's probe runs
        where a term's window in the column is not empty, the probes'
        outputs reduce over the term axis (psum, pmin, pmax, pmin, psum)
        one term after another, and K18's apply merges them on the rare
        cell."""
        mesh = self.mesh
        parts: list = [None] * self.n_cells
        for d in range(self.n_doc):
            rc = mesh.cell(row_rare, d)
            n = int(rare.counts[rc])
            if n == 0:
                continue
            start = int(rare.starts[rc])
            cand = cells[rc].docids[start:start + n]
            rdev = cells[rc].feats16.device
            contrib = torch.empty((len(others), XJOIN_ROWS, n),
                                  dtype=torch.int32, device=rdev)
            for j, sp in enumerate(others):
                xs = [None] * self.n_cells
                for t in range(self.n_term):
                    c = mesh.cell(t, d)
                    if sp.counts[c] == 0:
                        continue     # an empty window: all neutral
                    dev = cells[c].feats16.device
                    xs[c] = KD.xjoin_probe(
                        cand.to(dev), cells[c].dead,
                        contrib[:j].to(dev) if j else None, n_inc,
                        cells[c].jdocids, cells[c].jpos,
                        int(sp.jstarts[c]), int(sp.counts[c]),
                        cells[c].feats16, cells[c].flags)
                red = mesh.reduce(xs, "term", _xjoin_reduce)
                got = next((red[mesh.cell(t, d)] for t in range(self.n_term)
                            if red[mesh.cell(t, d)] is not None), None)
                contrib[j].copy_(got.to(rdev) if got is not None
                                 else _neutral(n, rdev))
            cell = cells[rc]
            m, fo, v = KD.xjoin_apply(cell.feats16, cell.flags, cell.docids,
                                      cell.dead, start, n, contrib, n_inc,
                                      filt)
            parts[rc] = (m, fo, v, cand)
        return parts
