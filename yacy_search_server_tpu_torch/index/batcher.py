"""The query batcher: concurrent device queries coalesced into waves.

Port of the JAX store's _QueryBatcher (yacy_search_server_tpu/index/
devstore.py:1720-3030) for the kinds this port serves: pruned queries
(`submit`: K5 `pruned_tile` with one slot a query, up to `max_batch` a
launch), conjunctions (`submit_join`: the batched K8 and kernels 1-2,
`devstore.join_batch_query`, up to MAX_JOIN_BATCH a wave, or `max_batch`
where every membership is a bitmap one) and, with `scan_batching`,
filtered exact scans (`submit_scan`: the batched K6/K7 pair,
`devstore.scan_batch_query`). One former owns
the incoming queue and forms batches, growing a batch while a wave is in
flight; a pool of dispatchers issues each part's launches; a pool of
completers waits for each wave's answer and wakes its submitters. A
submitter that waits past WATCHDOG_S withdraws its query and serves it
solo (the reference's semantics: the solo path runs the same kernels on
the card); a query that a wave could not take (its term has several
spans, a RAM delta, a tombstone newer than its span) comes back
"ineligible" at once and also goes solo.

CUDA in place of JAX's asynchronous dispatch:
- each dispatcher issues on a `torch.cuda.Stream` of its own (the
  wrappers launch on the current stream);
- a wave's answer is copied `non_blocking` into pinned host memory and
  an event is recorded after the copy; a completer waits on that event
  and reads host memory only;
- the arena writes on a stream of its own, so a dispatcher takes its
  snapshot (`DeviceSegmentStore.snapshot`: the arena tensors and the
  arena's `written` event) and makes its stream wait on the event before
  it launches; the completion record holds every tensor the wave reads
  until its event has completed, so no tensor it reads is freed (and its
  memory reused) while the wave runs;
- a kernel that raises in a dispatcher is no reason to serve the query
  another way: the error is counted and raised in each submitter. So is
  a kernel's fault on the card, which surfaces as a CUDA runtime error
  at the completer's wait. The one exception is the reference's
  degraded mode: a wave whose fetch fails (DeviceTransferError, from the
  store's device_fetch) answers ("ineligible",), and each of its queries
  retries solo, where a failed fetch is counted as a lost-device query.

A dispatcher or completer thread never submits to the batcher itself
(`owns_current_thread`). Left out of the port so far: the rerank, ANN
and promote kinds, and the reference's tracing, wave stamps and
profiler records.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from ..kernels import devstore as KD

log = logging.getLogger("yacy.torch.batcher")


class QueryBatcher:
    """Dynamic batching of concurrent device queries into waves."""

    # a query gives the batcher this long before withdrawing and serving
    # itself solo
    WATCHDOG_S = 1.0
    # conjunctions of a sort-mode membership a wave (all-bitmap ones:
    # max_batch), as in the reference
    MAX_JOIN_BATCH = 4

    # retire sentinel: set_tuning shrinks the pools by handing one of
    # these to exactly the thread that should exit
    _RETIRE = object()

    def __init__(self, store, max_batch: int = 16, dispatchers: int = 8,
                 completer_depth: int = 2, pipeline: bool = True):
        self.store = store
        self.max_batch = max(1, int(max_batch))
        self.device = store.arena.device
        # lint: unbounded-ok(every queued item is a submitter blocked on
        # its answer, so the depth is bounded by the callers' threads)
        self._q: queue.Queue = queue.Queue()
        # one-slot handoff: the former blocks here while every dispatcher
        # is busy and keeps growing its batch meanwhile
        self._ready: queue.Queue = queue.Queue(maxsize=1)
        # issued waves awaiting a completer: bounded, the backpressure on
        # in-flight device memory (dispatchers x completer_depth waves)
        self.pipeline = bool(pipeline)
        self._completer_depth = max(1, completer_depth)
        self._inflight: queue.Queue = queue.Queue(
            maxsize=max(1, (self._completer_depth - 1) * max(1, dispatchers)))
        self._stop = False
        self._tune_lock = threading.Lock()
        self._thread_seq = max(1, dispatchers)
        self._completer_retire_owed = 0
        # counters, all under _ms_lock
        self._ms_lock = threading.Lock()
        self.dispatches = 0
        self.dispatch_ms_max = 0.0
        self.exceptions = 0
        self.timeouts = 0
        # the stage an item had reached when its submitter gave up:
        # never claimed (queue_full), forming or waiting for a completer
        # (flush_deadline), its own launches or a fetch longer than a
        # watchdog window (worker_stall: zero in healthy serving)
        self.timeout_queue_full = 0
        self.timeout_flush_deadline = 0
        self.timeout_worker_stall = 0
        # per query: the wall of the wave it rode in (issue to answer
        # handed out) and its launch-to-answer wall
        self.query_dispatch_ms: deque = deque(maxlen=20000)
        self.query_kernel_ms: deque = deque(maxlen=20000)
        self._dispatchers = max(1, dispatchers)
        self._threads = [
            threading.Thread(target=self._dispatch_loop,
                             name=f"torch-batcher-{i}", daemon=True)
            for i in range(self._dispatchers)]
        self._former = threading.Thread(target=self._form_loop,
                                        name="torch-former", daemon=True)
        self._threads.append(self._former)
        self._completer_threads = [
            threading.Thread(target=self._completer_loop,
                             name=f"torch-completer-{i}", daemon=True)
            for i in range(self._dispatchers)]
        self._threads.extend(self._completer_threads)
        for t in self._threads:
            t.start()

    def owns_current_thread(self) -> bool:
        return threading.current_thread() in self._threads

    # -- submitters -----------------------------------------------------------

    @staticmethod
    def _claim(item: dict, stage: str | None = None) -> bool:
        """Exactly-once ownership of a queued item: a former claims it to
        batch it, a timed-out submitter to withdraw it."""
        with item["lk"]:
            if item["taken"]:
                return False
            item["taken"] = True
            if stage is not None:
                item["stage"] = stage
            return True

    def _submit_wait(self, item: dict):
        ev = item["ev"]
        self._q.put(item)
        res = self._wait(item, ev)
        if res[0] == "error":
            raise res[1]
        return res

    def _wait(self, item: dict, ev: threading.Event):
        if ev.wait(timeout=self.WATCHDOG_S):
            return item["res"]
        if self._claim(item):
            # never picked up: withdraw
            with self._ms_lock:
                self.timeouts += 1
                self.timeout_queue_full += 1
            return ("timeout",)
        # the former or a dispatcher holds it: one more watchdog window,
        # then stop waiting (a late answer is dropped)
        if ev.wait(timeout=self.WATCHDOG_S):
            return item["res"]
        with item["lk"]:
            if ev.is_set():     # the answer landed between wait and lock
                return item["res"]
            item["abandoned"] = True
        with self._ms_lock:
            self.timeouts += 1
            st, ft = item.get("stage"), item.get("fetch_t0")
            if st == "dispatch" or (
                    st == "fetch" and ft is not None
                    and time.perf_counter() - ft > self.WATCHDOG_S):
                self.timeout_worker_stall += 1
            else:
                self.timeout_flush_deadline += 1
        log.warning("batcher %s still holds query after %.1fs; serving "
                    "solo", item.get("stage", "former"), 2 * self.WATCHDOG_S)
        return ("timeout",)

    @staticmethod
    def _item(**kw) -> dict:
        kw.update(ev=threading.Event(), res=("ineligible",),
                  lk=threading.Lock(), taken=False)
        return kw

    def submit(self, termhash: bytes, profile, language: str, kk: int):
        """A pruned query (b = 1) in a wave; blocking. Returns ("ok",
        scores, docids, considered) | ("prune_fail",) | ("ineligible",)
        | ("timeout",)."""
        return self._submit_wait(self._item(
            kind="pruned", th=termhash, profile=profile, lang=language,
            kk=kk))

    def submit_scan(self, termhash: bytes, profile, language: str, kk: int,
                    filters: tuple):
        """A filtered exact scan in a wave; blocking. `filters` =
        (lang_filter, flag_bit, from_days, to_days) ride each slot's
        descriptor, so differently filtered scans share a launch. Returns
        ("ok", scores, docids, considered) | ("ineligible",) |
        ("timeout",)."""
        return self._submit_wait(self._item(
            kind="scan", th=termhash, profile=profile, lang=language, kk=kk,
            filters=filters))

    def submit_join(self, arrays, join, written, qargs, statics: tuple,
                    profile, language: str):
        """A conjunction in a wave; blocking. The caller (rank_join)
        resolved its spans against one snapshot: `arrays` and `join` its
        tensors (the arena's five, the join tables' three), `written` the
        event after their writes, `qargs` its descriptor row
        (KD.join_wave_desc's), `statics` (kk, n_inc, n_exc, the include
        partners' and the excludes' bitmap modes). Returns ("ok",
        scores, docids) with kk of each, (-(2^31-1), -1) past the
        winners | ("ineligible",) | ("timeout",)."""
        _kk, n_inc, n_exc, inc_bm, exc_bm = statics
        return self._submit_wait(self._item(
            kind="join", arrays=arrays, join=join, written=written,
            qargs=qargs, statics=statics, profile=profile, lang=language,
            joincap=(self.max_batch if (n_inc + n_exc)
                     and all(inc_bm + exc_bm) else self.MAX_JOIN_BATCH)))

    def close(self) -> None:
        self._stop = True
        self._q.put(None)       # the former forwards one a dispatcher
        for _ in self._completer_threads:
            try:
                self._inflight.put(None, timeout=5.0)
            except queue.Full:
                break
        for t in list(self._threads):
            if t is not threading.current_thread():
                t.join(timeout=10.0)

    # -- former ---------------------------------------------------------------

    def _form_loop(self) -> None:
        """Single owner of the incoming queue: forms batches and hands them
        through the one-slot _ready. While every dispatcher is busy the
        handoff blocks and the batch keeps growing from the backlog; a
        lone query is handed over at once."""
        while True:
            item = self._q.get()
            if item is None:
                with self._tune_lock:
                    for _ in range(self._dispatchers):
                        self._ready.put(None)
                return
            if not self._claim(item, stage="form"):
                continue  # withdrawn by its submitter while queued
            batch = [item]

            def joins_full() -> bool:
                """The batch's conjunctions fill the smallest cap among
                them."""
                joins = [it for it in batch if it["kind"] == "join"]
                return bool(joins) and len(joins) >= min(
                    it["joincap"] for it in joins)

            def drain() -> int:
                got = 0
                while len(batch) < self.max_batch and not joins_full():
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        return got
                    if nxt is None:
                        self._q.put(None)  # re-deliver the shutdown
                        return got
                    if self._claim(nxt, stage="form"):
                        batch.append(nxt)
                        got += 1
                return got

            # wave-aware growth: queries that completed together come back
            # together; while a drain finds companions, keep collecting
            if drain() > 0:
                while len(batch) < self.max_batch and not joins_full():
                    time.sleep(0.0015)
                    if drain() == 0:
                        break
            while True:
                if len(batch) >= self.max_batch or joins_full():
                    for part in self._split_parts(batch):
                        self._ready.put(part)
                    break
                try:
                    parts = self._split_parts(batch)
                    self._ready.put_nowait(parts[0])
                    for part in parts[1:]:
                        self._ready.put(part)
                    break
                except queue.Full:
                    # every dispatcher busy: keep growing the batch
                    try:
                        nxt = self._q.get(timeout=0.005)
                    except queue.Empty:
                        continue
                    if nxt is None:
                        self._q.put(None)
                        self._ready.put(batch)
                        break
                    if self._claim(nxt, stage="form"):
                        batch.append(nxt)

    @staticmethod
    def _split_parts(batch: list[dict]) -> list[list[dict]]:
        """The pruned queries in one part (one K5 launch a (profile,
        language, kk) group), each scan group in a part of its own, and
        each conjunction family (statics, profile, language) in parts of
        its cap, so that no dispatcher serializes unrelated launches."""
        pruned = [it for it in batch if it["kind"] == "pruned"]
        scans: dict[tuple, list[dict]] = {}
        fams: dict[tuple, list[dict]] = {}
        for it in batch:
            if it["kind"] == "scan":
                key = (it["profile"].to_external_string(), it["lang"],
                       it["kk"])
                scans.setdefault(key, []).append(it)
            elif it["kind"] == "join":
                key = (it["statics"], it["profile"].to_external_string(),
                       it["lang"])
                fams.setdefault(key, []).append(it)
        parts = [pruned] if pruned else []
        parts.extend(scans.values())
        for fam in fams.values():
            cap = min(it["joincap"] for it in fam)
            parts.extend(fam[i:i + cap] for i in range(0, len(fam), cap))
        return parts or [batch]

    # -- dispatchers ----------------------------------------------------------

    def _stream_ctx(self):
        """Where this dispatcher issues: a CUDA stream of its own."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(torch.cuda.Stream(self.device))

    def _dispatch_loop(self) -> None:
        with self._stream_ctx():
            while True:
                batch = self._ready.get()
                if batch is None or batch is self._RETIRE:
                    return
                for it in batch:
                    it["stage"] = "dispatch"
                try:
                    self._dispatch(batch)
                except Exception as e:  # noqa: BLE001 - raised in submitters
                    # the launch failed: each waiting submitter raises it
                    # (answers already handed to a completer are its own)
                    with self._ms_lock:
                        self.exceptions += 1
                    log.exception("batch dispatch failed (%d queries)",
                                  len(batch))
                    for it in batch:
                        if not it.get("issued") and not it["ev"].is_set():
                            it["res"] = ("error", e)
                            it["ev"].set()
                with self._ms_lock:
                    self.dispatches += 1

    def _dispatch(self, batch: list[dict]) -> None:
        scans = [it for it in batch if it["kind"] == "scan"]
        pruned = [it for it in batch if it["kind"] == "pruned"]
        joins = [it for it in batch if it["kind"] == "join"]
        if scans:
            self._dispatch_scans(scans)
        if pruned:
            self._dispatch_pruned(pruned)
        if joins:
            self._dispatch_joins(joins)

    def _dispatch_pruned(self, batch: list[dict]) -> None:
        """K5 over each (profile, language, kk) group of the part, one
        slot a query (no pad slots: a launch takes any number), without
        the init entries (the batched kernel's form)."""
        from .devstore import DeviceArena, prune_bound_consts
        store = self.store
        arrays, written, spans, _epoch, tomb, has_delta = store.snapshot(
            [it["th"] for it in batch])
        groups: dict[tuple, list[dict]] = {}
        for it in batch:
            sp = spans[it["th"]]
            if (sp is None or len(sp) != 1 or sp[0].tcount <= 0
                    or sp[0].dead_seq != tomb or has_delta[it["th"]]
                    or it["kk"] > KD.MAX_KK):
                it["ev"].set()  # stays ("ineligible",): the caller goes solo
                continue
            it["span"] = sp[0]
            key = (it["profile"].to_external_string(), it["lang"], it["kk"])
            groups.setdefault(key, []).append(it)
        if not groups:
            return
        DeviceArena.wait_written(written)
        for (_, lang, kk), items in groups.items():
            prof = items[0]["profile"]
            consts = store._profile_consts(prof, lang)
            shift, lang_term = prune_bound_consts(prof)
            desc = KD.pack_desc(
                [(it["span"].start, it["span"].count, it["span"].tstart,
                  it["span"].tcount, it["span"].stats["col_min"],
                  it["span"].stats["col_max"], it["span"].stats["tf_min"],
                  it["span"].stats["tf_max"]) for it in items],
                int(shift), int(lang_term))
            t0 = time.perf_counter()
            out = KD.pruned_tile(*arrays, desc, kk, consts, init=False)

            def finish(host, items=items, kk=kk):
                s, d = host[:, :kk], host[:, kk:2 * kk]
                ok = host[:, 2 * kk] != 0
                # concurrent completers: the store's counters under its lock
                with store._lock:
                    store.prune_rounds += 1
                    for i, it in enumerate(items):
                        if ok[i]:   # tiles past the one scored
                            store.pruned_tiles += max(
                                0, it["span"].tcount - 1)
                for i, it in enumerate(items):
                    it["res"] = (("ok", s[i], d[i], it["span"].count)
                                 if ok[i] else ("prune_fail",))
                    it["ev"].set()

            self._submit_completion(out, finish, items, t0,
                                    keep=(arrays, consts))

    def _dispatch_scans(self, items: list[dict]) -> None:
        """The batched exact scan over each (profile, language, kk) group
        in waves of up to 16 slots; a term with a RAM delta, no span or
        more than MAX_SPANS spans answers ("ineligible",) and goes solo."""
        from .devstore import (DAYS_NONE_HI, DAYS_NONE_LO, DeviceArena,
                               scan_batch_query)
        store = self.store
        arrays, written, spans, _epoch, _tomb, has_delta = store.snapshot(
            [it["th"] for it in items])
        groups: dict[tuple, list[dict]] = {}
        for it in items:
            sp = spans[it["th"]]
            if not sp or len(sp) > store.MAX_SPANS or has_delta[it["th"]]:
                it["ev"].set()
                continue
            it["spanlist"] = sp
            key = (it["profile"].to_external_string(), it["lang"], it["kk"])
            groups.setdefault(key, []).append(it)
        if not groups:
            return
        DeviceArena.wait_written(written)
        wave = min(self.max_batch, KD.BATCH_SLOTS)
        for (_, lang, kk), its in groups.items():
            consts = store._profile_consts(its[0]["profile"], lang)
            for pos in range(0, len(its), wave):
                chunk = its[pos:pos + wave]
                scans = []
                for it in chunk:
                    lf, fb, fd, td = it["filters"]
                    scans.append((
                        [(sp.start, sp.count) for sp in it["spanlist"]],
                        (lf, fb, DAYS_NONE_LO if fd is None else fd,
                         DAYS_NONE_HI if td is None else td)))
                t0 = time.perf_counter()
                out = scan_batch_query(arrays, scans, consts, kk)

                def finish(host, chunk=chunk, kk=kk):
                    with store._lock:
                        store.stream_scans += len(chunk)
                    for i, it in enumerate(chunk):
                        it["res"] = ("ok", host[i, :kk], host[i, kk:],
                                     sum(sp.count for sp in it["spanlist"]))
                        it["ev"].set()

                self._submit_completion(out, finish, chunk, t0,
                                        keep=(arrays, consts))

    def _dispatch_joins(self, items: list[dict]) -> None:
        """One join_batch_query a wave over each group of conjunctions
        that share an arena snapshot (the identity of every tensor they
        read: the arena's, the join tables', the tombstone bitmap, which
        dead_array replaces whenever tombstones land), the statics, the
        profile and the language (the reference's key, :2941-2948, less
        the XLA compile shapes r and the segment windows, which the
        port's kernels do not need), in waves of the group's cap (at most
        KD.BATCH_SLOTS). The reference pads a wave to the buckets {1, 4,
        16} to bound XLA's compile shapes; here only the live slots
        launch."""
        from .devstore import DeviceArena, join_batch_query
        store = self.store
        groups: dict[tuple, list[dict]] = {}
        for it in items:
            key = (tuple(id(a) for a in it["arrays"]),
                   tuple(id(a) for a in it["join"]), it["statics"],
                   it["profile"].to_external_string(), it["lang"])
            groups.setdefault(key, []).append(it)
        for its in groups.values():
            first = its[0]
            kk, n_inc = first["statics"][:2]
            # the arena appends in place, so one group's items may hold
            # later write events than the first's: wait on each
            for ev in {id(it["written"]): it["written"]
                       for it in its}.values():
                DeviceArena.wait_written(ev)
            consts = store._profile_consts(first["profile"], first["lang"])
            wave = min(min(it["joincap"] for it in its), self.max_batch,
                       KD.BATCH_SLOTS)
            for pos in range(0, len(its), wave):
                chunk = its[pos:pos + wave]
                t0 = time.perf_counter()
                out = join_batch_query(
                    first["arrays"], first["join"],
                    np.stack([it["qargs"] for it in chunk]), n_inc, consts,
                    kk)

                def finish(host, chunk=chunk, kk=kk):
                    for i, it in enumerate(chunk):
                        it["res"] = ("ok", host[i, :kk], host[i, kk:])
                        it["ev"].set()

                self._submit_completion(out, finish, chunk, t0,
                                        keep=(first["arrays"], first["join"],
                                              consts))

    # -- completers -----------------------------------------------------------

    def _submit_completion(self, out, finish, items: list[dict], t0: float,
                           keep) -> None:
        """Hand an issued wave to the completers: its answer copied into
        pinned host memory behind an event, and every tensor it reads held
        until the event completes. Without `pipeline` the dispatcher
        completes the wave itself."""
        if out.device.type == "cuda":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = out, None
        for it in items:
            it["stage"] = "inflight"
            it["issued"] = True     # a completer owns the answer now
        rec = {"host": host, "done": done, "keep": (keep, out),
               "finish": finish, "items": items, "t0": t0}
        if self.pipeline:
            self._inflight.put(rec)     # bounded: backpressure
        else:
            self._complete(rec)

    def _completer_loop(self) -> None:
        while True:
            rec = self._inflight.get()
            if rec is None or rec is self._RETIRE:
                return
            self._complete(rec)

    def _complete(self, rec: dict) -> None:
        """Wait for one wave's answer in host memory (the store's
        device_fetch) and hand it out. A failed fetch sends the wave's
        queries solo, as the reference's completer does (:2401-2410);
        any other error is raised in each submitter."""
        from .devstore import DeviceTransferError
        items = rec["items"]
        tf0 = time.perf_counter()
        for it in items:
            it["fetch_t0"] = tf0
            it["stage"] = "fetch"
        try:
            try:
                host = self.store.device_fetch(rec["host"], rec["done"])
            except DeviceTransferError:
                with self._ms_lock:
                    self.exceptions += 1
                log.warning("batch fetch failed (%d queries retry solo)",
                            len(items))
                for it in items:
                    if not it["ev"].is_set():
                        it["res"] = ("ineligible",)
                        it["ev"].set()
                return
            self.store.count_round_trip()
            rec["finish"](host)
        except Exception as e:  # noqa: BLE001 - raised in submitters
            with self._ms_lock:
                self.exceptions += 1
            log.exception("batch completion failed (%d queries)", len(items))
            for it in items:
                if not it["ev"].is_set():
                    it["res"] = ("error", e)
                    it["ev"].set()
            return
        finally:
            rec["keep"] = None  # the wave is done: its tensors may go
        ms = (time.perf_counter() - rec["t0"]) * 1000.0
        with self._ms_lock:
            self.query_kernel_ms.extend([ms] * len(items))
            self.query_dispatch_ms.extend([ms] * len(items))
            self.dispatch_ms_max = max(self.dispatch_ms_max, ms)

    # -- runtime tuning -------------------------------------------------------

    def tuning(self) -> dict:
        """Live pool geometry and the queue depths."""
        with self._ms_lock:
            dispatches = self.dispatches
        return {"dispatchers": self._dispatchers,
                "completer_depth": self._completer_depth,
                "queue_incoming": self._q.qsize(),
                "queue_inflight": self._inflight.qsize(),
                "dispatches": dispatches}

    def set_tuning(self, dispatchers: int | None = None,
                   completer_depth: int | None = None) -> dict:
        """Resize the dispatcher and completer pools and the in-flight
        bound at run time, floored at 1 dispatcher and depth 1. Growth
        starts a dispatcher and a completer together; shrinking hands a
        retire sentinel to one thread of each pool (a full queue defers
        the completer's to the next call)."""
        with self._tune_lock:
            if self._stop:
                return self.tuning()
            want_d = self._dispatchers if dispatchers is None \
                else max(1, int(dispatchers))
            want_c = self._completer_depth if completer_depth is None \
                else max(1, int(completer_depth))
            self._completer_depth = want_c
            self._completer_threads = [t for t in self._completer_threads
                                       if t.is_alive()]
            self._threads = [t for t in self._threads if t.is_alive()]
            while self._completer_retire_owed > 0:
                try:
                    self._inflight.put_nowait(self._RETIRE)
                except queue.Full:
                    break
                self._completer_retire_owed -= 1
            while self._dispatchers < want_d:
                i = self._thread_seq
                self._thread_seq += 1
                td = threading.Thread(target=self._dispatch_loop,
                                      name=f"torch-batcher-{i}", daemon=True)
                tc = threading.Thread(target=self._completer_loop,
                                      name=f"torch-completer-{i}",
                                      daemon=True)
                self._threads.extend((td, tc))
                self._completer_threads.append(tc)
                self._dispatchers += 1
                td.start()
                tc.start()
            while self._dispatchers > want_d:
                try:
                    self._ready.put(self._RETIRE, timeout=0.5)
                except queue.Full:
                    break       # pool saturated: retry next call
                try:
                    self._inflight.put(self._RETIRE, timeout=0.5)
                except queue.Full:
                    self._completer_retire_owed += 1
                self._dispatchers -= 1
            new_max = max(1, (want_c - 1) * max(1, self._dispatchers))
            with self._inflight.mutex:
                self._inflight.maxsize = new_max
                self._inflight.not_full.notify_all()
        return self.tuning()

