"""The reverse word index (RWI), memory only: term -> postings as an LSM.

Copy of yacy_search_server_tpu/index/rwi.py without persistence: a RAM
buffer absorbs writes, `flush` freezes it into an immutable sorted run
(`FrozenRun`), `ingest_run` adds a prebuilt run, `merge_runs` folds the
oldest runs (and the tombstones) into one, `delete_doc` tombstones a
docid everywhere and `remove_term` takes a term out of every run. Runs
are what the device store packs (index/devstore.py): it registers itself
as `listener` and is told of every run added or removed, every delete
and every term dropped.

Left out of the copy: the paged run files, the deletion journal, corrupt
run quarantine, the ingest SLO stamps and writer backpressure. The RAM
buffer holds each `add_many` call as one block of rows (the reference
holds one tuple a posting); a flush concatenates a term's blocks in
write order, so the later row still wins a docid collision.

The store reads `_runs`, `_tombstones`, `_lock`, `_ram_postings` and
each run's `dead_seq`, the names of the JAX package's RWIIndex, so it
attaches to either.
"""

from __future__ import annotations

import threading

import numpy as np

from .postings import NF, PostingsList, merge, remove_docids, sort_dedupe


class FrozenRun:
    """Immutable sorted run held in RAM: term -> PostingsList."""

    def __init__(self, terms: dict[bytes, PostingsList], dead_seq: int = -1):
        self.terms = terms
        self.n_postings = sum(len(p) for p in terms.values())
        # tombstone count at creation: frozen stats stay exact for pruning
        # while no tombstone postdates the run (index/devstore.py)
        self.dead_seq = dead_seq

    def get(self, termhash: bytes) -> PostingsList | None:
        return self.terms.get(termhash)

    def has(self, termhash: bytes) -> bool:
        return termhash in self.terms

    def term_hashes(self):
        return self.terms.keys()

    def drop_term(self, termhash: bytes) -> int:
        p = self.terms.pop(termhash, None)
        if p is None:
            return 0
        self.n_postings -= len(p)
        return len(p)


class RWIIndex:
    """RAM buffer + frozen runs, with tombstones and mergeable runs."""

    def __init__(self):
        # run-lifecycle listener: on_run_added / on_run_removed /
        # on_doc_deleted / on_term_dropped
        self.listener = None
        # term -> [(docids int32 [m], feats int32 [m, NF]), ...] in write
        # order
        self._ram: dict[bytes, list[tuple[np.ndarray, np.ndarray]]] = {}
        self._runs: list[FrozenRun] = []  # oldest first
        self._tombstones: set[int] = set()
        self._dead_arr: np.ndarray | None = None  # cached sorted tombstones
        self._lock = threading.RLock()

    # -- write path -----------------------------------------------------------

    def add_many(self, termhash: bytes, postings: PostingsList) -> None:
        """Bulk append of one term's postings to the RAM buffer."""
        with self._lock:
            blocks = self._ram.setdefault(termhash, [])
            if len(postings):
                blocks.append(
                    (np.asarray(postings.docids, np.int32),
                     np.asarray(postings.feats, np.int32).reshape(-1, NF)))

    def ingest_run(self, terms: dict[bytes, PostingsList]
                   ) -> FrozenRun | None:
        """Add a prebuilt term -> postings mapping as one frozen run,
        bypassing the RAM buffer (bulk imports)."""
        with self._lock:
            clean = {th: sort_dedupe(p.docids, p.feats)
                     for th, p in terms.items() if len(p)}
            if not clean:
                return None
            run = FrozenRun(clean, dead_seq=len(self._tombstones))
            self._runs.append(run)
        if self.listener is not None:
            self.listener.on_run_added(run)
        return run

    def flush(self) -> FrozenRun | None:
        """Freeze the RAM buffer into an immutable run."""
        with self._lock:
            terms: dict[bytes, PostingsList] = {}
            for th, blocks in self._ram.items():
                blocks = [b for b in blocks if len(b[0])]
                if not blocks:  # bucket emptied by delete_doc
                    continue
                terms[th] = sort_dedupe(
                    np.concatenate([b[0] for b in blocks]),
                    np.concatenate([b[1] for b in blocks]))
            self._ram = {}
            if not terms:
                return None
            run = FrozenRun(terms, dead_seq=len(self._tombstones))
            self._runs.append(run)
        if self.listener is not None:
            self.listener.on_run_added(run)
        return run

    def merge_runs(self, max_runs: int = 8) -> bool:
        """Merge the oldest runs into one when there are more than max_runs;
        tombstones are folded in. Returns True if a merge happened."""
        with self._lock:
            if len(self._runs) <= max_runs:
                return False
            # a chronological prefix: later runs win docid collisions
            victims = self._runs[: len(self._runs) - max_runs + 1]
            all_terms: set[bytes] = set()
            for r in victims:
                all_terms.update(r.term_hashes())
            dead = self._dead_sorted()
            merged: dict[bytes, PostingsList] = {}
            for th in all_terms:
                parts = [p for r in victims
                         if (p := r.get(th)) is not None]
                m = remove_docids(merge(parts), dead)
                if len(m):
                    merged[th] = m
            new_run = FrozenRun(merged, dead_seq=len(self._tombstones))
            # the merged run replaces the victims at the oldest position
            self._runs = [new_run] + [r for r in self._runs
                                      if r not in victims]
        if self.listener is not None:
            self.listener.on_run_added(new_run)
            for r in victims:
                self.listener.on_run_removed(r)
        return True

    def delete_doc(self, docid: int) -> None:
        """Tombstone a document everywhere."""
        with self._lock:
            self._tombstones.add(docid)
            self._dead_arr = None
            for blocks in self._ram.values():
                for i, (d, f) in enumerate(blocks):
                    keep = d != docid
                    if not keep.all():
                        blocks[i] = (d[keep], f[keep])
                # a term's blocks hold rows, so `_ram.get(th)` is truthy
                # exactly while the term has unflushed postings (the device
                # store's RAM-delta gate reads it, as the reference's)
                blocks[:] = [b for b in blocks if len(b[0])]
        if self.listener is not None:
            self.listener.on_doc_deleted(docid)

    def remove_term(self, termhash: bytes) -> PostingsList:
        """Remove and return a term's postings from the RAM buffer and
        every run (tombstones applied; as in the reference, a run's row
        wins a docid collision with a RAM row)."""
        with self._lock:
            parts: list[PostingsList] = []
            blocks = [b for b in self._ram.pop(termhash, None) or ()
                      if len(b[0])]
            if blocks:
                parts.append(sort_dedupe(
                    np.concatenate([b[0] for b in blocks]),
                    np.concatenate([b[1] for b in blocks])))
            for run in list(self._runs):
                p = run.get(termhash)
                if p is not None:
                    run.drop_term(termhash)
                    if self.listener is not None:
                        self.listener.on_term_dropped(run, termhash)
                    parts.append(p)
            return self._apply_tombstones(merge(parts))

    # -- read path ------------------------------------------------------------

    def has_term(self, termhash: bytes) -> bool:
        """Whether the term has postings in RAM or in any run."""
        with self._lock:
            if termhash in self._ram:
                return True
            return any(r.has(termhash) for r in self._runs)

    def _ram_postings(self, termhash: bytes) -> PostingsList | None:
        with self._lock:
            blocks = [b for b in self._ram.get(termhash) or () if len(b[0])]
        if not blocks:
            return None
        return sort_dedupe(np.concatenate([b[0] for b in blocks]),
                           np.concatenate([b[1] for b in blocks]))

    def _dead_sorted(self) -> np.ndarray:
        """Sorted tombstone array, cached (rebuilt only after delete_doc)."""
        if self._dead_arr is None:
            self._dead_arr = np.fromiter(sorted(self._tombstones),
                                         dtype=np.int32,
                                         count=len(self._tombstones))
        return self._dead_arr

    def _apply_tombstones(self, p: PostingsList) -> PostingsList:
        if not self._tombstones or len(p) == 0:
            return p
        return remove_docids(p, self._dead_sorted())

    def get(self, termhash: bytes) -> PostingsList:
        """A term's full postings: RAM + all runs merged, tombstones
        applied; later writes win docid collisions (RAM beats runs)."""
        with self._lock:
            parts = [p for r in self._runs
                     if (p := r.get(termhash)) is not None]
            ram = self._ram_postings(termhash)
            if ram is not None:
                parts.append(ram)
            return self._apply_tombstones(merge(parts))

    def count_upper(self, termhash: bytes) -> int:
        """Cheap upper bound on a term's posting count: run extents + RAM
        rows, no tombstone filtering."""
        with self._lock:
            total = sum(len(b[0]) for b in self._ram.get(termhash) or ())
            for run in self._runs:
                p = run.get(termhash)
                total += len(p) if p is not None else 0
            return total
