"""Device-resident postings serving: queries rank placed blocks in place.

Port of yacy_search_server_tpu/index/devstore.py, slice A: the device
arena, packing at `on_run_added`, and solo unfiltered `rank_term`.

- `DeviceArena`: growable int16 features, int32 flags, int32 docids (-1
  on pad rows), a tombstone bitmap and the per-tile bound rows `pmax`.
  Every frozen run packs into it once; each (run, term) is one
  contiguous extent, its rows reordered by the pack-time proxy score
  (the default profile against the span's frozen statistics, best
  first), so a query addresses its candidates by scalars.
- `DeviceSegmentStore.rank_term`: the pruned path scores the first tile
  of a single span and checks on the device, against `pmax`, that no
  other tile can beat the k-th score (kernel K5, `pruned_tile`); where
  the check fails the prefix grows through `_PRUNE_B` (K7 `span_score`
  over the prefix, kernel 3 `tie_topk`, `topk_finish`'s tail check).
  Where pruning cannot be used (several spans, a tombstone newer than
  the span) or fails at every size, the exact scan runs: K6
  `span_stats` over the live rows, K7, kernel 3, `topk_finish`. One
  device -> host copy a dispatch.

Ties rank by arena position, as the JAX package's `lax.top_k` merge does:
scores descending, then the row's place in the proxy-sorted extent (and
extents in span order), never the docid.

Queries with a constraint filter, a RAM delta or a facet bitmap return
None (the caller's host path serves them) and count a fallback; so do
packed spans, which this arena never holds, and `rank_join` declines
every conjunction. Left out: the query batcher, the top-k result cache,
device-loss handling, the join, bitmap and packed-word side tables, and
the JAX package's tracing and profiler hooks.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import resolve_device
from ..convert import profile_from_jax
from ..kernels import cardinal as KC
from ..kernels import devstore as KD
from ..kernels import tie_topk
from ..ops.ranking import (_ACTIVE_COLS, RankingProfile,
                           cardinal_from_stats_host, compact_feats,
                           pack_stats_host, profile_consts)
from . import postings as P

# the kernels read one TILE from a span's start; extents are not aligned,
# so the arena keeps at least one spare tile past its used rows
TILE = KD.TILE
NO_LANG = 0          # language filter sentinel (pack_language('') == 0)
NO_FLAG = -1         # contentdom flag sentinel
NEG_INF32 = -(2 ** 31 - 1)
INT32_MAX = 2 ** 31 - 1

# prune-prefix escalation buckets (tiles scored before tail verification)
_PRUNE_B = (1, 8, 64, 512, 4096)
# initial capacity of the reference's packed-words store: its budget
# check counts those words, so the same arithmetic keeps the same runs
# within budget
_PW_INITIAL_WORDS = 1 << 14
# safety margin added to stored proxy maxima: the device tf-normalization
# runs in float32 and may differ from the numpy pack-time computation by
# one unit, worth up to 1 << tf_coeff score points
_PMAX_MARGIN_EXTRA = 64


class Span:
    """One packed extent of a (run, term): arena rows + prune side-table."""

    __slots__ = ("start", "count", "tstart", "tcount", "stats", "dead_seq")

    def __init__(self, start, count, tstart=-1, tcount=0, stats=None,
                 dead_seq=-1):
        self.start = start        # first arena row
        self.count = count
        self.tstart = tstart      # first row in the pmax side-table
        self.tcount = tcount      # tiles in the side-table
        self.stats = stats        # frozen pack-time normalization stats
        # tombstone count at the span's run creation: pruning (frozen
        # stats) is exact only while no tombstone postdates the span;
        # -1 = unknown, never prunable until the next merge
        self.dead_seq = dead_seq

    def stats38(self) -> np.ndarray:
        """The frozen stats as the kernels' int32[38] (tf bounds as f32
        bits; host maximum and NaN flag 0)."""
        st = np.zeros(KC.STATS_LEN, np.int32)
        st[KC.S_COL_MIN:KC.S_COL_MIN + P.NF] = self.stats["col_min"]
        st[KC.S_COL_MAX:KC.S_COL_MAX + P.NF] = self.stats["col_max"]
        st[KC.S_TF_MIN] = np.float32(self.stats["tf_min"]).view(np.int32)
        st[KC.S_TF_MAX] = np.float32(self.stats["tf_max"]).view(np.int32)
        return st


def _signal_shift_vector(prof: RankingProfile) -> np.ndarray:
    """Every signal's shift coefficient in one fixed order (for the
    cross-profile bound max_s(cq_s - cp_s))."""
    bits_shifts = prof.flag_coeffs()[1]
    return np.concatenate([
        np.abs(prof.norm_coeffs())[_ACTIVE_COLS],
        np.array([prof.domlength, prof.tf, prof.language], np.int32),
        bits_shifts,
    ]).astype(np.int32)


_PROXY_PROFILE = RankingProfile()          # the pack-time ordering profile
_PROXY_SHIFTS = _signal_shift_vector(_PROXY_PROFILE)


def pack_prune_stats(f16, fl):
    """(frozen pack stats, proxy scores): the prune layout's scoring
    oracle."""
    stats = pack_stats_host(f16, fl)
    proxy = cardinal_from_stats_host(f16, fl, stats, _PROXY_PROFILE,
                                     P.pack_language("en"))
    return stats, proxy


def _bound_shift(prof: RankingProfile) -> int:
    """log2 of the bound factor M: score_q(row) <= proxy(row) << shift."""
    return int(np.max(_signal_shift_vector(prof) - _PROXY_SHIFTS))


def prune_bound_consts(profile):
    """(bound_shift, lang_term): the query-side tail-bound constants."""
    return (np.int32(_bound_shift(profile)),
            np.int32(255 << min(max(profile.language, 0), 15)))


def pmax_table(sorted_proxy: np.ndarray) -> np.ndarray:
    """Per-tile bound rows over a proxy-DESC-sorted span, margin folded
    in and clamped (see _PMAX_MARGIN_EXTRA)."""
    margin = (1 << _PROXY_PROFILE.tf) + _PMAX_MARGIN_EXTRA
    return np.minimum(sorted_proxy[::TILE] + margin,
                      INT32_MAX).astype(np.int32)


def _bucket_rows(n: int) -> int:
    """Size buckets for arena writes (pow2 and 1.5*pow2: <=33% pad)."""
    p = 1 << max(8, (n - 1).bit_length())
    if n <= p // 2 + p // 4:
        return p // 2 + p // 4
    return p


def pruned_query(arrays, sp: Span, shift: int, lang_term: int, consts,
                 kk: int, b: int) -> torch.Tensor:
    """One pruned query over the first min(b, tcount) tiles of a span, in
    the general kernel's form (_rank_pruned_kernel, init entries): the
    [2kk + 1] vector of scores, docids and ok, left on the device. b = 1
    is K5; a longer prefix (or kk past K5's 2048) is K7 over the prefix
    against the frozen stats, kernel 3 and topk_finish's tail check."""
    feats16, flags, docids, dead, pmax = arrays
    shift, lang_term = int(shift), int(lang_term)
    if b == 1 and kk <= KD.MAX_KK:
        desc = KD.pack_desc(
            [(sp.start, sp.count, sp.tstart, sp.tcount, sp.stats["col_min"],
              sp.stats["col_max"], sp.stats["tf_min"], sp.stats["tf_max"])],
            shift, lang_term)
        return KD.pruned_tile(feats16, flags, docids, dead, pmax, desc, kk,
                              consts, init=True)[0]
    scored = min(b, sp.tcount)
    ext = [(sp.start, min(sp.count, scored * TILE))]
    stats = torch.from_numpy(sp.stats38()).to(feats16.device)
    buf = KD.span_score(feats16, flags, docids, dead, ext, stats, consts,
                        max(ext[0][1], kk))
    top_s, top_rows, _ = tie_topk(buf, kk)
    return KD.topk_finish(top_s, top_rows, docids, ext, pmax=pmax,
                          tail=(sp.tstart, scored, sp.tcount, shift,
                                lang_term))


def scan_query(arrays, extents, consts, kk: int) -> torch.Tensor:
    """The exact two-pass scan over up to 8 extents: the [2kk + 36] vector
    of _rank_spans_packed_kernel (scores, docids, the live rows'
    col_min/col_max and tf bounds as f32 bits), left on the device."""
    feats16, flags, docids, dead, _pmax = arrays
    stats = KD.span_stats(feats16, docids, dead, extents)
    buf = KD.span_score(feats16, flags, docids, dead, extents, stats, consts,
                        max(sum(c for _s, c in extents), kk))
    top_s, top_rows, _ = tie_topk(buf, kk)
    return KD.topk_finish(top_s, top_rows, docids, extents, stats=stats)


class DeviceArena:
    """Growable device buffers holding packed postings extents.

    Appends write in place (`copy_`) into rows past the used mark: a
    query reading an earlier span reads rows past its own count only as
    far as its tile reaches, scores them -(2^31-1) and never returns
    them, so it is unaffected. Growth allocates new tensors and copies,
    so a query holding the old ones keeps a consistent snapshot, as the
    reference's `jnp.pad` did; so does a tombstone update of the bitmap.
    """

    def __init__(self, device=None, budget_bytes: int = 2 << 30,
                 initial_rows: int = 4 * TILE):
        self.device = resolve_device(device)
        self.budget_bytes = budget_bytes
        self._cap = initial_rows
        self._used = 0
        dev = self.device
        self._feats16 = torch.zeros((self._cap, P.NF), dtype=torch.int16,
                                    device=dev)
        self._flags = torch.zeros(self._cap, dtype=torch.int32, device=dev)
        self._docids = torch.full((self._cap,), -1, dtype=torch.int32,
                                  device=dev)
        self._doc_cap = 1 << 16
        self._dead = torch.zeros(self._doc_cap, dtype=torch.bool, device=dev)
        self._pending_dead: list[int] = []
        # prune side-table: per-tile proxy-score maxima (margin folded in);
        # pad slots hold INT32_MAX (never consulted: tcount caps the walk)
        self._tcap = 1 << 12
        self._tused = 0
        self._pmax = torch.full((self._tcap,), INT32_MAX, dtype=torch.int32,
                                device=dev)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @staticmethod
    def row_bytes() -> int:
        return P.NF * 2 + 4 + 4

    @property
    def used_rows(self) -> int:
        return self._used

    def would_fit(self, rows: int) -> bool:
        need = self._used + rows + TILE
        new_cap = self._cap
        while new_cap < need:          # growth doubles: budget the real cap
            new_cap *= 2
        return (new_cap * self.row_bytes() + _PW_INITIAL_WORDS * 4
                <= self.budget_bytes)

    def _grow_to(self, rows: int) -> None:
        new_cap = self._cap
        while new_cap < rows:
            new_cap *= 2
        if new_cap == self._cap:
            return
        dev = self.device
        f = torch.zeros((new_cap, P.NF), dtype=torch.int16, device=dev)
        fl = torch.zeros(new_cap, dtype=torch.int32, device=dev)
        d = torch.full((new_cap,), -1, dtype=torch.int32, device=dev)
        f[:self._cap].copy_(self._feats16)
        fl[:self._cap].copy_(self._flags)
        d[:self._cap].copy_(self._docids)
        self._feats16, self._flags, self._docids = f, fl, d
        self._cap = new_cap

    def append_block(self, chunks) -> int:
        """Pack a flat block streamed as (docids, feats) numpy chunks;
        returns the block's base row. The block is assembled in host
        buffers and written with one copy an array; buffers pad to size
        buckets, pad rows carry docid -1 and are overwritten by the next
        append or left inert past the used mark."""
        parts_d, parts_f = [], []
        for docids, feats in chunks:
            if len(docids):
                parts_d.append(np.asarray(docids))
                parts_f.append(np.asarray(feats))
        base = self._used
        if not parts_d:
            return base
        dd = np.concatenate(parts_d) if len(parts_d) > 1 else parts_d[0]
        ff = np.concatenate(parts_f) if len(parts_f) > 1 else parts_f[0]
        n = len(dd)
        pad = _bucket_rows(n)
        f16 = np.zeros((pad, P.NF), np.int16)
        fl = np.zeros(pad, np.int32)
        dpad = np.full(pad, -1, np.int32)
        cf, cfl = compact_feats(np.ascontiguousarray(ff, dtype=np.int32))
        f16[:n], fl[:n], dpad[:n] = cf, cfl, dd
        self._grow_to(self._used + pad + TILE)
        off = self._used
        self._feats16[off:off + pad].copy_(self._put(f16))
        self._flags[off:off + pad].copy_(self._put(fl))
        self._docids[off:off + pad].copy_(self._put(dpad))
        self._used += n
        return base

    def append_pmax(self, pmax: np.ndarray) -> int:
        """Add a span's per-tile bound rows to the side-table; returns
        their start. Growth doubles, pad slots INT32_MAX."""
        n = len(pmax)
        b = 1 << max(8, (n - 1).bit_length())  # min bucket 256 rows
        buf = np.full(b, INT32_MAX, np.int32)
        buf[:n] = pmax
        cap = self._tcap
        while cap < self._tused + b:
            cap *= 2
        if cap != self._tcap:
            grown = torch.full((cap,), INT32_MAX, dtype=torch.int32,
                               device=self.device)
            grown[:self._tcap].copy_(self._pmax)
            self._pmax, self._tcap = grown, cap
        start = self._tused
        self._pmax[start:start + b].copy_(self._put(buf))
        self._tused += n
        return start

    def mark_dead(self, docid: int) -> None:
        self._pending_dead.append(docid)

    def dead_array(self) -> torch.Tensor:
        """The dead bitmap with pending tombstones applied (lazy batch)."""
        if self._pending_dead:
            idx = np.asarray(self._pending_dead, np.int64)
            new_cap = self._doc_cap
            while new_cap < int(idx.max()) + 1:
                new_cap *= 2
            dead = torch.zeros(new_cap, dtype=torch.bool, device=self.device)
            dead[:self._doc_cap].copy_(self._dead)
            dead[self._put(idx)] = True
            self._dead, self._doc_cap = dead, new_cap
            self._pending_dead = []
        return self._dead

    def arrays(self):
        return self._feats16, self._flags, self._docids


class DeviceSegmentStore:
    """Span registry + query dispatch over a DeviceArena.

    Registered as the RWIIndex run listener (the port's index/rwi.py, or
    the JAX package's: the store reads `_runs`, `_tombstones`, `_lock`,
    `_ram_postings` and each run's `dead_seq`, `has`, `get`,
    `term_hashes` and `n_postings`)."""

    MAX_SPANS = KD.MAX_EXTENTS  # matches the RWI merge policy's max_runs

    def __init__(self, rwi, device=None, budget_bytes: int = 2 << 30):
        self.rwi = rwi
        self.arena = DeviceArena(device=device, budget_bytes=budget_bytes)
        # run id -> {termhash: Span}
        self._packed: dict[int, dict[bytes, Span]] = {}
        self._lock = threading.RLock()
        self._consts = None
        self._profile_key = None
        self._garbage_rows = 0
        # the attributes SearchEvent reads: a store-level small-candidate
        # threshold (None: the caller's SMALL_RANK_N) and the loss flag
        self.small_rank_n = None
        self.device_lost = False
        self.queries_served = 0
        self.fallbacks = 0
        # bumps on every event that can change a query's answer
        self.arena_epoch = 0
        self.prune_rounds = 0    # pruned dispatches (incl. escalations)
        self.pruned_tiles = 0    # tiles skipped by bound verification
        self.stream_scans = 0    # exact full-stream scans (no pruning)
        # seed tombstones recorded before this store existed
        for docid in rwi._tombstones:
            self.arena.mark_dead(docid)
        for run in list(rwi._runs):
            self.on_run_added(run)
        # attach last: a failed initial pack leaves the RWI untouched
        rwi.listener = self

    # -- packing (listener protocol) -----------------------------------------

    def _bump_epoch(self) -> None:
        with self._lock:
            self.arena_epoch += 1

    def on_run_added(self, run) -> None:
        """Pack a frozen run into one contiguous arena block, each term's
        rows reordered by the pack-time proxy score (descending) with its
        per-tile bound rows in the pmax side-table. The epoch bumps after
        the pack, also for runs the budget skips."""
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
            if not self.arena.would_fit(rows):
                return  # over budget: the run's terms stay host-served
            base = self.arena.used_rows
            meta: list[tuple] = []   # (th, rel_off, n, rel_toff, n_tiles,
            #                           stats)
            pmax_parts: list[np.ndarray] = []
            pending: list[tuple[np.ndarray, np.ndarray]] = []
            off = toff = 0
            for th in list(run.term_hashes()):
                p = run.get(th)
                if p is None or len(p) == 0:
                    continue
                f16, fl = compact_feats(p.feats)
                stats, proxy = pack_prune_stats(f16, fl)
                order = np.argsort(-proxy, kind="stable")
                n = len(p)
                n_tiles = (n + TILE - 1) // TILE
                pmax_parts.append(pmax_table(proxy[order]))
                meta.append((th, off, n, toff, n_tiles, stats))
                off += n
                toff += n_tiles
                pending.append((p.docids[order], p.feats[order]))
            if pending:
                self.arena.append_block(pending)
            tbase = self.arena.append_pmax(
                np.concatenate(pmax_parts) if pmax_parts
                else np.empty(0, np.int32))
            dseq = getattr(run, "dead_seq", -1)
            self._packed[rid] = {
                th: Span(base + o, n, tbase + to, nt, st, dseq)
                for th, o, n, to, nt, st in meta}

    # epoch bumps land after their mutation, as in the reference

    def on_run_removed(self, run) -> None:
        with self._lock:
            spans = self._packed.pop(id(run), None)
            if spans:
                self._garbage_rows += sum(sp.count for sp in spans.values())
            self._bump_epoch()
            # dead extents are reclaimed wholesale: once more than half
            # the arena is garbage, rebuild it from the live runs
            if (self._garbage_rows * 2 > max(self.arena.used_rows, 1)
                    and self._garbage_rows > 4 * TILE):
                self.repack()

    def on_run_swapped(self, old_run, new_run) -> None:
        """A run replaced by another form of the same rows: the extents
        stay valid, only the registry key moves (dropped terms retire)."""
        with self._lock:
            spans = self._packed.pop(id(old_run), None)
            if spans is not None:
                live = set(new_run.term_hashes())
                self._packed[id(new_run)] = {
                    th: ext for th, ext in spans.items() if th in live}
            self._bump_epoch()

    def on_doc_deleted(self, docid: int) -> None:
        self.arena.mark_dead(docid)
        self._bump_epoch()

    def on_term_dropped(self, run, termhash: bytes) -> None:
        with self._lock:
            spans = self._packed.get(id(run))
            if spans is not None:
                spans.pop(termhash, None)
            self._bump_epoch()

    def repack(self) -> None:
        """Rebuild the arena from live runs (reclaims dead extents); the
        tombstone bitmap carries over."""
        with self._lock:
            old = self.arena
            self._packed.clear()
            self.arena = DeviceArena(device=old.device,
                                     budget_bytes=old.budget_bytes)
            self.arena._dead = old._dead
            self.arena._doc_cap = old._doc_cap
            self.arena._pending_dead = old._pending_dead
            self._garbage_rows = 0
            for run in list(self.rwi._runs):
                self.on_run_added(run)      # bumps the epoch per run
            self._bump_epoch()              # incl. the zero-run rebuild

    # -- query dispatch -------------------------------------------------------

    def spans_for(self, termhash: bytes) -> list[Span] | None:
        """Arena extents covering ALL frozen postings of a term, oldest
        first, or None when any run holding the term is not packed."""
        with self._lock:
            out: list[Span] = []
            for run in list(self.rwi._runs):
                if not run.has(termhash):
                    continue
                spans = self._packed.get(id(run))
                if spans is None:
                    return None
                ext = spans.get(termhash)
                if ext is None:
                    return None
                out.append(ext)
            return out

    def _profile_consts(self, profile: RankingProfile, language: str):
        """The profile as the kernels' int32[44] on the arena's device,
        rebuilt when the profile or language changes."""
        key = (profile.to_external_string(), language)
        with self._lock:  # key and consts publish together
            if self._profile_key != key:
                self._consts = profile_consts(
                    profile, P.pack_language(language), self.arena.device)
                self._profile_key = key
            return self._consts

    def rank_join(self, include_hashes, exclude_hashes, profile,
                  language: str = "en", k: int = 100, **_filters):
        """Conjunctions are not served here yet: the caller's host join
        answers them."""
        return None

    def rank_term(self, termhash: bytes, profile, language: str = "en",
                  k: int = 100, lang_filter: int = NO_LANG,
                  flag_bit: int = NO_FLAG, from_days: int | None = None,
                  to_days: int | None = None, allow_bitmap=None):
        """Single-term ranked top-k from placed blocks: (scores, docids,
        considered) best-first, or None when the term is not fully
        resident or the query needs a filter, a RAM delta or a facet
        bitmap (the caller's host path serves it). `profile` is any
        ranking profile with `to_external_string()`; `considered` counts
        candidate rows before tombstone masking."""
        prof = profile_from_jax(profile.to_external_string())
        with self._lock:
            spans = self.spans_for(termhash)
            if spans is None or len(spans) > self.MAX_SPANS:
                self.fallbacks += 1
                return None
            feats16, flags, docids = self.arena.arrays()
            arrays = (feats16, flags, docids, self.arena.dead_array(),
                      self.arena._pmax)
        with self.rwi._lock:
            delta = self.rwi._ram_postings(termhash)
        if not spans and delta is None:
            return np.empty(0, np.int32), np.empty(0, np.int32), 0
        filtered = (lang_filter != NO_LANG or flag_bit != NO_FLAG
                    or from_days is not None or to_days is not None
                    or allow_bitmap is not None)
        if filtered or (delta is not None and len(delta)):
            with self._lock:
                self.fallbacks += 1
            return None
        considered = sum(sp.count for sp in spans)
        consts = self._profile_consts(prof, language)
        kk = max(16, 1 << (max(k, 1) - 1).bit_length())  # bucket k: pow2
        s = d = None
        # pruned fast path: one span whose frozen stats are still exact
        if (len(spans) == 1 and spans[0].tcount > 0
                and spans[0].dead_seq == len(self.rwi._tombstones)):
            sp = spans[0]
            shift, lang_term = prune_bound_consts(prof)
            for b in _PRUNE_B:
                # one fetch: scores ++ docids ++ ok
                host = pruned_query(arrays, sp, shift, lang_term, consts,
                                    kk, b).cpu().numpy()
                s, d, ok = host[:kk], host[kk:2 * kk], bool(host[2 * kk])
                with self._lock:
                    self.prune_rounds += 1
                    if ok:
                        self.pruned_tiles += max(0, sp.tcount - b)
                if ok:
                    break
                s = d = None  # bound failed: escalate the prefix
        if s is None:
            with self._lock:
                self.stream_scans += 1
            host = scan_query(arrays, [(sp.start, sp.count) for sp in spans],
                              consts, kk).cpu().numpy()
            s, d = host[:kk], host[kk:2 * kk]
        keep = (d >= 0) & (s > NEG_INF32)
        s, d = s[keep], d[keep]
        # cross-run duplicate docids: keep the best-scored instance
        _, first = np.unique(d, return_index=True)
        if len(first) != len(d):
            sel = np.sort(first)
            s, d = s[sel], d[sel]
        with self._lock:
            self.queries_served += 1
        return s[:k], d[:k], considered
