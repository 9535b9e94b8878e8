"""Device-resident postings serving: queries rank placed blocks in place.

Port of yacy_search_server_tpu/index/devstore.py: the device arena with
its join side-tables, packing at `on_run_added`, `rank_term` with RAM
deltas, constraint filters and facet bitmaps, solo `rank_join`, the
query batcher (index/batcher.py), the top-k result cache and the
serving counters.

- `DeviceArena`: growable int16 features, int32 flags, int32 docids (-1
  on pad rows), a tombstone bitmap and the per-tile bound rows `pmax`.
  Every frozen run packs into it once; each (run, term) is one
  contiguous extent, its rows reordered by the pack-time proxy score
  (the default profile against the span's frozen statistics, best
  first), so a query addresses its candidates by scalars. On the card
  every write is issued on the arena's own stream and recorded in an
  event (`written`) that a query's stream waits on before it reads:
  the batcher's dispatchers issue on streams of their own.
- `DeviceSegmentStore.rank_term`: a repeat of an unconstrained query is
  answered from the versioned top-k cache (`rank_cache_get`) with no
  device work. Otherwise the pruned path scores the first tile of a
  single span and checks on the device, against `pmax`, that no other
  tile can beat the k-th score (kernel K5, `pruned_tile`; with the
  batcher on, concurrent queries share one K5 launch a wave); where the
  check fails the prefix grows through `_PRUNE_B` (K7 `span_score` over
  the prefix, kernel 3 `tie_topk`, `topk_finish`'s tail check). Where
  pruning cannot be used (several spans, a tombstone newer than the
  span, a RAM delta) or fails at every size, the exact scan runs: K6
  `span_stats` over the live rows of the extents and of the term's RAM
  delta block (read from its own staging copy after the extents), K7,
  kernel 3, `topk_finish`. One device -> host copy a dispatch. A
  constraint filter (language, content flag, lastmod range) or a facet
  bitmap (`filter_bitmap`: site:/tld:/filetype:/protocol:) always takes
  the exact scan, with the filter in K6 and K7; K6's statistics are
  cached per (term, filter, bitmap) and reused while the snapshot they
  were taken on stands. With `scan_batching`, filtered scans without a
  delta or a bitmap share one batched K6/K7 launch a wave.
- `DeviceSegmentStore.rank_join`: the conjunction streams the rarest
  include term's span through K8 `join_member` (membership in every
  other include and every exclude by each term's docid-sorted segment or
  docid bitmap, partner rows merged, the filter applied), then kernels
  1-3 and `topk_finish` rank the merged rows. With the batcher on,
  concurrent conjunctions of one statics family share a wave
  (`join_batch_query`: K8 and kernels 1-2 with a slot dimension). A RAM
  delta declines, as in the reference.
- Device loss: every fetch goes through `device_fetch` (retries with
  backoff, a failure streak declares the device lost, a background
  rebuild re-packs the arena); while the device is lost `rank_term` and
  `rank_join` return None, counted, and the caller's host path serves.
- The hybrid dense rerank (`rerank_boost`, the second stage of a hybrid
  query): the candidates' doc vectors are gathered from the attached
  DenseVectorStore's forward index on the device (index/dense.py) and
  their fixed-scale cosine boost is added into the sparse scores (K9
  `dense_dot`, then K10 `rerank_sort` for the (score DESC, docid ASC)
  order); with the batcher's `rerank` kind concurrent reranks share one
  launch of each a wave. Full hybrid answers live in the same top-k
  cache, keyed also on alpha, the encoder version and the vectors'
  version (`hybrid_cache_get` / `hybrid_cache_put`).

- Packed residency (`packed_residency=True`): each (run, term) is a
  bit-packed block (ops/packed.py) instead of int16 rows. A block sits in
  the arena's packed-words store while the arena's one byte budget holds
  it ("hot"), else in host memory ("warm", up to `warm_budget_bytes`),
  else nowhere ("cold": rebuilt from the run on demand). A query on a
  hot term decodes its rows on the card: K5bp `pruned_tile_bp` for the
  pruned query (a failed bound goes straight to the exact scan), K6bp
  `span_stats_bp` and K7bp with its selection `span_topk_bp` for the
  exact scan (past kk 2048 K7bp `span_score_bp`, kernel 3 and
  `topk_finish_bp`; kernels/packed.py); the answers are the int16
  path's bit for bit. A query on a warm or cold term is a counted miss
  that the caller's host path serves, and it starts the term's promotion
  (inline, or through the batcher's `promote` kind): the block is placed
  hot, least recently used hot blocks demoted to warm and the store
  compacted where the budget needs the room. With `ingest_device_build`
  the blocks of a run are packed on the card (ingest/devbuild.py, K13).
  Facet bitmaps, RAM deltas and terms of several spans are declined on
  a packed store (counted fallbacks), joins on packed terms too, as in
  the reference.

- Dense-first candidate generation (`dense_first_topk`, the hybrid query's
  `densefirst=true` stage): the attached IVF ANN index (index/annstore.py)
  assigns each query its nprobe nearest centroids (K14 `ann_assign`, one
  launch a wave and nprobe) and the probed hot clusters' int8 vectors are
  scored and fused with the sparse candidates on the device (K15
  `ann_fuse`, one launch a (lane bucket, kk) group); warm clusters score
  on the host (the numpy oracle) and merge by (score DESC, docid ASC).
  With the batcher's `ann` kind concurrent queries share the launches;
  solo and batched answers are equal to the bit. While the device is
  lost, or a fetch fails, the index answers on the host (`search_host`).
  Dense-first answers live in the hybrid cache, keyed also on the
  index's centroid version (it bumps on a build and on a promotion).

Ties rank by arena position, as the JAX package's `lax.top_k` merge does:
scores descending, then the row's place in the proxy-sorted extent (and
extents in span order, the delta's rows last), never the docid.

Left out: the ingest scheduler's promotion deferral, the ANN index's cold
tier (its mmap slab: the port's index is memory only), the paged run files
(the port's runs live in memory, so a cold block is rebuilt from the
run), and the JAX package's tracing and profiler hooks (their
`counters()` keys read zero).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import weakref
from collections import OrderedDict, deque

import numpy as np
import torch

from .. import resolve_device
from ..convert import profile_from_jax
from ..kernels import cardinal as KC
from ..kernels import cardinal_score, cardinal_stats, tie_topk
from ..kernels import devstore as KD
from ..kernels import packed as KP
from ..ops import packed as PK
from ..ops.ranking import (_ACTIVE_COLS, RankingProfile,
                           cardinal_from_stats_host, compact_feats,
                           pack_stats_host, profile_consts)
from ..utils import faultinject
from . import postings as P

log = logging.getLogger("yacy.torch.devstore")

# the kernels read one TILE from a span's start; extents are not aligned,
# so the arena keeps at least one spare tile past its used rows
TILE = KD.TILE
NO_LANG = KD.NO_LANG            # language filter sentinel
NO_FLAG = KD.NO_FLAG            # contentdom flag sentinel
DAYS_NONE_LO = KD.DAYS_NONE_LO  # lastmod range sentinels
DAYS_NONE_HI = KD.DAYS_NONE_HI
NEG_INF32 = -(2 ** 31 - 1)
INT32_MAX = 2 ** 31 - 1
# entries of the filtered-stats cache (FIFO beyond)
_STATS_CACHE_CAP = 256
# the keys of the JAX store's counters() for machinery this port does not
# have yet (storage integrity, the profiler's silicon accounting, the
# paged runs' term cache): they read zero here
ZERO_COUNTERS = {
    "tunnel_rt_ms": 0.0, "util_pct_p50": 0.0, "util_pct_p95": 0.0,
    "bound": "", "storage_corruptions": 0,
    "journal_torn_tails": 0, "term_cache_hits": 0,
    "term_cache_misses": 0, "term_cache_evictions": 0, "term_cache_bytes": 0,
}
# the ANN index's counters for a store without one (the JAX store's)
ANN_ZERO_COUNTERS = {
    "ann_vectors": 0, "ann_clusters": 0, "ann_centroid_version": 0,
    "ann_hot_bytes": 0, "ann_warm_bytes": 0, "ann_cold_bytes": 0,
    "ann_tier_hot_hits": 0, "ann_tier_warm_hits": 0,
    "ann_tier_cold_hits": 0, "ann_promotions": 0,
    "ann_promote_failures": 0, "ann_lane_drops": 0,
}

# prune-prefix escalation buckets (tiles scored before tail verification)
_PRUNE_B = (1, 8, 64, 512, 4096)


class DeviceTransferError(RuntimeError):
    """A device -> host fetch failed through its whole retry ladder (the
    `device.transfer_fail` fault point; a CUDA runtime error is not one,
    device_fetch raises it as it is): the query's caller serves it on the
    host, counted."""


# a fetch retries TRANSFER_RETRIES times with exponential backoff from
# TRANSFER_BACKOFF_S before it counts as a failed transfer; LOSS_STREAK
# failed transfers in a row declare the device lost, and the rebuild
# probes the device first after REBUILD_BACKOFF_S. Read at each use, so a
# test or the smoke can tighten them (the JAX store keeps them per store)
TRANSFER_RETRIES = 2
TRANSFER_BACKOFF_S = 0.05
LOSS_STREAK = 2
REBUILD_BACKOFF_S = 0.5
# initial capacity of the reference's packed-words store: its budget
# check counts those words, so the same arithmetic keeps the same runs
# within budget
_PW_INITIAL_WORDS = 1 << 14
# safety margin added to stored proxy maxima: the device tf-normalization
# runs in float32 and may differ from the numpy pack-time computation by
# one unit, worth up to 1 << tf_coeff score points
_PMAX_MARGIN_EXTRA = 64


class Span:
    """One packed extent of a (run, term): arena rows + prune and join
    side-tables, or a bit-packed block of the packed-words store."""

    __slots__ = ("start", "count", "tstart", "tcount", "stats", "dead_seq",
                 "jstart", "jslot", "pbase", "pmeta", "row_bits", "tkey")

    def __init__(self, start, count, tstart=-1, tcount=0, stats=None,
                 dead_seq=-1, jstart=-1, jslot=-1, pbase=-1, pmeta=None,
                 row_bits=0, tkey=None):
        self.start = start        # first arena row (-1: a packed span)
        self.count = count
        # packed residency: the block's first word in the packed-words
        # store and its meta vector (ops/packed.py); -1 / None for int16
        self.pbase = pbase
        self.pmeta = pmeta
        self.row_bits = row_bits  # payload bits a row
        self.tkey = tkey          # (run id, termhash): the tier LRU's key
        self.tstart = tstart      # first row in the pmax side-table
        self.tcount = tcount      # tiles in the side-table
        self.stats = stats        # frozen pack-time normalization stats
        # tombstone count at the span's run creation: pruning (frozen
        # stats) is exact only while no tombstone postdates the span;
        # -1 = unknown, never prunable until the next merge
        self.dead_seq = dead_seq
        self.jstart = jstart      # first entry of its docid-sorted view in
        #                           the join side-table (-1: none)
        self.jslot = jslot        # its join-bitmap slot (-1: none)

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


def _bucket_rows_join(n: int) -> int:
    """The reference's rare-span window of a join (pow2 steps at 1/2, 5/8,
    3/4, 7/8, 1): a join declines where it does not fit the arena."""
    p = 1 << max(8, (n - 1).bit_length())
    for step in (p // 2, p // 2 + p // 8, p // 2 + p // 4,
                 p // 2 + p // 4 + p // 8, p):
        if n <= step:
            return step
    return p


def _side_bucket(n: int) -> int:
    return 1 << max(8, (n - 1).bit_length())  # min bucket 256 rows


_POPC8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                       axis=1).sum(1).astype(np.int32)


def join_bitmap(sorted_docids: np.ndarray, nwords: int) -> np.ndarray:
    """A term's join bitmap row: [nwords, 2] int32 of (word bits, set bits
    in the words before), over docids sorted ascending, all below
    32 nwords."""
    words = (sorted_docids >> 5).astype(np.int64)
    bits = np.uint32(1) << (sorted_docids & 31).astype(np.uint32)
    uw, starts = np.unique(words, return_index=True)
    bm = np.zeros(nwords, np.uint32)
    bm[uw] = np.bitwise_or.reduceat(bits, starts)
    pc = _POPC8[bm.view(np.uint8)].reshape(-1, 4).sum(1)
    prefix = np.zeros(nwords, np.int32)
    np.cumsum(pc[:-1], out=prefix[1:])
    return np.stack([bm.view(np.int32), prefix], axis=1)


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


def scan_query(arrays, extents, consts, kk: int, filt=None,
               stats=None, delta=None, allow=None) -> torch.Tensor:
    """The exact two-pass scan over up to 8 extents and a RAM delta block
    after them: the [2kk + 36] vector of _rank_spans_packed_kernel
    (scores, docids, the statistics' col_min/col_max and tf bounds as f32
    bits), left on the device. The rows are the live ones that pass the
    filter `filt` and the facet bitmap `allow`; `delta` is the block's
    (feats16, flags, docids); `stats` (int32[38] of those rows, from an
    earlier K6; never with a delta) skips K6."""
    feats16, flags, docids, dead, _pmax = arrays
    if stats is None:
        stats = KD.span_stats(feats16, docids, dead, extents, flags=flags,
                              filt=filt, delta=delta, allow=allow)
    rows = sum(c for _s, c in extents) + (
        delta[2].shape[0] if delta is not None else 0)
    buf = KD.span_score(feats16, flags, docids, dead, extents, stats, consts,
                        max(rows, kk), filt=filt, delta=delta, allow=allow)
    top_s, top_rows, _ = tie_topk(buf, kk)
    return KD.topk_finish(top_s, top_rows, docids, extents, stats=stats,
                          delta_docids=delta[2] if delta is not None
                          else None)


def scan_batch_query(arrays, scans, consts, kk: int) -> torch.Tensor:
    """A wave of up to 16 exact scans, each (extents, filter): the [bs,
    2kk] scores ++ docids of _rank_scan_batch_packed_kernel, left on the
    device; each slot's row equals scan_query's first 2kk entries for it
    alone. One batched K6 and one batched K7 that keeps each slot's kk
    best itself (the slots of identical extent lists reading them once),
    at every kk."""
    feats16, flags, docids, dead, _pmax = arrays
    desc = KD.scan_batch_desc(scans)
    stats = KD.span_stats_batch(feats16, flags, docids, dead, desc)
    return KD.span_topk_batch(feats16, flags, docids, dead, desc, stats,
                              consts, kk)


def join_query(arrays, join, start: int, count: int, parts, n_inc: int,
               consts, kk: int, filt=None) -> torch.Tensor:
    """One conjunction over the rare span's rows [start, start + count):
    K8, then kernel 1 (no host counts: the reference's num_hosts = 1 adds
    no authority term), kernel 2 on the int32 path, kernel 3 in index
    mode for min(kk, count) winners (ties by the row's place in the rare
    span) and topk_finish: the [2 min(kk, count) + 36] vector, left on
    the device. `join` is (jdocids, jpos, bmtab); `parts` as K8 takes
    them."""
    feats16, flags, docids, dead, _pmax = arrays
    merged, fo, v = KD.join_member(feats16, flags, docids, dead, start,
                                   count, *join, parts, n_inc, filt)
    stats, counts = cardinal_stats(merged, v, None, 0)
    sc = cardinal_score(merged, fo, v, None, stats, counts, consts, False)
    top_s, top_rows, _ = tie_topk(sc, min(kk, count))
    return KD.topk_finish(top_s, top_rows, docids, [(start, count)],
                          stats=stats)


def join_batch_query(arrays, join, desc, n_inc: int, consts,
                     kk: int) -> torch.Tensor:
    """A wave of up to 16 conjunctions over one snapshot and profile,
    `desc` the reference's qargs_batch (KD.join_wave_desc: a slot's rare
    span, filter and partner segments; slot -1 for a sort-mode one): the
    batched K8 writes each slot's merged rows into a region of its own
    (KD.join_wave_offsets), the batched kernels 1 and 2 take each slot's
    statistics and scores there, kernel 3 in index mode takes min(kk,
    count) winners of each slot over its region, and one batched finish
    maps them to docids: the [bs, 2kk] scores ++ docids, left on the
    device, (-(2^31-1), -1) past a slot's winners. After the keep mask a
    slot's row is join_query's answer for it alone and
    _rank_join_(bm_)batch_packed_kernel's row."""
    feats16, flags, docids, dead, _pmax = arrays
    desc = np.ascontiguousarray(desc, np.int32)
    bs = desc.shape[0]
    off = KD.join_wave_offsets(desc)
    merged, fo, v = KD.join_member_batch(feats16, flags, docids, dead, *join,
                                         desc, n_inc, off)
    stats = KD.join_stats_batch(merged, v, desc, off)
    sc = KD.join_score_batch(merged, fo, v, desc, off, stats, consts)
    # winners' rows 0 (a row the finish may read), scores -(2^31-1)
    top = torch.zeros((3, bs, kk), dtype=torch.int32, device=feats16.device)
    top[0].fill_(KC.SMALL)
    ext = []
    for i in range(bs):
        start, count = int(desc[i, 0]), int(desc[i, 1])
        ext.append(([(start, count)], KD.NO_FILTER))
        n = min(kk, count)
        if n:
            tie_topk(sc[int(off[i]):int(off[i]) + count], n,
                     out=(top[0, i, :n], top[1, i, :n], top[2, i, :n]))
    return KD.topk_finish_batch(top[0], top[2], docids,
                                KD.scan_batch_desc(ext))


def pruned_query_bp(words, dead, pmax, sp: Span, shift: int, lang_term: int,
                    consts, kk: int) -> torch.Tensor:
    """The b = 1 pruned query over a packed span (_rank_pruned_batch1_bp_
    kernel at one slot): the [2kk + 1] vector of scores, docids and ok,
    left on the device. K5bp; kk past its 2048: K7bp over the first tile
    against the frozen stats, kernel 3 and topk_finish_bp's tail check,
    the same function."""
    shift, lang_term = int(shift), int(lang_term)
    if kk <= KD.MAX_KK:
        desc = KP.pack_desc_bp(
            [(sp.pbase, sp.count, sp.tstart, sp.tcount, sp.stats["col_min"],
              sp.stats["col_max"], sp.stats["tf_min"], sp.stats["tf_max"])],
            [sp.pmeta], shift, lang_term)
        return KP.pruned_tile_bp(words, dead, pmax, desc, kk, consts)[0]
    rows = min(sp.count, TILE)
    stats = torch.from_numpy(sp.stats38()).to(words.device)
    buf = KP.span_score_bp(words, dead, sp.pbase, sp.pmeta, rows, stats,
                           consts, max(rows, kk))
    top_s, top_rows, _ = tie_topk(buf, kk)
    return KP.topk_finish_bp(top_s, top_rows, words, sp.pbase, sp.pmeta,
                             rows, pmax=pmax,
                             tail=(sp.tstart, sp.tcount, shift, lang_term))


def scan_query_bp(words, dead, sp: Span, consts, kk: int,
                  filt=None) -> torch.Tensor:
    """The exact two-pass scan over one packed span (_rank_scan_batch_bp_
    kernel at one slot): K6bp over the live rows that pass the filter,
    then K7bp with its selection (the reference's running merge order):
    [2kk] scores ++ docids, left on the device; a memset and two
    launches. Past KD.FUSED_KK, K7bp writes a score a row, kernel 3
    (index mode) ranks them and topk_finish_bp decodes the winners'
    docids."""
    stats = KP.span_stats_bp(words, dead, sp.pbase, sp.pmeta, sp.count,
                             filt)
    if kk <= KD.FUSED_KK:
        return KP.span_topk_bp(words, dead, sp.pbase, sp.pmeta, sp.count,
                               stats, consts, kk, filt)
    buf = KP.span_score_bp(words, dead, sp.pbase, sp.pmeta, sp.count, stats,
                           consts, max(sp.count, kk), filt)
    top_s, top_rows, _ = tie_topk(buf, kk)
    return KP.topk_finish_bp(top_s, top_rows, words, sp.pbase, sp.pmeta,
                             sp.count)


class DeviceArena:
    """Growable device buffers holding packed postings extents.

    Appends write in place (`copy_`) into rows past the used mark: a
    query reading an earlier span reads rows past its own count only as
    far as its tile reaches, scores them -(2^31-1) and never returns
    them, so it is unaffected. Growth allocates new tensors and copies,
    so a query holding the old ones keeps a consistent snapshot, as the
    reference's `jnp.pad` did; so does a tombstone update of the bitmap.

    On the card, every write (an append, a growth, a side-table or
    bitmap write, pending tombstones applied) is issued on one stream of
    the arena's (`_writing`), whichever thread or stream asks for it, and
    then recorded in the event `written`. So the writes are ordered among
    themselves, a tensor that a growth replaces is freed on the stream
    that read it last, and a query takes its snapshot and `written`
    together under the store's lock (DeviceSegmentStore.snapshot) and
    makes its own stream wait on the event (`wait_written`) before it
    launches: a dispatcher on another stream never reads rows in flight.

    Side-tables: the per-tile bound rows `pmax`, and for joins each span's
    docid-sorted view (`jdocids`, the arena row of each in `jpos`; pads
    INT32_MAX / 0) and, for big terms, a docid bitmap slot in `bmtab`
    [slots, nwords, 2] (word bits, rank prefix). nwords is fixed at the
    first bitmap (pow2 words over twice that term's largest docid); a
    term with a docid past it, or over the slot budget, gets no slot.

    The packed-words store (packed residency): one int32 tensor of the hot
    blocks' word streams, each appended at `_pw_used` (bucket-padded),
    its capacity counted in the arena's one byte budget beside the int16
    arrays. An append into unused capacity writes in place: a block's
    decode reads no word of a later block for its own rows. Growth and
    every compaction (`reset_packed`) allocate a fresh tensor, so a
    snapshot in flight keeps the old one. Words of demoted or retired
    blocks count in `packed_garbage_words` until a compaction.
    """

    # bitmap budget: slots are (nwords, 2) int32 rows
    JOIN_BITMAP_BYTES = 256 << 20
    JOIN_BITMAP_SLOTS = 64

    def __init__(self, device=None, budget_bytes: int = 2 << 30,
                 initial_rows: int = 4 * TILE, stream=None):
        self.device = resolve_device(device)
        self.budget_bytes = budget_bytes
        self._cap = initial_rows
        self._used = 0
        dev = self.device
        # the stream every write is issued on (the card; `stream`: a
        # rebuilt arena continues its predecessor's, whose tombstone
        # bitmap it takes over)
        self._wstream = None
        if dev.type == "cuda":
            self._wstream = stream or torch.cuda.Stream(dev)
        self.written = None   # the event after the last write (the card)
        with self._writing():
            self._alloc(dev)

    def _alloc(self, dev) -> None:
        """The empty tables (issued under `_writing`)."""
        self._feats16 = torch.zeros((self._cap, P.NF), dtype=torch.int16,
                                    device=dev)
        self._flags = torch.zeros(self._cap, dtype=torch.int32, device=dev)
        self._docids = torch.full((self._cap,), -1, dtype=torch.int32,
                                  device=dev)
        self._doc_cap = 1 << 16
        self._dead = torch.zeros(self._doc_cap, dtype=torch.bool, device=dev)
        self._pending_dead: list[int] = []
        # deletes arrive on the writer's thread without the store's lock
        self._pending_lock = threading.Lock()
        # prune side-table: per-tile proxy-score maxima (margin folded in);
        # pad slots hold INT32_MAX (never consulted: tcount caps the walk)
        self._tcap = 1 << 12
        self._tused = 0
        self._pmax = torch.full((self._tcap,), INT32_MAX, dtype=torch.int32,
                                device=dev)
        # join side-table: the spans' docid-sorted views
        self._jcap = 1 << 12
        self._jused = 0
        self._jdocids = torch.full((self._jcap,), INT32_MAX,
                                   dtype=torch.int32, device=dev)
        self._jpos = torch.zeros(self._jcap, dtype=torch.int32, device=dev)
        # join-bitmap side-table (nwords fixed at the first bitmap)
        self._bm_nwords = 0
        self._bm_cap = 0
        self._bm_used = 0
        self._bmtab = torch.zeros((1, 1, 2), dtype=torch.int32, device=dev)
        # the packed-words store
        self._pw_cap = _PW_INITIAL_WORDS
        self._pw_used = 0
        self._pwords = torch.zeros(self._pw_cap, dtype=torch.int32,
                                   device=dev)
        self.packed_garbage_words = 0

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @contextlib.contextmanager
    def _writing(self):
        """Issue the block's writes on the arena's stream and record
        their end in `written` (the card; elsewhere a no-op)."""
        if self._wstream is None:
            yield
            return
        with torch.cuda.stream(self._wstream):
            yield
            ev = torch.cuda.Event()
            ev.record(self._wstream)
            self.written = ev

    @staticmethod
    def wait_written(ev) -> None:
        """Make the current stream wait for the writes before `ev` (a
        snapshot's `written`; None: nothing to wait for)."""
        if ev is not None:
            torch.cuda.current_stream().wait_event(ev)

    @staticmethod
    def row_bytes() -> int:
        return P.NF * 2 + 4 + 4

    @property
    def used_rows(self) -> int:
        return self._used

    @property
    def capacity_rows(self) -> int:
        return self._cap

    def bytes_used(self) -> int:
        return (self._cap * self.row_bytes() + self._doc_cap
                + self._pw_cap * 4)

    def would_fit(self, rows: int) -> bool:
        need = self._used + rows + TILE
        new_cap = self._cap
        while new_cap < need:          # growth doubles: budget the real cap
            new_cap *= 2
        return (new_cap * self.row_bytes() + self._pw_cap * 4
                <= self.budget_bytes)

    def packed_would_fit(self, words: int) -> bool:
        """The hot tier's admission check: the word capacity an append of
        `words` would grow to (doubling), beside the int16 arrays and the
        tombstone bitmap, within the budget."""
        need = self._pw_used + _bucket_rows(words)
        new_cap = self._pw_cap
        while new_cap < need:
            new_cap *= 2
        return (self._cap * self.row_bytes() + self._doc_cap
                + new_cap * 4 <= self.budget_bytes)

    def append_packed_words(self, words: np.ndarray) -> int:
        """Place one packed block's word stream; returns its word base.
        The write pads to the size bucket with zeros (overwritten by the
        next append); growth doubles into a fresh tensor."""
        n = len(words)
        pad = _bucket_rows(n)
        buf = np.zeros(pad, np.int32)
        buf[:n] = words
        new_cap = self._pw_cap
        while new_cap < self._pw_used + pad:
            new_cap *= 2
        off = self._pw_used
        with self._writing():
            if new_cap != self._pw_cap:
                grown = torch.zeros(new_cap, dtype=torch.int32,
                                    device=self.device)
                grown[:self._pw_cap].copy_(self._pwords)
                self._pwords, self._pw_cap = grown, new_cap
            self._pwords[off:off + pad].copy_(self._put(buf))
        self._pw_used += n
        return off

    def reset_packed(self) -> None:
        """A fresh, empty packed-words store and pmax side-table (the
        compaction's start: a packed store's pmax rows are its blocks'
        alone); the old tensors stay with whoever holds them."""
        with self._writing():
            self._pw_cap = _PW_INITIAL_WORDS
            self._pw_used = 0
            self._pwords = torch.zeros(self._pw_cap, dtype=torch.int32,
                                       device=self.device)
            self._tcap = 1 << 12
            self._tused = 0
            self._pmax = torch.full((self._tcap,), INT32_MAX,
                                    dtype=torch.int32, device=self.device)
        self.packed_garbage_words = 0

    def packed_array(self) -> torch.Tensor:
        return self._pwords

    def packed_bytes_used(self) -> int:
        """Device bytes of the packed-words store (its capacity)."""
        return self._pw_cap * 4

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
        with self._writing():
            self._grow_to(self._used + pad + TILE)
            off = self._used
            self._feats16[off:off + pad].copy_(self._put(f16))
            self._flags[off:off + pad].copy_(self._put(fl))
            self._docids[off:off + pad].copy_(self._put(dpad))
        self._used += n
        return base

    def _side_write(self, arrays, fills, bufs, used: int, cap: int):
        """Write equal-length host buffers at `used` of 1-d side-tables of
        capacity `cap`, grown by doubling (new tensors, pads `fills`);
        returns (the arrays, their capacity)."""
        b = len(bufs[0])
        new_cap = cap
        while new_cap < used + b:
            new_cap *= 2
        with self._writing():
            if new_cap != cap:
                grown = []
                for a, fill in zip(arrays, fills):
                    g = torch.full((new_cap,), fill, dtype=torch.int32,
                                   device=self.device)
                    g[:cap].copy_(a)
                    grown.append(g)
                arrays = grown
            for a, buf in zip(arrays, bufs):
                a[used:used + b].copy_(self._put(buf))
        return arrays, new_cap

    def append_pmax(self, pmax: np.ndarray) -> int:
        """Add a span's per-tile bound rows to the side-table; returns
        their start. Growth doubles, pad slots INT32_MAX."""
        n = len(pmax)
        buf = np.full(_side_bucket(n), INT32_MAX, np.int32)
        buf[:n] = pmax
        start = self._tused
        (self._pmax,), self._tcap = self._side_write(
            [self._pmax], [INT32_MAX], [buf], start, self._tcap)
        self._tused += n
        return start

    def append_join_index(self, sorted_docids: np.ndarray,
                          sorted_pos: np.ndarray) -> int:
        """Add spans' docid-sorted (docid, arena row) views, each term's
        segment sorted, concatenated; returns their start."""
        n = len(sorted_docids)
        start = self._jused
        if n == 0:
            return start
        b = _side_bucket(n)
        dbuf = np.full(b, INT32_MAX, np.int32)
        pbuf = np.zeros(b, np.int32)
        dbuf[:n], pbuf[:n] = sorted_docids, sorted_pos
        (self._jdocids, self._jpos), self._jcap = self._side_write(
            [self._jdocids, self._jpos], [INT32_MAX, 0], [dbuf, pbuf], start,
            self._jcap)
        self._jused += n
        return start

    def join_arrays(self):
        return self._jdocids, self._jpos

    def bitmap_array(self):
        return self._bmtab

    def append_join_bitmaps(self, segs: list[np.ndarray]) -> list[int]:
        """Build the join bitmaps of docid-sorted segments and write them
        in one update; returns a slot a segment (-1: past the coverage,
        a negative docid, or no slot left)."""
        out: list[int] = []
        bufs: list[np.ndarray] = []
        for sorted_docids in segs:
            maxdoc = int(sorted_docids[-1])
            if self._bm_nwords == 0:
                # coverage: pow2 words over 2x the current docid space
                need = (2 * maxdoc + 32) // 32
                self._bm_nwords = 1 << max(15, (need - 1).bit_length())
            nbits = self._bm_nwords * 32
            max_slots = min(self.JOIN_BITMAP_SLOTS,
                            self.JOIN_BITMAP_BYTES // (self._bm_nwords * 8))
            if (maxdoc >= nbits or int(sorted_docids[0]) < 0
                    or self._bm_used + len(bufs) >= max_slots):
                out.append(-1)
                continue
            bufs.append(join_bitmap(sorted_docids, self._bm_nwords))
            out.append(self._bm_used + len(bufs) - 1)
        if bufs:
            need = self._bm_used + len(bufs)
            cap = max(self._bm_cap, 1)
            while cap < need:
                cap *= 2
            with self._writing():
                if (cap != self._bm_cap
                        or self._bmtab.shape[1] != self._bm_nwords):
                    # growth: a new table, the old slots copied over
                    fresh = torch.zeros((cap, self._bm_nwords, 2),
                                        dtype=torch.int32, device=self.device)
                    if self._bm_used:
                        fresh[:self._bm_used].copy_(
                            self._bmtab[:self._bm_used])
                    self._bmtab, self._bm_cap = fresh, cap
                self._bmtab[self._bm_used:need].copy_(
                    self._put(np.stack(bufs)))
            self._bm_used = need
        return out

    def mark_dead(self, docid: int) -> None:
        with self._pending_lock:
            self._pending_dead.append(docid)

    def dead_array(self) -> torch.Tensor:
        """The dead bitmap with pending tombstones applied (lazy batch,
        on the arena's stream after every earlier write, the previous
        bitmap among them): a new tensor each time, so a snapshot holding
        the old one keeps it."""
        with self._pending_lock:
            pending, self._pending_dead = self._pending_dead, []
        if pending:
            idx = np.asarray(pending, np.int64)
            new_cap = self._doc_cap
            while new_cap < int(idx.max()) + 1:
                new_cap *= 2
            with self._writing():
                dead = torch.zeros(new_cap, dtype=torch.bool,
                                   device=self.device)
                dead[:self._doc_cap].copy_(self._dead)
                dead[self._put(idx)] = True
            self._dead, self._doc_cap = dead, new_cap
        return self._dead

    def arrays(self):
        return self._feats16, self._flags, self._docids


class TopkCache:
    """Versioned LRU of final top-k answers (the JAX store's _TopkCache).

    Keyed by (termhash, profile string, language, kk); each entry holds
    the arena epoch it was computed against, and a hit is served only
    while the store's epoch is unchanged: every flush, merge, repack,
    delete and term drop bumps it. A RAM delta changes an answer without
    moving the epoch, so the store's lookup (rank_cache_get) declines
    terms with unflushed postings. Entries are the host arrays after the
    keep filter and the dedup, before the [:k] cut; `stale_ok` (degraded
    cache-only serving) answers from an epoch-stale entry and keeps it."""

    def __init__(self, cap: int = 512):
        self.cap = cap
        self.enabled = True
        self._lock = threading.Lock()
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.stale = 0
        self.misses = 0
        self.stale_served = 0

    def get(self, key, epoch: int, stale_ok: bool = False):
        with self._lock:
            if not self.enabled:
                return None
            got = self._d.get(key)
            if got is None:
                self.misses += 1
                return None
            e, s, d, considered = got
            if e != epoch:
                if stale_ok:
                    self.stale_served += 1
                    return s, d, considered
                del self._d[key]     # the index moved under the entry
                self.stale += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return s, d, considered

    def put(self, key, epoch: int, s, d, considered: int) -> None:
        with self._lock:
            if not self.enabled:
                return
            self._d[key] = (epoch, s, d, considered)
            self._d.move_to_end(key)
            while len(self._d) > self.cap:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


def _pctl(series, q: float) -> float:
    sv = sorted(series)
    if not sv:
        return 0.0
    return round(sv[min(len(sv) - 1, int(len(sv) * q))], 1)


class DeviceSegmentStore:
    """Span registry + query dispatch over a DeviceArena.

    Registered as the RWIIndex run listener (the port's index/rwi.py, or
    the JAX package's: the store reads `_runs`, `_tombstones`, `_lock`,
    `_ram_postings` and each run's `dead_seq`, `has`, `get`,
    `term_hashes` and `n_postings`)."""

    MAX_SPANS = KD.MAX_EXTENTS  # matches the RWI merge policy's max_runs
    # a join's terms (includes and excludes each), and its rare span's
    # rows (the merged int32 block is 68 B a row: 4M rows ~ 285 MB)
    MAX_JOIN_TERMS = 6
    MAX_JOIN_ROWS = 4_194_304
    # terms of at least this many rows get a join bitmap at pack time
    JOIN_BITMAP_MIN = 65_536

    def __init__(self, rwi, device=None, budget_bytes: int = 2 << 30,
                 packed_residency: bool = False,
                 warm_budget_bytes: int = 1 << 30):
        self.rwi = rwi
        # a packed store appends no int16 rows: its arena keeps the one
        # spare tile of them, and the budget goes to the packed words
        self.packed_residency = bool(packed_residency)
        self.arena = DeviceArena(device=device, budget_bytes=budget_bytes,
                                 initial_rows=self._initial_rows())
        # run id -> {termhash: Span}
        self._packed: dict[int, dict[bytes, Span]] = {}
        self._lock = threading.RLock()
        # the tier ladder of a packed store, a (run id, termhash) each:
        # {"block", "stats", "pmax", "count", "dead_seq", "hot",
        # "touched"}; the host block is the warm copy of a hot one
        self.warm_budget_bytes = warm_budget_bytes
        self._pblocks: dict[tuple, dict] = {}
        self._warm_bytes = 0                # the non-hot blocks' bytes
        self._promote_inflight: set = set()
        # off: no LRU touch, no miss attribution, no promotion (the
        # reference's idle-path switch); hot answers stay hot
        self._tiering_enabled = True
        self.tier_hot_hits = 0              # answers of a hot block
        self.tier_warm_hits = 0             # misses on a warm block
        self.tier_cold_hits = 0             # misses on a cold term
        self.tier_promotions_warm_hot = 0
        self.tier_promotions_cold_hot = 0
        self.tier_demotions_hot_warm = 0
        self.tier_evictions_warm_cold = 0
        self.tier_promote_async = 0         # promotions through the batcher
        self.tier_promote_failures = 0      # no room even after the LRU
        # pack a run's blocks on the card (ingest/devbuild.py, K13)
        self.ingest_device_build = False
        self.ingest_device_builds = 0       # blocks K13 laid down
        # (profile string, language) -> the kernels' int32[44] constants
        self._consts: OrderedDict = OrderedDict()
        self._garbage_rows = 0
        # the attributes SearchEvent reads: a store-level small-candidate
        # threshold (None: the caller's SMALL_RANK_N) and the loss flag
        self.small_rank_n = None
        self.device_lost = False
        # device loss (the JAX store's): device_fetch classifies every
        # fetch; a streak of failed ones declares the loss (epoch bumped,
        # the entry points answer None, counted) and a background rebuild
        # re-packs the arena until a probe round-trips again
        self.device_losses = 0            # declared losses
        self.device_loss_recoveries = 0   # rebuilds back to device serving
        self.device_lost_queries = 0      # host-fallback answers while lost
        self.transfer_failures = 0        # fetches that failed every attempt
        self.transfer_retries = 0         # attempts retried within a fetch
        self._transfer_fail_streak = 0
        self._rebuild_thread: threading.Thread | None = None
        self.queries_served = 0
        self.fallbacks = 0
        # bumps on every event that can change a query's answer
        self.arena_epoch = 0
        self.prune_rounds = 0    # pruned dispatches (incl. escalations)
        self.pruned_tiles = 0    # tiles skipped by bound verification
        self.stream_scans = 0    # exact full-stream scans (no pruning)
        # every join-shaped query lands in exactly one of these three
        self.join_served = 0
        self.join_fallbacks = 0
        self.join_degraded_plain = 0
        # a multi-span term declined a join: a merge would serve it
        self.merge_wanted = False
        # (termhash, lang, flag, from, to, facet bitmap id) -> (snapshot,
        # tombstone bitmap weakref, facet bitmap weakref, K6 statistics
        # int32[38] on the device), FIFO-capped
        self._span_stats_cache: dict[tuple, tuple] = {}
        self.filtered_served = 0     # exact scans under a facet bitmap
        self.batch_ineligible = 0    # batcher declines served solo
        self.device_round_trips = 0  # device -> host fetches (a wave: one)
        self._topk_cache = TopkCache()
        # facet bitmaps: combo -> (facet version, built at, int32 tensor)
        self._filter_cache: OrderedDict = OrderedDict()
        self._filter_inflight: dict = {}
        self._batcher = None
        self._scan_batching = False
        self._rerank_batching = False
        # the hybrid rerank: the attached DenseVectorStore and its counters
        self._dense = None
        self.rerank_dispatches = 0   # rerank launches (a wave: one)
        self.rerank_queries = 0      # reranks answered on the device
        self.rerank_cache_hits = 0   # hybrid answers from the top-k cache
        self.rerank_fallbacks = 0    # reranks left to the caller's host path
        # dense-first: the attached AnnVectorIndex (attach_ann), its knobs
        # and counters; batched under the rerank switch, as in the reference
        from ..ops.ann import ANN_DEFAULT_NPROBE, ANN_DEFAULT_PROBE_LANES
        self._ann = None
        self._ann_batching = False
        self.ann_nprobe = ANN_DEFAULT_NPROBE
        self.ann_probe_lanes = ANN_DEFAULT_PROBE_LANES
        self.ann_dispatches = 0      # K15 launches (a wave group: one)
        self.ann_queries = 0         # dense-first queries answered
        self.ann_fallbacks = 0       # no built index: the plain rerank serves
        self.ann_host_queries = 0    # answered on the host (device loss)
        # profile string -> the port's profile (parsed once)
        self._profiles: OrderedDict = OrderedDict()
        # seed tombstones recorded before this store existed
        for docid in rwi._tombstones:
            self.arena.mark_dead(docid)
        for run in list(rwi._runs):
            self.on_run_added(run)
        # attach last: a failed initial pack leaves the RWI untouched
        rwi.listener = self

    def _initial_rows(self) -> int:
        return TILE if self.packed_residency else 4 * TILE

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
        if self.packed_residency:
            self._pack_run_packed(run)
            return
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
            #                           stats); rel_off is the join
            #                           segment's offset too
            pmax_parts: list[np.ndarray] = []
            join_dd: list[np.ndarray] = []
            join_pos: list[np.ndarray] = []
            bm_segs: list[np.ndarray] = []     # big terms' sorted docids
            bm_at: list[int] = []              # their index into meta
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
                packed_dd = p.docids[order]
                # the docid-sorted view of the packed rows (absolute arena
                # rows): the join's lookup table
                jorder = np.argsort(packed_dd, kind="stable")
                sorted_dd = packed_dd[jorder].astype(np.int32)
                join_dd.append(sorted_dd)
                join_pos.append((base + off + jorder).astype(np.int32))
                if n >= self.JOIN_BITMAP_MIN:
                    bm_segs.append(sorted_dd)
                    bm_at.append(len(meta))
                meta.append((th, off, n, toff, n_tiles, stats))
                off += n
                toff += n_tiles
                pending.append((packed_dd, p.feats[order]))
            if pending:
                self.arena.append_block(pending)
            empty = np.empty(0, np.int32)
            tbase = self.arena.append_pmax(
                np.concatenate(pmax_parts) if pmax_parts else empty)
            jbase = self.arena.append_join_index(
                np.concatenate(join_dd) if join_dd else empty,
                np.concatenate(join_pos) if join_pos else empty)
            slots = dict(zip(bm_at, self.arena.append_join_bitmaps(bm_segs)
                             if bm_segs else []))
            dseq = getattr(run, "dead_seq", -1)
            self._packed[rid] = {
                th: Span(base + o, n, tbase + to, nt, st, dseq, jbase + o,
                         slots.get(i, -1))
                for i, (th, o, n, to, nt, st) in enumerate(meta)}

    # -- packed residency: the build and the tier ladder ----------------------

    def _build_packed_entry(self, p) -> dict:
        """One term's block, bit-packed in the int16 pack's proxy order,
        with its frozen stats and pmax bound rows: the same rows the int16
        path would place, so the answers are the same."""
        f16, fl = compact_feats(p.feats)
        stats, proxy = pack_prune_stats(f16, fl)
        order = np.argsort(-proxy, kind="stable")
        block = PK.pack_block(f16[order], fl[order],
                              p.docids[order].astype(np.int32))
        return {"block": block, "stats": stats,
                "pmax": pmax_table(proxy[order]), "count": len(p),
                "hot": False, "touched": time.monotonic()}

    def _place_hot_locked(self, key, ent, dead_seq) -> None:
        """Place one block in the packed-words store and register its
        span (the caller holds the lock and checked the room)."""
        rid, th = key
        block = ent["block"]
        wbase = self.arena.append_packed_words(block.words)
        tbase = self.arena.append_pmax(ent["pmax"])
        self._packed.setdefault(rid, {})[th] = Span(
            -1, ent["count"], tbase, len(ent["pmax"]), ent["stats"],
            dead_seq, pbase=wbase, pmeta=block.meta_vector(),
            row_bits=block.row_bits, tkey=key)
        if ent["hot"] is False and key in self._pblocks:
            self._warm_bytes -= block.packed_bytes
        ent["hot"] = True
        ent["touched"] = time.monotonic()

    def _build_packed_entries(self, plist: list) -> list:
        """[(th, postings)] -> [(th, entry)]: a run's blocks. With
        `ingest_device_build` the bit-pack is K13 on the arena's device
        (ingest/devbuild.py; blocks outside its row range and the stats
        and proxy order stay on the host). A failed launch raises to the
        run's writer: the reference's host pack after a device failure is
        not repeated here."""
        if not plist:
            return []
        if not self.ingest_device_build:
            return [(th, self._build_packed_entry(p)) for th, p in plist]
        from ..ingest import devbuild
        prep = []
        for th, p in plist:
            f16, fl = compact_feats(p.feats)
            stats, proxy = pack_prune_stats(f16, fl)
            order = np.argsort(-proxy, kind="stable")
            prep.append((th, p, f16[order], fl[order],
                         p.docids[order].astype(np.int32), stats,
                         pmax_table(proxy[order])))
        blocks = devbuild.pack_block_batch(
            [(f, g, d) for _t, _p, f, g, d, _s, _m in prep],
            self.arena.device)
        out = []
        now = time.monotonic()
        for (th, p, _f, _g, _d, stats, pmax), block in zip(prep, blocks):
            out.append((th, {"block": block, "stats": stats, "pmax": pmax,
                             "count": len(p), "hot": False,
                             "touched": now}))
            if devbuild.MIN_DEV_ROWS <= len(p) <= devbuild.MAX_DEV_ROWS:
                with self._lock:
                    self.ingest_device_builds += 1
        return out

    def _pack_run_packed(self, run) -> None:
        """A frozen run as packed blocks: hot while the arena's budget
        holds them, warm past it (the warm budget evicts the oldest to
        cold). The blocks are built outside the store's lock; no join
        side-tables are built (a join on a packed term declines)."""
        with self._lock:
            rid = id(run)
            if rid in self._packed:
                return
            self._packed[rid] = {}
            if run.n_postings == 0:
                return
            dseq = getattr(run, "dead_seq", -1)
        plist = []
        for th in list(run.term_hashes()):
            p = run.get(th)
            if p is not None and len(p):
                plist.append((th, p))
        ents = self._build_packed_entries(plist)
        with self._lock:
            # merged away while the blocks were built: never resurrect it
            if rid not in self._packed \
                    or not any(id(r) == rid for r in self.rwi._runs):
                return
            for th, ent in ents:
                if not run.has(th):     # dropped while packing
                    continue
                ent["dead_seq"] = dseq
                key = (rid, th)
                # a promotion that raced the build placed it already
                if key in self._pblocks or key in self._promote_inflight:
                    continue
                if self.arena.packed_would_fit(len(ent["block"].words)):
                    self._place_hot_locked(key, ent, dseq)
                else:
                    self._warm_bytes += ent["block"].packed_bytes
                self._pblocks[key] = ent
            self._enforce_warm_budget_locked()

    def _enforce_warm_budget_locked(self) -> None:
        """Evict the least recently touched warm blocks past the warm
        budget (warm -> cold: the run keeps the rows)."""
        while self._warm_bytes > self.warm_budget_bytes:
            victims = [(k, e) for k, e in self._pblocks.items()
                       if not e["hot"]]
            if not victims:
                return
            key, ent = min(victims, key=lambda kv: kv[1]["touched"])
            self._warm_bytes -= ent["block"].packed_bytes
            del self._pblocks[key]
            self.tier_evictions_warm_cold += 1

    def _demote_locked(self, key) -> None:
        """Hot -> warm: the span goes, its words become garbage until a
        compaction; the host block is the warm copy, nothing moves."""
        ent = self._pblocks.get(key)
        if ent is None or not ent["hot"]:
            return
        spans = self._packed.get(key[0])
        if spans is not None:
            spans.pop(key[1], None)
        ent["hot"] = False
        self.arena.packed_garbage_words += len(ent["block"].words)
        self._warm_bytes += ent["block"].packed_bytes
        self.tier_demotions_hot_warm += 1

    def _packed_live_padded_locked(self) -> int:
        """The bucket-padded words a compaction of the hot blocks takes."""
        return sum(_bucket_rows(len(e["block"].words))
                   for e in self._pblocks.values() if e["hot"])

    def _packed_fit_compact(self, live_padded: int, need: int) -> bool:
        """Would `need` more words fit after a compaction to the live
        blocks? (Demotion alone frees nothing until then.)"""
        total = live_padded + _bucket_rows(need)
        cap = _PW_INITIAL_WORDS
        while cap < total:
            cap *= 2
        return (self.arena._cap * self.arena.row_bytes()
                + self.arena._doc_cap + cap * 4
                <= self.arena.budget_bytes)

    def _repack_packed_locked(self) -> None:
        """Compact the packed-words store and its pmax side-table from the
        hot blocks' host copies, into fresh tensors and fresh Span
        objects: a query in flight keeps the old tensors and the old
        spans, which agree. The caller bumps the epoch."""
        arena = self.arena
        arena.reset_packed()
        for (rid, th), ent in self._pblocks.items():
            if not ent["hot"]:
                continue
            spans = self._packed.get(rid)
            old = spans.get(th) if spans is not None else None
            if old is None:
                continue
            wbase = arena.append_packed_words(ent["block"].words)
            tbase = arena.append_pmax(ent["pmax"])
            spans[th] = Span(-1, old.count, tbase, old.tcount, old.stats,
                             old.dead_seq, pbase=wbase, pmeta=old.pmeta,
                             row_bits=old.row_bits, tkey=old.tkey)

    def _touch_packed(self, sp) -> None:
        """The LRU stamp of a hot block (its demotion order)."""
        if not self._tiering_enabled or sp.tkey is None:
            return
        ent = self._pblocks.get(sp.tkey)
        if ent is not None:
            ent["touched"] = time.monotonic()

    def _note_tier_miss(self, termhash: bytes) -> None:
        """A query's term is not hot: count the miss once, at the best tier
        that holds it (warm block, else cold run), and start its
        promotion so that a later query serves it packed. This query is
        the caller's host path's. A term of several runs is not promoted
        (its spans cannot serve packed until a merge, which is asked
        for)."""
        if not (self.packed_residency and self._tiering_enabled):
            return
        promote: list[tuple] = []
        hit_tier = None
        with self._lock:
            holders = [run for run in list(self.rwi._runs)
                       if run.has(termhash)]
            for run in holders:
                key = (id(run), termhash)
                spans = self._packed.get(id(run))
                if spans is not None and termhash in spans:
                    continue            # hot in this run
                ent = self._pblocks.get(key)
                if ent is not None:
                    hit_tier = "warm"
                    ent["touched"] = time.monotonic()
                elif hit_tier is None:
                    hit_tier = "cold"
                if key in self._promote_inflight:
                    continue
                self._promote_inflight.add(key)
                promote.append((key, run))
            if hit_tier == "warm":
                self.tier_warm_hits += 1
            elif hit_tier == "cold":
                self.tier_cold_hits += 1
            if len(holders) != 1 and promote:
                self.merge_wanted = True
                for key, _run in promote:
                    self._promote_inflight.discard(key)
                promote = []
        for key, run in promote:
            self._submit_promote(key, run)

    def _submit_promote(self, key, run) -> None:
        """Queue one promotion: through the batcher's `promote` kind where
        one runs (its completer fetches the probe; nobody waits), else
        inline."""
        b = self._batcher
        if b is not None and not b._stop:
            with self._lock:
                self.tier_promote_async += 1
            b.submit_promote(key, run)
        else:
            self._promote_now(key, run)

    def _promote_now(self, key, run):
        """Place one block hot (built from the run where it is cold),
        demoting the least recently used hot blocks and compacting where
        the budget needs the room; bump the epoch. Returns the probe, K12's
        decode of the block's first row from the new words (a [19] int32
        tensor, fetched by the batcher's completer), the row the host
        block holds there, and the words tensor the probe reads (held
        until it is fetched: a compaction may replace it in the arena);
        None where the promotion did not happen (the run retired, a
        race, or no room: counted)."""
        rid, th = key
        try:
            with self._lock:
                if not any(id(r) == rid for r in self.rwi._runs):
                    return None
                ent = self._pblocks.get(key)
                src = "warm" if ent is not None else "cold"
            if ent is None:
                p = run.get(th)
                if p is None or len(p) == 0:
                    return None
                ent = self._build_packed_entry(p)
                ent["dead_seq"] = getattr(run, "dead_seq", -1)
            with self._lock:
                if not any(id(r) == rid for r in self.rwi._runs):
                    return None          # retired while building
                spans = self._packed.get(rid)
                if spans is not None and th in spans:
                    return None          # raced: already hot
                need = len(ent["block"].words)
                if not self.arena.packed_would_fit(need):
                    live = self._packed_live_padded_locked()
                    demoted = False
                    while not self._packed_fit_compact(live, need):
                        hot = [(k, e) for k, e in self._pblocks.items()
                               if e["hot"] and k != key]
                        if not hot:
                            self.tier_promote_failures += 1
                            return None
                        vkey, vent = min(hot,
                                         key=lambda kv: kv[1]["touched"])
                        live -= _bucket_rows(len(vent["block"].words))
                        self._demote_locked(vkey)
                        demoted = True
                    if demoted or self.arena.packed_garbage_words:
                        self._repack_packed_locked()
                    if not self.arena.packed_would_fit(need):
                        self.tier_promote_failures += 1
                        return None
                self._place_hot_locked(key, ent, ent["dead_seq"])
                self._pblocks[key] = ent
                if src == "warm":
                    self.tier_promotions_warm_hot += 1
                else:
                    self.tier_promotions_cold_hot += 1
                sp = self._packed[rid][th]
                words, written = self.arena.packed_array(), \
                    self.arena.written
            self._bump_epoch()
            DeviceArena.wait_written(written)
            f, fl, d = KP.unpack_rows(words, sp.pbase, sp.pmeta, 0, 1)
            probe = torch.cat([f[0], fl, d])
            blk = ent["block"]
            want = PK.unpack_block(PK.PackedBlock(
                blk.words, 1, blk.word_offs, blk.widths, blk.mins))
            return probe, np.concatenate([want[0][0].astype(np.int32),
                                          want[1], want[2]]), words
        finally:
            with self._lock:
                self._promote_inflight.discard(key)

    def tier_bytes(self) -> dict:
        """Bytes a tier: hot = the arena's int16 rows and packed words in
        use, warm = the host blocks awaiting promotion, cold = 0 (the
        port's runs live in memory: no paged run files yet)."""
        with self._lock:
            hot = (self.arena.used_rows * self.arena.row_bytes()
                   + self.arena._pw_used * 4)
            return {"hot": hot, "warm": self._warm_bytes, "cold": 0}

    def packed_compression_ratio(self) -> float:
        """int16 bytes / packed bytes of the hot blocks (of all blocks when
        none is hot; 1.0 without a block)."""
        with self._lock:
            blocks = ([e["block"] for e in self._pblocks.values()
                       if e["hot"]]
                      or [e["block"] for e in self._pblocks.values()])
            packed = sum(b.packed_bytes for b in blocks)
            orig = sum(b.int16_bytes for b in blocks)
        return round(orig / packed, 3) if packed else 1.0

    # epoch bumps land after their mutation, as in the reference

    def on_run_removed(self, run) -> None:
        with self._lock:
            rid = id(run)
            spans = self._packed.pop(rid, None)
            if spans:
                self._garbage_rows += sum(sp.count for sp in spans.values()
                                          if sp.pbase < 0)
            # the run's blocks retire from every tier
            for key in [k for k in self._pblocks if k[0] == rid]:
                ent = self._pblocks.pop(key)
                if ent["hot"]:
                    self.arena.packed_garbage_words += len(
                        ent["block"].words)
                else:
                    self._warm_bytes -= ent["block"].packed_bytes
            self._bump_epoch()
            # dead extents are reclaimed wholesale: once more than half
            # the arena (or of the packed words) is garbage, rebuild it
            # from the live runs
            if (self._garbage_rows * 2 > max(self.arena.used_rows, 1)
                    and self._garbage_rows > 4 * TILE) or \
                    (self.arena.packed_garbage_words * 2
                     > max(self.arena._pw_used, 1)
                     and self.arena.packed_garbage_words > 1 << 18):
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
                for ext in self._packed[id(new_run)].values():
                    if ext.tkey is not None:
                        ext.tkey = (id(new_run), ext.tkey[1])
            # the tier entries follow the key (dropped terms retire)
            for key in [k for k in self._pblocks if k[0] == id(old_run)]:
                ent = self._pblocks.pop(key)
                if new_run.has(key[1]):
                    self._pblocks[(id(new_run), key[1])] = ent
                elif ent["hot"]:
                    self.arena.packed_garbage_words += len(
                        ent["block"].words)
                else:
                    self._warm_bytes -= ent["block"].packed_bytes
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

    def live_rows(self) -> int:
        """Rows of every packed span (the operator page's `live_rows`)."""
        with self._lock:
            return sum(sp.count for spans in self._packed.values()
                       for sp in spans.values())

    def repack(self) -> None:
        """Rebuild the arena from live runs (reclaims dead extents); the
        tombstone bitmap carries over."""
        with self._lock:
            old = self.arena
            self._packed.clear()
            # the tier ladder rebuilds with the runs: hot and warm are
            # decided anew in a clean arena
            self._pblocks.clear()
            self._warm_bytes = 0
            self._promote_inflight.clear()
            self.arena = DeviceArena(device=old.device,
                                     budget_bytes=old.budget_bytes,
                                     initial_rows=self._initial_rows(),
                                     stream=old._wstream)
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

    def _arrays_locked(self):
        """The arena's tensors as a query reads them, (feats16, flags,
        docids, tombstone bitmap with pending tombstones applied, pmax),
        and the event after the writes they hold (None off the card); the
        caller holds the lock. The one rule of a query on the card: its
        stream waits on the event before it launches
        (DeviceArena.wait_written), and it holds the tensors until its
        answer is on the host (the arena replaces, never frees, a tensor
        a snapshot may hold, and writes on a stream of its own)."""
        feats16, flags, docids = self.arena.arrays()
        return ((feats16, flags, docids, self.arena.dead_array(),
                 self.arena._pmax), self.arena.written)

    def snapshot(self, termhashes, postings: bool = False,
                 words: bool = False):
        """One consistent view for single-term queries over
        `termhashes`: (arrays, written, {th: spans_for(th)}, arena epoch,
        tombstone count, {th: RAM delta}), the first two as
        _arrays_locked's, and with `words` the packed-words store last.
        The delta of a term is its `_ram_postings` with `postings`, else
        whether it has one (None for a term that is not fully
        resident)."""
        with self._lock:
            arrays, written = self._arrays_locked()
            pwords = self.arena.packed_array()
            spans = {th: self.spans_for(th) for th in termhashes}
            epoch = self.arena_epoch
            tomb = len(self.rwi._tombstones)
        with self.rwi._lock:
            ram = {th: None if sp is None
                   else self.rwi._ram_postings(th) if postings
                   else bool(self.rwi._ram.get(th))
                   for th, sp in spans.items()}
        if words:
            return arrays, written, spans, epoch, tomb, ram, pwords
        return arrays, written, spans, epoch, tomb, ram

    _CONSTS_CAP = 64

    def _profile_consts(self, profile: RankingProfile, language: str):
        """The profile as the kernels' int32[44] on the arena's device,
        one a (profile, language) pair (LRU of _CONSTS_CAP), so that
        queries of different profiles never rebuild one another's. A new
        tensor is complete before it is published: another thread's
        stream may read it next."""
        key = (profile.to_external_string(), language)
        with self._lock:
            got = self._consts.get(key)
            if got is not None:
                self._consts.move_to_end(key)
                return got
        got = profile_consts(profile, P.pack_language(language),
                             self.arena.device)
        if got.device.type == "cuda":
            torch.cuda.current_stream(got.device).synchronize()
        with self._lock:
            got = self._consts.setdefault(key, got)
            while len(self._consts) > self._CONSTS_CAP:
                self._consts.popitem(last=False)
            return got

    def rank_join(self, include_hashes, exclude_hashes, profile,
                  language: str = "en", k: int = 100,
                  lang_filter: int = NO_LANG, flag_bit: int = NO_FLAG,
                  from_days: int | None = None, to_days: int | None = None):
        """Conjunctive ranked top-k on the device: (scores, docids,
        considered) best-first, or None where the caller's host join
        serves. Every join-shaped query (two or more includes, or one with
        excludes) lands in exactly one of join_served, join_fallbacks and
        join_degraded_plain; a query whose excludes all name terms with no
        postings is a single-term query and goes to rank_term. While the
        device is lost, or where a fetch under the query fails
        (DeviceTransferError), the answer is None, counted in
        device_lost_queries and join_fallbacks."""
        if self.device_lost:
            with self._lock:
                self.device_lost_queries += 1
                self.join_fallbacks += 1
            return None
        try:
            out = self._rank_join_impl(include_hashes, exclude_hashes,
                                       profile, language, k, lang_filter,
                                       flag_bit, from_days, to_days)
        except DeviceTransferError:
            # counted (and perhaps the loss declared) by device_fetch
            with self._lock:
                self.device_lost_queries += 1
                self.join_fallbacks += 1
            return None
        if out == "declined":
            with self._lock:
                self.join_fallbacks += 1
            return None
        if out == "plain":
            with self._lock:
                self.join_degraded_plain += 1
            return self.rank_term(
                include_hashes[0], profile, language, k=k,
                lang_filter=lang_filter, flag_bit=flag_bit,
                from_days=from_days, to_days=to_days)
        if out is not None:
            with self._lock:
                self.join_served += 1
        return out

    def _join_span_locked(self, termhash: bytes):
        """The single joinable span of a term; None and `merge_wanted`
        where it has several, None where it has no join view, [] where no
        run holds it (caller holds the lock)."""
        spans = self.spans_for(termhash)
        if spans is None:
            return None
        if len(spans) > 1:
            # a merge returns the term to one (joinable) span
            self.merge_wanted = True
            return None
        if spans and spans[0].jstart < 0:
            return None
        return spans

    def _rank_join_impl(self, include_hashes, exclude_hashes, profile,
                        language, k, lang_filter, flag_bit, from_days,
                        to_days):
        """The join itself: None for a shape that is not a join, "plain",
        "declined" (a counted fallback), or the answer."""
        include_hashes = list(include_hashes)
        exclude_hashes = list(exclude_hashes or [])
        if (not include_hashes
                or (len(include_hashes) == 1 and not exclude_hashes)
                or len(include_hashes) > self.MAX_JOIN_TERMS
                or len(exclude_hashes) > self.MAX_JOIN_TERMS):
            return None
        prof = self._port_profile(profile)
        with self._lock:
            inc_spans = []
            for th in include_hashes:
                spans = self._join_span_locked(th)
                if not spans:
                    self.fallbacks += 1
                    return "declined"
                inc_spans.append(spans[0])
            exc_spans = []
            for th in exclude_hashes:
                spans = self.spans_for(th)
                if spans is None:
                    # not packed: a term with no postings excludes nothing
                    if self.rwi.has_term(th):
                        self.fallbacks += 1
                        return "declined"
                    continue
                spans = self._join_span_locked(th)
                if spans is None:
                    self.fallbacks += 1
                    return "declined"
                exc_spans += spans
            arrays, written = self._arrays_locked()
            join = (*self.arena.join_arrays(), self.arena.bitmap_array())
        feats16 = arrays[0]
        # RAM deltas are not joinable on the device; the counter bump
        # happens outside the rwi lock (the store -> rwi lock order)
        with self.rwi._lock:
            ram_delta = any(self.rwi._ram_postings(th) is not None
                            for th in include_hashes + exclude_hashes)
        if ram_delta:
            with self._lock:
                self.fallbacks += 1
            return "declined"
        if len(inc_spans) == 1 and not exc_spans:
            return "plain"   # every exclude named a term with no postings
        rare_i = min(range(len(inc_spans)), key=lambda i: inc_spans[i].count)
        rare = inc_spans[rare_i]
        partners = [sp for i, sp in enumerate(inc_spans) if i != rare_i]
        # the reference's static rare window must fit the arena
        r = min(_bucket_rows_join(rare.count), feats16.shape[0] - rare.start)
        jcap, nslots = join[0].shape[0], join[2].shape[0]

        def part(sp):
            """(jstart, count, bitmap slot or -1), None where the
            reference's sorted-segment window does not fit the table."""
            if 0 <= sp.jslot < nslots:
                return sp.jstart, sp.count, sp.jslot
            m = min(_bucket_rows(sp.count), jcap - sp.jstart)
            return (sp.jstart, sp.count, -1) if m >= sp.count else None

        parts = [part(sp) for sp in partners + exc_spans]
        if (r < rare.count or rare.count > self.MAX_JOIN_ROWS
                or any(p is None for p in parts)):
            with self._lock:
                self.fallbacks += 1
            return "declined"
        consts = self._profile_consts(prof, language)
        kk = max(16, 1 << (max(k, 1) - 1).bit_length())
        filt = (lang_filter, flag_bit,
                DAYS_NONE_LO if from_days is None else from_days,
                DAYS_NONE_HI if to_days is None else to_days)
        s = d = None
        # concurrent conjunctions of one statics family, profile, language
        # and snapshot share a wave (the reference's route, :4793-4812)
        batcher = self._batcher
        if batcher is not None and not batcher.owns_current_thread():
            n_inc, n_exc = len(partners), len(exc_spans)
            bm = tuple(p[2] >= 0 for p in parts)
            qargs = KD.join_wave_desc([(rare.start, rare.count, filt, parts)],
                                      n_inc, n_exc)[0]
            res = batcher.submit_join(
                arrays, join, written, qargs,
                (kk, n_inc, n_exc, bm[:n_inc], bm[n_inc:]), prof, language)
            if res[0] == "ok":
                s, d = res[1], res[2]
            elif res[0] == "ineligible":
                with self._lock:
                    self.batch_ineligible += 1
            # "ineligible" / "timeout": the solo join below serves it
        if s is None:
            DeviceArena.wait_written(written)
            host = self.device_fetch(join_query(
                arrays, join, rare.start, rare.count, parts, len(partners),
                consts, kk, filt))
            self.count_round_trip()
            n = min(kk, rare.count)
            s, d = host[:n], host[n:2 * n]
        keep = (d >= 0) & (s > NEG_INF32)
        with self._lock:
            self.queries_served += 1
        return s[keep][:k], d[keep][:k], rare.count

    def _port_profile(self, profile) -> RankingProfile:
        """The port's profile of any profile with to_external_string(),
        parsed once a string."""
        key = profile.to_external_string()
        with self._lock:
            got = self._profiles.get(key)
            if got is None:
                got = self._profiles[key] = profile_from_jax(key)
                while len(self._profiles) > 64:
                    self._profiles.popitem(last=False)
            return got

    def count_round_trip(self) -> None:
        with self._lock:
            self.device_round_trips += 1

    # -- device loss ----------------------------------------------------------

    def device_fetch(self, out: torch.Tensor, done=None) -> np.ndarray:
        """The host copy of a dispatch's answer, every fetch of the store
        and the batcher classified as the JAX store's device_fetch does: a
        failed attempt retries TRANSFER_RETRIES times with exponential
        backoff from TRANSFER_BACKOFF_S (transfer_retries); a fetch that
        fails every attempt counts in transfer_failures and raises
        DeviceTransferError, and LOSS_STREAK of those in a row declare the
        device lost. `done`: the event after a non-blocking copy into
        `out` (a wave's pinned host buffer), waited on first. The
        `device.transfer_fail` fault point costs one charge an attempt.

        Only a DeviceTransferError counts as a failed transfer. Any other
        error of the wait or the copy raises as it is, in the query's own
        thread: on the card that is a CUDA runtime error (an illegal
        address or a failed assert in a kernel of the dispatch, an Xid,
        an ECC error), which is sticky. It fails every later call of the
        process, so no retry or rebuild could serve again; recovery
        needs a process restart, and counting it as a lost device would
        hide a kernel fault behind the host fallback."""
        delay = TRANSFER_BACKOFF_S
        attempt = 0
        while True:
            try:
                if faultinject.take("device.transfer_fail"):
                    raise DeviceTransferError(
                        "injected device.transfer_fail")
                if done is not None:
                    done.synchronize()
                host = out.cpu().numpy()
            except DeviceTransferError as e:
                if attempt < TRANSFER_RETRIES:
                    attempt += 1
                    with self._lock:
                        self.transfer_retries += 1
                    time.sleep(delay)
                    delay *= 2
                    continue
                self._note_transfer_failure(e)
                raise DeviceTransferError(
                    f"device transfer failed after {attempt + 1} "
                    f"attempts: {e!r}") from e
            with self._lock:
                self._transfer_fail_streak = 0
            return host

    def _note_transfer_failure(self, err) -> None:
        with self._lock:
            self.transfer_failures += 1
            self._transfer_fail_streak += 1
            declare = (not self.device_lost
                       and self._transfer_fail_streak >= LOSS_STREAK)
        if declare:
            self._declare_device_loss(err)

    def _declare_device_loss(self, err) -> None:
        """A streak of failed transfers: the entry points answer None
        (the caller's host path serves, counted), every cached answer
        dies with the epoch, and the background rebuild starts."""
        with self._lock:
            if self.device_lost:
                return
            self.device_lost = True
            self.device_losses += 1
            self._transfer_fail_streak = 0
        self._bump_epoch()
        log.error("device lost after %d failed transfers in a row (%r): "
                  "serving the host fallback; rebuild started",
                  LOSS_STREAK, err)
        self.start_rebuild()

    def start_rebuild(self) -> None:
        """Run the background rebuild while the device is lost (a no-op
        when it is not, or the rebuild runs)."""
        with self._lock:
            if not self.device_lost:
                return
            t = self._rebuild_thread
            if t is not None and t.is_alive():
                return
            t = threading.Thread(target=self._rebuild_loop,
                                 name="torch-devstore-rebuild", daemon=True)
            self._rebuild_thread = t
        t.start()

    def _rebuild_loop(self) -> None:
        """Probe the device with backoff (doubling, at most 30 s); once a
        one-word upload and fetch round-trips, rebuild the arena and
        resume device serving."""
        delay = REBUILD_BACKOFF_S
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
                torch.zeros(1, dtype=torch.int32,
                            device=self.arena.device).cpu()
            except Exception as e:  # noqa: BLE001 - the device is still down
                log.warning("device rebuild probe failed: %r", e)
                continue
            try:
                self._rebuild_device()
            except Exception:  # noqa: BLE001 - retried at the next probe
                log.exception("device rebuild failed; retrying")
                continue
            with self._lock:
                self.device_lost = False
                self.device_loss_recoveries += 1
                self._transfer_fail_streak = 0
            self._bump_epoch()
            log.warning("device serving resumed after rebuild %d",
                        self.device_loss_recoveries)
            return

    def _rebuild_device(self) -> None:
        """A fresh arena on the same device, every run of the RWI packed
        into it again and every tombstone marked again; a packed store
        instead demotes every hot block to warm (its host copy) and
        promotes every block again through _submit_promote (the batcher's
        `promote` kind where one runs). The same spans from the same
        rows, so answers after it equal those before the loss. (The
        reference's _maybe_prewarm compiles XLA shapes: the port's
        kernels are built once a process, nothing to warm.)"""
        promote: list[tuple] = []
        with self._lock:
            old = self.arena
            self._packed.clear()
            self._garbage_rows = 0
            self._promote_inflight.clear()
            self.arena = DeviceArena(device=old.device,
                                     budget_bytes=old.budget_bytes,
                                     initial_rows=self._initial_rows())
            if self.packed_residency:
                for ent in self._pblocks.values():
                    if ent["hot"]:
                        ent["hot"] = False
                        self._warm_bytes += ent["block"].packed_bytes
                runs = {id(r): r for r in self.rwi._runs}
                for key in list(self._pblocks):
                    run = runs.get(key[0])
                    if run is not None:
                        self._promote_inflight.add(key)
                        promote.append((key, run))
        if self.packed_residency:
            for key, run in promote:
                self._submit_promote(key, run)
        else:
            for run in list(self.rwi._runs):
                self.on_run_added(run)
        for docid in self.rwi._tombstones:
            self.arena.mark_dead(docid)

    def _delta_block(self, delta) -> tuple:
        """A RAM delta's rows on the arena's device as K6/K7 read them:
        (feats16 [b, 17] int16, flags [b] int32, docids [b] int32), padded
        to its bucket b with docid -1 (compact_feats, as the reference's
        :5813-5821). On the card the three arrays travel in one copy from
        a pinned staging buffer, on the query's stream."""
        n = len(delta)
        b = KD.bucket_delta(n)
        cf, cfl = compact_feats(np.ascontiguousarray(delta.feats, np.int32))
        dev = self.arena.device
        if dev.type != "cuda":
            f16 = np.zeros((b, P.NF), np.int16)
            fl = np.zeros(b, np.int32)
            dd = np.full(b, -1, np.int32)
            f16[:n], fl[:n], dd[:n] = cf, cfl, delta.docids
            return tuple(torch.from_numpy(a).to(dev) for a in (f16, fl, dd))
        fb, wb = b * P.NF * 2, b * 4
        host = torch.empty(fb + 2 * wb, dtype=torch.uint8, pin_memory=True)
        hb = host.numpy()
        f16 = hb[:fb].view(np.int16).reshape(b, P.NF)
        fl = hb[fb:fb + wb].view(np.int32)
        dd = hb[fb + wb:].view(np.int32)
        f16[:n], fl[:n], dd[:n] = cf, cfl, delta.docids
        f16[n:], fl[n:], dd[n:] = 0, 0, -1
        blk = torch.empty(fb + 2 * wb, dtype=torch.uint8, device=dev)
        blk.copy_(host, non_blocking=True)
        return (blk[:fb].view(torch.int16).view(b, P.NF),
                blk[fb:fb + wb].view(torch.int32),
                blk[fb + wb:].view(torch.int32))

    def rank_cache_get(self, termhash: bytes, profile, language: str = "en",
                       k: int = 100, stale_ok: bool = False):
        """The versioned top-k cache's answer, with no device work: the
        full final answer of an earlier identical unconstrained query,
        served while the arena epoch is unchanged and the term has no
        unflushed RAM delta (a delta changes the answer without moving
        the epoch). (scores[:k], docids[:k], considered) or None.
        `stale_ok` (degraded cache-only serving) relaxes both gates."""
        kk = max(16, 1 << (max(k, 1) - 1).bit_length())
        key = (termhash, profile.to_external_string(), language, kk)
        if not stale_ok:
            with self.rwi._lock:
                if self.rwi._ram.get(termhash):
                    return None
        with self._lock:
            epoch = self.arena_epoch
        got = self._topk_cache.get(key, epoch, stale_ok=stale_ok)
        if got is None:
            return None
        s, d, considered = got
        with self._lock:
            self.queries_served += 1
        return s[:k], d[:k], considered

    def rank_term(self, termhash: bytes, profile, language: str = "en",
                  k: int = 100, lang_filter: int = NO_LANG,
                  flag_bit: int = NO_FLAG, from_days: int | None = None,
                  to_days: int | None = None, allow_bitmap=None):
        """Single-term ranked top-k from placed blocks and the term's RAM
        delta: (scores, docids, considered) best-first, or None when the
        term is not fully resident (the caller's host path serves it).
        `profile` is any ranking profile with `to_external_string()`;
        `considered` counts candidate rows (the spans' and the delta's)
        before tombstone and filter masking. A constraint filter or a
        facet bitmap (`allow_bitmap`, from filter_bitmap) takes the exact
        scan (statistics over the filtered rows), as does a RAM delta.
        `allow_bitmap` is filter_bitmap's int32 tensor (or
        convert.bitmap_from_numpy's) on the store's device. While the
        device is lost, or where a fetch under the query fails
        (DeviceTransferError), the answer is None, counted in
        device_lost_queries and fallbacks, never an exception."""
        if self.device_lost:
            with self._lock:
                self.device_lost_queries += 1
                self.fallbacks += 1
            return None
        try:
            return self._rank_term_impl(termhash, profile, language, k,
                                        lang_filter, flag_bit, from_days,
                                        to_days, allow_bitmap)
        except DeviceTransferError:
            # counted (and perhaps the loss declared) by device_fetch
            with self._lock:
                self.device_lost_queries += 1
                self.fallbacks += 1
            return None

    def _rank_term_impl(self, termhash: bytes, profile, language: str,
                        k: int, lang_filter: int, flag_bit: int,
                        from_days: int | None, to_days: int | None,
                        allow_bitmap):
        """rank_term's body (a DeviceTransferError passes through)."""
        cacheable = (lang_filter == NO_LANG and flag_bit == NO_FLAG
                     and from_days is None and to_days is None
                     and allow_bitmap is None)
        if cacheable:
            got = self.rank_cache_get(termhash, profile, language, k)
            if got is not None:
                return got
        prof = self._port_profile(profile)
        # epoch0, dead0: the snapshot the caches validate against
        arrays, written, spans, epoch0, dead0, delta = self.snapshot(
            [termhash], postings=True)
        spans, delta = spans[termhash], delta[termhash]
        if spans is None or len(spans) > self.MAX_SPANS:
            with self._lock:
                self.fallbacks += 1
            if spans is None:
                # the tier ladder: count the miss, start the promotion
                self._note_tier_miss(termhash)
            return None
        if any(sp.pbase >= 0 for sp in spans):
            return self._rank_term_packed(
                termhash, profile, prof, language, k, lang_filter, flag_bit,
                from_days, to_days, allow_bitmap, cacheable)
        if not spans and delta is None:
            return np.empty(0, np.int32), np.empty(0, np.int32), 0
        with_delta = delta is not None and len(delta) > 0
        considered = sum(sp.count for sp in spans) + (
            len(delta) if with_delta else 0)
        consts = self._profile_consts(prof, language)
        kk = max(16, 1 << (max(k, 1) - 1).bit_length())  # bucket k: pow2
        no_filters = cacheable
        batcher = self._batcher
        solo_only = batcher is None or batcher.owns_current_thread()
        s = d = None
        prune_from = 0   # index into _PRUNE_B for the solo escalation
        # concurrent pruned queries share one K5 launch a wave
        if not solo_only and no_filters:
            res = batcher.submit(termhash, prof, language, kk)
            if res[0] == "ok":
                s, d = res[1], res[2]
            elif res[0] == "prune_fail":
                # the wave proved _PRUNE_B[0] insufficient: the solo
                # escalation does not repeat that round
                prune_from = 1
            elif res[0] == "ineligible":
                with self._lock:
                    self.batch_ineligible += 1
            # "ineligible" / "timeout": the solo paths below serve it
        DeviceArena.wait_written(written)
        # pruned fast path: one span whose frozen stats are still exact,
        # no delta, no filter (the bound holds in the unfiltered score
        # domain only)
        if (s is None and no_filters and len(spans) == 1
                and spans[0].tcount > 0 and not with_delta
                and spans[0].dead_seq == len(self.rwi._tombstones)):
            sp = spans[0]
            shift, lang_term = prune_bound_consts(prof)
            for b in _PRUNE_B[prune_from:]:
                # one fetch: scores ++ docids ++ ok
                host = self.device_fetch(pruned_query(
                    arrays, sp, shift, lang_term, consts, kk, b))
                self.count_round_trip()
                s, d, ok = host[:kk], host[kk:2 * kk], bool(host[2 * kk])
                with self._lock:
                    self.prune_rounds += 1
                    if ok:
                        self.pruned_tiles += max(0, sp.tcount - b)
                if ok:
                    break
                s = d = None  # bound failed: escalate the prefix
        filt = (lang_filter, flag_bit,
                DAYS_NONE_LO if from_days is None else from_days,
                DAYS_NONE_HI if to_days is None else to_days)
        # filtered scans without a delta or a bitmap share one batched
        # K6/K7 launch a wave (scan_batching)
        if (s is None and self._scan_batching and not solo_only and spans
                and not with_delta and allow_bitmap is None):
            res = batcher.submit_scan(termhash, prof, language, kk,
                                      (int(lang_filter), int(flag_bit),
                                       from_days, to_days))
            if res[0] == "ok":
                s, d = res[1], res[2]
            elif res[0] == "ineligible":
                with self._lock:
                    self.batch_ineligible += 1
        if s is None:
            with self._lock:
                self.stream_scans += 1
                if allow_bitmap is not None:
                    self.filtered_served += 1
            ext = [(sp.start, sp.count) for sp in spans]
            stats = None
            if with_delta:
                dblock = self._delta_block(delta)
            else:
                # the statistics of a (term, filter, bitmap) stand while
                # its rows, their tombstones and the bitmap do: a repeat
                # skips K6. The arena appends in place, so the feature
                # tensors' identity proves nothing: an entry holds its
                # snapshot's epoch (every flush, merge, delete and term
                # drop bumps it after the change), tombstone count,
                # extents and tombstone bitmap (a new tensor whenever
                # tombstones land), and serves only a snapshot equal in
                # all four and the same facet bitmap (by weak reference,
                # as the reference checks it). A delta's rows join the
                # statistics, so delta queries never cache.
                dblock = None
                skey = (termhash, *filt,
                        id(allow_bitmap) if allow_bitmap is not None else 0)
                snap = (epoch0, dead0, tuple(ext))
                got = self._span_stats_cache.get(skey)
                if (got is not None and got[0] == snap
                        and got[1]() is arrays[3]
                        and got[2]() is allow_bitmap):
                    stats = got[3]
                else:
                    stats = KD.span_stats(arrays[0], arrays[2], arrays[3],
                                          ext, flags=arrays[1], filt=filt,
                                          allow=allow_bitmap)
                    bref = (weakref.ref(allow_bitmap)
                            if allow_bitmap is not None else _none_ref)
                    with self._lock:
                        while len(self._span_stats_cache) >= _STATS_CACHE_CAP:
                            self._span_stats_cache.pop(
                                next(iter(self._span_stats_cache)))
                        self._span_stats_cache[skey] = (
                            snap, weakref.ref(arrays[3]), bref, stats)
            host = self.device_fetch(scan_query(arrays, ext, consts, kk,
                                                filt, stats, dblock,
                                                allow_bitmap))
            self.count_round_trip()
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
        if cacheable and not with_delta:
            # the final answer under the snapshot's epoch: an index event
            # since then leaves the entry born stale
            self._topk_cache.put(
                (termhash, profile.to_external_string(), language, kk),
                epoch0, s, d, considered)
        return s[:k], d[:k], considered

    def _rank_term_packed(self, termhash: bytes, profile, prof, language,
                          k: int, lang_filter: int, flag_bit: int,
                          from_days, to_days, allow_bitmap,
                          cacheable: bool):
        """rank_term over a packed span (the reference's
        _rank_term_packed): the pruned query (K5bp; with the batcher, its
        wave) where no filter is asked and the span's frozen stats are
        exact, else, and where the bound fails, the exact scan
        (scan_query_bp: K6bp, K7bp). A facet bitmap, a RAM delta or
        several spans are counted fallbacks (several spans also ask for a
        merge); a hot hit counts only past those gates."""
        with self._lock:
            spans = self.spans_for(termhash)
            if not spans or len(spans) != 1 or spans[0].pbase < 0:
                if spans is not None and len(spans) > 1:
                    self.merge_wanted = True
                self.fallbacks += 1
                return None
            sp = spans[0]
            words = self.arena.packed_array()
            dead = self.arena.dead_array()
            pmax = self.arena._pmax
            written = self.arena.written
            epoch0 = self.arena_epoch
        if allow_bitmap is not None:
            with self._lock:
                self.fallbacks += 1
            return None
        with self.rwi._lock:
            delta = self.rwi._ram_postings(termhash)
        if delta is not None and len(delta) > 0:
            with self._lock:
                self.fallbacks += 1
            return None
        with self._lock:
            self.tier_hot_hits += 1
            self._touch_packed(sp)
        consts = self._profile_consts(prof, language)
        kk = max(16, 1 << (max(k, 1) - 1).bit_length())
        no_filters = cacheable
        s = d = None
        skip_prune = False
        batcher = self._batcher
        if (batcher is not None and no_filters
                and not batcher.owns_current_thread()):
            res = batcher.submit(termhash, prof, language, kk)
            if res[0] == "ok":
                s, d = res[1], res[2]
            elif res[0] == "prune_fail":
                skip_prune = True     # straight to the exact scan
            elif res[0] == "ineligible":
                with self._lock:
                    self.batch_ineligible += 1
        DeviceArena.wait_written(written)
        if (s is None and no_filters and not skip_prune and sp.tcount > 0
                and sp.dead_seq == len(self.rwi._tombstones)):
            shift, lang_term = prune_bound_consts(prof)
            host = self.device_fetch(pruned_query_bp(
                words, dead, pmax, sp, shift, lang_term, consts, kk))
            self.count_round_trip()
            ok = bool(host[2 * kk])
            with self._lock:
                self.prune_rounds += 1
                if ok:
                    self.pruned_tiles += max(0, sp.tcount - 1)
            if ok:
                s, d = host[:kk], host[kk:2 * kk]
        if s is None:
            filt = (lang_filter, flag_bit,
                    DAYS_NONE_LO if from_days is None else from_days,
                    DAYS_NONE_HI if to_days is None else to_days)
            host = self.device_fetch(scan_query_bp(words, dead, sp, consts,
                                                   kk, filt))
            self.count_round_trip()
            with self._lock:
                self.stream_scans += 1
            s, d = host[:kk], host[kk:]
        keep = (d >= 0) & (s > NEG_INF32)
        s, d = s[keep], d[keep]
        with self._lock:
            self.queries_served += 1
        if cacheable:
            self._topk_cache.put(
                (termhash, profile.to_external_string(), language, kk),
                epoch0, s, d, sp.count)
        return s[:k], d[:k], sp.count

    # -- metadata-facet filter bitmaps (site:/tld:/filetype:/protocol:) -----

    supports_filter_bitmap = True
    FILTER_CACHE_MAX = 16
    # a cached bitmap stays valid this long even when the metadata facet
    # version moved on (staleness only delays a new document's inclusion;
    # SearchEvent rechecks every materialized result)
    FILTER_TTL_S = 2.0

    def filter_bitmap(self, key: tuple, docids_fn):
        """The facet filter's docid bitmap on the arena's device: int32
        [nwords] bit patterns, nwords a power of two of at least 1024
        covering `capacity`. `key` = (modifier combo, facet version,
        capacity); `docids_fn()` gives the allowed docids on a miss.
        Entries are LRU-cached by combo and reused while fresh (same
        version, or younger than FILTER_TTL_S); concurrent misses of one
        combo build it once while the others wait."""
        combo, version, capacity = key[0], key[1], key[2]
        now = time.monotonic()
        while True:
            with self._lock:
                got = self._filter_cache.get(combo)
                if got is not None:
                    ver, built, bm = got
                    if ver == version or now - built < self.FILTER_TTL_S:
                        self._filter_cache.move_to_end(combo)
                        return bm
                ev = self._filter_inflight.get(combo)
                if ev is None:
                    self._filter_inflight[combo] = threading.Event()
                    break
            ev.wait(timeout=10.0)   # another thread builds this combo
            now = time.monotonic()
        try:
            nwords = 1 << max(10, (max((capacity + 31) // 32, 1)
                                   - 1).bit_length())
            words = np.zeros(nwords, np.uint32)
            dd = np.asarray(docids_fn(), np.int64)
            dd = dd[(dd >= 0) & (dd < capacity)]
            np.bitwise_or.at(words, dd >> 5,
                             np.uint32(1) << (dd & 31).astype(np.uint32))
            bm = torch.from_numpy(words.view(np.int32)).to(self.arena.device)
            with self._lock:
                self._filter_cache[combo] = (version, time.monotonic(), bm)
                self._filter_cache.move_to_end(combo)
                while len(self._filter_cache) > self.FILTER_CACHE_MAX:
                    self._filter_cache.popitem(last=False)
            return bm
        finally:
            with self._lock:
                ev = self._filter_inflight.pop(combo, None)
            if ev is not None:
                ev.set()

    # -- the hybrid dense rerank ----------------------------------------------

    def attach_dense(self, dense) -> None:
        """Wire the segment's DenseVectorStore (index/dense.py): its forward
        index is what rerank_boost gathers from, its version keys the
        hybrid top-k cache."""
        self._dense = dense

    def rerank_boost(self, qvec, sparse_scores, docids, alpha):
        """The dense rerank of one query's sparse answer on the device:
        (scores, docids) of every candidate, final = sparse +
        round((cos * alpha) * DENSE_BOOST_SCALE) (no boost for a docid the
        forward index does not cover), best-first by (score DESC, docid
        ASC). With rerank batching on, through the batcher's `rerank` kind
        (a wave of up to max_batch slots a launch); otherwise, on a
        timeout, or from the batcher's own threads, the same kernels solo
        at the wave's shape (bs = max_batch, pad slots empty).

        None where the caller's host path serves, counted in
        rerank_fallbacks: the device is lost, more than RERANK_MAX_N
        candidates, no forward index (over its budget), or the fetch
        failed (DeviceTransferError). None uncounted without a dense
        store; n == 0 answers two empty arrays."""
        from ..ops import dense as DN
        if self.device_lost:
            # the sparse stage of this query counted it in
            # device_lost_queries already
            with self._lock:
                self.rerank_fallbacks += 1
            return None
        dense = self._dense
        if dense is None:
            return None
        n = int(len(docids))
        if n == 0:
            return np.empty(0, np.int32), np.empty(0, np.int32)
        if n > DN.RERANK_MAX_N:
            with self._lock:
                self.rerank_fallbacks += 1
            return None
        got = dense.device_snapshot(self.arena.device)
        if got is None:
            with self._lock:
                self.rerank_fallbacks += 1
            return None
        fwd, _ver, written = got
        nb = DN.rerank_bucket(n)
        row = DN.pack_rerank_row(qvec, sparse_scores, docids, alpha, nb)
        b = self._batcher
        if (self._rerank_batching and b is not None
                and not b.owns_current_thread()):
            res = b.submit_rerank(row, nb, n, fwd, written)
            if res[0] == "ok":
                return res[1], res[2]
            # "timeout", or a wave whose fetch failed: solo below
        bs = b.max_batch if b is not None else 1
        qi = np.zeros((bs, len(row)), np.int32)
        qi[0] = row
        DeviceArena.wait_written(written)
        try:
            host = self.device_fetch(DN.rerank_fwd_batch_packed(fwd, qi, nb))
        except DeviceTransferError:
            with self._lock:
                self.rerank_fallbacks += 1
            return None
        self.count_round_trip()
        with self._lock:
            self.rerank_dispatches += 1
            self.rerank_queries += 1
        return host[0, :n], host[0, nb:nb + n]

    def hybrid_vector_version(self) -> int:
        """The attached dense store's content version (-1 without one):
        snapshotted with the epoch before a hybrid answer is computed."""
        dense = self._dense
        return dense.version if dense is not None else -1

    def ann_centroid_version(self) -> int:
        """The attached ANN index's centroid version (-1 without one):
        snapshotted with the epoch before a dense-first answer is
        computed, so a build or promotion racing it leaves the cached
        entry unreachable."""
        ann = self._ann
        return ann.centroid_version if ann is not None else -1

    def _hybrid_cache_key(self, termhash: bytes, profile, language: str,
                          k: int, alpha, dv: int | None = None,
                          dense_first: bool = False,
                          cv: int | None = None) -> tuple:
        """The sparse key extended by the blend alpha, the encoder version
        and the vectors' version (an encoder swap or a vector write
        re-keys every entry), at the EXACT k (the rerank's input is the
        sparse answer's [:k]). Dense-first entries add the centroid
        version."""
        from ..ops import dense as DN
        if dv is None:
            dv = self.hybrid_vector_version()
        base = (termhash, profile.to_external_string(), language, k,
                "hybrid", round(float(alpha), 6), DN.ENCODER_VERSION, dv)
        if not dense_first:
            return base
        if cv is None:
            cv = self.ann_centroid_version()
        return base + ("df", cv)

    def hybrid_cache_get(self, termhash: bytes, profile,
                         language: str = "en", k: int = 100,
                         alpha: float = 0.5, dense_first: bool = False):
        """A full hybrid answer (sparse stage and rerank) from the top-k
        cache with no device work: (scores, docids, considered) or None.
        The freshness gates of rank_cache_get (the arena epoch, no RAM
        delta); vector and encoder changes miss through the key."""
        with self.rwi._lock:
            if self.rwi._ram.get(termhash):
                return None
        with self._lock:
            epoch = self.arena_epoch
        got = self._topk_cache.get(
            self._hybrid_cache_key(termhash, profile, language, k, alpha,
                                   dense_first=dense_first), epoch)
        if got is None:
            return None
        s, d, considered = got
        with self._lock:
            self.rerank_cache_hits += 1
            self.queries_served += 1
        return s, d, considered

    def hybrid_cache_put(self, termhash: bytes, profile, language: str,
                         k: int, alpha: float, epoch0: int, s, d,
                         considered: int, dv0: int | None = None,
                         dense_first: bool = False,
                         cv0: int | None = None) -> None:
        """File a computed hybrid answer under the epoch and the vectors'
        version snapshotted BEFORE its sparse stage ran (dv0; None: the
        live one, for callers no write can race): a write racing the
        answer leaves the entry unreachable, never served."""
        self._topk_cache.put(
            self._hybrid_cache_key(termhash, profile, language, k, alpha,
                                   dv=dv0, dense_first=dense_first, cv=cv0),
            epoch0, np.asarray(s), np.asarray(d), considered)

    def _dense_fwd_bytes(self) -> int:
        """Device bytes of the forward index's block (0 when none)."""
        dense = self._dense
        if dense is None:
            return 0
        with dense._lock:
            fwd = dense._fwd
            return int(fwd.shape[0] * fwd.shape[1] * 2) \
                if fwd is not None else 0

    # -- dense-first IVF ANN candidate generation -----------------------------

    def attach_ann(self, ann) -> None:
        """Wire the segment's AnnVectorIndex (index/annstore.py): its hot
        arena is what dense_first_topk probes on this store's device, its
        centroid version keys the dense-first cache."""
        self._ann = ann

    def dense_first_topk(self, qvec, sparse_scores, docids, alpha,
                         k: int, nprobe: int | None = None):
        """The fused dense-first answer of one query: the IVF probe
        candidates and the sparse candidates in one cardinal domain
        (sparse + the fixed-scale dense boost), (scores, docids) by
        (score DESC, docid ASC), deduplicated, at most k. Through the
        batcher's `ann` kind when batching is on (not from its own
        threads); otherwise, or on a timeout, the same kernels solo:
        equal answers. Warm clusters score on the host. While the device
        is lost, or when a fetch fails, the index answers on the host
        (counted in ann_host_queries). None, counted in ann_fallbacks,
        when no built index is attached (the caller's plain rerank)."""
        ann = self._ann
        if ann is None or not ann.built:
            with self._lock:
                self.ann_fallbacks += 1
            return None
        nprobe = nprobe or self.ann_nprobe
        sd = np.asarray(docids, np.int32)
        ss = np.asarray(sparse_scores, np.int32)
        qv = np.asarray(qvec, np.float32)
        if not self.device_lost:
            try:
                b = self._batcher
                if (self._ann_batching and b is not None
                        and not b.owns_current_thread()):
                    res = b.submit_ann(qv, ss, sd, float(alpha), k, nprobe)
                    if res[0] == "ok":
                        return res[1], res[2]
                    # "timeout", or a wave whose fetch failed: solo below
                return self._ann_solo(qv, ss, sd, float(alpha), k, nprobe)
            except DeviceTransferError:
                pass    # counted by device_fetch; the host answers
        with self._lock:
            self.ann_host_queries += 1
            self.ann_queries += 1
        return ann.search_host(qv, sd, ss, float(alpha), k, nprobe,
                               self.ann_probe_lanes)

    def _ann_prepare_wave(self, slots: list[dict]):
        """Centroid assignment and lane plans for one wave of dense-first
        slots: one K14 launch a distinct nprobe (its fetch is the wave's
        first round trip), then each slot planned against ONE hot-arena
        snapshot (a promotion patching the arena meanwhile cannot mix
        generations inside a launch). Returns (kernel groups keyed by
        (nb, kk) with each slot's descriptor, host slots with no device
        lane, the clusters to promote). A failed fetch raises
        DeviceTransferError."""
        from ..ops.ann import (ann_assign_batch, ann_lane_bucket,
                               ann_topk_bucket, pack_ann_fuse_row)
        ann = self._ann
        device = self.arena.device
        cent, cev = ann.centroid_block(device)
        got_hot = ann.hot_block(device)
        hb, hot_limit, hev = got_hot if got_hot is not None else \
            (None, 0, None)
        DeviceArena.wait_written(cev)
        DeviceArena.wait_written(hev)
        n_clusters = ann.n_clusters()
        by_np: dict[int, list[dict]] = {}
        for it in slots:
            by_np.setdefault(int(it["nprobe"]), []).append(it)
        for nprobe, its in by_np.items():
            out = ann_assign_batch(
                cent, np.stack([it["qvec"] for it in its]),
                min(nprobe, n_clusters), n_clusters)
            ids = self.device_fetch(out)
            self.count_round_trip()
            for i, it in enumerate(its):
                it["cids"] = ids[i]
        groups: dict[tuple, list[dict]] = {}
        host_slots: list[dict] = []
        promote: list[int] = []
        for it in slots:
            plan = ann.plan(it["cids"], it["sd"], it["ss"],
                            self.ann_probe_lanes, hot_limit=hot_limit)
            promote.extend(plan["promote"])
            it["plan"] = plan
            hot_rows = plan["hot_rows"]
            spr, spd, sps = plan["sp_hot"]
            lanes = len(hot_rows) + len(spr)
            if lanes == 0:
                host_slots.append(it)
                continue
            # the sparse candidates ride first (never cut); the probes are
            # bounded by the plan's lane budget
            rows = np.concatenate([spr, hot_rows])
            dd = np.concatenate([spd, np.full(len(hot_rows), -1, np.int32)])
            sp = np.concatenate([sps, np.zeros(len(hot_rows), np.int32)])
            nb = ann_lane_bucket(lanes, lanes)
            kk = ann_topk_bucket(it["k"], nb)
            it["qrow"] = pack_ann_fuse_row(it["qvec"], rows, dd, sp,
                                           it["alpha"], nb)
            it["hb"] = hb
            groups.setdefault((nb, kk), []).append(it)
        return groups, host_slots, promote

    def _ann_fuse_issue(self, its: list[dict], nb: int, kk: int):
        """Launch K15 for one (nb, kk) group of slots (planned against one
        hot-arena snapshot, its[0]["hb"]): [len(its), 2kk] on the device,
        not fetched."""
        from ..ops.ann import ann_fuse_batch_packed
        hb = its[0]["hb"]
        return ann_fuse_batch_packed(*hb, np.stack([it["qrow"] for it in its]),
                                     nb, kk)

    def _ann_finish_slot(self, it: dict, dev_part, kk: int):
        """One slot's device lanes (fused and ordered by K15; pad entries
        carry docid INT32_MAX) merged with its host-scored parts by (score
        DESC, docid ASC), deduplicated best first, trimmed to k."""
        from ..ops.ann import merge_fused
        parts = []
        if dev_part is not None:
            s, d = dev_part
            ok = d != INT32_MAX
            parts.append((np.asarray(s)[ok].astype(np.int64),
                          np.asarray(d)[ok]))
        parts.extend(self._ann.host_score_parts(it["plan"], it["qvec"],
                                                it["alpha"], kk))
        return merge_fused(parts, it["k"])

    def _ann_solo(self, qvec, ss, sd, alpha, k: int, nprobe: int):
        """One dense-first query outside a wave: the same kernels, one
        slot each."""
        from ..ops.ann import ann_topk_bucket
        slot = {"qvec": qvec, "ss": ss, "sd": sd, "alpha": alpha,
                "k": k, "nprobe": nprobe}
        groups, _host, promote = self._ann_prepare_wave([slot])
        for cid in promote:
            self._submit_ann_promote(cid)
        if groups:
            ((nb, kk), its), = groups.items()
            host = self.device_fetch(self._ann_fuse_issue(its, nb, kk))
            self.count_round_trip()
            res = self._ann_finish_slot(slot, (host[0, :kk],
                                               host[0, kk:2 * kk]), kk)
            with self._lock:
                self.ann_dispatches += 1
                self.ann_queries += 1
            return res
        res = self._ann_finish_slot(slot, None, ann_topk_bucket(k, 1 << 30))
        with self._lock:
            self.ann_queries += 1
        return res

    def _submit_ann_promote(self, cid: int) -> None:
        """One ANN cluster's promotion on the batcher's `promote` kind
        (off the query path); inline without a batcher."""
        b = self._batcher
        if b is not None and not b._stop:
            with self._lock:
                self.tier_promote_async += 1
            b.submit_ann_promote(cid)
        else:
            self._ann_promote_now(cid)

    def _ann_promote_now(self, cid: int):
        """Place one warm cluster in the hot arena and patch it onto the
        device (index/annstore.promote_cluster): (the device copy of its
        first docid, read behind the patch's event on the current stream,
        the host mirror's, the arrays to hold) or None."""
        ann = self._ann
        if ann is None:
            return None
        got = ann.promote_cluster(cid, self.arena.device)
        if got is None:
            return None
        probe, want, arrays, ev = got
        DeviceArena.wait_written(ev)
        return probe, want, arrays

    # -- the query batcher ----------------------------------------------------

    def enable_batching(self, max_batch: int = 16, dispatchers: int = 8,
                        scan_batching: bool = False, completer_depth: int = 2,
                        pipeline: bool = True,
                        rerank_batching: bool = True) -> None:
        """Coalesce concurrent pruned queries and conjunctions (and, with
        `scan_batching`, filtered exact scans; with `rerank_batching`, the
        hybrid reranks) into waves of one launch each
        (index/batcher.QueryBatcher). On the card the kernels are built
        first: a first-use build outlasts the batcher's watchdog."""
        from .batcher import QueryBatcher
        self._scan_batching = bool(scan_batching)
        self._rerank_batching = bool(rerank_batching)
        # the dense-first waves ride the rerank switch (both are the
        # hybrid query's second stage), as in the reference
        self._ann_batching = bool(rerank_batching)
        if self._batcher is None:
            if self.arena.device.type == "cuda":
                from ..kernels import build
                build.library()
            self._batcher = QueryBatcher(
                self, max_batch=max_batch, dispatchers=dispatchers,
                completer_depth=completer_depth, pipeline=pipeline)

    def set_tuning(self, dispatchers: int | None = None,
                   completer_depth: int | None = None) -> dict:
        """Resize the batcher's pools at run time ({} without one)."""
        if self._batcher is None:
            return {}
        return self._batcher.set_tuning(dispatchers, completer_depth)

    def close(self) -> None:
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None
        if self.rwi.listener is self:
            self.rwi.listener = None

    # -- counters -------------------------------------------------------------

    def counters(self) -> dict:
        """The serving counters under the JAX store's key names, so that
        /metrics and the health rules resolve against this store, and
        `ingest_device_builds` (the blocks K13 packed). Keys of machinery
        not ported (ZERO_COUNTERS) read zero.
        `dispatch_ms_p50/p95` are per-query walls of the wave each batched
        query rode in, `kernel_ms_p50/p95` the launch-to-answer walls of
        those waves (no tunnel here: nothing to subtract)."""
        b = self._batcher
        if b is not None:
            with b._ms_lock:
                dseries = list(b.query_dispatch_ms)
                kseries = list(b.query_kernel_ms)
                bstats = (b.dispatches, round(b.dispatch_ms_max, 1),
                          b.exceptions, b.timeouts, b.timeout_queue_full,
                          b.timeout_flush_deadline, b.timeout_worker_stall)
        else:
            dseries, kseries, bstats = [], [], (0, 0.0, 0, 0, 0, 0, 0)
        tc = self._topk_cache
        fwd_bytes = self._dense_fwd_bytes()
        tb = self.tier_bytes()
        ratio = self.packed_compression_ratio()
        ann = self._ann
        ann_c = ann.counters() if ann is not None else ANN_ZERO_COUNTERS
        with self._lock:
            out = dict(ZERO_COUNTERS)
            out.update(ann_c)
            out.update({
                "ann_dispatches": self.ann_dispatches,
                "ann_queries": self.ann_queries,
                "ann_fallbacks": self.ann_fallbacks,
                "ann_host_queries": self.ann_host_queries,
                "dispatch_ms_p50": _pctl(dseries, 0.50),
                "dispatch_ms_p95": _pctl(dseries, 0.95),
                "kernel_ms_p50": _pctl(kseries, 0.50),
                "kernel_ms_p95": _pctl(kseries, 0.95),
                "queries_served": self.queries_served,
                "fallbacks": self.fallbacks,
                "rank_cache_hits": tc.hits,
                "rank_cache_stale": tc.stale,
                "rank_cache_stale_served": tc.stale_served,
                "arena_epoch": self.arena_epoch,
                "device_round_trips": self.device_round_trips,
                "prune_rounds": self.prune_rounds,
                "pruned_tiles": self.pruned_tiles,
                "stream_scans": self.stream_scans,
                "filtered_served": self.filtered_served,
                "batch_ineligible": self.batch_ineligible,
                "join_served": self.join_served,
                "join_fallbacks": self.join_fallbacks,
                "join_degraded_plain": self.join_degraded_plain,
                "device_lost": 1 if self.device_lost else 0,
                "device_losses": self.device_losses,
                "device_loss_recoveries": self.device_loss_recoveries,
                "device_lost_queries": self.device_lost_queries,
                "transfer_failures": self.transfer_failures,
                "transfer_retries": self.transfer_retries,
                "rerank_dispatches": self.rerank_dispatches,
                "rerank_queries": self.rerank_queries,
                "rerank_cache_hits": self.rerank_cache_hits,
                "rerank_fallbacks": self.rerank_fallbacks,
                "tier_hot_hits": self.tier_hot_hits,
                "tier_warm_hits": self.tier_warm_hits,
                "tier_cold_hits": self.tier_cold_hits,
                "tier_promotions_warm_hot": self.tier_promotions_warm_hot,
                "tier_promotions_cold_hot": self.tier_promotions_cold_hot,
                "tier_demotions_hot_warm": self.tier_demotions_hot_warm,
                "tier_evictions_warm_cold": self.tier_evictions_warm_cold,
                "tier_promote_async": self.tier_promote_async,
                "tier_promote_failures": self.tier_promote_failures,
                "tier_hot_bytes": tb["hot"],
                "tier_warm_bytes": tb["warm"],
                "tier_cold_bytes": tb["cold"],
                "packed_compression_ratio": ratio,
                "ingest_device_builds": self.ingest_device_builds,
                "batch_dispatches": bstats[0],
                "batch_dispatch_ms_max": bstats[1],
                "batch_exceptions": bstats[2],
                "batch_timeouts": bstats[3],
                "batch_timeout_queue_full": bstats[4],
                "batch_timeout_flush_deadline": bstats[5],
                "batch_timeout_worker_stall": bstats[6],
                "dense_fwd_bytes": fwd_bytes,
            })
        return out


def _none_ref():
    return None
