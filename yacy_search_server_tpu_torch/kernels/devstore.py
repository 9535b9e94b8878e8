"""The devstore's kernels: K5 `pruned_tile`, K6 `span_stats`, K7
`span_score`, `topk_finish`, K8 `join_member`, and the batched exact scan
(`span_stats_batch`, `span_score_batch`, `topk_finish_batch`).

They read the device arena of index/devstore.py in place: features
int16 [cap, 17], flags and docids int32 [cap] (-1 on pad rows), the
tombstone bitmap `dead` bool [doc_cap] and the per-tile bound rows
`pmax` int32. A row is live when it holds a docid that is not tombstoned
(docids at or past the bitmap are alive), as _tile_valid of the JAX
package's index/devstore.py decides; every kernel decides it itself.

- `pruned_tile` (csrc/pruned_tile.cu) replaces _rank_pruned_batch1_kernel
  / _rank_pruned_batch1_packed_kernel, and _rank_pruned_kernel /
  _rank_pruned_batch_kernel at b = 1: per slot of a fused descriptor,
  one TILE scored against frozen statistics, the kk best by (score
  descending, arena position ascending), their docids, and the pmax tail
  check. `init` gives the general kernel's form (its running merge
  starts from kk entries (-(2^31-1), -1) that precede every row).
- `span_stats` (csrc/cardinal_stats.cu) and `span_score`
  (csrc/cardinal_score.cu) are the two passes of _rank_spans_kernel over
  up to 8 extents and a RAM delta block after them, minus the top-k:
  kernel 3 (`tie_topk`, index mode) selects from span_score's buffer, in
  the order of the JAX running merge (span rows before delta rows).
- `topk_finish` (csrc/pruned_tile.cu) maps kernel 3's winners back to
  docids (the arena's, or the delta's), applies the init entries' rule,
  and appends the tail check's ok (the b > 1 escalation of
  _pruned_span_topk) or the scan's statistics (_rank_spans_packed_kernel's
  [2kk + 36] output).
- `join_member` (csrc/join.cu) replaces the membership and merge of
  _join_topk, the body of _rank_join_batch_kernel /
  _rank_join_bm_batch_kernel and their packed twins: each row of the
  rarest include's span tested against every partner (binary search of
  its docid-sorted segment, or its docid bitmap) and every exclude, the
  partner rows merged in, the constraint filter applied; kernels 1-3 and
  topk_finish rank the merged block.
- `span_stats_batch`, `span_score_batch` (the same sources) and
  `topk_finish_batch` replace _rank_scan_batch_kernel /
  _rank_scan_batch_packed_kernel: K6 and K7 with a query dimension over a
  wave of up to 16 filtered scans (`scan_batch_desc`), each slot with its
  own extents, filter, statistics and buffer row; kernel 3 a slot; then
  one finish for the wave, [bs, 2kk].
- `join_member_batch` (csrc/join.cu), `join_stats_batch`
  (csrc/cardinal_stats.cu) and `join_score_batch` (csrc/cardinal_score.cu)
  replace _rank_join_batch_kernel / _rank_join_bm_batch_kernel and their
  packed twins at bs > 1: K8, kernel 1 (no host counts) and kernel 2 (the
  int32 path) with a slot dimension over a wave of up to 16 conjunctions
  (`join_wave_desc`, the reference's qargs_batch), each slot's merged
  rows, statistics and scores in a region of its own of one buffer
  (`join_wave_offsets`); kernel 3 a slot and `topk_finish_batch` finish
  the wave.

K6, K7 and K8 take a constraint filter `filt` (_constraint_valid): the
4-tuple (language, flag bit, from days, to days), each off at its
sentinel (NO_FILTER); None is no filter. K6 and K7 also take a facet
bitmap `allow` (_bitmap_member: int32 [nwords] bit patterns, a docid's
bit set where it is allowed, docids at or past 32 nwords excluded) and a
RAM delta `delta` (feats16 int16 [n, 17], flags and docids int32 [n], pad
rows docid -1: compact_feats of the term's unflushed postings, read after
the extents).

Each wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version only for CPU tensors. An extent is a (first row, row
count) pair of Python ints; a descriptor is a numpy int32 vector in
_pack_batch1_fused's layout.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..index import postings as P
from . import build as B
from . import cardinal as KC
from .topk import tie_topk_plain

TILE = 32_768
MAX_EXTENTS = 8
MAX_KK = 2048
INT32_MAX = 2**31 - 1
NO_LANG = 0                # language filter sentinel (pack_language(''))
NO_FLAG = -1               # contentdom flag sentinel
DAYS_NONE_LO = -(2**30)    # lastmod range sentinels
DAYS_NONE_HI = 2**30
NO_FILTER = (NO_LANG, NO_FLAG, DAYS_NONE_LO, DAYS_NONE_HI)
JOIN_DOCID_CAP = 1 << 29   # sort-mode membership clips docids to it
MAX_PARTNERS = 5           # include partners of a join (6 terms, one rare)
MAX_EXCLUDES = 6
DESC_SLOT_WORDS = 4 + 2 * P.NF + 2   # start, count, tstart, tcount, cmin,
#                                      cmax, tf_min, tf_max
_PLAIN_ROWS = 1 << 20                # rows a plain scoring step holds
# RAM delta blocks pad to these row counts (past the last: whole TILEs),
# as the JAX store's _DELTA_BUCKETS / _bucket_delta
DELTA_BUCKETS = (256, 1024, 4096, 16_384, 65_536, 262_144)
BATCH_SLOTS = 16                     # slots of one batched-scan launch
SLOT_DESC_WORDS = 1 + 2 * MAX_EXTENTS + 4   # n, (start, count) x 8, filter
_STATS_SLOT = 2 * 38 + 1             # a batched K6 slot: stats, acc, ticket


def bucket_delta(n: int) -> int:
    """The padded row count of a RAM delta block of n rows."""
    for b in DELTA_BUCKETS:
        if n <= b:
            return b
    return ((n + TILE - 1) // TILE) * TILE


def desc_slots(desc: np.ndarray) -> int:
    """The slots of a fused descriptor (its length is 2 + 40 bs)."""
    bs, rem = divmod(len(desc) - 2, DESC_SLOT_WORDS)
    if bs < 1 or rem:
        raise ValueError(f"descriptor of {len(desc)} words is not 2 + "
                         f"{DESC_SLOT_WORDS} a slot")
    return bs


def pack_desc(slots, bound_shift: int, lang_term: int) -> np.ndarray:
    """The fused descriptor (_pack_batch1_fused) of `slots`, each (start,
    count, tstart, tcount, col_min int32[17], col_max int32[17], tf_min
    f32, tf_max f32)."""
    cols = list(zip(*slots))
    f32 = lambda v: np.asarray(v, np.float32).view(np.int32)  # noqa: E731
    return np.concatenate([
        np.asarray([bound_shift, lang_term], np.int32),
        *(np.asarray(c, np.int32) for c in cols[:4]),
        np.asarray(cols[4], np.int32).ravel(),
        np.asarray(cols[5], np.int32).ravel(),
        f32(cols[6]), f32(cols[7])]).astype(np.int32)


def _slot(desc: np.ndarray, bs: int, i: int):
    """(start, count, tstart, tcount, stats int32[38]) of slot i."""
    q = desc
    base = 2 + 4 * bs
    st = np.zeros(KC.STATS_LEN, np.int32)
    st[KC.S_COL_MIN:KC.S_COL_MIN + P.NF] = q[base + i * P.NF:
                                             base + (i + 1) * P.NF]
    base += bs * P.NF
    st[KC.S_COL_MAX:KC.S_COL_MAX + P.NF] = q[base + i * P.NF:
                                             base + (i + 1) * P.NF]
    base += bs * P.NF
    st[KC.S_TF_MIN] = q[base + i]
    st[KC.S_TF_MAX] = q[base + bs + i]
    return (int(q[2 + i]), int(q[2 + bs + i]), int(q[2 + 2 * bs + i]),
            int(q[2 + 3 * bs + i]), st)


def live_rows(docids: torch.Tensor, dead: torch.Tensor) -> torch.Tensor:
    """Liveness of arena rows from their docids (_tile_valid)."""
    d = docids.to(torch.int64)
    in_range = d < dead.shape[0]
    hit = dead[d.clamp(0, max(dead.shape[0] - 1, 0))]
    return (d >= 0) & ~(hit & in_range)


def filter_args(filt):
    """A filter as 4 Python ints (None: NO_FILTER)."""
    if filt is None:
        return NO_FILTER
    q = tuple(int(v) for v in filt)
    if len(q) != 4:
        raise ValueError(f"a filter is 4 ints, got {len(q)}")
    return q


def _filt_arg(q):
    """The filter as int32[4] in host memory (hold it while it is used)."""
    return (ctypes.c_int32 * 4)(*q)


def constraint_valid(feats, flags, filt) -> torch.Tensor:
    """_constraint_valid: the rows of `feats` ([n, 17] int16 or int32)
    with `flags` ([n] int32; read only under a flag filter) that pass the
    filter, bool [n]."""
    lang, flag, lo, hi = filter_args(filt)
    v = torch.ones(feats.shape[0], dtype=torch.bool, device=feats.device)
    if lang != NO_LANG:
        v &= feats[:, P.F_LANGUAGE].to(torch.int32) == lang
    if flag != NO_FLAG:
        # XLA's arithmetic shift: a bit past 31 reads the sign
        v &= ((flags.to(torch.int64) >> min(max(flag, 0), 31)) & 1) == 1
    lastmod = feats[:, P.F_LASTMOD].to(torch.int32)
    if lo != DAYS_NONE_LO:
        v &= lastmod >= lo
    if hi != DAYS_NONE_HI:
        v &= lastmod <= hi
    return v


def bitmap_member(allow, docids) -> torch.Tensor:
    """_bitmap_member: the bit of each docid in `allow` (int32 [nwords]
    bit patterns), False for a docid at or past 32 nwords, bool [n]."""
    d = docids.to(torch.int64)
    nwords = allow.shape[0]
    w = allow[(d >> 5).clamp(0, nwords - 1)].to(torch.int64) & 0xFFFFFFFF
    return (((w >> (d & 31)) & 1) == 1) & (d < 32 * nwords)


def _check_delta(delta, dev):
    """The delta triple's tensors checked ((feats16, flags, docids) or
    None) and its row count."""
    if delta is None:
        return None, 0
    f, fl, d = delta
    if dev.type != "cpu":
        B.require(f, "delta feats16", (torch.int16,), 2, dev)
        B.require(fl, "delta flags", (torch.int32,), 1, dev)
        B.require(d, "delta docids", (torch.int32,), 1, dev)
    n = d.shape[0]
    if f.shape != (n, P.NF) or fl.shape[0] != n:
        raise ValueError(f"delta: feats16 {tuple(f.shape)}, flags "
                         f"{tuple(fl.shape)}, docids {tuple(d.shape)}")
    return delta, n


def _check_allow(allow, dev):
    if allow is not None:
        if dev.type != "cpu":
            B.require(allow, "allow", (torch.int32,), 1, dev)
        if allow.shape[0] < 1:
            raise ValueError("allow: an empty bitmap")
    return allow


def _filter_flags(flags, q):
    if q[1] != NO_FLAG and flags is None:
        raise ValueError("a flag filter needs the arena's flags")


def tail_ok_plain(pm: torch.Tensor, bound_shift: int, lang_term: int,
                  theta: int) -> bool:
    """Every tail tile's bound (pmax << shift, saturated) plus the language
    term is at most theta, in int32 arithmetic (devstore.py:939-951)."""
    pm = pm.to(torch.int64)
    pos, neg = max(bound_shift, 0), max(-bound_shift, 0)
    cap = (INT32_MAX - 2048) - lang_term
    shifted = torch.where(pm > (cap >> pos), cap, KC.wrap32(pm << pos)) >> neg
    return bool((KC.wrap32(shifted + lang_term) <= theta).all())


def _check_kk(kk: int) -> None:
    if not 16 <= kk <= MAX_KK or kk & (kk - 1):
        raise ValueError(f"kk={kk}: a power of two in [16, {MAX_KK}]")


def _check_extents(extents, cap: int) -> list[tuple[int, int]]:
    ext = [(int(s), int(c)) for s, c in extents]
    if len(ext) > MAX_EXTENTS:
        raise ValueError(f"{len(ext)} extents, at most {MAX_EXTENTS}")
    for s, c in ext:
        if s < 0 or c < 0 or s + c > cap:
            raise ValueError(f"extent ({s}, {c}) outside the arena's {cap} "
                             "rows")
    return ext


def _ext_arg(ext):
    """The extents as int64 (start, count) pairs in host memory (the C
    entry points copy them into the kernel's arguments); pass
    ctypes.addressof of it while it is held."""
    flat = [v for e in ext for v in e] or [0]
    return (ctypes.c_int64 * len(flat))(*flat)


def _require_arena(feats16, flags, docids, dead, dev):
    B.require(feats16, "feats16", (torch.int16,), 2, dev)
    if feats16.shape[1] != P.NF:
        raise ValueError(f"feats16: {feats16.shape[1]} columns, expected "
                         f"{P.NF}")
    cap = feats16.shape[0]
    for name, t in (("flags", flags), ("docids", docids)):
        if t is not None:
            B.require(t, name, (torch.int32,), 1, dev)
            if t.shape[0] != cap:
                raise ValueError(f"{name}: {t.shape[0]} rows, arena {cap}")
    B.require(dead, "dead", (torch.bool,), 1, dev)
    return cap


def _rows(t: torch.Tensor, ext) -> torch.Tensor:
    parts = [t[s:s + c] for s, c in ext]
    return torch.cat(parts) if parts else t[:0]


# ---------------------------------------------------------------------------
# K5 pruned_tile
# ---------------------------------------------------------------------------

def pruned_tile_plain(feats16, flags, docids, dead, pmax, desc, kk: int,
                      consts, init: bool):
    """Plain PyTorch version of K5: [bs, 2kk + 1] int32."""
    dev = feats16.device
    bs = desc_slots(desc)
    shift, lang = int(desc[0]), int(desc[1])
    out = torch.empty((bs, 2 * kk + 1), dtype=torch.int32, device=dev)
    rows = torch.arange(TILE, device=dev)
    for i in range(bs):
        start, count, tstart, tcount, st = _slot(desc, bs, i)
        dd = docids[start:start + TILE]
        v = (rows < count) & live_rows(dd, dead)
        sc = KC.cardinal_score_plain(
            feats16[start:start + TILE], flags[start:start + TILE], v,
            torch.zeros(TILE, dtype=torch.int32, device=dev),
            torch.from_numpy(st).to(dev),
            torch.zeros(1, dtype=torch.int32, device=dev), consts, True)
        s, _, idx = tie_topk_plain(sc, kk)
        d = dd[idx.long()]
        if init:
            gone = s <= KC.SMALL
            s = torch.where(gone, KC.SMALL, s)
            d = torch.where(gone, -1, d)
        ok = tail_ok_plain(pmax[tstart + 1:tstart + max(tcount, 1)], shift,
                           lang, int(s[kk - 1]))
        out[i, :kk], out[i, kk:2 * kk], out[i, 2 * kk] = s, d, int(ok)
    return out


def pruned_tile(feats16, flags, docids, dead, pmax, desc, kk: int, consts,
                init: bool):
    """K5: the b = 1 pruned query of each slot of `desc` (a numpy int32
    fused descriptor) over the arena; kk a power of two in [16, 2048].
    Returns [bs, 2kk + 1] int32: scores, docids, ok."""
    _check_kk(kk)
    desc = np.ascontiguousarray(desc, np.int32)
    bs = desc_slots(desc)
    starts = desc[2:2 + bs].astype(np.int64)
    tstarts = desc[2 + 2 * bs:2 + 3 * bs].astype(np.int64)
    tcounts = desc[2 + 3 * bs:2 + 4 * bs].astype(np.int64)
    if ((starts < 0) | (starts + TILE > feats16.shape[0])).any():
        raise ValueError(f"a slot's tile lies outside the arena's "
                         f"{feats16.shape[0]} rows")
    if ((tstarts < 0) | (tcounts < 0)
            | (tstarts + tcounts > pmax.shape[0])).any():
        raise ValueError("a slot's pmax rows lie outside the side-table")
    if feats16.device.type == "cpu":
        return pruned_tile_plain(feats16, flags, docids, dead, pmax, desc,
                                 kk, consts, init)
    dev = feats16.device
    _require_arena(feats16, flags, docids, dead, dev)
    B.require(pmax, "pmax", (torch.int32,), 1, dev)
    B.require(consts, "consts", (torch.int32,), 1, dev)
    scratch = torch.empty(bs * TILE, dtype=torch.int32, device=dev)
    out = torch.empty((bs, 2 * kk + 1), dtype=torch.int32, device=dev)
    # the descriptor stays in host memory: the C entry point copies it
    # into the launches' parameters
    rc = B.library().yt_pruned_tile(
        feats16.data_ptr(), flags.data_ptr(), docids.data_ptr(),
        dead.data_ptr(), dead.shape[0], pmax.data_ptr(), desc.ctypes.data,
        bs, kk, int(init), consts.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "pruned_tile")
    # live slots: those with rows (a pad slot has count 0)
    B.count_launch("pruned_tile", slots=int((desc[2 + bs:2 + 2 * bs] > 0)
                                            .sum()))
    return out


# ---------------------------------------------------------------------------
# K6 span_stats
# ---------------------------------------------------------------------------

def _source_rows(feats16, flags, docids, ext, delta):
    """(feats, flags, docids) of the extents' rows in order, then the
    delta's."""
    f, fl, d = _rows(feats16, ext), _rows(flags, ext), _rows(docids, ext)
    if delta is not None:
        f = torch.cat([f, delta[0]])
        fl = torch.cat([fl, delta[1]])
        d = torch.cat([d, delta[2]])
    return f, fl, d


def span_stats_plain(feats16, docids, dead, extents, flags=None,
                     filt=None, delta=None, allow=None):
    """Plain PyTorch version of K6: stats int32[38] of the live rows (of
    the extents and the delta) that pass the filter and the bitmap."""
    q = filter_args(filt)
    _filter_flags(flags, q)
    ext = _check_extents(extents, feats16.shape[0])
    if flags is None:
        flags = torch.zeros_like(docids)
    f, fl, d = _source_rows(feats16, flags, docids, ext, delta)
    v = live_rows(d, dead)
    if q != NO_FILTER:
        v &= constraint_valid(f, fl, q)
    if allow is not None:
        v &= bitmap_member(allow, d)
    st, _ = KC.cardinal_stats_plain(f, v, d, 0)
    return st


def span_stats(feats16, docids, dead, extents, flags=None, filt=None,
               delta=None, allow=None):
    """K6: the statistics (masked column min/max, tf min/max; host maximum
    0) of the live rows of up to 8 arena extents, and of the RAM delta
    block `delta` after them, that pass the filter (`flags`, the arena's,
    read under a flag filter) and the facet bitmap `allow`:
    int32[38]."""
    q = filter_args(filt)
    _filter_flags(flags, q)
    dev = feats16.device
    delta, dn = _check_delta(delta, dev)
    allow = _check_allow(allow, dev)
    if dev.type == "cpu":
        return span_stats_plain(feats16, docids, dead, extents, flags, q,
                                delta, allow)
    cap = _require_arena(feats16, flags, docids, dead, dev)
    ext = _check_extents(extents, cap)
    # the statistics, then the kernel's accumulator and ticket
    out = torch.empty(2 * KC.STATS_LEN + 1, dtype=torch.int32, device=dev)
    ext_arg, filt_arg = _ext_arg(ext), _filt_arg(q)
    rc = B.library().yt_span_stats(
        feats16.data_ptr(), flags.data_ptr() if flags is not None else None,
        docids.data_ptr(), dead.data_ptr(), dead.shape[0],
        ctypes.addressof(ext_arg), len(ext), ctypes.addressof(filt_arg),
        *_allow_args(allow), *_delta_args(delta, dn), out.data_ptr(),
        B.stream_ptr(dev))
    B.check(rc, "span_stats")
    B.count_launch("span_stats")
    return out[:KC.STATS_LEN]


def _allow_args(allow):
    return ((allow.data_ptr(), allow.shape[0]) if allow is not None
            else (None, 0))


def _delta_args(delta, dn):
    if delta is None:
        return None, None, None, 0
    return (delta[0].data_ptr(), delta[1].data_ptr(), delta[2].data_ptr(),
            dn)


# ---------------------------------------------------------------------------
# K7 span_score
# ---------------------------------------------------------------------------

def span_score_plain(feats16, flags, docids, dead, extents, stats, consts,
                     out_len: int, filt=None, delta=None, allow=None):
    """Plain PyTorch version of K7 (scored in steps of 2^20 rows)."""
    q = filter_args(filt)
    dev = feats16.device
    ext = _check_extents(extents, feats16.shape[0])
    out = torch.full((out_len,), KC.SMALL, dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    srcs = [(feats16[s:s + c], flags[s:s + c], docids[s:s + c])
            for s, c in ext]
    if delta is not None:
        srcs.append(delta)
    pos = 0
    for f_s, fl_s, d_s in srcs:
        c = d_s.shape[0]
        for lo in range(0, c, _PLAIN_ROWS):
            hi = min(c, lo + _PLAIN_ROWS)
            dd, f, fl = d_s[lo:hi], f_s[lo:hi], fl_s[lo:hi]
            v = live_rows(dd, dead)
            if q != NO_FILTER:
                v &= constraint_valid(f, fl, q)
            if allow is not None:
                v &= bitmap_member(allow, dd)
            out[pos + lo:pos + hi] = KC.cardinal_score_plain(
                f, fl, v, torch.zeros_like(dd), stats, zero, consts, True)
        pos += c
    return out


def span_score(feats16, flags, docids, dead, extents, stats, consts,
               out_len: int, filt=None, delta=None, allow=None):
    """K7: the rows of up to 8 arena extents, then of the RAM delta block
    `delta`, scored against `stats` (int32[38]) in that order, dead rows
    and rows the filter or the facet bitmap `allow` rejects -(2^31-1),
    into [out_len] int32 (out_len >= their rows; the rest
    -(2^31-1))."""
    q = filter_args(filt)
    dev = feats16.device
    delta, dn = _check_delta(delta, dev)
    allow = _check_allow(allow, dev)
    rows = sum(int(c) for _s, c in extents) + dn
    if out_len < rows:
        raise ValueError(f"out_len {out_len} < the sources' {rows} rows")
    if dev.type == "cpu":
        return span_score_plain(feats16, flags, docids, dead, extents, stats,
                                consts, out_len, q, delta, allow)
    cap = _require_arena(feats16, flags, docids, dead, dev)
    ext = _check_extents(extents, cap)
    B.require(stats, "stats", (torch.int32,), 1, dev)
    B.require(consts, "consts", (torch.int32,), 1, dev)
    out = torch.empty(out_len, dtype=torch.int32, device=dev)
    ext_arg, filt_arg = _ext_arg(ext), _filt_arg(q)
    rc = B.library().yt_span_score(
        feats16.data_ptr(), flags.data_ptr(), docids.data_ptr(),
        dead.data_ptr(), dead.shape[0], ctypes.addressof(ext_arg), len(ext),
        ctypes.addressof(filt_arg), *_allow_args(allow),
        *_delta_args(delta, dn), stats.data_ptr(), consts.data_ptr(),
        out.data_ptr(), out_len, B.stream_ptr(dev))
    B.check(rc, "span_score")
    B.count_launch("span_score")
    return out


# ---------------------------------------------------------------------------
# topk_finish
# ---------------------------------------------------------------------------

def _winners_plain(top_s, top_rows, docids, extents, delta_docids=None):
    """(scores, docids) of kernel 3's winners over the extents and a delta
    block, (-(2^31-1), -1) at or below -(2^31-1)."""
    r = top_rows.to(torch.int64)
    d = torch.full_like(r, -1)
    base = 0
    for s, c in extents:
        inside = (r >= base) & (r < base + c)
        d = torch.where(inside, docids[(s + r - base).clamp(
            0, docids.shape[0] - 1)].to(torch.int64), d)
        base += c
    if delta_docids is not None and delta_docids.shape[0]:
        n = delta_docids.shape[0]
        inside = (r >= base) & (r < base + n)
        d = torch.where(inside, delta_docids[(r - base).clamp(0, n - 1)]
                        .to(torch.int64), d)
    gone = top_s <= KC.SMALL
    return (torch.where(gone, KC.SMALL, top_s),
            torch.where(gone, -1, d).to(torch.int32))


def topk_finish_plain(top_s, top_rows, docids, extents, stats=None,
                      pmax=None, tail=None, delta_docids=None):
    """Plain PyTorch version of topk_finish."""
    dev = top_s.device
    kk = top_s.shape[0]
    s, d = _winners_plain(top_s, top_rows, docids, extents, delta_docids)
    if stats is not None:
        return torch.cat([s, d, stats[:2 * P.NF + 2]])
    tstart, j0, tcount, shift, lang = tail
    theta = max(int(top_s[kk - 1]), KC.SMALL)
    ok = tail_ok_plain(pmax[tstart + j0:tstart + max(tcount, j0)], shift,
                       lang, theta)
    return torch.cat([s, d, torch.tensor([int(ok)], dtype=torch.int32,
                                         device=dev)])


def topk_finish(top_s, top_rows, docids, extents, stats=None, pmax=None,
                tail=None, delta_docids=None):
    """The kk winners of kernel 3 (scores, rows of a span_score buffer
    over `extents` and then a delta block whose docids are
    `delta_docids`) as scores and docids, (-(2^31-1), -1) wherever the
    score is -(2^31-1) or less; then either `stats[:36]` (the exact scan:
    [2kk + 36]) or the ok of the tail tiles [j0, tcount) of a span's pmax
    rows from tstart, `tail` = (tstart, j0, tcount, bound_shift,
    lang_term), against theta = max(kk-th score, -(2^31-1)): [2kk + 1]."""
    if (stats is None) == (tail is None):
        raise ValueError("topk_finish: give stats or tail, not both")
    if top_s.device.type == "cpu":
        return topk_finish_plain(top_s, top_rows, docids, extents, stats,
                                 pmax, tail, delta_docids)
    dev = top_s.device
    kk = top_s.shape[0]
    B.require(top_s, "top_s", (torch.int32,), 1, dev)
    B.require(top_rows, "top_rows", (torch.int32,), 1, dev)
    B.require(docids, "docids", (torch.int32,), 1, dev)
    if delta_docids is not None:
        B.require(delta_docids, "delta_docids", (torch.int32,), 1, dev)
    if top_rows.shape[0] != kk:
        raise ValueError("top_s and top_rows must have kk entries")
    ext = _check_extents(extents, docids.shape[0])
    if stats is not None:
        B.require(stats, "stats", (torch.int32,), 1, dev)
        tstart = j0 = tcount = shift = lang = 0
        pm = stats          # not read
        out = torch.empty(2 * kk + 2 * P.NF + 2, dtype=torch.int32,
                          device=dev)
    else:
        tstart, j0, tcount, shift, lang = (int(v) for v in tail)
        B.require(pmax, "pmax", (torch.int32,), 1, dev)
        if tstart < 0 or tstart + tcount > pmax.shape[0]:
            raise ValueError("tail rows outside the pmax side-table")
        pm = pmax
        out = torch.empty(2 * kk + 1, dtype=torch.int32, device=dev)
    ext_arg = _ext_arg(ext)
    dn = delta_docids.shape[0] if delta_docids is not None else 0
    rc = B.library().yt_topk_finish(
        top_s.data_ptr(), top_rows.data_ptr(), kk, docids.data_ptr(),
        ctypes.addressof(ext_arg), len(ext),
        delta_docids.data_ptr() if dn else None, dn, pm.data_ptr(),
        tstart, j0, tcount, shift, lang,
        stats.data_ptr() if stats is not None else None, out.data_ptr(),
        B.stream_ptr(dev))
    B.check(rc, "topk_finish")
    B.count_launch("topk_finish")
    return out


# ---------------------------------------------------------------------------
# K8 join_member
# ---------------------------------------------------------------------------

def _popc32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of uint32 values held in int64 (_popc32's SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    return ((((x + (x >> 4)) & 0x0F0F0F0F) * 0x01010101) >> 24) & 0xFF


def _member_plain(docids, jstart: int, jcount: int, slot: int, jdocids, jpos,
                 bmtab, valid=None):
    """Membership of `docids` ([n] int32) in one partner: (found bool [n],
    the partner's arena row int64 [n], 0 where not found). slot >= 0: its
    docid bitmap (_membership_bitmap); -1: its docid-sorted segment
    jdocids[jstart:jstart + jcount], searched for clip(docid, 0, 2^29),
    where of the rows still `valid` whose docid the clip makes 2^29 only
    the last matches (_membership_sorted's stable co-sort puts only that
    one next to the segment's entry; a span holds no docid twice, so no
    other key repeats)."""
    d = docids.to(torch.int64)
    if slot >= 0:
        nbits = bmtab.shape[1] * 32
        t = d.clamp(0, nbits - 1)
        wp = bmtab[slot][t >> 5].to(torch.int64)
        w = wp[:, 0] & 0xFFFFFFFF
        sh = t & 31
        found = (((w >> sh) & 1) == 1) & (d >= 0) & (d < nbits)
        rank = wp[:, 1] + _popc32(w & ((1 << sh) - 1))
        p = (jstart + rank).clamp(0, jpos.shape[0] - 1)
        return found, torch.where(found, jpos[p].to(torch.int64), 0)
    seg = jdocids[jstart:jstart + jcount]
    if jcount == 0:
        return (torch.zeros_like(d, dtype=torch.bool), torch.zeros_like(d))
    key = d.clamp(0, JOIN_DOCID_CAP).to(torch.int32)
    i = torch.searchsorted(seg, key).clamp(max=jcount - 1)
    found = seg[i] == key
    high = d >= JOIN_DOCID_CAP
    cand = high & valid if valid is not None else high
    if int(cand.sum()) > 1:
        last = int(torch.nonzero(cand)[-1])
        found &= ~high | (torch.arange(len(d), device=d.device) == last)
    return found, torch.where(found, jpos[jstart + i].to(torch.int64), 0)


def _check_join(feats16, start, count, jdocids, bmtab, parts, n_inc):
    parts = [(int(a), int(b), int(c)) for a, b, c in parts]
    n_exc = len(parts) - n_inc
    if not 0 <= n_inc <= MAX_PARTNERS or not 0 <= n_exc <= MAX_EXCLUDES:
        raise ValueError(f"{n_inc} partners and {n_exc} excludes: at most "
                         f"{MAX_PARTNERS} and {MAX_EXCLUDES}")
    if start < 0 or count < 0 or start + count > feats16.shape[0]:
        raise ValueError(f"rows ({start}, {count}) outside the arena")
    for js, jc, slot in parts:
        if js < 0 or jc < 0 or js + jc > jdocids.shape[0]:
            raise ValueError(f"segment ({js}, {jc}) outside the join table")
        if slot >= bmtab.shape[0] or (slot >= 0 and bmtab.dim() != 3):
            raise ValueError(f"bitmap slot {slot} outside the table")
    return parts


def join_member_plain(feats16, flags, docids, dead, start: int, count: int,
                      jdocids, jpos, bmtab, parts, n_inc: int, filt=None):
    """Plain PyTorch version of K8: (merged int32 [count, 17], flags int32
    [count], valid bool [count])."""
    q = filter_args(filt)
    parts = _check_join(feats16, start, count, jdocids, bmtab, parts, n_inc)
    f = feats16[start:start + count]
    d = docids[start:start + count]
    fo = flags[start:start + count].clone()
    v = live_rows(d, dead)
    pmin = f[:, P.F_POSINTEXT].to(torch.int32)
    pmax, hmin = pmin.clone(), f[:, P.F_HITCOUNT].to(torch.int32)
    for i, (js, jc, slot) in enumerate(parts):
        found, row = _member_plain(d, js, jc, slot, jdocids, jpos, bmtab,
                                   v)
        found &= v          # a row no longer valid tests no later term
        if i < n_inc:
            pp = feats16[row, P.F_POSINTEXT].to(torch.int32)
            pmin = torch.where(found, torch.minimum(pmin, pp), pmin)
            pmax = torch.where(found, torch.maximum(pmax, pp), pmax)
            hmin = torch.where(found, torch.minimum(
                hmin, feats16[row, P.F_HITCOUNT].to(torch.int32)), hmin)
            fo = torch.where(found, fo | flags[row], fo)
            v = found
        else:
            v = v & ~found
    merged = f.to(torch.int32)
    merged[:, P.F_WORDDISTANCE] = pmax - pmin
    merged[:, P.F_HITCOUNT] = hmin
    if q != NO_FILTER:
        v &= constraint_valid(f, fo, q)
    return merged, fo, v


def join_member(feats16, flags, docids, dead, start: int, count: int,
                jdocids, jpos, bmtab, parts, n_inc: int, filt=None):
    """K8: the rows [start, start + count) of the arena (the rarest
    include's span) joined to their partners: `parts` holds (jstart,
    jcount, slot) of each include partner (the first `n_inc`) and each
    exclude, slot the bitmap slot (bmtab [slots, nwords, 2]) or -1 for
    the docid-sorted segment jdocids/jpos[jstart:jstart + jcount]. A row
    is valid when it is live, in every partner, in no exclude and passes
    the filter; in sort mode a docid at or above 2^29 is clipped to 2^29,
    and of the still-valid rows it makes equal only the last matches, as
    in the reference. Returns (merged int32 [count, 17]: the row with
    worddistance = max - min of posintext and hitcount = min over it and
    its partner rows; flags int32 [count]: their OR; valid bool
    [count])."""
    q = filter_args(filt)
    start, count = int(start), int(count)
    if feats16.device.type == "cpu":
        return join_member_plain(feats16, flags, docids, dead, start, count,
                                 jdocids, jpos, bmtab, parts, n_inc, q)
    dev = feats16.device
    _require_arena(feats16, flags, docids, dead, dev)
    for name, t in (("jdocids", jdocids), ("jpos", jpos)):
        B.require(t, name, (torch.int32,), 1, dev)
    if jpos.shape != jdocids.shape:
        raise ValueError("jdocids and jpos must have one entry each")
    B.require(bmtab, "bmtab", (torch.int32,), 3, dev)
    parts = _check_join(feats16, start, count, jdocids, bmtab, parts, n_inc)
    merged = torch.empty((count, P.NF), dtype=torch.int32, device=dev)
    fo = torch.empty(count, dtype=torch.int32, device=dev)
    v = torch.empty(count, dtype=torch.bool, device=dev)
    # the count of rare rows at or above 2^29 (the clip rule's fix-up)
    nhigh = torch.empty(1, dtype=torch.int32, device=dev)
    flat = [x for p in parts for x in p] or [0]
    parts_arg = (ctypes.c_int64 * len(flat))(*flat)
    filt_arg = _filt_arg(q)
    rc = B.library().yt_join_member(
        feats16.data_ptr(), flags.data_ptr(), docids.data_ptr(),
        dead.data_ptr(), dead.shape[0], start, count, jdocids.data_ptr(),
        jpos.data_ptr(), jdocids.shape[0], bmtab.data_ptr(), bmtab.shape[1],
        ctypes.addressof(parts_arg), n_inc, len(parts) - n_inc,
        ctypes.addressof(filt_arg), merged.data_ptr(), fo.data_ptr(),
        v.data_ptr(), nhigh.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "join_member")
    B.count_launch("join_member")
    return merged, fo, v


# ---------------------------------------------------------------------------
# the batched exact scan: K6, K7 and topk_finish over a wave of queries
# ---------------------------------------------------------------------------

def scan_batch_desc(slots) -> np.ndarray:
    """A wave of up to BATCH_SLOTS exact scans, each (extents, filter), as
    the batched kernels take it: int32 [bs, SLOT_DESC_WORDS], a slot's
    extent count, its 8 (start, count) pairs (unused ones 0) and its
    filter's 4 ints (the qi rows of _dispatch_scans)."""
    bs = len(slots)
    if not 1 <= bs <= BATCH_SLOTS:
        raise ValueError(f"{bs} slots: a wave holds 1 to {BATCH_SLOTS}")
    desc = np.zeros((bs, SLOT_DESC_WORDS), np.int32)
    for i, (extents, filt) in enumerate(slots):
        ext = [(int(a), int(c)) for a, c in extents]
        if len(ext) > MAX_EXTENTS:
            raise ValueError(f"{len(ext)} extents, at most {MAX_EXTENTS}")
        desc[i, 0] = len(ext)
        for e, (a, c) in enumerate(ext):
            desc[i, 1 + 2 * e], desc[i, 2 + 2 * e] = a, c
        desc[i, 1 + 2 * MAX_EXTENTS:] = filter_args(filt)
    return desc


def desc_scans(desc: np.ndarray):
    """The (extents, filter) of each slot of a scan_batch_desc wave."""
    out = []
    for row in np.asarray(desc):
        n = int(row[0])
        out.append(([(int(row[1 + 2 * e]), int(row[2 + 2 * e]))
                     for e in range(n)],
                    tuple(int(v) for v in row[1 + 2 * MAX_EXTENTS:])))
    return out


def _check_wave(desc, cap: int) -> np.ndarray:
    desc = np.ascontiguousarray(desc, np.int32)
    if desc.ndim != 2 or desc.shape[1] != SLOT_DESC_WORDS \
            or not 1 <= desc.shape[0] <= BATCH_SLOTS:
        raise ValueError(f"a wave is int32 [1..{BATCH_SLOTS}, "
                         f"{SLOT_DESC_WORDS}], got {desc.shape}")
    for ext, _filt in desc_scans(desc):
        _check_extents(ext, cap)
    return desc


def span_stats_batch_plain(feats16, flags, docids, dead, desc):
    """Plain PyTorch version of the batched K6: [bs, 38]."""
    return torch.stack([span_stats_plain(feats16, docids, dead, ext, flags,
                                         filt)
                        for ext, filt in desc_scans(desc)])


def span_stats_batch(feats16, flags, docids, dead, desc):
    """Batched K6: the statistics of each slot of a wave (scan_batch_desc)
    over the live rows of its extents that pass its filter, [bs, 38]
    int32 (a view of rows 77 apart on the card)."""
    if feats16.device.type == "cpu":
        return span_stats_batch_plain(feats16, flags, docids, dead, desc)
    dev = feats16.device
    cap = _require_arena(feats16, flags, docids, dead, dev)
    desc = _check_wave(desc, cap)
    bs = desc.shape[0]
    # per slot: the statistics, then the kernel's accumulator and ticket
    out = torch.empty((bs, _STATS_SLOT), dtype=torch.int32, device=dev)
    rc = B.library().yt_span_stats_batch(
        feats16.data_ptr(), flags.data_ptr(), docids.data_ptr(),
        dead.data_ptr(), dead.shape[0], desc.ctypes.data, bs,
        out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "span_stats_batch")
    B.count_launch("span_stats_batch", slots=bs)
    return out[:, :KC.STATS_LEN]


# a slot's region of the batched K7's packed output starts on a 128-byte
# boundary: kernel 3 reads its scores as 16-byte vectors
_REGION_ALIGN = 32


def scan_batch_offsets(desc, kk: int) -> np.ndarray:
    """The batched K7's packed output layout: int64 [bs + 1] region
    starts, slot s in [off[s], off[s + 1]), max(its rows, kk) entries
    (the solo scan's buffer, scan_query's) rounded up to _REGION_ALIGN.
    Each slot's kernel 3 reads its first max(rows, kk) entries."""
    lens = [max(sum(c for _a, c in ext), kk) for ext, _f in desc_scans(desc)]
    off = np.zeros(len(lens) + 1, np.int64)
    off[1:] = np.cumsum([-(-n // _REGION_ALIGN) * _REGION_ALIGN
                         for n in lens])
    return off


def span_score_batch_plain(feats16, flags, docids, dead, desc, stats,
                           consts, out_off):
    """Plain PyTorch version of the batched K7: int32 [out_off[-1]]."""
    return torch.cat([
        span_score_plain(feats16, flags, docids, dead, ext, stats[i],
                         consts, int(out_off[i + 1] - out_off[i]), filt)
        for i, (ext, filt) in enumerate(desc_scans(desc))])


def span_score_batch(feats16, flags, docids, dead, desc, stats, consts,
                     out_off):
    """Batched K7: each slot's rows scored against its row of `stats`
    ([bs, 38], span_stats_batch's) under its filter, in extent order, into
    its region [out_off[s], out_off[s + 1]) of one packed int32 buffer
    (scan_batch_offsets; the region's entries past its rows
    -(2^31-1)). One profile a wave (`consts`)."""
    scans = desc_scans(desc)
    out_off = np.ascontiguousarray(out_off, np.int64)
    if out_off.shape != (len(scans) + 1,) or out_off[0] != 0 or any(
            out_off[i + 1] - out_off[i] < sum(c for _a, c in ext)
            for i, (ext, _f) in enumerate(scans)):
        raise ValueError("out_off: bs + 1 region starts from 0, each "
                         "region at least its slot's rows")
    if feats16.device.type == "cpu":
        return span_score_batch_plain(feats16, flags, docids, dead, desc,
                                      stats, consts, out_off)
    dev = feats16.device
    cap = _require_arena(feats16, flags, docids, dead, dev)
    desc = _check_wave(desc, cap)
    bs = desc.shape[0]
    if stats.dtype != torch.int32 or stats.device != dev \
            or stats.shape != (bs, KC.STATS_LEN) or stats.stride(1) != 1:
        raise ValueError("stats: int32 [bs, 38] rows on the card expected")
    B.require(consts, "consts", (torch.int32,), 1, dev)
    out = torch.empty(int(out_off[-1]), dtype=torch.int32, device=dev)
    rc = B.library().yt_span_score_batch(
        feats16.data_ptr(), flags.data_ptr(), docids.data_ptr(),
        dead.data_ptr(), dead.shape[0], desc.ctypes.data, bs,
        stats.data_ptr(), stats.stride(0), consts.data_ptr(), out.data_ptr(),
        out_off.ctypes.data, B.stream_ptr(dev))
    B.check(rc, "span_score_batch")
    B.count_launch("span_score_batch", slots=bs)
    return out


def topk_finish_batch_plain(top_s, top_rows, docids, desc):
    """Plain PyTorch version of topk_finish_batch: [bs, 2kk]."""
    return torch.stack([
        torch.cat(_winners_plain(top_s[i], top_rows[i], docids, ext))
        for i, (ext, _filt) in enumerate(desc_scans(desc))])


def topk_finish_batch(top_s, top_rows, docids, desc):
    """The finish of a wave of batched scans: each slot's kk winners of
    kernel 3 (top_s / top_rows [bs, kk] over its span_score_batch region) as
    scores and docids, (-(2^31-1), -1) at or below -(2^31-1): [bs, 2kk]
    int32 (_rank_scan_batch_packed_kernel's output)."""
    if top_s.device.type == "cpu":
        return topk_finish_batch_plain(top_s, top_rows, docids, desc)
    dev = top_s.device
    B.require(top_s, "top_s", (torch.int32,), 2, dev)
    B.require(top_rows, "top_rows", (torch.int32,), 2, dev)
    B.require(docids, "docids", (torch.int32,), 1, dev)
    desc = _check_wave(desc, docids.shape[0])
    bs, kk = top_s.shape
    if top_rows.shape != (bs, kk) or desc.shape[0] != bs:
        raise ValueError("top_s, top_rows and the wave must have bs rows")
    out = torch.empty((bs, 2 * kk), dtype=torch.int32, device=dev)
    rc = B.library().yt_topk_finish_batch(
        top_s.data_ptr(), top_rows.data_ptr(), kk, docids.data_ptr(),
        desc.ctypes.data, bs, out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "topk_finish_batch")
    B.count_launch("topk_finish_batch", slots=bs)
    return out


# ---------------------------------------------------------------------------
# the batched join: K8 and kernels 1-2 over a wave of conjunctions
# ---------------------------------------------------------------------------

JOIN_QARGS = 6   # a slot's start, count and filter before its partners


def join_wave_desc(slots, n_inc: int, n_exc: int) -> np.ndarray:
    """A wave of up to BATCH_SLOTS conjunctions, each (start, count,
    filter, parts) as join_member takes them (the rare span's rows, a
    4-int filter or None, then n_inc partners and n_exc excludes as
    (jstart, jcount, slot or -1)), as the batched kernels take it: int32
    [bs, 6 + 3 (n_inc + n_exc)] in the reference's qargs_batch layout,
    [start, count, lang, flag bit, from days, to days, jstart of each
    partner, their jcounts, their slots, then the same of each exclude]
    (devstore.py:661-666, :4776-4786), a sort-mode membership's slot
    -1."""
    bs = len(slots)
    if not 1 <= bs <= BATCH_SLOTS:
        raise ValueError(f"{bs} slots: a wave holds 1 to {BATCH_SLOTS}")
    desc = np.zeros((bs, JOIN_QARGS + 3 * (n_inc + n_exc)), np.int32)
    for i, (start, count, filt, parts) in enumerate(slots):
        if len(parts) != n_inc + n_exc:
            raise ValueError(f"slot {i}: {len(parts)} parts, expected "
                             f"{n_inc} + {n_exc}")
        inc, exc = parts[:n_inc], parts[n_inc:]
        desc[i] = [int(start), int(count), *filter_args(filt),
                   *(int(p[j]) for j in range(3) for p in inc),
                   *(int(p[j]) for j in range(3) for p in exc)]
    return desc


def join_wave_slots(desc, n_inc: int):
    """The (start, count, filter, parts) of each slot of a join wave."""
    desc = np.asarray(desc)
    n_exc = (desc.shape[1] - JOIN_QARGS) // 3 - n_inc
    out = []
    for row in desc.tolist():
        q = row[JOIN_QARGS:]
        inc = q[:3 * n_inc]
        exc = q[3 * n_inc:]
        parts = ([(inc[t], inc[n_inc + t], inc[2 * n_inc + t])
                  for t in range(n_inc)]
                 + [(exc[e], exc[n_exc + e], exc[2 * n_exc + e])
                    for e in range(n_exc)])
        out.append((row[0], row[1], tuple(row[2:JOIN_QARGS]), parts))
    return out


def join_wave_offsets(desc) -> np.ndarray:
    """The regions of a join wave's buffers: int64 [bs + 1] row starts,
    slot s's merged rows, flags, valid bytes and scores at [off[s],
    off[s] + its count), each region rounded up to _REGION_ALIGN rows
    (kernel 3 reads a slot's scores from its region's start as 16-byte
    vectors); the rows past a slot's count are never read."""
    counts = np.asarray(desc, np.int64)[:, 1]
    off = np.zeros(len(counts) + 1, np.int64)
    off[1:] = np.cumsum(-(-counts // _REGION_ALIGN) * _REGION_ALIGN)
    return off


def _check_offsets(desc, off) -> np.ndarray:
    """A join wave's region starts (join_wave_offsets'), checked."""
    off = np.ascontiguousarray(off, np.int64)
    if off.shape != (desc.shape[0] + 1,) or off[0] != 0 \
            or (off[1:] - off[:-1] < desc[:, 1]).any():
        raise ValueError("off: bs + 1 region starts from 0, each region at "
                         "least its slot's rows")
    return off


def _check_join_wave(feats16, jdocids, bmtab, desc, n_inc: int, off):
    desc = np.ascontiguousarray(desc, np.int32)
    n_exc = (desc.shape[1] - JOIN_QARGS) // 3 - n_inc if desc.ndim == 2 \
        else -1
    if (desc.ndim != 2 or not 1 <= desc.shape[0] <= BATCH_SLOTS
            or n_exc < 0 or desc.shape[1] != JOIN_QARGS + 3 * (n_inc + n_exc)):
        raise ValueError(f"a join wave is int32 [1..{BATCH_SLOTS}, 6 + 3 "
                         f"(n_inc + n_exc)], got {desc.shape} with n_inc "
                         f"{n_inc}")
    for start, count, _f, parts in join_wave_slots(desc, n_inc):
        _check_join(feats16, start, count, jdocids, bmtab, parts, n_inc)
    return desc, n_exc, _check_offsets(desc, off)


def wave_rows(t, desc, off):
    """The rows of a join wave's buffer `t` that its kernels write: each
    slot's count of rows from its region's start, in slot order."""
    return torch.cat([t[o:o + c] for o, c in zip(
        np.asarray(off)[:-1].tolist(), np.asarray(desc)[:, 1].tolist())])


def join_member_batch_plain(feats16, flags, docids, dead, jdocids, jpos,
                            bmtab, desc, n_inc: int, off):
    """Plain PyTorch version of the batched K8: (merged int32 [off[-1],
    17], flags int32 [off[-1]], valid bool [off[-1]]), each slot
    join_member_plain's in its region, the rows past its count 0 / False."""
    desc, _n_exc, off = _check_join_wave(feats16, jdocids, bmtab, desc,
                                         n_inc, off)
    dev = feats16.device
    rows = int(off[-1])
    merged = torch.zeros((rows, P.NF), dtype=torch.int32, device=dev)
    fo = torch.zeros(rows, dtype=torch.int32, device=dev)
    v = torch.zeros(rows, dtype=torch.bool, device=dev)
    for i, (start, count, filt, parts) in enumerate(
            join_wave_slots(desc, n_inc)):
        o = int(off[i])
        m, f, w = join_member_plain(feats16, flags, docids, dead, start,
                                    count, jdocids, jpos, bmtab, parts,
                                    n_inc, filt)
        merged[o:o + count], fo[o:o + count], v[o:o + count] = m, f, w
    return merged, fo, v


def join_member_batch(feats16, flags, docids, dead, jdocids, jpos, bmtab,
                      desc, n_inc: int, off):
    """The batched K8: join_member for each slot of a join wave
    (`desc`, join_wave_desc's; each slot its own rare span, filter and
    partner segments, a partner's mode by its slot: >= 0 a bitmap, -1 a
    sorted segment, the clip rule's fix-up a slot's own), its merged rows,
    OR'd flags and valid bytes in its region [off[s], off[s] + count) of
    three wave buffers (`off`: join_wave_offsets): (merged int32
    [off[-1], 17], flags int32 [off[-1]], valid bool [off[-1]]); the rows
    past a slot's count are not written on the card."""
    if feats16.device.type == "cpu":
        return join_member_batch_plain(feats16, flags, docids, dead, jdocids,
                                       jpos, bmtab, desc, n_inc, off)
    dev = feats16.device
    _require_arena(feats16, flags, docids, dead, dev)
    for name, t in (("jdocids", jdocids), ("jpos", jpos)):
        B.require(t, name, (torch.int32,), 1, dev)
    if jpos.shape != jdocids.shape:
        raise ValueError("jdocids and jpos must have one entry each")
    B.require(bmtab, "bmtab", (torch.int32,), 3, dev)
    desc, n_exc, off = _check_join_wave(feats16, jdocids, bmtab, desc, n_inc,
                                        off)
    bs, rows = desc.shape[0], int(off[-1])
    merged = torch.empty((rows, P.NF), dtype=torch.int32, device=dev)
    fo = torch.empty(rows, dtype=torch.int32, device=dev)
    v = torch.empty(rows, dtype=torch.bool, device=dev)
    # each slot's count of rare rows at or above 2^29 (the clip fix-up)
    nhigh = torch.empty(bs, dtype=torch.int32, device=dev)
    rc = B.library().yt_join_member_batch(
        feats16.data_ptr(), flags.data_ptr(), docids.data_ptr(),
        dead.data_ptr(), dead.shape[0], jdocids.data_ptr(), jpos.data_ptr(),
        jdocids.shape[0], bmtab.data_ptr(), bmtab.shape[1], desc.ctypes.data,
        bs, n_inc, n_exc, off.ctypes.data, merged.data_ptr(), fo.data_ptr(),
        v.data_ptr(), nhigh.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "join_member_batch")
    B.count_launch("join_member_batch", slots=int((desc[:, 1] > 0).sum()))
    return merged, fo, v


def _check_regions(merged, desc, off, *rows):
    desc = np.ascontiguousarray(desc, np.int32)
    if desc.ndim != 2 or not 1 <= desc.shape[0] <= BATCH_SLOTS:
        raise ValueError(f"a join wave holds 1 to {BATCH_SLOTS} slots")
    off = _check_offsets(desc, off)
    n = int(off[-1])
    if merged.shape != (n, P.NF) or any(t.shape[0] != n for t in rows):
        raise ValueError(f"wave buffers of {n} rows expected")
    return desc, off


def join_stats_batch_plain(merged, valid, desc, off):
    """Plain PyTorch version of the batched kernel 1: [bs, 38]."""
    desc, off = _check_regions(merged, desc, off, valid)
    return torch.stack([
        KC.cardinal_stats_plain(merged[o:o + c], valid[o:o + c], None, 0)[0]
        for o, c in zip(off[:-1].tolist(), desc[:, 1].tolist())])


def join_stats_batch(merged, valid, desc, off):
    """The batched kernel 1 without host counts (the reference's
    num_hosts = 1): the statistics of the valid merged rows of each slot
    of a join wave, over its region [off[s], off[s] + count) of
    join_member_batch's buffers: [bs, 38] int32 (a view of rows 77 apart
    on the card)."""
    if merged.device.type == "cpu":
        return join_stats_batch_plain(merged, valid, desc, off)
    dev = merged.device
    B.require(merged, "merged", (torch.int32,), 2, dev)
    B.require(valid, "valid", (torch.bool,), 1, dev)
    desc, off = _check_regions(merged, desc, off, valid)
    bs = desc.shape[0]
    counts = np.ascontiguousarray(desc[:, 1], np.int64)
    # per slot: the statistics, then the kernel's accumulator and ticket
    out = torch.empty((bs, _STATS_SLOT), dtype=torch.int32, device=dev)
    rc = B.library().yt_join_stats_batch(
        merged.data_ptr(), valid.data_ptr(), off.ctypes.data,
        counts.ctypes.data, bs, out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "join_stats_batch")
    B.count_launch("join_stats_batch", slots=int((counts > 0).sum()))
    return out[:, :KC.STATS_LEN]


def join_score_batch_plain(merged, flags, valid, desc, off, stats, consts):
    """Plain PyTorch version of the batched kernel 2: int32 [off[-1]],
    the rows past a slot's count -(2^31-1)."""
    desc, off = _check_regions(merged, desc, off, flags, valid)
    out = torch.full((int(off[-1]),), KC.SMALL, dtype=torch.int32,
                     device=merged.device)
    one = torch.zeros(1, dtype=torch.int32, device=merged.device)
    for i, c in enumerate(desc[:, 1].tolist()):
        o = int(off[i])
        out[o:o + c] = KC.cardinal_score_plain(
            merged[o:o + c], flags[o:o + c], valid[o:o + c], None, stats[i],
            one, consts, False)
    return out


def join_score_batch(merged, flags, valid, desc, off, stats, consts):
    """The batched kernel 2 on the int32 path: each slot's merged rows of
    a join wave scored against its row of `stats` ([bs, 38],
    join_stats_batch's) under one profile (`consts`), with their OR'd
    flags, into its region of one int32 [off[-1]] buffer; invalid rows
    -(2^31-1), the rows past a slot's count not written on the card."""
    if merged.device.type == "cpu":
        return join_score_batch_plain(merged, flags, valid, desc, off, stats,
                                      consts)
    dev = merged.device
    B.require(merged, "merged", (torch.int32,), 2, dev)
    B.require(flags, "flags", (torch.int32,), 1, dev)
    B.require(valid, "valid", (torch.bool,), 1, dev)
    B.require(consts, "consts", (torch.int32,), 1, dev)
    desc, off = _check_regions(merged, desc, off, flags, valid)
    bs = desc.shape[0]
    if stats.dtype != torch.int32 or stats.device != dev \
            or stats.shape != (bs, KC.STATS_LEN) or stats.stride(1) != 1:
        raise ValueError("stats: int32 [bs, 38] rows on the card expected")
    counts = np.ascontiguousarray(desc[:, 1], np.int64)
    out = torch.empty(int(off[-1]), dtype=torch.int32, device=dev)
    rc = B.library().yt_join_score_batch(
        merged.data_ptr(), flags.data_ptr(), valid.data_ptr(),
        off.ctypes.data, counts.ctypes.data, bs, stats.data_ptr(),
        stats.stride(0), consts.data_ptr(), out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "join_score_batch")
    B.count_launch("join_score_batch", slots=int((counts > 0).sum()))
    return out
