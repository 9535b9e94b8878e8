"""The devstore's kernels: K5 `pruned_tile`, K6 `span_stats`, K7
`span_score`, `topk_finish` and K8 `join_member`.

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
  up to 8 extents, minus the top-k: kernel 3 (`tie_topk`, index mode)
  selects from span_score's buffer, in the order of the JAX running
  merge.
- `topk_finish` (csrc/pruned_tile.cu) maps kernel 3's winners back to
  docids, applies the init entries' rule, and appends the tail check's ok
  (the b > 1 escalation of _pruned_span_topk) or the scan's statistics
  (_rank_spans_packed_kernel's [2kk + 36] output).
- `join_member` (csrc/join.cu) replaces the membership and merge of
  _join_topk, the body of _rank_join_batch_kernel /
  _rank_join_bm_batch_kernel and their packed twins: each row of the
  rarest include's span tested against every partner (binary search of
  its docid-sorted segment, or its docid bitmap) and every exclude, the
  partner rows merged in, the constraint filter applied; kernels 1-3 and
  topk_finish rank the merged block.

K6, K7 and K8 take a constraint filter `filt` (_constraint_valid): the
4-tuple (language, flag bit, from days, to days), each off at its
sentinel (NO_FILTER); None is no filter.

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
    B.LAUNCHES["pruned_tile"] += 1
    return out


# ---------------------------------------------------------------------------
# K6 span_stats
# ---------------------------------------------------------------------------

def span_stats_plain(feats16, docids, dead, extents, flags=None,
                     filt=None):
    """Plain PyTorch version of K6: stats int32[38] of the live rows that
    pass the filter."""
    q = filter_args(filt)
    _filter_flags(flags, q)
    ext = _check_extents(extents, feats16.shape[0])
    d, f = _rows(docids, ext), _rows(feats16, ext)
    v = live_rows(d, dead)
    if q != NO_FILTER:
        v &= constraint_valid(f, _rows(flags, ext) if q[1] != NO_FLAG
                              else None, q)
    st, _ = KC.cardinal_stats_plain(f, v, d, 0)
    return st


def span_stats(feats16, docids, dead, extents, flags=None, filt=None):
    """K6: the statistics (masked column min/max, tf min/max; host maximum
    0) of the live rows of up to 8 arena extents that pass the filter
    (`flags`, the arena's, read under a flag filter): int32[38]."""
    q = filter_args(filt)
    _filter_flags(flags, q)
    if feats16.device.type == "cpu":
        return span_stats_plain(feats16, docids, dead, extents, flags, q)
    dev = feats16.device
    cap = _require_arena(feats16, flags, docids, dead, dev)
    ext = _check_extents(extents, cap)
    # the statistics, then the kernel's accumulator and ticket
    out = torch.empty(2 * KC.STATS_LEN + 1, dtype=torch.int32, device=dev)
    ext_arg, filt_arg = _ext_arg(ext), _filt_arg(q)
    rc = B.library().yt_span_stats(
        feats16.data_ptr(), flags.data_ptr() if flags is not None else None,
        docids.data_ptr(), dead.data_ptr(), dead.shape[0],
        ctypes.addressof(ext_arg), len(ext), ctypes.addressof(filt_arg),
        out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "span_stats")
    B.LAUNCHES["span_stats"] += 1
    return out[:KC.STATS_LEN]


# ---------------------------------------------------------------------------
# K7 span_score
# ---------------------------------------------------------------------------

def span_score_plain(feats16, flags, docids, dead, extents, stats, consts,
                     out_len: int, filt=None):
    """Plain PyTorch version of K7 (scored in steps of 2^20 rows)."""
    q = filter_args(filt)
    dev = feats16.device
    ext = _check_extents(extents, feats16.shape[0])
    out = torch.full((out_len,), KC.SMALL, dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    pos = 0
    for s, c in ext:
        for lo in range(0, c, _PLAIN_ROWS):
            hi = min(c, lo + _PLAIN_ROWS)
            dd, f = docids[s + lo:s + hi], feats16[s + lo:s + hi]
            fl = flags[s + lo:s + hi]
            v = live_rows(dd, dead)
            if q != NO_FILTER:
                v &= constraint_valid(f, fl, q)
            out[pos + lo:pos + hi] = KC.cardinal_score_plain(
                f, fl, v, torch.zeros_like(dd), stats, zero, consts, True)
        pos += c
    return out


def span_score(feats16, flags, docids, dead, extents, stats, consts,
               out_len: int, filt=None):
    """K7: the rows of up to 8 arena extents scored against `stats`
    (int32[38]) in extent order, dead rows and rows the filter rejects
    -(2^31-1), into [out_len] int32 (out_len >= their rows; the rest
    -(2^31-1))."""
    q = filter_args(filt)
    rows = sum(int(c) for _s, c in extents)
    if out_len < rows:
        raise ValueError(f"out_len {out_len} < the extents' {rows} rows")
    if feats16.device.type == "cpu":
        return span_score_plain(feats16, flags, docids, dead, extents, stats,
                                consts, out_len, q)
    dev = feats16.device
    cap = _require_arena(feats16, flags, docids, dead, dev)
    ext = _check_extents(extents, cap)
    B.require(stats, "stats", (torch.int32,), 1, dev)
    B.require(consts, "consts", (torch.int32,), 1, dev)
    out = torch.empty(out_len, dtype=torch.int32, device=dev)
    ext_arg, filt_arg = _ext_arg(ext), _filt_arg(q)
    rc = B.library().yt_span_score(
        feats16.data_ptr(), flags.data_ptr(), docids.data_ptr(),
        dead.data_ptr(), dead.shape[0], ctypes.addressof(ext_arg), len(ext),
        ctypes.addressof(filt_arg), stats.data_ptr(), consts.data_ptr(),
        out.data_ptr(), out_len, B.stream_ptr(dev))
    B.check(rc, "span_score")
    B.LAUNCHES["span_score"] += 1
    return out


# ---------------------------------------------------------------------------
# topk_finish
# ---------------------------------------------------------------------------

def topk_finish_plain(top_s, top_rows, docids, extents, stats=None,
                      pmax=None, tail=None):
    """Plain PyTorch version of topk_finish."""
    dev = top_s.device
    kk = top_s.shape[0]
    r = top_rows.to(torch.int64)
    a = torch.full_like(r, -1)
    base = 0
    for s, c in extents:
        inside = (r >= base) & (r < base + c)
        a = torch.where(inside, s + r - base, a)
        base += c
    d = torch.where(a >= 0, docids[a.clamp(min=0)], -1)
    gone = top_s <= KC.SMALL
    s = torch.where(gone, KC.SMALL, top_s)
    d = torch.where(gone, -1, d).to(torch.int32)
    if stats is not None:
        return torch.cat([s, d, stats[:2 * P.NF + 2]])
    tstart, j0, tcount, shift, lang = tail
    theta = max(int(top_s[kk - 1]), KC.SMALL)
    ok = tail_ok_plain(pmax[tstart + j0:tstart + max(tcount, j0)], shift,
                       lang, theta)
    return torch.cat([s, d, torch.tensor([int(ok)], dtype=torch.int32,
                                         device=dev)])


def topk_finish(top_s, top_rows, docids, extents, stats=None, pmax=None,
                tail=None):
    """The kk winners of kernel 3 (scores, rows of a span_score buffer
    over `extents`) as scores and docids, (-(2^31-1), -1) wherever the
    score is -(2^31-1) or less; then either `stats[:36]` (the exact scan:
    [2kk + 36]) or the ok of the tail tiles [j0, tcount) of a span's pmax
    rows from tstart, `tail` = (tstart, j0, tcount, bound_shift,
    lang_term), against theta = max(kk-th score, -(2^31-1)): [2kk + 1]."""
    if (stats is None) == (tail is None):
        raise ValueError("topk_finish: give stats or tail, not both")
    if top_s.device.type == "cpu":
        return topk_finish_plain(top_s, top_rows, docids, extents, stats,
                                 pmax, tail)
    dev = top_s.device
    kk = top_s.shape[0]
    B.require(top_s, "top_s", (torch.int32,), 1, dev)
    B.require(top_rows, "top_rows", (torch.int32,), 1, dev)
    B.require(docids, "docids", (torch.int32,), 1, dev)
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
    rc = B.library().yt_topk_finish(
        top_s.data_ptr(), top_rows.data_ptr(), kk, docids.data_ptr(),
        ctypes.addressof(ext_arg), len(ext), pm.data_ptr(),
        tstart, j0, tcount, shift, lang,
        stats.data_ptr() if stats is not None else None, out.data_ptr(),
        B.stream_ptr(dev))
    B.check(rc, "topk_finish")
    B.LAUNCHES["topk_finish"] += 1
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
                 bmtab):
    """Membership of `docids` ([n] int32) in one partner: (found bool [n],
    the partner's arena row int64 [n], 0 where not found). slot >= 0: its
    docid bitmap (_membership_bitmap); -1: its docid-sorted segment
    jdocids[jstart:jstart + jcount], searched for clip(docid, 0, 2^29)."""
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
        found, row = _member_plain(d, js, jc, slot, jdocids, jpos, bmtab)
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
    the filter. Returns (merged int32 [count, 17]: the row with
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
    flat = [x for p in parts for x in p] or [0]
    parts_arg = (ctypes.c_int64 * len(flat))(*flat)
    filt_arg = _filt_arg(q)
    rc = B.library().yt_join_member(
        feats16.data_ptr(), flags.data_ptr(), docids.data_ptr(),
        dead.data_ptr(), dead.shape[0], start, count, jdocids.data_ptr(),
        jpos.data_ptr(), jdocids.shape[0], bmtab.data_ptr(), bmtab.shape[1],
        ctypes.addressof(parts_arg), n_inc, len(parts) - n_inc,
        ctypes.addressof(filt_arg), merged.data_ptr(), fo.data_ptr(),
        v.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "join_member")
    B.LAUNCHES["join_member"] += 1
    return merged, fo, v
