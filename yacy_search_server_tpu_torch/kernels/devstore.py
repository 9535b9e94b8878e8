"""The devstore's kernels: K5 `pruned_tile`, K6 `span_stats`, K7
`span_score`, and `topk_finish`.

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

def span_stats_plain(feats16, docids, dead, extents):
    """Plain PyTorch version of K6: stats int32[38] of the live rows."""
    ext = _check_extents(extents, feats16.shape[0])
    d = _rows(docids, ext)
    st, _ = KC.cardinal_stats_plain(_rows(feats16, ext), live_rows(d, dead),
                                    d, 0)
    return st


def span_stats(feats16, docids, dead, extents):
    """K6: the statistics (masked column min/max, tf min/max; host maximum
    0) of the live rows of up to 8 arena extents: int32[38]."""
    if feats16.device.type == "cpu":
        return span_stats_plain(feats16, docids, dead, extents)
    dev = feats16.device
    cap = _require_arena(feats16, None, docids, dead, dev)
    ext = _check_extents(extents, cap)
    # the statistics, then the kernel's accumulator and ticket
    out = torch.empty(2 * KC.STATS_LEN + 1, dtype=torch.int32, device=dev)
    ext_arg = _ext_arg(ext)
    rc = B.library().yt_span_stats(
        feats16.data_ptr(), docids.data_ptr(), dead.data_ptr(),
        dead.shape[0], ctypes.addressof(ext_arg), len(ext), out.data_ptr(),
        B.stream_ptr(dev))
    B.check(rc, "span_stats")
    B.LAUNCHES["span_stats"] += 1
    return out[:KC.STATS_LEN]


# ---------------------------------------------------------------------------
# K7 span_score
# ---------------------------------------------------------------------------

def span_score_plain(feats16, flags, docids, dead, extents, stats, consts,
                     out_len: int):
    """Plain PyTorch version of K7 (scored in steps of 2^20 rows)."""
    dev = feats16.device
    ext = _check_extents(extents, feats16.shape[0])
    out = torch.full((out_len,), KC.SMALL, dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    pos = 0
    for s, c in ext:
        for lo in range(0, c, _PLAIN_ROWS):
            hi = min(c, lo + _PLAIN_ROWS)
            dd = docids[s + lo:s + hi]
            out[pos + lo:pos + hi] = KC.cardinal_score_plain(
                feats16[s + lo:s + hi], flags[s + lo:s + hi],
                live_rows(dd, dead), torch.zeros_like(dd), stats, zero,
                consts, True)
        pos += c
    return out


def span_score(feats16, flags, docids, dead, extents, stats, consts,
               out_len: int):
    """K7: the rows of up to 8 arena extents scored against `stats`
    (int32[38]) in extent order, dead rows -(2^31-1), into [out_len]
    int32 (out_len >= their rows; the rest -(2^31-1))."""
    rows = sum(int(c) for _s, c in extents)
    if out_len < rows:
        raise ValueError(f"out_len {out_len} < the extents' {rows} rows")
    if feats16.device.type == "cpu":
        return span_score_plain(feats16, flags, docids, dead, extents, stats,
                                consts, out_len)
    dev = feats16.device
    cap = _require_arena(feats16, flags, docids, dead, dev)
    ext = _check_extents(extents, cap)
    B.require(stats, "stats", (torch.int32,), 1, dev)
    B.require(consts, "consts", (torch.int32,), 1, dev)
    out = torch.empty(out_len, dtype=torch.int32, device=dev)
    ext_arg = _ext_arg(ext)
    rc = B.library().yt_span_score(
        feats16.data_ptr(), flags.data_ptr(), docids.data_ptr(),
        dead.data_ptr(), dead.shape[0], ctypes.addressof(ext_arg), len(ext),
        stats.data_ptr(), consts.data_ptr(), out.data_ptr(), out_len,
        B.stream_ptr(dev))
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
