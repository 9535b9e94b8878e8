"""The packed-residency kernels: K12 `unpack_rows`, K5bp `pruned_tile_bp`,
K6bp `span_stats_bp`, K7bp `span_topk_bp` and `span_score_bp`,
`topk_finish_bp` and K13 `pack_block_batch`.

They read the packed-words store of index/devstore.DeviceArena: int32
[nw] holding every resident block's word stream (ops/packed.py), a block
addressed by its first word (`wbase`) and its meta vector (META_LEN
int32: column word offsets, widths, minima); beside it the tombstone
bitmap `dead` bool [doc_cap] and the per-tile bound rows `pmax` int32.

- `unpack_rows` (csrc/packed.cu) is ops/packed.unpack_rows_dev
  (packed.py:205) standalone: `rows` rows from `row0` as int32 feats
  [rows, 17], flags and docids. The scorers fuse the same decode
  (csrc/common.cuh unpack_value).
- `pruned_tile_bp` (csrc/pruned_tile.cu, K5's cluster kernel on the
  packed row source) replaces _rank_pruned_batch1_bp_kernel
  (devstore.py:1151): per slot the first TILE rows decoded (each CTA's
  four 512-row tiles staged at once) and scored against the frozen
  statistics, the kk best by
  (score descending, row ascending) with their docids decoded, and the
  pmax tail check; [bs, 2kk + 1]. One launch of up to BP_SLOTS slots.
- `span_stats_bp` (csrc/cardinal_stats.cu) and `span_topk_bp`
  (csrc/cardinal_score.cu) replace _rank_scan_batch_bp_kernel
  (devstore.py:1213) for one span: statistics over the live rows that
  pass the filter, then their scores with the kk best kept in the pass
  and their docids decoded. Both stream the span's tiles through shared
  memory and decode there (csrc/common.cuh bp_run). Past KD.FUSED_KK,
  `span_score_bp` writes a score a row, kernel 3 `tie_topk` (index mode)
  ranks them and `topk_finish_bp` (csrc/pruned_tile.cu) decodes the
  winners' docids.
- `pack_block_batch` (csrc/packed.cu) replaces ingest/devbuild.
  _pack_block_batch_kernel (devbuild.py:71): B blocks bit-packed at once,
  each equal word for word to ops/packed.pack_block.

Each wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version only for CPU tensors. A slot descriptor is numpy int32
(`pack_desc_bp`: K5's fused layout with the word base as the start, then
each slot's meta vector).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..index import postings as P
from ..ops.packed import (C_DOCIDS, META_LEN, NCOLS, unpack_col_plain,
                          unpack_rows_plain)
from . import build as B
from . import cardinal as KC
from . import devstore as KD
from .topk import tie_topk_plain

TILE = KD.TILE
_PLAIN_ROWS = 1 << 20            # rows a plain decode step holds
BP_SLOT_WORDS = KD.DESC_SLOT_WORDS + META_LEN
BP_SLOTS = 8                     # K5bp slots a launch (by value)


def pack_desc_bp(slots, metas, bound_shift: int, lang_term: int):
    """The packed descriptor of `slots`, each (wbase, count, tstart,
    tcount, col_min int32[17], col_max int32[17], tf_min f32, tf_max
    f32), and their meta vectors `metas` [bs][META_LEN]."""
    return np.concatenate([
        KD.pack_desc(slots, bound_shift, lang_term),
        np.asarray(metas, np.int32).reshape(-1)]).astype(np.int32)


def desc_slots_bp(desc: np.ndarray) -> int:
    """The slots of a packed descriptor (2 + 97 bs words)."""
    bs, rem = divmod(len(desc) - 2, BP_SLOT_WORDS)
    if bs < 1 or rem:
        raise ValueError(f"descriptor of {len(desc)} words is not 2 + "
                         f"{BP_SLOT_WORDS} a slot")
    return bs


def _meta_arg(meta):
    m = np.ascontiguousarray(np.asarray(meta, np.int32).reshape(-1))
    if m.shape[0] != META_LEN:
        raise ValueError(f"meta: {m.shape[0]} ints, expected {META_LEN}")
    return m


def _require_words(words, dead, dev):
    B.require(words, "words", (torch.int32,), 1, dev)
    if words.shape[0] < 1:
        raise ValueError("words: an empty store")
    if dead is not None:
        B.require(dead, "dead", (torch.bool,), 1, dev)


def _check_block(words, wbase: int, count: int):
    if wbase < 0 or wbase >= words.shape[0] or count < 0:
        raise ValueError(f"block at word {wbase} of {count} rows outside "
                         f"the store's {words.shape[0]} words")


# ---------------------------------------------------------------------------
# K12 unpack_rows
# ---------------------------------------------------------------------------

def unpack_rows(words, wbase: int, meta, row0: int, rows: int):
    """K12: `rows` rows from row `row0` of the block at word `wbase` of
    `words` with meta vector `meta`: (feats int32 [rows, 17], flags int32
    [rows], docids int32 [rows]). Rows past the block's count decode
    garbage, as in the reference."""
    wbase, row0, rows = int(wbase), int(row0), int(rows)
    m = _meta_arg(meta)
    if words.device.type == "cpu":
        return unpack_rows_plain(words, wbase, m, row0, rows)
    dev = words.device
    _require_words(words, None, dev)
    _check_block(words, wbase, rows)
    if row0 < 0:
        raise ValueError(f"row0 {row0} < 0")
    f = torch.empty((rows, P.NF), dtype=torch.int32, device=dev)
    fl = torch.empty(rows, dtype=torch.int32, device=dev)
    d = torch.empty(rows, dtype=torch.int32, device=dev)
    rc = B.library().yt_unpack_rows(
        words.data_ptr(), words.shape[0], wbase, m.ctypes.data, row0, rows,
        f.data_ptr(), fl.data_ptr(), d.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "unpack_rows")
    B.count_launch("unpack_rows")
    return f, fl, d


# ---------------------------------------------------------------------------
# K5bp pruned_tile_bp
# ---------------------------------------------------------------------------

def _bp_slot(desc: np.ndarray, bs: int, i: int):
    """(wbase, count, tstart, tcount, stats int32[38], meta) of slot i."""
    fused = desc[:2 + KD.DESC_SLOT_WORDS * bs]
    wbase, count, tstart, tcount, st = KD._slot(fused, bs, i)
    m0 = 2 + KD.DESC_SLOT_WORDS * bs + i * META_LEN
    return wbase, count, tstart, tcount, st, desc[m0:m0 + META_LEN]


def pruned_tile_bp_plain(words, dead, pmax, desc, kk: int, consts):
    """Plain PyTorch version of K5bp: [bs, 2kk + 1] int32."""
    dev = words.device
    bs = desc_slots_bp(desc)
    shift, lang = int(desc[0]), int(desc[1])
    out = torch.empty((bs, 2 * kk + 1), dtype=torch.int32, device=dev)
    rows = torch.arange(TILE, device=dev)
    for i in range(bs):
        wbase, count, tstart, tcount, st, meta = _bp_slot(desc, bs, i)
        f, fl, dd = unpack_rows_plain(words, wbase, meta, 0, TILE)
        v = (rows < count) & KD.live_rows(dd, dead)
        sc = KC.cardinal_score_plain(
            f, fl, v, torch.zeros(TILE, dtype=torch.int32, device=dev),
            torch.from_numpy(st).to(dev),
            torch.zeros(1, dtype=torch.int32, device=dev), consts, True)
        s, _, idx = tie_topk_plain(sc, kk)
        ok = KD.tail_ok_plain(pmax[tstart + 1:tstart + max(tcount, 1)],
                              shift, lang, int(s[kk - 1]))
        out[i, :kk], out[i, kk:2 * kk] = s, dd[idx.long()]
        out[i, 2 * kk] = int(ok)
    return out


def pruned_tile_bp(words, dead, pmax, desc, kk: int, consts):
    """K5bp: the b = 1 pruned query of each slot of `desc` (pack_desc_bp)
    over the packed-words store, in the batched kernel's form (no init
    entries: a place past the valid rows keeps its garbage docid under
    the score -(2^31-1)); kk a power of two in [16, 2048]. Returns [bs,
    2kk + 1] int32: scores, docids, ok."""
    KD._check_kk(kk)
    desc = np.ascontiguousarray(desc, np.int32)
    bs = desc_slots_bp(desc)
    for i in range(bs):
        wbase, count, tstart, tcount, _st, _m = _bp_slot(desc, bs, i)
        _check_block(words, wbase, count)
        if tstart < 0 or tcount < 0 or tstart + tcount > pmax.shape[0]:
            raise ValueError("a slot's pmax rows lie outside the side-table")
    if words.device.type == "cpu":
        return pruned_tile_bp_plain(words, dead, pmax, desc, kk, consts)
    dev = words.device
    _require_words(words, dead, dev)
    B.require(pmax, "pmax", (torch.int32,), 1, dev)
    B.require(consts, "consts", (torch.int32,), 1, dev)
    out = torch.empty((bs, 2 * kk + 1), dtype=torch.int32, device=dev)
    rc = B.library().yt_pruned_tile_bp(
        words.data_ptr(), words.shape[0], dead.data_ptr(), dead.shape[0],
        pmax.data_ptr(), desc.ctypes.data, bs, kk, consts.data_ptr(),
        out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "pruned_tile_bp")
    KD.count_slot_launches("pruned_tile_bp", desc[2 + bs:2 + 2 * bs],
                           BP_SLOTS)
    return out


# ---------------------------------------------------------------------------
# K6bp span_stats_bp, K7bp span_score_bp and span_topk_bp
# ---------------------------------------------------------------------------

def _decoded_steps(words, dead, wbase, meta, count, filt):
    """(first row, feats, flags, docids, valid) of the span's rows in
    steps of _PLAIN_ROWS: valid = live and passing the filter."""
    q = KD.filter_args(filt)
    for lo in range(0, count, _PLAIN_ROWS):
        n = min(_PLAIN_ROWS, count - lo)
        f, fl, d = unpack_rows_plain(words, wbase, meta, lo, n)
        v = KD.live_rows(d, dead)
        if q != KD.NO_FILTER:
            v &= KD.constraint_valid(f, fl, q)
        yield lo, f, fl, d, v


def span_stats_bp_plain(words, dead, wbase: int, meta, count: int,
                        filt=None):
    """Plain PyTorch version of K6bp: stats int32[38]."""
    parts = list(_decoded_steps(words, dead, wbase, meta, count, filt))
    if not parts:
        empty = torch.zeros((0, P.NF), dtype=torch.int32, device=words.device)
        return KC.cardinal_stats_plain(
            empty, torch.zeros(0, dtype=torch.bool, device=words.device),
            None, 0)[0]
    f = torch.cat([p[1] for p in parts])
    v = torch.cat([p[4] for p in parts])
    return KC.cardinal_stats_plain(f, v, None, 0)[0]


def span_stats_bp(words, dead, wbase: int, meta, count: int, filt=None):
    """K6bp: the statistics (masked column min/max, tf min/max; host
    maximum 0) of the live rows of the packed span of `count` rows at
    word `wbase` (meta vector `meta`) that pass the filter: int32[38]."""
    wbase, count = int(wbase), int(count)
    m = _meta_arg(meta)
    q = KD.filter_args(filt)
    _check_block(words, wbase, count)
    if words.device.type == "cpu":
        return span_stats_bp_plain(words, dead, wbase, m, count, q)
    dev = words.device
    _require_words(words, dead, dev)
    out = torch.empty(2 * KC.STATS_LEN + 1, dtype=torch.int32, device=dev)
    filt_arg = KD._filt_arg(q)
    rc = B.library().yt_span_stats_bp(
        words.data_ptr(), words.shape[0], wbase, m.ctypes.data, count,
        dead.data_ptr(), dead.shape[0], ctypes.addressof(filt_arg),
        out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "span_stats_bp")
    B.count_launch("span_stats_bp")
    return out[:KC.STATS_LEN]


def span_score_bp_plain(words, dead, wbase: int, meta, count: int, stats,
                        consts, out_len: int, filt=None):
    """Plain PyTorch version of K7bp."""
    dev = words.device
    out = torch.full((out_len,), KC.SMALL, dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    for lo, f, fl, d, v in _decoded_steps(words, dead, wbase, meta, count,
                                          filt):
        out[lo:lo + d.shape[0]] = KC.cardinal_score_plain(
            f, fl, v, torch.zeros_like(d), stats, zero, consts, True)
    return out


def span_score_bp(words, dead, wbase: int, meta, count: int, stats, consts,
                  out_len: int, filt=None):
    """K7bp: the rows of the packed span of `count` rows at word `wbase`
    scored against `stats` (int32[38]) in row order, dead rows and rows
    the filter rejects -(2^31-1), into [out_len] int32 (out_len >= count;
    the rest -(2^31-1))."""
    wbase, count, out_len = int(wbase), int(count), int(out_len)
    m = _meta_arg(meta)
    q = KD.filter_args(filt)
    _check_block(words, wbase, count)
    if out_len < count:
        raise ValueError(f"out_len {out_len} < the span's {count} rows")
    if words.device.type == "cpu":
        return span_score_bp_plain(words, dead, wbase, m, count, stats,
                                   consts, out_len, q)
    dev = words.device
    _require_words(words, dead, dev)
    B.require(stats, "stats", (torch.int32,), 1, dev)
    B.require(consts, "consts", (torch.int32,), 1, dev)
    out = torch.empty(out_len, dtype=torch.int32, device=dev)
    filt_arg = KD._filt_arg(q)
    rc = B.library().yt_span_score_bp(
        words.data_ptr(), words.shape[0], wbase, m.ctypes.data, count,
        dead.data_ptr(), dead.shape[0], ctypes.addressof(filt_arg),
        stats.data_ptr(), consts.data_ptr(), out.data_ptr(), out_len,
        B.stream_ptr(dev))
    B.check(rc, "span_score_bp")
    B.count_launch("span_score_bp")
    return out


def span_topk_bp_plain(words, dead, wbase: int, meta, count: int, stats,
                       consts, kk: int, filt=None):
    """Plain PyTorch version of K7bp with its selection: K7bp's, kernel
    3's (index mode) and topk_finish_bp's: [2kk]."""
    buf = span_score_bp_plain(words, dead, wbase, meta, count, stats,
                              consts, max(count, kk), filt)
    top_s, top_rows, _ = tie_topk_plain(buf, kk)
    return topk_finish_bp_plain(top_s, top_rows, words, wbase, meta, count)


def span_topk_bp(words, dead, wbase: int, meta, count: int, stats, consts,
                 kk: int, filt=None):
    """K7bp with its selection: the rows of the packed span of `count`
    rows at word `wbase` scored against `stats` (int32[38]) under the
    filter, and its kk best (score descending, then row ascending: the
    JAX merge's order) as scores and docids, (-(2^31-1), -1) where fewer
    than kk rows are live and pass: [2kk] int32, _rank_scan_batch_bp_
    kernel's row; 1 <= kk <= KD.FUSED_KK. One launch."""
    wbase, count, kk = int(wbase), int(count), int(kk)
    if not 1 <= kk <= KD.FUSED_KK:
        raise ValueError(f"kk={kk} outside [1, {KD.FUSED_KK}]")
    m = _meta_arg(meta)
    q = KD.filter_args(filt)
    _check_block(words, wbase, count)
    if words.device.type == "cpu":
        return span_topk_bp_plain(words, dead, wbase, m, count, stats,
                                  consts, kk, q)
    dev = words.device
    _require_words(words, dead, dev)
    B.require(stats, "stats", (torch.int32,), 1, dev)
    B.require(consts, "consts", (torch.int32,), 1, dev)
    lib = B.library()
    # the scratch and ticket words for as many blocks as the card holds
    plan = (ctypes.c_int64 * 2)()
    filt_arg = KD._filt_arg(q)
    out = torch.empty(2 * kk, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        B.check(lib.yt_span_topk_bp_plan(kk, plan), "span_topk_bp")
        scratch = torch.empty(int(plan[0]), dtype=torch.uint8, device=dev)
        stream = B.stream_ptr(dev)
        tickets = KD._join_counters(dev, stream, "span_topk_bp",
                                    int(plan[1]))
        rc = lib.yt_span_topk_bp(
            words.data_ptr(), words.shape[0], wbase, m.ctypes.data, count,
            dead.data_ptr(), dead.shape[0], ctypes.addressof(filt_arg),
            stats.data_ptr(), consts.data_ptr(), kk, scratch.data_ptr(),
            scratch.numel(), tickets.data_ptr(), tickets.numel(),
            out.data_ptr(), stream)
    B.check(rc, "span_topk_bp")
    B.count_launch("span_topk_bp")
    return out


# ---------------------------------------------------------------------------
# topk_finish_bp
# ---------------------------------------------------------------------------

def topk_finish_bp_plain(top_s, top_rows, words, wbase: int, meta,
                         count: int, pmax=None, tail=None):
    """Plain PyTorch version of topk_finish_bp."""
    dev = top_s.device
    kk = top_s.shape[0]
    r = top_rows.to(torch.int64)
    gone = (top_s <= KC.SMALL) | (r < 0) | (r >= count)
    d = unpack_col_plain(words, wbase, meta, C_DOCIDS,
                         r.clamp(0, max(count - 1, 0)))
    s = torch.where(gone, KC.SMALL, top_s).to(torch.int32)
    d = torch.where(gone, -1, d).to(torch.int32)
    if tail is None:
        return torch.cat([s, d])
    tstart, tcount, shift, lang = tail
    theta = max(int(top_s[kk - 1]), KC.SMALL)
    ok = KD.tail_ok_plain(pmax[tstart + 1:tstart + max(tcount, 1)], shift,
                          lang, theta)
    return torch.cat([s, d, torch.tensor([int(ok)], dtype=torch.int32,
                                         device=dev)])


def topk_finish_bp(top_s, top_rows, words, wbase: int, meta, count: int,
                   pmax=None, tail=None):
    """The kk winners of kernel 3 (scores, rows of a span_score_bp buffer
    over the packed span of `count` rows at word `wbase`) as scores and
    decoded docids, (-(2^31-1), -1) wherever the score is -(2^31-1) or
    less or the row is past the count: [2kk]; with `tail` = (tstart,
    tcount, bound_shift, lang_term), then the ok of the tail tiles [1,
    tcount) of the span's pmax rows from tstart against theta = max(kk-th
    score, -(2^31-1)): [2kk + 1]."""
    wbase, count = int(wbase), int(count)
    m = _meta_arg(meta)
    _check_block(words, wbase, count)
    if tail is not None:
        tstart, tcount = int(tail[0]), int(tail[1])
        if tstart < 0 or tcount < 0 or tstart + tcount > pmax.shape[0]:
            raise ValueError("tail rows outside the pmax side-table")
    if top_s.device.type == "cpu":
        return topk_finish_bp_plain(top_s, top_rows, words, wbase, m, count,
                                    pmax, tail)
    dev = top_s.device
    kk = top_s.shape[0]
    B.require(top_s, "top_s", (torch.int32,), 1, dev)
    B.require(top_rows, "top_rows", (torch.int32,), 1, dev)
    _require_words(words, None, dev)
    if top_rows.shape[0] != kk:
        raise ValueError("top_s and top_rows must have kk entries")
    if tail is None:
        tstart, tcount, shift, lang = -1, 0, 0, 0
        pm = words       # not read
        out = torch.empty(2 * kk, dtype=torch.int32, device=dev)
    else:
        tstart, tcount, shift, lang = (int(v) for v in tail)
        B.require(pmax, "pmax", (torch.int32,), 1, dev)
        pm = pmax
        out = torch.empty(2 * kk + 1, dtype=torch.int32, device=dev)
    rc = B.library().yt_topk_finish_bp(
        top_s.data_ptr(), top_rows.data_ptr(), kk, words.data_ptr(),
        words.shape[0], wbase, m.ctypes.data, count, pm.data_ptr(), tstart,
        tcount, shift, lang, out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "topk_finish_bp")
    B.count_launch("topk_finish_bp")
    return out


# ---------------------------------------------------------------------------
# K13 pack_block_batch
# ---------------------------------------------------------------------------

def pack_block_batch_plain(f16, fl, dd, n):
    """Plain PyTorch version of K13: (words int32 [B, rows * NCOLS], meta
    int32 [B, META_LEN], totals int32 [B]); the lay-down is the
    reference's scatter-add (distinct values own disjoint bits)."""
    dev = f16.device
    nb, rows = f16.shape[0], f16.shape[1]
    words = torch.zeros((nb, rows * NCOLS), dtype=torch.int64, device=dev)
    meta = torch.zeros((nb, META_LEN), dtype=torch.int32, device=dev)
    totals = torch.zeros(nb, dtype=torch.int32, device=dev)
    for b in range(nb):
        m = int(n[b])
        off = 0
        cols = ([f16[b, :m, c] for c in range(P.NF)]
                + [fl[b, :m], dd[b, :m]])
        for c, v in enumerate(x.to(torch.int64) for x in cols):
            vmin = int(v.min()) if m else 0
            vmax = int(v.max()) if m else 0
            w = max(1, ((vmax - vmin) & 0xFFFFFFFF).bit_length())
            meta[b, c], meta[b, NCOLS + c], meta[b, 2 * NCOLS + c] = \
                off, w, vmin
            if m:
                bit = torch.arange(m, dtype=torch.int64, device=dev) * w
                shifted = ((v - vmin) & 0xFFFFFFFF) << (bit & 31)
                wi = off + (bit >> 5)
                acc = torch.zeros(rows * NCOLS + 1, dtype=torch.int64,
                                  device=dev)
                acc.index_add_(0, wi, shifted & 0xFFFFFFFF)
                acc.index_add_(0, wi + 1, shifted >> 32)
                words[b] += acc[:rows * NCOLS]
            off += (m * w + 31) >> 5
        totals[b] = off
    return KC.wrap32(words).to(torch.int32), meta, totals


def pack_block_batch(f16, fl, dd, n):
    """K13: bit-pack B blocks at once. f16 int16 [B, rows, 17], fl and dd
    int32 [B, rows] (lane b's first n[b] rows are its block, in order), n
    int32 [B]. Returns (words int32 [B, rows * NCOLS], meta int32 [B,
    META_LEN], totals int32 [B]): words[b, :totals[b]] and meta[b] are
    ops/packed.pack_block of lane b's rows; the words past totals[b] are
    zero."""
    if f16.dim() != 3 or f16.shape[2] != P.NF:
        raise ValueError(f"f16: {tuple(f16.shape)}, expected [B, rows, 17]")
    nb, rows = f16.shape[0], f16.shape[1]
    for name, t in (("fl", fl), ("dd", dd)):
        if tuple(t.shape) != (nb, rows):
            raise ValueError(f"{name}: {tuple(t.shape)}, expected "
                             f"{(nb, rows)}")
    if tuple(n.shape) != (nb,):
        raise ValueError(f"n: {tuple(n.shape)}, expected ({nb},)")
    if nb and (int(n.min()) < 0 or int(n.max()) > rows):
        raise ValueError("n: a lane's rows outside [0, rows]")
    if f16.device.type == "cpu":
        return pack_block_batch_plain(f16, fl, dd, n)
    dev = f16.device
    B.require(f16, "f16", (torch.int16,), 3, dev)
    B.require(fl, "fl", (torch.int32,), 2, dev)
    B.require(dd, "dd", (torch.int32,), 2, dev)
    B.require(n, "n", (torch.int32,), 1, dev)
    if not 1 <= nb <= 65535 or rows < 1:
        raise ValueError(f"{nb} lanes of {rows} rows")
    scratch = torch.empty((nb, NCOLS, 2), dtype=torch.int32, device=dev)
    words = torch.empty((nb, rows * NCOLS), dtype=torch.int32, device=dev)
    meta = torch.empty((nb, META_LEN), dtype=torch.int32, device=dev)
    totals = torch.empty(nb, dtype=torch.int32, device=dev)
    rc = B.library().yt_pack_block_batch(
        f16.data_ptr(), fl.data_ptr(), dd.data_ptr(), n.data_ptr(), nb, rows,
        scratch.data_ptr(), words.data_ptr(), meta.data_ptr(),
        totals.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "pack_block_batch")
    B.count_launch("pack_block_batch", slots=nb)
    return words, meta, totals
