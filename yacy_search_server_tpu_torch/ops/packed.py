"""Bit-packed posting blocks: per-column minimal widths, decoded on the card.

The port's own copy of yacy_search_server_tpu/ops/packed.py (which
imports JAX): the block format, its host pack and unpack, the plain form
of the device decode, and the numpy oracle of the packed-decode scorers.

- At pack time every column of a block (the 17 compact feature columns,
  the int32 flags, the docids) gets the least bit width that spans its
  min..max range (floor 1) and is stored as value - column minimum.
- The values are laid down little-endian into one int32 word stream,
  each column's sub-stream starting on a word, a value free to straddle
  two words.
- The card decodes with shifts and masks over two words a value
  (kernels/csrc/common.cuh `unpack_value`, fused into the packed-decode
  scorers of kernels/packed.py); `unpack_rows_plain` is the same decode
  in PyTorch. The scoring downstream is the int16 path's, so a packed
  block answers bit for bit as its int16 rows do.

`pack_block` gives the same words, offsets, widths and minima as the
reference's (tests/test_torch_packed.py holds them word for word); it
folds each column's contributions with one OR-reduce over its word
indices, which are already in order, where the reference sorts them
first.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index import postings as P
from ..kernels import cardinal as KC

# packed column order: the NF compact feature columns, the int32 flags
# bitfield, the docids: NCOLS sub-streams a block
NCOLS = P.NF + 2
C_FLAGS = P.NF
C_DOCIDS = P.NF + 1

# meta vector (int32 [3 * NCOLS]): the columns' word offsets within the
# block, then their bit widths, then their minima
META_LEN = 3 * NCOLS


def col_width(vmin: int, vmax: int) -> int:
    """Least bits spanning vmin..vmax (floor 1: a constant column still
    packs one zero bit a row, which keeps the decode uniform)."""
    return max(1, int(int(vmax) - int(vmin)).bit_length())


@dataclass
class PackedBlock:
    """One bit-packed postings block (host form).

    words: the int32 word stream (all columns, each on a word)
    count: rows in the block
    word_offs/widths/mins: int32 [NCOLS] column geometry
    """

    words: np.ndarray
    count: int
    word_offs: np.ndarray
    widths: np.ndarray
    mins: np.ndarray

    def meta_vector(self) -> np.ndarray:
        """The decode descriptor the kernels take for the block."""
        return np.concatenate([self.word_offs, self.widths,
                               self.mins]).astype(np.int32)

    @property
    def row_bits(self) -> int:
        """Payload bits a row (word padding left out)."""
        return int(self.widths.sum())

    @property
    def packed_bytes(self) -> int:
        return int(self.words.nbytes)

    @property
    def int16_bytes(self) -> int:
        """The same rows in the int16 block format (features, flags,
        docids): the compression ratio's numerator."""
        return self.count * (P.NF * 2 + 4 + 4)

    @property
    def compression_ratio(self) -> float:
        return self.int16_bytes / max(self.packed_bytes, 1)


def _pack_column(vals: np.ndarray, w: int, nwords: int) -> np.ndarray:
    """Pack non-negative uint64 values of `w` bits into `nwords` int32
    words (little-endian bit order, straddling allowed). Row i starts at
    bit i * w, so the values' word indices are in order: one OR-reduce
    over each run of equal indices folds the values (low and high word
    parts at once, in 64 bits)."""
    n = len(vals)
    out = np.zeros(nwords, np.uint32)
    if n == 0:
        return out.view(np.int32)
    bit = np.arange(n, dtype=np.uint64) * np.uint64(w)
    wi = bit >> np.uint64(5)
    starts = np.flatnonzero(np.r_[True, wi[1:] != wi[:-1]])
    # < 2^63 before the fold: w <= 32, shift <= 31
    folded = np.bitwise_or.reduceat(vals << (bit & np.uint64(31)), starts)
    words = wi[starts].astype(np.int64)
    out[words] = folded.astype(np.uint32)
    # the high part of a straddling value lands in the next word; the
    # last value's may point one past the stream, where it is zero
    inside = words + 1 < nwords
    out[words[inside] + 1] |= (folded[inside] >> np.uint64(32)).astype(
        np.uint32)
    return out.view(np.int32)


def pack_block(feats16: np.ndarray, flags: np.ndarray,
               docids: np.ndarray) -> PackedBlock:
    """Bit-pack one compact block: the (feats16, flags, docids) triple
    the int16 arena stores, in the same row order."""
    n = len(docids)
    assert feats16.shape == (n, P.NF) and len(flags) == n
    cols = list(np.ascontiguousarray(feats16.T)) + [flags, docids]
    mins = np.zeros(NCOLS, np.int32)
    widths = np.zeros(NCOLS, np.int32)
    word_offs = np.zeros(NCOLS, np.int32)
    parts: list[np.ndarray] = []
    off = 0
    for c in range(NCOLS):
        v = cols[c].astype(np.int64)
        vmin = int(v.min()) if n else 0
        vmax = int(v.max()) if n else 0
        w = col_width(vmin, vmax)
        mins[c] = vmin
        widths[c] = w
        word_offs[c] = off
        nwords = (n * w + 31) // 32
        parts.append(_pack_column((v - vmin).astype(np.uint64), w, nwords))
        off += nwords
    return PackedBlock(words=np.concatenate(parts), count=n,
                       word_offs=word_offs, widths=widths, mins=mins)


def _unpack_column(words: np.ndarray, off: int, w: int, vmin: int,
                   n: int) -> np.ndarray:
    """The inverse of _pack_column (int64 values)."""
    wu = words.view(np.uint32)
    bit = np.arange(n, dtype=np.uint64) * np.uint64(w)
    wi = off + (bit >> np.uint64(5)).astype(np.int64)
    s = bit & np.uint64(31)
    lo = wu[wi].astype(np.uint64)
    hi = wu[np.minimum(wi + 1, len(wu) - 1)].astype(np.uint64)
    mask = (np.uint64(1) << np.uint64(w)) - np.uint64(1)
    val = ((lo | (hi << np.uint64(32))) >> s) & mask
    return val.astype(np.int64) + vmin


def unpack_block(pb: PackedBlock) -> tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """(feats16, flags, docids): the inverse of pack_block, and the numpy
    half of the packed-decode scorers' oracle."""
    n = pb.count

    def col(c):
        return _unpack_column(pb.words, int(pb.word_offs[c]),
                              int(pb.widths[c]), int(pb.mins[c]), n)

    f16 = np.zeros((n, P.NF), np.int16)
    for c in range(P.NF):
        f16[:, c] = col(c).astype(np.int16)
    return f16, col(C_FLAGS).astype(np.int32), col(C_DOCIDS).astype(np.int32)


def unpack_col_plain(words: torch.Tensor, wbase: int, meta, c: int,
                     i: torch.Tensor) -> torch.Tensor:
    """Column c at rows `i` (int64) of the packed block at word `wbase`
    of `words` (int32, the packed-words store) with meta vector `meta`:
    int32. The reference's unpack_rows_dev in int64 arithmetic: word
    indices clamp to the store, so a row past the block's count decodes
    garbage that a caller masks. (The reference's int32 bit index wraps
    past 2^31 bits, some 67M rows at 32 bits; this one does not.)"""
    nw = words.shape[0]
    off, w, vmin = (int(meta[c]), int(meta[NCOLS + c]),
                    int(meta[2 * NCOLS + c]))

    def word(j):
        return words[j.clamp(0, nw - 1)].to(torch.int64) & 0xFFFFFFFF

    bit = i * w
    wi = int(wbase) + off + (bit >> 5)
    mask = 0xFFFFFFFF if w >= 32 else (1 << max(w, 0)) - 1
    val = ((word(wi) | (word(wi + 1) << 32)) >> (bit & 31)) & mask
    return KC.wrap32(val + (vmin & 0xFFFFFFFF)).to(torch.int32)


def unpack_rows_plain(words: torch.Tensor, wbase: int, meta, row0: int,
                      rows: int):
    """The decode of `rows` rows from row `row0` of the packed block at
    word `wbase` (unpack_col_plain's): (feats int32 [rows, NF], flags
    int32 [rows], docids int32 [rows])."""
    m = [int(x) for x in meta]
    i = int(row0) + torch.arange(int(rows), dtype=torch.int64,
                                 device=words.device)
    cols = [unpack_col_plain(words, wbase, m, c, i) for c in range(NCOLS)]
    return torch.stack(cols[:P.NF], dim=1), cols[C_FLAGS], cols[C_DOCIDS]


def bp_topk_oracle(pb: PackedBlock, profile, language: str, k: int,
                   stats: dict | None = None,
                   lang_filter: int | None = None,
                   flag_bit: int | None = None,
                   from_days: int | None = None,
                   to_days: int | None = None):
    """The packed-decode scorers' reference answer: the block unpacked on
    the host, scored by the host twin (ops/ranking.
    cardinal_from_stats_host), the constraint mask applied, and the top
    k by score descending, then block row order. `stats=None` takes the
    statistics over the (masked) block as the exact scan does; the frozen
    pack statistics give the pruned path's score domain."""
    from .ranking import cardinal_from_stats_host, pack_stats_host
    f16, fl, dd = unpack_block(pb)
    n = pb.count
    keep = np.ones(n, bool)
    if lang_filter is not None and lang_filter != 0:
        keep &= f16[:, P.F_LANGUAGE].astype(np.int32) == lang_filter
    if flag_bit is not None and flag_bit >= 0:
        keep &= ((fl >> flag_bit) & 1) == 1
    if from_days is not None:
        keep &= f16[:, P.F_LASTMOD].astype(np.int32) >= from_days
    if to_days is not None:
        keep &= f16[:, P.F_LASTMOD].astype(np.int32) <= to_days
    if stats is None:
        if not keep.any():
            return (np.empty(0, np.int64), np.empty(0, np.int32))
        stats = pack_stats_host(f16[keep], fl[keep])
    s = cardinal_from_stats_host(f16, fl, stats, profile,
                                 P.pack_language(language))
    s = np.where(keep, s, np.int64(-(2 ** 63 - 1)))
    order = np.argsort(-s, kind="stable")[:k]
    order = order[keep[order]]
    return s[order], dd[order]


# reference kernel -> (its oracle, the contract): every packed-decode
# scorer has a numpy anchor
BP_ORACLES: dict[str, tuple] = {
    "_rank_pruned_batch1_bp_kernel": (
        bp_topk_oracle,
        "frozen pack stats + first-tile prefix; the tail bound walk is "
        "verified by the int16 twin's proof (same pmax side-table)"),
    "_rank_scan_batch_bp_kernel": (
        bp_topk_oracle,
        "exact two-pass scan semantics: stats over the constraint-masked "
        "rows, then score + top-k, identical to _rank_scan_batch_kernel"),
}
