"""Kernels 1 and 2: cardinal statistics and cardinal scores.

`cardinal_stats` replaces ops/ranking.local_stats of the JAX package and
`cardinal_score` replaces ops/ranking.cardinal_from_stats (sources
csrc/cardinal_stats.cu and csrc/cardinal_score.cu). Each wrapper launches
its CUDA kernel for tensors on a CUDA device and takes its plain PyTorch
version only for tensors on the CPU.

Packed layouts shared with csrc/common.cuh:

    consts int32[44]: [0,17) norm coeffs, [17,28) flag bits,
        [28,39) flag shifts, 39 domlength, 40 tf, 41 language,
        42 authority, 43 language preference
    stats  int32[38]: [0,17) col_min, [17,34) col_max, 34 tf_min (f32
        bits), 35 tf_max (f32 bits), 36 max host count, 37 NaN-seen flag

The plain versions reproduce XLA's int32 arithmetic in int64 with an
explicit wrap to 32 bits wherever the JAX code's int32 values wrap.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index import postings as P
from . import build as B

C_NORM, C_BITS, C_SHIFTS = 0, 17, 28
C_DOMLENGTH, C_TF, C_LANGUAGE, C_AUTHORITY, C_LANG_PREF = 39, 40, 41, 42, 43
CONSTS_LEN = 44
S_COL_MIN, S_COL_MAX, S_TF_MIN, S_TF_MAX, S_HOST_MAX, S_NAN = \
    0, 17, 34, 35, 36, 37
STATS_LEN = 38

BIG = 2**31 - 1
SMALL = -(2**31 - 1)

_INACTIVE = [P.F_FLAGS, P.F_DOCTYPE, P.F_LANGUAGE, P.F_DOMLENGTH]
ACTIVE = ~np.isin(np.arange(P.NF), _INACTIVE)
DIRECT = np.isin(np.arange(P.NF), [
    P.F_LASTMOD, P.F_WORDS_IN_TITLE, P.F_WORDS_IN_TEXT, P.F_PHRASES_IN_TEXT,
    P.F_LLOCAL, P.F_LOTHER, P.F_HITCOUNT])

_FEAT_DTYPES = (torch.int16, torch.int32)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value two's-complement wrapping gives (int64)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def shl(x: torch.Tensor, s) -> torch.Tensor:
    """XLA shift left on int32 values held in int64: amounts outside
    [0, 32) give 0; the result is wrapped to int32."""
    s = torch.as_tensor(s, dtype=torch.int64, device=x.device)
    out = x << s.clamp(0, 31)
    return wrap32(torch.where((s < 0) | (s >= 32), torch.zeros_like(out), out))


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 -> int32 conversion: truncate, saturate, NaN -> 0
    (int64 result)."""
    t = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return t.clamp(-2.0**31, 2.0**31 - 1).trunc().to(torch.int64)


def term_frequency(feats: torch.Tensor) -> torch.Tensor:
    """hitcount / (wordsintext + wordsintitle + 1) in f32."""
    den = (feats[:, P.F_WORDS_IN_TEXT].to(torch.int32)
           + feats[:, P.F_WORDS_IN_TITLE].to(torch.int32) + 1)
    return feats[:, P.F_HITCOUNT].to(torch.float32) / den.to(torch.float32)


# ---------------------------------------------------------------------------
# kernel 1: cardinal_stats
# ---------------------------------------------------------------------------

def cardinal_stats_plain(feats, valid, hostids, num_hosts: int):
    """Plain PyTorch version of kernel 1: (stats int32[38], host counts
    int32[max(num_hosts, 1)]); num_hosts == 0 skips the host counts."""
    dev = feats.device
    f = feats.to(torch.int32)
    v = valid.to(torch.bool)
    if f.shape[0]:
        col_min = torch.where(v[:, None], f, BIG).amin(0)
        col_max = torch.where(v[:, None], f, SMALL).amax(0)
    else:
        col_min = torch.full((P.NF,), BIG, dtype=torch.int32, device=dev)
        col_max = torch.full((P.NF,), SMALL, dtype=torch.int32, device=dev)
    tf = term_frequency(f)
    inf = torch.tensor(float("inf"), device=dev)
    tf_min = torch.where(v, tf, inf).amin() if f.shape[0] else inf
    tf_max = torch.where(v, tf, -inf).amax() if f.shape[0] else -inf
    nan = bool(torch.isnan(tf[v]).any())
    counts = torch.zeros(max(num_hosts, 1), dtype=torch.int32, device=dev)
    if num_hosts > 0:
        h = hostids.to(torch.int64)
        keep = v & (h >= 0) & (h < num_hosts)
        counts = torch.bincount(h[keep], minlength=num_hosts).to(torch.int32)
    host_max = counts.max() if num_hosts > 0 else torch.zeros(
        (), dtype=torch.int32, device=dev)
    tail = torch.stack([
        tf_min.to(torch.float32).view(torch.int32),
        tf_max.to(torch.float32).view(torch.int32),
        host_max.to(torch.int32),
        torch.tensor(int(nan), dtype=torch.int32, device=dev)])
    return torch.cat([col_min.to(torch.int32), col_max.to(torch.int32),
                      tail]), counts


def cardinal_stats(feats, valid, hostids, num_hosts: int):
    """Kernel 1: normalisation statistics of a postings block.

    feats [n, 17] int16 or int32, valid [n] bool, hostids [n] int32
    (None when num_hosts is 0: not read); num_hosts bins for the per-host
    valid counts (0: not counted).
    Returns (stats int32[38], counts int32[max(num_hosts, 1)])."""
    if hostids is None and num_hosts > 0:
        raise ValueError("host counts need the host ids")
    if feats.device.type == "cpu":
        return cardinal_stats_plain(feats, valid, hostids, num_hosts)
    dev = feats.device
    n = feats.shape[0]
    B.require(feats, "feats", _FEAT_DTYPES, 2, dev)
    if feats.shape[1] != P.NF:
        raise ValueError(f"feats: {feats.shape[1]} columns, expected {P.NF}")
    B.require(valid, "valid", (torch.bool,), 1, dev)
    if hostids is not None:
        B.require(hostids, "hostids", (torch.int32,), 1, dev)
    if valid.shape[0] != n or (hostids is not None
                               and hostids.shape[0] != n):
        raise ValueError("valid/hostids must have one entry per row")
    # one allocation: the statistics, the counts, then the kernel's
    # accumulator and ticket (csrc/cardinal_stats.cu)
    cnt = max(num_hosts, 1)
    out = torch.empty(STATS_LEN + cnt + STATS_LEN + 1, dtype=torch.int32,
                      device=dev)
    rc = B.library().yt_cardinal_stats(
        feats.data_ptr(), feats.element_size(), valid.data_ptr(),
        hostids.data_ptr() if hostids is not None else None, n, num_hosts,
        out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "cardinal_stats")
    B.count_launch("cardinal_stats")
    return out[:STATS_LEN], out[STATS_LEN:STATS_LEN + cnt]


# ---------------------------------------------------------------------------
# kernel 2: cardinal_score
# ---------------------------------------------------------------------------

_PLAIN_ROWS = 1 << 20   # rows a plain scoring step holds in int64


def cardinal_score_plain(feats, flags, valid, hostids, stats, counts,
                         consts, fast_div: bool):
    """Plain PyTorch version of kernel 2 (the JAX cardinal_from_stats),
    in steps of 2^20 rows (a row's score depends on its row alone)."""
    n = feats.shape[0]
    if n <= _PLAIN_ROWS:
        return _score_rows_plain(feats, flags, valid, hostids, stats, counts,
                                 consts, fast_div)
    def part(t, lo):
        return None if t is None else t[lo:lo + _PLAIN_ROWS]
    return torch.cat([_score_rows_plain(
        feats[lo:lo + _PLAIN_ROWS], part(flags, lo), part(valid, lo),
        part(hostids, lo), stats, counts, consts, fast_div)
        for lo in range(0, n, _PLAIN_ROWS)])


def _score_rows_plain(feats, flags, valid, hostids, stats, counts, consts,
                      fast_div: bool):
    dev = feats.device
    c = consts.to(torch.int64)
    st = stats.to(torch.int64)
    f = feats.to(torch.int64)
    cmin, cmax = st[S_COL_MIN:S_COL_MIN + P.NF], st[S_COL_MAX:S_COL_MAX + P.NF]
    span = wrap32(cmax - cmin)
    safe = span.clamp(min=1)
    prod = wrap32((f - cmin[None, :]) * 256)
    if fast_div:
        rcp = 1.0 / safe.to(torch.float32)
        q0 = f32_to_i32(prod.to(torch.float32) * rcp[None, :])
        r = wrap32(prod - q0 * safe[None, :])
        norm = q0 + (r >= safe[None, :]).long() - (r < 0).long()
    else:
        norm = torch.div(prod, safe[None, :], rounding_mode="floor")
    zero = span[None, :] == 0
    norm = torch.where(zero, 0, norm)
    inv = torch.where(zero, 0, 256 - norm)
    contrib = torch.where(torch.as_tensor(DIRECT, device=dev)[None, :],
                          norm, inv)
    per_col = shl(contrib, c[C_NORM:C_NORM + P.NF].abs()[None, :])
    score = torch.where(torch.as_tensor(ACTIVE, device=dev)[None, :],
                        per_col, 0).sum(1)
    score = score + shl(256 - f[:, P.F_DOMLENGTH], c[C_DOMLENGTH])

    tf = term_frequency(feats)
    tf_min = stats[S_TF_MIN:S_TF_MIN + 1].view(torch.float32)[0]
    tf_max = stats[S_TF_MAX:S_TF_MAX + 1].view(torch.float32)[0]
    tf_span = tf_max - tf_min
    den = torch.maximum(tf_span, torch.tensor(1e-9, dtype=torch.float32,
                                              device=dev))
    tf_norm = torch.where(tf_span > 0, f32_to_i32((tf - tf_min) * 256.0 / den),
                          0)
    score = score + shl(tf_norm, c[C_TF])

    score = score + torch.where(f[:, P.F_LANGUAGE] == c[C_LANG_PREF],
                                shl(torch.tensor(255, device=dev),
                                    c[C_LANGUAGE]), 0)

    fl = (flags if flags is not None else feats[:, P.F_FLAGS]).to(torch.int64)
    bits = c[C_BITS:C_BITS + 11]
    hit = (fl[:, None] >> bits.clamp(0, 63)[None, :]) & 1
    term = shl(torch.full((11,), 255, dtype=torch.int64, device=dev),
               c[C_SHIFTS:C_SHIFTS + 11])
    score = score + (hit * term[None, :]).sum(1)

    if counts.numel() > 1 and int(c[C_AUTHORITY]) > 12:
        h = hostids.to(torch.int64).clamp(0, counts.numel() - 1)
        auth = torch.div(wrap32(counts.to(torch.int64)[h] << 8),
                         1 + st[S_HOST_MAX], rounding_mode="floor")
        score = score + shl(auth, c[C_AUTHORITY])
    score = wrap32(score).to(torch.int32)
    return torch.where(valid.to(torch.bool), score,
                       torch.tensor(SMALL, dtype=torch.int32, device=dev))


def cardinal_score(feats, flags, valid, hostids, stats, counts, consts,
                   fast_div: bool):
    """Kernel 2: int32 cardinal score per row (invalid rows -(2^31-1)).

    feats [n, 17] int16 or int32; flags [n] int32 or None (read the
    F_FLAGS column); valid [n] bool; hostids [n] int32 (None when counts
    has one entry: no authority term, not read); stats int32[38]
    and counts from kernel 1 (or merged); consts int32[44]; fast_div
    selects the compact path's reciprocal division (exact for int16
    blocks) over the int32 path's floor division."""
    if hostids is None and counts.shape[0] > 1:
        raise ValueError("the authority term needs the host ids")
    if feats.device.type == "cpu":
        return cardinal_score_plain(feats, flags, valid, hostids, stats,
                                    counts, consts, fast_div)
    dev = feats.device
    n = feats.shape[0]
    B.require(feats, "feats", _FEAT_DTYPES, 2, dev)
    if feats.shape[1] != P.NF:
        raise ValueError(f"feats: {feats.shape[1]} columns, expected {P.NF}")
    if flags is not None:
        B.require(flags, "flags", (torch.int32,), 1, dev)
    B.require(valid, "valid", (torch.bool,), 1, dev)
    if hostids is not None:
        B.require(hostids, "hostids", (torch.int32,), 1, dev)
    B.require(stats, "stats", (torch.int32,), 1, dev)
    B.require(counts, "counts", (torch.int32,), 1, dev)
    B.require(consts, "consts", (torch.int32,), 1, dev)
    if any(t is not None and t.shape[0] != n
           for t in (valid, hostids, flags)):
        raise ValueError("flags/valid/hostids must have one entry per row")
    if stats.shape[0] != STATS_LEN or consts.shape[0] != CONSTS_LEN:
        raise ValueError("stats must be int32[38] and consts int32[44]")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    rc = B.library().yt_cardinal_score(
        feats.data_ptr(), feats.element_size(),
        flags.data_ptr() if flags is not None else None, valid.data_ptr(),
        hostids.data_ptr() if hostids is not None else None, n,
        stats.data_ptr(), counts.data_ptr(),
        counts.shape[0], consts.data_ptr(), int(fast_div), out.data_ptr(),
        B.stream_ptr(dev))
    B.check(rc, "cardinal_score")
    B.count_launch("cardinal_score")
    return out
