"""Kernels 3 and 4: exact tie-ordered top-k and the fusion merge.

`tie_topk` (csrc/tie_topk.cu) replaces lax.top_k in the JAX package's
score_topk16 / score_topk / streaming merge (index mode: descending
score, ties by the lower row index) and parallel/mesh.tie_topk (tie mode:
lax.sort ascending on (-score, docid)). `gather_topk` (csrc/gather_topk.cu)
replaces the merge of the Pallas kernel parallel/mesh._all_gather_topk_pallas,
and `gather_topk_batch` (the same source) the per-slot merge of the mesh
store's batched pruned body (index/meshstore._mesh_pruned_batch_shard).
Each wrapper launches its CUDA kernel for CUDA tensors and takes its plain
PyTorch version only for CPU tensors.

Orders, shared with csrc/common.cuh: scores are int32 or f32. Index mode
sorts f32 by the IEEE total order (NaN first, -NaN last, +0 before -0),
as lax.top_k does. Tie mode sorts by lax.sort's canonical order of the
negated score: -0 equals +0, every NaN sorts last, and an int32 score of
-2^31 (whose negation wraps) sorts first.
"""

from __future__ import annotations

import torch

from . import build as B

_SCORE_DTYPES = (torch.int32, torch.float32)


def _float_order(bits: torch.Tensor) -> torch.Tensor:
    """f32 bits (int64 values of int32) -> signed total-order key."""
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _hi_key(scores: torch.Tensor, tie: bool) -> torch.Tensor:
    """Ascending uint32 key (in int64) of the score half: smaller is
    better."""
    if scores.dtype == torch.int32:
        s = scores.to(torch.int64)
        if tie:
            neg = ((-s + 2**31) & 0xFFFFFFFF) - 2**31     # wrapping negation
            return neg + 2**31
        return 2**31 - 1 - s
    if tie:
        v = -scores
        bits = v.view(torch.int32).to(torch.int64)
        bits = torch.where(v == 0, 0, bits)
        bits = torch.where(torch.isnan(v), 0x7FC00000, bits)
        return _float_order(bits) + 2**31
    return 2**31 - 1 - _float_order(scores.view(torch.int32).to(torch.int64))


def tie_topk_plain(scores, k: int, secondary=None, payload=None):
    """Plain PyTorch version of kernel 3: (scores, secondary-or-payload,
    row index) of the k best rows."""
    n = scores.shape[0]
    hi = _hi_key(scores, secondary is not None)
    lo = (secondary.to(torch.int64) + 2**31 if secondary is not None
          else torch.arange(n, dtype=torch.int64, device=scores.device))
    key = (hi - 2**31) * 2**32 + lo
    idx = torch.argsort(key, stable=True)[:k]
    if payload is not None:
        sec = payload[idx]
    elif secondary is not None:
        sec = secondary[idx]
    else:
        sec = idx.to(torch.int32)
    return scores[idx], sec, idx.to(torch.int32)


def tie_topk(scores, k: int, secondary=None, payload=None, out=None):
    """Kernel 3: exact top-k of `scores` ([n] int32 or f32), 1 <= k <= n.

    Without `secondary`: lax.top_k order (ties by lower row index). With
    `secondary` ([n] int32 docids): lax.sort order on (-score, docid).
    Returns (scores [k], payload[row] or secondary[row] or row [k] int32,
    row [k] int32), written into `out` (three contiguous int32 [k]
    tensors, e.g. rows of a wave's buffers) when it is given."""
    n = scores.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"tie_topk: k={k} outside [1, {n}]")
    if scores.device.type == "cpu":
        got = tie_topk_plain(scores, k, secondary, payload)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g.view(torch.int32) if g.dtype == torch.float32 else g)
        return got
    dev = scores.device
    B.require(scores, "scores", _SCORE_DTYPES, 1, dev)
    for name, t in (("secondary", secondary), ("payload", payload)):
        if t is not None:
            B.require(t, name, (torch.int32,), 1, dev)
            if t.shape[0] != n:
                raise ValueError(f"{name}: one entry per score expected")
    lib = B.library()
    scratch = torch.empty(int(lib.yt_tie_topk_scratch_bytes(n, k)),
                          dtype=torch.uint8, device=dev)
    if out is None:
        out = tuple(torch.empty(k, dtype=torch.int32, device=dev)
                    for _ in range(3))
    for o in out:
        B.require(o, "out", (torch.int32,), 1, dev)
        if o.shape[0] != k:
            raise ValueError(f"out: {o.shape[0]} entries, k={k}")
    out_s, out_sec, out_idx = out
    is_float = scores.dtype == torch.float32
    rc = lib.yt_tie_topk(
        scores.data_ptr(), int(is_float),
        secondary.data_ptr() if secondary is not None else None,
        payload.data_ptr() if payload is not None else None,
        n, k, scratch.data_ptr(), out_s.data_ptr(), out_sec.data_ptr(),
        out_idx.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "tie_topk")
    B.count_launch("tie_topk")
    return (out_s.view(torch.float32) if is_float else out_s), out_sec, out_idx


def _runs(m: int, k: int, run_len) -> int:
    """Check gather_topk's k and run length (default: one run of m)."""
    run_len = m if run_len is None else int(run_len)
    if not 1 <= k <= m:
        raise ValueError(f"gather_topk: k={k} outside [1, {m}]")
    if run_len < 1 or m % run_len:
        raise ValueError(f"gather_topk: run_len={run_len} does not divide "
                         f"m={m}")
    return run_len


def gather_topk_plain(scores, docids, k: int, is_float: bool, run_len=None):
    """Plain PyTorch version of kernel 4: (score bits [k], docids [k]).
    Ranks all m rows, so the runs' order does not matter to it."""
    _runs(scores.shape[0], k, run_len)
    s = scores.contiguous()
    s = s.view(torch.float32) if is_float else s
    top_s, top_d, _ = tie_topk_plain(s, k, secondary=docids.contiguous())
    return (top_s.view(torch.int32) if is_float else top_s), top_d


def gather_topk(scores, docids, k: int, is_float: bool, run_len=None):
    """Kernel 4: merge m gathered rows of shard-local top-k into the first
    k rows of the (score DESC, docid ASC) order, 1 <= k <= m.

    `scores` (int32, f32 bits when is_float) and `docids` (int32) are [m]
    columns with one stride, e.g. the columns of a gathered [m, 2] block.
    The rows are m / run_len runs (default one run of m), each in that
    order, as a local tie_topk leaves them; a run out of order is ranked
    by the kernel's slow all-pairs path, never answered wrongly. Returns
    (score column [k] int32, docids [k] int32)."""
    m = scores.shape[0]
    run_len = _runs(m, k, run_len)
    if scores.device.type == "cpu":
        return gather_topk_plain(scores, docids, k, is_float, run_len)
    dev = scores.device
    for name, t in (("scores", scores), ("docids", docids)):
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name}: expected a tensor on {dev}")
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != m:
            raise ValueError(f"{name}: expected int32 [{m}]")
    stride = scores.stride(0)
    if docids.stride(0) != stride or stride < 1:
        raise ValueError("scores and docids must share one positive stride")
    out = torch.empty((2, k), dtype=torch.int32, device=dev)
    rc = B.library().yt_gather_topk(scores.data_ptr(), docids.data_ptr(),
                                    stride, m, run_len, int(is_float), k,
                                    out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "gather_topk")
    B.count_launch("gather_topk")
    return out[0], out[1]


def _check_batch(g, run_len: int, k: int, d_off: int, ok_off):
    """Check gather_topk_batch's arguments; (bs, runs, width)."""
    if not isinstance(g, torch.Tensor) or g.dtype != torch.int32 \
            or g.dim() != 3:
        raise ValueError("gather_topk_batch: g must be int32 [bs, runs, w]")
    bs, runs, w = g.shape
    if bs < 1 or runs < 1 or run_len < 1:
        raise ValueError("gather_topk_batch: an empty batch")
    if not 1 <= k <= runs * run_len:
        raise ValueError(f"gather_topk_batch: k={k} outside [1, "
                         f"{runs * run_len}]")
    if run_len > w or not 0 <= d_off <= w - run_len \
            or (ok_off is not None and not 0 <= ok_off < w):
        raise ValueError("gather_topk_batch: a column outside a run's "
                         f"{w} words")
    return bs, runs, w


def gather_topk_batch_plain(g, run_len: int, k: int, is_float: bool,
                            d_off: int, ok_off=None):
    """Plain PyTorch version of K4 batched: [bs, 2k (+1)] int32."""
    bs, runs, _w = _check_batch(g, run_len, k, d_off, ok_off)
    out = torch.empty((bs, 2 * k + (ok_off is not None)), dtype=torch.int32,
                      device=g.device)
    for b in range(bs):
        s = g[b, :, :run_len].reshape(-1)
        d = g[b, :, d_off:d_off + run_len].reshape(-1)
        out[b, :k], out[b, k:2 * k] = gather_topk_plain(s, d, k, is_float)
        if ok_off is not None:
            out[b, 2 * k] = int(bool((g[b, :, ok_off] != 0).all()))
    return out


def gather_topk_batch(g, run_len: int, k: int, is_float: bool, d_off: int,
                      ok_off=None):
    """K4 batched: one launch that merges, for each of bs slots, `runs`
    tie-ordered runs of `run_len` rows into the first k rows of the (score
    DESC, docid ASC) order, 1 <= k <= runs * run_len.

    `g` is int32 [bs, runs, w] (the cells' [bs, w] blocks gathered along
    a new cell axis): run r of slot b has its scores (int32, f32 bits when
    is_float) at g[b, r, :run_len], its docids at g[b, r, d_off:d_off +
    run_len] and, with `ok_off`, an ok word at g[b, r, ok_off]. A run out
    of order takes the slow all-pairs path, never a wrong answer (the
    pruned cells' runs are in (score, tile row) order). Returns [bs, 2k]
    scores ++ docids, and with ok_off one more column: 1 where every run's
    ok is nonzero (the pmin over cells of _mesh_pruned_batch_shard)."""
    bs, runs, w = _check_batch(g, run_len, k, d_off, ok_off)
    if g.device.type == "cpu":
        return gather_topk_batch_plain(g, run_len, k, is_float, d_off,
                                       ok_off)
    dev = g.device
    B.require(g, "g", (torch.int32,), 3, dev)
    out = torch.empty((bs, 2 * k + (ok_off is not None)), dtype=torch.int32,
                      device=dev)
    base = g.data_ptr()
    rc = B.library().yt_gather_topk_batch(
        base, base + 4 * d_off,
        base + 4 * ok_off if ok_off is not None else None, runs * w, w, bs,
        runs, run_len, int(is_float), k, out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "gather_topk_batch")
    B.count_launch("gather_topk_batch", slots=bs)
    return out
