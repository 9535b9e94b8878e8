"""Streaming block scorer: unbounded postings through a running top-k.

Port of yacy_search_server_tpu/ops/streaming.py. Postings blocks flow
tile by tile through the scoring kernel while a running top-k carries
over (a Python loop replaces `lax.scan`):

- `scan_score_topk`: a device-resident block scored in fixed tiles; live
  memory is one tile's scores plus the carry.
- `stream_score_topk`: a numpy block fed to the device chunk by chunk, so
  blocks larger than the card's memory score in bounded memory; two
  passes (stats, then scores) keep normalization block-global.

Per tile: kernel 2 scores, kernel 3 takes the tile's top-k, and kernel 3
again merges it into the running top-k (running rows first, so
lowest-index tie-breaking keeps equal scores docid-ascending).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..index import postings as P
from ..kernels import cardinal as KC
from ..kernels import tie_topk
from .ranking import cardinal_from_stats, local_stats

NEG_INF32 = -(2**31 - 1)


def merge_stats(a: dict | None, b: dict) -> dict:
    """Combine per-chunk stats (min, max, min, max, sum)."""
    if a is None:
        return b
    sa, sb = a["stats"], b["stats"]
    cols = torch.cat([
        torch.minimum(sa[KC.S_COL_MIN:KC.S_COL_MAX],
                      sb[KC.S_COL_MIN:KC.S_COL_MAX]),
        torch.maximum(sa[KC.S_COL_MAX:KC.S_TF_MIN],
                      sb[KC.S_COL_MAX:KC.S_TF_MIN])])
    fa = sa[KC.S_TF_MIN:KC.S_TF_MAX + 1].view(torch.float32)
    fb = sb[KC.S_TF_MIN:KC.S_TF_MAX + 1].view(torch.float32)
    tf = torch.stack([torch.minimum(fa[0], fb[0]),
                      torch.maximum(fa[1], fb[1])]).view(torch.int32)
    counts = a["host_counts"] + b["host_counts"]
    tail = torch.stack([counts.max(),
                        torch.maximum(sa[KC.S_NAN], sb[KC.S_NAN])])
    return {"stats": torch.cat([cols, tf, tail]), "host_counts": counts}


def _merge_topk(run_s, run_d, new_s, new_d, k: int):
    s, d, _ = tie_topk(torch.cat([run_s, new_s]), k,
                       payload=torch.cat([run_d, new_d]))
    return s, d


def scan_score_topk(feats16, flags, docids, valid, hostids, stats: dict,
                    consts, k: int, tile: int = 1 << 20):
    """Device streaming over a compact block in `tile`-row slices with a
    running (scores, docids) top-k. The last partial tile is padded with
    invalid rows (docid -1), as the JAX version pads; when fewer than k
    valid rows exist the tail carries docid -1 at the sentinel score."""
    dev = feats16.device
    n = feats16.shape[0]
    steps = max(1, (n + tile - 1) // tile)
    run_s = torch.full((k,), NEG_INF32, dtype=torch.int32, device=dev)
    run_d = torch.full((k,), -1, dtype=torch.int32, device=dev)
    for i in range(steps):
        lo, hi = i * tile, min(n, (i + 1) * tile)
        f, fl, dd, vv, hh = (feats16[lo:hi], flags[lo:hi], docids[lo:hi],
                             valid[lo:hi], hostids[lo:hi])
        if hi - lo < tile:
            pad = tile - (hi - lo)
            f = torch.cat([f, f.new_zeros((pad, P.NF))])
            fl = torch.cat([fl, fl.new_zeros(pad)])
            dd = torch.cat([dd, dd.new_full((pad,), -1)])
            vv = torch.cat([vv, vv.new_zeros(pad)])
            hh = torch.cat([hh, hh.new_zeros(pad)])
        s = cardinal_from_stats(f, vv, hh, stats, consts, fast_div=True,
                                flags=fl)
        tile_s, tile_d, _ = tie_topk(s, min(k, tile), payload=dd)
        run_s, run_d = _merge_topk(run_s, run_d, tile_s, tile_d, k)
    return run_s, run_d


def stream_score_topk(feats: np.ndarray, flags: np.ndarray,
                      docids: np.ndarray, hostids: np.ndarray, consts,
                      k: int = 100, chunk: int = 1 << 21, device=None):
    """Host streaming: numpy block -> device chunks -> running top-k.

    Peak device memory is one chunk regardless of block size. Returns
    (scores, docids) numpy arrays, best-first. Streamed scoring never
    accumulates per-host counts, so it behaves as if the authority guard
    were off (the JAX version's documented limit). `consts` is the
    profile's constant tensor; it must lie on `device`."""
    n = len(docids)
    if n == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    stats = None
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        cs = local_stats(put(feats[lo:hi]),
                         torch.ones(hi - lo, dtype=torch.bool, device=dev),
                         put(hostids[lo:hi]), num_hosts=1,
                         with_host_counts=False)
        stats = merge_stats(stats, cs)

    run_s = torch.full((k,), NEG_INF32, dtype=torch.int32, device=dev)
    run_d = torch.full((k,), -1, dtype=torch.int32, device=dev)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        s = cardinal_from_stats(
            put(feats[lo:hi]),
            torch.ones(hi - lo, dtype=torch.bool, device=dev),
            put(hostids[lo:hi]), stats, consts,
            fast_div=feats.dtype == np.int16, flags=put(flags[lo:hi]))
        tile_s, tile_d, _ = tie_topk(s, min(k, hi - lo),
                                     payload=put(docids[lo:hi]))
        run_s, run_d = _merge_topk(run_s, run_d, tile_s, tile_d, k)
    s_np, d_np = run_s.cpu().numpy(), run_d.cpu().numpy()
    keep = d_np >= 0
    return s_np[keep], d_np[keep]
