"""The smoke's data and timers for the port's kernels on one CUDA card.

`make_term` makes the smoke's 10M-posting term from its seed,
`edge_block` a block at the edges of `cardinal_score`'s int32
arithmetic, and `sorted_runs` the gathered block of a fusion (one sorted
run a shard). `call_ms` times one call between two CUDA events as the host
issues it from an idle queue (the `ms` of chip_smoke.py);
`device_ms` times the device alone, the calls queued behind a spin
kernel. `empty_launch` launches an empty kernel (the floor of a call),
`device_ops` lists the device operations one call issues (a profiler
trace). `topk_trace` reads `tie_topk`'s per-pass trace, which the kernel
library holds only when built with YT_KERNEL_TRACE=1.
"""

from __future__ import annotations

import statistics
import time

import numpy as np

SEED = 20261016


def make_term(n: int, seed: int = SEED):
    """(feats int32 [n, 17], docids int32 [n], hostids int32 [n], rng) of
    the smoke's synthetic term: random columns in their real ranges, 50,000
    hosts, and the best row of the first 100,000 repeated every 500,009
    rows so that equal scores reach the top-k."""
    from ..index import postings as P
    from ..ops import ranking as R
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 30000, (n, P.NF), dtype=np.int32)
    feats[:, P.F_FLAGS] = rng.integers(0, 2**30, n, dtype=np.int32)
    feats[:, P.F_HITCOUNT] = rng.integers(0, 256, n, dtype=np.int32)
    feats[:, P.F_DOMLENGTH] = rng.integers(0, 256, n, dtype=np.int32)
    feats[:, P.F_LANGUAGE] = np.where(rng.random(n) < 0.5, 0x656E, 0x6465)
    docids = np.arange(n, dtype=np.int32) * 2 + 1
    hostids = rng.integers(0, 50_000, n, dtype=np.int32)
    best = np.argmax(R.cardinal_scores_host(feats[:min(n, 100_000)],
                                            R.RankingProfile()))
    feats[::500_009] = feats[best]
    return feats, docids, hostids, rng


def host_mix(mix: str, n: int, rng, hosts: int = 50_000):
    """int32 host ids of n postings, each drawn on its own: "uniform" over
    `hosts` hosts (make_term's), "zipf" over `hosts` hosts with
    P(rank r) ~ r^-1.1 (the exponent of the repo's Zipf query mixes,
    CHAOS_r02.json) and the ranks given random ids, or "one" host."""
    if mix == "uniform":
        return rng.integers(0, hosts, n, dtype=np.int32)
    if mix == "zipf":
        p = np.arange(1, hosts + 1, dtype=np.float64) ** -1.1
        ids = rng.permutation(hosts).astype(np.int32)
        return ids[rng.choice(hosts, n, p=p / p.sum())]
    if mix == "one":
        return np.full(n, hosts // 2, np.int32)
    raise ValueError(f"unknown host mix {mix!r}")


# cardinal_score's int32 edges: column spans (max - min, wrapping), column
# minima, and offsets from the minimum, whose (f - min) * 256 lands on and
# beside both int32 wrap boundaries (2^23 * 256 = 2^31)
EDGE_SPANS = (1, 2, 2**31 - 1, 0, 3, 2**31 - 2, -5, 255, 65537, 1)
EDGE_MINS = (-2**31, -2**31 + 1, -2**23, -1, 0, 1, 2**31 - 1, -2**23 + 100)
EDGE_DELTAS = (0, 1, -1, 2**23 - 1, 2**23, 2**23 + 1, -2**23 - 1, -2**23,
               -2**23 + 1, 2**24 - 1, 2**31 - 1, -2**31, 255, 256)


def edge_block(n: int, seed: int = SEED):
    """(feats int32 [n, 17], col_min int32 [17], col_max int32 [17]) at the
    edges of cardinal_score's int32 arithmetic, to stand in for the
    statistics' column bounds: spans of 0, 1, 2, 3, 2^31-2, 2^31-1 and a
    wrapped negative one, minima at both ends of int32, and features at
    offsets from the minimum whose product by 256 wraps or just does not.
    The term-frequency columns keep their real values (their minima are
    the extremes), so the tf sum does not wrap."""
    from ..index import postings as P
    feats, _, _, rng = make_term(n, seed)
    wrap = lambda x: ((np.asarray(x, np.int64) + 2**31) % 2**32  # noqa: E731
                      - 2**31)
    tf_cols = (P.F_WORDS_IN_TITLE, P.F_WORDS_IN_TEXT, P.F_HITCOUNT)
    free = [c for c in range(P.NF)
            if c not in tf_cols and c not in (4, P.F_LANGUAGE, P.F_FLAGS,
                                              P.F_DOMLENGTH)]
    cmin = np.zeros(P.NF, np.int64)
    cmax = np.zeros(P.NF, np.int64)
    for i, c in enumerate(free + list(tf_cols)):
        cmin[c] = EDGE_MINS[i % len(EDGE_MINS)]
        cmax[c] = wrap(cmin[c] + EDGE_SPANS[i % len(EDGE_SPANS)])
    for c in free:
        d = rng.choice(np.array(EDGE_DELTAS, np.int64), n)
        wild = rng.random(n) < 0.25
        d[wild] = rng.integers(-2**31, 2**31, int(wild.sum()))
        feats[:, c] = wrap(cmin[c] + d)
    return feats, cmin.astype(np.int32), cmax.astype(np.int32)


def sorted_runs(shards: int, rows: int, is_float: bool, rng, pad: int = 0,
                special: bool = False):
    """A gathered [shards * rows, 2] int32 block (CPU) of `shards` sorted
    runs, as the fusion gathers them: each run the tie_topk_plain of
    random scores with few values (so that scores tie within and across
    runs), its last `pad` rows padding (docid -1, score -inf or
    -(2^31-1)), and with `special` f32 NaN, -0.0, +0.0 and -inf or int32
    -2^31 among the scores."""
    import torch
    from .topk import tie_topk_plain
    cols = []
    for _ in range(shards):
        if is_float:
            s = (rng.integers(0, 50, rows) * 0.5).astype(np.float32)
            if special:
                s[::5] = np.nan
                s[1::7] = -0.0
                s[2::7] = 0.0
                s[3::11] = -np.inf
        else:
            s = rng.integers(0, 50, rows).astype(np.int32)
            if special:
                s[::5] = -(2**31)
        d = rng.integers(0, 5000, rows).astype(np.int32)
        if pad:
            s[rows - pad:] = -np.inf if is_float else -(2**31 - 1)
            d[rows - pad:] = -1
        ts, td, _ = tie_topk_plain(torch.from_numpy(s), rows,
                                   secondary=torch.from_numpy(d))
        cols.append(torch.stack([ts.view(torch.int32) if is_float else ts,
                                 td], 1))
    return torch.cat(cols)


def device_ms(fn, reps: int = 20) -> float:
    """Median device time of one call of `fn`, in ms.

    A spin kernel holds the stream while the host queues every call, so
    the events around each call time the device alone, not the host's
    Python and launch work between calls. Calls follow each other: inputs
    that fit the L2 cache (tie_topk's 40 MB of scores) may be found there,
    as in the ranking step, where the scores were just written."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    # about 2 GHz: cycles enough for the host to queue every call
    torch.cuda._sleep(int(min(1.0, 2.0 * host_s * reps + 0.002) * 2e9))
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def call_ms(fn, reps: int = 20) -> float:
    """Median time between two events around one call issued from an idle
    queue: the device time plus the host's issue time."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def empty_launch() -> None:
    """One launch of an empty kernel on the current stream: the floor of
    any kernel's call and device time."""
    import torch
    from . import build as B
    B.check(B.library().yt_empty_launch(
        B.stream_ptr(torch.device("cuda"))), "empty")


def device_ops(fn) -> list:
    """Names of the device operations (kernels, memsets, copies) one call
    of `fn` issues, read from a torch.profiler trace of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def topk_trace() -> list:
    """The passes of the last tie_topk call, from the kernel's trace slots
    (device clock, us since the kernel's start): for each pass the first
    block's arrival at the grid barrier and the pick that ends it (after
    the sample, the guessed bucket of digit 0; after a pass, each digit
    picked, the source the next pass reads: 0 the scores, 1-2 a
    candidate buffer of `m` rows, and the rows in the chosen bucket),
    then the end of the select and of the sort. Empty when the library
    was built without the trace."""
    import ctypes
    from . import build as B
    buf = (ctypes.c_uint64 * 64)()
    got = B.library().yt_tie_topk_trace(buf)
    if got < 0:
        raise RuntimeError("tie_topk trace: cudaMemcpyFromSymbol failed")
    rows = [tuple(buf[4 * i:4 * i + 4]) for i in range(max(got, 0))]
    t0 = rows[0][0] if rows else 0
    us = lambda t: round((t - t0) / 1e3, 2)  # noqa: E731
    out = []
    for t, a, b, c in rows[1:]:
        if a == 300:
            out.append({"us": us(t), "first_arrival_us": us(b)})
        elif a == 400:
            out.append({"us": us(t), "guess": b, "sample_rows": c})
        elif a == 100:
            out.append({"us": us(t), "collected_from": b})
        elif a in (200, 201):
            out.append({"us": us(t), "end": "sort" if a == 200 else "select"})
        else:
            out.append({"us": us(t), "digit": a, "src": b, "m": c >> 32,
                        "bucket": c & 0xFFFFFFFF})
    return out
