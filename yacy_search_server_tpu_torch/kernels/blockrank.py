"""K17 `power_iterate` (csrc/blockrank.cu): BlockRank's damped power
iteration over a host edge list, with its plain PyTorch version.

Replaces the JAX package's ops/blockrank.py `_power_iterate_sparse`
(:27-50). Both versions compute, to the bit, what XLA's CPU compiler makes
of that while_loop (read from its optimized HLO; csrc/blockrank.cu says
each step): r0 = f32(1.0 / n), inv = 1 / f32(n), teleport = (1 - d) *
inv; a step sums where(dangling, r, 0) in XLA's tree order
(`xla_tree_sum`), starts each destination's sum at dm = that sum * inv
and adds its edges' products in edge order, then r' = fma(d, acc,
teleport) rounded once, and stops when max |r' - r| <= f32(1e-9) or after
MAX_ITERS steps.

`power_iterate` launches the kernel for CUDA tensors (one persistent
launch runs every step, none after the stop; the state is fetched once
at the end) and takes the plain version for CPU tensors only. Both return
(r f32 [n], steps). `layout` also builds the kernel's work list (`order`):
hubs of more than HUB_MIN in-edges by descending in-degree, ties by host
id (a block each, the longest chains first), then the medium destinations
(LIGHT + 1 .. HUB_MIN in-edges, a warp each) the same way; the light ones
(a thread each) are the other hosts. A test may lay out at another
threshold (`layout`'s hub_min); the entry point uses HUB_MIN.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build as B

MAX_ITERS = 50
TOL = 1e-9
WINDOW = 32        # XLA's tree-reduction window (TreeReductionRewriter)
LIGHT = 32         # csrc/blockrank.cu BR_LIGHT: in-degree of one thread
HUB_MIN = 4096     # more in-edges than this: a hub, summed by a block
STATE_LEN = 16     # csrc/blockrank.cu BR_STATE: done, steps, ..., current


def step_consts(damping: float, n: int):
    """(d, inv, teleport, r0, tol) as np.float32, each rounded as XLA's
    CPU code rounds it: inv = 1 / f32(n) (XLA turns `x / n` into `x *
    inv`), teleport = f32(1 - d) * inv, r0 = f32(1.0 / n) (jnp.full of a
    Python double)."""
    d = np.float32(damping)
    inv = np.float32(1.0) / np.float32(n)
    tele = np.float32(np.float32(1.0) - d) * inv
    return d, inv, tele, np.float32(1.0 / n), np.float32(TOL)


def xla_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of a 1-d tensor in XLA's CPU order: while more than 32
    values remain, pad to a multiple of 32 (pad // 2 zeros low, the rest
    high) and add each window of 32 left to right from 0; then add the
    last values left to right from 0."""
    x = x.to(torch.float32)
    while x.numel() > WINDOW:
        m = -(-x.numel() // WINDOW) * WINDOW
        lo = (m - x.numel()) // 2
        p = torch.zeros(m, dtype=torch.float32, device=x.device)
        p[lo:lo + x.numel()] = x
        p = p.view(-1, WINDOW)
        acc = torch.zeros(p.shape[0], dtype=torch.float32, device=x.device)
        for j in range(WINDOW):
            acc = acc + p[:, j]
        x = acc
    s = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(x.numel()):
        s = s + x[j]
    return s


def fma_f32(a, b: torch.Tensor, c) -> torch.Tensor:
    """f32 a * b + c rounded once (a and c f32 scalars, b f32). The product
    is exact in f64; the f64 sum's one rounding can make the f32 rounding
    a second one only where the sum lands on an f32 midpoint, so there the
    exact error (TwoSum) picks the side."""
    a64 = torch.tensor(float(a), dtype=torch.float64, device=b.device)
    c64 = torch.tensor(float(c), dtype=torch.float64, device=b.device)
    p = a64 * b.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    out = s.to(torch.float32)
    o64 = out.to(torch.float64)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=b.device)
    nb = torch.nextafter(out, torch.where(s > o64, inf, -inf))
    nb64 = nb.to(torch.float64)
    tie = (s == (o64 + nb64) / 2) & (err != 0)
    toward = (err > 0) == (nb64 > o64)
    return torch.where(tie & toward, nb, out)


def power_iterate_plain(srcs, dsts, weights, dangling, damping: float,
                        n: int):
    """Plain version of K17: (r f32 [n], steps). Exact to the bit on CPU
    tensors, where index_add_ adds in index order; on CUDA tensors its
    segment sums run in atomics' order (a timing only)."""
    if n < 1:
        raise ValueError("power_iterate: n must be at least 1")
    d, inv, tele, r0, tol = step_consts(damping, n)
    dev = weights.device
    tol_t = torch.tensor(float(tol), dtype=torch.float32, device=dev)
    inv_t = torch.tensor(float(inv), dtype=torch.float32, device=dev)
    dsts = dsts.to(torch.int64)
    srcs = srcs.to(torch.int64)
    r = torch.full((n,), float(r0), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    steps = 0
    delta = torch.tensor(1.0, dtype=torch.float32, device=dev)
    while bool(delta > tol_t) and steps < MAX_ITERS:
        dm = xla_tree_sum(torch.where(dangling, r, zero)) * inv_t
        acc = dm.expand(n).clone()
        acc.index_add_(0, dsts, weights * r[srcs])
        r2 = fma_f32(d, acc, tele)
        delta = (r2 - r).abs().max()
        r, steps = r2, steps + 1
    return r, steps


def work_list(deg: torch.Tensor, n_heavy: int) -> torch.Tensor:
    """The n_heavy hosts of most in-edges (`deg` [n]) by descending
    in-degree, ties by host id, as int32: with n_heavy the count of more
    than LIGHT in-edges, the hubs and then the medium destinations, each
    tier in the kernel's order. One top-k on a key that breaks the ties,
    no host sync."""
    ids = torch.arange(deg.shape[0], dtype=torch.int64, device=deg.device)
    key = deg.to(torch.int64) * 2**31 + (2**31 - 1 - ids)
    return torch.topk(key, n_heavy).indices.to(torch.int32)


def layout(srcs, dsts, weights, dangling, n: int,
           hub_min: int = HUB_MIN) -> dict:
    """K17's input on the card, once a call: the edges as a CSR by
    destination (a stable sort keeps each destination's edges in edge
    order, the order its sum must take), the work list (`work_list`: hubs
    of more than hub_min in-edges, then the medium destinations), the rank
    buffers and the state. One host sync: the edge ends' range (what the
    kernel does not check) and the tiers' sizes, fetched together."""
    dev = weights.device
    B.require(srcs, "srcs", (torch.int32,), 1, dev)
    B.require(dsts, "dsts", (torch.int32,), 1, dev)
    B.require(weights, "weights", (torch.float32,), 1, dev)
    B.require(dangling, "dangling", (torch.bool,), 1, dev)
    e = weights.shape[0]
    if n < 1 or n >= 2**31 or dangling.shape[0] != n:
        raise ValueError("power_iterate: need 1 <= n < 2^31 and dangling [n]")
    if srcs.shape[0] != e or dsts.shape[0] != e or e >= 2**31 - 2**10:
        raise ValueError("power_iterate: srcs, dsts, weights must be [e], "
                         "e < 2^31 - 2^10")
    if hub_min < LIGHT:
        raise ValueError(f"power_iterate: hub_min below LIGHT ({LIGHT})")
    dst_s, order = torch.sort(dsts, stable=True)
    rowptr = torch.searchsorted(
        dst_s, torch.arange(n + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    deg = rowptr[1:] - rowptr[:-1]
    n_heavy = n_hub = 0
    if e:
        got = torch.stack([srcs.min().long(), srcs.max().long(),
                           dst_s[0].long(), dst_s[-1].long(),
                           (deg > LIGHT).sum(), (deg > hub_min).sum()])
        lo_s, hi_s, lo_d, hi_d, n_heavy, n_hub = got.tolist()
        if min(lo_s, lo_d) < 0 or max(hi_s, hi_d) >= n:
            raise ValueError("power_iterate: an edge end outside [0, n)")
    nwin = -(-n // WINDOW) if n > WINDOW else 0
    lvl = -(-nwin // WINDOW)
    return {
        "n": n, "rowptr": rowptr, "dangling": dangling,
        "src_s": srcs[order].contiguous(), "w_s": weights[order].contiguous(),
        "order": work_list(deg, n_heavy), "n_hub": n_hub,
        "n_med": n_heavy - n_hub,
        "rb": (torch.empty(n, dtype=torch.float32, device=dev),
               torch.empty(n, dtype=torch.float32, device=dev)),
        "part": torch.empty(max(nwin + 2 * lvl, 1), dtype=torch.float32,
                            device=dev),
        "state": torch.empty(STATE_LEN, dtype=torch.int32, device=dev)}


def launch(lay: dict, damping: float) -> None:
    """Launch K17 over a `layout`: r0 and the state set, then one kernel
    that runs every step on the current stream, no host sync. Three
    device operations: the fill, the zero, the kernel. Afterwards state[1]
    holds the steps taken and rb[state[4]] the ranks."""
    n = lay["n"]
    d, inv, tele, r0, tol = step_consts(damping, n)
    rb0, rb1 = lay["rb"]
    rb0.fill_(float(r0))
    lay["state"].zero_()
    bits = [int(np.asarray(x, np.float32).view(np.int32))
            for x in (d, inv, tele, tol)]
    rc = B.library().yt_power_iterate(
        lay["rowptr"].data_ptr(), lay["src_s"].data_ptr(),
        lay["w_s"].data_ptr(), lay["order"].data_ptr(), lay["n_hub"],
        lay["n_med"], lay["dangling"].data_ptr(), n,
        rb0.data_ptr(), rb1.data_ptr(), lay["part"].data_ptr(),
        lay["part"].numel(), lay["state"].data_ptr(), *bits, MAX_ITERS,
        B.stream_ptr(rb0.device))
    B.check(rc, "power_iterate")
    B.count_launch("power_iterate")


def power_iterate(srcs, dsts, weights, dangling, damping: float, n: int):
    """K17 over the edge list (srcs, dsts int32 [e] in [0, n), weights f32
    [e], dangling bool [n]) with the damping as f32: (r f32 [n] on the
    edges' device, steps). CPU tensors take the plain version."""
    if weights.device.type == "cpu":
        return power_iterate_plain(srcs, dsts, weights, dangling, damping, n)
    lay = layout(srcs, dsts, weights, dangling, n)
    launch(lay, damping)
    st = lay["state"].cpu()       # the one fetch: steps, current buffer
    return lay["rb"][int(st[4])], int(st[1])
