"""The dense-first IVF ANN's kernels: K14 `ann_assign` and K15 `ann_fuse`
(csrc/ann.cu), with their plain PyTorch versions.

- K14 `ann_assign` replaces the JAX package's ops/ann.py
  `_ann_assign_batch_kernel` (:82): each query (f32, rounded to bf16)
  against every row of the centroid block (f16, rounded to bf16), f32
  accumulation in K9's order (kernels/dense.dot_plain), the pow2 pad rows
  at or past `c_real` at -inf, and the first `np_` centroid ids of each
  slot in lax.top_k's order (descending IEEE total order, ties by id).
- K15 `ann_fuse` replaces `_ann_fuse_batch_packed_kernel` (:151): for each
  lane of a slot's descriptor (ops/ann.pack_ann_fuse_row) the int8 row of
  the hot slab dot the bf16 query, times the row's f16 scale (0 outside
  the slab), the docid (the lane's own, else the slab's), final = sparse
  + round((sims * alpha) * DENSE_BOOST_SCALE) on valid lanes, and the
  slot's first kk lanes in (score DESC, docid ASC) order, invalid lanes
  keyed INT32_MAX: [bs, 2kk], the scores then the docids, as lax.sort
  then [:kk] gives them.

Both dots sum in K9's fixed order, so the card equals the plain versions
to the bit; against the JAX package's XLA dot they differ by a few units
of the rounded boost (its own bar against its oracle). DIM = 256 only.
Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build as B
from .dense import DIM, _aligned, _wrap32, bf16, boost_plain, dot_plain
from .topk import _hi_key

NEG = -(2 ** 31 - 1)
INT32_MAX = 2 ** 31 - 1
MAX_CENTROIDS = 8192      # pow2 rows of K14's centroid block
MAX_KK = 8192             # K15's output lanes a slot
_PLAIN_ELEMS = 1 << 24    # products a plain step holds


# ---------------------------------------------------------------------------
# K14 ann_assign
# ---------------------------------------------------------------------------

def _check_assign(cent, qv, np_: int, c_real: int) -> None:
    if cent.dim() != 2 or cent.shape[1] != DIM or cent.dtype != torch.float16:
        raise ValueError(f"centroids must be [C_pad, {DIM}] f16, got "
                         f"{tuple(cent.shape)} {cent.dtype}")
    cp = cent.shape[0]
    if cp < 2 or cp > MAX_CENTROIDS or cp & (cp - 1):
        raise ValueError(f"C_pad={cp} is not a power of two in [2, "
                         f"{MAX_CENTROIDS}]")
    if qv.dim() != 2 or qv.shape[1] != DIM:
        raise ValueError(f"queries must be [B, {DIM}]")
    if not 1 <= c_real <= cp or not 1 <= np_ <= cp:
        raise ValueError(f"c_real={c_real}, np_={np_} outside [1, {cp}]")


def ann_assign_plain(cent, qv, np_: int, c_real: int) -> torch.Tensor:
    """Plain version of K14: [B, np_] int32."""
    _check_assign(cent, qv, np_, c_real)
    c = bf16(cent)
    q = bf16(qv.to(torch.float32))
    sims = torch.empty((q.shape[0], c.shape[0]), dtype=torch.float32,
                       device=cent.device)
    for b in range(q.shape[0]):
        sims[b] = dot_plain(c, q[b])
    ids = torch.arange(c.shape[0], device=cent.device)
    sims = torch.where(ids[None, :] < c_real, sims,
                       torch.full_like(sims, -float("inf")))
    key = (_hi_key(sims, False) - 2 ** 31) * 2 ** 32 + ids[None, :]
    return torch.argsort(key, dim=1)[:, :np_].to(torch.int32)


def ann_assign(cent, qv, np_: int, c_real: int) -> torch.Tensor:
    """K14: the first `np_` centroid ids of each query of `qv` ([B, 256]
    f32) against the centroid block `cent` ([C_pad, 256] f16, C_pad a
    power of two), rows at or past `c_real` masked: [B, np_] int32."""
    _check_assign(cent, qv, np_, c_real)
    if cent.device.type == "cpu":
        return ann_assign_plain(cent, qv, np_, c_real)
    dev = cent.device
    B.require(cent, "centroids", (torch.float16,), 2, dev)
    _aligned(cent, "centroids")
    B.require(qv, "queries", (torch.float32,), 2, dev)
    nq = qv.shape[0]
    out = torch.empty((nq, np_), dtype=torch.int32, device=dev)
    if nq:
        rc = B.library().yt_ann_assign(cent.data_ptr(), cent.shape[0],
                                       c_real, qv.data_ptr(), nq, np_,
                                       out.data_ptr(), B.stream_ptr(dev))
        B.check(rc, "ann_assign")
        B.count_launch("ann_assign", slots=nq)
    return out


# ---------------------------------------------------------------------------
# K15 ann_fuse
# ---------------------------------------------------------------------------

def _check_fuse(slab, scales, sdocids, qd, nb: int, kk: int) -> int:
    """Check K15's inputs; returns bs, the descriptor's slots."""
    if qd.dim() != 2 or qd.shape[1] != 2 + 3 * nb + DIM:
        raise ValueError(f"descriptor {tuple(qd.shape)} is not [bs, "
                         f"{2 + 3 * nb + DIM}] for nb={nb}")
    if nb < 16 or nb & (nb - 1):
        raise ValueError(f"nb={nb} is not a power of two of at least 16")
    bs = qd.shape[0]
    if slab.dim() != 2 or slab.shape[1] != DIM or slab.dtype != torch.int8:
        raise ValueError(f"the slab must be [cap, {DIM}] int8")
    cap = slab.shape[0]
    if scales.shape != (cap,) or scales.dtype != torch.float16:
        raise ValueError("scales must be [cap] f16")
    if sdocids.shape != (cap,) or sdocids.dtype != torch.int32:
        raise ValueError("slab docids must be [cap] int32")
    if not 1 <= kk <= min(nb, MAX_KK):
        raise ValueError(f"kk={kk} outside [1, min(nb, {MAX_KK})]")
    return bs


def ann_fuse_plain(slab, scales, sdocids, qd, nb: int, kk: int):
    """Plain version of K15: [bs, 2kk] int32."""
    bs = _check_fuse(slab, scales, sdocids, qd, nb, kk)
    dev = slab.device
    cap = slab.shape[0]
    nvalid = qd[:, 0:1].to(torch.int64)
    alpha = qd[:, 1:2].contiguous().view(torch.float32)
    rows = qd[:, 2:2 + nb].to(torch.int64)
    own = qd[:, 2 + nb:2 + 2 * nb].to(torch.int64)
    sparse = qd[:, 2 + 2 * nb:2 + 3 * nb].to(torch.int64)
    q = bf16(qd[:, 2 + 3 * nb:].contiguous().view(torch.float32))
    cr = rows.clamp(0, cap - 1)
    in_slab = (rows >= 0) & (rows < cap)
    sims = torch.zeros((bs, nb), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_ELEMS // (nb * DIM))
    for b0 in range(0, bs, step):
        g = slab[cr[b0:b0 + step]].to(torch.float32)
        sims[b0:b0 + step] = dot_plain(g, q[b0:b0 + step, None, :])
    sims = torch.where(in_slab, sims * scales[cr].to(torch.float32),
                       torch.zeros_like(sims))
    dd = torch.where(own >= 0, own,
                     torch.where(in_slab, sdocids[cr].to(torch.int64),
                                 torch.full_like(own, INT32_MAX)))
    lanes = torch.arange(nb, device=dev)[None, :]
    valid = (lanes < nvalid) & (dd != INT32_MAX)
    final = torch.where(valid, _wrap32(sparse + boost_plain(sims, alpha))
                        .to(torch.int64), torch.full_like(own, NEG))
    tkey = torch.where(valid, dd, torch.full_like(dd, INT32_MAX))
    neg = _wrap32(-final).to(torch.int64)
    key = torch.sort(neg * 2 ** 32 + (tkey + 2 ** 31), dim=1).values[:, :kk]
    fs = _wrap32(-torch.div(key, 2 ** 32, rounding_mode="floor"))
    ds = ((key & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)
    return torch.cat([fs, ds], dim=1)


def ann_fuse(slab, scales, sdocids, qd, nb: int, kk: int,
             live: int | None = None) -> torch.Tensor:
    """K15 over the hot slab (`slab` [cap, 256] int8, `scales` [cap] f16,
    `sdocids` [cap] int32) for each slot of the device descriptor `qd`
    ([bs, 2 + 3nb + 256] int32): [bs, 2kk] int32, each slot's first kk
    fused scores then their docids. `live`: the slots with lanes
    (counted; default bs)."""
    bs = _check_fuse(slab, scales, sdocids, qd, nb, kk)
    if slab.device.type == "cpu":
        return ann_fuse_plain(slab, scales, sdocids, qd, nb, kk)
    dev = slab.device
    B.require(slab, "slab", (torch.int8,), 2, dev)
    _aligned(slab, "slab")
    B.require(scales, "scales", (torch.float16,), 1, dev)
    B.require(sdocids, "slab docids", (torch.int32,), 1, dev)
    B.require(qd, "descriptor", (torch.int32,), 2, dev)
    # the lanes' 64-bit keys, then the first selection round's survivors
    keys = torch.empty(bs * nb * 3 // 2, dtype=torch.int64, device=dev)
    out = torch.empty((bs, 2 * kk), dtype=torch.int32, device=dev)
    rc = B.library().yt_ann_fuse(slab.data_ptr(), scales.data_ptr(),
                                 sdocids.data_ptr(), slab.shape[0],
                                 qd.data_ptr(), bs, nb, kk, keys.data_ptr(),
                                 out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "ann_fuse")
    B.count_launch("ann_fuse", slots=bs if live is None else live)
    return out
