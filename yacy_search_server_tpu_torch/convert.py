"""Carry state from the JAX package to the port.

A search engine's "weights" are its index blocks and its ranking profile.
`placed_from_numpy` turns the padded arrays that the JAX package's
MeshRanker.place / CardinalRanker.rank build (as numpy) into the port's
placed tensors; `profile_from_jax` turns a JAX RankingProfile, through its
external string, into the port's. `arena_from_numpy`, `join_from_numpy`
and `span_from_fields` carry a JAX DeviceSegmentStore's arena and join
side-tables (fetched as numpy) and its spans into the port, and
`delta_from_numpy` / `bitmap_from_numpy` a RAM delta block and a facet
bitmap as its kernels take them, and `join_wave_from_numpy` a wave's
qargs_batch as the batched join kernels take it, so the devstore kernels
of both read the same bytes. Both sides then score
identical bytes under an identical profile.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .index import postings as P
from .ops.ranking import RankingProfile


def placed_from_numpy(feats, docids, valid, hostids, npad: int, device=None):
    """(feats int32 [npad, NF], docids int32 [npad], valid bool [npad],
    hostids int32 [npad], npad) on `device` (None: the CUDA device)."""
    dev = resolve_device(device)
    # writable C-contiguous copies where needed: arrays fetched from JAX
    # are read-only, and torch.from_numpy shares the buffer on the CPU
    own = lambda a, t: np.require(a, t, ["C", "W"])  # noqa: E731
    feats = own(feats, np.int32)
    if feats.shape != (npad, P.NF):
        raise ValueError(f"feats shape {feats.shape}, expected ({npad}, {P.NF})")
    arrays = (own(docids, np.int32), own(valid, bool), own(hostids, np.int32))
    if any(a.shape != (npad,) for a in arrays):
        raise ValueError(f"docids/valid/hostids must be [{npad}]")
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (put(feats), *map(put, arrays), int(npad))


def profile_from_jax(external_string: str) -> RankingProfile:
    """The port's profile from a JAX RankingProfile.to_external_string()."""
    return RankingProfile.from_external_string(external_string)


def arena_from_numpy(feats16, flags, docids, dead, pmax, device=None):
    """(feats16 int16 [cap, 17], flags int32 [cap], docids int32 [cap],
    dead bool [doc_cap], pmax int32 [tcap]) on `device` (None: the CUDA
    device): a DeviceArena's buffers as the devstore kernels read them."""
    dev = resolve_device(device)
    feats16 = np.require(feats16, np.int16, ["C", "W"])
    cap = feats16.shape[0]
    if feats16.shape != (cap, P.NF):
        raise ValueError(f"feats16 shape {feats16.shape}, expected "
                         f"(cap, {P.NF})")
    flags, docids = (np.require(a, np.int32, ["C", "W"])
                     for a in (flags, docids))
    if flags.shape != (cap,) or docids.shape != (cap,):
        raise ValueError(f"flags/docids must be [{cap}]")
    arrays = (feats16, flags, docids, np.require(dead, bool, ["C", "W"]),
              np.require(pmax, np.int32, ["C", "W"]))
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def join_from_numpy(jdocids, jpos, bmtab, device=None):
    """(jdocids int32 [jcap], jpos int32 [jcap], bmtab int32 [slots,
    nwords, 2]) on `device` (None: the CUDA device): a DeviceArena's join
    side-tables as K8 reads them."""
    dev = resolve_device(device)
    jdocids, jpos = (np.require(a, np.int32, ["C", "W"])
                     for a in (jdocids, jpos))
    bmtab = np.require(bmtab, np.int32, ["C", "W"])
    if jdocids.ndim != 1 or jpos.shape != jdocids.shape:
        raise ValueError("jdocids/jpos must be one-dimensional and equal "
                         "in length")
    if bmtab.ndim != 3 or bmtab.shape[2] != 2:
        raise ValueError(f"bmtab shape {bmtab.shape}, expected "
                         "(slots, nwords, 2)")
    return tuple(torch.from_numpy(a).to(dev) for a in (jdocids, jpos, bmtab))


def span_from_fields(start, count, tstart, tcount, stats, dead_seq,
                     jstart=-1, jslot=-1):
    """The port's Span from a JAX Span's fields (`stats`: its frozen
    pack-time dict of col_min, col_max, tf_min, tf_max; `jstart`,
    `jslot`: its join segment and bitmap slot)."""
    from .index.devstore import Span
    return Span(int(start), int(count), int(tstart), int(tcount),
                {"col_min": np.asarray(stats["col_min"], np.int32),
                 "col_max": np.asarray(stats["col_max"], np.int32),
                 "tf_min": np.float32(stats["tf_min"]),
                 "tf_max": np.float32(stats["tf_max"])}, int(dead_seq),
                int(jstart), int(jslot))


def delta_from_numpy(feats16, flags, docids, device=None):
    """(feats16 int16 [n, 17], flags int32 [n], docids int32 [n]) on
    `device` (None: the CUDA device): a RAM delta block (the JAX store's
    d_feats16, d_flags, d_docids: compact rows padded with docid -1) as
    K6, K7 and topk_finish read it after the extents."""
    dev = resolve_device(device)
    feats16 = np.require(feats16, np.int16, ["C", "W"])
    n = feats16.shape[0]
    flags, docids = (np.require(a, np.int32, ["C", "W"])
                     for a in (flags, docids))
    if feats16.shape != (n, P.NF) or flags.shape != (n,) \
            or docids.shape != (n,):
        raise ValueError(f"a delta block is [n, {P.NF}] int16 and two [n] "
                         "int32 arrays")
    return tuple(torch.from_numpy(a).to(dev) for a in (feats16, flags, docids))


def bitmap_from_numpy(words, device=None):
    """A facet docid bitmap (the JAX store's uint32 `allow` words) as the
    int32 bit patterns K6 and K7 read, on `device` (None: CUDA)."""
    words = np.ascontiguousarray(words, np.uint32)
    if words.ndim != 1 or not len(words):
        raise ValueError("a bitmap is a non-empty [nwords] array")
    return torch.from_numpy(words.view(np.int32).copy()).to(
        resolve_device(device))


def join_wave_from_numpy(qargs_batch, n_inc: int, inc_bm=(), exc_bm=()):
    """A JAX store's join wave descriptor (`qargs_batch`, int32 [bs, 6 +
    3 (n_inc + n_exc)]) as the port's batched join kernels take it: the
    same layout (kernels/devstore.join_wave_desc) in host memory, where
    the kernels' launches copy it from, with the slot of each partner and
    exclude whose membership mode (the reference's static `inc_bm` /
    `exc_bm`, all False where not given) is the sorted segment set to
    -1."""
    desc = np.array(qargs_batch, np.int32, ndmin=2)
    n_exc = (desc.shape[1] - 6) // 3 - n_inc
    if n_exc < 0 or desc.shape[1] != 6 + 3 * (n_inc + n_exc):
        raise ValueError(f"qargs_batch of {desc.shape[1]} words does not "
                         f"hold {n_inc} partners and their excludes")
    inc_bm = tuple(inc_bm) or (False,) * n_inc
    exc_bm = tuple(exc_bm) or (False,) * n_exc
    for t, bm in enumerate(inc_bm):
        if not bm:
            desc[:, 6 + 2 * n_inc + t] = -1
    base = 6 + 3 * n_inc
    for e, bm in enumerate(exc_bm):
        if not bm:
            desc[:, base + 2 * n_exc + e] = -1
    return desc
