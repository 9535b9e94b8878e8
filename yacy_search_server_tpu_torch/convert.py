"""Carry state from the JAX package to the port.

A search engine's "weights" are its index blocks and its ranking profile.
`placed_from_numpy` turns the padded arrays that the JAX package's
MeshRanker.place / CardinalRanker.rank build (as numpy) into the port's
placed tensors; `profile_from_jax` turns a JAX RankingProfile, through its
external string, into the port's. `arena_from_numpy` and `span_from_fields`
carry a JAX DeviceSegmentStore's arena (fetched as numpy) and its spans
into the port, so the devstore kernels of both read the same bytes. Both
sides then score identical bytes under an identical profile.
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


def span_from_fields(start, count, tstart, tcount, stats, dead_seq):
    """The port's Span from a JAX Span's fields (`stats`: its frozen
    pack-time dict of col_min, col_max, tf_min, tf_max)."""
    from .index.devstore import Span
    return Span(int(start), int(count), int(tstart), int(tcount),
                {"col_min": np.asarray(stats["col_min"], np.int32),
                 "col_max": np.asarray(stats["col_max"], np.int32),
                 "tf_min": np.float32(stats["tf_min"]),
                 "tf_max": np.float32(stats["tf_max"])}, int(dead_seq))
