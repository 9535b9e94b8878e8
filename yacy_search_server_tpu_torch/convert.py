"""Carry state from the JAX package to the port.

A search engine's "weights" are its index blocks and its ranking profile.
`placed_from_numpy` turns the padded arrays that the JAX package's
MeshRanker.place / CardinalRanker.rank build (as numpy) into the port's
placed tensors; `profile_from_jax` turns a JAX RankingProfile, through its
external string, into the port's. Both sides then score identical bytes
under an identical profile.
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
