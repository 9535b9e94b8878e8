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
of both read the same bytes. `dense_from_numpy` builds the port's
DenseVectorStore from a JAX store's vectors (`_vecs[:len(store)]`), and
`ann_from_numpy` the port's AnnVectorIndex from a JAX index's arrays.
Both sides then score identical bytes under an identical profile.
`edges_from_numpy` carries BlockRank's host edge list (built in numpy by
both packages) to the device K17 reads it on. `mesh_cells_from_numpy`
turns a JAX MeshSegmentStore's global [n_cells, ...] arrays into the
port's mesh cells, so the port's shard bodies run on its own placement.
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


def dense_from_numpy(vecs, n: int | None = None, device=None,
                     budget_bytes: int | None = None):
    """The port's DenseVectorStore holding the first `n` rows of `vecs`
    ([rows, dim], stored as f16; n defaults to all rows) in one copy,
    with its forward index uploaded to `device` (None: the CUDA device)
    unless it is over `budget_bytes` (None: the store's default). The
    store's version counts one write a row."""
    from .index.dense import DenseVectorStore
    vecs = np.asarray(vecs)
    if vecs.ndim != 2:
        raise ValueError(f"vecs must be [rows, dim], got {vecs.shape}")
    n = len(vecs) if n is None else int(n)
    if not 0 <= n <= len(vecs):
        raise ValueError(f"n={n} outside [0, {len(vecs)}]")
    st = DenseVectorStore(dim=vecs.shape[1], device_budget_bytes=budget_bytes)
    cap = 256
    while cap < n:
        cap *= 2     # the JAX store's doubling from 256 rows
    st._vecs = np.zeros((cap, vecs.shape[1]), np.float16)
    st._vecs[:n] = vecs[:n]
    st._n = n
    st.version = n
    st._fwd_dirty = set()
    st.device_snapshot(resolve_device(device))
    return st


def ann_from_numpy(centroids, slab, scales, sdocids, cstart, ccount, row_of,
                   hot_slab, hot_scales, hot_docids, hot_map: dict,
                   device=None, device_budget_bytes: int = 1 << 30):
    """The port's AnnVectorIndex holding a JAX AnnVectorIndex's layout:
    its f32 centroids, the int8 slab with its f16 scales and docids, each
    cluster's start and count, the docid -> row map, and the hot arena's
    host mirror (slab, scales, docids) with its cluster -> start row map.
    `device_budget_bytes` must be the JAX index's, which sized the mirror.
    The hot arena goes to `device` (None: the CUDA device) at first use,
    whole."""
    from .index.annstore import AnnVectorIndex
    slab = np.asarray(slab, np.int8)
    idx = AnnVectorIndex(slab.shape[1], device=device,
                         device_budget_bytes=device_budget_bytes)
    idx.adopt(np.asarray(centroids, np.float32), slab,
              np.asarray(scales, np.float16), np.asarray(sdocids, np.int32),
              np.asarray(cstart, np.int64), np.asarray(ccount, np.int64),
              np.asarray(row_of, np.int32))
    if hot_slab is not None and len(hot_slab) != idx._hot_cap:
        raise ValueError(f"the hot mirror holds {len(hot_slab)} rows, the "
                         f"budget {idx._hot_cap}: pass the JAX index's "
                         "device_budget_bytes")
    with idx._lock:
        if idx._hot_cap:
            idx._hot_slab = np.array(hot_slab, np.int8)
            idx._hot_scales = np.array(hot_scales, np.float16)
            idx._hot_docids = np.array(hot_docids, np.int32)
        idx._hot_map = {int(c): int(h) for c, h in hot_map.items()}
        idx._hot_used = max((h + int(idx._ccount[c])
                             for c, h in idx._hot_map.items()), default=0)
        idx._hot_pending = []
    return idx


def edges_from_numpy(srcs, dsts, weights, dangling, device=None):
    """(srcs int32 [e], dsts int32 [e], weights f32 [e], dangling bool [n])
    on `device` (None: the CUDA device): BlockRank's edge list as K17
    `power_iterate` reads it."""
    dev = resolve_device(device)
    srcs, dsts = (np.require(a, np.int32, ["C", "W"]) for a in (srcs, dsts))
    weights = np.require(weights, np.float32, ["C", "W"])
    dangling = np.require(dangling, bool, ["C", "W"])
    if srcs.ndim != 1 or dsts.shape != srcs.shape \
            or weights.shape != srcs.shape or dangling.ndim != 1:
        raise ValueError("srcs, dsts, weights must be [e] and dangling [n]")
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (srcs, dsts, weights, dangling))


def mesh_cells_from_numpy(feats16, flags, docids, jdocids, jpos, pmax,
                          devices, dead=None):
    """The port's mesh cells from a JAX MeshSegmentStore's global arrays
    (np.asarray of its `_dev_arrays`: feats16 int16 [n_cells, C, 17], flags
    and docids int32 [n_cells, C]; of `_dev_join`: jdocids and jpos int32
    [n_cells, JC]; of `_dev_pmax`: int32 [n_cells, TC]), one device a cell
    in cell order (a device may repeat), with the tombstone bitmap `dead`
    (bool [doc_cap]; None: none): the per-cell tensors the port's shard
    bodies (index/meshstore) read, one [cells_on_device, ...] tensor a
    device and array with the cells as its views, as the port store's
    device sync lays them out."""
    from .index.meshstore import place_cells
    arrays = [np.require(a, t, ["C", "W"]) for a, t in (
        (feats16, np.int16), (flags, np.int32), (docids, np.int32),
        (jdocids, np.int32), (jpos, np.int32), (pmax, np.int32))]
    n = arrays[0].shape[0]
    if arrays[0].ndim != 3 or arrays[0].shape[2] != P.NF:
        raise ValueError(f"feats16 shape {arrays[0].shape}, expected "
                         f"(cells, C, {P.NF})")
    if any(a.ndim != 2 or a.shape[0] != n for a in arrays[1:]):
        raise ValueError("every array needs one row a cell")
    devs = [resolve_device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"{len(devs)} devices for {n} cells")
    return place_cells(arrays, devs, np.zeros(1 << 16, bool)
                       if dead is None else dead)
