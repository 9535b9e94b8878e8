"""The dense-first IVF ANN family: port of yacy_search_server_tpu/ops/ann.py.

A clustered (IVF) device-resident index makes the dense vectors a
candidate generator, not only a rescoring signal: each dense-first query
is assigned its `nprobe` nearest centroids, the probed clusters' int8
vectors (a per-vector f16 scale) are scored against the query and fused
with the sparse candidates in one cardinal score domain (sparse + the
fixed-scale dense boost), ordered by (score DESC, docid ASC).

The two device functions are thin calls into the kernels of
kernels/ann.py: `ann_assign_batch` (K14, the JAX `_ann_assign_batch_kernel`)
and `ann_fuse_batch_packed` (K15, the JAX `_ann_fuse_batch_packed_kernel`).
Both sum the bf16 dot in K9's fixed order, so the card equals their plain
versions (the CPU's path) to the bit; against the JAX package's XLA dot
the fused scores differ by a few units of rounded boost, the caveat the
numpy oracles state.

The numpy oracles `ann_assign_np` / `ann_fuse_np` (the host scoring of
warm clusters and the device-loss path) and `pack_ann_fuse_row`,
`fuse_dedup`, `merge_fused` are the JAX package's, with `ops/dense.bf16_np`
in place of ml_dtypes: equal to the JAX package's to the bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .dense import DENSE_BOOST_SCALE, _place, bf16_np

# clusters scored a query (the index.ann.nprobe knob's default)
ANN_DEFAULT_NPROBE = 8
# probe lanes a query (pow2): probes past it drop whole clusters, counted
ANN_DEFAULT_PROBE_LANES = 1 << 15
# pad lanes/keys
_NEG = -(2 ** 31 - 1)
_INT_MAX = 2 ** 31 - 1


def ann_lane_bucket(n: int, cap: int) -> int:
    """The pow2 lane bucket (>= 256) of one fuse slot, capped at the
    probe-lane budget's bucket."""
    b = 1 << max(8, (max(n, 1) - 1).bit_length())
    return min(b, 1 << max(8, (max(cap, 1) - 1).bit_length()))


def ann_topk_bucket(k: int, nb: int) -> int:
    """The pow2 output bucket of the fused top-k: 2k (the dedup of a docid
    that is both a probe and a sparse lane still fills k), at least 16,
    clamped to the lane bucket."""
    return min(nb, 1 << max(4, (2 * max(k, 1) - 1).bit_length()))


def _on(a, dtype, dev) -> torch.Tensor:
    """A tensor as it is (the kernels check its type); numpy as a
    contiguous `dtype` tensor on `dev`."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


# -- centroid assignment ------------------------------------------------------

def ann_assign_batch(cent, qv, np_: int, c_real: int,
                     device=None) -> torch.Tensor:
    """The wave's query vectors ([B, dim] f32) against the centroid block
    ([C_pad, dim] f16): [B, np_] int32 centroid ids a slot, the pad rows
    at or past `c_real` masked (K14). A tensor stays on its device, numpy
    goes to it (or to `device`: None is the CUDA device, raising without
    one)."""
    from ..kernels import ann as KA
    dev = _place(device, cent, qv)
    return KA.ann_assign(_on(cent, np.float16, dev), _on(qv, np.float32, dev),
                         np_, c_real)


def ann_assign_np(cent, qv, nprobe: int) -> np.ndarray:
    """CPU oracle of the assignment (and the host fallback's): bf16-rounded
    inputs, f32 accumulation in numpy's order, ties by centroid id."""
    sims = (bf16_np(np.asarray(qv, np.float32))
            @ bf16_np(np.asarray(cent, np.float32)).T)
    return np.argsort(-sims, axis=-1, kind="stable")[..., :nprobe] \
        .astype(np.int32)


# -- probe + fuse -------------------------------------------------------------

def pack_ann_fuse_row(qvec: np.ndarray, rows: np.ndarray,
                      docids: np.ndarray, sparse: np.ndarray,
                      alpha: float, nb: int) -> np.ndarray:
    """One dense-first slot's int32 descriptor: ``[n_valid, alpha_bits,
    rows[nb], docids[nb], sparse[nb], qvec_bits[dim]]``. A probe lane has
    its hot-slab row and docid -1; a sparse lane its docid and cardinal
    score, and its hot row or -1 (no hot vector: it scores sparse + 0);
    lanes at or past n_valid are padding."""
    n = len(rows)
    dim = len(qvec)
    row = np.zeros(2 + 3 * nb + dim, np.int32)
    row[0] = n
    row[1] = np.float32(alpha).view(np.int32)
    row[2:2 + n] = np.asarray(rows, np.int32)
    row[2 + nb:2 + nb + n] = np.asarray(docids, np.int32)
    row[2 + 2 * nb:2 + 2 * nb + n] = np.asarray(sparse, np.int32)
    row[2 + 3 * nb:] = np.asarray(qvec, np.float32).view(np.int32)
    return row


def ann_fuse_batch_packed(slab, scales, sdocids, qi, nb: int, k: int,
                          device=None) -> torch.Tensor:
    """The batched probe and fusion against the hot slab (K15): `qi` [bs,
    2 + 3nb + dim] int32 descriptors (pack_ann_fuse_row; on the card a
    numpy wave crosses through pinned memory on the current stream), [bs,
    2k] int32 out, each slot's first k fused scores then their docids,
    pad entries INT32_MAX docids. Devices as ann_assign_batch's."""
    from ..kernels import ann as KA
    from ..kernels.dense import upload_desc
    dev = _place(device, slab, scales, sdocids, qi)
    live = None
    if not isinstance(qi, torch.Tensor):
        qi = np.ascontiguousarray(qi, np.int32)
        live = int(np.count_nonzero(qi[:, 0]))
        qi = upload_desc(qi, dev)
    return KA.ann_fuse(_on(slab, np.int8, dev), _on(scales, np.float16, dev),
                       _on(sdocids, np.int32, dev), qi, nb, k, live=live)


def ann_fuse_np(slab, scales, sdocids, rows, docids, sparse, qvec,
                alpha: float, k: int):
    """CPU oracle of one fuse slot, and the host scoring of warm clusters
    and of the device-loss path: bf16-rounded matmul inputs, f32
    accumulation in numpy's order, the same boost and (score DESC, docid
    ASC) order. Returns (scores[<=k], docids[<=k]) over the valid lanes."""
    rows = np.asarray(rows, np.int64)
    docids = np.asarray(docids, np.int64)
    sparse = np.asarray(sparse, np.int64)
    cap = slab.shape[0]
    in_slab = (rows >= 0) & (rows < cap)
    cr = np.clip(rows, 0, cap - 1)
    g = np.asarray(slab[cr]).astype(np.float32)
    q = bf16_np(np.asarray(qvec, np.float32))
    sims = g @ q
    sims = np.where(in_slab,
                    sims * np.asarray(scales[cr], np.float32), 0.0)
    dd = np.where(docids >= 0, docids,
                  np.where(in_slab, np.asarray(sdocids)[cr], _INT_MAX))
    boost = np.round(sims * np.float32(alpha)
                     * np.float32(DENSE_BOOST_SCALE)).astype(np.int64)
    final = sparse + boost
    ok = dd != _INT_MAX
    final, dd = final[ok], dd[ok]
    order = np.lexsort((dd, -final))[:k]
    return final[order].astype(np.int64), dd[order].astype(np.int32)


def fuse_dedup(scores: np.ndarray, docids: np.ndarray,
               k: int) -> tuple[np.ndarray, np.ndarray]:
    """Collapse duplicate docids of a (score DESC, docid ASC) list keeping
    the first (the best: a docid that is a probe and a sparse lane keeps
    its sparse + boost entry), then trim to k."""
    seen: set = set()
    keep = np.zeros(len(docids), bool)
    for i, d in enumerate(docids.tolist()):
        if d not in seen:
            seen.add(d)
            keep[i] = True
    return scores[keep][:k], docids[keep][:k]


def merge_fused(parts: list, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Merge fused (scores, docids) parts (the device lanes, host-scored
    warm clusters) by (score DESC, docid ASC), dedup best first, trim to
    k."""
    if not parts:
        return np.empty(0, np.int64), np.empty(0, np.int32)
    s = np.concatenate([np.asarray(p[0], np.int64) for p in parts])
    d = np.concatenate([np.asarray(p[1], np.int32) for p in parts])
    order = np.lexsort((d, -s))
    return fuse_dedup(s[order], d[order], k)


# every device function of the family and its numpy oracle
ANN_ORACLES: dict[str, object] = {
    "ann_assign_batch": ann_assign_np,
    "ann_fuse_batch_packed": ann_fuse_np,
}
