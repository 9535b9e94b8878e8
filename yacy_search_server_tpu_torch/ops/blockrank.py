"""BlockRank — host-level citation rank as a device power iteration.

The port's copy of the JAX package's ops/blockrank.py (capability
equivalent of the reference's offline citation ranking, reference:
source/net/yacy/search/ranking/BlockRank.java:50, and
CollectionConfiguration's postprocessing that writes the normalized host
citation rank into cr_host_norm_d for query-time boosting). The host side
is the JAX module's line for line (the sorted host vocabulary, f32
out-degree normalisation, Python-float max normalisation, Python's round
for cr_host_norm_i); the power iteration is K17 `power_iterate`
(kernels/blockrank.py, csrc/blockrank.cu), equal to the JAX
`_power_iterate_sparse` to the bit.

Entry points run on the CUDA device unless given `device` (None: CUDA,
raising without one; "cpu": the plain version).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..convert import edges_from_numpy
from ..kernels import blockrank as KB

DAMPING = 0.85
MAX_ITERS = KB.MAX_ITERS
TOL = KB.TOL


def power_iterate_sparse(srcs, dsts, weights, dangling, damping: float,
                         n: int, device=None) -> torch.Tensor:
    """Damped power iteration over an edge list (srcs, dsts int32 [e],
    weights f32 [e], dangling bool [n]): the rank vector f32 [n]. Four
    tensors stay on their device; numpy arrays go to `device` (None: the
    CUDA device, raising without one)."""
    arrays = (srcs, dsts, weights, dangling)
    if not all(isinstance(a, torch.Tensor) for a in arrays):
        arrays = edges_from_numpy(*arrays, device=device)
    r, _steps = KB.power_iterate(*arrays, damping, n)
    return r


def host_ranks(web_structure, damping: float = DAMPING,
               device=None) -> dict[str, float]:
    """host -> rank in [0, 1] (max-normalized), from the host link graph."""
    dev = resolve_device(device)
    # node set = every source host plus every link target
    hosts = set(web_structure.source_hosts())
    for h in list(hosts):
        hosts.update(web_structure.outgoing(h).keys())
    hosts = sorted(hosts)
    if not hosts:
        return {}
    idx = {h: i for i, h in enumerate(hosts)}
    n = len(hosts)
    srcs: list[int] = []
    dsts: list[int] = []
    weights: list[float] = []
    dangling = np.zeros(n, dtype=bool)
    for h in hosts:
        out = web_structure.outgoing(h)
        total = sum(out.values())
        if total <= 0:
            dangling[idx[h]] = True     # rank mass spreads uniformly
            continue
        for target, count in out.items():
            srcs.append(idx[h])
            dsts.append(idx[target])
            weights.append(count / total)
    if not srcs:        # no edges at all: uniform ranks
        return {h: 1.0 for h in hosts}
    r = power_iterate_sparse(
        np.array(srcs, np.int32), np.array(dsts, np.int32),
        np.array(weights, np.float32), dangling, damping, n,
        device=dev).cpu().numpy()
    peak = float(r.max()) or 1.0
    return {h: float(r[idx[h]]) / peak for h in hosts}


def host_ranks_from_edges(webgraph, damping: float = DAMPING,
                          device=None) -> dict[str, float]:
    """host -> rank from the per-edge webgraph store (index/webgraph.py):
    cross-host edges aggregate into the same column-stochastic form as
    host_ranks(); in-host edges are excluded."""
    dev = resolve_device(device)
    hosts, srcs, dsts, counts = webgraph.host_edge_arrays()
    n = len(hosts)
    if n == 0:
        return {}
    if len(srcs) == 0:
        return {h: 1.0 for h in hosts}
    # per-source out-degree normalization (column-stochastic transition)
    out_total = np.zeros(n, dtype=np.float32)
    np.add.at(out_total, srcs, counts)
    weights = counts / out_total[srcs]
    dangling = out_total == 0.0
    r = power_iterate_sparse(srcs, dsts, weights, dangling, damping, n,
                             device=dev).cpu().numpy()
    peak = float(r.max()) or 1.0
    return {h: float(r[i]) / peak for i, h in enumerate(hosts)}


def postprocess_segment(segment, web_structure, damping: float = DAMPING,
                        ranks: dict[str, float] | None = None,
                        device=None) -> int:
    """Write cr_host_norm_d for every indexed doc from its host's rank
    (the reference's postprocessing pass over the collection). Returns
    docs updated. Pass precomputed `ranks` to avoid re-iterating (then no
    device is needed). `segment` is duck-typed: a `.metadata` store."""
    if ranks is None:
        ranks = host_ranks(web_structure, damping, device=device)
    if not ranks:
        return 0
    # webgraph edges written AFTER this pass carry both endpoints' rank
    # partitions (source/target_cr_host_norm_i): the writer passes
    # segment._host_ranks to WebgraphStore.add_document_edges
    segment._host_ranks = ranks
    meta = segment.metadata
    updated = 0
    for docid in range(meta.capacity()):
        if meta.is_deleted(docid):
            continue
        host = meta.text_value(docid, "host_s")
        r = ranks.get(host)
        if r is not None:
            # cr_host_norm_i: the reference's integer partition of the
            # normalized rank (a 0..10 boost bucket)
            meta.set_fields(docid, cr_host_norm_d=r,
                            cr_host_norm_i=int(round(r * 10)))
            updated += 1
    return updated
