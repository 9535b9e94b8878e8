"""Machine API servlets — htroot/api/* equivalents, as far as ported.

The port's copy of the JAX package's server/servlets/api.py holds only
`postprocessing_p` (the citation-rank postprocessing trigger); the other
servlets of that file are not ported yet.

`sb` is duck-typed: `.index` with `.webgraph` and `.metadata`, and
`.web_structure`. The BlockRank iteration runs on the CUDA device; a
caller asks for another device (e.g. the CPU, for the plain version) by
setting `sb.torch_device`, which the JAX servlet never reads.
"""

from __future__ import annotations

from ..objects import ServerObjects, escape_json
from . import servlet


@servlet("postprocessing_p")
def respond_postprocessing(header: dict, post: ServerObjects,
                           sb) -> ServerObjects:
    """Trigger citation-rank postprocessing (reference: the postprocessing
    control on IndexControl; BlockRank evaluation)."""
    prop = ServerObjects()
    from ...ops.blockrank import (host_ranks, host_ranks_from_edges,
                                  postprocess_segment)
    device = getattr(sb, "torch_device", None)
    # prefer the per-edge webgraph when it has data (richer than the
    # host matrix: per-edge retirement on re-index, nofollow carried)
    if len(sb.index.webgraph):
        all_ranks = host_ranks_from_edges(sb.index.webgraph, device=device)
        prop.put("source", "webgraph")
    else:
        all_ranks = host_ranks(sb.web_structure, device=device)
        prop.put("source", "hostmatrix")
    if post.get("run"):
        prop.put("updated", postprocess_segment(
            sb.index, sb.web_structure, ranks=all_ranks))
        from ...index.postprocess import postprocess_uniqueness
        prop.put("uniqueness_updated", postprocess_uniqueness(sb.index))
    ranks = sorted(all_ranks.items(),
                   key=lambda kv: -kv[1])[: post.get_int("maxhosts", 25)]
    prop.put("hosts", len(ranks))
    for i, (h, r) in enumerate(ranks):
        prop.put(f"hosts_{i}_host", escape_json(h))
        prop.put(f"hosts_{i}_rank", round(r, 6))
    return prop
