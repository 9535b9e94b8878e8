"""A parsed document's hyperlink — the one part of the JAX package's
document model (document/document.py) that the port's webgraph reads.

Capability equivalent of the reference's anchor entries (reference:
source/net/yacy/document/Document.java): the link's target url, its
anchor text and its rel attribute. `index/webgraph.add_document_edges`
reads `url`, `text` and `rel` (and `alt`/`name` where present).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Anchor:
    url: str
    text: str = ""
    rel: str = ""
