"""Dense structure-of-arrays postings: the column layout the scorer reads.

Copy of yacy_search_server_tpu/index/postings.py (numpy only): a term's
postings are `docids` int32 [n] (ascending, unique) and `feats` int32
[n, NF], one column per posting attribute of the reference's
WordReferenceRow.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# feature column indices (NF columns, int32 each)
F_LASTMOD = 0
F_WORDS_IN_TITLE = 1
F_WORDS_IN_TEXT = 2
F_PHRASES_IN_TEXT = 3
F_DOCTYPE = 4
F_LANGUAGE = 5        # 2 ascii chars packed big-endian
F_LLOCAL = 6
F_LOTHER = 7
F_URL_LENGTH = 8
F_URL_COMPS = 9
F_FLAGS = 10          # 30-bit appearance/category bitfield
F_HITCOUNT = 11
F_POSINTEXT = 12
F_POSINPHRASE = 13
F_POSOFPHRASE = 14
F_WORDDISTANCE = 15
F_DOMLENGTH = 16      # normalized domain length 0..255
NF = 17


def pack_language(lang: str) -> int:
    """2-char ISO-639-1 code -> int (e.g. 'en' -> 0x656e); '' -> 0."""
    if not lang:
        return 0
    b = lang[:2].lower().encode("ascii", "replace")
    return (b[0] << 8) | (b[1] if len(b) > 1 else 0)


@dataclass
class PostingsList:
    """One term's postings: sorted-unique docids + aligned feature rows."""

    docids: np.ndarray  # int32 [n], ascending, unique
    feats: np.ndarray   # int32 [n, NF]

    def __post_init__(self):
        if self.docids.ndim != 1 or self.feats.shape != (len(self.docids), NF):
            raise ValueError("PostingsList needs docids [n] and feats [n, NF]")

    def __len__(self) -> int:
        return len(self.docids)

    @staticmethod
    def empty() -> "PostingsList":
        return PostingsList(np.empty(0, np.int32), np.empty((0, NF), np.int32))
