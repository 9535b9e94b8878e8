"""Content signatures — exact and fuzzy duplicate-detection hashes.

Capability equivalent of the reference's signature fields (reference:
search/schema/CollectionSchema.java exact_signature_l / fuzzy_signature_l,
computed by EnhancedTextProfileSignature — a Solr TextProfileSignature
variant hashing the most frequent words): 63-bit integers so exact
duplicates (same normalized text) and near-duplicates (same dominant
vocabulary) can be grouped with one int-column compare, which is also how
the uniqueness postprocessing marks *_unique_b flags.

The port's copy of the JAX package's module of the same name.
"""

from __future__ import annotations

import hashlib
import re

_WORD_RE = re.compile(r"\w+", re.UNICODE)
_WS_RE = re.compile(r"\s+")


def _h63(data: str) -> int:
    """63-bit positive hash (fits the schema's signed long)."""
    digest = hashlib.md5(data.encode("utf-8", "replace")).digest()
    return int.from_bytes(digest[:8], "big") & 0x7FFF_FFFF_FFFF_FFFF


def exact_signature(text: str) -> int:
    """Hash of the whitespace-normalized, lowercased text — equal iff the
    visible content is byte-equal after trivial formatting."""
    return _h63(_WS_RE.sub(" ", text).strip().lower())


def fuzzy_profile_text(text: str, quant_rate: float = 0.01,
                       min_token_len: int = 2) -> str:
    """The dominant-vocabulary profile string the fuzzy signature hashes
    (stored as CollectionSchema.fuzzy_signature_text_t so operators can
    inspect WHY two documents grouped as near-duplicates)."""
    counts: dict[str, int] = {}
    for w in _WORD_RE.findall(text.lower()):
        if len(w) >= min_token_len:
            counts[w] = counts.get(w, 0) + 1
    if not counts:
        return ""
    max_freq = max(counts.values())
    quant = max(1, round(max_freq * quant_rate)) if max_freq > 1 else 1
    profile = sorted(
        (w for w, c in counts.items() if (c // quant) > 0),
        key=lambda w: (-(counts[w] // quant), w))[:64]
    return " ".join(f"{w}:{counts[w] // quant}" for w in profile)


def fuzzy_signature(text: str, quant_rate: float = 0.01,
                    min_token_len: int = 2) -> int:
    """Hash of the dominant vocabulary: words are counted, counts are
    quantized (TextProfileSignature's QUANT_RATE rounding), and tokens at
    the top quantized frequency form the profile. Layout/boilerplate
    differences that keep the same dominant words collide — which is the
    point."""
    return _h63(fuzzy_profile_text(text, quant_rate, min_token_len))
