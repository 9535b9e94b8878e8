"""Query-time cardinal ranking (ReferenceOrder) and BM25, on PyTorch.

Port of yacy_search_server_tpu/ops/ranking.py. The host half (profile,
compact block format, numpy twins) is copied; the device half runs the
hand-written CUDA kernels of `kernels/`:

    stats    = kernels.cardinal_stats  (masked column min/max, tf min/max,
                                        per-host counts)
    scores   = kernels.cardinal_score  (sum_s norm_s << coeff_s, int32)
    top-k    = kernels.tie_topk        (lax.top_k order)
    BM25     = bm25_scores             (K16 `bm25_pass`, csrc/bm25.cu)

The profile becomes one constant int32[44] tensor on the chosen device
(`profile_consts`, layout in kernels/cardinal.py). Statistics are a dict
{"stats": int32[38], "host_counts": int32[H]}, the packed vector kernel 1
writes; `stats_fields` unpacks it.

Scores are int32 and bit-identical to the JAX package's on the same
input; BM25 is f32 and agrees to rounding (its sums run in another order
and its log is taken in double), its card and plain versions to the bit.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import resolve_device
from ..index import postings as P
from ..kernels import cardinal as KC
from ..kernels import cardinal_score, cardinal_stats, tie_topk
from ..utils.bitfield import (
    FLAG_APP_DC_CREATOR, FLAG_APP_DC_DESCRIPTION, FLAG_APP_DC_IDENTIFIER,
    FLAG_APP_DC_SUBJECT, FLAG_APP_DC_TITLE, FLAG_APP_EMPHASIZED,
    FLAG_CAT_HASAPP, FLAG_CAT_HASAUDIO, FLAG_CAT_HASIMAGE,
    FLAG_CAT_HASVIDEO, FLAG_CAT_INDEXOF,
)

# content domains (reference: cora/document/analysis/Classification.ContentDomain)
CD_ALL, CD_TEXT, CD_IMAGE, CD_AUDIO, CD_VIDEO, CD_APP = -1, 0, 1, 2, 3, 4

NEG_INF_I32 = -(2**31 - 1)


@dataclass
class RankingProfile:
    """The 32 shift coefficients, defaults per content domain, with the
    reference's `name=value,...` external form (RankingProfile.java)."""

    domlength: int = 10
    date: int = 9
    wordsintitle: int = 2
    wordsintext: int = 3
    phrasesintext: int = 0
    llocal: int = 0
    lother: int = 7
    urllength: int = 6
    urlcomps: int = 7
    hitcount: int = 1
    posintext: int = 4
    posofphrase: int = 0
    posinphrase: int = 0
    authority: int = 5
    worddistance: int = 10
    appurl: int = 12
    appdescr: int = 14
    appauthor: int = 1
    apptags: int = 2
    appref: int = 10
    appemph: int = 5
    catindexof: int = 0
    cathasimage: int = 0
    cathasaudio: int = 0
    cathasvideo: int = 0
    cathasapp: int = 0
    tf: int = 8
    language: int = 2
    citation: int = 10
    # post-ranking predicates (applied host-side after ranking)
    urlcompintoplist: int = 2
    descrcompintoplist: int = 2
    prefer: int = 0

    @staticmethod
    def for_contentdom(cd: int) -> "RankingProfile":
        p = RankingProfile()
        p.cathasapp = 15 if cd == CD_APP else 0
        p.cathasaudio = 15 if cd == CD_AUDIO else 0
        p.cathasimage = 15 if cd == CD_IMAGE else 0
        p.cathasvideo = 15 if cd == CD_VIDEO else 0
        p.catindexof = 0 if cd in (CD_TEXT, CD_ALL) else 15
        return p

    def to_external_string(self) -> str:
        return ",".join(f"{f.name}={getattr(self, f.name)}" for f in fields(self))

    @staticmethod
    def from_external_string(s: str) -> "RankingProfile":
        p = RankingProfile()
        if not s:
            return p
        s = s.strip()
        if s.startswith("{") and s.endswith("}"):
            s = s[1:-1].strip()
        parts = s.split("&") if "&" in s else s.split(",")
        valid = {f.name for f in fields(p)}
        for part in parts:
            if "=" not in part:
                continue
            k, _, v = part.strip().partition("=")
            if k in valid:
                try:
                    setattr(p, k, max(0, min(15, int(v))))
                except ValueError:
                    pass
        return p

    def norm_coeffs(self) -> np.ndarray:
        """int32 [NF] shift coefficients per feature column; negative =
        lower-is-better (the reference's `256 - norm` inversion)."""
        c = np.zeros(P.NF, dtype=np.int32)
        c[P.F_LASTMOD] = self.date
        c[P.F_WORDS_IN_TITLE] = self.wordsintitle
        c[P.F_WORDS_IN_TEXT] = self.wordsintext
        c[P.F_PHRASES_IN_TEXT] = self.phrasesintext
        c[P.F_LLOCAL] = self.llocal
        c[P.F_LOTHER] = self.lother
        c[P.F_URL_LENGTH] = -self.urllength
        c[P.F_URL_COMPS] = -self.urlcomps
        c[P.F_HITCOUNT] = self.hitcount
        c[P.F_POSINTEXT] = -self.posintext
        c[P.F_POSINPHRASE] = -self.posinphrase
        c[P.F_POSOFPHRASE] = -self.posofphrase
        c[P.F_WORDDISTANCE] = -self.worddistance
        return c

    def flag_coeffs(self) -> tuple[np.ndarray, np.ndarray]:
        """(flag bit positions, shift coefficients) for the 255<<coeff terms."""
        pairs = [
            (FLAG_APP_DC_IDENTIFIER, self.appurl),
            (FLAG_APP_DC_TITLE, self.appdescr),
            (FLAG_APP_DC_CREATOR, self.appauthor),
            (FLAG_APP_DC_SUBJECT, self.apptags),
            (FLAG_APP_DC_DESCRIPTION, self.appref),
            (FLAG_APP_EMPHASIZED, self.appemph),
            (FLAG_CAT_INDEXOF, self.catindexof),
            (FLAG_CAT_HASIMAGE, self.cathasimage),
            (FLAG_CAT_HASAUDIO, self.cathasaudio),
            (FLAG_CAT_HASVIDEO, self.cathasvideo),
            (FLAG_CAT_HASAPP, self.cathasapp),
        ]
        bits = np.array([b for b, _ in pairs], dtype=np.int32)
        shifts = np.array([s for _, s in pairs], dtype=np.int32)
        return bits, shifts


# direct (higher-is-better) columns never invert; flags column is special
_NORM_DIRECT = KC.DIRECT
# columns carrying normalized contributions (flags/doctype/language/
# domlength are handled by their own terms)
_ACTIVE_COLS = KC.ACTIVE


def profile_consts(profile: RankingProfile, language_pref: int,
                   device) -> torch.Tensor:
    """The profile as one int32[44] constant tensor on `device` (layout in
    kernels/cardinal.py): the port's `_device_consts`."""
    bits, shifts = profile.flag_coeffs()
    c = np.concatenate([
        profile.norm_coeffs(), bits, shifts,
        np.array([profile.domlength, profile.tf, profile.language,
                  profile.authority, language_pref], np.int32)])
    return torch.from_numpy(c.astype(np.int32)).to(device)


# ---------------------------------------------------------------------------
# device half: statistics, scores, top-k
# ---------------------------------------------------------------------------

def local_stats(feats, valid, hostids, num_hosts: int,
                with_host_counts: bool = True) -> dict:
    """Per-block normalization statistics (kernel 1). Statistics of
    several blocks combine with (min, max, min, max, sum): see
    ops/streaming.merge_stats. `with_host_counts=False` skips the per-host
    scatter (legitimate whenever the authority guard is off)."""
    st, counts = cardinal_stats(feats, valid, hostids,
                                num_hosts if with_host_counts else 0)
    return {"stats": st, "host_counts": counts}


def stats_fields(stats: dict) -> dict:
    """Unpack a statistics dict into the JAX package's field names."""
    st = stats["stats"]
    return {
        "col_min": st[KC.S_COL_MIN:KC.S_COL_MIN + P.NF],
        "col_max": st[KC.S_COL_MAX:KC.S_COL_MAX + P.NF],
        "tf_min": st[KC.S_TF_MIN:KC.S_TF_MIN + 1].view(torch.float32)[0],
        "tf_max": st[KC.S_TF_MAX:KC.S_TF_MAX + 1].view(torch.float32)[0],
        "host_counts": stats["host_counts"],
    }


def cardinal_from_stats(feats, valid, hostids, stats: dict, consts,
                        fast_div: bool = False, flags=None):
    """Score rows against precomputed (possibly merged) statistics
    (kernel 2). `feats` may be int16 (compact block, then `flags` carries
    the int32 bitfields) or int32 (flags read from the F_FLAGS column)."""
    return cardinal_score(feats, flags, valid, hostids, stats["stats"],
                          stats["host_counts"], consts, fast_div)


def cardinal_scores(feats, valid, hostids, consts):
    """int32 cardinal score per row over an int32 block, statistics of the
    block itself with per-row host bins (single-device composition)."""
    stats = local_stats(feats, valid, hostids, num_hosts=feats.shape[0])
    return cardinal_from_stats(feats, valid, hostids, stats, consts)


# Compact device blocks: int16 [n, NF] with the flags column zeroed, plus
# one int32 [n] flags array; values are clipped into int16 at pack time.
INT16_MAX = 32767


def compact_feats(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int32 [n, NF] -> (int16 [n, NF] with flags zeroed, int32 [n] flags)."""
    flags = np.ascontiguousarray(feats[:, P.F_FLAGS]).astype(np.int32)
    small = np.clip(feats, -INT16_MAX - 1, INT16_MAX).astype(np.int16)
    small[:, P.F_FLAGS] = 0
    return small, flags


def cardinal_scores16(feats16, flags, valid, hostids, stats: dict | None,
                      consts, with_authority: bool = True):
    """Compact-block scorer with the exact fast division. `with_authority`
    is the host-known authority guard: when False the per-host scatter is
    skipped."""
    if stats is None:
        stats = local_stats(feats16, valid, hostids,
                            num_hosts=feats16.shape[0],
                            with_host_counts=with_authority)
    return cardinal_from_stats(feats16, valid, hostids, stats, consts,
                               fast_div=True, flags=flags)


def score_topk16(feats16, flags, docids, valid, hostids, consts, k: int,
                 with_authority: bool = True):
    """Compact-block cardinal + top-k: (scores, docids, row index)."""
    scores = cardinal_scores16(feats16, flags, valid, hostids, None, consts,
                               with_authority=with_authority)
    return tie_topk(scores, k, payload=docids)


def score_topk16_packed(feats16, flags, docids, valid, hostids, consts,
                        k: int, with_authority: bool = True):
    """score_topk16 with a packed [2k] int32 output (scores ++ docids):
    one device->host copy per query."""
    s, d, _ = score_topk16(feats16, flags, docids, valid, hostids, consts,
                           k, with_authority=with_authority)
    return torch.cat([s, d])


def score_topk(feats, docids, valid, hostids, consts, k: int):
    """int32-block cardinal + top-k: (scores, docids, row index)."""
    scores = cardinal_scores(feats, valid, hostids, consts)
    return tie_topk(scores, k, payload=docids)


def pad_to(n: int, tile: int = 128) -> int:
    """Round up to a tile multiple; min one tile."""
    return max(tile, ((n + tile - 1) // tile) * tile)


def hostid_array(docids: np.ndarray, hosthashes) -> np.ndarray:
    """Map per-row host hashes to dense int ids (for the authority term)."""
    _, ids = np.unique(np.asarray(hosthashes), return_inverse=True)
    return ids.astype(np.int32)


# below this candidate count a kernel dispatch costs more than scoring on
# the host: CardinalRanker scores such blocks with the numpy twin
SMALL_RANK_N = 4096


# ---------------------------------------------------------------------------
# host half: numpy twins
# ---------------------------------------------------------------------------

def pack_stats_host(feats16: np.ndarray, flags: np.ndarray) -> dict:
    """Normalization stats over a compact block (numpy twin of
    local_stats, all rows valid), float32 tf like the kernel."""
    f = feats16.astype(np.int32)
    tf = f[:, P.F_HITCOUNT].astype(np.float32) / (
        f[:, P.F_WORDS_IN_TEXT] + f[:, P.F_WORDS_IN_TITLE] + 1
    ).astype(np.float32)
    return {
        "col_min": f.min(axis=0).astype(np.int32),
        "col_max": f.max(axis=0).astype(np.int32),
        "tf_min": np.float32(tf.min()),
        "tf_max": np.float32(tf.max()),
    }


def cardinal_from_stats_host(feats16: np.ndarray, flags: np.ndarray,
                             stats: dict, prof: RankingProfile,
                             language_pref: int,
                             hostids: np.ndarray | None = None) -> np.ndarray:
    """Numpy twin of cardinal_from_stats over a compact block (integer
    parts bit-exact, tf normalization in float32 like the kernel)."""
    f = feats16.astype(np.int32)
    col_min, col_max = stats["col_min"], stats["col_max"]
    span = col_max - col_min
    safe = np.maximum(span, 1)
    norm = ((f - col_min[None, :]) * 256) // safe[None, :]
    norm = np.where(span[None, :] == 0, 0, norm)
    inv = np.where(span[None, :] == 0, 0, 256 - norm)
    contrib = np.where(_NORM_DIRECT[None, :], norm, inv)
    per_col = contrib << np.abs(prof.norm_coeffs())[None, :]
    score = np.where(_ACTIVE_COLS[None, :], per_col, 0).sum(
        axis=1, dtype=np.int64)
    score += (256 - f[:, P.F_DOMLENGTH]) << prof.domlength
    tf = f[:, P.F_HITCOUNT].astype(np.float32) / (
        f[:, P.F_WORDS_IN_TEXT] + f[:, P.F_WORDS_IN_TITLE] + 1
    ).astype(np.float32)
    tf_span = stats["tf_max"] - stats["tf_min"]
    tf_norm = np.where(
        tf_span > 0,
        (tf - stats["tf_min"]) * np.float32(256.0) / max(tf_span, 1e-9),
        0.0).astype(np.int32)
    score += tf_norm.astype(np.int64) << prof.tf
    score += np.where(f[:, P.F_LANGUAGE] == language_pref,
                      255 << prof.language, 0)
    bits, shifts = prof.flag_coeffs()
    hit = (flags[:, None] >> bits[None, :]) & 1
    score += (hit * (255 << shifts[None, :])).sum(axis=1, dtype=np.int64)
    if prof.authority > 12 and hostids is not None and len(f):
        counts = np.bincount(hostids, minlength=int(hostids.max()) + 1)
        auth = (counts[hostids].astype(np.int64) << 8) // (1 + counts.max())
        score += auth << prof.authority
    return score.astype(np.int64)


def cardinal_scores_host(feats: np.ndarray, profile: RankingProfile,
                         language: str = "en",
                         hostids: np.ndarray | None = None) -> np.ndarray:
    """Pure-numpy scorer for small candidate sets; scores the same compact
    int16 representation the device path scores."""
    feats16, flags = compact_feats(np.asarray(feats, dtype=np.int32))
    stats = pack_stats_host(feats16, flags)
    return cardinal_from_stats_host(feats16, flags, stats, profile,
                                    P.pack_language(language), hostids)


class CardinalRanker:
    """Host-side wrapper: pad -> upload -> score_topk16_packed, profile
    baked into constants on `device` (None: the CUDA device)."""

    def __init__(self, profile: RankingProfile | None = None,
                 language: str = "en", device=None):
        self.profile = profile or RankingProfile()
        self._lang_str = language
        self._device = device
        self._consts = None   # built on the first device rank

    def _device_consts(self) -> torch.Tensor:
        """Lazy upload of the profile constants: a ranker whose every
        query takes the small-n host path never touches the device."""
        if self._consts is None:
            self._consts = profile_consts(
                self.profile, P.pack_language(self._lang_str),
                resolve_device(self._device))
        return self._consts

    def rank(self, plist, hosthashes=None, k: int = 10):
        """(scores, docids) best-first over a PostingsList, as numpy."""
        n = len(plist)
        if n == 0:
            return np.empty(0, np.int32), np.empty(0, np.int32)
        if n <= SMALL_RANK_N:
            # product policy: tiny candidate sets score on the host
            hostids = (hostid_array(plist.docids, hosthashes)
                       if hosthashes is not None else None)
            s = cardinal_scores_host(plist.feats, self.profile,
                                     self._lang_str, hostids)
            order = np.argsort(-s, kind="stable")[:k]
            return s[order], plist.docids[order]
        consts = self._device_consts()
        dev = consts.device
        npad = pad_to(n)
        feats = np.zeros((npad, P.NF), np.int32)
        feats[:n] = plist.feats
        docids = np.full(npad, -1, np.int32)
        docids[:n] = plist.docids
        valid = np.zeros(npad, bool)
        valid[:n] = True
        hostids = np.zeros(npad, np.int32)
        if hosthashes is not None:
            hostids[:n] = hostid_array(plist.docids, hosthashes)
        kk = min(k, npad)
        feats16, flags = compact_feats(feats)
        put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        out = score_topk16_packed(
            put(feats16), put(flags), put(docids), put(valid), put(hostids),
            consts, kk, with_authority=self.profile.authority > 12)
        host = out.cpu().numpy()      # one packed fetch (scores ++ docids)
        s, d = host[:kk], host[kk:]
        keep = (d >= 0) & (s > NEG_INF_I32)
        return s[keep][:k], d[keep][:k]


# ---------------------------------------------------------------------------
# BM25: dense doc x term first-stage relevance
# ---------------------------------------------------------------------------

def _bm25_consts(k1: float, b: float):
    """The pass's f32 constants k1, 1 - b, b, k1 + 1, each rounded once
    from the host's double (as PyTorch rounds a Python scalar for an f32
    tensor)."""
    return tuple(np.float32(x) for x in (k1, 1.0 - b, b, k1 + 1.0))


def bm25_sums_plain(doclen, valid):
    """Plain version of K16's first half: int64 [2], the valid rows'
    doclen summed exactly and their count."""
    total = torch.where(valid, doclen.to(torch.int64), 0).sum()
    cnt = valid.to(torch.int64).sum()
    return torch.stack([total, cnt])


def bm25_rows_plain(tf, doclen, df, ndocs, valid, acc, k1: float = 1.2,
                    b: float = 0.75):
    """Plain version of K16's second half: the rows' f32 scores over the
    tf block's term columns against the sums `acc` (int64 [2])."""
    dev = tf.device
    c = [torch.tensor(x, dtype=torch.float32, device=dev)
         for x in _bm25_consts(k1, b)]
    ck1, c0, cb, ck1p1 = c
    tf = tf.to(torch.float32)
    dl = doclen.to(torch.float32)
    acc = acc.to(dev)
    avgdl = acc[0].to(torch.float32) / torch.clamp(acc[1].to(torch.float32),
                                                   min=1.0)
    nd = torch.as_tensor(ndocs, device=dev).to(torch.float32)
    dff = df.to(torch.float32)
    x = 1.0 + ((nd - dff) + 0.5) / (dff + 0.5)
    idf = torch.log(x.to(torch.float64)).to(torch.float32)
    base = ck1 * (c0 + cb * (dl / torch.clamp(avgdl, min=1e-6)))
    score = None
    for j in range(tf.shape[1]):
        den = torch.clamp(tf[:, j] + base, min=1e-9)
        term = ((idf[j] * tf[:, j]) * ck1p1) / den
        score = term if score is None else score + term
    if score is None:
        score = torch.zeros_like(dl)
    return torch.where(valid, score, float("-inf"))


def bm25_scores_plain(tf, doclen, df, ndocs, valid, k1: float = 1.2,
                      b: float = 0.75):
    """Plain version of K16 `bm25_pass`: f32 BM25 per row, -inf on invalid
    rows, in the kernel's operation order (csrc/bm25.cu): avgdl =
    f32(the valid rows' doclen summed exactly) / max(f32(count), 1); idf =
    f32(log(double(1 + ((ndocs - df) + 0.5) / (df + 0.5)))); term_j =
    ((idf_j * tf_j) * (k1 + 1)) / max(tf_j + k1 * ((1 - b) + b * (dl /
    max(avgdl, 1e-6))), 1e-9), summed left to right. The JAX package sums
    avgdl and the terms in XLA's order and takes an f32 log: a few ulps
    apart."""
    return bm25_rows_plain(tf, doclen, df, ndocs, valid,
                           bm25_sums_plain(doclen, valid), k1, b)


def _bm25_args(tf, doclen, df, ndocs, valid):
    """Check K16's block; (n, t, the ndocs pointer, its f32 bits)."""
    from ..kernels import build as B
    dev = tf.device
    B.require(tf, "tf", (torch.float32, torch.int32), 2, dev)
    n, t = tf.shape
    B.require(doclen, "doclen", (torch.int32,), 1, dev)
    B.require(df, "df", (torch.int32,), 1, dev)
    B.require(valid, "valid", (torch.bool,), 1, dev)
    if doclen.shape[0] != n or valid.shape[0] != n or df.shape[0] != t:
        raise ValueError("doclen and valid must be [n], df [t]")
    if isinstance(ndocs, torch.Tensor):
        if ndocs.device != dev or ndocs.dtype != torch.int32 \
                or ndocs.numel() != 1:
            raise ValueError("ndocs: one int32 on the block's device")
        return n, t, ndocs.data_ptr(), 0
    return n, t, None, int(np.float32(ndocs).view(np.int32))


def bm25_scores(tf, doclen, df, ndocs, valid, k1: float = 1.2,
                b: float = 0.75):
    """K16 `bm25_pass` (csrc/bm25.cu), the scoring pass of the JAX
    `bm25_topk` (ops/ranking.py:653): [n] f32 BM25 of each row of the
    [n, t] tf block (f32 or int32) with doclen [n] int32, df [t] int32,
    ndocs (a number or an int32 tensor on the block's device) and valid
    [n] bool; -inf on invalid rows. The plain version for CPU tensors."""
    if tf.device.type == "cpu":
        return bm25_scores_plain(tf, doclen, df, ndocs, valid, k1, b)
    from ..kernels import build as B
    dev = tf.device
    n, t, nd_ptr, nd_bits = _bm25_args(tf, doclen, df, ndocs, valid)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    acc = torch.empty(2, dtype=torch.int64, device=dev)
    bits = [int(x.view(np.int32)) for x in _bm25_consts(k1, b)]
    rc = B.library().yt_bm25_pass(
        tf.data_ptr(), int(tf.dtype == torch.int32), doclen.data_ptr(),
        df.data_ptr(), valid.data_ptr(), n, t, nd_ptr, nd_bits, *bits,
        acc.data_ptr(), out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "bm25_pass")
    B.count_launch("bm25_pass")
    return out


def bm25_sums(doclen, valid):
    """K16's first half (`yt_bm25_sums`): int64 [2] on the block's device,
    the valid rows' doclen summed exactly and their count. A mesh cell's
    sums add over the doc axis before bm25_rows."""
    if doclen.device.type == "cpu":
        return bm25_sums_plain(doclen, valid)
    from ..kernels import build as B
    dev = doclen.device
    B.require(doclen, "doclen", (torch.int32,), 1, dev)
    B.require(valid, "valid", (torch.bool,), 1, dev)
    if valid.shape[0] != doclen.shape[0]:
        raise ValueError("doclen and valid must be [n]")
    acc = torch.empty(2, dtype=torch.int64, device=dev)
    rc = B.library().yt_bm25_sums(doclen.data_ptr(), valid.data_ptr(),
                                  doclen.shape[0], acc.data_ptr(),
                                  B.stream_ptr(dev))
    B.check(rc, "bm25_sums")
    B.count_launch("bm25_sums")
    return acc


def bm25_rows(tf, doclen, df, ndocs, valid, acc, k1: float = 1.2,
              b: float = 0.75):
    """K16's second half (`yt_bm25_rows`): [n] f32, each row's BM25 over
    the block's term columns (a mesh cell's own: its partial score, summed
    over the term axis) against the sums `acc` (int64 [2], bm25_sums' or
    their doc-axis total); -inf on invalid rows."""
    if tf.device.type == "cpu":
        return bm25_rows_plain(tf, doclen, df, ndocs, valid, acc, k1, b)
    from ..kernels import build as B
    dev = tf.device
    n, t, nd_ptr, nd_bits = _bm25_args(tf, doclen, df, ndocs, valid)
    B.require(acc, "acc", (torch.int64,), 1, dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    bits = [int(x.view(np.int32)) for x in _bm25_consts(k1, b)]
    rc = B.library().yt_bm25_rows(
        tf.data_ptr(), int(tf.dtype == torch.int32), doclen.data_ptr(),
        df.data_ptr(), valid.data_ptr(), n, t, nd_ptr, nd_bits, *bits,
        acc.data_ptr(), out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "bm25_rows")
    B.count_launch("bm25_rows")
    return out


def bm25_topk(tf, doclen, df, ndocs, valid, docids, k: int,
              k1: float = 1.2, b: float = 0.75, device=None):
    """BM25 over a dense [docs, terms] block (K16) + top-k (kernel 3):
    (scores [k] f32, docids [k]). Tensors stay on their device; numpy
    arrays go to it, or to `device` (None: the CUDA device, raising
    without one)."""
    arrays = (tf, doclen, df, valid, docids)
    dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
               None) or resolve_device(device)
    tf, doclen, df, valid, docids = (
        a if isinstance(a, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in arrays)
    score = bm25_scores(tf, doclen, df, ndocs, valid, k1, b)
    s, d, _ = tie_topk(score, k, payload=docids)
    return s, d


def bm25_scores_np(tf: np.ndarray, doclen: np.ndarray, df: np.ndarray,
                   ndocs: int, k1: float = 1.2, b: float = 0.75) -> np.ndarray:
    """Numpy oracle (float64, identical math)."""
    tf = tf.astype(np.float64)
    dl = doclen.astype(np.float64)
    avgdl = dl.mean() if len(dl) else 1.0
    idf = np.log(1.0 + (ndocs - df + 0.5) / (df + 0.5))
    denom = tf + k1 * (1.0 - b + b * (dl / max(avgdl, 1e-6))[:, None])
    return (idf[None, :] * tf * (k1 + 1.0) / np.maximum(denom, 1e-9)).sum(axis=1)
