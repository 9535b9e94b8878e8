"""Dense semantic encoding and the hybrid rerank: port of
yacy_search_server_tpu/ops/dense.py.

A first-stage sparse search (the cardinal ranking) is followed by a dense
cosine rerank on the device. Document and query vectors are DIM-wide
(the encoder's width); the encoder is a deterministic signed feature hash
of words and character trigrams, L2-normalised, copied from the JAX
package bit for bit (numpy and zlib only).

The four device functions are thin calls into the kernels of
kernels/dense.py (K9 `dense_dot`, K10 `rerank_sort`, K11 `hybrid_blend`)
and kernel 3 `tie_topk`:

- `rerank_fwd_batch_packed` (JAX `_rerank_fwd_batch_packed_kernel`, the
  serving path's batched rerank over the device-resident forward index):
  K9 in gather mode with the boost epilogue, then K10;
- `dense_boost_topk` (the host-gather fallback): K9 over a contiguous
  block, then `tie_topk` in index mode;
- `hybrid_rerank_topk` / `hybrid_rerank_topk_batch` (the f32 blend of
  bench.py): K9's f32 similarities (the batch reads each doc row once
  for every query), K11, then `tie_topk` in index mode a slot.

Each takes numpy arrays or tensors: a tensor stays on its device, numpy
goes to `device` (None: the CUDA device, raising without one). On a CPU
tensor the kernels' plain versions run. The dot's order of summation is
fixed (kernels/dense.py), so the card's answers equal the plain
versions' to the bit; against the JAX package's XLA dot they differ by a
few units of the rounded boost, which is the caveat the JAX oracles state.
"""

from __future__ import annotations

from zlib import crc32

import numpy as np
import torch

from .. import resolve_device

DIM = 256
_SEED = 0x5EED
# bump when the feature hash or the embedding changes: stored doc vectors
# must be re-encoded to stay comparable with query vectors
ENCODER_VERSION = 2
# the dense similarity enters the cardinal integer domain as an additive
# boost of a fixed scale (one maxed-out cardinal signal, 255 << 15)
DENSE_BOOST_SCALE = float(255 << 15)
# candidate-lane buckets of one rerank slot (pow2, at least 16); pad
# lanes carry n_valid's mask
RERANK_MAX_N = 1 << 14
NEG = -(2 ** 31 - 1)


def _stable_hash(s: str) -> int:
    """Deterministic 32-bit hash (zlib.crc32; Python's hash() is salted
    per process)."""
    return crc32(s.encode("utf-8"))


class HashingEncoder:
    """Signed feature hashing of word and char-trigram features into `dim`
    buckets, L2-normalised: deterministic across processes and peers. One
    `np.add.at` scatter a text (a batch), applied in feature order, behind
    a bounded (word -> buckets, signed weights) cache."""

    _CACHE_MAX = 1 << 18

    def __init__(self, dim: int = DIM):
        self.dim = dim
        self._cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def _word_arrays(self, w: str):
        """One word's (buckets, signed weights): the word feature, then
        its char trigrams."""
        got = self._cache.get(w)
        if got is not None:
            return got
        feats = ["w:" + w]
        wts = [1.0]
        padded = f"^{w}$"
        for i in range(len(padded) - 2):
            feats.append("t:" + padded[i:i + 3])
            wts.append(0.5)
        bs = np.empty(len(feats), dtype=np.int64)
        sg = np.empty(len(feats), dtype=np.float32)
        for j, f in enumerate(feats):
            h = _stable_hash(f)
            bs[j] = (h >> 1) % self.dim
            sg[j] = (1.0 if (h & 1) else -1.0) * wts[j]
        if len(self._cache) > self._CACHE_MAX:
            self._cache.clear()
        got = (bs, sg)
        self._cache[w] = got
        return got

    def _feature_arrays(self, text: str):
        words = [w for w in text.lower().split() if w][:512]
        if not words:
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.float32))
        parts = [self._word_arrays(w) for w in words]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    def encode(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, dtype=np.float32)
        b, w = self._feature_arrays(text)
        if len(b):
            np.add.at(v, b, w)
        n = float(np.linalg.norm(v))
        return v / n if n > 0 else v

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        """Every row bit-identical to encode()."""
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        v = np.zeros((len(texts), self.dim), dtype=np.float32)
        rows, cols, wts = [], [], []
        for i, t in enumerate(texts):
            b, w = self._feature_arrays(t)
            if len(b):
                rows.append(np.full(len(b), i, dtype=np.int64))
                cols.append(b)
                wts.append(w)
        if rows:
            np.add.at(v, (np.concatenate(rows), np.concatenate(cols)),
                      np.concatenate(wts))
        for i in range(len(texts)):
            n = float(np.linalg.norm(v[i]))
            if n > 0:
                v[i] /= n
        return v


def rerank_bucket(n: int) -> int:
    """The candidate-lane bucket of one rerank slot."""
    return 1 << max(4, (max(n, 1) - 1).bit_length())


def pack_rerank_row(qvec: np.ndarray, sparse_scores: np.ndarray,
                    docids: np.ndarray, alpha: float, nb: int) -> np.ndarray:
    """One slot's int32 descriptor: [n_valid, alpha bits, docids[nb],
    sparse[nb], qvec bits[dim]]."""
    n = len(docids)
    dim = len(qvec)
    row = np.zeros(2 + 2 * nb + dim, np.int32)
    row[0] = n
    row[1] = np.float32(alpha).view(np.int32)
    row[2:2 + n] = np.asarray(docids, np.int32)
    row[2 + nb:2 + nb + n] = np.asarray(sparse_scores, np.int32)
    row[2 + 2 * nb:] = np.asarray(qvec, np.float32).view(np.int32)
    return row


# -- the device functions ------------------------------------------------------

_NP = {torch.float32: np.float32, torch.int32: np.int32,
       torch.bool: np.bool_}


def _tensor(a, dtype, dev) -> torch.Tensor:
    """`a` as a contiguous tensor of `dtype`: a tensor stays on its device,
    numpy goes to `dev`."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a, dtype=_NP[dtype])).to(dev)


def _place(device, *arrays):
    """The device of the first tensor among `arrays`, else `device`."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(device)


def _docs(doc_vecs, dev) -> torch.Tensor:
    """Doc vectors as K9 reads them: f16, the forward index's type (a
    tensor stays on its device, numpy goes to `dev`)."""
    on_host = not isinstance(doc_vecs, torch.Tensor)
    t = torch.from_numpy(np.ascontiguousarray(doc_vecs)) if on_host \
        else doc_vecs
    if t.dtype != torch.float16:
        raise TypeError(f"doc vectors: dtype {t.dtype}, expected f16 (the "
                        "forward index's type)")
    return t.contiguous().to(dev) if on_host else t.contiguous()


def rerank_fwd_batch_packed(fwd: torch.Tensor, qi, nb: int) -> torch.Tensor:
    """The batched cardinal-domain rerank over the forward index `fwd`
    ([cap, DIM] f16 on its device): `qi` [bs, 2 + 2nb + DIM] int32
    descriptors (pack_rerank_row) -> [bs, 2nb] int32, each slot's scores
    then docids over all nb lanes, sorted by (score DESC, docid ASC), pad
    lanes last with score -(2^31-1). Candidates outside [0, cap) keep
    their sparse score (no boost)."""
    from ..kernels import dense as KDn
    qi = np.ascontiguousarray(qi, np.int32)
    live = int((qi[:, 0] > 0).sum())
    qd = KDn.upload_desc(qi, fwd.device)
    final = KDn.dense_gather_boost(fwd, qd, nb, live)
    return KDn.rerank_sort(final, qd, nb, live)


def dense_boost_topk(qvec, doc_vecs, sparse_scores, valid, alpha, k: int,
                     device=None):
    """final = sparse + round(cos * alpha * DENSE_BOOST_SCALE), -(2^31-1)
    off `valid`, over f16 doc_vecs [n, DIM]; the top k as (int32 scores
    [k], int32 rows [k]), ties to the lower row (lax.top_k)."""
    from ..kernels import dense as KDn
    from ..kernels.topk import tie_topk
    dev = _place(device, doc_vecs, qvec, sparse_scores, valid)
    docs = _docs(doc_vecs, dev)
    final = KDn.dense_rows_boost(
        docs, _tensor(qvec, torch.float32, dev),
        _tensor(sparse_scores, torch.int32, dev),
        _tensor(valid, torch.bool, dev), float(alpha))
    s, _, idx = tie_topk(final, k)
    return s, idx


def _blend_topk(sims, sparse_scores, valid, alpha, k, dev):
    from ..kernels import dense as KDn
    from ..kernels.topk import tie_topk
    final = KDn.hybrid_blend(sims, _tensor(sparse_scores, torch.float32, dev)
                             .view(sims.shape),
                             _tensor(valid, torch.bool, dev).view(sims.shape),
                             float(alpha))
    outs = [tie_topk(final[b], k) for b in range(final.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[2] for o in outs]))


def hybrid_rerank_topk(qvec, doc_vecs, sparse_scores, valid, alpha, k: int,
                       device=None):
    """final = (1 - alpha) * minmax(sparse over valid) + alpha * cos, -inf
    off `valid`, cos the bf16 dot of f16 doc_vecs [n, DIM] with f32
    accumulation; the top k as (f32 scores [k], int32 rows [k]), ties to
    the lower row."""
    from ..kernels import dense as KDn
    dev = _place(device, doc_vecs, qvec, sparse_scores, valid)
    sims = KDn.dense_sims(_docs(doc_vecs, dev),
                          _tensor(qvec, torch.float32, dev).view(1, -1))
    s, i = _blend_topk(sims, sparse_scores, valid, alpha, k, dev)
    return s[0], i[0]


def hybrid_rerank_topk_batch(qvecs, doc_vecs, sparse_scores, valid, alpha,
                             k: int, device=None):
    """B queries against one shared f16 doc matrix: qvecs [B, DIM],
    sparse and valid [B, N]; ([B, k] f32, [B, k] int32), slot i equal to
    hybrid_rerank_topk on slot i's inputs."""
    from ..kernels import dense as KDn
    dev = _place(device, doc_vecs, qvecs, sparse_scores, valid)
    sims = KDn.dense_sims(_docs(doc_vecs, dev),
                          _tensor(qvecs, torch.float32, dev))
    return _blend_topk(sims, sparse_scores, valid, alpha, k, dev)


# -- numpy oracles (the JAX package's, without ml_dtypes) ----------------------

def bf16_np(x) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest, ties to even), as
    float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def rerank_fwd_np(qvec, fwd, sparse_scores, docids, alpha):
    """CPU oracle of rerank_fwd_batch_packed (one slot): bf16-rounded
    inputs, an f32 dot in numpy's order (a few units of rounded boost
    from the kernel's), the same (score DESC, docid ASC) order."""
    docids = np.asarray(docids, np.int64)
    in_cov = (docids >= 0) & (docids < fwd.shape[0])
    dv = fwd[np.clip(docids, 0, fwd.shape[0] - 1)]
    sims = bf16_np(dv.astype(np.float32)) @ bf16_np(np.asarray(qvec))
    sims = np.where(in_cov, sims, 0.0).astype(np.float32)
    boost = np.round(sims * np.float32(alpha)
                     * np.float32(DENSE_BOOST_SCALE)).astype(np.int32)
    final = np.asarray(sparse_scores, np.int32) + boost
    order = np.lexsort((docids, -final.astype(np.int64)))
    return final[order], np.asarray(docids, np.int32)[order]


def dense_boost_topk_np(qvec, doc_vecs, sparse_scores, valid, alpha, k):
    """CPU oracle of dense_boost_topk (numpy's order of summation)."""
    sims = (bf16_np(np.asarray(doc_vecs, np.float32))
            @ bf16_np(np.asarray(qvec)))
    boost = np.round(sims.astype(np.float32) * np.float32(alpha)
                     * np.float32(DENSE_BOOST_SCALE)).astype(np.int32)
    final = np.asarray(sparse_scores).astype(np.int32) + boost
    final = np.where(valid, final, np.int32(NEG))
    idx = np.argsort(-final.astype(np.int64), kind="stable")[:k]
    return final[idx], idx


def hybrid_rerank_topk_np(qvec, doc_vecs, sparse_scores, valid, alpha, k):
    """CPU oracle of hybrid_rerank_topk (an f32 cosine, no bf16 rounding,
    as the JAX package's)."""
    sims = doc_vecs.astype(np.float32) @ qvec.astype(np.float32)
    s = sparse_scores.astype(np.float32)
    sv = s[valid]
    smin = sv.min() if sv.size else 0.0
    smax = sv.max() if sv.size else 0.0
    span = max(smax - smin, 1e-6)
    s_norm = np.where(valid, (s - smin) / span, 0.0)
    final = (1.0 - alpha) * s_norm + alpha * sims
    final = np.where(valid, final, -np.inf)
    idx = np.argsort(-final, kind="stable")[:k]
    return final[idx], idx
