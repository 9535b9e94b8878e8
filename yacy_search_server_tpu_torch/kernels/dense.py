"""The dense rerank's kernels: K9 `dense_dot`, K10 `rerank_sort`, K11
`hybrid_blend` (csrc/dense.cu), with their plain PyTorch versions.

- K9 `dense_dot` replaces the bf16 dot of the JAX package's ops/dense.py
  (`_rerank_fwd_batch_packed_kernel` :290, `dense_boost_topk` :218,
  `hybrid_rerank_topk` :150, `hybrid_rerank_topk_batch` :177): one warp a
  (slot, candidate) dot over DIM = 256, in three modes. `dense_gather_boost`
  gathers each candidate's row of the forward index from a slot's
  descriptor and adds the fixed-scale boost into its sparse score;
  `dense_rows_boost` does the same over a contiguous block of rows;
  `dense_sims` gives the f32 similarities of B queries against every row
  of one block, each row read once for all of them.
- K10 `rerank_sort` replaces the per-slot `lax.sort` of
  `_rerank_fwd_batch_packed_kernel`: each slot's nb lanes sorted on
  (-score, docid), pad lanes keyed INT32_MAX, stably; only the live
  prefix is sorted (one block a slot, or from nb = 1024 a thread-block
  cluster a slot merging its CTAs' runs through distributed shared
  memory), the pad lanes copied.
- K11 `hybrid_blend` replaces the min/max normalisation and blend of
  `hybrid_rerank_topk(_batch)`: final = (1 - alpha) * (s - min) / span +
  alpha * sims on the valid lanes, -inf elsewhere.

The dot's order of summation is fixed, so the kernel and its plain
version agree to the bit: every element is rounded to bf16 (to nearest,
ties to even: f16 -> f32 -> bf16 for the doc rows, f32 -> bf16 for the
query), each product of two bf16 values is exact in f32, lane l (of 32)
sums the products of elements 8l..8l+7 as ((p0+p1)+(p2+p3))+((p4+p5)+
(p6+p7)), and a 5-step xor butterfly (offsets 16, 8, 4, 2, 1) adds the
lanes: x[i] + x[i + h] for h = 16 .. 1. The boost is two f32 multiplies,
(sims * alpha) * DENSE_BOOST_SCALE, rounded half to even, then int32.
Non-finite vectors are outside that promise: the encoder L2-normalises
every vector.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build as B

DIM = 256
DENSE_BOOST_SCALE = float(255 << 15)
NEG = -(2 ** 31 - 1)
INT32_MAX = 2 ** 31 - 1
MAX_NB = 1 << 14          # lanes of one rerank slot (RERANK_MAX_N)
_PLAIN_ELEMS = 1 << 24    # products a plain step holds


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 (two's complement)."""
    return (((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bfloat16 (to nearest, ties to even), as float32."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def dot_plain(d: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The kernel's dot of bf16-rounded f32 rows `d` [..., 256] with
    bf16-rounded queries `q` (broadcast to d), in its order: [...] f32."""
    p = (d * q).view(*d.shape[:-1], 32, 8)
    a = p[..., 0::2] + p[..., 1::2]
    b = a[..., 0::2] + a[..., 1::2]
    s = b[..., 0] + b[..., 1]
    for h in (16, 8, 4, 2, 1):
        s = s[..., :h] + s[..., h:2 * h]
    return s[..., 0]


def boost_plain(sims: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """round((sims * alpha) * DENSE_BOOST_SCALE) as int64."""
    scale = torch.tensor(DENSE_BOOST_SCALE, dtype=torch.float32)
    return torch.round((sims * alpha) * scale).to(torch.int64)


def _check_docs(docs: torch.Tensor) -> None:
    if docs.dim() != 2 or docs.shape[1] != DIM:
        raise ValueError(f"doc vectors must be [n, {DIM}], got "
                         f"{tuple(docs.shape)}: the dot kernel is {DIM} wide")
    if docs.dtype != torch.float16:
        raise TypeError(f"doc vectors: dtype {docs.dtype}, expected f16 (the "
                        "forward index's type)")


def _aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned (the kernel reads "
                         "16 bytes a lane)")


# ---------------------------------------------------------------------------
# the rerank descriptor
# ---------------------------------------------------------------------------

def desc_nb(qd: torch.Tensor, nb: int) -> int:
    """Check a device descriptor [bs, 2 + 2nb + DIM] int32; returns bs."""
    if qd.dim() != 2 or qd.shape[1] != 2 + 2 * nb + DIM:
        raise ValueError(f"descriptor {tuple(qd.shape)} is not [bs, "
                         f"{2 + 2 * nb + DIM}] for nb={nb}")
    if not 16 <= nb <= MAX_NB or nb & (nb - 1):
        raise ValueError(f"nb={nb} is not a power of two in [16, {MAX_NB}]")
    return qd.shape[0]


def upload_desc(qi, device) -> torch.Tensor:
    """A wave's numpy descriptors on `device`: on the card through pinned
    memory, copied on the current stream."""
    qi = np.ascontiguousarray(qi, np.int32)
    if qi.ndim != 2:
        raise ValueError("descriptors must be [bs, words]")
    host = torch.from_numpy(qi)
    if torch.device(device).type != "cuda":
        return host.clone().to(device)
    return host.pin_memory().to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# K9 dense_dot
# ---------------------------------------------------------------------------

def dense_gather_boost_plain(fwd, qd, nb: int) -> torch.Tensor:
    """Plain version of K9's gather mode: [bs, nb] int32 finals."""
    bs = desc_nb(qd, nb)
    cap = fwd.shape[0]
    nvalid = qd[:, 0:1].to(torch.int64)
    alpha = qd[:, 1:2].contiguous().view(torch.float32)
    docids = qd[:, 2:2 + nb].to(torch.int64)
    sparse = qd[:, 2 + nb:2 + 2 * nb].to(torch.int64)
    q = bf16(qd[:, 2 + 2 * nb:].contiguous().view(torch.float32))
    in_cov = (docids >= 0) & (docids < cap)
    sims = torch.zeros((bs, nb), dtype=torch.float32, device=fwd.device)
    step = max(1, _PLAIN_ELEMS // (nb * DIM))
    for b0 in range(0, bs, step):
        rows = fwd[docids[b0:b0 + step].clamp(0, cap - 1)]
        sims[b0:b0 + step] = dot_plain(bf16(rows), q[b0:b0 + step, None, :])
    sims = torch.where(in_cov, sims, torch.zeros_like(sims))
    final = _wrap32(sparse + boost_plain(sims, alpha))
    valid = torch.arange(nb, device=fwd.device)[None, :] < nvalid
    return torch.where(valid, final, torch.full_like(final, NEG))


def dense_gather_boost(fwd, qd, nb: int, live: int | None = None):
    """K9, gather mode: for each slot of the device descriptor `qd` (see
    ops/dense.pack_rerank_row) and each lane below its n_valid, the dot of
    fwd[docid] ([cap, 256] f16) with the slot's query, 0 for a docid
    outside [0, cap), and final = sparse + round((dot * alpha) * SCALE);
    -(2^31-1) on the other lanes. [bs, nb] int32. `live`: the slots with
    candidates (counted; default bs), as the caller knows them from its
    host copy of the descriptor."""
    bs = desc_nb(qd, nb)
    if fwd.device.type == "cpu":
        return dense_gather_boost_plain(fwd, qd, nb)
    dev = fwd.device
    B.require(fwd, "fwd", (torch.float16,), 2, dev)
    if fwd.shape[1] != DIM:
        raise ValueError(f"fwd must be [cap, {DIM}]")
    _aligned(fwd, "fwd")
    B.require(qd, "descriptor", (torch.int32,), 2, dev)
    out = torch.empty((bs, nb), dtype=torch.int32, device=dev)
    rc = B.library().yt_dense_gather(fwd.data_ptr(), fwd.shape[0],
                                     qd.data_ptr(), bs, nb, out.data_ptr(),
                                     B.stream_ptr(dev))
    B.check(rc, "dense_dot")
    B.count_launch("dense_dot", slots=bs if live is None else live)
    return out


def dense_rows_boost_plain(docs, qvec, sparse, valid, alpha: float):
    """Plain version of K9's block mode: [n] int32 finals."""
    q = bf16(qvec.to(torch.float32))
    sims = torch.empty(docs.shape[0], dtype=torch.float32,
                       device=docs.device)
    step = max(1, _PLAIN_ELEMS // DIM)
    for r0 in range(0, docs.shape[0], step):
        sims[r0:r0 + step] = dot_plain(bf16(docs[r0:r0 + step]), q)
    a = torch.tensor(alpha, dtype=torch.float32)
    final = _wrap32(sparse.to(torch.int64) + boost_plain(sims, a))
    return torch.where(valid, final, torch.full_like(final, NEG))


def dense_rows_boost(docs, qvec, sparse, valid, alpha: float):
    """K9, block mode: final[i] = sparse[i] + round((dot(docs[i], qvec) *
    alpha) * SCALE) where valid[i], else -(2^31-1). docs [n, 256] f16,
    qvec [256] f32, sparse [n] int32, valid [n] bool; [n] int32."""
    _check_docs(docs)
    n = docs.shape[0]
    if qvec.shape != (DIM,) or sparse.shape != (n,) or valid.shape != (n,):
        raise ValueError("qvec must be [256], sparse and valid [n]")
    if docs.device.type == "cpu":
        return dense_rows_boost_plain(docs, qvec, sparse, valid, alpha)
    dev = docs.device
    B.require(docs, "docs", (torch.float16,), 2, dev)
    _aligned(docs, "docs")
    B.require(qvec, "qvec", (torch.float32,), 1, dev)
    B.require(sparse, "sparse", (torch.int32,), 1, dev)
    B.require(valid, "valid", (torch.bool,), 1, dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        rc = B.library().yt_dense_rows(
            docs.data_ptr(), n, qvec.data_ptr(), sparse.data_ptr(), valid.data_ptr(),
            _f32_bits(alpha), out.data_ptr(), B.stream_ptr(dev))
        B.check(rc, "dense_dot")
        B.count_launch("dense_dot")
    return out


def dense_sims_plain(docs, qvecs):
    """Plain version of K9's similarity mode: [B, n] f32."""
    q = bf16(qvecs.to(torch.float32))
    out = torch.empty((q.shape[0], docs.shape[0]), dtype=torch.float32,
                      device=docs.device)
    step = max(1, _PLAIN_ELEMS // DIM)
    for r0 in range(0, docs.shape[0], step):
        d = bf16(docs[r0:r0 + step])
        for b in range(q.shape[0]):
            out[b, r0:r0 + step] = dot_plain(d, q[b])
    return out


def dense_sims(docs, qvecs):
    """K9, similarity mode: sims[b, i] = dot(docs[i], qvecs[b]) in f32,
    docs [n, 256] f16, qvecs [B, 256] f32; each doc row is read
    once for up to 32 queries. [B, n] f32."""
    _check_docs(docs)
    if qvecs.dim() != 2 or qvecs.shape[1] != DIM:
        raise ValueError(f"qvecs must be [B, {DIM}]")
    if docs.device.type == "cpu":
        return dense_sims_plain(docs, qvecs)
    dev = docs.device
    B.require(docs, "docs", (torch.float16,), 2, dev)
    _aligned(docs, "docs")
    B.require(qvecs, "qvecs", (torch.float32,), 2, dev)
    nq, n = qvecs.shape[0], docs.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    if n and nq:
        rc = B.library().yt_dense_sims(
            docs.data_ptr(), n, qvecs.data_ptr(), nq, out.data_ptr(),
            B.stream_ptr(dev))
        B.check(rc, "dense_dot")
        B.count_launch("dense_dot", slots=nq)
    return out


def _f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.int32))


# ---------------------------------------------------------------------------
# K10 rerank_sort
# ---------------------------------------------------------------------------

def rerank_sort_plain(final, qd, nb: int) -> torch.Tensor:
    """Plain version of K10: [bs, 2nb] int32."""
    bs = desc_nb(qd, nb)
    lanes = torch.arange(nb, device=final.device)
    valid = lanes[None, :] < qd[:, 0:1].to(torch.int64)
    docids = qd[:, 2:2 + nb]
    skey = _wrap32(-final.to(torch.int64)).to(torch.int64)
    tkey = torch.where(valid, docids, torch.full_like(docids, INT32_MAX))
    key = skey * 2 ** 32 + (tkey.to(torch.int64) + 2 ** 31)
    order = torch.argsort(key, dim=1, stable=True)
    return torch.cat([torch.gather(final, 1, order),
                      torch.gather(docids, 1, order)], dim=1).reshape(
                          bs, 2 * nb)


def rerank_sort(final, qd, nb: int, live: int | None = None):
    """K10: each slot's nb lanes of `final` ([bs, nb] int32) with their
    docids (from the descriptor `qd`), sorted ascending on (-final
    wrapping, docid; INT32_MAX on lanes at or past n_valid), stably:
    [bs, 2nb] int32, the sorted finals then the sorted docids, pad lanes
    included, as lax.sort lays them out. `live` as dense_gather_boost's."""
    bs = desc_nb(qd, nb)
    if final.shape != (bs, nb):
        raise ValueError(f"final must be [{bs}, {nb}]")
    if final.device.type == "cpu":
        return rerank_sort_plain(final, qd, nb)
    dev = final.device
    B.require(final, "final", (torch.int32,), 2, dev)
    B.require(qd, "descriptor", (torch.int32,), 2, dev)
    out = torch.empty((bs, 2 * nb), dtype=torch.int32, device=dev)
    rc = B.library().yt_rerank_sort(final.data_ptr(), qd.data_ptr(), bs, nb,
                                    out.data_ptr(), B.stream_ptr(dev))
    B.check(rc, "rerank_sort")
    B.count_launch("rerank_sort", slots=bs if live is None else live)
    return out


# ---------------------------------------------------------------------------
# K11 hybrid_blend
# ---------------------------------------------------------------------------

def hybrid_blend_plain(sims, sparse, valid, alpha: float) -> torch.Tensor:
    """Plain version of K11: [B, n] f32."""
    big = torch.tensor(1e30, dtype=torch.float32)
    smin = torch.where(valid, sparse, big).amin(dim=1, keepdim=True)
    smax = torch.where(valid, sparse, -big).amax(dim=1, keepdim=True)
    span = torch.clamp_min(smax - smin, 1e-6)
    a = torch.tensor(alpha, dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    final = (one - a) * ((sparse - smin) / span) + a * sims
    return torch.where(valid, final, torch.full_like(final, -float("inf")))


def hybrid_blend(sims, sparse, valid, alpha: float) -> torch.Tensor:
    """K11: per slot b, smin / smax the min / max of sparse[b] over the
    valid lanes (1e30 / -1e30 for each other lane, as the reference's
    masked min and max), span = max(smax - smin, 1e-6), and final =
    (1 - alpha) * ((s - smin) / span) + alpha * sims on valid lanes, -inf
    elsewhere. sims, sparse [B, n] f32, valid [B, n] bool; [B, n] f32."""
    if sims.dim() != 2 or sparse.shape != sims.shape \
            or valid.shape != sims.shape:
        raise ValueError("sims, sparse and valid must be one [B, n] shape")
    if sims.device.type == "cpu":
        return hybrid_blend_plain(sims, sparse, valid, alpha)
    dev = sims.device
    B.require(sims, "sims", (torch.float32,), 2, dev)
    B.require(sparse, "sparse", (torch.float32,), 2, dev)
    B.require(valid, "valid", (torch.bool,), 2, dev)
    nq, n = sims.shape
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    if not n or not nq:
        return out
    lib = B.library()
    scratch = torch.empty(int(lib.yt_hybrid_blend_scratch_bytes(n, nq)),
                          dtype=torch.uint8, device=dev)
    rc = lib.yt_hybrid_blend(sims.data_ptr(), sparse.data_ptr(),
                             valid.data_ptr(), n, nq, _f32_bits(alpha),
                             scratch.data_ptr(), out.data_ptr(),
                             B.stream_ptr(dev))
    B.check(rc, "hybrid_blend")
    B.count_launch("hybrid_blend", slots=nq)
    return out
