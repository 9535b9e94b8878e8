"""Doc-sharded query execution and the candidate-fusion collective.

Port of yacy_search_server_tpu/parallel/mesh.py. There the query step is
one `shard_map` program over a ('term', 'doc') TPU mesh: each doc shard
computes local statistics, merges them with pmin/pmax/psum, scores, takes
its exact local top-k, and the candidate-fusion collective gathers the k
rows of every shard and merges them under (score DESC, docid ASC).

Here a `DocMesh` names the device and the group sizes. This version runs
one card (n_doc = n_term = 1), where pmin/pmax/psum are identities and the
gather is the local block itself; the fusion merge is the hand-written
kernel 4 (`kernels.gather_topk`), the counterpart of the Pallas ring
`_all_gather_topk_pallas`. Across cards the gather becomes an NCCL
all-gather feeding the same kernel, one sorted run per card (not yet
ported: larger meshes raise).

Parity contract, as in the JAX package: results are identical to the
single-device CardinalRanker on the same postings.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..convert import placed_from_numpy
from ..index import postings as P
from ..kernels import gather_topk
from ..kernels import tie_topk as _tie_topk_kernel
from ..ops import ranking as R

NEG_INF_I32 = -(2**31 - 1)


@dataclass
class DocMesh:
    """The device and the doc/term group sizes of the query mesh."""

    device: torch.device
    n_doc: int = 1
    n_term: int = 1


def make_mesh(n_doc: int = 1, n_term: int = 1, device=None) -> DocMesh:
    """A one-card mesh; more cards need the NCCL gather (not yet ported)."""
    if n_doc != 1 or n_term != 1:
        raise NotImplementedError(
            "the port's mesh runs one card (n_doc = n_term = 1); the "
            "multi-card NCCL gather is not ported yet")
    return DocMesh(resolve_device(device), n_doc, n_term)


def pad_to_shards(n: int, shards: int, tile: int = 128) -> int:
    """Round n up so every shard holds a whole number of tiles (min 1)."""
    per = max(tile, ((n + shards - 1) // shards + tile - 1) // tile * tile)
    return per * shards


# ---------------------------------------------------------------------------
# candidate fusion
# ---------------------------------------------------------------------------

def tie_topk(scores, docids, k: int):
    """Exact top-k of (scores, docids) under (score DESC, docid ASC),
    int32 or f32 scores (kernel 3, tie mode)."""
    kk = min(k, scores.shape[0])
    s, d, _ = _tie_topk_kernel(scores, kk, secondary=docids)
    return s, d


def _gather(mesh: DocMesh, local):
    """The doc-axis all-gather: on one card, the local block itself."""
    if mesh.n_doc != 1:
        raise NotImplementedError("multi-card gather not ported yet")
    return local


def all_gather_topk(local_s, local_d, mesh: DocMesh, k: int):
    """Gather each shard's local top-k and merge with tie_topk."""
    return tie_topk(_gather(mesh, local_s), _gather(mesh, local_d), k)


def all_gather_topk_full(local_s, local_d, mesh: DocMesh):
    """The whole tie-ordered gather (no trim)."""
    gs, gd = _gather(mesh, local_s), _gather(mesh, local_d)
    return tie_topk(gs, gd, gs.shape[0])


def fused_gather_topk(local_s, local_d, mesh: DocMesh, k: int):
    """The fusion collective: each shard's tie-ordered local top-k (scores
    as int32, f32 bit-cast) is gathered, one run per shard, and merged by
    kernel 4. A failure raises; there is no other path."""
    is_float = local_s.dtype != torch.int32
    col = local_s.to(torch.float32).view(torch.int32) if is_float else local_s
    gs, gd = _gather(mesh, col), _gather(mesh, local_d)
    kk = min(k, gs.shape[0])
    gs, gd = gather_topk(gs, gd, kk, is_float, run_len=col.shape[0])
    return (gs.view(torch.float32) if is_float else gs), gd


# ---------------------------------------------------------------------------
# shard bodies
# ---------------------------------------------------------------------------

def _cardinal_shard(feats, docids, valid, hostids, consts, mesh: DocMesh,
                    *, k: int, num_hosts: int):
    st = R.local_stats(feats, valid, hostids, num_hosts=num_hosts)
    # pmin/pmax/psum over the doc axis: identities on one card
    scores = R.cardinal_from_stats(feats, valid, hostids, st, consts)
    local_s, local_d = tie_topk(scores, docids, min(k, scores.shape[0]))
    return fused_gather_topk(local_s, local_d, mesh, k)


def _bm25_shard(tf, doclen, df, ndocs, valid, docids, mesh: DocMesh, *,
                k: int, k1: float, b: float):
    # psum over the doc and term axes: identities on one card
    score = R.bm25_scores(tf, doclen, df, ndocs, valid, k1, b)
    local_s, local_d = tie_topk(score, docids, min(k, score.shape[0]))
    return fused_gather_topk(local_s, local_d, mesh, k)


# ---------------------------------------------------------------------------
# host-side wrappers
# ---------------------------------------------------------------------------

class MeshRanker:
    """Sharded CardinalRanker: pad to shard tiles, place, run, trim."""

    def __init__(self, mesh: DocMesh, profile: R.RankingProfile | None = None,
                 language: str = "en"):
        self.mesh = mesh
        self.n_doc = mesh.n_doc
        self.profile = profile or R.RankingProfile()
        self._consts = R.profile_consts(self.profile,
                                        P.pack_language(language),
                                        mesh.device)

    def place(self, plist: P.PostingsList, hosthashes=None):
        """Pad + upload a PostingsList; the device-resident tuple is reused
        across queries (steady-state path)."""
        n = len(plist)
        npad = pad_to_shards(max(n, 1), self.n_doc)
        feats = np.zeros((npad, P.NF), np.int32)
        docids = np.full(npad, -1, np.int32)
        valid = np.zeros(npad, bool)
        hostids = np.zeros(npad, np.int32)
        if n:
            feats[:n] = plist.feats
            docids[:n] = plist.docids
            valid[:n] = True
            if hosthashes is not None:
                hostids[:n] = R.hostid_array(plist.docids, hosthashes)
        return placed_from_numpy(feats, docids, valid, hostids, npad,
                                 self.mesh.device)

    def rank_placed(self, placed, k: int = 10):
        feats, docids, valid, hostids, npad = placed
        s, d = _cardinal_shard(feats, docids, valid, hostids, self._consts,
                               self.mesh, k=k, num_hosts=npad)
        s, d = s.cpu().numpy(), d.cpu().numpy()
        keep = (d >= 0) & (s > NEG_INF_I32)
        return s[keep][:k], d[keep][:k]

    def rank(self, plist: P.PostingsList, hosthashes=None, k: int = 10):
        return self.rank_placed(self.place(plist, hosthashes), k=k)


class MeshBM25:
    """Sharded BM25 over a dense [docs, terms] tf block."""

    def __init__(self, mesh: DocMesh, k1: float = 1.2, b: float = 0.75):
        self.mesh = mesh
        self.n_doc = mesh.n_doc
        self.n_term = mesh.n_term
        self.k1, self.b = k1, b

    def place(self, tf: np.ndarray, doclen: np.ndarray, df: np.ndarray,
              ndocs: int, docids: np.ndarray):
        n, t = tf.shape
        npad = pad_to_shards(max(n, 1), self.n_doc)
        tpad = max(self.n_term, ((t + self.n_term - 1) // self.n_term)
                   * self.n_term)
        tf_p = np.zeros((npad, tpad), np.float32)
        tf_p[:n, :t] = tf
        dl_p = np.zeros(npad, np.int32)
        dl_p[:n] = doclen
        df_p = np.zeros(tpad, np.int32)
        df_p[:t] = df
        valid = np.zeros(npad, bool)
        valid[:n] = True
        did_p = np.full(npad, -1, np.int32)
        did_p[:n] = docids
        dev = self.mesh.device
        put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return (put(tf_p), put(dl_p), put(df_p),
                torch.tensor(ndocs, dtype=torch.int32, device=dev),
                put(valid), put(did_p))

    def topk_placed(self, placed, k: int = 10):
        s, d = _bm25_shard(*placed, self.mesh, k=k, k1=self.k1, b=self.b)
        s, d = s.cpu().numpy(), d.cpu().numpy()
        keep = (d >= 0) & np.isfinite(s)
        return s[keep][:k], d[keep][:k]

    def topk(self, tf, doclen, df, ndocs, docids, k: int = 10):
        return self.topk_placed(self.place(tf, doclen, df, ndocs, docids), k=k)
