"""Doc-sharded query execution and the candidate-fusion collective.

Port of yacy_search_server_tpu/parallel/mesh.py. There the query step is
one `shard_map` program over a ('term', 'doc') TPU mesh: each cell
computes local statistics, merges them with pmin/pmax/psum, scores, takes
its exact local top-k, and the candidate-fusion collective gathers the k
rows of every cell and merges them under (score DESC, docid ASC).

Here a `DocMesh` is a list of `n_term * n_doc` cell devices, cell t *
n_doc + d at term row t and doc column d (index/meshstore.py's
placement), run from one process. A device may repeat in the list, as the
JAX tests' 8 virtual devices share one CPU: a 2 x 2 mesh fits on one
card. The shard bodies run per cell and call the port's hand-written
kernels on the cell's tensors; where the JAX body has
lax.pmin/pmax/psum/all_gather the mesh's collectives run over the cells'
tensors (`DocMesh.pmin`, `pmax`, `psum`, `reduce`, `all_gather`): each
cell's block is copied to its group's first device (nothing moves where
the devices repeat, a peer copy where they differ), reduced there in
cell order, and handed back per cell. They are communication only; no
compute of a shard body goes through a library call. The fusion merge is
the hand-written kernel 4 (`kernels.gather_topk`) over the cells' runs
in one buffer, the counterpart of the Pallas ring
`_all_gather_topk_pallas`. Across processes the collectives become
torch.distributed ones (NCCL on the card) feeding the same kernels; that
backend is not ported yet (the multi-process runtime's slice).

Parity contract, as in the JAX package: results are identical to the
single-device CardinalRanker on the same postings.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..index import postings as P
from ..kernels import gather_topk
from ..kernels import tie_topk as _tie_topk_kernel
from ..ops import ranking as R
from ..ops.streaming import merge_stats

NEG_INF_I32 = -(2**31 - 1)
AXES = ("term", "doc")


@dataclass
class DocMesh:
    """The cells of a ('term', 'doc') query mesh: one device a cell, cell
    t * n_doc + d (a device may repeat)."""

    devices: list = field(default_factory=list)
    n_doc: int = 1
    n_term: int = 1

    @property
    def device(self) -> torch.device:
        """The first cell's device (where a whole-mesh result lands)."""
        return self.devices[0]

    @property
    def n_cells(self) -> int:
        return self.n_term * self.n_doc

    def cell(self, t: int, d: int) -> int:
        return t * self.n_doc + d

    def groups(self, axes) -> list[list[int]]:
        """The cells that one collective over `axes` ("doc", "term" or
        ("term", "doc")) joins, each group in cell order."""
        axes = {axes} if isinstance(axes, str) else set(axes)
        if not axes or not axes <= set(AXES):
            raise ValueError(f"axes {axes}: a subset of {AXES}")
        if axes == set(AXES):
            return [list(range(self.n_cells))]
        if axes == {"doc"}:
            return [[self.cell(t, d) for d in range(self.n_doc)]
                    for t in range(self.n_term)]
        return [[self.cell(t, d) for t in range(self.n_term)]
                for d in range(self.n_doc)]

    def reduce(self, xs: list, axes, combine) -> list:
        """The collective of `combine` (a fold of two cells' values, in
        cell order) over `axes`: xs holds one value a cell (a tensor, or a
        tuple or dict of tensors; None: the cell takes no part), the
        result one a cell, on the cell's device."""
        out = [None] * self.n_cells
        for g in self.groups(axes):
            cells = [c for c in g if xs[c] is not None]
            if not cells:
                continue
            dev0 = self.devices[cells[0]]
            acc = xs[cells[0]]
            for c in cells[1:]:
                acc = combine(acc, _to(xs[c], dev0))
            for c in cells:
                out[c] = _to(acc, self.devices[c])
        return out

    def pmin(self, xs: list, axes) -> list:
        return self.reduce(xs, axes, torch.minimum)

    def pmax(self, xs: list, axes) -> list:
        return self.reduce(xs, axes, torch.maximum)

    def psum(self, xs: list, axes) -> list:
        return self.reduce(xs, axes, lambda a, b: a + b)

    def pmerge_stats(self, xs: list, axes) -> list:
        """The statistics' collective (col_min pmin, col_max pmax, the f32
        tf bounds pmin/pmax as floats, host counts psum): each cell's
        local_stats dict merged over `axes`."""
        return self.reduce(xs, axes, merge_stats)

    def all_gather(self, xs: list, axes) -> list:
        """Each group's blocks concatenated in cell order (tiled), one
        copy a cell."""
        out = [None] * self.n_cells
        for g in self.groups(axes):
            dev0 = self.devices[g[0]]
            cat = torch.cat([xs[c].to(dev0) for c in g])
            for c in g:
                out[c] = cat.to(self.devices[c])
        return out


def _to(x, dev):
    """A cell's value (tensor, tuple or dict of tensors) on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, dev) for v in x)
    return x


def make_mesh(n_doc: int | None = None, n_term: int = 1, devices=None,
              device=None) -> DocMesh:
    """A ('term', 'doc') mesh of n_term x n_doc cells. `devices`: one a
    cell in cell order (a device may repeat; n_doc None: all of them, at
    len(devices) // n_term columns); else every cell on `device` (None:
    the CUDA device, raising without one), n_doc 1 by default."""
    if n_term < 1 or (n_doc is not None and n_doc < 1):
        raise ValueError(f"mesh of {n_term} x {n_doc} cells")
    if devices is None:
        n_doc = 1 if n_doc is None else n_doc
        return DocMesh([resolve_device(device)] * (n_term * n_doc), n_doc,
                       n_term)
    devs = [torch.device(d) for d in devices]
    if not devs or len(devs) % n_term:
        raise ValueError(f"{len(devs)} devices not divisible by "
                         f"n_term={n_term}")
    if n_doc is None:
        n_doc = len(devs) // n_term
    if len(devs) < n_term * n_doc:
        raise ValueError(f"{len(devs)} devices for {n_term} x {n_doc} cells")
    return DocMesh(devs[:n_term * n_doc], n_doc, n_term)


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


def _cells(x) -> list:
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _gathered(local_s, local_d, dev):
    """The cells' runs in one [cells * run, 2] int32 block on `dev` (f32
    scores bit-cast): the all-gather of the fusion collective."""
    ss, ds = _cells(local_s), _cells(local_d)
    run = ss[0].shape[0]
    if any(s.shape[0] != run or d.shape[0] != run for s, d in zip(ss, ds)):
        raise ValueError("the cells' runs must have one length")
    block = torch.empty((len(ss) * run, 2), dtype=torch.int32, device=dev)
    for i, (s, d) in enumerate(zip(ss, ds)):
        col = s.view(torch.int32) if s.dtype == torch.float32 else s
        block[i * run:(i + 1) * run, 0].copy_(col)
        block[i * run:(i + 1) * run, 1].copy_(d)
    return block, run


def all_gather_topk(local_s, local_d, mesh: DocMesh, k: int):
    """Gather the cells' local top-k (one tensor, or a list of one run a
    cell) and merge with tie_topk."""
    gs = torch.cat([s.to(mesh.device) for s in _cells(local_s)])
    gd = torch.cat([d.to(mesh.device) for d in _cells(local_d)])
    return tie_topk(gs, gd, k)


def all_gather_topk_full(local_s, local_d, mesh: DocMesh):
    """The whole tie-ordered gather (no trim)."""
    gs = torch.cat([s.to(mesh.device) for s in _cells(local_s)])
    gd = torch.cat([d.to(mesh.device) for d in _cells(local_d)])
    return tie_topk(gs, gd, gs.shape[0])


def fused_gather_topk(local_s, local_d, mesh: DocMesh, k: int):
    """The fusion collective: the cells' tie-ordered local top-k (one
    tensor for one cell, or a list of one run a cell, all one length;
    scores int32, or f32 bit-cast) are copied into one [cells * run, 2]
    buffer on the mesh's first device, and kernel 4 merges the runs. A
    failure raises; there is no other path."""
    ss = _cells(local_s)
    is_float = ss[0].dtype != torch.int32
    if len(ss) == 1:
        col = ss[0].to(torch.float32).view(torch.int32) if is_float else ss[0]
        gs, gd, run = col, _cells(local_d)[0], col.shape[0]
    else:
        block, run = _gathered(ss, local_d, mesh.device)
        gs, gd = block[:, 0], block[:, 1]
    kk = min(k, gs.shape[0])
    gs, gd = gather_topk(gs, gd, kk, is_float, run_len=run)
    return (gs.view(torch.float32) if is_float else gs), gd


# ---------------------------------------------------------------------------
# shard bodies
# ---------------------------------------------------------------------------

def _cardinal_shard(cells, consts, mesh: DocMesh, *, k: int, num_hosts: int):
    """The sharded cardinal step over the doc axis: `cells` holds term row
    0's (feats, docids, valid, hostids) a doc column (the other term rows
    are replicas), `consts` one profile tensor a column. Kernel 1 a cell,
    the statistics' pmin/pmax/psum over the doc axis, kernel 2 and kernel
    3 (tie mode) a cell, kernel 4 over the columns' runs."""
    xs = [None] * mesh.n_cells
    for d, (feats, _dd, valid, hostids) in enumerate(cells):
        xs[mesh.cell(0, d)] = R.local_stats(feats, valid, hostids,
                                            num_hosts=num_hosts)
    merged = mesh.pmerge_stats(xs, "doc")
    runs_s, runs_d = [], []
    for d, (feats, docids, valid, hostids) in enumerate(cells):
        scores = R.cardinal_from_stats(feats, valid, hostids,
                                       merged[mesh.cell(0, d)], consts[d])
        s, dd = tie_topk(scores, docids, min(k, scores.shape[0]))
        runs_s.append(s)
        runs_d.append(dd)
    return fused_gather_topk(runs_s, runs_d, mesh, k)


def _bm25_shard(cells, mesh: DocMesh, *, k: int, k1: float, b: float):
    """The sharded BM25 step over the full mesh: `cells` holds each cell's
    (tf [rows, its term columns], doclen, df [its columns], ndocs, valid,
    docids). K16's sums a cell, their psum over the doc axis, K16's rows
    a cell against the merged sums (the cell's partial score), the
    partials' psum over the term axis (term row order), then kernel 3 (tie
    mode) a doc column and kernel 4 over the columns' runs. One cell: K16
    in one call (`bm25_pass`)."""
    if mesh.n_cells == 1:
        tf, dl, df, nd, valid, docids = cells[0]
        score = R.bm25_scores(tf, dl, df, nd, valid, k1, b)
        s, dd = tie_topk(score, docids, min(k, score.shape[0]))
        return fused_gather_topk(s, dd, mesh, k)
    acc = mesh.psum([R.bm25_sums(c[1], c[4]) for c in cells], "doc")
    part = [R.bm25_rows(c[0], c[1], c[2], c[3], c[4], acc[i], k1, b)
            for i, c in enumerate(cells)]
    score = mesh.psum(part, "term")
    runs_s, runs_d = [], []
    for d in range(mesh.n_doc):
        c = mesh.cell(0, d)
        s, dd = tie_topk(score[c], cells[c][5], min(k, score[c].shape[0]))
        runs_s.append(s)
        runs_d.append(dd)
    return fused_gather_topk(runs_s, runs_d, mesh, k)


# ---------------------------------------------------------------------------
# host-side wrappers
# ---------------------------------------------------------------------------

def _doc_shards(placed, mesh: DocMesh):
    """A whole placed block (feats, docids, valid, hostids, npad), as
    convert.placed_from_numpy gives it, as one view a doc column, each on
    its term row 0 cell's device."""
    feats, docids, valid, hostids, npad = placed
    per = npad // mesh.n_doc
    return [tuple(a[d * per:(d + 1) * per].to(mesh.devices[mesh.cell(0, d)])
                  for a in (feats, docids, valid, hostids))
            for d in range(mesh.n_doc)]


class MeshRanker:
    """Sharded CardinalRanker: pad to shard tiles, place, run, trim."""

    def __init__(self, mesh: DocMesh, profile: R.RankingProfile | None = None,
                 language: str = "en"):
        self.mesh = mesh
        self.n_doc = mesh.n_doc
        self.profile = profile or R.RankingProfile()
        self._consts = [R.profile_consts(self.profile,
                                         P.pack_language(language),
                                         mesh.devices[mesh.cell(0, d)])
                        for d in range(mesh.n_doc)]

    def place(self, plist: P.PostingsList, hosthashes=None):
        """Pad + upload a PostingsList, each doc column's rows to its
        cells' device (term row 0: the term axis only replicates the
        cardinal step); the device-resident tuple is reused across queries
        (steady-state path)."""
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
        per = npad // self.n_doc
        put = lambda a, d: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a[d * per:(d + 1) * per])).to(
            self.mesh.devices[self.mesh.cell(0, d)])
        return ([tuple(put(a, d) for a in (feats, docids, valid, hostids))
                 for d in range(self.n_doc)], npad)

    def rank_placed(self, placed, k: int = 10):
        """`placed`: place()'s, or a whole block as
        convert.placed_from_numpy gives it."""
        if len(placed) == 5:
            cells, npad = _doc_shards(placed, self.mesh), placed[4]
        else:
            cells, npad = placed
        s, d = _cardinal_shard(cells, self._consts, self.mesh, k=k,
                               num_hosts=npad)
        s, d = s.cpu().numpy(), d.cpu().numpy()
        keep = (d >= 0) & (s > NEG_INF_I32)
        return s[keep][:k], d[keep][:k]

    def rank(self, plist: P.PostingsList, hosthashes=None, k: int = 10):
        return self.rank_placed(self.place(plist, hosthashes), k=k)


class MeshBM25:
    """Sharded BM25 over a dense [docs, terms] tf block: cell (t, d) holds
    doc column d's rows of term block t's columns."""

    def __init__(self, mesh: DocMesh, k1: float = 1.2, b: float = 0.75):
        self.mesh = mesh
        self.n_doc = mesh.n_doc
        self.n_term = mesh.n_term
        self.k1, self.b = k1, b

    def place(self, tf: np.ndarray, doclen: np.ndarray, df: np.ndarray,
              ndocs: int, docids: np.ndarray):
        """One (tf, doclen, df, ndocs, valid, docids) a cell, in cell
        order, on the cell's device."""
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
        per, tper = npad // self.n_doc, tpad // self.n_term
        cells = []
        for ti in range(self.n_term):
            for d in range(self.n_doc):
                dev = self.mesh.devices[self.mesh.cell(ti, d)]
                put = lambda a: torch.from_numpy(  # noqa: E731
                    np.ascontiguousarray(a)).to(dev)
                rows = slice(d * per, (d + 1) * per)
                cols = slice(ti * tper, (ti + 1) * tper)
                cells.append((put(tf_p[rows, cols]), put(dl_p[rows]),
                              put(df_p[cols]),
                              torch.tensor(ndocs, dtype=torch.int32,
                                           device=dev),
                              put(valid[rows]), put(did_p[rows])))
        return cells

    def topk_placed(self, placed, k: int = 10):
        s, d = _bm25_shard(placed, self.mesh, k=k, k1=self.k1, b=self.b)
        s, d = s.cpu().numpy(), d.cpu().numpy()
        keep = (d >= 0) & np.isfinite(s)
        return s[keep][:k], d[keep][:k]

    def topk(self, tf, doclen, df, ndocs, docids, k: int = 10):
        return self.topk_placed(self.place(tf, doclen, df, ndocs, docids), k=k)
