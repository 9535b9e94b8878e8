"""The IVF ANN vector index: port of yacy_search_server_tpu/index/annstore.py.

Doc vectors live int8-quantized (a per-vector f16 scale, the dequant
fused into the scoring kernel, ops/ann.py) in contiguous per-cluster
slabs, so probing a cluster is a contiguous window of rows. The build
(k-means over a strided sample, the full assignment, the quantization
and the scatter into cluster order) is the JAX package's numpy, line for
line, so both packages lay out the same index from the same source and
seed; `convert.ann_from_numpy` carries a built JAX index over.

Residency is a hot/warm ladder: clusters placed in the hot arena (up to
the index's own `device_budget_bytes`, greedily by cluster id up to
HOT_FILL_FRACTION of it at build, then by access through promotion) are
scored on the device by K15; the others ("warm": the slab is host
memory) are scored on the host by the numpy oracle. A warm cluster
probed PROMOTE_AFTER times is promoted: placed in the host mirror of the
arena and patched onto the device (the devstore's batcher `promote` kind,
or inline). The arena never evicts: vectors are immutable between
rebuilds.

The device copies (the centroid block, the hot arena) are torch tensors
on an explicit device. They are uploaded, and patched OUT OF PLACE (a
clone, then the pending ranges copied in), on a stream of the index's own
and recorded in an event that a reader's stream waits on before it
launches (index/dense.DenseVectorStore's rule): a wave issued on an older
arena keeps reading the rows it planned against. `hot_block` hands out a
snapshot with the row prefix it covers; a cluster promoted after it plans
as warm against it.

`centroid_version` bumps on every build AND every promotion (a promoted
cluster moves from the host oracle to the kernel, whose fused scores can
differ by a unit of rounded boost): the dense-first top-k cache keys on
it. Memory only: the JAX index's `data_dir` mmap (the cold tier) is not
ported, so the cold tier is empty, as the JAX index's is without one.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import resolve_device
from ..ops.ann import (ANN_DEFAULT_NPROBE, ANN_DEFAULT_PROBE_LANES,
                       ann_assign_np, ann_fuse_np, merge_fused)


def quantize_rows(vecs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-vector symmetric int8 quantization: ``q = round(v/scale)``
    with ``scale = max|v| / 127`` (f16-rounded so device and host
    dequantize identically). Zero vectors quantize to zeros, scale 0."""
    v = np.asarray(vecs, np.float32)
    amax = np.abs(v).max(axis=1)
    scale = (amax / 127.0).astype(np.float16)
    s32 = scale.astype(np.float32)
    safe = np.where(s32 > 0, s32, 1.0)
    q = np.clip(np.round(v / safe[:, None]), -127, 127).astype(np.int8)
    return q, scale


class AnnVectorIndex:
    """Clustered int8 vector index over one segment's doc embeddings."""

    # host-scored accesses before a warm cluster is promotion material
    PROMOTE_AFTER = 2
    # share of the hot arena the build's greedy fill may take; promotion
    # fills the rest by observed access
    HOT_FILL_FRACTION = 0.75

    def __init__(self, dim: int, device=None,
                 device_budget_bytes: int = 1 << 30):
        self.dim = dim
        # where the hot arena and the centroids live (None: the CUDA
        # device, raising without one)
        self.device = resolve_device(device)
        self.device_budget_bytes = int(device_budget_bytes)
        self._lock = threading.RLock()
        # serializes device uploads and patches without holding the index
        # lock across them
        self._upload_lock = threading.Lock()
        self.built = False
        # bumps on every build and every hot promotion: the dense-first
        # cache key
        self.centroid_version = 0
        # bumps only on a build: the layout a plan's offsets are valid
        # against
        self.layout_version = 0
        self.centroids: np.ndarray | None = None    # (C, dim) f32
        self._cent_dev = None        # (tensor, event) on _cent_dev_device
        self._cent_dev_device = None
        self._cent_dev_version = -1
        self._slab = None            # (n, dim) int8
        self._scales = None          # (n,) f16
        self._sdocids = None         # (n,) int32 slab row -> docid
        self._cstart = None          # (C,) int64
        self._ccount = None          # (C,) int64
        self._row_of = None          # (max_docid+1,) int32 docid -> row
        # the hot arena: its host mirror and device copies
        self._hot_cap = 0
        self._hot_used = 0
        self._hot_slab = None
        self._hot_scales = None
        self._hot_docids = None
        self._hot_map: dict[int, int] = {}    # cid -> hot start row
        self._hot_dev = None         # (slab, scales, docids) tensors
        self._hot_dev_device = None
        self._hot_written = None     # the event after their writes
        self._hot_pending: list[tuple[int, int]] = []   # not uploaded yet
        self._wstreams: dict = {}    # device -> the index's write stream
        self._access: dict[int, int] = {}
        self._promote_inflight: set[int] = set()
        # counters (devstore.counters -> ann_*)
        self.tier_hot_hits = 0
        self.tier_warm_hits = 0
        self.tier_cold_hits = 0
        self.promotions = 0
        self.promote_failures = 0
        self.lane_drops = 0          # whole clusters past the lane budget
        self.patches = 0             # hot arenas patched out of place

    # -- build ---------------------------------------------------------------

    @property
    def row_bytes(self) -> int:
        return self.dim + 2 + 4      # int8 row + f16 scale + int32 docid

    def n_vectors(self) -> int:
        return 0 if self._sdocids is None else len(self._sdocids)

    def n_clusters(self) -> int:
        with self._lock:
            return 0 if self._ccount is None else len(self._ccount)

    def build_from_dense(self, dense, n_clusters: int | None = None,
                         **kw) -> None:
        """Build over a DenseVectorStore's vectors (docid-aligned: slab row
        i of docid d carries dense._vecs[d])."""
        with dense._lock:
            n = dense._n
            vecs = dense._vecs[:n].astype(np.float32)
        self.build(lambda i0, i1: vecs[i0:i1], n,
                   n_clusters=n_clusters, **kw)

    def build(self, source, n: int, docids: np.ndarray | None = None,
              n_clusters: int | None = None, sample_n: int = 65536,
              iters: int = 3, seed: int = 0,
              chunk: int = 1 << 18) -> None:
        """(Re)build the IVF layout. ``source(i0, i1) -> (i1-i0, dim)``
        float32, a chunk reader. Deterministic for a given (source, seed).
        Clusters lay out as contiguous slab row runs ordered by cluster
        id; within a cluster, source order."""
        if n <= 0:
            raise ValueError("cannot build an ANN index over 0 vectors")
        dim = self.dim
        ids = (np.arange(n, dtype=np.int64) if docids is None
               else np.asarray(docids, np.int64))
        C = n_clusters if n_clusters else max(1, min(4096, n // 2048))
        C = min(C, n)
        rng = np.random.default_rng(seed)
        # strided block sample for k-means (contiguous blocks keep the
        # source reads cheap; the stride keeps the head from biasing it)
        sn = min(sample_n, n)
        bsz = min(256, sn)
        nblocks = (sn + bsz - 1) // bsz
        blocks = []
        for bi in range(nblocks):
            off = ((bi * max(n - bsz, 0)) // max(1, nblocks - 1)
                   if nblocks > 1 else 0)
            blocks.append(np.asarray(source(off, min(off + bsz, n)),
                                     np.float32))
        sample = np.concatenate(blocks)[:sn]
        cent = sample[rng.choice(len(sample), C, replace=False)] \
            .astype(np.float32)
        for _ in range(max(0, iters)):
            a = np.argmax(sample @ cent.T, axis=1)
            for c in range(C):
                rows = sample[a == c]
                if len(rows):
                    m = rows.mean(axis=0)
                    nm = float(np.linalg.norm(m))
                    cent[c] = m / nm if nm > 0 else m
        # the full assignment, chunked (the one O(n*C*dim) pass)
        cids = np.empty(n, np.int32)
        for i0 in range(0, n, chunk):
            i1 = min(i0 + chunk, n)
            v = np.asarray(source(i0, i1), np.float32)
            cids[i0:i1] = np.argmax(v @ cent.T, axis=1)
        ccount = np.bincount(cids, minlength=C).astype(np.int64)
        cstart = np.zeros(C, np.int64)
        np.cumsum(ccount[:-1], out=cstart[1:])
        slab = np.zeros((n, dim), np.int8)
        scales = np.zeros(n, np.float16)
        sdocids = np.zeros(n, np.int32)
        cursor = cstart.copy()
        for i0 in range(0, n, chunk):
            i1 = min(i0 + chunk, n)
            q, s = quantize_rows(np.asarray(source(i0, i1), np.float32))
            cc = cids[i0:i1]
            # group the chunk's rows by cluster, each group to the next
            # run of its cluster's slab rows
            order = np.argsort(cc, kind="stable")
            uniq, uidx, ucnt = np.unique(cc[order], return_index=True,
                                         return_counts=True)
            dst = np.empty(i1 - i0, np.int64)
            for u, st, cnt in zip(uniq.tolist(), uidx.tolist(),
                                  ucnt.tolist()):
                grp = order[st:st + cnt]
                dst[grp] = cursor[u] + np.arange(cnt, dtype=np.int64)
                cursor[u] += cnt
            slab[dst] = q
            scales[dst] = s
            sdocids[dst] = ids[i0:i1]
        row_of = np.full(int(ids.max()) + 1, -1, np.int32)
        row_of[sdocids] = np.arange(n, dtype=np.int32)
        self.adopt(cent, slab, scales, sdocids, cstart, ccount, row_of)

    def adopt(self, centroids, slab, scales, sdocids, cstart, ccount,
              row_of) -> None:
        """Take a built layout (build's arrays, or another index's: they
        are never written in place, so two indexes may share them) and
        lay out the hot arena under this index's budget: the greedy fill
        by cluster id up to HOT_FILL_FRACTION of it."""
        hot_cap = max(0, self.device_budget_bytes // self.row_bytes)
        dim = self.dim
        with self._lock:
            self.centroids = np.asarray(centroids, np.float32)
            self._slab, self._scales, self._sdocids = slab, scales, \
                sdocids
            self._cstart, self._ccount, self._row_of = cstart, ccount, \
                row_of
            self._hot_cap = hot_cap
            self._hot_slab = np.zeros((hot_cap, dim), np.int8) \
                if hot_cap else None
            self._hot_scales = np.zeros(hot_cap, np.float16) \
                if hot_cap else None
            self._hot_docids = np.full(hot_cap, 2 ** 31 - 1, np.int32) \
                if hot_cap else None
            self._hot_map.clear()
            self._hot_used = 0
            self._hot_dev = None
            self._hot_dev_device = None
            self._hot_written = None
            self._hot_pending = []
            self._access.clear()
            self._promote_inflight.clear()
            fill_cap = int(hot_cap * self.HOT_FILL_FRACTION)
            for c in range(len(ccount)):
                cnt = int(ccount[c])
                if cnt and self._hot_used + cnt > fill_cap:
                    break
                self._hot_place_locked(c)
            self._cent_dev = None
            self._cent_dev_version = -1
            self.built = True
            self.centroid_version += 1
            self.layout_version += 1

    def _hot_place_locked(self, cid: int) -> bool:
        """Copy one cluster's rows into the hot arena's host mirror; the
        device patch follows in hot_block."""
        cnt = int(self._ccount[cid])
        if cid in self._hot_map:
            return True
        if cnt == 0:
            self._hot_map[cid] = self._hot_used
            return True
        if self._hot_used + cnt > self._hot_cap:
            return False
        s = int(self._cstart[cid])
        h0 = self._hot_used
        self._hot_slab[h0:h0 + cnt] = self._slab[s:s + cnt]
        self._hot_scales[h0:h0 + cnt] = self._scales[s:s + cnt]
        self._hot_docids[h0:h0 + cnt] = self._sdocids[s:s + cnt]
        self._hot_map[cid] = h0
        self._hot_used = h0 + cnt
        self._hot_pending.append((h0, h0 + cnt))
        return True

    # -- device residency ----------------------------------------------------

    def _stream(self, dev):
        if dev.type != "cuda":
            return None
        s = self._wstreams.get(dev)
        if s is None:
            s = self._wstreams[dev] = torch.cuda.Stream(dev)
        return s

    def _on_stream(self, dev, fn):
        """fn() issued on the index's write stream of `dev`, and the event
        after it (None off the card)."""
        stream = self._stream(dev)
        if stream is None:
            return fn(), None
        with torch.cuda.stream(stream):
            out = fn()
            ev = torch.cuda.Event()
            ev.record(stream)
        return out, ev

    def centroid_block(self, device=None):
        """(the f16 centroid block on `device` (None: the index's) with
        C_pad pow2 rows, pad rows zero, the event after its upload). K14
        masks the pad rows."""
        dev = self.device if device is None else torch.device(device)
        with self._upload_lock:
            with self._lock:
                if (self._cent_dev is not None
                        and self._cent_dev_device == dev
                        and self._cent_dev_version
                        == self.centroid_version):
                    return self._cent_dev
                C = len(self.centroids)
                cp = 1 << max(4, (C - 1).bit_length())
                buf = np.zeros((cp, self.dim), np.float16)
                buf[:C] = self.centroids.astype(np.float16)
                ver = self.centroid_version
            got = self._on_stream(dev, lambda: torch.from_numpy(buf).to(dev))
            with self._lock:
                self._cent_dev = got
                self._cent_dev_device = dev
                self._cent_dev_version = ver
                return got

    def hot_block(self, device=None):
        """The hot arena on `device` (None: the index's) as a snapshot:
        ((slab int8 [cap,
        dim], scales f16 [cap], docids int32 [cap]), rows_covered, the
        event after their writes), or None without an arena. The arrays
        are uploaded once at full capacity, then patched out of place
        with the ranges placed since. `rows_covered` is the row prefix
        these arrays hold: a plan against this snapshot treats only the
        clusters inside it as hot. Host ranges are copied under the index
        lock (a racing promotion cannot tear them), the transfer runs
        under the upload lock alone."""
        dev = self.device if device is None else torch.device(device)
        with self._upload_lock:
            with self._lock:
                if self._hot_cap == 0:
                    return None
                fresh = (self._hot_dev is None
                         or self._hot_dev_device != dev)
                used = self._hot_used
                if fresh:
                    # rows past `used` may still be written by a racing
                    # promotion: outside rows_covered, and re-patched from
                    # the range it appends after this call
                    host = (self._hot_slab, self._hot_scales,
                            self._hot_docids)
                    copies = []
                else:
                    copies = [(a, b, self._hot_slab[a:b].copy(),
                               self._hot_scales[a:b].copy(),
                               self._hot_docids[a:b].copy())
                              for a, b in self._hot_pending]
                    base = self._hot_dev
                self._hot_pending = []
                if not fresh and not copies:
                    return self._hot_dev, used, self._hot_written

            def write():
                if fresh:
                    return tuple(torch.from_numpy(h).to(dev, copy=True)
                                 for h in host)
                out = tuple(t.clone() for t in base)
                for a, b, *rows in copies:
                    for t, r in zip(out, rows):
                        t[a:b] = torch.from_numpy(r).to(dev)
                return out
            arrays, ev = self._on_stream(dev, write)
            with self._lock:
                self._hot_dev = arrays
                self._hot_dev_device = dev
                self._hot_written = ev
                if not fresh:
                    self.patches += 1
            return arrays, used, ev

    def promote_cluster(self, cid: int, device=None):
        """Place one warm cluster in free hot-arena rows and patch it onto
        the device (the devstore batcher's `promote` kind, or inline).
        Bumps the centroid version: the cluster's scoring moved from the
        host oracle to the kernel. Returns (the device copy of the
        cluster's first docid, the host mirror's, the snapshot's arrays,
        the event after them) for the caller to confirm the upload, or
        None when nothing landed (already hot, no arena, an empty
        cluster; a full arena counts in promote_failures)."""
        with self._lock:
            self._promote_inflight.discard(cid)
            if cid in self._hot_map or self._hot_cap == 0:
                return None
            if not self._hot_place_locked(cid):
                self.promote_failures += 1
                return None
            self.promotions += 1
            self.centroid_version += 1
            dev = self.device if device is None else torch.device(device)
            had_dev = (self._hot_dev is not None
                       and self._hot_dev_device == dev)
            h0 = self._hot_map[cid]
            empty = int(self._ccount[cid]) == 0
            want = None if empty else self._hot_docids[h0:h0 + 1].copy()
        if not had_dev or empty:
            return None
        arrays, _used, ev = self.hot_block(dev)
        return arrays[2][h0:h0 + 1], want, arrays, ev

    # -- probing -------------------------------------------------------------

    def assign_host(self, qvecs: np.ndarray, nprobe: int) -> np.ndarray:
        """Host centroid assignment (the f32 centroids rounded to bf16 as
        they are, where the device rounds their f16 upload)."""
        with self._lock:
            cents = self.centroids
        return ann_assign_np(cents, np.atleast_2d(qvecs), nprobe)

    def _snapshot_locked(self) -> dict:
        """The layout arrays a plan's offsets are valid against (build
        replaces them whole, never in place)."""
        return {"layout": self.layout_version, "slab": self._slab,
                "scales": self._scales, "sdocids": self._sdocids,
                "cstart": self._cstart, "ccount": self._ccount}

    def plan(self, cids, sparse_docids, sparse_scores,
             lanes_budget: int | None = None,
             hot_limit: int | None = None) -> dict:
        """One slot's probed cluster ids and sparse candidates as lanes:
        hot probe rows (the kernel's), host-scored clusters, sparse lanes
        split the same way, and the promotion list; the tier hits are
        counted here. `hot_limit`: the rows the caller's device snapshot
        covers (hot_block's rows_covered), past which a cluster plans as
        warm. Probes past `lanes_budget` drop whole clusters, counted."""
        budget = lanes_budget or ANN_DEFAULT_PROBE_LANES
        hot_rows: list[np.ndarray] = []
        host_cids: list[int] = []
        promote: list[int] = []
        lanes = 0
        with self._lock:
            snap = self._snapshot_locked()
            C = self.n_clusters()
            limit = self._hot_used if hot_limit is None else hot_limit
            for cid in dict.fromkeys(int(c) for c in cids):
                if cid < 0 or cid >= C:
                    continue        # assignment pad lane
                cnt = int(self._ccount[cid])
                if cnt == 0:
                    continue
                if lanes + cnt > budget:
                    self.lane_drops += 1
                    continue        # whole-cluster drop, counted
                lanes += cnt
                h0 = self._hot_map.get(cid)
                hot = (h0 is not None and self._hot_dev is not None
                       and h0 + cnt <= limit)
                if hot:
                    self.tier_hot_hits += 1
                    hot_rows.append(
                        np.arange(h0, h0 + cnt, dtype=np.int32))
                else:
                    host_cids.append(cid)
                    self._access[cid] = self._access.get(cid, 0) + 1
                    if (h0 is None
                            and self._access[cid] >= self.PROMOTE_AFTER
                            and self._hot_used + cnt <= self._hot_cap
                            and cid not in self._promote_inflight):
                        self._promote_inflight.add(cid)
                        promote.append(cid)
            # sparse candidates: hot rows ride the kernel, the rest score
            # on the host (the reference's loop, in array form: the same
            # lanes in the same order)
            sd = np.asarray(sparse_docids, np.int64).reshape(-1)
            ss = np.asarray(sparse_scores, np.int64).reshape(-1)
            nrow = len(self._row_of)
            inr = (sd >= 0) & (sd < nrow)
            r = np.where(inr, self._row_of[np.clip(sd, 0, nrow - 1)],
                         -1).astype(np.int64)
            has = r >= 0
            cid = np.searchsorted(self._cstart, np.where(has, r, 0),
                                  side="right") - 1
            hot_start = np.full(C, -1, np.int64)
            for c, h0 in self._hot_map.items():
                hot_start[c] = h0
            h0s = hot_start[cid]
            dev = self._hot_dev is not None
            hot = has & (h0s >= 0) & dev & (h0s + self._ccount[cid] <= limit)
            hr = np.where(hot, h0s + (r - self._cstart[cid]), -1)
            # a hot vector, or none at all with an arena to ride (sparse
            # + 0 on the device: a missing vector never drops a candidate)
            on_dev = hot | (~has & dev)
        return {
            "hot_rows": (np.concatenate(hot_rows)
                         if hot_rows else np.empty(0, np.int32)),
            "host_cids": host_cids,
            "sp_hot": (hr[on_dev].astype(np.int32),
                       sd[on_dev].astype(np.int32),
                       ss[on_dev].astype(np.int32)),
            "sp_host": (r[~on_dev].astype(np.int32),
                        sd[~on_dev].astype(np.int32),
                        ss[~on_dev].astype(np.int32)),
            "promote": promote,
            "snap": snap,
        }

    def cluster_rows(self, cid: int,
                     snap: dict | None = None) -> tuple[np.ndarray, int]:
        """One cluster's int8 rows and its slab start (a warm hit); from
        `snap`'s own arrays when a build landed since the plan."""
        with self._lock:
            if snap is not None \
                    and snap["layout"] != self.layout_version:
                s = int(snap["cstart"][cid])
                cnt = int(snap["ccount"][cid])
                return np.asarray(snap["slab"][s:s + cnt]), s
            s = int(self._cstart[cid])
            cnt = int(self._ccount[cid])
            self.tier_warm_hits += 1
            return self._slab[s:s + cnt], s

    def host_score_parts(self, plan: dict, qvec, alpha: float,
                         k: int) -> list:
        """A plan's warm clusters and host sparse lanes scored by the
        numpy oracle: fused (scores, docids) parts for merge_fused, every
        read through the plan's layout snapshot."""
        snap = plan["snap"]
        parts = []
        for cid in plan["host_cids"]:
            rows, s = self.cluster_rows(cid, snap=snap)
            cnt = len(rows)
            if cnt == 0:
                continue
            parts.append(ann_fuse_np(
                rows, snap["scales"][s:s + cnt],
                snap["sdocids"][s:s + cnt],
                np.arange(cnt, dtype=np.int32),
                np.full(cnt, -1, np.int32), np.zeros(cnt, np.int32),
                qvec, alpha, k))
        rr, dd, ss = plan["sp_host"]
        if len(dd):
            parts.append(ann_fuse_np(snap["slab"], snap["scales"],
                                     snap["sdocids"], rr, dd, ss,
                                     qvec, alpha, k))
        return parts

    def search_host(self, qvec, sparse_docids, sparse_scores,
                    alpha: float, k: int,
                    nprobe: int = ANN_DEFAULT_NPROBE,
                    lanes_budget: int | None = None):
        """The whole dense-first answer on the host (device loss): host
        assignment, the oracle over every probed cluster and the sparse
        lanes, merged by (score DESC, docid ASC)."""
        with self._lock:
            snap = self._snapshot_locked()
            row_of = self._row_of
            cent = self.centroids
            C = self.n_clusters()
        cids = ann_assign_np(cent, np.atleast_2d(qvec), nprobe)[0]
        parts = []
        budget = lanes_budget or ANN_DEFAULT_PROBE_LANES
        lanes = 0
        for cid in dict.fromkeys(int(c) for c in cids):
            if cid < 0 or cid >= C:
                continue
            rows, s = self.cluster_rows(cid, snap=snap)
            cnt = len(rows)
            if cnt == 0:
                continue
            if lanes + cnt > budget:
                with self._lock:
                    self.lane_drops += 1
                continue
            lanes += cnt
            parts.append(ann_fuse_np(
                rows, snap["scales"][s:s + cnt],
                snap["sdocids"][s:s + cnt],
                np.arange(cnt, dtype=np.int32),
                np.full(cnt, -1, np.int32), np.zeros(cnt, np.int32),
                qvec, alpha, k))
        dd = np.asarray(sparse_docids, np.int64)
        if len(dd):
            nrow = len(row_of)
            rr = np.where((dd >= 0) & (dd < nrow),
                          row_of[np.clip(dd, 0, nrow - 1)], -1)
            parts.append(ann_fuse_np(
                snap["slab"], snap["scales"], snap["sdocids"],
                rr.astype(np.int32), dd.astype(np.int32),
                np.asarray(sparse_scores, np.int32), qvec, alpha, k))
        return merge_fused(parts, k)

    def exact_topk(self, qvec, k: int, chunk: int = 1 << 19):
        """The exact oracle over the whole quantized corpus (the recall
        denominator): same score domain as the probes, (score DESC, docid
        ASC)."""
        q = np.asarray(qvec, np.float32)
        with self._lock:
            slab, scales, sdocids = self._slab, self._scales, \
                self._sdocids
            n = 0 if sdocids is None else len(sdocids)
        best_s = np.empty(0, np.float64)
        best_d = np.empty(0, np.int64)
        for i0 in range(0, n, chunk):
            i1 = min(i0 + chunk, n)
            sims = (np.asarray(slab[i0:i1], np.float32) @ q) \
                * np.asarray(scales[i0:i1], np.float32)
            dd = sdocids[i0:i1].astype(np.int64)
            s = np.concatenate([best_s, sims])
            d = np.concatenate([best_d, dd])
            order = np.lexsort((d, -s))[:k]
            best_s, best_d = s[order], d[order]
        return best_s, best_d.astype(np.int32)

    # -- accounting ----------------------------------------------------------

    def tier_bytes(self) -> dict:
        with self._lock:
            return {"hot": self._hot_used * self.row_bytes,
                    "warm": self.n_vectors() * self.row_bytes, "cold": 0}

    def counters(self) -> dict:
        tb = self.tier_bytes()
        with self._lock:
            return {
                "ann_vectors": self.n_vectors(),
                "ann_clusters": self.n_clusters(),
                "ann_centroid_version": self.centroid_version,
                "ann_hot_bytes": tb["hot"],
                "ann_warm_bytes": tb["warm"],
                "ann_cold_bytes": tb["cold"],
                "ann_tier_hot_hits": self.tier_hot_hits,
                "ann_tier_warm_hits": self.tier_warm_hits,
                "ann_tier_cold_hits": self.tier_cold_hits,
                "ann_promotions": self.promotions,
                "ann_promote_failures": self.promote_failures,
                "ann_lane_drops": self.lane_drops,
            }
