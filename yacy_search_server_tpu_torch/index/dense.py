"""The dense vector store: per-segment doc vectors aligned to docids.

Port of yacy_search_server_tpu/index/dense.py's DenseVectorStore, memory
only (the JAX store's .npy snapshot, its crc footer, quarantine and the
encoder-version stamp are not ported). One growable [capacity, dim] f16
block on the host, and the forward index the rerank kernels gather from:
the block's rows padded to a pow2 bucket (at least 256) on a device.

The device block (`device_snapshot` / `device_block`) is uploaded once
and kept while the vector-content `version` stands. After writes, when
the bucket is unchanged, the dirty set has not overflowed and at most a
quarter of the rows changed, only the dirty rows cross: the block is
patched OUT OF PLACE (a clone, then index_copy_), so a rerank wave
issued before the write keeps reading the rows it was issued on and
answers with one version. On the card every upload and patch is issued
on a stream of the store's own and recorded in an event (`written`) that
a rerank's stream waits on before it launches (the arena's rule,
index/devstore.DeviceArena). A transfer that fails (the
`dense.upload_fail` fault point, or any error of the copy) leaves the
block as it was and restores the dirty rows it had taken.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..ops.dense import DIM
from ..utils import faultinject


class DenseUploadError(RuntimeError):
    """An upload or patch of the forward index failed (injected by the
    `dense.upload_fail` fault point)."""


class DenseVectorStore:
    # device-residency cap of the forward index: beyond it the rerank
    # falls back to the host gather (1 GiB is 2^21 rows at dim 256)
    DEVICE_BUDGET_BYTES = 1 << 30
    # dirty-row cap of the patch path: a bigger set costs more than the
    # full upload it would save
    _DIRTY_CAP = 1 << 16

    def __init__(self, dim: int = DIM, device_budget_bytes: int | None = None):
        self.dim = dim
        self.device_budget_bytes = (self.DEVICE_BUDGET_BYTES
                                    if device_budget_bytes is None
                                    else int(device_budget_bytes))
        self._vecs = np.zeros((256, dim), dtype=np.float16)
        self._n = 0
        self._lock = threading.Lock()
        # bumps on every write: the hybrid top-k cache keys on it
        self.version = 0
        self._fwd = None
        self._fwd_version = -1
        self._fwd_device = None
        self._fwd_written = None     # the event after the block's writes
        self._wstreams: dict = {}    # device -> the store's write stream
        # serializes uploads without holding the write lock across them
        self._fwd_lock = threading.Lock()
        # rows written since the last upload; None: overflowed
        self._fwd_dirty: set | None = set()
        self.uploads = 0    # whole blocks uploaded
        self.patches = 0    # blocks patched with their dirty rows

    def put(self, docid: int, vec: np.ndarray) -> None:
        with self._lock:
            while docid >= self._vecs.shape[0]:
                self._vecs = np.vstack(
                    [self._vecs, np.zeros_like(self._vecs)])
            self._vecs[docid] = vec.astype(np.float16)
            self._n = max(self._n, docid + 1)
            self.version += 1
            if self._fwd_dirty is not None:
                self._fwd_dirty.add(docid)
                if len(self._fwd_dirty) > self._DIRTY_CAP:
                    self._fwd_dirty = None

    def get_block(self, docids: np.ndarray) -> np.ndarray:
        """[len(docids), dim] f16; docids without a stored vector gather
        zeros (no boost), as the device block's pad rows do."""
        with self._lock:
            ids = np.asarray(docids, dtype=np.int64)
            out = np.zeros((len(ids), self.dim), np.float16)
            ok = (ids >= 0) & (ids < self._n)
            out[ok] = self._vecs[ids[ok]]
            return out

    def _rows_locked(self) -> int:
        return 1 << max(8, (max(self._n, 1) - 1).bit_length())

    def device_rows(self) -> int:
        """The device block's pow2 row bucket."""
        with self._lock:
            return self._rows_locked()

    def _stream(self, dev):
        if dev.type != "cuda":
            return None
        s = self._wstreams.get(dev)
        if s is None:
            s = self._wstreams[dev] = torch.cuda.Stream(dev)
        return s

    def _transfer(self, dev, patch, base, idx, sub, buf):
        """The new block on `dev` (a patched clone of `base`, or `buf`
        uploaded) and the event after its writes (None off the card)."""
        if faultinject.take("dense.upload_fail"):
            raise DenseUploadError("injected dense.upload_fail")
        stream = self._stream(dev)
        if stream is None:
            if patch:
                fwd = base.clone()
                fwd.index_copy_(0, torch.from_numpy(idx),
                                torch.from_numpy(sub))
                return fwd, None
            return torch.from_numpy(buf), None
        # on the store's stream, behind the block's earlier writes
        with torch.cuda.stream(stream):
            if patch:
                fwd = base.clone()
                fwd.index_copy_(0, torch.from_numpy(idx).to(dev),
                                torch.from_numpy(sub).to(dev))
            else:
                fwd = torch.from_numpy(buf).to(dev)
            ev = torch.cuda.Event()
            ev.record(stream)
        return fwd, ev

    def device_snapshot(self, device):
        """The forward index on `device`: ([rows, dim] f16 tensor, content
        version, the event after its writes (None off the card)), or None
        when the block is over `device_budget_bytes` (the last block is
        released then). A reader waits on the event before it launches
        and holds the tensor until its answer is on the host."""
        dev = torch.device(device)
        with self._fwd_lock:
            with self._lock:
                rows = self._rows_locked()
                if rows * self.dim * 2 > self.device_budget_bytes:
                    self._fwd = None
                    self._fwd_device = None
                    self._fwd_version = -1
                    self._fwd_written = None
                    return None
                if (self._fwd is not None
                        and self._fwd_version == self.version
                        and self._fwd_device == dev
                        and self._fwd.shape[0] == rows):
                    return self._fwd, self._fwd_version, self._fwd_written
                ver = self.version
                base, dirty = self._fwd, self._fwd_dirty
                patch = (base is not None and dirty is not None
                         and self._fwd_device == dev
                         and base.shape[0] == rows
                         and 0 < len(dirty) <= rows // 4)
                idx = sub = buf = None
                if patch:
                    idx = np.fromiter(dirty, np.int64, len(dirty))
                    sub = self._vecs[idx]
                else:
                    buf = np.zeros((rows, self.dim), np.float16)
                    buf[:self._n] = self._vecs[:self._n]
                self._fwd_dirty = set()
            try:
                fwd, ev = self._transfer(dev, patch, base, idx, sub, buf)
            except BaseException:
                # the block is unchanged: the rows taken must be patched
                # in by the next call, or a later patch would serve them
                # stale as fresh
                with self._lock:
                    if dirty is None or self._fwd_dirty is None:
                        self._fwd_dirty = None
                    else:
                        self._fwd_dirty |= dirty
                raise
            with self._lock:
                self._fwd = fwd
                self._fwd_version = ver
                self._fwd_device = dev
                self._fwd_written = ev
                if patch:
                    self.patches += 1
                else:
                    self.uploads += 1
            return fwd, ver, ev

    def device_block(self, device):
        """(forward index [rows, dim] f16 on `device`, content version), or
        None over the budget (device_snapshot without its event)."""
        got = self.device_snapshot(device)
        return None if got is None else got[:2]

    def __len__(self) -> int:
        with self._lock:
            return self._n
