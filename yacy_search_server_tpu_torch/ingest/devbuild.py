"""The device build of packed blocks: the bit-pack of many terms at once.

Port of yacy_search_server_tpu/ingest/devbuild.py. With packed residency
the store packs every term of a fresh run (index/devstore.py
_build_packed_entries); `ops/packed.pack_block` does it on the host, one
term at a time, and with `ingest_device_build` this module does it on
the card instead: K13 (`kernels/packed.pack_block_batch`) once a row
bucket, every block word for word what the host pack gives.

Blocks outside [MIN_DEV_ROWS, MAX_DEV_ROWS] rows stay on the host packer,
as in the reference: a stub of a few rows is cheaper on the host than its
padding on the card, and a block past 2^18 rows (the 10M-row term of a
benchmark corpus) would need a transient padded buffer of its own size.
The reference pads each bucket's batch to a power of two to bound XLA's
compile shapes; the kernel takes any batch, so only live lanes go, in
waves of at most _WAVE_BYTES of padded input.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..index import postings as P
from ..kernels import packed as KP
from ..ops import packed as PK

MAX_DEV_ROWS = 1 << 18
MIN_DEV_ROWS = 64
# padded input bytes (int16 features, flags, docids) a launch takes
_WAVE_BYTES = 256 << 20


def rows_bucket(n: int) -> int:
    """The padded rows of a block's lane: a power of two, at least 256."""
    return 1 << max(8, (max(n, 1) - 1).bit_length())


def pack_block_batch(parts, device=None) -> list:
    """Pack [(feats16, flags, docids), ...] into PackedBlocks in input
    order: blocks of [MIN_DEV_ROWS, MAX_DEV_ROWS] rows by K13 on `device`
    (one launch a row bucket and wave), the others by the host pack.
    Every block equals ops/packed.pack_block of the same rows."""
    dev = resolve_device(device)
    out: list = [None] * len(parts)
    groups: dict[int, list] = {}
    for idx, (f16, fl, dd) in enumerate(parts):
        nrows = len(dd)
        if not MIN_DEV_ROWS <= nrows <= MAX_DEV_ROWS:
            out[idx] = PK.pack_block(f16, fl, dd)
        else:
            groups.setdefault(rows_bucket(nrows), []).append(idx)
    for rows, idxs in sorted(groups.items()):
        wave = max(1, _WAVE_BYTES // (rows * (P.NF * 2 + 8)))
        for pos in range(0, len(idxs), wave):
            _pack_wave(parts, idxs[pos:pos + wave], rows, dev, out)
    return out


def _pack_wave(parts, idxs, rows: int, dev, out: list) -> None:
    """One K13 launch over the blocks `idxs`, each a lane of `rows`."""
    nb = len(idxs)
    f16 = np.zeros((nb, rows, P.NF), np.int16)
    fl = np.zeros((nb, rows), np.int32)
    dd = np.zeros((nb, rows), np.int32)
    n = np.zeros(nb, np.int32)
    for j, idx in enumerate(idxs):
        bf, bl, bd = parts[idx]
        m = len(bd)
        f16[j, :m], fl[j, :m], dd[j, :m], n[j] = bf, bl, bd, m
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    words, meta, totals = KP.pack_block_batch(put(f16), put(fl), put(dd),
                                              put(n))
    meta = meta.cpu().numpy()
    totals = totals.cpu().numpy().astype(np.int64)
    # one copy of every lane's words, each cut at its total
    flat = torch.cat([words[j, :int(totals[j])] for j in range(nb)]).cpu()
    flat = flat.numpy()
    ends = np.cumsum(totals)
    for j, idx in enumerate(idxs):
        m = meta[j]
        out[idx] = PK.PackedBlock(
            words=flat[ends[j] - totals[j]:ends[j]].copy(), count=int(n[j]),
            word_offs=m[:PK.NCOLS].copy(),
            widths=m[PK.NCOLS:2 * PK.NCOLS].copy(),
            mins=m[2 * PK.NCOLS:].copy())
