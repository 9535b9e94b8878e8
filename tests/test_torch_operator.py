"""The JAX package's operator page `DeviceStore_p` on a port store.

A reference Segment can carry the port's DeviceSegmentStore; the page
reads the arena's `capacity_rows` and the store's `live_rows()` beside its
counters. Rendered through a stub switchboard, the page must show every
row for a port store, with the values it shows for a JAX store over the
same RWI (int16 and packed residency alike). The JAX store's
`util_pct_*` and `bound` rows read the JAX package's process-wide
roofline profiler, which other tests in the same process fill; the test
gives that profiler an empty series for its own run (the port's rows
read zero: no query was served), so the comparison depends on this RWI
alone.
"""

import types
from collections import deque

import numpy as np
import pytest

from yacy_search_server_tpu.index import devstore as JD
from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.index.rwi import RWIIndex as JRWI
from yacy_search_server_tpu.server.objects import ServerObjects
from yacy_search_server_tpu.server.servlets import lookup
from yacy_search_server_tpu.utils.profiler import PROFILER
from yacy_search_server_tpu_torch.index import devstore as TD
from yacy_search_server_tpu_torch.kernels import bench as KB


def _fill(idx, seed):
    rng = np.random.default_rng(seed)
    for i, n in enumerate((500, JD.TILE + 5_000, 3, 1_000)):
        docids = (7 * i + 3 * np.arange(n)).astype(np.int32)
        feats = rng.integers(0, 1000, (n, JP.NF)).astype(np.int32)
        feats[:, JP.F_LANGUAGE] = JP.pack_language("en")
        idx.add_many(b"term%08d" % i, JP.PostingsList(docids, feats))
    idx.flush()
    idx.add_many(b"term00000001", JP.PostingsList(
        np.arange(100_001, 100_901, dtype=np.int32),
        rng.integers(0, 1000, (900, JP.NF)).astype(np.int32)))
    idx.flush()
    idx.delete_doc(21)


def _page(store):
    sb = types.SimpleNamespace(index=types.SimpleNamespace(devstore=store))
    return lookup("DeviceStore_p")({}, ServerObjects(), sb).as_dict()


@pytest.mark.parametrize("packed", [False, True], ids=["int16", "packed"])
def test_device_store_page_renders_for_a_port_store(packed, monkeypatch):
    monkeypatch.setattr(PROFILER, "_query_util", deque(maxlen=20_000))
    idx = JRWI()
    kw = dict(packed_residency=True) if packed else {}
    j = JD.DeviceSegmentStore(idx, **kw)
    t = TD.DeviceSegmentStore(idx, device="cpu", **kw)
    idx.listener = KB.Fanout(j, t)
    _fill(idx, seed=3)
    assert t.arena.capacity_rows == j.arena.capacity_rows
    assert t.live_rows() == j.live_rows() > 0
    want, got = _page(j), _page(t)
    assert got == want
    assert list(got) == list(want)
    rows = {got[f"rows_{i}_key"]: got[f"rows_{i}_value"]
            for i in range(int(got["rows"]))}
    assert int(rows["live_rows"]) == t.live_rows()
    assert int(rows["arena_rows_capacity"]) == t.arena.capacity_rows
    assert got["kind"] == "DeviceSegmentStore" and got["enabled"] == "1"
