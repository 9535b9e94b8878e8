"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

Module names are matched exactly: `yacy_search_server_tpu_torch` starts
with `yacy_search_server_tpu` and must not count as an import of it.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "yacy_search_server_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "yacy_search_server_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_name_match_is_exact():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("yacy_search_server_tpu")
    assert _forbidden("yacy_search_server_tpu.ops.ranking")
    assert not _forbidden("yacy_search_server_tpu_torch")
    assert not _forbidden("yacy_search_server_tpu_torch.ops.ranking")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_masked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'yacy_search_server_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import yacy_search_server_tpu_torch.ops.ranking\n"
        "import yacy_search_server_tpu_torch.ops.streaming\n"
        "import yacy_search_server_tpu_torch.parallel.mesh\n"
        "import yacy_search_server_tpu_torch.parallel.distribution\n"
        "import yacy_search_server_tpu_torch.index.meshstore\n"
        "import yacy_search_server_tpu_torch.convert\n"
        "import yacy_search_server_tpu_torch.kernels\n"
        "import yacy_search_server_tpu_torch.kernels.devstore\n"
        "import yacy_search_server_tpu_torch.kernels.bench\n"
        "import yacy_search_server_tpu_torch.index.rwi\n"
        "import yacy_search_server_tpu_torch.index.devstore\n"
        "import yacy_search_server_tpu_torch.index.batcher\n"
        "import yacy_search_server_tpu_torch.utils.faultinject\n"
        "import yacy_search_server_tpu_torch.ops.dense\n"
        "import yacy_search_server_tpu_torch.kernels.dense\n"
        "import yacy_search_server_tpu_torch.index.dense\n"
        "import yacy_search_server_tpu_torch.ops.packed\n"
        "import yacy_search_server_tpu_torch.kernels.packed\n"
        "import yacy_search_server_tpu_torch.ingest.devbuild\n"
        "import yacy_search_server_tpu_torch.ops.ann\n"
        "import yacy_search_server_tpu_torch.kernels.ann\n"
        "import yacy_search_server_tpu_torch.index.annstore\n"
        "from yacy_search_server_tpu_torch.convert import ann_from_numpy\n"
        "import yacy_search_server_tpu_torch.utils.base64order\n"
        "import yacy_search_server_tpu_torch.utils.hashes\n"
        "import yacy_search_server_tpu_torch.document.signature\n"
        "import yacy_search_server_tpu_torch.document.document\n"
        "import yacy_search_server_tpu_torch.webstructure\n"
        "import yacy_search_server_tpu_torch.index.metadata\n"
        "import yacy_search_server_tpu_torch.index.webgraph\n"
        "import yacy_search_server_tpu_torch.index.postprocess\n"
        "import yacy_search_server_tpu_torch.kernels.blockrank\n"
        "import yacy_search_server_tpu_torch.ops.blockrank\n"
        "import yacy_search_server_tpu_torch.server.objects\n"
        "from yacy_search_server_tpu_torch.server.servlets import lookup\n"
        "assert lookup('postprocessing_p') is not None\n"
        "from yacy_search_server_tpu_torch.kernels.devstore import (\n"
        "    join_member_batch, join_stats_batch, join_score_batch)\n"
        "from yacy_search_server_tpu_torch.index.devstore import (\n"
        "    DeviceTransferError, join_batch_query)\n"
        "assert not any(m == 'jax' or m.startswith('jax.')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_device_rank_without_device_raises_on_a_box_without_cuda():
    import torch

    from yacy_search_server_tpu_torch.index import postings as TP
    from yacy_search_server_tpu_torch.ops import ranking as TR
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the device path would run")
    n = TR.SMALL_RANK_N + 1
    rng = np.random.default_rng(0)
    feats = rng.integers(0, 100, (n, TP.NF)).astype(np.int32)
    plist = TP.PostingsList(np.arange(n, dtype=np.int32), feats)
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.CardinalRanker().rank(plist, k=10)
    # and a CPU tensor is the only way to the plain versions
    s, d = TR.CardinalRanker(device="cpu").rank(plist, k=10)
    assert len(s) == 10


def test_packed_entry_points_raise_without_cuda():
    """A packed store and the device build run on the card unless given
    device="cpu": without CUDA they raise, never fall back."""
    import torch

    from yacy_search_server_tpu_torch.index import devstore as TD
    from yacy_search_server_tpu_torch.index.rwi import RWIIndex
    from yacy_search_server_tpu_torch.ingest import devbuild as TB
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the device path would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.DeviceSegmentStore(RWIIndex(), packed_residency=True)
    part = (np.zeros((100, 17), np.int16), np.zeros(100, np.int32),
            np.arange(100, dtype=np.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        TB.pack_block_batch([part])
    s = TD.DeviceSegmentStore(RWIIndex(), device="cpu",
                              packed_residency=True)
    assert s.arena.device.type == "cpu"
    assert len(TB.pack_block_batch([part], "cpu")) == 1


def test_ann_and_bm25_entry_points_raise_without_cuda():
    """The ANN index, the ANN device functions on numpy inputs and
    bm25_topk run on the card unless given device="cpu": without CUDA
    they raise, never fall back."""
    import torch

    from yacy_search_server_tpu_torch.index.annstore import AnnVectorIndex
    from yacy_search_server_tpu_torch.ops import ann as TA
    from yacy_search_server_tpu_torch.ops import ranking as TR
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the device path would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        AnnVectorIndex(256)
    assert AnnVectorIndex(256, device="cpu").device.type == "cpu"
    cent = np.zeros((16, 256), np.float16)
    qv = np.ones((2, 256), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.ann_assign_batch(cent, qv, 4, 16)
    assert TA.ann_assign_batch(cent, qv, 4, 16, device="cpu").shape == (2, 4)
    slab = np.zeros((8, 256), np.int8)
    scales = np.ones(8, np.float16)
    sdoc = np.arange(8, dtype=np.int32)
    qi = TA.pack_ann_fuse_row(qv[0], np.arange(8), np.full(8, -1),
                              np.zeros(8), 0.5, 256)[None]
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.ann_fuse_batch_packed(slab, scales, sdoc, qi, 256, 16)
    out = TA.ann_fuse_batch_packed(slab, scales, sdoc, qi, 256, 16,
                                   device="cpu")
    assert out.shape == (1, 32)
    tf = np.ones((10, 2), np.float32)
    args = (tf, np.full(10, 50, np.int32), np.array([1, 2], np.int32), 10,
            np.ones(10, bool), np.arange(10, dtype=np.int32), 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.bm25_topk(*args)
    assert len(TR.bm25_topk(*args, device="cpu")[0]) == 5


def test_blockrank_entry_points_raise_without_cuda():
    """BlockRank's power iteration, host_ranks(_from_edges),
    postprocess_segment without precomputed ranks and the
    postprocessing_p servlet run on the card unless asked for the CPU
    (`device="cpu"`, or `sb.torch_device` for the servlet): without CUDA
    they raise, never fall back."""
    import types

    import torch

    from yacy_search_server_tpu_torch.index.metadata import MetadataStore
    from yacy_search_server_tpu_torch.index.webgraph import WebgraphStore
    from yacy_search_server_tpu_torch.ops import blockrank as TB
    from yacy_search_server_tpu_torch.server.objects import ServerObjects
    from yacy_search_server_tpu_torch.server.servlets import lookup
    from yacy_search_server_tpu_torch.webstructure import WebStructureGraph
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the device path would run")
    ws = WebStructureGraph()
    ws.add_document("http://a.test/", ["http://b.test/", "http://c.test/"])
    wg = WebgraphStore()
    wg.add_document_edges(0, "http://a.test/", ["http://b.test/"])
    g = (np.zeros(1, np.int32), np.ones(1, np.int32),
         np.ones(1, np.float32), np.array([False, True]))
    seg = types.SimpleNamespace(webgraph=wg, metadata=MetadataStore())
    for call in (lambda d: TB.power_iterate_sparse(*g, 0.85, 2, device=d),
                 lambda d: TB.host_ranks(ws, device=d),
                 lambda d: TB.host_ranks(WebStructureGraph(), device=d),
                 lambda d: TB.host_ranks_from_edges(wg, device=d),
                 lambda d: TB.postprocess_segment(seg, ws, device=d)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call(None)
        call("cpu")
    fn = lookup("postprocessing_p")
    sb = types.SimpleNamespace(index=seg, web_structure=ws)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn({}, ServerObjects({"run": "1"}), sb)
    sb.torch_device = "cpu"
    assert fn({}, ServerObjects({"run": "1"}), sb).get("source") == \
        "webgraph"
