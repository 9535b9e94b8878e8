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
        "import yacy_search_server_tpu_torch.convert\n"
        "import yacy_search_server_tpu_torch.kernels\n"
        "import yacy_search_server_tpu_torch.kernels.devstore\n"
        "import yacy_search_server_tpu_torch.kernels.bench\n"
        "import yacy_search_server_tpu_torch.index.rwi\n"
        "import yacy_search_server_tpu_torch.index.devstore\n"
        "import yacy_search_server_tpu_torch.index.batcher\n"
        "import yacy_search_server_tpu_torch.utils.faultinject\n"
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
