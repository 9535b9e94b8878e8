"""PyTorch/CUDA port of the query-time ranking step of yacy_search_server_tpu.

The layout mirrors the JAX package so each module has an obvious
counterpart (`utils/bitfield.py`, `index/postings.py`, `index/rwi.py`,
`index/devstore.py`, `ops/ranking.py`, `ops/streaming.py`,
`parallel/mesh.py`). Device kernels are hand-written
CUDA C++ for sm_90a under `kernels/`; each has a plain PyTorch version
that runs only for tensors on the CPU.

Entry points take `device=None`, meaning CUDA; without a CUDA device they
raise instead of running on the CPU. Pass `device="cpu"` explicitly to run
the plain versions.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA device (raises without one); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's device path needs one; pass "
                "device='cpu' explicitly to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)
