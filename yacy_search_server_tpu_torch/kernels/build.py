"""Build and bind the port's CUDA kernels.

Every `csrc/*.cu` is compiled by nvcc for sm_90a into an object, all
sources at once in parallel, and the objects are linked into one shared
library `build/kernels/libyacytorch.so` at the repository root (a
git-ignored directory). The library has a plain C interface and is loaded
with ctypes. The build happens at first use and is redone whenever a
source or the flags change (a content stamp sits beside the library).

Flags: `-fmad=false` keeps nvcc from contracting a multiply and an add
into one FMA. The scorer's tf normalisation and the compact path's
reciprocal division must round exactly as the JAX reference does, step
by step; fast-math is never used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libyacytorch.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# YT_KERNEL_TRACE=1 compiles tie_topk's per-pass trace in (read by
# kernels/bench.topk_trace); the stamp holds the flags, so switching it
# rebuilds
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
                     "-Xcompiler", "-fPIC"] + (
    ["-DYT_TRACE"] if os.environ.get("YT_KERNEL_TRACE") == "1" else [])

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
# C entry points: name -> argtypes (every pointer and the stream as void*)
SIGNATURES = {
    "yt_cardinal_stats": [_P, _I, _P, _P, _I64, _I64, _P, _P],
    "yt_cardinal_score": [_P, _I, _P, _P, _P, _I64, _P, _P, _I64, _P, _I,
                          _P, _P],
    "yt_tie_topk_scratch_bytes": [_I64, _I64],
    "yt_tie_topk": [_P, _I, _P, _P, _I64, _I64, _P, _P, _P, _P, _P],
    "yt_tie_topk_trace": [_P],
    "yt_gather_topk": [_P, _P, _I64, _I64, _I64, _I, _I64, _P, _P],
    "yt_gather_topk_batch": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I,
                             _I64, _P, _P],
    "yt_empty_launch": [_P],
    "yt_span_stats": [_P, _P, _P, _P, _I64, _P, _I, _P, _P, _I64, _P, _P,
                      _P, _I64, _P, _P],
    "yt_span_score": [_P, _P, _P, _P, _I64, _P, _I, _P, _P, _I64, _P, _P,
                      _P, _I64, _P, _P, _P, _P, _I64, _P],
    "yt_span_stats_batch": [_P, _P, _P, _P, _I64, _P, _I, _P, _P],
    "yt_span_topk_batch_plan": [_P, _I, _I, _P],
    "yt_span_topk_batch": [_P, _P, _P, _P, _I64, _P, _I, _P, _I64, _P, _I,
                           _P, _I64, _P, _I64, _P, _P],
    "yt_join_stage_most": [_P],
    "yt_join_rows": [_P, _P, _P, _P, _I64, _P, _P, _I64, _P, _I64, _P, _I64,
                     _P, _I64, _I64, _I64, _P, _P, _P, _P, _P],
    "yt_xjoin_probe": [_P, _I64, _P, _I64, _P, _I, _I, _P, _P, _I64, _I64,
                       _P, _P, _P, _P, _P],
    "yt_xjoin_apply": [_P, _P, _P, _P, _I64, _I64, _I64, _P, _I, _I, _P, _P,
                       _P, _P, _P],
    "yt_join_stats_batch": [_P, _P, _P, _P, _I, _P, _P],
    "yt_join_score_batch": [_P, _P, _P, _P, _P, _I, _P, _I64, _P, _P, _P],
    "yt_pruned_tile": [_P, _P, _P, _P, _I64, _P, _P, _I, _I, _I, _P, _P, _P],
    "yt_pruned_tile_cluster": [_I, _I, _P],
    "yt_topk_finish": [_P, _P, _I, _P, _P, _I, _P, _I64, _P, _I64, _I64,
                       _I64, _I, _I, _P, _P, _P],
    "yt_topk_finish_batch": [_P, _P, _I, _P, _P, _I, _P, _P],
    "yt_dense_gather": [_P, _I64, _P, _I, _I, _P, _P],
    "yt_dense_rows": [_P, _I64, _P, _P, _P, _I, _P, _P],
    "yt_dense_sims": [_P, _I64, _P, _I, _P, _P],
    "yt_rerank_sort": [_P, _P, _I, _I, _P, _P],
    "yt_hybrid_blend_scratch_bytes": [_I64, _I64],
    "yt_hybrid_blend": [_P, _P, _P, _I64, _I, _I, _P, _P, _P],
    "yt_unpack_rows": [_P, _I64, _I64, _P, _I64, _I64, _P, _P, _P, _P],
    "yt_pruned_tile_bp": [_P, _I64, _P, _I64, _P, _P, _I, _I, _P, _P, _P],
    "yt_span_stats_bp": [_P, _I64, _I64, _P, _I64, _P, _I64, _P, _P, _P],
    "yt_span_score_bp": [_P, _I64, _I64, _P, _I64, _P, _I64, _P, _P, _P,
                         _P, _I64, _P],
    "yt_span_topk_bp_plan": [_I, _P],
    "yt_span_topk_bp": [_P, _I64, _I64, _P, _I64, _P, _I64, _P, _P, _P, _I,
                        _P, _I64, _P, _I64, _P, _P],
    "yt_topk_finish_bp": [_P, _P, _I, _P, _I64, _I64, _P, _I64, _P, _I64,
                          _I64, _I, _I, _P, _P],
    "yt_pack_block_batch": [_P, _P, _P, _P, _I, _I64, _P, _P, _P, _P, _P],
    "yt_ann_assign": [_P, _I, _I, _P, _I, _I, _P, _P],
    "yt_ann_fuse_scratch_bytes": [_I64, _I64, _I64],
    "yt_ann_fuse": [_P, _P, _P, _I64, _P, _I, _I, _I, _P, _P, _P],
    "yt_bm25_pass": [_P, _I, _P, _P, _P, _I64, _I, _P, _I, _I, _I, _I, _I,
                     _P, _P, _P],
    "yt_bm25_sums": [_P, _P, _I64, _P, _P],
    "yt_bm25_rows": [_P, _I, _P, _P, _P, _I64, _I, _P, _I, _I, _I, _I, _I,
                     _P, _P, _P],
    "yt_power_iterate": [_P, _P, _P, _P, _I, _P, _I64, _P, _P, _P, _I64, _P,
                         _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [shutil.which("nvcc")]
    if CUDA_HOME:
        cand.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _stamp() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile csrc/*.cu (one nvcc per source, all started together) and
    link them into the shared library; returns its path. A no-op when the
    stamp says the library is current. The compiler's resource report
    (-Xptxas -v) goes to build/kernels/build.log."""
    sources = sorted(CSRC.glob("*.cu"))
    lib = BUILD_DIR / LIB_NAME
    stamp_file = BUILD_DIR / "stamp"
    stamp = _stamp()
    if lib.exists() and stamp_file.exists() \
            and stamp_file.read_text() == stamp:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for src, _obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp),
         *[str(o) for _s, o, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    stamp_file.write_text(stamp)
    return lib


def library():
    """The loaded kernel library (built on first use), argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = (ctypes.c_int64
                              if name.endswith("_bytes") else ctypes.c_int)
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {rc}")


# launches of each kernel's CUDA path (never of its plain version): a run
# shows it went through a kernel by the count moving. WIDE counts the
# launches that took more than one live query slot (the batcher's waves),
# SLOTS the live slots of all launches (SLOTS / LAUNCHES: a wave's mean).
# Wrappers run on many threads (the batcher's dispatchers), so every
# update goes through count_launch under one lock.
LAUNCHES = {"cardinal_stats": 0, "cardinal_score": 0, "tie_topk": 0,
            "gather_topk": 0, "pruned_tile": 0, "span_stats": 0,
            "span_score": 0, "topk_finish": 0, "join_member": 0,
            "span_stats_batch": 0, "span_topk_batch": 0,
            "topk_finish_batch": 0,
            "join_member_batch": 0, "join_stats_batch": 0,
            "join_score_batch": 0, "dense_dot": 0,
            "rerank_sort": 0, "hybrid_blend": 0, "unpack_rows": 0,
            "pruned_tile_bp": 0, "span_stats_bp": 0, "span_score_bp": 0,
            "span_topk_bp": 0,
            "topk_finish_bp": 0, "pack_block_batch": 0, "ann_assign": 0,
            "ann_fuse": 0, "bm25_pass": 0, "power_iterate": 0,
            "gather_topk_batch": 0, "bm25_sums": 0, "bm25_rows": 0,
            "xjoin_probe": 0, "xjoin_apply": 0, "span_score_docids": 0}
WIDE = {name: 0 for name in LAUNCHES}
SLOTS = {name: 0 for name in LAUNCHES}
_count_lock = threading.Lock()


def count_launch(name: str, slots: int = 1) -> None:
    """One launch of `name` serving `slots` live query slots."""
    with _count_lock:
        LAUNCHES[name] += 1
        SLOTS[name] += slots
        if slots > 1:
            WIDE[name] += 1


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
            WIDE[name] = 0
            SLOTS[name] = 0


def require(t, name: str, dtypes, ndim: int, device) -> None:
    """Reject a tensor the kernel does not take (before any pointer
    leaves Python)."""
    import torch
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
