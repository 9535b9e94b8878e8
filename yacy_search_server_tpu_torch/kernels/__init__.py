"""Hand-written CUDA kernels of the port (sources in csrc/, built by nvcc
for sm_90a at first use) with their plain PyTorch versions and launch
counts. See build.py for the build and binding."""

from .build import LAUNCHES, SLOTS, WIDE, reset_launches
from .cardinal import cardinal_score, cardinal_stats
from .topk import gather_topk, tie_topk

__all__ = ["LAUNCHES", "SLOTS", "WIDE", "reset_launches", "cardinal_stats",
           "cardinal_score", "tie_topk", "gather_topk"]
