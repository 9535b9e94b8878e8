"""Counted fault points for tests: the port's own copy of what the JAX
package's utils/faultinject.py offers for `device.transfer_fail`.

A test arms a point with a count (`set_fault("device.transfer_fail",
n)`); each `take` of an armed point consumes one charge and returns
True, and at zero the point disarms itself ("the device comes back").
The store charges one `take` a fetch attempt and one a rebuild probe,
at the places the JAX store does, so one schedule armed in both
packages drives both stores through the same retries, losses and
recoveries. `dense.upload_fail` (the port's own) fails one upload or
patch of the dense forward index (index/dense.py). Nothing is armed unless a caller arms it; an unarmed `take`
is one flag read.
"""

from __future__ import annotations

import threading

# every point a caller may arm
POINTS = ("device.transfer_fail", "dense.upload_fail")

_lock = threading.Lock()
_faults: dict[str, int] = {}
_active = False   # the fast path: no point armed


def set_fault(name: str, count: int) -> None:
    """Arm `name` with `count` charges."""
    global _active
    if name not in POINTS:
        raise KeyError(f"unknown fault point {name!r}, not in {POINTS}")
    with _lock:
        _faults[name] = int(count)
        _active = True


def clear(name: str | None = None) -> None:
    """Disarm one point, or every point."""
    global _active
    with _lock:
        if name is None:
            _faults.clear()
        else:
            _faults.pop(name, None)
        _active = bool(_faults)


def take(name: str) -> bool:
    """Consume one charge of `name`: True while it had one."""
    global _active
    if not _active:
        return False
    with _lock:
        n = _faults.get(name)
        if n is None:
            return False
        if n <= 1:
            _faults.pop(name)
            _active = bool(_faults)
            return n == 1
        _faults[name] = n - 1
        return True
