"""Servlet registry — the htroot dispatch table of the port.

The reference compiles `htroot/<Name>.java` classes and invokes their
static `respond(RequestHeader, serverObjects, serverSwitch)` by reflection
(reference: source/net/yacy/http/servlets/YaCyDefaultServlet.java:658,
765-785). As in the JAX package, servlets are plain functions with the
same signature, registered by name. The port registers only the servlets
it has ported (`api.postprocessing_p`).
"""

from __future__ import annotations

from typing import Callable

from ..objects import ServerObjects

Servlet = Callable[[dict, ServerObjects, object], ServerObjects]

_REGISTRY: dict[str, Servlet] = {}


def servlet(name: str):
    def deco(fn: Servlet) -> Servlet:
        _REGISTRY[name] = fn
        return fn
    return deco


def lookup(name: str) -> Servlet | None:
    _ensure_loaded()
    return _REGISTRY.get(name)


_loaded = False


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    from . import api  # noqa: F401
