"""serverObjects — the request/response property multimap.

Capability equivalent of the reference's `serverObjects`
(reference: source/net/yacy/server/serverObjects.java): a string→string
property map shared between servlet and template, with XSS-safe putters
(putHTML/putXML/putJSON escape for their output medium) and loop counters
(put(key, n) + put(f"{key}_{i}_{field}", v) backs the #{key}# template
loop grammar).

The port's copy of the JAX package's module of the same name.
"""

from __future__ import annotations

import html
from typing import Any, Iterator


def escape_html(s: str) -> str:
    return html.escape(str(s), quote=True)


def escape_xml(s: str) -> str:
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;")
            .replace("'", "&apos;"))


def escape_json(s: str) -> str:
    out = []
    for ch in str(s):
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\r":
            out.append("\\r")
        elif ch == "\t":
            out.append("\\t")
        elif ord(ch) < 0x20:
            out.append("\\u%04x" % ord(ch))
        else:
            out.append(ch)
    return "".join(out)


class ServerObjects:
    """String-keyed property map; values are stored as strings."""

    def __init__(self, initial: dict | None = None):
        self._map: dict[str, str] = {}
        # when set, the HTTP layer sends this body verbatim instead of
        # rendering a template (structured responses like Solr-shape JSON
        # or PNG graphics, the reference's custom response writers);
        # bytes bodies use raw_ctype as their content type
        self.raw_body: str | bytes | None = None
        self.raw_ctype: str | None = None
        if initial:
            for k, v in initial.items():
                self.put(k, v)

    # -- putters ------------------------------------------------------------

    def put(self, key: str, value: Any) -> None:
        if isinstance(value, bool):
            value = "1" if value else "0"
        self._map[str(key)] = str(value)

    def put_html(self, key: str, value: Any) -> None:
        self._map[str(key)] = escape_html(value)

    def put_xml(self, key: str, value: Any) -> None:
        self._map[str(key)] = escape_xml(value)

    def put_json(self, key: str, value: Any) -> None:
        self._map[str(key)] = escape_json(value)

    def put_num(self, key: str, value) -> None:
        """Grouped-digits number formatting (putNum parity)."""
        if isinstance(value, float):
            self._map[str(key)] = f"{value:,.3f}"
        else:
            self._map[str(key)] = f"{int(value):,}"

    # -- getters ------------------------------------------------------------

    def get(self, key: str, default: str = "") -> str:
        return self._map.get(str(key), default)

    def get_int(self, key: str, default: int = 0) -> int:
        try:
            return int(self._map.get(str(key), ""))
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._map.get(str(key))
        if v is None:
            return default
        return v.lower() in ("1", "true", "on", "yes")

    def __contains__(self, key: str) -> bool:
        return str(key) in self._map

    def __iter__(self) -> Iterator[str]:
        return iter(self._map)

    def items(self):
        return self._map.items()

    def __len__(self) -> int:
        return len(self._map)

    def as_dict(self) -> dict[str, str]:
        return dict(self._map)
