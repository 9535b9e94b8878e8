"""WebStructureGraph — the host-level link matrix.

Capability equivalent of the reference's web structure accounting
(reference: source/net/yacy/peers/graphics/WebStructureGraph.java:71-159:
per-document host->host link recording into old/new structure maps,
persisted, feeding citation ranking, the webstructure API and the
network graphics). Here: a host adjacency count matrix with jsonl
persistence and the accessors the API layer serves
(outgoing/incoming/references).

The port's copy of the JAX package's module of the same name.
"""

from __future__ import annotations

import json
import os
import threading
from collections import defaultdict
from urllib.parse import urlsplit

from .utils.hashes import hosthash, url2hash


def host_of(url: str) -> str:
    return urlsplit(url).netloc.lower()


class WebStructureGraph:
    def __init__(self, data_dir: str | None = None,
                 max_hosts: int = 50_000):
        self.max_hosts = max_hosts
        self._out: dict[str, dict[str, int]] = defaultdict(dict)
        self._lock = threading.Lock()
        self._path = None
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._path = os.path.join(data_dir, "webstructure.jsonl")
            self._load()

    # lint: unlocked-ok(construction-time: only __init__ calls this,
    # before the graph is shared with any other thread)
    def _load(self) -> None:
        if not (self._path and os.path.exists(self._path)):
            return
        with open(self._path, encoding="utf-8") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    self._out[rec["h"]] = {k: int(v)
                                           for k, v in rec["o"].items()}
                except (json.JSONDecodeError, KeyError, ValueError):
                    continue

    # -- write path (learnrefs / storeDocument hook) ------------------------

    def add_document(self, source_url: str, target_urls: list[str]) -> None:
        src = host_of(source_url)
        if not src:
            return
        with self._lock:
            row = self._out[src]
            for t in target_urls:
                dst = host_of(t)
                if not dst or dst == src:
                    continue
                row[dst] = row.get(dst, 0) + 1
            if len(self._out) > self.max_hosts:
                # evict the smallest rows (the reference caps its maps too)
                victim = min(self._out, key=lambda h: len(self._out[h]))
                del self._out[victim]

    # -- read path -----------------------------------------------------------

    def outgoing(self, host: str) -> dict[str, int]:
        with self._lock:
            return dict(self._out.get(host.lower(), {}))

    def incoming(self, host: str) -> dict[str, int]:
        host = host.lower()
        with self._lock:
            return {src: row[host] for src, row in self._out.items()
                    if host in row}

    def references_count(self, host: str) -> int:
        """Number of distinct hosts linking to `host` (the CRh signal)."""
        return len(self.incoming(host))

    def host_count(self) -> int:
        with self._lock:
            return len(self._out)

    def source_hosts(self) -> list[str]:
        """Every host that has outgoing links recorded."""
        with self._lock:
            return list(self._out.keys())

    def top_hosts(self, n: int = 20) -> list[tuple[str, int]]:
        """Hosts by inbound reference count."""
        counts: dict[str, int] = defaultdict(int)
        with self._lock:
            for row in self._out.values():
                for dst in row:
                    counts[dst] += 1
        return sorted(counts.items(), key=lambda kv: -kv[1])[:n]

    def hosthash(self, host: str) -> bytes:
        # hashes.hosthash slices the host part out of a 12-byte url hash,
        # so the host must be run through url2hash first
        return hosthash(url2hash("http://" + host + "/"))

    # -- persistence ---------------------------------------------------------

    def save(self) -> None:
        if not self._path:
            return
        with self._lock, open(self._path, "w", encoding="utf-8") as f:
            for h, row in self._out.items():
                f.write(json.dumps({"h": h, "o": row}) + "\n")

    def close(self) -> None:
        self.save()
