"""Webgraph edge store, memory-only — per-hyperlink columnar index.

The port's copy of the JAX package's index/webgraph.py (capability
equivalent of the reference's webgraph collection, reference:
source/net/yacy/search/schema/WebgraphSchema.java:34-100, written by
WebgraphConfiguration.getEdges, WebgraphConfiguration.java:141-291: one
subdocument per hyperlink of every indexed page). Edges are append-only
columns; re-indexing a source document retires its previous edges
(tombstone by source docid). BlockRank reads the cross-host edges as
dense (src, dst, count) arrays over a sorted host vocabulary
(`host_edge_arrays`), in the same order as the JAX store.

Memory-only: every edge lives in the RAM tail, as in a JAX WebgraphStore
opened without a data_dir (whose `compact` filters the tail). Segment
files, `snapshot` and the journal wait for the port's persistence; a
`data_dir` raises.
"""

from __future__ import annotations

import threading
from collections import defaultdict

import numpy as np

from ..utils.hashes import _split, safe_host, url2hash

# rel attribute coding (reference: WebgraphConfiguration.relEval:291 —
# "me"=1, "nofollow"=2; we extend with the other machine-meaningful rels)
REL_ME = 1
REL_NOFOLLOW = 2
REL_NOOPENER = 4
REL_UGC = 8
REL_SPONSORED = 16


def rel_flags(rel: str) -> int:
    flags = 0
    for token in rel.lower().split():
        if token == "me":
            flags |= REL_ME
        elif token == "nofollow":
            flags |= REL_NOFOLLOW
        elif token == "noopener":
            flags |= REL_NOOPENER
        elif token == "ugc":
            flags |= REL_UGC
        elif token == "sponsored":
            flags |= REL_SPONSORED
    return flags


TEXT_COLS = (
    "source_id_s",      # source url hash (12 chars)
    "source_host_s",
    "source_path_s",
    "target_id_s",      # target url hash
    "target_host_s",
    "target_path_s",
    "target_sku_s",     # full target url (reconstruction source for the
                        # reference's protocol/urlstub/file decompositions)
    "target_linktext_s",
    "target_rel_s",
    "target_alt_s",
    "target_name_t",
    "target_file_ext_s",
    "collection_sxt",
    # -- long tail (WebgraphSchema.java:34-100): url/host decompositions
    "source_protocol_s",
    "source_urlstub_s",
    "source_file_name_s",
    "source_file_ext_s",
    "source_path_folders_sxt",
    "source_host_subdomain_s",
    "source_host_organization_s",
    "source_host_dnc_s",
    "source_host_organizationdnc_s",
    "target_protocol_s",
    "target_urlstub_s",
    "target_file_name_s",
    "target_path_folders_sxt",
    "target_host_subdomain_s",
    "target_host_organization_s",
    "target_host_dnc_s",
    "target_host_organizationdnc_s",
    "target_parameter_key_sxt",
    "target_parameter_value_sxt",
    "source_parameter_key_sxt",
    "source_parameter_value_sxt",
    "source_host_id_s",        # 6-char host hash of the source host
    "target_host_id_s",
    "process_sxt",
    "harvestkey_s",
)
INT_COLS = (
    "source_docid_i",   # internal: retirement key on re-index
    "source_crawldepth_i",
    "source_chars_i",
    "target_chars_i",
    "target_order_i",
    "target_linktext_charcount_i",
    "target_linktext_wordcount_i",
    "target_relflags_i",
    "target_inbound_b",  # 1 when target host == source host
    "load_date_days_i",
    # -- long tail
    "source_path_folders_count_i",
    "target_path_folders_count_i",
    "target_parameter_count_i",
    "source_parameter_count_i",
    "target_alt_charcount_i",
    "target_alt_wordcount_i",
    "target_crawldepth_i",     # source depth + 1 (the link's depth)
    "last_modified_days_i",
    # citation-rank partitions of both endpoints, filled at WRITE time
    # from the segment's last blockrank pass (ops/blockrank.py stores
    # host ranks on the segment; edges written before the first pass
    # carry 0 — the rows are immutable, like every other column here)
    "source_cr_host_norm_i",
    "target_cr_host_norm_i",
)

# reference names carried under a different representation
# (WebgraphSchema.java checklist closure; same contract as
# metadata.FIELD_ALIASES): `id` is the internal edge row id,
# load_date_dt/last_modified are day-granular int columns
FIELD_ALIASES = {
    "id": "edge_row",
    "load_date_dt": "load_date_days_i",
    "last_modified": "last_modified_days_i",
}


class WebgraphStore:
    """Columnar hyperlink store (memory-only: the journaled tail of the
    JAX store, without its segments)."""

    def __init__(self, data_dir: str | None = None):
        if data_dir:
            raise NotImplementedError(
                "the port's WebgraphStore is memory-only: persistence "
                "(segment files, snapshot, journal) is not ported yet")
        self._lock = threading.RLock()
        self._text: dict[str, list] = {c: [] for c in TEXT_COLS}
        self._ints: dict[str, list] = {c: [] for c in INT_COLS}
        self._by_source_docid: dict[int, list[int]] = defaultdict(list)
        self._by_target_id: dict[str, list[int]] = defaultdict(list)
        self._by_source_host: dict[str, list[int]] = defaultdict(list)
        self._dead: set[int] = set()           # edge row ids

    # -- write path ----------------------------------------------------------

    @staticmethod
    def _hosthash_of(hosthash_fn, url: str) -> str:
        try:
            return hosthash_fn(url2hash(url)).decode("ascii", "replace")
        except Exception:
            return ""

    def add_document_edges(self, source_docid: int, source_url: str,
                           anchors, crawldepth: int = 0,
                           collection: str = "", load_date_days: int = 0,
                           last_modified_days: int = 0,
                           host_ranks: dict | None = None) -> int:
        """Record one indexed document's outbound hyperlinks; returns the
        number of edges written (WebgraphConfiguration.getEdges parity:
        one edge per anchor, with link text/alt/rel and the inbound flag)."""
        # _split tolerates malformed URLs (the identity layer's contract:
        # scraped hrefs must never crash indexing) where raw urlsplit raises
        from urllib.parse import parse_qsl

        from ..utils.hashes import (_split_host, host_dnc, hosthash,
                                    url_file_ext)
        from .metadata import join_multi_positional
        src_host = safe_host(source_url)
        src_split = _split(source_url)
        src_path = src_split[3]
        src_query = src_split[4] if len(src_split) > 4 else ""
        try:
            src_id = url2hash(source_url).decode("ascii")
        except Exception:
            return 0
        src_qs = parse_qsl(src_query, keep_blank_values=True)

        def _decomp(url, host, path):
            """Shared url/host decomposition columns (prefix applied by
            the caller) — WebgraphSchema's *_protocol/urlstub/file/
            folders/host_* groups."""
            proto = url.split("://", 1)[0] if "://" in url else "http"
            parts = [p for p in path.split("/") if p]
            fname = "" if (path.endswith("/") or not parts) else parts[-1]
            folders = parts if not fname else parts[:-1]
            subdom, org = _split_host(host)
            dnc, orgdnc = host_dnc(host)
            return {
                "protocol_s": proto,
                "urlstub_s": url.split("://", 1)[-1],
                "file_name_s": fname,
                "file_ext_s": url_file_ext(url),
                "path_folders_sxt": join_multi_positional(folders),
                "path_folders_count_i": len(folders),
                "host_subdomain_s": subdom,
                "host_organization_s": org,
                "host_dnc_s": dnc,
                "host_organizationdnc_s": orgdnc,
            }

        src_decomp = {f"source_{k}": v
                      for k, v in _decomp(source_url, src_host,
                                          src_path).items()}
        rows = []
        for order, a in enumerate(anchors):
            target_url = getattr(a, "url", None) or str(a)
            tgt_host = safe_host(target_url)
            if not tgt_host:
                continue
            _sch, _h, _po, path, query = _split(target_url)
            ext = url_file_ext(target_url)
            try:
                tgt_id = url2hash(target_url).decode("ascii")
            except Exception:
                continue
            text = getattr(a, "text", "") or ""
            rel = getattr(a, "rel", "") or ""
            alt = getattr(a, "alt", "") or ""
            name = getattr(a, "name", "") or ""
            tgt_decomp = {f"target_{k}": v
                          for k, v in _decomp(target_url, tgt_host,
                                              path).items()
                          if k != "file_ext_s"}   # kept as its own column
            qs = parse_qsl(query, keep_blank_values=True)
            rows.append({
                **src_decomp,
                **tgt_decomp,
                "target_parameter_count_i": len(qs),
                "target_parameter_key_sxt": join_multi_positional(
                    k for k, _v in qs),
                "target_parameter_value_sxt": join_multi_positional(
                    v for _k, v in qs),
                "source_parameter_count_i": len(src_qs),
                "source_parameter_key_sxt": join_multi_positional(
                    k for k, _v in src_qs),
                "source_parameter_value_sxt": join_multi_positional(
                    v for _k, v in src_qs),
                "source_host_id_s": self._hosthash_of(hosthash, source_url),
                "target_host_id_s": self._hosthash_of(hosthash, target_url),
                "target_crawldepth_i": crawldepth + 1,
                "last_modified_days_i": last_modified_days,
                "source_cr_host_norm_i": int(round(
                    (host_ranks or {}).get(src_host, 0.0) * 10)),
                "target_cr_host_norm_i": int(round(
                    (host_ranks or {}).get(tgt_host, 0.0) * 10)),
                "target_alt_charcount_i": len(alt),
                "target_alt_wordcount_i": len(alt.split()) if alt else 0,
                "source_id_s": src_id,
                "source_host_s": src_host,
                "source_path_s": src_path,
                "target_id_s": tgt_id,
                "target_host_s": tgt_host,
                "target_path_s": path,
                "target_sku_s": target_url,
                "target_linktext_s": text[:512],
                "target_rel_s": rel,
                "target_alt_s": alt[:512],
                "target_name_t": name,
                "target_file_ext_s": ext,
                "collection_sxt": collection,
                "source_docid_i": source_docid,
                "source_crawldepth_i": crawldepth,
                "source_chars_i": len(source_url),
                "target_chars_i": len(target_url),
                "target_order_i": order,
                "target_linktext_charcount_i": len(text),
                "target_linktext_wordcount_i": len(text.split()) if text else 0,
                "target_relflags_i": rel_flags(rel),
                "target_inbound_b": int(tgt_host == src_host),
                "load_date_days_i": load_date_days,
            })
        if not rows:
            return 0
        with self._lock:
            for row in rows:
                self._append(row)
        return len(rows)

    def _append(self, row: dict) -> None:
        local = len(self._ints["source_docid_i"])
        for c in TEXT_COLS:
            self._text[c].append(row.get(c, ""))
        for c in INT_COLS:
            self._ints[c].append(int(row.get(c, 0)))
        self._by_source_docid[row["source_docid_i"]].append(local)
        self._by_target_id[row["target_id_s"]].append(local)
        self._by_source_host[row["source_host_s"]].append(local)

    # compaction floor: merges only bother once this many rows are dead
    COMPACT_MIN_DEAD = 10_000

    def remove_source(self, source_docid: int) -> int:
        """Retire all edges written by a (re-indexed or deleted) document."""
        with self._lock:
            idxs = list(self._by_source_docid.get(source_docid, ()))
            fresh = [i for i in idxs if i not in self._dead]
            self._dead.update(fresh)
            self._by_source_docid.pop(source_docid, None)
            # dead-majority auto-compaction: memory stays proportional to
            # LIVE edges over unbounded recrawl cycles
            if (len(self._dead) >= self.COMPACT_MIN_DEAD
                    and len(self._dead) * 2 >= self.edge_count_total()):
                self.compact()
            return len(fresh)

    # -- read path -----------------------------------------------------------

    def edge(self, idx: int) -> dict:
        row = {c: self._text[c][idx] for c in TEXT_COLS}
        row.update({c: self._ints[c][idx] for c in INT_COLS})
        return row

    def _alive(self, idxs) -> list[int]:
        return [i for i in idxs if i not in self._dead]

    def edges_from_host(self, host: str) -> list[dict]:
        with self._lock:
            return [self.edge(i) for i in self._alive(
                self._by_source_host.get(host.lower(), ()))]

    def edges_to(self, target_urlhash: bytes | str) -> list[dict]:
        key = target_urlhash.decode("ascii") \
            if isinstance(target_urlhash, bytes) else target_urlhash
        with self._lock:
            return [self.edge(i) for i in self._alive(
                self._by_target_id.get(key, ()))]

    def anchor_texts(self, target_urlhash: bytes | str,
                     skip_nofollow: bool = True) -> list[str]:
        """Inbound link texts of a target (the anchor-text ranking signal the
        reference derives from webgraph subdocuments)."""
        texts = []
        for e in self.edges_to(target_urlhash):
            if skip_nofollow and (e["target_relflags_i"] & REL_NOFOLLOW):
                continue
            if e["target_linktext_s"]:
                texts.append(e["target_linktext_s"])
        return texts

    def inbound_count(self, target_urlhash: bytes | str) -> int:
        key = target_urlhash.decode("ascii") \
            if isinstance(target_urlhash, bytes) else target_urlhash
        with self._lock:
            return len(self._alive(self._by_target_id.get(key, ())))

    # -- aggregate views -----------------------------------------------------

    def host_matrix(self) -> dict[str, dict[str, int]]:
        """src host -> {dst host: edge count}, cross-host edges only — the
        WebStructureGraph-shaped aggregation (parity surface for the
        host-matrix BlockRank path)."""
        out: dict[str, dict[str, int]] = defaultdict(dict)
        # snapshot references under the lock, count outside it: the tail
        # lists are append-only
        with self._lock:
            src = list(self._text["source_host_s"])
            dst = list(self._text["target_host_s"])
            dead = set(self._dead)
        for i in range(len(src)):
            if i in dead or src[i] == dst[i] or not src[i]:
                continue
            row = out[src[i]]
            row[dst[i]] = row.get(dst[i], 0) + 1
        return dict(out)

    def host_edge_arrays(self):
        """(src_hosts, dst_hosts, counts) as aligned arrays over a sorted
        host vocabulary — the input BlockRank's power iteration consumes
        directly. Edge order: source hosts in order of first appearance,
        each source's targets in order of first appearance."""
        matrix = self.host_matrix()
        hosts = set(matrix)
        for row in matrix.values():
            hosts.update(row)
        hosts = sorted(hosts)
        idx = {h: i for i, h in enumerate(hosts)}
        srcs, dsts, counts = [], [], []
        for s, row in matrix.items():
            for d, c in row.items():
                srcs.append(idx[s])
                dsts.append(idx[d])
                counts.append(c)
        return (hosts, np.asarray(srcs, dtype=np.int32),
                np.asarray(dsts, dtype=np.int32),
                np.asarray(counts, dtype=np.float32))

    def host_link_graph(self, host: str):
        """All alive edges with source inside `host`, split into in-host and
        outbound lists — the linkstructure API's working set."""
        inhost, outbound = [], []
        for e in self.edges_from_host(host):
            (inhost if e["target_inbound_b"] else outbound).append(e)
        return inhost, outbound

    def __len__(self) -> int:
        with self._lock:
            return self.edge_count_total() - len(self._dead)

    def edge_count_total(self) -> int:
        with self._lock:
            return len(self._ints["source_docid_i"])

    def compact(self) -> None:
        """Drop all tombstoned rows (edge ids are internal, so the
        renumbering is invisible outside)."""
        with self._lock:
            if not self._dead:
                return
            keep = [i for i in range(len(self._ints["source_docid_i"]))
                    if i not in self._dead]
            for c in TEXT_COLS:
                col = self._text[c]
                self._text[c] = [col[i] for i in keep]
            for c in INT_COLS:
                col = self._ints[c]
                self._ints[c] = [col[i] for i in keep]
            self._dead = set()
            self._by_source_docid = defaultdict(list)
            self._by_target_id = defaultdict(list)
            self._by_source_host = defaultdict(list)
            for idx in range(len(self._ints["source_docid_i"])):
                self._by_source_docid[
                    self._ints["source_docid_i"][idx]].append(idx)
                self._by_target_id[self._text["target_id_s"][idx]].append(idx)
                self._by_source_host[
                    self._text["source_host_s"][idx]].append(idx)
