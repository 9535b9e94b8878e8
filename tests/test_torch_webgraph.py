"""The port's memory-only WebgraphStore and its WebStructureGraph against
the JAX package's, on the CPU.

Both packages take the same documents' anchors (malformed urls, nofollow
and other rels, in-host links, query parameters, plain-string anchors,
rows written after a BlockRank pass with host ranks); every column of
every edge, the host matrix, `host_edge_arrays` (arrays and order),
retirement by source docid and what follows it (the views, compaction),
inbound counts and anchor texts must be equal. The host link graphs must
keep the same `outgoing` order, evict the same hosts past `max_hosts`, and
save and load the same jsonl. No tolerance: Python values compared with
==, arrays to the bit.
"""

import types

import numpy as np
import pytest

from yacy_search_server_tpu.document.document import Anchor as JAnchor
from yacy_search_server_tpu.index import webgraph as JW
from yacy_search_server_tpu.webstructure import WebStructureGraph as JWS
from yacy_search_server_tpu_torch.document.document import Anchor as TAnchor
from yacy_search_server_tpu_torch.index import webgraph as TW
from yacy_search_server_tpu_torch.kernels import bench as KB
from yacy_search_server_tpu_torch.utils.hashes import url2hash
from yacy_search_server_tpu_torch.webstructure import \
    WebStructureGraph as TWS

ODD = [
    ("http://[::1", "broken ipv6", ""),
    ("javascript:void(0)", "js", ""),
    ("mailto:someone@example.com", "mail", ""),
    ("relative/page.html", "relative", ""),
    ("", "empty", ""),
    ("http://exa mple.com/space", "space", "nofollow"),
    ("http://[::1]:8080/v6?x=1&y=", "v6", "NoFollow ugc"),
    ("https://UPPER.example.com:8443/A/B/c.PDF?k=v&k2=", "upper",
     "me noopener sponsored"),
    ("ftp://files.example.org/pub/", "", "external"),
    ("http://localhost/admin", "local", ""),
]


def _docs():
    """(docid, source url, anchors) of the link_docs documents plus the
    odd cases, re-indexing two sources."""
    out = []
    for d, (url, _title, _text, links) in enumerate(
            KB.link_docs(120, 25, anchors=6, seed=7)):
        out.append((d, url, links))
    out.append((120, "http://odd.test/index.html?session=1", ODD))
    out.append((121, "http://[::1", ODD[:3]))
    out.append((122, "http://odd.test/", [("http://odd.test/self", "in", "")]))
    return out


def _anchors(links, Anchor, kind):
    if kind == "plain":
        return [u for u, _t, _r in links]
    if kind == "attrs":
        return [types.SimpleNamespace(url=u, text=t, rel=r, alt=t[:3],
                                      name=f"n{i}")
                for i, (u, t, r) in enumerate(links)]
    return [Anchor(url=u, text=t, rel=r) for u, t, r in links]


def _feed(j, t, docs, host_ranks=None, start=0):
    kinds = ("anchor", "plain", "attrs")
    for i, (d, url, links) in enumerate(docs):
        kind = kinds[(i + start) % 3]
        kw = dict(crawldepth=i % 4, collection="user,c2",
                  load_date_days=20000 + i, last_modified_days=19000 + i,
                  host_ranks=host_ranks)
        assert j.add_document_edges(d, url, _anchors(links, JAnchor, kind),
                                    **kw) == \
            t.add_document_edges(d, url, _anchors(links, TAnchor, kind), **kw)


def _same(j, t, docs):
    assert len(j) == len(t) and j.edge_count_total() == t.edge_count_total()
    for i in range(j.edge_count_total()):
        assert j.edge(i) == t.edge(i)
    jm, tm = j.host_matrix(), t.host_matrix()
    assert jm == tm
    assert [(s, list(r.items())) for s, r in jm.items()] == \
        [(s, list(r.items())) for s, r in tm.items()]
    jh, js, jd, jc = j.host_edge_arrays()
    th, ts, td, tc = t.host_edge_arrays()
    assert jh == th
    for a, b in ((js, ts), (jd, td), (jc, tc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    hosts = {TW.safe_host(u) for _d, u, _l in docs} | {"nohost.test", ""}
    for h in sorted(hosts):
        assert j.edges_from_host(h) == t.edges_from_host(h)
        assert j.host_link_graph(h) == t.host_link_graph(h)
    targets = {e["target_id_s"] for e in (j.edge(i) for i in
                                          range(j.edge_count_total()))}
    for tid in sorted(targets)[:200] + ["AAAAAAAAAAAA"]:
        for key in (tid, tid.encode()):
            assert j.inbound_count(key) == t.inbound_count(key)
            assert j.edges_to(key) == t.edges_to(key)
            for skip in (True, False):
                assert j.anchor_texts(key, skip) == t.anchor_texts(key, skip)


def test_constants_match_jax():
    assert TW.TEXT_COLS == JW.TEXT_COLS and TW.INT_COLS == JW.INT_COLS
    assert TW.FIELD_ALIASES == JW.FIELD_ALIASES
    for rel in ("", "me", "NoFollow ugc", "sponsored noopener me x",
                "nofollow nofollow"):
        assert TW.rel_flags(rel) == JW.rel_flags(rel)


def test_edges_match_jax():
    j, t = JW.WebgraphStore(), TW.WebgraphStore()
    docs = _docs()
    _feed(j, t, docs)
    _same(j, t, docs)
    # rows written after a BlockRank pass carry both endpoints' partitions
    ranks = {"host00001.test": 0.95, "host00003.test": 0.449999,
             "odd.test": 0.05, "upper.example.com": 1.0}
    later = [(200 + d, u, links) for d, u, links in docs[:30]]
    _feed(j, t, later, host_ranks=ranks, start=1)
    _same(j, t, docs)
    assert any(t.edge(i)["target_cr_host_norm_i"]
               for i in range(t.edge_count_total()))


def test_remove_source_and_compaction_match_jax():
    j, t = JW.WebgraphStore(), TW.WebgraphStore()
    docs = _docs()
    _feed(j, t, docs)
    for d in (0, 5, 5, 121, 999, 120):
        assert j.remove_source(d) == t.remove_source(d)
    _same(j, t, docs)
    # re-index a removed source, then compact with a low floor on both
    _feed(j, t, [(0, docs[0][1], docs[0][2])])
    j.COMPACT_MIN_DEAD = t.COMPACT_MIN_DEAD = 20
    total = t.edge_count_total()
    for d in range(1, 110):
        assert j.remove_source(d) == t.remove_source(d)
    _same(j, t, docs)
    # the dead majority compacted both tails
    assert len(t._dead) == len(j._dead)
    assert t.edge_count_total() == j.edge_count_total() < total
    j.compact()
    t.compact()
    _same(j, t, docs)
    with pytest.raises(NotImplementedError):
        TW.WebgraphStore(data_dir="webgraph-dir")


def _ws_pair(max_hosts):
    return JWS(max_hosts=max_hosts), TWS(max_hosts=max_hosts)


def _same_ws(j, t):
    assert j.source_hosts() == t.source_hosts()
    for h in j.source_hosts() + ["nohost.test", "HOST00001.TEST"]:
        assert list(j.outgoing(h).items()) == list(t.outgoing(h).items())
        assert j.incoming(h) == t.incoming(h)
        assert j.references_count(h) == t.references_count(h)
        assert j.hosthash(h) == t.hosthash(h)
    assert j.host_count() == t.host_count()
    assert j.top_hosts(7) == t.top_hosts(7)


def test_webstructure_order_and_eviction_match_jax():
    docs = KB.link_docs(300, 60, anchors=8, seed=3)
    for max_hosts in (50_000, 17):
        j, t = _ws_pair(max_hosts)
        for url, _ti, _te, links in docs:
            targets = [u for u, _t, _r in links] + ["", "relative.html"]
            j.add_document(url, targets)
            t.add_document(url, targets)
        _same_ws(j, t)
        if max_hosts == 17:
            assert t.host_count() == 17
    for s in (j, t):
        with pytest.raises(ValueError):
            s.add_document("http://[::1", ["http://a.test/"])


def test_webstructure_save_and_load_match_jax(tmp_path):
    j = JWS(data_dir=str(tmp_path / "jax"))
    t = TWS(data_dir=str(tmp_path / "port"))
    for url, _ti, _te, links in KB.link_docs(80, 20, anchors=5, seed=4):
        j.add_document(url, [u for u, _t, _r in links])
        t.add_document(url, [u for u, _t, _r in links])
    j.close()
    t.close()
    jt = (tmp_path / "jax" / "webstructure.jsonl").read_text()
    assert (tmp_path / "port" / "webstructure.jsonl").read_text() == jt
    # a torn line is skipped by both
    for sub in ("jax", "port"):
        with open(tmp_path / sub / "webstructure.jsonl", "a") as f:
            f.write('{"h": "torn.test", "o": {"x": \n')
    j2 = JWS(data_dir=str(tmp_path / "jax"))
    t2 = TWS(data_dir=str(tmp_path / "port"))
    _same_ws(j2, t2)
    _same_ws(j, t2)
    assert url2hash("http://a.test/")[6:] == t2.hosthash("a.test")
