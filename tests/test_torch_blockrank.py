"""BlockRank in the port against the JAX package, on the CPU.

K17's plain version (kernels/blockrank.power_iterate_plain, the path of
every CPU tensor) against the JAX `_power_iterate_sparse`, run here by
XLA's CPU compiler, on edge lists of kernels/bench.edge_list (srcs, dsts
uniform from np.random.default_rng(seed), counts 1..4, normalised as
host_ranks_from_edges does) and on edge cases: equal to the bit, ranks and
all, on every shape. The
port repeats XLA's own order (csrc/blockrank.cu says which): the segment
sum from dm in edge order, the f32 fma of the update, `x / n` as `x *
(1 / n)`, and the dangling mass in XLA's tree order of windows of 32. The
trip count is compared with the numpy model below (JAX returns the ranks
only). Then the host functions (`host_ranks`, `host_ranks_from_edges`,
`postprocess_segment`) and the `postprocessing_p` servlet on the port's
stores against the JAX package's on equal stores fed the same documents:
equal dicts, columns and pages, no tolerance.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yacy_search_server_tpu.document.document import Anchor as JAnchor
from yacy_search_server_tpu.index import metadata as JM
from yacy_search_server_tpu.index.webgraph import WebgraphStore as JWG
from yacy_search_server_tpu.ops import blockrank as JB
from yacy_search_server_tpu.server.objects import ServerObjects as JObj
from yacy_search_server_tpu.server.servlets import lookup as jlookup
from yacy_search_server_tpu.webstructure import WebStructureGraph as JWS
from yacy_search_server_tpu_torch import convert
from yacy_search_server_tpu_torch.document.document import Anchor as TAnchor
from yacy_search_server_tpu_torch.index import metadata as TM
from yacy_search_server_tpu_torch.index.webgraph import WebgraphStore as TWG
from yacy_search_server_tpu_torch.kernels import bench as KB
from yacy_search_server_tpu_torch.kernels import blockrank as KBr
from yacy_search_server_tpu_torch.ops import blockrank as TB
from yacy_search_server_tpu_torch.server.objects import ServerObjects as TObj
from yacy_search_server_tpu_torch.server.servlets import lookup as tlookup
from yacy_search_server_tpu_torch.utils.hashes import url2hash
from yacy_search_server_tpu_torch.webstructure import \
    WebStructureGraph as TWS


def _jax(g, damping, n):
    return np.asarray(JB._power_iterate_sparse(
        *(jnp.asarray(a) for a in g), jnp.float32(damping), n))


def _steps_np(g, damping, n):
    """The trip count of the same iteration in numpy, with every rounding
    spelled out: the steps JAX's while_loop takes."""
    srcs, dsts, w, dangling = g
    d, inv, tele, r0, tol = KBr.step_consts(damping, n)
    r = np.full(n, r0, np.float32)
    delta, steps = np.float32(1), 0
    while delta > tol and steps < KBr.MAX_ITERS:
        s = KBr.xla_tree_sum(torch.from_numpy(
            np.where(dangling, r, np.float32(0)))).numpy()
        acc = np.full(n, np.float32(s * inv), np.float32)
        np.add.at(acc, dsts, (w * r[srcs]).astype(np.float32))
        r2 = KBr.fma_f32(d, torch.from_numpy(acc), tele).numpy()
        delta = np.abs(r2 - r).max()
        r, steps = r2, steps + 1
    return steps


def _plain(g, damping, n):
    return KBr.power_iterate(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in g), damping, n)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# the shapes the numpy model first matched JAX at (no dangling host), and
# the others: dangling hosts whose mass XLA sums in its tree order, n of
# 31 / 33 (no window / two windows), several tree levels
@pytest.mark.parametrize("n,e", [(64, 512), (4096, 65_536),
                                 (50_000, 800_000), (1000, 7000),
                                 (3000, 9000), (20_001, 60_000), (31, 100),
                                 (33, 40), (300_001, 3_000_000)])
def test_power_iterate_plain_equals_jax_to_the_bit(n, e):
    g = KB.edge_list(n, e, 0)
    r, steps = _plain(g, TB.DAMPING, n)
    np.testing.assert_array_equal(_bits(r.numpy()), _bits(_jax(g, TB.DAMPING,
                                                               n)))
    assert steps == _steps_np(g, TB.DAMPING, n)


def _edge_cases():
    zero = np.zeros(0, np.int32)
    cases = {
        "zipf_hubs": KB.host_graph(seed=11, n=20_000, sources=1000,
                                   mean_degree=40),
        "all_dangling": (zero, zero, np.zeros(0, np.float32),
                         np.ones(500, bool)),
        "n1_self_loop": (np.zeros(1, np.int32), np.zeros(1, np.int32),
                         np.ones(1, np.float32), np.zeros(1, bool)),
        "n1_dangling": (zero, zero, np.zeros(0, np.float32),
                        np.ones(1, bool)),
    }
    srcs, dsts, _w, _d = KB.edge_list(2000, 9000, 3)
    srcs[::7] = dsts[::7]                 # self-loops
    out_total = np.zeros(2000, np.float32)
    np.add.at(out_total, srcs, np.ones(len(srcs), np.float32))
    cases["self_loops"] = (srcs, dsts, (1.0 / out_total[srcs]).astype(
        np.float32), out_total == 0.0)
    return cases


@pytest.mark.parametrize("case", list(_edge_cases()))
@pytest.mark.parametrize("damping", [0.85, 0.5])
def test_power_iterate_plain_edge_graphs_equal_jax(case, damping):
    g = _edge_cases()[case]
    n = len(g[3])
    r, steps = _plain(g, damping, n)
    np.testing.assert_array_equal(_bits(r.numpy()),
                                  _bits(_jax(g, damping, n)))
    assert steps == _steps_np(g, damping, n)


@pytest.mark.parametrize("case", [0, 1, 2])
def test_power_iterate_plain_k17_graphs_equal_jax(case):
    """kernels/bench.k17_graphs (the card tests' K17 edge graphs): the
    plain version equals JAX to the bit and takes the steps JAX takes (the
    star all 50, the ring one)."""
    _label, g, damping, steps = KB.k17_graphs(KBr.HUB_MIN)[case]
    n = len(g[3])
    r, got = _plain(g, damping, n)
    np.testing.assert_array_equal(_bits(r.numpy()),
                                  _bits(_jax(g, damping, n)))
    assert got == _steps_np(g, damping, n)
    assert steps is None or got == steps


def _work_list_np(deg, hub_min):
    ids = np.arange(len(deg))
    tiers = [ids[deg > hub_min], ids[(deg > KBr.LIGHT) & (deg <= hub_min)]]
    tiers = [t[np.lexsort((t, -deg[t]))] for t in tiers]
    return np.concatenate(tiers), len(tiers[0]), len(tiers[1])


# K17's work list: hubs (more than hub_min in-edges) by descending
# in-degree, ties by host id, then the medium destinations the same way;
# the light ones (at most 32) are left out; degrees on every tier edge.
# `layout` on CPU tensors of a graph with those in-degrees (edges in a
# shuffled order), at the threshold given
@pytest.mark.parametrize("hub_min", [32, 33, 100, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_work_list_matches_numpy(seed, hub_min):
    rng = np.random.default_rng(seed)
    deg = rng.choice(np.array([0, 1, 31, 32, 33, 34, 99, 100, 101, 1024,
                               1025, 5000]), 3000)
    n = len(deg)
    dsts = rng.permutation(np.repeat(np.arange(n), deg)).astype(np.int32)
    srcs = rng.integers(0, n, len(dsts)).astype(np.int32)
    lay = KBr.layout(torch.from_numpy(srcs), torch.from_numpy(dsts),
                     torch.ones(len(dsts)), torch.zeros(n, dtype=torch.bool),
                     n, hub_min=hub_min)
    want, w_hub, w_med = _work_list_np(deg, hub_min)
    assert lay["order"].dtype == torch.int32
    assert (lay["n_hub"], lay["n_med"]) == (w_hub, w_med)
    np.testing.assert_array_equal(lay["order"].numpy(), want)
    np.testing.assert_array_equal(
        KBr.work_list(torch.from_numpy(deg), w_hub + w_med).numpy(), want)


def test_layout_work_list_on_the_tier_graph():
    """The card tests' tier graph laid out on the CPU: its 6 hubs longest
    first (host 10's 20,000 in-edges, the three of HUB_MIN + 2,000 by id,
    11's HUB_MIN + 1,000, 3's HUB_MIN + 1), then its 5 medium destinations
    (2's HUB_MIN, the three of 100 by id, 1's 33); every other host (host
    0's 32 in-edges among them) is light. The CSR keeps each
    destination's edges in edge order."""
    g = KB.tier_graph(KBr.HUB_MIN)
    n = len(g[3])
    lay = KBr.layout(*(torch.from_numpy(a) for a in g), n)
    order = lay["order"].numpy()
    h, m = lay["n_hub"], lay["n_med"]
    assert order[:h].tolist() == [10, 4, 5, 6, 11, 3]
    assert order[h:h + m].tolist() == [2, 7, 8, 9, 1]
    assert len(order) == h + m
    deg = np.diff(lay["rowptr"].numpy())
    assert (deg[[0] + list(range(12, n))] <= KBr.LIGHT).all()
    hm = KBr.HUB_MIN
    assert deg[:12].tolist() == [32, 33, hm, hm + 1, hm + 2000, hm + 2000,
                                 hm + 2000, 100, 100, 100, 20_000, hm + 1000]
    assert g[3][10] and not g[3][11]
    rp = lay["rowptr"].numpy()
    for v in (0, 3, 10):
        np.testing.assert_array_equal(lay["src_s"][rp[v]:rp[v + 1]].numpy(),
                                      g[0][g[1] == v])


def test_work_list_rejects_a_hub_threshold_below_a_threads_share():
    g = [torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
         torch.ones(4), torch.zeros(4, dtype=torch.bool)]
    with pytest.raises(ValueError, match="hub_min"):
        KBr.layout(*g, 4, hub_min=KBr.LIGHT - 1)


def test_step_constants_round_as_xla():
    # r0 is a double 1/n rounded once to f32 (jnp.full of a Python
    # float); it equals 1 / f32(n) below 2^24 and differs above
    for n in (1, 3, 1000, 300_001, 16_777_215):
        d, inv, tele, r0, tol = KBr.step_consts(0.85, n)
        assert r0 == np.float32(1) / np.float32(n) == inv
        assert tele == np.float32(np.float32(1) - np.float32(0.85)) * inv
    n = 2**24 + 1
    _d, inv, _t, r0, _tol = KBr.step_consts(0.85, n)
    assert r0 == np.float32(1.0 / n) and r0 != inv
    # the fma rounds once where a double sum would round twice: a * b =
    # 64 + 2^-30 exactly, + 2^30 lands in f64 on the f32 midpoint 2^30 +
    # 64 (ties to even: 2^30); the exact value rounds up to 2^30 + 128
    a = np.float32(1 + 2**-12)
    b = torch.tensor([64 * (1 - 2**-12 + 2**-24)], dtype=torch.float32)
    c = np.float32(2**30)
    naive = (np.float64(a) * b.double() + np.float64(c)).float()
    assert float(naive[0]) == 2**30
    assert float(KBr.fma_f32(a, b, c)[0]) == 2**30 + 128


def test_xla_tree_sum_order():
    """33 values: the padding of 31 splits 15 low, 16 high, so window 0
    holds x[0:17] and window 1 x[17:33]. With 1 at x[0] and 2^-24 at x[16],
    x[17], x[18] the windows are 1 and 2^-23 and the sum 1 + 2^-23; a sum
    left to right, or windows padded at the end only, give 1."""
    x = np.zeros(33, np.float32)
    x[0] = 1.0
    x[16:19] = 2**-24
    assert float(KBr.xla_tree_sum(torch.from_numpy(x))) == 1 + 2**-23
    seq = np.float32(0)
    for v in x:
        seq = np.float32(seq + v)
    assert float(seq) == 1.0


def test_power_iterate_sparse_entry_and_convert():
    g = KB.edge_list(300, 2000, 4)
    r = TB.power_iterate_sparse(*g, TB.DAMPING, 300, device="cpu")
    np.testing.assert_array_equal(_bits(r.numpy()),
                                  _bits(_jax(g, TB.DAMPING, 300)))
    t = convert.edges_from_numpy(*g, device="cpu")
    assert [a.dtype for a in t] == [torch.int32, torch.int32,
                                    torch.float32, torch.bool]
    r2 = TB.power_iterate_sparse(*t, TB.DAMPING, 300)
    assert torch.equal(r, r2)
    with pytest.raises(ValueError):
        convert.edges_from_numpy(g[0], g[1][:5], g[2], g[3], device="cpu")


# -- the host functions on the port's stores ---------------------------------

GRAPH = {
    "http://hub.test/": ["http://a.test/", "http://b.test/",
                         "http://c.test/"],
    "http://a.test/": ["http://b.test/"],
    "http://b.test/": ["http://a.test/", "http://hub.test/"],
    "http://c.test/": ["http://hub.test/", "http://hub.test/page2"],
}


def _stores(docs):
    """Equal JAX and port stores (webgraph, host graph, metadata) fed the
    same documents: [(url, title, text, [(target, text, rel)])]."""
    j = types.SimpleNamespace(webgraph=JWG(), metadata=JM.MetadataStore())
    t = types.SimpleNamespace(webgraph=TWG(), metadata=TM.MetadataStore())
    jws, tws = JWS(), TWS()
    for url, title, text, links in docs:
        uh = url2hash(url)
        host = url.split("/")[2]
        fields = dict(host_s=host, description_txt=text[:12],
                      exact_signature_l=len(title) % 3,
                      sku=url.replace("http://", "https://")
                      if len(text) % 5 == 0 else url)
        jd = j.metadata.put(JM.metadata_from_parsed(uh, url, title, text,
                                                    **fields))
        td = t.metadata.put(TM.metadata_from_parsed(uh, url, title, text,
                                                    **fields))
        assert jd == td
        j.webgraph.add_document_edges(jd, url, [
            JAnchor(url=u, text=x, rel=r) for u, x, r in links])
        t.webgraph.add_document_edges(td, url, [
            TAnchor(url=u, text=x, rel=r) for u, x, r in links])
        jws.add_document(url, [u for u, _x, _r in links])
        tws.add_document(url, [u for u, _x, _r in links])
    return j, t, jws, tws


def _graph_docs():
    return [(src, "t", "x", [(u, "x", "") for u in targets])
            for src, targets in GRAPH.items()]


def test_host_ranks_match_jax():
    docs = KB.link_docs(400, 60, anchors=10, seed=1)
    j, t, jws, tws = _stores(docs)
    want = JB.host_ranks(jws)
    got = TB.host_ranks(tws, device="cpu")
    assert list(got.items()) == list(want.items())
    want_e = JB.host_ranks_from_edges(j.webgraph)
    got_e = TB.host_ranks_from_edges(t.webgraph, device="cpu")
    assert list(got_e.items()) == list(want_e.items())
    for damping in (0.5, 0.99):
        assert TB.host_ranks(tws, damping, device="cpu") == \
            JB.host_ranks(jws, damping)
    # no hosts, and hosts without any edge
    assert TB.host_ranks(TWS(), device="cpu") == JB.host_ranks(JWS()) == {}
    assert TB.host_ranks_from_edges(TWG(), device="cpu") == {}
    lone_j, lone_t = JWG(), TWG()
    for s in (lone_j, lone_t):
        s.add_document_edges(0, "http://solo.test/", ["http://solo.test/x"])
    assert TB.host_ranks_from_edges(lone_t, device="cpu") == \
        JB.host_ranks_from_edges(lone_j)
    ws_j, ws_t = JWS(), TWS()
    for s in (ws_j, ws_t):
        s.add_document("http://solo.test/", ["http://solo.test/x"])
    assert TB.host_ranks(ws_t, device="cpu") == JB.host_ranks(ws_j)


def test_hub_graph_and_real_edges_agree_on_the_ports_stores():
    """tests/test_sitemap_blockrank.py's hub/a/b graph and
    tests/test_webgraph.py's agreement of the two paths, on the port."""
    ws = TWS()
    ws.add_document("http://a.test/1", ["http://hub.test/x"] * 3)
    ws.add_document("http://b.test/1", ["http://hub.test/y",
                                        "http://a.test/2"])
    ranks = TB.host_ranks(ws, device="cpu")
    assert set(ranks) >= {"a.test", "b.test", "hub.test"}
    assert ranks["hub.test"] == 1.0
    assert ranks["hub.test"] > ranks["a.test"] > 0
    assert ranks["b.test"] < ranks["a.test"]
    assert all(0 <= r <= 1 for r in ranks.values())
    jws = JWS()
    jws.add_document("http://a.test/1", ["http://hub.test/x"] * 3)
    jws.add_document("http://b.test/1", ["http://hub.test/y",
                                         "http://a.test/2"])
    assert ranks == JB.host_ranks(jws)

    _j, t, _jws, tws = _stores(_graph_docs())
    r_edges = TB.host_ranks_from_edges(t.webgraph, device="cpu")
    r_matrix = TB.host_ranks(tws, device="cpu")
    assert set(r_edges) == set(r_matrix)
    for h in r_edges:
        assert r_edges[h] == pytest.approx(r_matrix[h], abs=1e-5)
    assert max(r_edges.values()) == pytest.approx(1.0)
    assert all(0.0 < v <= 1.0 for v in r_edges.values())


@pytest.mark.parametrize("precomputed", [False, True])
def test_postprocess_segment_matches_jax(precomputed):
    docs = KB.link_docs(300, 40, anchors=8, seed=2)
    j, t, jws, tws = _stores(docs)
    j.metadata.delete(url2hash(docs[3][0]))
    t.metadata.delete(url2hash(docs[3][0]))
    ranks_j = JB.host_ranks(jws) if precomputed else None
    ranks_t = TB.host_ranks(tws, device="cpu") if precomputed else None
    n_j = JB.postprocess_segment(j, jws, ranks=ranks_j)
    n_t = TB.postprocess_segment(t, tws, ranks=ranks_t, device="cpu")
    assert n_t == n_j > 0
    assert list(t._host_ranks.items()) == list(j._host_ranks.items())
    for f in ("cr_host_norm_i",):
        np.testing.assert_array_equal(t.metadata.int_column(f),
                                      j.metadata.int_column(f))
    for d in range(j.metadata.capacity()):
        assert t.metadata.get(d) is None or \
            t.metadata.get(d).fields == j.metadata.get(d).fields
    # edges written after the pass carry the new partitions
    url, _ti, _te, links = docs[0]
    j.webgraph.add_document_edges(999, url, [JAnchor(url=u) for u, _x, _r
                                             in links],
                                  host_ranks=j._host_ranks)
    t.webgraph.add_document_edges(999, url, [TAnchor(url=u) for u, _x, _r
                                             in links],
                                  host_ranks=t._host_ranks)
    for i in range(j.webgraph.edge_count_total()):
        assert t.webgraph.edge(i) == j.webgraph.edge(i)
    # nothing to rank: nothing written
    assert TB.postprocess_segment(t, TWS(), device="cpu") == 0


def _sb(stores, ws, port):
    sb = types.SimpleNamespace(index=stores, web_structure=ws)
    if port:
        sb.torch_device = "cpu"
    return sb


@pytest.mark.parametrize("full", [False, True], ids=["hostmatrix",
                                                      "webgraph"])
@pytest.mark.parametrize("run", [False, True])
def test_postprocessing_servlet_matches_jax(full, run):
    docs = KB.link_docs(250, 50, anchors=8, seed=5)
    j, t, jws, tws = _stores(docs)
    if not full:
        j.webgraph, t.webgraph = JWG(), TWG()
    post = {"run": "1"} if run else {}
    post["maxhosts"] = "40"
    jpage = jlookup("postprocessing_p")({}, JObj(post), _sb(j, jws, False))
    tfn = tlookup("postprocessing_p")
    assert tfn is not None
    tpage = tfn({}, TObj(post), _sb(t, tws, True))
    assert tpage.as_dict() == jpage.as_dict()
    assert list(tpage.as_dict()) == list(jpage.as_dict())
    assert tpage.get("source") == ("webgraph" if full else "hostmatrix")
    assert int(tpage.get("hosts")) == 40
    if run:
        assert int(tpage.get("updated")) > 0
        for d in range(j.metadata.capacity()):
            jg, tg = j.metadata.get(d), t.metadata.get(d)
            assert (jg is None and tg is None) or jg.fields == tg.fields
    # and a second run changes no uniqueness flag on either
    if run:
        jp2 = jlookup("postprocessing_p")({}, JObj(post), _sb(j, jws, False))
        tp2 = tfn({}, TObj(post), _sb(t, tws, True))
        assert tp2.as_dict() == jp2.as_dict()
        assert tp2.get("uniqueness_updated") == "0"
