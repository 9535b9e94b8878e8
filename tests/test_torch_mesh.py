"""PyTorch port of parallel/mesh: the fusion and the doc-sharded step.

The JAX side runs on the 8-device virtual CPU mesh (conftest), where
fused_gather_topk takes its lax path, which shares the tie_topk epilogue
the Pallas kernel is pinned to. The port runs one card's worth of the
step with its plain versions (device="cpu") and must be bit-identical;
BM25 agrees to rtol=1e-5.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as PS

from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.ops import ranking as JR
from yacy_search_server_tpu.parallel import mesh as JM
from yacy_search_server_tpu_torch import convert
from yacy_search_server_tpu_torch.index import postings as TP
from yacy_search_server_tpu_torch.kernels import gather_topk
from yacy_search_server_tpu_torch.kernels.topk import gather_topk_plain
from yacy_search_server_tpu_torch.parallel import mesh as TM


def _cpu8():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return devs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scores(n, dtype, rng):
    if dtype == np.int32:
        return rng.integers(0, 6, n).astype(np.int32) * 1000
    s = rng.integers(0, 6, n).astype(np.float32) * 0.5
    s[::11] = -0.0
    s[::13] = 0.0
    s[::17] = -np.inf
    return s


def _random_postings(n, seed=0):
    rng = np.random.default_rng(seed)
    docids = np.arange(n, dtype=np.int32)
    feats = rng.integers(0, 500, (n, JP.NF)).astype(np.int32)
    feats[:, JP.F_FLAGS] = rng.integers(0, 2**20, n)
    feats[:, JP.F_LANGUAGE] = np.where(rng.random(n) < 0.5,
                                       JP.pack_language("en"),
                                       JP.pack_language("de"))
    feats[:, JP.F_DOMLENGTH] = rng.integers(0, 256, n)
    hosts = [bytes([i % 13, 7]) for i in range(n)]
    return feats, docids, hosts


def test_pad_to_shards_matches():
    for n, s in ((1, 8), (1024, 8), (1025, 8), (5000, 1), (1, 1)):
        assert TM.pad_to_shards(n, s) == JM.pad_to_shards(n, s)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("k", [1, 20, 500])
def test_tie_topk_bit_identical(dtype, k):
    rng = np.random.default_rng(1)
    s = _scores(300, dtype, rng)
    if dtype == np.int32:
        s[5] = -(2**31)          # negation wraps: sorts first in lax.sort
    else:
        s[7] = np.nan
    d = rng.permutation(300).astype(np.int32)
    d[::9] = -1                   # duplicate docids (pad rows)
    ws, wd = jax.jit(lambda a, b: JM.tie_topk(a, b, k))(s, d)
    gs, gd = TM.tie_topk(_t(s), _t(d), k)
    np.testing.assert_array_equal(np.asarray(ws), gs.numpy())
    np.testing.assert_array_equal(np.asarray(wd), gd.numpy())


def _jax_gather(mesh, local_s, local_d, k, full=False):
    def body(s, d):
        if full:
            return JM.all_gather_topk_full(s, d, "doc")
        return JM.all_gather_topk(s, d, "doc", k)
    fn = jax.jit(JM.shard_map(body, mesh=mesh,
                              in_specs=(PS("doc"), PS("doc")),
                              out_specs=(PS(), PS()), check_vma=False))
    sh = NamedSharding(mesh, PS("doc"))
    ws, wd = fn(jax.device_put(local_s, sh), jax.device_put(local_d, sh))
    return np.asarray(ws), np.asarray(wd)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("rows,k", [(16, 10), (4, 10), (32, 32)])
def test_gather_topk_matches_jax_all_gather_topk(dtype, rows, k):
    """Eight shards' local tie-ordered top-k blocks (rows < k: shards
    shorter than k) with equal scores across shards: the plain kernel-4
    merge of the gathered block equals the JAX collective."""
    devs = _cpu8()
    mesh = JM.make_mesh(n_doc=8, devices=devs)
    rng = np.random.default_rng(2)
    local_s, local_d = [], []
    for _shard in range(8):
        s = _scores(rows, dtype, rng)
        d = rng.choice(10_000, rows, replace=False).astype(np.int32)
        ts, td = JM.tie_topk(s, d, rows)
        local_s.append(np.asarray(ts))
        local_d.append(np.asarray(td))
    ls, ld = np.concatenate(local_s), np.concatenate(local_d)
    ws, wd = _jax_gather(mesh, ls, ld, k)
    block = _t(np.stack([ls.view(np.int32), ld], axis=1))
    kk = min(k, len(ls))
    gs, gd = gather_topk(block[:, 0], block[:, 1], kk, dtype == np.float32,
                         run_len=rows)
    got_s = gs.numpy().view(np.float32) if dtype == np.float32 else gs.numpy()
    np.testing.assert_array_equal(ws, got_s)
    np.testing.assert_array_equal(wd, gd.numpy())
    # the one-card collective and its all-gather twins agree too
    one = TM.make_mesh(device="cpu")
    fs, fd = TM.fused_gather_topk(_t(ls), _t(ld), one, k)
    as_, ad = TM.all_gather_topk(_t(ls), _t(ld), one, k)
    np.testing.assert_array_equal(fs.numpy(), ws)
    np.testing.assert_array_equal(fd.numpy(), wd)
    np.testing.assert_array_equal(as_.numpy(), ws)
    np.testing.assert_array_equal(ad.numpy(), wd)
    full_s, full_d = _jax_gather(mesh, ls, ld, k, full=True)
    ts, td = TM.all_gather_topk_full(_t(ls), _t(ld), one)
    np.testing.assert_array_equal(ts.numpy(), full_s)
    np.testing.assert_array_equal(td.numpy(), full_d)


def _padded_runs(dtype, rows, pad, rng):
    """Eight shards' local tie_topk runs of `rows` rows whose last `pad`
    rows are padding (docid -1, score -inf or -(2^31-1)), the same rows in
    every shard, with f32 NaN / -0.0 / +0.0 or int32 -2^31 among the real
    scores and scores equal across shards."""
    pad_s = -np.inf if dtype == np.float32 else TM.NEG_INF_I32
    runs_s, runs_d = [], []
    for shard in range(8):
        s = _scores(rows, dtype, rng)
        if rows - pad >= 5 and dtype == np.float32:
            s[shard % 3] = np.nan
            s[3] = -0.0
            s[4] = 0.0
        elif rows - pad >= 5:
            s[shard % 3] = -(2**31)
        d = rng.choice(10_000, rows, replace=False).astype(np.int32)
        s[rows - pad:] = pad_s
        d[rows - pad:] = -1
        ts, td = JM.tie_topk(s, d, rows)
        runs_s.append(np.asarray(ts))
        runs_d.append(np.asarray(td))
    return np.concatenate(runs_s), np.concatenate(runs_d)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("rows,pad,k", [(16, 5, 10), (16, 5, 128),
                                        (12, 12, 20), (1, 1, 8)])
def test_gather_topk_sorted_runs_with_padding_match_jax(dtype, rows, pad, k):
    """Eight sorted shard runs (JAX tie_topk output) whose padding rows
    repeat across shards: the plain kernel-4 merge, told the run length,
    and the one-card fusion equal the JAX all_gather_topk on the 8-device
    mesh, bit for bit."""
    mesh = JM.make_mesh(n_doc=8, devices=_cpu8())
    ls, ld = _padded_runs(dtype, rows, pad, np.random.default_rng(rows + k))
    kk = min(k, len(ls))
    ws, wd = _jax_gather(mesh, ls, ld, kk)
    is_float = dtype == np.float32
    ps, pd = gather_topk_plain(_t(ls.view(np.int32)), _t(ld), kk, is_float,
                               run_len=rows)
    np.testing.assert_array_equal(ps.numpy(), ws.view(np.int32))
    np.testing.assert_array_equal(pd.numpy(), wd)
    fs, fd = TM.fused_gather_topk(_t(ls), _t(ld), TM.make_mesh(device="cpu"),
                                  kk)
    np.testing.assert_array_equal(fs.numpy(), ws)
    np.testing.assert_array_equal(fd.numpy(), wd)


@pytest.mark.parametrize("run_len,k", [(3, 4), (0, 4), (-8, 4), (33, 4),
                                       (8, 0), (8, 33), (None, -1)])
def test_gather_topk_rejects_bad_run_len_and_k(run_len, k):
    """m = 32 rows: a run length that does not divide m, or a k outside
    [1, m], is refused before the CPU branch."""
    s = torch.arange(32, dtype=torch.int32)
    d = torch.arange(32, dtype=torch.int32)
    with pytest.raises(ValueError):
        gather_topk(s, d, k, False, run_len=run_len)
    with pytest.raises(ValueError):
        gather_topk_plain(s, d, k, False, run_len=run_len)


@pytest.mark.parametrize("n_term,n_doc", [(1, 8), (2, 4)])
@pytest.mark.parametrize("profile", [{}, {"authority": 15, "language": 5}])
@pytest.mark.parametrize("cells", ["one", "mesh"])
def test_mesh_ranker_bit_identical_to_jax_mesh(n_term, n_doc, profile,
                                               cells):
    """The JAX MeshRanker on the 8-device CPU mesh against the port's on
    one CPU cell and on the same n_term x n_doc mesh of CPU cells (the
    statistics merged across the doc axis, host counts summed): equal to
    the bit."""
    devs = _cpu8()
    feats, docids, hosts = _random_postings(1000, seed=3)
    jp = JR.RankingProfile(**profile)
    mesh = JM.make_mesh(n_doc=n_doc, n_term=n_term, devices=devs)
    ws, wd = JM.MeshRanker(mesh, jp).rank(JP.PostingsList(docids, feats),
                                          hosts, k=20)
    tp = convert.profile_from_jax(jp.to_external_string())
    tmesh = (TM.make_mesh(device="cpu") if cells == "one" else
             TM.make_mesh(n_doc, n_term, devices=["cpu"] * 8))
    gs, gd = TM.MeshRanker(tmesh, tp).rank(
        TP.PostingsList(docids, feats), hosts, k=20)
    np.testing.assert_array_equal(ws, gs)
    np.testing.assert_array_equal(wd, gd)


def test_mesh_ranker_small_and_empty():
    mesh = TM.make_mesh(device="cpu")
    feats, docids, hosts = _random_postings(5, seed=4)
    s, d = TM.MeshRanker(mesh).rank(TP.PostingsList(docids, feats), hosts,
                                    k=10)
    assert len(s) == 5 and set(d.tolist()) <= set(range(5))
    s, d = TM.MeshRanker(mesh).rank(TP.PostingsList.empty(), None, k=10)
    assert len(s) == 0 and len(d) == 0


def test_placed_from_numpy_carries_the_jax_placement():
    """The slice as a whole: the arrays a JAX MeshRanker.place builds,
    carried over by convert.placed_from_numpy, rank identically."""
    devs = _cpu8()
    feats, docids, hosts = _random_postings(2000, seed=5)
    jp = JR.RankingProfile(authority=14)
    jr = JM.MeshRanker(JM.make_mesh(n_doc=8, devices=devs), jp)
    jplaced = jr.place(JP.PostingsList(docids, feats), hosts)
    ws, wd = jr.rank_placed(jplaced, k=50)
    arrays = [np.asarray(a) for a in jplaced[:4]]
    tplaced = convert.placed_from_numpy(*arrays, jplaced[4], device="cpu")
    tr = TM.MeshRanker(TM.make_mesh(device="cpu"),
                       convert.profile_from_jax(jp.to_external_string()))
    gs, gd = tr.rank_placed(tplaced, k=50)
    np.testing.assert_array_equal(ws, gs)
    np.testing.assert_array_equal(wd, gd)


@pytest.mark.parametrize("cells", ["one", "mesh"])
def test_mesh_bm25_matches_jax(cells):
    """JAX MeshBM25 at 2 x 4 against the port's on one CPU cell and at
    2 x 4 CPU cells (K16's sums a cell, psum over the doc axis, K16's
    rows a cell, psum over the term axis): rtol 1e-5 on the scores, the
    docids where the scores are apart."""
    devs = _cpu8()
    rng = np.random.default_rng(6)
    n, t, k = 777, 6, 15
    tf = rng.integers(0, 9, (n, t)).astype(np.float32)
    dl = rng.integers(40, 800, n).astype(np.int32)
    df = rng.integers(1, n, t).astype(np.int32)
    docids = np.arange(n, dtype=np.int32)
    mesh = JM.make_mesh(n_doc=4, n_term=2, devices=devs)
    ws, wd = JM.MeshBM25(mesh).topk(tf, dl, df, n, docids, k=k)
    tmesh = (TM.make_mesh(device="cpu") if cells == "one" else
             TM.make_mesh(4, 2, devices=["cpu"] * 8))
    gs, gd = TM.MeshBM25(tmesh).topk(tf, dl, df, n, docids, k=k)
    np.testing.assert_allclose(gs, ws, rtol=1e-5)
    gap = np.abs(np.diff(ws)) > 1e-5 * np.abs(ws[1:])
    sep = np.ones(k, bool)
    sep[1:] &= gap
    sep[:-1] &= gap
    np.testing.assert_array_equal(gd[sep], wd[sep])


def test_make_mesh_rejects_devices_not_divisible_by_n_term():
    """As the JAX MeshSegmentStore refuses a device list that n_term does
    not divide, make_mesh raises ValueError; a list it divides gives
    len / n_term doc columns, a device repeating as often as it is
    listed."""
    with pytest.raises(ValueError):
        TM.make_mesh(n_term=2, devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        TM.make_mesh(n_term=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        TM.make_mesh(n_doc=4, n_term=2, devices=["cpu"] * 6)
    m = TM.make_mesh(n_term=2, devices=["cpu"] * 8)
    assert (m.n_term, m.n_doc, m.n_cells) == (2, 4, 8)
    assert m.groups("term")[1] == [1, 5]
    assert m.groups("doc")[1] == [4, 5, 6, 7]
    one = TM.make_mesh(n_doc=2, n_term=2, device="cpu")
    assert one.devices == [torch.device("cpu")] * 4


@pytest.mark.parametrize("axes", ["doc", "term", ("term", "doc")])
def test_collectives_match_lax(axes):
    """The mesh's collectives over 2 x 4 CPU cells equal lax.pmin, pmax,
    psum and the tiled all_gather over the JAX mesh's same axes, cell by
    cell; a cell given None takes no part and gets None."""
    from jax import lax
    jm = JM.make_mesh(n_doc=4, n_term=2, devices=_cpu8())
    x = np.random.default_rng(8).integers(-1000, 1000,
                                          (8, 5)).astype(np.int32)

    def body(v):
        return (lax.pmin(v, axes), lax.pmax(v, axes), lax.psum(v, axes),
                lax.all_gather(v, axes, tiled=True))
    cells = PS(("term", "doc"))
    fn = jax.jit(JM.shard_map(body, mesh=jm, in_specs=(cells,),
                              out_specs=(cells,) * 4, check_vma=False))
    want = [np.asarray(w) for w in fn(jax.device_put(
        x, NamedSharding(jm, cells)))]
    tm = TM.make_mesh(4, 2, devices=["cpu"] * 8)
    xs = [_t(x[c]) for c in range(8)]
    for got, w in zip((tm.pmin(xs, axes), tm.pmax(xs, axes),
                       tm.psum(xs, axes), tm.all_gather(xs, axes)), want):
        np.testing.assert_array_equal(torch.stack(got).numpy().ravel(),
                                      w.ravel())
    part = list(xs)
    part[1] = None
    got = tm.psum(part, axes)
    assert got[1] is None
    for g in tm.groups(axes):
        if 1 in g:
            others = [c for c in g if c != 1]
            np.testing.assert_array_equal(got[others[0]].numpy(),
                                          x[others].sum(0))
