"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: each test skips without a CUDA device. Run them on a
machine with one (this file imports no JAX, so the repo's conftest can be
left out):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from yacy_search_server_tpu_torch import convert
from yacy_search_server_tpu_torch.index import devstore as TD
from yacy_search_server_tpu_torch.index import postings as P
from yacy_search_server_tpu_torch.index.rwi import RWIIndex
from yacy_search_server_tpu_torch.kernels import devstore as KD
from yacy_search_server_tpu_torch.kernels import (LAUNCHES, WIDE,
                                                  bench as KBench,
                                                  cardinal as KC, topk as KT)
from yacy_search_server_tpu_torch.ops import ranking as R

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _block(n, seed, edge=False):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 30000, (n, P.NF)).astype(np.int32)
    feats[:, P.F_FLAGS] = rng.integers(0, 2**30, n)
    feats[:, P.F_HITCOUNT] = rng.integers(0, 256, n)
    feats[:, P.F_DOMLENGTH] = rng.integers(0, 256, n)
    feats[:, P.F_LANGUAGE] = np.where(rng.random(n) < 0.5, 0x656E, 0x6465)
    feats[:, P.F_LASTMOD] = 12345            # a span-0 column
    if edge:
        ext = rng.choice(np.array([-32768, -1, 0, 1, 32767]), (n, P.NF))
        feats[:, 6:10] = ext[:, 6:10]
        feats[::97, P.F_WORDS_IN_TEXT] = -1  # tf denominators of 0
        feats[::97, P.F_WORDS_IN_TITLE] = 0
    valid = rng.random(n) < 0.95
    hostids = rng.integers(0, 1000, n).astype(np.int32)
    return feats, valid, hostids


def _stats_equal(a, b):
    a, b = a.cpu(), b.cpu()
    ints = list(range(KC.S_TF_MIN)) + [KC.S_HOST_MAX, KC.S_NAN]
    assert torch.equal(a[ints], b[ints])
    fa = a[KC.S_TF_MIN:KC.S_TF_MAX + 1].view(torch.float32)
    fb = b[KC.S_TF_MIN:KC.S_TF_MAX + 1].view(torch.float32)
    assert torch.equal(torch.isnan(fa), torch.isnan(fb))
    ok = ~torch.isnan(fa)
    assert torch.equal(fa[ok], fb[ok])


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("authority", [5, 15])
def test_cardinal_kernels_match_plain(dev, compact, edge, authority):
    feats, valid, hostids = _block(200_003, seed=1, edge=edge)
    if compact:
        f, flags = R.compact_feats(feats)
    else:
        f, flags = feats, None
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    f_d, v_d, h_d = t(f), t(valid), t(hostids)
    fl_d = t(flags) if flags is not None else None
    num_hosts = 1000 if authority > 12 else 0
    st, counts = KC.cardinal_stats(f_d, v_d, h_d, num_hosts)
    pst, pcounts = KC.cardinal_stats_plain(f_d, v_d, h_d, num_hosts)
    torch.cuda.synchronize()
    _stats_equal(st, pst)
    assert torch.equal(counts, pcounts)
    consts = R.profile_consts(R.RankingProfile(authority=authority), 0x656E,
                              dev)
    got = KC.cardinal_score(f_d, fl_d, v_d, h_d, st, counts, consts, compact)
    want = KC.cardinal_score_plain(f_d, fl_d, v_d, h_d, st, counts, consts,
                                   compact)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _stats_agree(f_d, v_d, h_d, num_hosts):
    """Kernel 1 against its plain version, called twice (the second call
    must see its accumulator and ticket zeroed again)."""
    before = LAUNCHES["cardinal_stats"]
    got = [KC.cardinal_stats(f_d, v_d, h_d, num_hosts) for _ in range(2)]
    pst, pcounts = KC.cardinal_stats_plain(f_d, v_d, h_d, num_hosts)
    torch.cuda.synchronize()
    assert LAUNCHES["cardinal_stats"] == before + 2
    for st, counts in got:
        _stats_equal(st, pst)
        assert torch.equal(counts, pcounts)
    return got[0]


def _dev_block(dev, feats, valid, hostids, compact):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    f = R.compact_feats(feats)[0] if compact else feats
    return t(f), t(valid), t(hostids)


# more host bins than a cluster's shared memory holds (~300,000): ids
# above its bins are added to the counts in device memory
MANY_HOSTS = 4_000_000


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 257, 200_003])
@pytest.mark.parametrize("hosts", [0, 1, 1000, "n", MANY_HOSTS])
def test_cardinal_stats_matches_plain(dev, compact, n, hosts):
    """Row counts around the 64-row chunk and the block, host bins from
    none to one a row and beyond the cluster's shared bins, host ids below
    0 and at or above num_hosts (dropped, as segment_sum drops them)."""
    num_hosts = n if hosts == "n" else hosts
    feats, valid, _ = _block(max(n, 1), seed=n + 7, edge=True)
    rng = np.random.default_rng(n)
    hostids = rng.integers(-3, max(num_hosts, 1) + 3, max(n, 1)).astype(
        np.int32)
    f_d, v_d, h_d = _dev_block(dev, feats[:n], valid[:n], hostids[:n],
                               compact)
    _stats_agree(f_d, v_d, h_d, num_hosts)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("case", ["offset_view", "all_invalid", "one_host",
                                  "one_host_beyond_bins", "zipf_hosts",
                                  "nan_tf", "inf_tf"])
def test_cardinal_stats_cases(dev, compact, case):
    """A view that starts 34 or 68 bytes into its storage, a block with no
    valid row, every row on one host (the maximum is the valid count),
    in a cluster's shared bins or beyond them, host ids drawn Zipf over
    1000 hosts, and term frequencies of NaN (0 / 0) or of +-inf only
    (+-h / 0)."""
    n = 100_003
    feats, valid, hostids = _block(n + 1, seed=5, edge=False)
    num_hosts = 1000
    if case == "all_invalid":
        valid[:] = False
    if case == "one_host":
        hostids[:] = 17
    if case == "one_host_beyond_bins":
        num_hosts = MANY_HOSTS
        hostids[:] = MANY_HOSTS - 1
    if case == "zipf_hosts":
        hostids = KBench.host_mix("zipf", n + 1, np.random.default_rng(6),
                                  hosts=num_hosts)
    if case in ("nan_tf", "inf_tf"):
        feats[::101, P.F_WORDS_IN_TEXT] = -1
        feats[::101, P.F_WORDS_IN_TITLE] = 0
        feats[::101, P.F_HITCOUNT] = np.where(
            np.arange(len(feats[::101])) % 2, 5, -5)
        valid[::101] = True
        if case == "nan_tf":
            feats[202, P.F_HITCOUNT] = 0
    f_d, v_d, h_d = _dev_block(dev, feats, valid, hostids, compact)
    if case == "offset_view":
        f_d, v_d, h_d = f_d[1:], v_d[1:], h_d[1:]
        assert f_d.data_ptr() % 16 != 0
    else:
        f_d, v_d, h_d = f_d[:n], v_d[:n], h_d[:n]
    st, counts = _stats_agree(f_d, v_d, h_d, num_hosts)
    if case in ("one_host", "one_host_beyond_bins"):
        assert int(st[KC.S_HOST_MAX]) == int(v_d.sum())
    if case == "all_invalid":
        assert int(st[KC.S_HOST_MAX]) == 0 and int(counts.sum()) == 0
    if case == "nan_tf":
        assert bool(torch.isnan(st[KC.S_TF_MIN:KC.S_TF_MAX + 1]
                                .view(torch.float32)).all())
    if case == "inf_tf":
        tf = st[KC.S_TF_MIN:KC.S_TF_MAX + 1].view(torch.float32).cpu()
        assert tf.tolist() == [float("-inf"), float("inf")]


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("case", ["ragged", "offset_view", "all_invalid"])
@pytest.mark.parametrize("n", [1, 257, 100_003])
def test_cardinal_score_tile_edges(dev, compact, case, n):
    """Row counts that are not a whole number of tiles, a view that starts
    34 or 68 bytes into its storage, and a block with no valid row."""
    feats, valid, hostids = _block(n + 1, seed=n, edge=True)
    if case == "all_invalid":
        valid[:] = False
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    if compact:
        f, flags = R.compact_feats(feats)
    else:
        f, flags = feats, None
    f_d = t(f)
    fl_d = t(flags) if flags is not None else None
    v_d, h_d = t(valid), t(hostids)
    if case == "offset_view":
        f_d = f_d[1:]
        fl_d = fl_d[1:] if fl_d is not None else None
        v_d, h_d = v_d[1:], h_d[1:]
        assert f_d.data_ptr() % 16 != 0
    else:
        f_d, v_d, h_d = f_d[:n], v_d[:n], h_d[:n]
        fl_d = fl_d[:n] if fl_d is not None else None
    st, counts = KC.cardinal_stats_plain(f_d, v_d, h_d, 1000)
    consts = R.profile_consts(R.RankingProfile(authority=15), 0x656E, dev)
    got = KC.cardinal_score(f_d, fl_d, v_d, h_d, st, counts, consts, compact)
    want = KC.cardinal_score_plain(f_d, fl_d, v_d, h_d, st, counts, consts,
                                   compact)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if case == "all_invalid":
        assert bool((got == KC.SMALL).all())


@pytest.mark.parametrize("fast_div", [False, True])
@pytest.mark.parametrize("authority", [5, 15])
def test_cardinal_score_int32_edges(dev, fast_div, authority):
    """Column bounds at int32's edges (spans of 0, 1, 2, 2^31-1 and wrapped
    ones, minima at both ends) and features whose (f - min) * 256 lands on
    and beside both wrap boundaries: the kernel's division (a double
    estimate corrected by its remainder) and its reassociated product must
    give the plain version's bits."""
    feats, cmin, cmax = KBench.edge_block(100_003, seed=11)
    rng = np.random.default_rng(11)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    f_d = t(feats)
    v_d = t(rng.random(len(feats)) < 0.95)
    h_d = t(rng.integers(0, 1000, len(feats)).astype(np.int32))
    st, counts = KC.cardinal_stats_plain(f_d, v_d, h_d, 1000)
    st[KC.S_COL_MIN:KC.S_COL_MIN + P.NF] = t(cmin)
    st[KC.S_COL_MAX:KC.S_COL_MAX + P.NF] = t(cmax)
    consts = R.profile_consts(R.RankingProfile(authority=authority), 0x656E,
                              dev)
    got = KC.cardinal_score(f_d, None, v_d, h_d, st, counts, consts, fast_div)
    want = KC.cardinal_score_plain(f_d, None, v_d, h_d, st, counts, consts,
                                   fast_div)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _topk_agrees(s, docids, k, tie):
    sec = docids if tie else None
    pay = None if tie else docids
    before = LAUNCHES["tie_topk"]
    got = KT.tie_topk(s, k, secondary=sec, payload=pay)
    want = KT.tie_topk_plain(s, k, secondary=sec, payload=pay)
    torch.cuda.synchronize()
    assert LAUNCHES["tie_topk"] == before + 1
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x  # noqa: E731
    assert torch.equal(bits(got[0]), bits(want[0]))
    assert torch.equal(got[1], want[1])
    if not tie:
        assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("k", [10, 1000])
def test_tie_topk_all_equal_scores(dev, tie, k):
    """10M equal scores: the bucket never fits the candidate buffer, so
    every digit is a pass over the whole array."""
    n = 10_000_000
    s = torch.full((n,), 7, dtype=torch.int32, device=dev)
    docids = torch.from_numpy(np.random.default_rng(k).permutation(n)
                              .astype(np.int32)).to(dev)
    _topk_agrees(s, docids, k, tie)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("k", [100, 1000])
def test_tie_topk_sample_guess_misses(dev, dtype, tie, k):
    """Scores rising with the row: every block's sample (the first round
    of its share) holds its share's worst rows, so the bucket guessed from
    the sample is not the k-th key's, and the select goes on digit by
    digit."""
    n = 2_000_000
    s = (torch.arange(n, dtype=torch.int64, device=dev) * 1024).to(torch.int32)
    if dtype == torch.float32:
        s = s.view(torch.float32)   # finite positive floats, rising bits
    docids = torch.from_numpy(np.random.default_rng(k).permutation(n)
                              .astype(np.int32)).to(dev)
    _topk_agrees(s, docids, k, tie)


def _scores(n, dtype, values, rng):
    """`wide`: 500 distinct values with int32 -2^31, f32 NaN, -0.0 and
    -inf among them; `edge`: seven values, so that most rows tie, with
    int32 -2^31 and 2^31-1, f32 NaN, -0.0, -inf and inf in large shares."""
    if values == "wide":
        if dtype == torch.int32:
            s = rng.integers(0, 500, n).astype(np.int32)
            s[::1001] = -(2**31)
        else:
            s = (rng.integers(0, 500, n) * 0.25).astype(np.float32)
            s[::7] = -0.0
            s[::13] = -np.inf
            s[::1009] = np.nan
        return s
    if dtype == torch.int32:
        s = rng.integers(-3, 4, n).astype(np.int32)
        s[::3] = -(2**31)
        s[1::5] = 2**31 - 1
    else:
        s = (rng.integers(-3, 4, n) * 0.5).astype(np.float32)
        s[::3] = np.nan
        s[1::4] = -0.0
        s[2::5] = -np.inf
        s[3::7] = np.inf
    return s


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("n,k,values", [
    (1, 1, "wide"), (1000, 1000, "wide"), (300_000, 10, "wide"),
    (300_000, 100, "wide"), (300_000, 1000, "wide"), (20_000, 5000, "wide"),
    (1, 1, "edge"), (7, 7, "edge"), (7, 3, "edge"), (1023, 1023, "edge"),
    (1023, 1, "edge"), (2049, 2049, "edge"), (5000, 2049, "edge")])
def test_tie_topk_matches_plain(dev, dtype, tie, n, k, values):
    """Bit for bit against the plain version, the launch counted: k = n,
    k = 2049 (the sort in device memory), tiny n, and the special values
    (int32 -2^31, f32 NaN, -0.0 and -inf) in both modes."""
    rng = np.random.default_rng(n + k if values == "wide" else 7 * n + k)
    s = _scores(n, dtype, values, rng)
    docids = rng.permutation(n).astype(np.int32)
    if values == "wide":
        docids[::17] = -1
    else:
        docids[::4] = 5
    _topk_agrees(torch.from_numpy(s).to(dev),
                 torch.from_numpy(docids).to(dev), k, tie)


def _gather_agrees(dev, block, k, is_float, run_len):
    b = block.to(dev)
    before = LAUNCHES["gather_topk"]
    gs, gd = KT.gather_topk(b[:, 0], b[:, 1], k, is_float, run_len=run_len)
    ps, pd = KT.gather_topk_plain(b[:, 0], b[:, 1], k, is_float,
                                  run_len=run_len)
    torch.cuda.synchronize()
    assert LAUNCHES["gather_topk"] == before + 1
    assert torch.equal(gs, ps) and torch.equal(gd, pd)


@pytest.mark.parametrize("is_float", [False, True])
@pytest.mark.parametrize("shards,rows,k", [(1, 100, 100), (1, 100, 7),
                                           (2, 500, 1000), (8, 1000, 1000),
                                           (16, 1000, 1000), (8, 30, 100),
                                           (16, 7, 100), (32, 1000, 1000)])
def test_gather_topk_matches_plain(dev, is_float, shards, rows, k):
    """Sorted runs, one per shard (tie_topk_plain of each shard), as the
    fusion gathers them; runs shorter than k; 32,000 rows, more than a
    block stages in shared memory."""
    rng = np.random.default_rng(shards * rows)
    block = KBench.sorted_runs(shards, rows, is_float, rng)
    _gather_agrees(dev, block, min(k, shards * rows), is_float, rows)


@pytest.mark.parametrize("is_float", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 8, 16])
def test_gather_topk_ties_padding_special(dev, is_float, shards):
    """Ties across runs, padding rows repeated in every run, and f32 NaN,
    -0.0, +0.0 and -inf or int32 -2^31 among the scores."""
    rng = np.random.default_rng(100 + shards)
    block = KBench.sorted_runs(shards, 64, is_float, rng, pad=20,
                               special=True)
    for k in (1, 50, shards * 64):
        _gather_agrees(dev, block, k, is_float, 64)


@pytest.mark.parametrize("is_float", [False, True])
@pytest.mark.parametrize("shards", [1, 8])
def test_gather_topk_run_out_of_order(dev, is_float, shards):
    """A run that breaks the sorted-run contract: the kernel detects it
    and ranks by the all-pairs count, so the answer is still the plain
    version's."""
    rng = np.random.default_rng(7 + shards)
    block = KBench.sorted_runs(shards, 100, is_float, rng, pad=10,
                               special=True)
    last = block[(shards - 1) * 100:]
    block[(shards - 1) * 100:] = last[torch.from_numpy(rng.permutation(100))]
    _gather_agrees(dev, block, 100, is_float, 100)


def test_fused_gather_topk_columns(dev):
    """The one-card fusion hands the kernel its two columns (stride 1, no
    stacked block) and counts one launch."""
    from yacy_search_server_tpu_torch.parallel import mesh as M
    rng = np.random.default_rng(3)
    block = KBench.sorted_runs(1, 300, True, rng, pad=30, special=True)
    s = block[:, 0].contiguous().view(torch.float32).to(dev)
    d = block[:, 1].contiguous().to(dev)
    before = LAUNCHES["gather_topk"]
    fs, fd = M.fused_gather_topk(s, d, M.make_mesh(device=dev), 100)
    ps, pd = KT.gather_topk_plain(block[:, 0], block[:, 1], 100, True)
    torch.cuda.synchronize()
    assert LAUNCHES["gather_topk"] == before + 1
    assert torch.equal(fs.view(torch.int32).cpu(), ps)
    assert torch.equal(fd.cpu(), pd)


# ---------------------------------------------------------------------------
# the devstore kernels: K5 pruned_tile, K6 span_stats, K7 span_score,
# topk_finish, and the store's routes through them
# ---------------------------------------------------------------------------

NONDEFAULT = dict(worddistance=2, appemph=15, urllength=12, tf=3)


@pytest.fixture(scope="module")
def edge_store():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return KBench.devstore_edges("cuda")[0]


def _arena(store):
    f, fl, d = store.arena.arrays()
    return f, fl, d, store.arena.dead_array(), store.arena._pmax


def _consts(prof):
    return R.profile_consts(prof, 0x656E, torch.device("cuda"))


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("kk", [16, 128, 1024, 2048])
@pytest.mark.parametrize("bs", [1, 16, 20])
@pytest.mark.parametrize("nondefault", [False, True])
def test_pruned_tile_matches_plain(edge_store, nondefault, bs, kk, init):
    """Pad slots, a ragged last tile, dead rows, live docids past the
    bitmap, ties; the non-default profile's bound fails on the big term;
    20 slots take two launches of 16 and 4."""
    prof = R.RankingProfile(**NONDEFAULT) if nondefault else R.RankingProfile()
    shift, lang = TD.prune_bound_consts(prof)
    desc = KD.pack_desc(KBench.edge_slots(edge_store, bs), int(shift),
                        int(lang))
    a, c = _arena(edge_store), _consts(prof)
    before = LAUNCHES["pruned_tile"]
    got = KD.pruned_tile(*a, desc, kk, c, init)
    want = KD.pruned_tile_plain(*a, desc, kk, c, init)
    torch.cuda.synchronize()
    assert LAUNCHES["pruned_tile"] == before + 1
    assert torch.equal(got, want)
    if nondefault and kk == 16:
        assert int(got[0, 2 * kk]) == 0, "the big term's bound should fail"


@pytest.mark.parametrize("n", [1, 2, 8])
def test_span_stats_and_score_match_plain(edge_store, n):
    """1, 2 and 8 extents: whole, offset, ragged, all dead, empty."""
    f, fl, d, dead, _pm = _arena(edge_store)
    ext = KBench.edge_extents(edge_store, n)
    st = KD.span_stats(f, d, dead, ext)
    _stats_equal(st, KD.span_stats_plain(f, d, dead, ext))
    rows = sum(c for _s, c in ext)
    for prof in (R.RankingProfile(), R.RankingProfile(**NONDEFAULT)):
        c = _consts(prof)
        for out_len in (rows, rows + 1_000):
            got = KD.span_score(f, fl, d, dead, ext, st, c, out_len)
            want = KD.span_score_plain(f, fl, d, dead, ext, st, c, out_len)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


def test_span_stats_of_no_live_row(edge_store):
    f, _fl, d, dead, _pm = _arena(edge_store)
    for ext in ([], KBench.edge_extents(edge_store, 8)[3:5]):
        got = KD.span_stats(f, d, dead, ext)
        _stats_equal(got, KD.span_stats_plain(f, d, dead, ext))
        assert int(got[KC.S_COL_MIN]) == KC.BIG


@pytest.mark.parametrize("kk", [16, 1024, 4096])
def test_topk_finish_matches_plain(edge_store, kk):
    f, fl, d, dead, pm = _arena(edge_store)
    ext = KBench.edge_extents(edge_store, 8)
    st = KD.span_stats(f, d, dead, ext)
    c = _consts(R.RankingProfile())
    buf = KD.span_score(f, fl, d, dead, ext, st, c,
                        max(sum(n for _s, n in ext), kk))
    s, rows, _ = KT.tie_topk(buf, kk)
    got = KD.topk_finish(s, rows, d, ext, stats=st)
    want = KD.topk_finish_plain(s, rows, d, ext, stats=st)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    big = edge_store.spans_for(b"bigAAAAAAAAA")[0]
    for j0 in (0, 1, big.tcount):
        tail = (big.tstart, j0, big.tcount,
                *map(int, TD.prune_bound_consts(R.RankingProfile())))
        got = KD.topk_finish(s, rows, d, ext, pmax=pm, tail=tail)
        want = KD.topk_finish_plain(s, rows, d, ext, pmax=pm, tail=tail)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("kk", [16, 1024, 4096])
@pytest.mark.parametrize("nondefault", [False, True])
def test_store_routes_match_cpu(edge_store, nondefault, kk):
    """The store's pruned route at b = 1, 8, 64 and its exact scan on the
    card against the same routes on a CPU copy of the arena."""
    prof = R.RankingProfile(**NONDEFAULT) if nondefault else R.RankingProfile()
    shift, lang = TD.prune_bound_consts(prof)
    a = _arena(edge_store)
    a_cpu = tuple(t.cpu() for t in a)
    c = _consts(prof)
    for th in KBench.EDGE_TERMS:
        sp = edge_store.spans_for(th)[0]
        for b in (1, 8, 64):
            got = TD.pruned_query(a, sp, shift, lang, c, kk, b)
            want = TD.pruned_query(a_cpu, sp, shift, lang, c.cpu(), kk, b)
            assert torch.equal(got.cpu(), want)
    for n in (1, 2, 8):
        ext = KBench.edge_extents(edge_store, n)
        got = TD.scan_query(a, ext, c, kk)
        want = TD.scan_query(a_cpu, ext, c.cpu(), kk)
        assert torch.equal(got.cpu(), want)


def test_rank_term_on_the_card_matches_cpu():
    """A store on the card and its twin on the CPU over one RWI: pruned,
    escalated and exact-scan answers equal, with equal counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    feats, docids, _h, _rng = KBench.make_term(300_000)
    idx = RWIIndex()
    th = b"termAAAAAAAA"
    idx.add_many(th, P.PostingsList(docids, feats))
    idx.flush()
    g = TD.DeviceSegmentStore(idx, device="cuda")
    h = TD.DeviceSegmentStore(idx, device="cpu")
    idx.listener = KBench.Fanout(g, h)
    counters = lambda s: (s.prune_rounds, s.pruned_tiles,  # noqa: E731
                          s.stream_scans, s.queries_served)
    for prof, k in ((R.RankingProfile(), 10), (R.RankingProfile(), 1000),
                    (R.RankingProfile(**NONDEFAULT), 100)):
        a, b = g.rank_term(th, prof, k=k), h.rank_term(th, prof, k=k)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a[2] == b[2]
    idx.delete_doc(int(docids[5]))
    a, b = g.rank_term(th, R.RankingProfile(), k=100), \
        h.rank_term(th, R.RankingProfile(), k=100)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert counters(g) == counters(h) and g.stream_scans == 1


# ---------------------------------------------------------------------------
# K8 join_member and the filtered K6 / K7 (kernels/bench.join_edges)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def join_store():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return KBench.join_edges("cuda")[0]


def _join_cases():
    # the cases' labels, from a CPU store (cheap: 300k rows)
    return list(range(13))


@pytest.mark.parametrize("case", _join_cases())
def test_join_member_matches_plain(join_store, case):
    """Excludes only, a partner meeting no row and one holding every row,
    bitmap and sort partners in one call, docids at and above 2^29 and
    past the bitmaps' coverage, five partners and six excludes,
    tombstoned rare rows, each filter alone and all four; every output
    equal to the plain version's, and equal again on a second call."""
    cases = KBench.join_edge_cases(join_store)
    assert len(cases) == len(_join_cases())
    label, rare, parts, n_inc, filt = cases[case]
    f, fl, d, dead, _pm = _arena(join_store)
    jd, jp = join_store.arena.join_arrays()
    bm = join_store.arena.bitmap_array()
    before = LAUNCHES["join_member"]
    outs = [KD.join_member(f, fl, d, dead, rare.start, rare.count, jd, jp,
                           bm, parts, n_inc, filt) for _ in range(2)]
    want = KD.join_member_plain(f, fl, d, dead, rare.start, rare.count, jd,
                                jp, bm, parts, n_inc, filt)
    torch.cuda.synchronize()
    assert LAUNCHES["join_member"] == before + 2
    for got in outs:
        for g, w in zip(got, want):
            assert torch.equal(g, w), label


def test_join_member_at_max_join_rows(dev):
    """A rare span of MAX_JOIN_ROWS rows against a bitmap partner and a
    sort partner of a third of them each, and a sort exclude."""
    n = TD.DeviceSegmentStore.MAX_JOIN_ROWS
    rng = np.random.default_rng(5)
    feats, _v, _h = _block(n + KD.TILE, seed=6)
    f16, flags = R.compact_feats(feats)
    docids = (2 * np.arange(n + KD.TILE) + 1).astype(np.int32)
    segs, pos = [], []
    for step in (3, 5, 7):
        rows = np.arange(0, n, step) + rng.integers(0, step)
        rows = rows[rows < n].astype(np.int32)
        segs.append(docids[rows])
        pos.append(rows)
    jd = np.concatenate(segs)
    jp = np.concatenate(pos)
    nwords = 1 << (2 * n + 32 - 1).bit_length() >> 5
    bm = TD.join_bitmap(segs[0], nwords)[None]
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = (t(f16), t(flags), t(docids), t(np.zeros(1 << 16, bool)), 0, n,
            t(jd), t(jp), t(bm))
    off = [0, len(segs[0]), len(segs[0]) + len(segs[1])]
    parts = [(off[0], len(segs[0]), 0), (off[1], len(segs[1]), -1),
             (off[2], len(segs[2]), -1)]
    got = KD.join_member(*args, parts, 2, None)
    want = KD.join_member_plain(*args, parts, 2, None)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("name", list(KBench.JOIN_EDGE_FILTERS))
def test_filtered_span_stats_and_score_match_plain(join_store, name):
    """K6 and K7 under each filter over 1 and 3 extents of the join edge
    store (random languages, lastmods and flags, tombstoned rows); K7 also
    with statistics handed in, as a filtered-stats cache hit does."""
    filt = KBench.JOIN_EDGE_FILTERS[name]
    f, fl, d, dead, _pm = _arena(join_store)
    sp = [join_store.spans_for(th)[0] for th in KBench.JOIN_EDGE_TERMS]
    for ext in ([(sp[1].start, sp[1].count)],
                [(sp[0].start + 5, 70_001), (sp[1].start, sp[1].count),
                 (sp[5].start, sp[5].count)]):
        st = KD.span_stats(f, d, dead, ext, flags=fl, filt=filt)
        pst = KD.span_stats_plain(f, d, dead, ext, flags=fl, filt=filt)
        _stats_equal(st, pst)
        rows = sum(c for _s, c in ext)
        for prof in (R.RankingProfile(), R.RankingProfile(**NONDEFAULT)):
            c = _consts(prof)
            for stats in (st, pst.clone()):
                got = KD.span_score(f, fl, d, dead, ext, stats, c, rows + 7,
                                    filt=filt)
                want = KD.span_score_plain(f, fl, d, dead, ext, stats, c,
                                           rows + 7, filt=filt)
                torch.cuda.synchronize()
                assert torch.equal(got, want)


def test_rank_join_and_filtered_rank_term_on_the_card_match_cpu():
    """A store on the card and its twin on the CPU over the join edge
    terms: conjunctions in bitmap, sort and mixed mode with and without
    filters, filtered rank_term cold, cached and after a delete; equal
    answers and counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, idx = KBench.join_edges("cuda")
    h = TD.DeviceSegmentStore(idx, device="cpu")
    idx.listener = KBench.Fanout(g, h)
    names = list(KBench.JOIN_EDGE_TERMS)
    counters = lambda s: (s.join_served, s.join_fallbacks,  # noqa: E731
                          s.join_degraded_plain, s.stream_scans,
                          s.queries_served, s.fallbacks)
    prof = R.RankingProfile()
    for inc, exc in (([names[1], names[0]], []),
                     ([names[1], names[0], names[2]], [names[5]]),
                     ([names[5], names[1]], [names[4]]),
                     ([names[1]], [names[3]])):
        for kw in ({}, dict(lang_filter=0x6465, from_days=3_000)):
            a = g.rank_join(inc, exc, prof, k=100, **kw)
            b = h.rank_join(inc, exc, prof, k=100, **kw)
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            assert a[2] == b[2]
    for _ in range(2):
        a = g.rank_term(names[0], prof, k=50, flag_bit=4, to_days=20_000)
        b = h.rank_term(names[0], prof, k=50, flag_bit=4, to_days=20_000)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    idx.delete_doc(int(a[1][0]))
    a = g.rank_term(names[0], prof, k=50, flag_bit=4, to_days=20_000)
    b = h.rank_term(names[0], prof, k=50, flag_bit=4, to_days=20_000)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert counters(g) == counters(h) and g.join_served == 8


# ---------------------------------------------------------------------------
# K6 / K7 / topk_finish with a RAM delta and a facet bitmap, the batched
# scan, K5 waves, tie_topk on concurrent streams and the batcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filt", [None, (0x656E, 7, 5_000, 25_000)],
                         ids=["no_filter", "filter"])
@pytest.mark.parametrize("bitmap", [False, True], ids=["", "bitmap"])
@pytest.mark.parametrize("n_delta", [0, 7, 256, 50_000, 300_000])
def test_span_kernels_with_delta_and_bitmap_match_plain(edge_store, n_delta,
                                                        bitmap, filt):
    """K6, K7 and topk_finish over the 8 edge extents and a delta block
    (span docids, tombstoned ones, docids past the tombstone bitmap and
    past the facet bitmap; below the first bucket, at it, 50,000 rows and
    past the last bucket), with a facet bitmap of 4M bits admitting 30 %
    and a constraint filter; equal to the plain versions."""
    f, fl, d, dead, _pm = _arena(edge_store)
    ext = KBench.edge_extents(edge_store, 8)
    delta = (convert.delta_from_numpy(*KBench.edge_delta(edge_store, n_delta),
                                      "cuda") if n_delta else None)
    allow = (convert.bitmap_from_numpy(KBench.facet_bitmap(1 << 22, 0.3),
                                       "cuda") if bitmap else None)
    kw = dict(filt=filt, delta=delta, allow=allow)
    st = KD.span_stats(f, d, dead, ext, flags=fl, **kw)
    _stats_equal(st, KD.span_stats_plain(f, d, dead, ext, flags=fl, **kw))
    rows = sum(c for _s, c in ext) + (delta[2].shape[0] if delta else 0)
    c = _consts(R.RankingProfile())
    buf = KD.span_score(f, fl, d, dead, ext, st, c, rows + 7, **kw)
    assert torch.equal(buf, KD.span_score_plain(f, fl, d, dead, ext, st, c,
                                                rows + 7, **kw))
    dd = delta[2] if delta else None
    for kk in (16, 1024):
        s, r, _ = KT.tie_topk(buf, kk)
        got = KD.topk_finish(s, r, d, ext, stats=st, delta_docids=dd)
        want = KD.topk_finish_plain(s, r, d, ext, stats=st, delta_docids=dd)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("n_ext", [0, 2])
def test_delta_only_scan_matches_cpu(edge_store, n_ext):
    """The exact scan of a term whose rows are all, or partly, in its RAM
    delta: no extent (the delta the only source) and two extents, with a
    filter; equal to the same route on a CPU copy of the arena."""
    a = _arena(edge_store)
    a_cpu = tuple(t.cpu() for t in a)
    ext = KBench.edge_extents(edge_store, 2)[:n_ext]
    blk = KBench.edge_delta(edge_store, 3_000)
    c = _consts(R.RankingProfile())
    for filt in (None, (0x656E, -1, KD.DAYS_NONE_LO, KD.DAYS_NONE_HI)):
        got = TD.scan_query(a, ext, c, 128, filt,
                            delta=convert.delta_from_numpy(*blk, "cuda"))
        want = TD.scan_query(a_cpu, ext, c.cpu(), 128, filt,
                             delta=convert.delta_from_numpy(*blk, "cpu"))
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kk", [16, 1024])
@pytest.mark.parametrize("bs", [1, 3, 16])
def test_batched_scan_matches_plain_and_solo(edge_store, bs, kk):
    """The batched K6, K7 and finish over a wave of bs edge scans (1, 2 and
    8 extents, five filters): each equal to its plain version, the wave
    equal to the CPU's, each slot equal to the solo scan's first 2kk."""
    a = _arena(edge_store)
    f, fl, d, dead, _pm = a
    scans = KBench.scan_wave(edge_store, bs)
    desc = KD.scan_batch_desc(scans)
    c = _consts(R.RankingProfile(**NONDEFAULT))
    wide = dict(WIDE)
    st = KD.span_stats_batch(f, fl, d, dead, desc)
    pst = KD.span_stats_batch_plain(f, fl, d, dead, desc)
    for i in range(bs):
        _stats_equal(st[i], pst[i])
    off = KD.scan_batch_offsets(desc, kk)
    buf = KD.span_score_batch(f, fl, d, dead, desc, st, c, off)
    assert torch.equal(buf, KD.span_score_batch_plain(f, fl, d, dead, desc,
                                                      pst, c, off))
    got = TD.scan_batch_query(a, scans, c, kk)
    a_cpu = tuple(t.cpu() for t in a)
    assert torch.equal(got.cpu(), TD.scan_batch_query(a_cpu, scans, c.cpu(),
                                                      kk))
    for i, (ext, filt) in enumerate(scans):
        solo = TD.scan_query(a, ext, c, kk, filt)
        assert torch.equal(got[i], solo[:2 * kk])
    torch.cuda.synchronize()
    if bs > 1:
        assert WIDE["span_stats_batch"] > wide["span_stats_batch"]
        assert WIDE["span_score_batch"] > wide["span_score_batch"]


def test_tie_topk_on_16_streams(dev):
    """tie_topk's cooperative launches from 16 threads, each on a stream
    of its own, beside K7-sized scoring launches on the others: every
    answer equal to the plain version's, none trapped."""
    import threading
    rng = np.random.default_rng(90)
    inputs = [torch.from_numpy(rng.integers(0, 5_000, n, dtype=np.int32))
              .to(dev) for n in (3_000_000, 40_000, 700_000, 100)]
    want = {(i, k): KT.tie_topk_plain(x, k) for i, x in enumerate(inputs)
            for k in (16, 128) if k <= x.shape[0]}
    feats, valid, hostids = _block(2_000_000, seed=91)
    fb, vb, hb = (torch.from_numpy(a).to(dev) for a in (feats, valid,
                                                        hostids))
    st, cnt = KC.cardinal_stats(fb, vb, hb, 0)
    c = _consts(R.RankingProfile())
    torch.cuda.synchronize()
    errors = []

    def worker(t):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for rep in range(20):
                    if t % 4 == 3:
                        KC.cardinal_score(fb, None, vb, hb, st, cnt, c,
                                          False)
                        continue
                    i = (t + rep) % len(inputs)
                    for k in (16, 128):
                        if k > inputs[i].shape[0]:
                            continue
                        g = KT.tie_topk(inputs[i], k)
                        torch.cuda.current_stream().synchronize()
                        w = want[(i, k)]
                        if not (torch.equal(g[0], w[0])
                                and torch.equal(g[2], w[2])):
                            errors.append((t, i, k))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    ts = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=300)
    torch.cuda.synchronize()
    assert not errors and not any(th.is_alive() for th in ts)


def test_batcher_on_the_card_matches_cpu():
    """A store on the card with the batcher (and scan batching) on, and
    its twin on the CPU: 16 threads of pruned queries and of filtered
    scans, a RAM delta and a facet bitmap query; every answer equal to
    the twin's solo answer, K5 and the batched scan launched with more
    than one live slot, no timeout, no exception."""
    import threading
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx = RWIIndex()
    terms = [b"bt%010d" % i for i in range(6)]
    for i, th in enumerate(terms):
        feats, _d, _h, _r = KBench.make_term((300_000, 70_000, 40_000,
                                              9_000, 5_000, 2_000)[i],
                                             KBench.SEED + 30 + i)
        idx.add_many(th, P.PostingsList(
            (i + 7 * np.arange(len(feats))).astype(np.int32), feats))
    idx.flush()
    g = TD.DeviceSegmentStore(idx, device="cuda")
    h = TD.DeviceSegmentStore(idx, device="cpu")
    idx.listener = KBench.Fanout(g, h)
    g.enable_batching(max_batch=16, dispatchers=4, scan_batching=True)
    profs = [R.RankingProfile(), R.RankingProfile(domlength=12, tf=5)]
    jobs = [(th, p, k, f) for th in terms for p in range(2)
            for k in (10, 100) for f in (None, (0x656E, 7, 5_000, 25_000))]

    def kw(f):
        return {} if f is None else dict(lang_filter=f[0], flag_bit=f[1],
                                         from_days=f[2], to_days=f[3])
    want = {}
    for job in jobs:
        h._topk_cache.clear()
        want[job] = h.rank_term(job[0], profs[job[1]], k=job[2],
                                **kw(job[3]))
    wide = dict(WIDE)
    errors = []

    def worker(mine):
        try:
            for job in mine:
                g._topk_cache.clear()
                got = g.rank_term(job[0], profs[job[1]], k=job[2],
                                  **kw(job[3]))
                w = want[job]
                if not (np.array_equal(got[0], w[0])
                        and np.array_equal(got[1], w[1])
                        and got[2] == w[2]):
                    errors.append(job)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    ts = [threading.Thread(target=worker, args=((jobs * 3)[i::16],))
          for i in range(16)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=600)
    assert not errors and not any(th.is_alive() for th in ts)
    c = g.counters()
    assert c["batch_dispatches"] > 0 and c["batch_timeouts"] == 0
    assert c["batch_exceptions"] == 0
    assert WIDE["pruned_tile"] > wide["pruned_tile"]
    assert WIDE["span_stats_batch"] > wide["span_stats_batch"]
    # a RAM delta and a facet bitmap, solo, on the card and on the twin
    idx.add_many(terms[0], P.PostingsList(
        np.arange(5, 60_000, 11).astype(np.int32),
        KBench.make_term(len(range(5, 60_000, 11)), 7)[0]))
    key = ((("site", "x.example"),), 0, 2_100_000)
    allowed = lambda: np.arange(0, 2_100_000, 9)  # noqa: E731
    for extra in ({}, dict(allow_bitmap=g.filter_bitmap(key, allowed))):
        a = g.rank_term(terms[0], profs[0], k=100, **extra)
        if extra:
            extra = dict(allow_bitmap=h.filter_bitmap(key, allowed))
        b = h.rank_term(terms[0], profs[0], k=100, **extra)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a[2] == b[2]
    g.close()


def test_batcher_deletes_on_the_card_match_cpu():
    """Deletes landing while 16 threads send pruned queries and filtered
    scans through the batcher, whose dispatchers apply the pending
    tombstones on their own streams: afterwards the card's tombstone
    bitmap equals the CPU twin's, and every answer from 16 threads again
    equals the twin's."""
    import threading
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx = RWIIndex()
    terms = [b"dt%010d" % i for i in range(4)]
    for i, th in enumerate(terms):
        feats, _d, _h, _r = KBench.make_term((200_000, 50_000, 9_000,
                                              2_000)[i],
                                             KBench.SEED + 40 + i)
        idx.add_many(th, P.PostingsList(
            (i + 5 * np.arange(len(feats))).astype(np.int32), feats))
    idx.flush()
    g = TD.DeviceSegmentStore(idx, device="cuda")
    h = TD.DeviceSegmentStore(idx, device="cpu")
    idx.listener = KBench.Fanout(g, h)
    g.enable_batching(max_batch=16, dispatchers=8, scan_batching=True)
    g._topk_cache.enabled = h._topk_cache.enabled = False
    prof = R.RankingProfile()
    filt = dict(lang_filter=0x656E, flag_bit=7, from_days=5_000)
    jobs = [(th, f, k) for th in terms for f in (False, True)
            for k in (10, 100)]

    def ask(store, job):
        return store.rank_term(job[0], prof, k=job[2],
                               **(filt if job[1] else {}))
    gone = sorted({int(x) for job in jobs for x in ask(h, job)[1][:8]})
    errors = []

    def worker(mine):
        try:
            for job in mine:
                ask(g, job)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    ts = [threading.Thread(target=worker, args=((jobs * 12)[i::16],))
          for i in range(16)]
    for th in ts:
        th.start()
    for x in gone:
        idx.delete_doc(x)
    for th in ts:
        th.join(timeout=600)
    assert not errors and not any(th.is_alive() for th in ts)
    dead_g = g.arena.dead_array().cpu()
    dead_h = h.arena.dead_array()
    assert torch.equal(dead_g, dead_h)
    assert sorted(torch.nonzero(dead_h).flatten().tolist()) == gone
    want = {job: ask(h, job) for job in jobs}
    out = []

    def check(mine):
        for job in mine:
            out.append((job, ask(g, job)))
    ts = [threading.Thread(target=check, args=((jobs * 2)[i::16],))
          for i in range(16)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=600)
    assert len(out) == 2 * len(jobs)
    for job, got in out:
        w = want[job]
        assert np.array_equal(got[0], w[0]) and np.array_equal(got[1], w[1])
        assert got[2] == w[2]
    c = g.counters()
    assert c["batch_timeouts"] == 0 and c["batch_exceptions"] == 0
    g.close()


# ---------------------------------------------------------------------------
# the batched join: join_member_batch, join_stats_batch, join_score_batch
# (kernels/bench.join_edge_waves) and rank_join through the batcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(range(5)))
def test_join_wave_kernels_match_plain(join_store, case):
    """Each wave of the join edge store (16 bitmap slots, mixed modes,
    the clip rows in every slot as partner and as exclude, five partners
    and six excludes; every filter, a slot of no row and one of 100
    rows): the batched K8's rows, kernel 1's statistics and kernel 2's
    scores (two profiles) equal to their plain versions' in every slot's
    region, and join_batch_query's slots equal to the solo join_query's
    after the keep mask."""
    label, desc, n_inc = KBench.join_edge_waves(join_store)[case]
    f, fl, d, dead, pm = _arena(join_store)
    jt = (*join_store.arena.join_arrays(), join_store.arena.bitmap_array())
    off = KD.join_wave_offsets(desc)
    before = LAUNCHES["join_member_batch"]
    got = KD.join_member_batch(f, fl, d, dead, *jt, desc, n_inc, off)
    want = KD.join_member_batch_plain(f, fl, d, dead, *jt, desc, n_inc, off)
    torch.cuda.synchronize()
    assert LAUNCHES["join_member_batch"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(KD.wave_rows(g, desc, off),
                           KD.wave_rows(w, desc, off)), label
    st = KD.join_stats_batch(want[0], want[2], desc, off)
    pst = KD.join_stats_batch_plain(want[0], want[2], desc, off)
    torch.cuda.synchronize()
    for i in range(desc.shape[0]):
        _stats_equal(st[i], pst[i])
    for prof in (R.RankingProfile(), R.RankingProfile(**NONDEFAULT)):
        c = _consts(prof)
        sc = KD.join_score_batch(*want, desc, off, pst, c)
        psc = KD.join_score_batch_plain(*want, desc, off, pst, c)
        torch.cuda.synchronize()
        assert torch.equal(KD.wave_rows(sc, desc, off),
                           KD.wave_rows(psc, desc, off)), label
        for kk in (16, 1024):
            whole = TD.join_batch_query((f, fl, d, dead, pm), jt, desc,
                                        n_inc, c, kk).cpu().numpy()
            for i, (start, count, filt, parts) in enumerate(
                    KD.join_wave_slots(desc, n_inc)):
                s_, d_ = whole[i, :kk], whole[i, kk:]
                keep = (d_ >= 0) & (s_ > TD.NEG_INF32)
                if not count:
                    assert not keep.any()
                    continue
                solo = TD.join_query((f, fl, d, dead, pm), jt, start, count,
                                     parts, n_inc, c, kk, filt).cpu().numpy()
                n = min(kk, count)
                sk = (solo[n:2 * n] >= 0) & (solo[:n] > TD.NEG_INF32)
                assert np.array_equal(s_[keep], solo[:n][sk]), label
                assert np.array_equal(d_[keep], solo[n:2 * n][sk]), label


def test_batched_joins_on_the_card_match_cpu():
    """A store on the card with the batcher on and its twin on the CPU:
    16 threads of conjunctions (a bitmap and a sort-mode partner, an
    exclude, a filter, k 10 and 100, two profiles), then 16 threads of
    one of them (one statics family, so that waves fill): every answer
    the twin's, join_member_batch launched with more than one live slot,
    no timeout, no exception, no failed transfer."""
    import threading
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx = RWIIndex()
    terms = [b"jt%010d" % i for i in range(4)]
    for i, th in enumerate(terms):
        feats, _d, _h, _r = KBench.make_term((300_000, 120_000, 40_000,
                                              20_000)[i],
                                             KBench.SEED + 60 + i)
        ids = KBench.draw_docids(len(feats), 900_000,
                                 np.random.default_rng(KBench.SEED + 70 + i))
        idx.add_many(th, P.PostingsList(ids, feats))
    idx.flush()
    g = TD.DeviceSegmentStore(idx, device="cuda")
    h = TD.DeviceSegmentStore(idx, device="cpu")
    idx.listener = KBench.Fanout(g, h)
    g.enable_batching(max_batch=16, dispatchers=4)
    g._topk_cache.enabled = h._topk_cache.enabled = False
    profs = [R.RankingProfile(), R.RankingProfile(domlength=12, tf=5)]
    shapes = [([terms[2], terms[0]], [], {}),
              ([terms[2], terms[3]], [terms[1]], {}),
              ([terms[1], terms[0], terms[3]], [],
               dict(lang_filter=0x656E, from_days=5_000))]
    jobs = [(q, p, k) for q in range(len(shapes)) for p in range(2)
            for k in (10, 100)]

    def ask(store, job):
        inc, exc, kw = shapes[job[0]]
        return store.rank_join(inc, exc, profs[job[1]], k=job[2], **kw)
    want = {job: ask(h, job) for job in jobs}
    wide = dict(WIDE)
    errors = []

    def worker(mine):
        try:
            for job in mine:
                got, w = ask(g, job), want[job]
                if not (np.array_equal(got[0], w[0])
                        and np.array_equal(got[1], w[1])
                        and got[2] == w[2]):
                    errors.append(job)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    stream = jobs * 4 + [jobs[2]] * 256
    ts = [threading.Thread(target=worker, args=(stream[i::16],))
          for i in range(16)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=600)
    assert not errors and not any(th.is_alive() for th in ts)
    c = g.counters()
    assert c["batch_dispatches"] > 0 and c["batch_timeouts"] == 0
    assert c["batch_exceptions"] == 0 and c["transfer_failures"] == 0
    assert WIDE["join_member_batch"] > wide["join_member_batch"]
    g.close()


# A wave whose kernel faults on the card, in a process of its own (the
# fault leaves the CUDA context unusable for the rest of the process):
# after join_member_batch a gather out of bounds trips a device-side
# assert on the dispatcher's stream, which surfaces at the completer's
# wait. Prints the error rank_join's caller got and the store's counters.
_WAVE_FAULT = r"""
import json, os
import numpy as np
import torch
from yacy_search_server_tpu_torch.index import devstore as TD
from yacy_search_server_tpu_torch.index import postings as P
from yacy_search_server_tpu_torch.index.rwi import RWIIndex
from yacy_search_server_tpu_torch.kernels import bench as KBench
from yacy_search_server_tpu_torch.kernels import devstore as KD
from yacy_search_server_tpu_torch.ops import ranking as R

idx = RWIIndex()
terms = [b"ft%010d" % i for i in range(2)]
for i, th in enumerate(terms):
    feats, _d, _h, _r = KBench.make_term((40_000, 20_000)[i],
                                         KBench.SEED + 90 + i)
    ids = KBench.draw_docids(len(feats), 100_000,
                             np.random.default_rng(KBench.SEED + 95 + i))
    idx.add_many(th, P.PostingsList(ids, feats))
idx.flush()
g = TD.DeviceSegmentStore(idx, device="cuda")
g._topk_cache.enabled = False
g.enable_batching(max_batch=16, dispatchers=1)
first = g.rank_join(terms, [], R.RankingProfile(), k=10)
real = KD.join_member_batch


def faulting(*a, **kw):
    out = real(*a, **kw)
    bad = torch.full((1,), 1 << 30, dtype=torch.int64, device=out[0].device)
    out[1][bad]
    return out


KD.join_member_batch = faulting
try:
    g.rank_join(terms, [], R.RankingProfile(), k=10)
    err = None
except Exception as e:  # noqa: BLE001 - reported below
    err = e
c = g.counters()
print(json.dumps({
    "first": first is not None,
    "type": None if err is None else type(err).__name__,
    "transfer_error": isinstance(err, TD.DeviceTransferError),
    "runtime_error": isinstance(err, RuntimeError),
    "msg": "" if err is None else str(err)[:300],
    "counters": {k: int(c[k]) for k in (
        "device_lost", "device_losses", "transfer_failures",
        "transfer_retries", "device_lost_queries", "join_fallbacks",
        "batch_exceptions")}}), flush=True)
os._exit(0)
"""


def test_join_wave_kernel_fault_reaches_the_caller():
    """A kernel's fault in a join wave on the card is raised to
    rank_join's caller as the CUDA runtime error it is: not retried, not
    counted as a failed transfer or a lost device, not served on the
    host."""
    import json
    import os
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _WAVE_FAULT], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["first"], out
    assert out["runtime_error"] and not out["transfer_error"], out
    assert "CUDA" in out["msg"] or "assert" in out["msg"], out
    assert out["counters"] == {
        "device_lost": 0, "device_losses": 0, "transfer_failures": 0,
        "transfer_retries": 0, "device_lost_queries": 0,
        "join_fallbacks": 0, "batch_exceptions": 1}, out
