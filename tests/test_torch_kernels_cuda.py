"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: each test skips without a CUDA device. Run them on a
machine with one (this file imports no JAX, so the repo's conftest can be
left out):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from yacy_search_server_tpu_torch.index import postings as P
from yacy_search_server_tpu_torch.kernels import (LAUNCHES, bench as KBench,
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
