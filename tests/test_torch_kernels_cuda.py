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


@pytest.mark.parametrize("is_float", [False, True])
@pytest.mark.parametrize("shards,rows,k", [(1, 100, 100), (8, 1000, 1000),
                                           (16, 1000, 1000), (8, 30, 100)])
def test_gather_topk_matches_plain(dev, is_float, shards, rows, k):
    rng = np.random.default_rng(shards * rows)
    m = shards * rows
    if is_float:
        col = (rng.integers(0, 50, m) * 0.5).astype(np.float32).view(np.int32)
    else:
        col = rng.integers(0, 50, m).astype(np.int32)
    block = np.stack([col, rng.integers(-1, 5000, m).astype(np.int32)], 1)
    block = torch.from_numpy(np.ascontiguousarray(block)).to(dev)
    kk = min(k, m)
    before = LAUNCHES["gather_topk"]
    gs, gd = KT.gather_topk(block, kk, is_float)
    ps, pd = KT.gather_topk_plain(block, kk, is_float)
    torch.cuda.synchronize()
    assert LAUNCHES["gather_topk"] == before + 1
    assert torch.equal(gs, ps) and torch.equal(gd, pd)
