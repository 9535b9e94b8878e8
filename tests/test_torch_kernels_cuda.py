"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: each test skips without a CUDA device. Run them on a
machine with one (this file imports no JAX, so the repo's conftest can be
left out):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import time

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
from yacy_search_server_tpu_torch.kernels import scan_batch_bench as SBB
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


@pytest.fixture(scope="module")
def tile_edge_store():
    """kernels/bench.TILE_EDGE_TERMS in an int16 store on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return KBench.tile_edges(RWIIndex(), lambda idx: TD.DeviceSegmentStore(
        idx, device="cuda"))


def _span_slots(store, names):
    """A K5 / K5bp slot (start or word base first) of each span."""
    out = []
    for th in names:
        sp = store.spans_for(th)[0]
        st = sp.stats
        out.append((sp.pbase if sp.pbase >= 0 else sp.start, sp.count,
                    sp.tstart, sp.tcount, st["col_min"], st["col_max"],
                    st["tf_min"], st["tf_max"]))
    return out


def _alloc_bytes(t):
    """The caching allocator's block for tensor t (512-byte steps)."""
    return -(-t.numel() * t.element_size() // 512) * 512


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("kk", [16, 128, 1024, 2048])
@pytest.mark.parametrize("bs", [1, 2, 16, 20, "tile_edges"])
@pytest.mark.parametrize("nondefault", [False, True])
def test_pruned_tile_matches_plain(request, edge_store, nondefault, bs, kk,
                                   init):
    """Pad slots, a ragged last tile, dead rows, live docids past the
    bitmap, ties; the non-default profile's bound fails on the big term;
    20 slots take two launches of 16 and 4, up to 16 one; "tile_edges":
    a span shorter than kk, one of one tile, one all dead, equal scores
    across the CTAs' boundaries. The call allocates its output alone."""
    prof = R.RankingProfile(**NONDEFAULT) if nondefault else R.RankingProfile()
    shift, lang = TD.prune_bound_consts(prof)
    store = edge_store
    if bs == "tile_edges":
        store = request.getfixturevalue("tile_edge_store")
        slots = _span_slots(store, KBench.TILE_EDGE_TERMS)
    else:
        slots = KBench.edge_slots(edge_store, bs)
    desc = KD.pack_desc(slots, int(shift), int(lang))
    a, c = _arena(store), _consts(prof)
    before = LAUNCHES["pruned_tile"]
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    got = KD.pruned_tile(*a, desc, kk, c, init)
    grown = torch.cuda.memory_allocated() - mem
    want = KD.pruned_tile_plain(*a, desc, kk, c, init)
    torch.cuda.synchronize()
    assert LAUNCHES["pruned_tile"] == before + -(-len(slots) // KD.SLOTS)
    assert grown == _alloc_bytes(got), "a scratch buffer beside the output"
    assert torch.equal(got, want)
    if nondefault and kk == 16 and bs != "tile_edges":
        assert int(got[0, 2 * kk]) == 0, "the big term's bound should fail"


@pytest.mark.parametrize("packed", [False, True])
def test_pruned_tile_cluster_sizes_match_plain(edge_store, packed_edges,
                                               packed):
    """K5 / K5bp at both cluster sizes (8 and 16 CTAs a slot) against the
    plain version; then the kernel's own choice again."""
    from yacy_search_server_tpu_torch.kernels import packed as KP
    size, room = KD.pruned_tile_cluster(packed=packed)
    assert size in (8, 16) and room >= 1
    prof = R.RankingProfile()
    shift, lang = TD.prune_bound_consts(prof)
    c = _consts(prof)
    try:
        for want in (8, 16):
            assert KD.pruned_tile_cluster(packed=packed, size=want)[0] == want
            for kk in (16, 2048):
                if packed:
                    stores, blocks = packed_edges
                    slots, metas = _bp_slots(blocks, [1, 2, 0] * 3,
                                             R.pack_stats_host)
                    desc = KP.pack_desc_bp(slots, metas, int(shift),
                                           int(lang))
                    pm = torch.zeros(4, dtype=torch.int32, device="cuda")
                    got = KP.pruned_tile_bp(*stores["cuda"], pm, desc, kk, c)
                    want_ = KP.pruned_tile_bp(*stores["cpu"], pm.cpu(), desc,
                                              kk, c.cpu())
                else:
                    desc = KD.pack_desc(KBench.edge_slots(edge_store, 20),
                                        int(shift), int(lang))
                    a = _arena(edge_store)
                    got = KD.pruned_tile(*a, desc, kk, c, False)
                    want_ = KD.pruned_tile_plain(*a, desc, kk, c, False)
                torch.cuda.synchronize()
                assert torch.equal(got.cpu(), want_.cpu()), (want, kk)
    finally:
        assert KD.pruned_tile_cluster(packed=packed, size=0)[0] == size


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


# K8's redesign (csrc/join.cu join_rows): the partners' search modes, the
# clip rule's redo by the last block of a group, a wave's groups, tiles
# that are not whole and spans that do not start on 16 bytes

def _k8_arena(n, seed, high=(), dead_high=()):
    """n arena rows with docids 2i + 1, those at rows `high` replaced by
    2^29, 2^29 + 1, ... (in that order), 3 % of the others tombstoned and
    the rows `dead_high` too: (feats16, flags, docids, dead) in numpy."""
    rng = np.random.default_rng(seed)
    feats, _v, _h = _block(n, seed)
    f16, flags = R.compact_feats(feats)
    docids = (2 * np.arange(n) + 1).astype(np.int64)
    for i, r in enumerate(high):
        docids[r] = KD.JOIN_DOCID_CAP + i
    dead = np.zeros(KD.JOIN_DOCID_CAP + 64 if len(high) else 2 * n + 2,
                    bool)
    low = docids < KD.JOIN_DOCID_CAP
    dead[docids[low & (rng.random(n) < 0.03)]] = True
    dead[docids[list(dead_high)]] = True
    return f16, flags, docids.astype(np.int32), dead


def _k8_tables(docids, segs, bitmap):
    """Join tables of partner segments, each an array of arena rows:
    jdocids / jpos (each segment sorted by docid), the bitmap table (one
    row a segment, over the docids below 2^29) and each segment's (jstart,
    jcount, slot) with slot its bitmap row where bitmap[i], else -1."""
    jd, jp, parts, at = [], [], [], 0
    n = len(docids)
    nwords = 1 << (2 * n + 32 - 1).bit_length() >> 5
    bm = np.zeros((len(segs), nwords, 2), np.int32)
    for i, rows in enumerate(segs):
        rows = np.asarray(rows, np.int64)
        d = docids[rows]
        o = np.argsort(d, kind="stable")
        jd.append(d[o])
        jp.append(rows[o].astype(np.int32))
        if bitmap[i]:
            assert (d < 32 * nwords).all()
            bm[i] = TD.join_bitmap(d[o], nwords)
        parts.append((at, len(rows), i if bitmap[i] else -1))
        at += len(rows)
    return np.concatenate(jd), np.concatenate(jp), bm, parts


def _k8_dev(dev, f16, flags, docids, dead, jd, jp, bm):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(f16), t(flags), t(docids), t(dead)), (t(jd), t(jp), t(bm))


def _k8_equal(got, want, label=""):
    for g, w in zip(got, want):
        assert torch.equal(g, w), label


@pytest.mark.parametrize("mode", ["staged", "fence 64", "fence wide"])
def test_join_member_search_modes_match_plain(dev, mode):
    """Each way of searching a sort-mode partner (its segment staged whole
    in shared memory, a fence table of every 64th docid where it is just
    too big for that, a table of a wider stride where even every 64th
    docid is more than the table holds), on a rare span that does not
    start on 16 bytes and is not a whole number of tiles: equal to the
    plain version, call after call."""
    n = 1_100_003
    rng = np.random.default_rng(11)
    f16, flags, docids, dead = _k8_arena(n, 12)
    # the first sort partner: staged whole, one entry over that, or 1M
    most = KD.join_stage_most(dev)
    seg0 = {"staged": min(20_000, most), "fence 64": most + 1,
            "fence wide": 1_000_000}[mode]
    assert 4096 * 64 < 1_000_000 and most + 1 < 4096 * 64
    segs = [np.sort(rng.choice(n, seg0, replace=False)),
            np.sort(rng.choice(n, 90_000, replace=False)),
            np.sort(rng.choice(n, 5_000, replace=False))]
    jd, jp, bm, parts = _k8_tables(docids, segs, [False, True, False])
    arena, jt = _k8_dev(dev, f16, flags, docids, dead, jd, jp, bm)
    for ps, n_inc in (([parts[0], parts[1]], 2), ([parts[0]], 1)):
        for start, count in ((3, 150_001), (1, 129), (0, 1), (5, 4_097)):
            before = LAUNCHES["join_member"]
            outs = [KD.join_member(*arena, start, count, *jt, ps, n_inc,
                                   None) for _ in range(2)]
            want = KD.join_member_plain(*arena, start, count, *jt, ps,
                                        n_inc, None)
            torch.cuda.synchronize()
            assert LAUNCHES["join_member"] == before + 2
            for got in outs:
                _k8_equal(got, want, (mode, len(ps), start, count))
            if count > 1000:
                assert int(want[2].sum()) > 0


def test_join_member_partner_at_the_stage_edge(dev):
    """A sort-mode partner just small enough to be staged whole in a
    block's shared memory and one just too big (searched through a fence
    table), each as the only partner and the two together: equal to the
    plain version."""
    under = KD.join_stage_most(dev)
    over = under + 1
    n = 3 * over
    rng = np.random.default_rng(21)
    f16, flags, docids, dead = _k8_arena(n, 22)
    segs = [np.sort(rng.choice(n, under, replace=False)),
            np.sort(rng.choice(n, over, replace=False))]
    jd, jp, bm, parts = _k8_tables(docids, segs, [False, False])
    arena, jt = _k8_dev(dev, f16, flags, docids, dead, jd, jp, bm)
    for ps, n_inc in (([parts[0]], 1), ([parts[1]], 1), (parts, 2),
                      (parts, 1)):
        got = KD.join_member(*arena, 7, n - 9, *jt, ps, n_inc, None)
        want = KD.join_member_plain(*arena, 7, n - 9, *jt, ps, n_inc, None)
        torch.cuda.synchronize()
        _k8_equal(got, want, (len(ps), n_inc))
        assert int(want[2].sum()) > 0


# rows at or above 2^29 spread over the span, so different blocks hold
# them; the last one tombstoned
_HIGH = (1_000, 150_003, 300_001, 450_007, 599_990)


def _k8_clip_case(dev):
    n = 600_000
    rng = np.random.default_rng(31)
    f16, flags, docids, dead = _k8_arena(n, 32, high=_HIGH,
                                         dead_high=_HIGH[-1:])
    high = np.asarray(_HIGH)
    # a sort partner holding 2^29 (the first high row's docid) and a third
    # of the others; a bitmap partner of half the low rows; a sort
    # exclude of a tenth
    low = np.setdiff1d(np.arange(n), high)
    segs = [np.concatenate([high[:1], rng.choice(low, n // 3,
                                                 replace=False)]),
            rng.choice(low, n // 2, replace=False),
            np.concatenate([high[:1], rng.choice(low, n // 10,
                                                 replace=False)])]
    jd, jp, bm, parts = _k8_tables(docids, segs, [False, True, False])
    return n, _k8_dev(dev, f16, flags, docids, dead, jd, jp, bm), parts


def test_join_member_clip_rows_in_different_blocks(dev):
    """Rows at or above 2^29 in different blocks, the last tombstoned,
    against a sort partner that holds 2^29: only the last still-valid one
    matches, as the plain version decides; as an exclude, only it falls
    out. Each call leaves the counters at zero, so a second and third
    call agree."""
    n, (arena, jt), parts = _k8_clip_case(dev)
    for ps, n_inc in (([parts[0]], 1), ([parts[1], parts[0]], 2),
                      ([parts[1], parts[2]], 1), ([parts[2]], 0)):
        outs = [KD.join_member(*arena, 0, n, *jt, ps, n_inc, None)
                for _ in range(3)]
        want = KD.join_member_plain(*arena, 0, n, *jt, ps, n_inc, None)
        torch.cuda.synchronize()
        for got in outs:
            _k8_equal(got, want, (ps, n_inc))
        hv = want[2][list(_HIGH)].tolist()
        if n_inc and ps[-1] == parts[0]:
            assert sum(hv) <= 1 and not hv[-1]



def test_join_rows_refuses_a_malformed_call(dev):
    """A call whose partner runs past the join tables, or whose slot's
    region does not start on a multiple of 4 rows, is refused before any
    launch; so is a wave whose region does not."""
    from yacy_search_server_tpu_torch.kernels import build as KBuild
    n = 5_000
    f16, flags, docids, dead = _k8_arena(n, 41)
    jd, jp, bm, parts = _k8_tables(docids, [np.arange(0, n, 3)], [False])
    arena, jt = _k8_dev(dev, f16, flags, docids, dead, jd, jp, bm)
    out = (torch.empty((n, P.NF), dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev))
    stream = KBuild.stream_ptr(dev)
    jcap = jt[0].shape[0]

    def call(part, off):
        gw, sw = KD.join_words([(0, n, [part])], [(off, 0, KD.NO_FILTER)])
        return KBuild.library().yt_join_rows(
            *(t.data_ptr() for t in arena), dead.shape[0],
            jt[0].data_ptr(), jt[1].data_ptr(), jcap, jt[2].data_ptr(),
            jt[2].shape[1], gw.buffer_info()[0], 1, sw.buffer_info()[0], 1,
            1, 0, *(t.data_ptr() for t in out),
            KD._join_counters(dev, stream).data_ptr(), stream)

    assert call(parts[0], 0) == 0
    assert call((1, jcap, -1), 0) != 0
    assert call(parts[0], 2) != 0
    torch.cuda.synchronize()
    want = KD.join_member_plain(*arena, 0, n, *jt, parts, 1, None)
    _k8_equal(out, want)
    desc = KD.join_wave_desc([(0, 10, None, parts), (20, 10, None, parts)],
                             1, 0)
    with pytest.raises(ValueError):
        KD.join_member_batch(*arena, *jt, desc, 1, np.array([0, 10, 20]))

_LANG = (0x656E, KD.NO_FLAG, KD.DAYS_NONE_LO, KD.DAYS_NONE_HI)
_FLAG = (KD.NO_LANG, 3, KD.DAYS_NONE_LO, KD.DAYS_NONE_HI)


def test_join_wave_groups_match_plain(dev):
    """A wave whose slots form groups of five, three and two (equal and
    different filters) mixed with slots that share nothing (another span,
    other partners, no rows), the clip rows in the span: each slot's
    region equal to the plain version's, slots of one group and filter
    equal to each other, one launch a call, and a second call equal to
    the first."""
    n, (arena, jt), parts = _k8_clip_case(dev)
    pa = [parts[0], parts[2]]       # a sort partner and a sort exclude
    pb = [parts[1], parts[2]]       # a bitmap partner and the exclude
    slots = [(0, n, None, pa), (0, n, _LANG, pa), (5, 70_001, None, pa),
             (0, n, None, pb), (0, n, _FLAG, pa), (0, n, None, pa),
             (5, 70_001, _LANG, pa), (9, 0, None, pa), (0, n, _LANG, pa),
             (5, 70_001, _LANG, pa), (300_000, 1, _FLAG, pb),
             (0, n, None, pb)]
    desc = KD.join_wave_desc(slots, 1, 1)
    assert KD.join_wave_groups(desc, 1) == [[0, 1, 4, 5, 8], [2, 6, 9],
                                            [3, 11], [7], [10]]
    off = KD.join_wave_offsets(desc)
    before = LAUNCHES["join_member_batch"]
    outs = [KD.join_member_batch(*arena, *jt, desc, 1, off)
            for _ in range(2)]
    want = KD.join_member_batch_plain(*arena, *jt, desc, 1, off)
    torch.cuda.synchronize()
    assert LAUNCHES["join_member_batch"] == before + 2
    for got in outs:
        for g, w in zip(got, want):
            assert torch.equal(KD.wave_rows(g, desc, off),
                               KD.wave_rows(w, desc, off))
    v = outs[1][2]
    same = [(0, 5), (1, 8), (6, 9), (3, 11)]
    for a, b in same:
        c = int(desc[a, 1])
        assert torch.equal(v[int(off[a]):int(off[a]) + c],
                           v[int(off[b]):int(off[b]) + c])
    assert int(want[2].sum()) > 0


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


@pytest.mark.parametrize("kk", [16, 1024, 4096])
@pytest.mark.parametrize("bs", [1, 3, 16])
def test_batched_scan_matches_plain_and_solo(edge_store, bs, kk):
    """The batched K6 and K7 with its selection over a wave of bs edge
    scans (1, 2 and 8 extents, five filters): each equal to its plain
    version, the wave equal to the CPU's, each slot equal to the solo
    scan's first 2kk (kk 4096: the lists in device memory)."""
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
    assert torch.equal(KD.span_topk_batch(f, fl, d, dead, desc, st, c, kk),
                       KD.span_topk_batch_plain(f, fl, d, dead, desc, pst,
                                                c, kk))
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
        assert WIDE["span_topk_batch"] > wide["span_topk_batch"]


@pytest.fixture(scope="module")
def scan_arena():
    """kernels/scan_batch_bench's arena of the smoke's run at a tenth of
    its rows, on the card: (arrays, spans)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    host, spans = SBB.make_arena(scale=0.1)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
                 for a in host), spans


def _scan_wave(spans, shape):
    """The waves of the batched scan's card tests: the bench's shapes A
    (16 slots, two groups of 8) and B (7 groups of one), one slot, and
    16 filters over one span list (one group of 16, its lists in device
    memory from kk = 2048, where 16 slots' lists no longer fit in shared
    memory)."""
    waves = SBB.wave_shapes(spans)
    head = [spans["10M"], spans["10M, run 2"]]
    filts = [(lang, flag, lo, SBB.HI) for lang in (0, SBB.EN, SBB.DE)
             for flag in (-1, 3) for lo in (SBB.LO, 10_000)][:16]
    filts += [SBB.FILTERS[2]] * (16 - len(filts))
    return {"A": waves["A"], "B": waves["B"], "one": waves["A"][:1],
            "16 filters": [(head, q) for q in filts]}[shape]


def _batched_route(arrays, scans, c, kk):
    """scan_batch_query on the card with the launches it made, against
    the bench's oracle."""
    before = dict(LAUNCHES)
    got = TD.scan_batch_query((*arrays, None), scans, c, kk)
    torch.cuda.synchronize()
    ran = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
           if LAUNCHES[k] != before[k]}
    assert torch.equal(got, SBB.oracle(arrays, scans, c, kk))
    return got, ran


@pytest.mark.parametrize("kk", [16, 128, 2048, 4096, 8192])
@pytest.mark.parametrize("shape", ["A", "B", "one", "16 filters"])
def test_span_topk_batch_matches_plain(scan_arena, shape, kk):
    """The batched K6 and the batched K7 with its selection each equal to
    its plain version on the bench's waves (at a tenth of the rows), and
    scan_batch_query equal to the oracle of the plain versions slot by
    slot, in one K6 and one K7 launch (no kernel 3, no finish), at every
    kk (past KD.FUSED_KK the lists in device memory)."""
    arrays, spans = scan_arena
    f, fl, d, dead = arrays
    scans = _scan_wave(spans, shape)
    desc = KD.scan_batch_desc(scans)
    c = _consts(R.RankingProfile())
    st = KD.span_stats_batch(f, fl, d, dead, desc)
    pst = KD.span_stats_batch_plain(f, fl, d, dead, desc)
    for i in range(len(scans)):
        _stats_equal(st[i], pst[i])
    got = KD.span_topk_batch(f, fl, d, dead, desc, st, c, kk)
    assert torch.equal(got, KD.span_topk_batch_plain(f, fl, d, dead, desc,
                                                     pst, c, kk))
    _got, ran = _batched_route(arrays, scans, c, kk)
    assert ran == {"span_stats_batch": 1, "span_topk_batch": 1}


def test_scan_batch_above_the_fused_limit(scan_arena):
    """Past KD.FUSED_KK (shape A at kk = 4096 and 8192: the smoke's
    k = 3000 waves take kk = 4096) the batched K7 still selects each
    slot's kk best itself, its lists in device memory: the answer equal
    to the plain versions', one K6 and one K7 launch, no kernel 3, no
    finish (the wave's 3 device operations, K6's memset and kernel and K7:
    kernels/scan_batch_bench.py's trace)."""
    arrays, spans = scan_arena
    scans = _scan_wave(spans, "A")
    c = _consts(R.RankingProfile())
    for kk in (4096, 8192):
        _got, ran = _batched_route(arrays, scans, c, kk)
        assert ran == {"span_stats_batch": 1, "span_topk_batch": 1}
    desc = KD.scan_batch_desc(scans)
    st = KD.span_stats_batch(*arrays, desc)
    with pytest.raises(ValueError):
        KD.span_topk_batch(*arrays, desc, st, c, KD.MAX_WAVE_KK + 1)


@pytest.mark.parametrize("kk", [16, 128, 2048, 4096])
def test_span_topk_batch_equal_scores_across_blocks(dev, kk):
    """Every row of a 600,000-row span equal (all scores equal, so the
    answer is the first kk live rows in extent order, which many blocks
    hold): four slots over the span, one over a part of it (a group of
    its own) and one over two extents; some of the first rows dead."""
    n = 600_000
    feats, _d, _h, _r = KBench.make_term(1, KBench.SEED + 40)
    f16, fl = R.compact_feats(np.repeat(feats, n, axis=0))
    docids = np.random.default_rng(41).permutation(n).astype(np.int32)
    dead = np.zeros(n, bool)
    dead[docids[[0, 5, 17, 4_000, 300_001]]] = True
    a = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
              for x in (f16, fl, docids, dead))
    lang = int(f16[0, P.F_LANGUAGE])
    scans = [([(0, n)], None), ([(0, n)], (lang, -1, SBB.LO, SBB.HI)),
             ([(0, n)], (0, -1, SBB.LO, SBB.HI)), ([(0, n)], None),
             ([(7, n - 7)], None), ([(300_000, 300_000), (0, 300_000)],
                                    None)]
    scans = [(e, q if q is not None else KD.NO_FILTER) for e, q in scans]
    c = _consts(R.RankingProfile())
    got, ran = _batched_route(a, scans, c, kk)
    assert ran == {"span_stats_batch": 1, "span_topk_batch": 1}
    live = ~dead[docids]
    first = docids[live][:kk]
    for i in (0, 1, 3):
        assert np.array_equal(got[i, kk:].cpu().numpy(), first)
        assert (got[i, :kk] == got[i, 0]).all()


def test_span_topk_batch_overlapping_groups(scan_arena):
    """Slots whose extents overlap but differ (separate groups), slots of
    identical extents and filter, and a slot of two extents over another
    term's span: each slot equal to the plain versions'."""
    arrays, spans = scan_arena
    s1, n1 = spans["1M"]
    sA, nA = spans["joinA"]
    q0, q1 = SBB.FILTERS[0], SBB.FILTERS[1]
    scans = [([(s1, n1)], q0), ([(s1 + 1_000, n1 - 1_000)], q0),
             ([(s1, n1 // 2)], q1), ([(s1, n1), (sA, nA)], q0),
             ([(s1 + 1_000, n1 - 1_000)], q1), ([(s1, n1)], q0),
             ([(sA, nA), (s1, n1)], q0)]
    c = _consts(R.RankingProfile(**NONDEFAULT))
    for kk in (16, 128):
        got, ran = _batched_route(arrays, scans, c, kk)
        assert ran == {"span_stats_batch": 1, "span_topk_batch": 1}
        assert torch.equal(got[0], got[5])


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


# ---------------------------------------------------------------------------
# the dense rerank: K9 dense_dot, K10 rerank_sort, K11 hybrid_blend
# ---------------------------------------------------------------------------

def _fwd(cap, seed=30):
    """A forward index of unit rows, every 97th row a copy of row 5
    (equal boosts)."""
    v = KBench.unit_vectors(cap, np.random.default_rng(seed))
    v[::97] = v[min(5, cap - 1)]
    return v


@pytest.mark.parametrize("nb,ns", [
    (16, (3, 16, 0, 13)), (128, (100, 128, 1, 77, 0, 5, 64, 99) * 2),
    (1024, (1000, 0, 513)), (16384, (16384, 9000)),
    (128, tuple(range(1, 21)))], ids=["16", "128x16", "1024", "16384",
                                      "bs20"])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_dense_rerank_kernels_match_plain(dev, nb, ns, alpha):
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    from yacy_search_server_tpu_torch.ops import dense as DN
    cap = max(4096, 2 * nb)
    fwd = torch.from_numpy(_fwd(cap)).to(dev)
    qi, nb, slots = KBench.rerank_wave(np.random.default_rng(nb + len(ns)),
                                       cap, ns, nb, alpha)
    qd = KDn.upload_desc(qi, dev)
    g0 = LAUNCHES["dense_dot"]
    final = KDn.dense_gather_boost(fwd, qd, nb)
    want = KDn.dense_gather_boost_plain(fwd, qd, nb)
    torch.cuda.synchronize()
    assert torch.equal(final, want)
    assert LAUNCHES["dense_dot"] == g0 + 1
    out = KDn.rerank_sort(final, qd, nb)
    assert torch.equal(out, KDn.rerank_sort_plain(final, qd, nb))
    got = DN.rerank_fwd_batch_packed(fwd, qi, nb).cpu().numpy()
    assert np.array_equal(got, out.cpu().numpy())
    fwd_np = fwd.cpu().numpy()
    for i, (q, sp, dd) in enumerate(slots):
        n = len(dd)
        es, ed = DN.rerank_fwd_np(q, fwd_np, sp, dd, alpha)
        assert np.array_equal(got[i, nb:nb + n], ed) or alpha != 0.0
        assert set(got[i, nb:nb + n].tolist()) == set(ed.tolist())
        e = dict(zip(ed.tolist(), es.tolist()))
        assert all(abs(s - e[d]) <= 64 for s, d in
                   zip(got[i, :n].tolist(), got[i, nb:nb + n].tolist()))
        assert (got[i, n:nb] == -(2**31 - 1)).all()


@pytest.mark.parametrize("n", [1, 100, 1000, 65_537])
def test_dense_rows_boost_matches_plain(dev, n):
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    rng = np.random.default_rng(n)
    docs = torch.from_numpy(_fwd(n)).to(dev)
    q = torch.from_numpy(KBench.unit_vectors(1, rng, dtype=np.float32)[0]
                         ).to(dev)
    sp = torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32)
                          ).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    got = KDn.dense_rows_boost(docs, q, sp, valid, 0.5)
    want = KDn.dense_rows_boost_plain(docs, q, sp, valid, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("nq", [1, 3, 16, 33])
@pytest.mark.parametrize("n", [1, 1000, 65_537])
def test_dense_sims_and_blend_match_plain(dev, nq, n):
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    from yacy_search_server_tpu_torch.ops import dense as DN
    rng = np.random.default_rng(nq * n)
    docs = torch.from_numpy(_fwd(n)).to(dev)
    qs = torch.from_numpy(KBench.unit_vectors(nq, rng, dtype=np.float32)
                          ).to(dev)
    sims = KDn.dense_sims(docs, qs)
    assert torch.equal(sims, KDn.dense_sims_plain(docs, qs))
    sparse = torch.from_numpy(rng.integers(0, 1000, (nq, n)).astype(
        np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((nq, n)) < 0.9).to(dev)
    valid[0, :] = n == 1            # one slot all valid or all invalid
    for alpha in (0.0, 0.5, 1.0):
        got = KDn.hybrid_blend(sims, sparse, valid, alpha)
        assert torch.equal(got, KDn.hybrid_blend_plain(sims, sparse, valid,
                                                       alpha))
    k = min(n, 10)
    s, i = DN.hybrid_rerank_topk_batch(qs, docs, sparse, valid, 0.5, k)
    torch.cuda.synchronize()
    for b in range(nq):
        s1, i1 = DN.hybrid_rerank_topk(qs[b], docs, sparse[b], valid[b], 0.5,
                                       k)
        assert torch.equal(s[b], s1) and torch.equal(i[b], i1)
        ps, pi = DN.hybrid_rerank_topk(qs[b].cpu(), docs.cpu(),
                                       sparse[b].cpu(), valid[b].cpu(), 0.5,
                                       k)
        assert torch.equal(s1.cpu(), ps) and torch.equal(i1.cpu(), pi)


# K9's similarity mode on register tiles: one row (a tile of 64 with 63
# unused rows), a ragged last tile, one to two passes of 32 queries and
# every unit width (1-4 queries)
@pytest.mark.parametrize("nq", [1, 16, 31, 32, 33, 40])
@pytest.mark.parametrize("n", [1, 4099])
def test_dense_sims_register_tiles_match_plain(dev, nq, n):
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    rng = np.random.default_rng(nq + 7 * n)
    docs = torch.from_numpy(_fwd(n, seed=n + nq)).to(dev)
    qs = torch.from_numpy(KBench.unit_vectors(nq, rng, dtype=np.float32)
                          ).to(dev)
    before = LAUNCHES["dense_dot"]
    sims = KDn.dense_sims(docs, qs)
    torch.cuda.synchronize()
    assert LAUNCHES["dense_dot"] == before + 1
    assert torch.equal(sims, KDn.dense_sims_plain(docs, qs))


def test_dense_sims_mul_add_and_fma_passes_match_plain(dev):
    """40 queries in two passes: the first's elements all in [2^-100,
    2^100] (the fma at the leaf pairs), the second's query 35 with
    elements near 1e-35 (the pass takes mul + add)."""
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    rng = np.random.default_rng(35)
    docs = torch.from_numpy(_fwd(4099, seed=3)).to(dev)
    q = KBench.unit_vectors(40, rng, dtype=np.float32)
    q[35, ::3] = rng.uniform(0.5e-35, 2e-35, len(q[35, ::3]))
    qs = torch.from_numpy(q).to(dev)
    assert torch.equal(KDn.dense_sims(docs, qs).cpu(),
                       KDn.dense_sims_plain(docs.cpu(), qs.cpu()))


def test_dense_sims_subnormal_products_match_plain(dev):
    """Queries scaled to about 1e-37: every product is an f32 subnormal,
    rounded on its own (an fma of the leaf pairs would round twice less
    and differ), held against the plain version on the CPU."""
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    rng = np.random.default_rng(37)
    docs = torch.from_numpy(_fwd(1000, seed=4)).to(dev)
    q = KBench.unit_vectors(16, rng, dtype=np.float32) * np.float32(1e-36)
    qs = torch.from_numpy(q).to(dev)
    got = KDn.dense_sims(docs, qs).cpu()
    want = KDn.dense_sims_plain(docs.cpu(), qs.cpu())
    assert torch.equal(got, want) and bool((want != 0).any())


def test_dense_boost_topk_matches_plain(dev):
    from yacy_search_server_tpu_torch.ops import dense as DN
    rng = np.random.default_rng(8)
    docs = _fwd(1000)
    q = KBench.unit_vectors(1, rng, dtype=np.float32)[0]
    sp = rng.integers(0, 1 << 20, 1000).astype(np.int32)
    sp[::3] = sp[0]
    valid = rng.random(1000) < 0.8
    for k in (1, 100, 1000):
        s, i = DN.dense_boost_topk(q, docs, sp, valid, 0.5, k, device=dev)
        ps, pi = DN.dense_boost_topk(q, docs, sp, valid, 0.5, k,
                                     device="cpu")
        assert torch.equal(s.cpu(), ps) and torch.equal(i.cpu(), pi)


def test_dense_kernels_reject_other_widths(dev):
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    docs = torch.zeros((8, 128), dtype=torch.float16, device=dev)
    with pytest.raises(ValueError):
        KDn.dense_sims(docs, torch.zeros((1, 128), device=dev))


def test_dense_kernels_reject_f32_rows(dev):
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    docs = torch.zeros((8, 256), dtype=torch.float32, device=dev)
    q = torch.zeros(256, device=dev)
    with pytest.raises(TypeError, match="f16"):
        KDn.dense_sims(docs, q.view(1, -1))
    with pytest.raises(TypeError, match="f16"):
        KDn.dense_rows_boost(docs, q, torch.zeros(8, dtype=torch.int32,
                                                  device=dev),
                             torch.ones(8, dtype=torch.bool, device=dev), 0.5)


# ---------------------------------------------------------------------------
# packed residency: K12 unpack_rows, K5bp pruned_tile_bp, K6bp
# span_stats_bp, K7bp span_score_bp, topk_finish_bp, K13 pack_block_batch
# ---------------------------------------------------------------------------

def _edge_block(n, seed):
    """A compact block whose columns take every width: a constant column
    (w = 1), flags over all of int32 (w = 32), docids up to 2^31 - 1
    (w = 31), the rest of make_term's ranges (straddling widths); the
    best row repeated (ties)."""
    feats, _d, _h, rng = KBench.make_term(n, seed)
    f16, fl = R.compact_feats(feats)
    f16[:, P.F_WORDS_IN_TITLE] = 3
    fl = rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64).astype(
        np.int32)
    fl[:2] = (-2 ** 31, 2 ** 31 - 1)[:n]
    dd = np.sort(rng.choice(2 ** 31 - 1, n, replace=False)).astype(np.int32)
    dd[-1:] = 2 ** 31 - 1
    dd[::7] = rng.integers(0, 4_000, len(dd[::7]))   # under the bitmap
    return f16, fl, dd


@pytest.fixture(scope="module")
def packed_edges():
    """A packed-words store of three blocks (40,000, 70,001 and 900
    rows) on the card and on the CPU, the last block ending on the
    store's last word; a tombstone bitmap over some of their docids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yacy_search_server_tpu_torch.ops import packed as TPK
    blocks, words, base = [], [], 0
    for i, n in enumerate((40_000, 70_001, 900)):
        f16, fl, dd = _edge_block(n, 60 + i)
        blk = TPK.pack_block(f16, fl, dd)
        blocks.append((base, blk, (f16, fl, dd)))
        words.append(blk.words)
        base += len(blk.words)
    store = np.concatenate(words)
    dead = np.zeros(4_096, bool)
    dead[::3] = True
    t = lambda a, d: torch.from_numpy(a).to(d)  # noqa: E731
    return {d: (t(store, d), t(dead, d)) for d in ("cuda", "cpu")}, blocks


@pytest.mark.parametrize("block", [0, 1, 2])
@pytest.mark.parametrize("row0,rows", [(0, None), (1, 64), (33, 5_000),
                                       ("end", 300)])
def test_unpack_rows_matches_plain(packed_edges, block, row0, rows):
    """K12 against its plain version and the host unpack: from row 0, a
    ragged piece, rows past the count (garbage, clamped to the store),
    the last block's straddles reading the store's last word."""
    from yacy_search_server_tpu_torch.kernels import packed as KP
    stores, blocks = packed_edges
    base, blk, (f16, fl, dd) = blocks[block]
    meta = blk.meta_vector()
    if row0 == "end":
        row0 = blk.count - 100
    rows = blk.count - row0 if rows is None else rows
    before = LAUNCHES["unpack_rows"]
    got = KP.unpack_rows(stores["cuda"][0], base, meta, row0, rows)
    want = KP.unpack_rows(stores["cpu"][0], base, meta, row0, rows)
    torch.cuda.synchronize()
    assert LAUNCHES["unpack_rows"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    inside = slice(0, max(0, min(rows, blk.count - row0)))
    assert torch.equal(got[0].cpu()[inside], torch.from_numpy(
        f16[row0:row0 + rows].astype(np.int32)))
    assert torch.equal(got[2].cpu()[inside],
                       torch.from_numpy(dd[row0:row0 + rows]))


def _bp_slots(blocks, which, stats_of):
    out, metas = [], []
    for i in which:
        base, blk, (f16, fl, _dd) = blocks[i]
        st = stats_of(f16, fl)
        out.append((base, blk.count, 0, 0, st["col_min"], st["col_max"],
                    st["tf_min"], st["tf_max"]))
        metas.append(blk.meta_vector())
    return out, metas


@pytest.fixture(scope="module")
def packed_tile_edges():
    """kernels/bench.TILE_EDGE_TERMS in a packed store on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return KBench.tile_edges(RWIIndex(), lambda idx: TD.DeviceSegmentStore(
        idx, device="cuda", packed_residency=True))


@pytest.mark.parametrize("kk", [16, 1024, 2048])
@pytest.mark.parametrize("which", [[0], [1, 2, 0], [2] * 9, [1, 2],
                                   "tile_edges"],
                         ids=["one", "three", "nine", "two", "tile_edges"])
@pytest.mark.parametrize("nondefault", [False, True])
def test_pruned_tile_bp_matches_plain(request, packed_edges, which, kk,
                                      nondefault):
    """K5bp against its plain version: a tile past a block's count (900
    rows: the rest decodes garbage), dead rows, ties; nine slots take two
    launches of eight and one, up to eight one. The tail walk has no pmax
    rows here (tcount 0): the int16 K5 tests hold it. "tile_edges": a
    packed store's span shorter than kk, one of one tile, one all dead,
    equal scores across the CTAs' boundaries. The call allocates its
    output alone."""
    from yacy_search_server_tpu_torch.kernels import packed as KP
    prof = R.RankingProfile(**NONDEFAULT) if nondefault else R.RankingProfile()
    shift, lang = TD.prune_bound_consts(prof)
    if which == "tile_edges":
        ps = request.getfixturevalue("packed_tile_edges")
        names = list(KBench.TILE_EDGE_TERMS)
        slots = _span_slots(ps, names)
        metas = [ps.spans_for(th)[0].pmeta for th in names]
        stores = {d: (ps.arena.packed_array().to(d),
                      ps.arena.dead_array().to(d)) for d in ("cuda", "cpu")}
        pmax = {d: ps.arena._pmax.to(d) for d in ("cuda", "cpu")}
    else:
        stores, blocks = packed_edges
        slots, metas = _bp_slots(blocks, which, R.pack_stats_host)
        pmax = {d: torch.zeros(4, dtype=torch.int32, device=d)
                for d in ("cuda", "cpu")}
    desc = KP.pack_desc_bp(slots, metas, int(shift), int(lang))
    before = LAUNCHES["pruned_tile_bp"]
    c = R.profile_consts(prof, 0x656E, "cuda")
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    got = KP.pruned_tile_bp(*stores["cuda"], pmax["cuda"], desc, kk, c)
    grown = torch.cuda.memory_allocated() - mem
    want = KP.pruned_tile_bp(*stores["cpu"], pmax["cpu"], desc, kk,
                             R.profile_consts(prof, 0x656E, "cpu"))
    torch.cuda.synchronize()
    assert LAUNCHES["pruned_tile_bp"] == before + -(-len(slots)
                                                    // KP.BP_SLOTS)
    assert grown == _alloc_bytes(got), "a scratch buffer beside the output"
    assert torch.equal(got.cpu(), want)


FILTS = [None, (0x656E, -1, KD.DAYS_NONE_LO, KD.DAYS_NONE_HI),
         (0, 31, 5_000, 25_000), (0x7777, -1, KD.DAYS_NONE_LO,
                                  KD.DAYS_NONE_HI)]


@pytest.mark.parametrize("filt", FILTS, ids=["none", "lang", "flag_days",
                                             "nothing"])
@pytest.mark.parametrize("block", [0, 1, 2])
def test_span_kernels_bp_match_plain(packed_edges, block, filt):
    """K6bp, K7bp (and the rows past the span, -(2^31-1)), kernel 3 and
    topk_finish_bp without and with a tail check, against their plain
    versions: the store's exact scan over one packed span."""
    from yacy_search_server_tpu_torch.kernels import packed as KP
    stores, blocks = packed_edges
    base, blk, _ = blocks[block]
    meta = blk.meta_vector()
    n = blk.count
    c = {d: R.profile_consts(R.RankingProfile(), 0x656E, d)
         for d in ("cuda", "cpu")}
    st = {d: KP.span_stats_bp(*stores[d], base, meta, n, filt)
          for d in ("cuda", "cpu")}
    torch.cuda.synchronize()
    _stats_equal(st["cuda"], st["cpu"])
    out_len = n + 1_000
    sc = {d: KP.span_score_bp(*stores[d], base, meta, n, st["cpu"].to(d),
                              c[d], out_len, filt) for d in ("cuda", "cpu")}
    torch.cuda.synchronize()
    assert torch.equal(sc["cuda"].cpu(), sc["cpu"])
    pmax = {d: torch.full((8,), 5, dtype=torch.int32, device=d)
            for d in ("cuda", "cpu")}
    for kk in (16, 1024):
        top_s, top_rows, _ = KT.tie_topk(sc["cuda"], kk)
        for tail in (None, (2, 5, 0, 0)):
            got = KP.topk_finish_bp(top_s, top_rows, stores["cuda"][0], base,
                                    meta, n, pmax=pmax["cuda"], tail=tail)
            want = KP.topk_finish_bp(top_s.cpu(), top_rows.cpu(),
                                     stores["cpu"][0], base, meta, n,
                                     pmax=pmax["cpu"], tail=tail)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want)


# the packed scan's K6bp and K7bp on blocks at the edges of their tiles:
# (case, rows), block i at a word base of residue i mod 4, the last ending
# on the store's last word
BP_BLOCKS = [("edge", 1), ("edge", 31), ("equal", 5_000), ("edge", 33),
             ("edge", 1_023), ("dead", 1_000), ("edge", 1_025),
             ("edge", 40_000), ("edge", 300_001), ("edge", 2_049)]
# the smoke's filtered-scan mix and no filter
BP_FILTS = [None, *SBB.FILTERS]


@pytest.fixture(scope="module")
def bp_store():
    """BP_BLOCKS packed into one words store on the card and on the CPU:
    _edge_block's rows (flags of width 32, a constant column), every row
    equal ("equal": equal scores at every place), every docid tombstoned
    ("dead"); garbage words between the blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yacy_search_server_tpu_torch.ops import packed as TPK
    parts, blocks, at = [], [], 0
    for i, (case, n) in enumerate(BP_BLOCKS):
        pad = (i - at) % 4 + 4
        parts.append(np.full(pad, -0x5A5A5A5B, np.int32))
        at += pad
        f16, fl, dd = _edge_block(n, 80 + i)
        if case == "equal":
            f16[:], fl[:] = f16[0], fl[0]
        elif case == "dead":
            dd = (3 * np.arange(n)).astype(np.int32)
        blk = TPK.pack_block(f16, fl, dd)
        blocks.append((at, blk))
        parts.append(blk.words)
        at += len(blk.words)
    store = np.concatenate(parts)
    dead = np.zeros(4_096, bool)
    dead[::3] = True
    t = lambda a, d: torch.from_numpy(a).to(d)  # noqa: E731
    return {d: (t(store, d), t(dead, d)) for d in ("cuda", "cpu")}, blocks


def _bp_span(wbase, blk, meta=None):
    return TD.Span(start=-1, count=blk.count, pbase=wbase,
                   pmeta=blk.meta_vector() if meta is None else meta)


@pytest.mark.parametrize("kk", [16, 128, 2048])
@pytest.mark.parametrize("filt", BP_FILTS,
                         ids=["none", "smoke0", "smoke1", "smoke2",
                              "smoke3"])
def test_span_topk_bp_matches_plain(bp_store, filt, kk):
    """K6bp and K7bp with its selection against their plain versions on
    every block of the edge store (word bases at each residue mod 4, the
    store's last word, counts about a tile, one block of the grid and
    many, equal scores, every row dead, a column read at width 0), and
    scan_query_bp in one K6bp and one span_topk_bp launch: no kernel 3,
    no K7bp buffer, no finish."""
    from yacy_search_server_tpu_torch.kernels import packed as KP
    stores, blocks = bp_store
    c = {d: R.profile_consts(R.RankingProfile(), 0x656E, d)
         for d in ("cuda", "cpu")}
    for wbase, blk in blocks:
        metas = [blk.meta_vector()]
        if blk.widths[P.F_WORDS_IN_TITLE] == 1:
            m0 = blk.meta_vector().copy()
            m0[len(blk.widths) + P.F_WORDS_IN_TITLE] = 0
            metas.append(m0)
        for meta in metas:
            st = {d: KP.span_stats_bp(*stores[d], wbase, meta, blk.count,
                                      filt) for d in ("cuda", "cpu")}
            torch.cuda.synchronize()
            _stats_equal(st["cuda"], st["cpu"])
            got = KP.span_topk_bp(*stores["cuda"], wbase, meta, blk.count,
                                  st["cpu"].to("cuda"), c["cuda"], kk, filt)
            want = KP.span_topk_bp(*stores["cpu"], wbase, meta, blk.count,
                                   st["cpu"], c["cpu"], kk, filt)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (blk.count, wbase % 4)
            before = dict(LAUNCHES)
            got = TD.scan_query_bp(*stores["cuda"], _bp_span(wbase, blk,
                                                             meta),
                                   c["cuda"], kk, filt)
            torch.cuda.synchronize()
            ran = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                   if LAUNCHES[k] != before[k]}
            assert ran == {"span_stats_bp": 1, "span_topk_bp": 1}
            assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("filt", BP_FILTS[:2], ids=["none", "smoke0"])
def test_span_score_bp_past_the_fused_limit(bp_store, filt):
    """Past KD.FUSED_KK (kk = 4096) scan_query_bp takes K7bp's buffer
    mode, kernel 3 and topk_finish_bp: each equal to its plain version on
    every block (the buffer past the span -(2^31-1)); span_topk_bp
    refuses the kk."""
    from yacy_search_server_tpu_torch.kernels import packed as KP
    stores, blocks = bp_store
    c = {d: R.profile_consts(R.RankingProfile(**NONDEFAULT), 0x6465, d)
         for d in ("cuda", "cpu")}
    kk = 4096
    for wbase, blk in blocks:
        meta, n = blk.meta_vector(), blk.count
        st = KP.span_stats_bp(*stores["cpu"], wbase, meta, n, filt)
        sc = {d: KP.span_score_bp(*stores[d], wbase, meta, n, st.to(d),
                                  c[d], n + 5_000, filt)
              for d in ("cuda", "cpu")}
        torch.cuda.synchronize()
        assert torch.equal(sc["cuda"].cpu(), sc["cpu"])
        before = dict(LAUNCHES)
        got = TD.scan_query_bp(*stores["cuda"], _bp_span(wbase, blk),
                               c["cuda"], kk, filt)
        want = TD.scan_query_bp(*stores["cpu"], _bp_span(wbase, blk),
                                c["cpu"], kk, filt)
        torch.cuda.synchronize()
        ran = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
               if LAUNCHES[k] != before[k]}
        assert ran == {"span_stats_bp": 1, "span_score_bp": 1,
                       "tie_topk": 1, "topk_finish_bp": 1}
        assert torch.equal(got.cpu(), want)
        with pytest.raises(ValueError):
            KP.span_topk_bp(*stores["cuda"], wbase, meta, n,
                            st.to("cuda"), c["cuda"], KD.FUSED_KK + 1, filt)


@pytest.mark.parametrize("sizes", [[64], [1, 0, 64, 257, 1000, 999],
                                   [70_001, 65_536, 33]])
def test_pack_block_batch_matches_plain_and_host(sizes):
    """K13 against its plain version and each lane against the host pack
    (ragged lanes, an empty one, w = 1 and w = 32 columns)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yacy_search_server_tpu_torch.ingest import devbuild as TB
    from yacy_search_server_tpu_torch.kernels import packed as KP
    from yacy_search_server_tpu_torch.ops import packed as TPK
    rows = TB.rows_bucket(max(sizes))
    b = len(sizes)
    f16 = np.zeros((b, rows, P.NF), np.int16)
    fl = np.zeros((b, rows), np.int32)
    dd = np.zeros((b, rows), np.int32)
    parts = []
    for j, m in enumerate(sizes):
        part = _edge_block(m, 70 + j) if m else (
            np.zeros((0, P.NF), np.int16), np.zeros(0, np.int32),
            np.zeros(0, np.int32))
        parts.append(part)
        f16[j, :m], fl[j, :m], dd[j, :m] = part
    n = np.asarray(sizes, np.int32)
    t = lambda a, d: torch.from_numpy(a).to(d)  # noqa: E731
    before = LAUNCHES["pack_block_batch"]
    got = KP.pack_block_batch(*(t(a, "cuda") for a in (f16, fl, dd, n)))
    want = KP.pack_block_batch(*(t(a, "cpu") for a in (f16, fl, dd, n)))
    torch.cuda.synchronize()
    assert LAUNCHES["pack_block_batch"] == before + 1
    for a, w in zip(got, want):
        assert torch.equal(a.cpu(), w)
    words, meta, totals = (a.cpu().numpy() for a in got)
    for j, part in enumerate(parts):
        blk = TPK.pack_block(*part)
        assert np.array_equal(words[j, :totals[j]], blk.words)
        assert np.array_equal(meta[j], blk.meta_vector())
    # the device build through devbuild: every block the host pack's
    blocks = TB.pack_block_batch(parts, "cuda")
    for blk, part in zip(blocks, parts):
        assert np.array_equal(blk.words, TPK.pack_block(*part).words)


def test_packed_store_on_the_card_matches_cpu():
    """A packed store on the card (device build on) and its twin on the
    CPU over one RWI, with a budget that holds two of three terms: the
    pruned and filtered queries solo and from 16 threads through the
    batcher, a warm promotion through the batcher's `promote` kind, and
    a delete; every answer the twin's, every new kernel launched."""
    import threading
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx = RWIIndex()
    # the packed words' capacity may reach 2^21: the 200,000-row block
    # and the 9,000-row one fit, the 60,000-row one stays warm
    budget = TD.TILE * 42 + (1 << 16) + 4 * (1 << 21)
    g = TD.DeviceSegmentStore(idx, device="cuda", packed_residency=True,
                              budget_bytes=budget)
    h = TD.DeviceSegmentStore(idx, device="cpu", packed_residency=True,
                              budget_bytes=budget)
    for s in (g, h):
        s.ingest_device_build = True
    idx.listener = KBench.Fanout(g, h)
    terms = [b"pk%010d" % i for i in range(3)]
    for i, th in enumerate(terms):
        feats, _d, _h, _r = KBench.make_term((200_000, 60_000, 9_000)[i],
                                             KBench.SEED + 40 + i)
        idx.add_many(th, P.PostingsList(
            (i + 5 * np.arange(len(feats))).astype(np.int32), feats))
    idx.flush()
    assert g.ingest_device_builds == h.ingest_device_builds == 3
    hot = {k[1]: e["hot"] for k, e in g._pblocks.items()}
    assert hot == {k[1]: e["hot"] for k, e in h._pblocks.items()}
    assert sum(hot.values()) == 2
    profs = [R.RankingProfile(), R.RankingProfile(**NONDEFAULT)]
    filt = dict(lang_filter=0x656E, from_days=5_000)
    l0 = dict(LAUNCHES)

    def both(th, p, k, **kw):
        g._topk_cache.clear()
        h._topk_cache.clear()
        a = g.rank_term(th, profs[p], k=k, **kw)
        b = h.rank_term(th, profs[p], k=k, **kw)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            assert a[2] == b[2]
        return a
    hot_terms = [th for th in terms if hot[th]]
    for th in hot_terms:
        for p in range(2):
            for k in (10, 1000):
                assert both(th, p, k) is not None
                assert both(th, p, k, **filt) is not None
        # past the fused kk: K7bp's buffer, kernel 3 and topk_finish_bp
        assert both(th, 0, 3000, **filt) is not None
    g.enable_batching(max_batch=16, dispatchers=4)
    want = {(th, p): both(th, p, 100) for th in hot_terms for p in range(2)}
    errors = []

    def worker(mine):
        for job in mine:
            got = g.rank_term(job[0], profs[job[1]], k=100)
            if not (np.array_equal(got[0], want[job][0])
                    and np.array_equal(got[1], want[job][1])):
                errors.append(job)
    g._topk_cache.enabled = False
    ts = [threading.Thread(target=worker, args=((list(want) * 24)[i::16],))
          for i in range(16)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=600)
    assert not errors
    g._topk_cache.enabled = True
    cold = [th for th in terms if not hot[th]][0]
    assert both(cold, 0, 10) is None
    deadline = time.monotonic() + 30
    while g.tier_promotions_warm_hot < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert g.tier_promotions_warm_hot == h.tier_promotions_warm_hot == 1
    assert both(cold, 0, 10) is not None
    c = g.counters()
    assert c["batch_exceptions"] == 0 and c["batch_timeouts"] == 0
    first = both(cold, 0, 10)
    idx.delete_doc(int(first[1][0]))
    assert both(cold, 0, 10) is not None
    for name in ("pruned_tile_bp", "span_stats_bp", "span_topk_bp",
                 "span_score_bp", "topk_finish_bp", "unpack_rows"):
        assert LAUNCHES[name] > l0[name], name
    g.close()


# ---------------------------------------------------------------------------
# the dense-first ANN: K14 ann_assign, K15 ann_fuse; K16 bm25_pass
# ---------------------------------------------------------------------------

def _centroid_block(c_real, rng):
    cp = 1 << max(4, (c_real - 1).bit_length())
    cent = np.zeros((cp, 256), np.float16)
    cent[:c_real] = KBench.unit_vectors(c_real, rng)
    cent[c_real // 2] = cent[0]             # two equal centroids: a tie
    return cent


@pytest.mark.parametrize("c_real", [12, 1000, 1024, 4096])
@pytest.mark.parametrize("nq", [1, 16])
def test_ann_assign_matches_plain(dev, c_real, nq):
    from yacy_search_server_tpu_torch.kernels import ann as KA
    rng = np.random.default_rng(c_real + nq)
    cent = torch.from_numpy(_centroid_block(c_real, rng)).to(dev)
    q = KBench.unit_vectors(nq, rng, dtype=np.float32)
    q[0] = -cent[0].cpu().numpy()           # anti-aligned with a centroid
    qv = torch.from_numpy(q).to(dev)
    for np_ in sorted({1, 8, min(64, c_real), c_real}):
        a0 = LAUNCHES["ann_assign"]
        got = KA.ann_assign(cent, qv, np_, c_real)
        want = KA.ann_assign_plain(cent, qv, np_, c_real)
        torch.cuda.synchronize()
        assert torch.equal(got, want), np_
        assert LAUNCHES["ann_assign"] == a0 + 1
        assert int(got.max()) < c_real
    assert torch.equal(KA.ann_assign(cent.cpu(), qv.cpu(), 8, c_real),
                       KA.ann_assign(cent, qv, 8, c_real).cpu())


def _hot_slab(cap, rng):
    slab = rng.integers(-127, 128, (cap, 256)).astype(np.int8)
    slab[::50] = slab[3]                    # equal rows: equal sims
    scales = (rng.random(cap) / 127).astype(np.float16)
    scales[::50] = scales[3]
    sdoc = rng.permutation(cap).astype(np.int32) * 3
    return slab, scales, sdoc


@pytest.mark.parametrize("nb,ns", [
    (256, (256, 0, 17)), (1024, (1000, 513, 0, 1024) * 4),
    (16384, (16384, 9000)), (32768, (17000, 32768, 0)), (65536, (40000,))],
    ids=["256", "1024x16", "16384", "32768", "65536"])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_ann_fuse_matches_plain(dev, nb, ns, alpha):
    from yacy_search_server_tpu_torch.kernels import ann as KA
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    from yacy_search_server_tpu_torch.ops import ann as A
    rng = np.random.default_rng(nb + len(ns))
    cap = 70_000
    slab, scales, sdoc = (torch.from_numpy(a).to(dev)
                          for a in _hot_slab(cap, rng))
    qi = KBench.ann_wave(rng, cap, ns, nb, alpha)
    qd = KDn.upload_desc(qi, dev)
    for kk in sorted({1, 16, min(nb, 1000), min(nb, 2048), min(nb, 8192)}):
        f0 = LAUNCHES["ann_fuse"]
        got = KA.ann_fuse(slab, scales, sdoc, qd, nb, kk)
        want = KA.ann_fuse_plain(slab, scales, sdoc, qd, nb, kk)
        torch.cuda.synchronize()
        assert torch.equal(got, want), kk
        assert LAUNCHES["ann_fuse"] == f0 + 1
        for i, n in enumerate(ns):
            if n == 0:      # no valid lane: all pad
                assert (got[i, kk:] == KA.INT32_MAX).all()
                assert (got[i, :kk] == KA.NEG).all()
    out = A.ann_fuse_batch_packed(slab, scales, sdoc, qi, nb, 16)
    assert torch.equal(out, KA.ann_fuse(slab, scales, sdoc, qd, nb, 16))


@pytest.mark.parametrize("nb,ns", [
    (32768, (16699,) * 16), (32768, (0, 32768, 17, 2049, 4095, 4097)),
    (1024, (1000,) * 16), (65536, (65536, 40000))],
    ids=["mix-16", "ragged", "1024x16", "65536"])
def test_ann_fuse_one_launch(dev, nb, ns):
    """K15 up to kk 2048 takes its one-launch route (no key buffer) for a
    call of up to 16 slots and allocates nothing beside its output; its
    answers equal the plain version's at kk 1 to 8192 (past 2048 the
    two-kernel route); a slot with no valid lane is all pad. (One device
    operation a call: kernels/ann_fuse_bench.py's trace.)"""
    from yacy_search_server_tpu_torch.kernels import ann as KA
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    rng = np.random.default_rng(nb + len(ns) + 7)
    cap = 70_000
    slab, scales, sdoc = (torch.from_numpy(a).to(dev)
                          for a in _hot_slab(cap, rng))
    qd = KDn.upload_desc(KBench.ann_wave(rng, cap, ns, nb, 0.5), dev)
    for kk in (1, 16, 17, 32, 128, 129, 2048, 2049, 8192):
        if kk > nb:
            continue
        got = KA.ann_fuse(slab, scales, sdoc, qd, nb, kk)
        want = KA.ann_fuse_plain(slab, scales, sdoc, qd, nb, kk)
        torch.cuda.synchronize()
        assert torch.equal(got, want), kk
        for i, n in enumerate(ns):
            if n == 0:
                assert (got[i, kk:] == KA.INT32_MAX).all()
                assert (got[i, :kk] == KA.NEG).all()
        if kk <= 2048:
            # the one-launch route: no key buffer
            assert KA.fuse_scratch_bytes(dev, len(ns), nb, kk) == 0
            torch.cuda.synchronize()
            a0 = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
            KA.ann_fuse(slab, scales, sdoc, qd, nb, kk)
            a1 = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
            assert a1 - a0 == 1, kk       # the output alone


@pytest.mark.parametrize("kk", [16, 32, 256, 2048])
def test_ann_fuse_equal_keys_across_ctas(dev, kk):
    """Lanes whose keys are equal (one row, one docid, one sparse score)
    spread over every CTA of a slot's cluster, beside a few better and
    worse lanes and lanes outside the slab: the answer equal to the plain
    version's, the equal keys filling the places the better ones leave."""
    from yacy_search_server_tpu_torch.kernels import ann as KA
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    from yacy_search_server_tpu_torch.ops import ann as A
    rng = np.random.default_rng(kk + 11)
    cap, nb = 5_000, 32768
    slab, scales, sdoc = (torch.from_numpy(a).to(dev)
                          for a in _hot_slab(cap, rng))
    q = KBench.unit_vectors(1, rng, 256, np.float32)[0]
    rows = np.full(nb, 7, np.int32)
    dd = np.full(nb, 123_456, np.int32)
    sp = np.full(nb, 1_000, np.int32)
    better = rng.choice(nb, 5, replace=False)
    sp[better] = 50_000 + np.arange(5)
    dd[better] = 99 + np.arange(5)
    worse = rng.choice(nb, 300, replace=False)
    sp[worse] = -50_000
    rows[worse[:40]] = cap + 3              # outside the slab
    qi = np.stack([A.pack_ann_fuse_row(q, rows, dd, sp, 0.5, nb),
                   A.pack_ann_fuse_row(q, rows[:20_000], dd[:20_000],
                                       sp[:20_000], 0.0, nb)])
    qd = KDn.upload_desc(qi, dev)
    got = KA.ann_fuse(slab, scales, sdoc, qd, nb, kk)
    want = KA.ann_fuse_plain(slab, scales, sdoc, qd, nb, kk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int((got[0, kk:] == 123_456).sum()) >= kk - 5


@pytest.mark.parametrize("t", [0, 1, 4, 8])
@pytest.mark.parametrize("n", [1, 1000, 1_000_000])
@pytest.mark.parametrize("tf_int", [False, True])
def test_bm25_pass_matches_plain(dev, t, n, tf_int):
    rng = np.random.default_rng(n + t)
    tf = rng.integers(0, 9, (n, t)).astype(np.int32 if tf_int
                                           else np.float32)
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    tf_d, dl = put(tf), put(rng.integers(40, 800, n).astype(np.int32))
    df = put(rng.integers(1, max(n, 2), t).astype(np.int32))
    for valid in (put(rng.random(n) < 0.9), torch.zeros(n, dtype=torch.bool,
                                                         device=dev)):
        for nd in (n, torch.tensor(n, dtype=torch.int32, device=dev)):
            b0 = LAUNCHES["bm25_pass"]
            got = R.bm25_scores(tf_d, dl, df, nd, valid)
            want = R.bm25_scores_plain(tf_d, dl, df, nd, valid)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32))
            assert LAUNCHES["bm25_pass"] == b0 + 1
    cpu = R.bm25_scores(tf_d.cpu(), dl.cpu(), df.cpu(), n, valid.cpu())
    assert torch.equal(cpu, R.bm25_scores(tf_d, dl, df, n, valid).cpu())


def test_dense_first_on_the_card_matches_cpu(dev):
    """A store on the card and one on the CPU, each with an index of one
    layout: with every cluster hot, solo answers and 16 threads through
    the batcher equal the CPU store's to the bit; with half the corpus
    hot, a warm cluster promoted through the batcher answers as the CPU
    store's after its own (inline) promotion; a lost device's answers are
    search_host's."""
    import threading

    from yacy_search_server_tpu_torch.index.annstore import AnnVectorIndex
    rng = np.random.default_rng(41)
    n = 200_000
    vecs, _c = KBench.clustered_vectors(n, rng, n_clusters=64)
    layout = ("centroids", "_slab", "_scales", "_sdocids", "_cstart",
              "_ccount", "_row_of")

    def pair(budget):
        out = []
        for device in ("cuda", "cpu"):
            ix = AnnVectorIndex(256, device=device,
                                device_budget_bytes=budget)
            if out:
                ix.adopt(*(getattr(out[0][1], a) for a in layout))
            else:
                ix.build(lambda a, b: vecs[a:b], n, n_clusters=64,
                         sample_n=8192, iters=2, seed=1)
            st = TD.DeviceSegmentStore(RWIIndex(), device=device)
            st.attach_ann(ix)
            out.append((st, ix))
        return out
    (g, gi), (h, hi) = pair(1 << 30)
    assert len(gi._hot_map) == 64
    qs = [(vecs[int(i)], rng.integers(0, 1 << 24, 20).astype(np.int32),
           rng.integers(0, n + 1000, 20).astype(np.int32))
          for i in rng.integers(0, n, 16)]

    def ask(s, q, **kw):
        return s.dense_first_topk(*q, 0.5, 100, **kw)

    def same(a, b):
        return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    want = [ask(h, q) for q in qs]
    assert all(same(ask(g, q), w) for q, w in zip(qs, want))
    g.enable_batching(max_batch=16, dispatchers=4)
    out = [None] * len(qs)

    def worker(i):
        out[i] = ask(g, qs[i])
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=120)
    assert all(same(a, b) for a, b in zip(out, want))
    c = g.counters()
    assert c["batch_timeouts"] == 0 and c["batch_exceptions"] == 0
    assert c["ann_queries"] == 32 and c["ann_host_queries"] == 0
    assert c["ann_tier_warm_hits"] == 0
    g.device_lost = True
    got = ask(g, qs[0])
    assert same(got, hi.search_host(qs[0][0], qs[0][2], qs[0][1], 0.5, 100))
    assert g.counters()["ann_host_queries"] == 1
    g.close()
    # the ladder: half the corpus hot
    (g, gi), (h, hi) = pair((n // 2) * 262)
    g.enable_batching(max_batch=16, dispatchers=4)
    warm = max(gi._hot_map) + 1
    q = (np.asarray(gi.centroids[warm], np.float32), np.zeros(0, np.int32),
         np.zeros(0, np.int32))
    first = ask(g, q, nprobe=1)
    assert same(first, ask(h, q, nprobe=1))     # warm: the host's numpy
    ask(g, q, nprobe=1)
    deadline = time.monotonic() + 30
    while (gi.promotions == 0 or gi._hot_pending) and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    ask(h, q, nprobe=1)                         # h promotes inline
    assert gi.promotions == hi.promotions == 1 and gi.patches >= 1
    assert g.counters()["tier_promote_async"] == 1
    assert same(ask(g, q, nprobe=1), ask(h, q, nprobe=1))
    assert g.counters()["ann_tier_hot_hits"] >= 1
    g.close()


def _k17_matches_plain(dev, g, damping=0.85, steps=None):
    """K17 on the card against its plain version on the CPU: the ranks to
    the bit, the trip count (and `steps` where given), one launch a
    call."""
    from yacy_search_server_tpu_torch.kernels import blockrank as KBr
    n = len(g[3])
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in g]
    want, want_steps = KBr.power_iterate_plain(*cpu, damping, n)
    before = LAUNCHES["power_iterate"]
    got, got_steps = KBr.power_iterate(*(a.to(dev) for a in cpu), damping,
                                       n)
    torch.cuda.synchronize()
    assert LAUNCHES["power_iterate"] == before + 1
    assert got_steps == want_steps
    if steps is not None:
        assert want_steps == steps
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


# K17 `power_iterate`: card against its plain version to the bit, and the
# trip count: tiny shapes, n that is no multiple of a block or a window,
# a self-loop, damping 0.5
@pytest.mark.parametrize("n,e", [(1, 1), (2, 1), (31, 100), (33, 40),
                                 (64, 512), (257, 1000), (1000, 7000),
                                 (4096, 65536), (50_000, 800_000),
                                 (300_001, 3_000_000)])
@pytest.mark.parametrize("damping", [0.85, 0.5])
def test_power_iterate_matches_plain(dev, n, e, damping):
    _k17_matches_plain(dev, KBench.edge_list(n, e, seed=n), damping)


def test_power_iterate_all_dangling_and_no_edges(dev):
    n = 70_001
    empty = np.zeros(0, np.int32)
    _k17_matches_plain(dev, (empty, empty, np.zeros(0, np.float32),
                             np.ones(n, bool)))
    # a few edges, every other host dangling
    _k17_matches_plain(dev, KBench.edge_list(n, 50, seed=3))


def test_power_iterate_hub_of_50000(dev):
    """One destination with 50,000 in-edges (the block-a-hub path, a
    serial chain of 50,000 adds) among uniform edges."""
    _k17_matches_plain(dev, KBench.edge_list(100_003, 300_000, seed=5,
                                        hub=50_000))


def test_power_iterate_hubs_at_round_edges(dev):
    """Destinations of 33 (just past a thread's share), 1023, 1024, 1025,
    2048 and 4097 in-edges: a hub block's rounds of 1024 staged products,
    full, short and of one, the four-at-a-time adds and their rest."""
    srcs, dsts, _w, _d = KBench.edge_list(20_011, 40_000, seed=9)
    for hub, deg in enumerate((33, 1023, 1024, 1025, 2048, 4097)):
        srcs = np.concatenate([srcs, np.arange(100, 100 + deg,
                                               dtype=np.int32)])
        dsts = np.concatenate([dsts, np.full(deg, hub, np.int32)])
    order = np.random.default_rng(2).permutation(len(srcs))
    srcs, dsts = srcs[order], dsts[order]
    counts = np.ones(len(srcs), np.float32)
    out_total = np.zeros(20_011, np.float32)
    np.add.at(out_total, srcs, counts)
    _k17_matches_plain(dev, (srcs, dsts, counts / out_total[srcs],
                             out_total == 0.0))


@pytest.mark.parametrize("case", [0, 1, 2])
def test_power_iterate_edge_graphs(dev, case):
    """kernels/bench.k17_graphs: the work tiers at their edges (in-degrees
    32, 33, HUB_MIN, HUB_MIN + 1; equal-degree hubs and medium
    destinations; a dangling hub and one that is a source), a ring that
    stops after one step and a star that runs all 50."""
    from yacy_search_server_tpu_torch.kernels import blockrank as KBr
    _label, g, damping, steps = KBench.k17_graphs(KBr.HUB_MIN)[case]
    _k17_matches_plain(dev, g, damping, steps)


@pytest.mark.parametrize("hub_min", [32, 33, 1024])
def test_power_iterate_other_hub_thresholds(dev, hub_min):
    """The tier graph laid out with every destination past 32 in-edges a
    hub (32), the threshold one above a thread's share (33), and a lower
    one than HUB_MIN (1024); `launch` over that layout against the plain
    version, to the bit and in as many steps, one launch."""
    from yacy_search_server_tpu_torch.kernels import blockrank as KBr
    g = KBench.tier_graph(hub_min)
    n = len(g[3])
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in g]
    want, want_steps = KBr.power_iterate_plain(*cpu, 0.85, n)
    lay = KBr.layout(*(a.to(dev) for a in cpu), n, hub_min=hub_min)
    assert lay["n_hub"] >= 6
    before = LAUNCHES["power_iterate"]
    KBr.launch(lay, 0.85)
    st = lay["state"].cpu()
    assert LAUNCHES["power_iterate"] == before + 1
    assert int(st[1]) == want_steps
    assert torch.equal(lay["rb"][int(st[4])].cpu().view(torch.int32),
                       want.view(torch.int32))


def test_power_iterate_is_one_kernel_a_call(dev):
    """A launch is the fill, the state's zero and one kernel, whatever the
    trip count (50 steps here)."""
    from yacy_search_server_tpu_torch.kernels import blockrank as KBr
    g = KBench.star_graph()
    lay = KBr.layout(*(torch.from_numpy(a).to(dev) for a in g), len(g[3]))
    ops = KBench.device_ops(lambda: KBr.launch(lay, 0.85))
    assert int(lay["state"][1]) == 50
    assert 1 <= len(ops) <= 3
    assert sum("br_iterate" in o for o in ops) == 1


def test_power_iterate_realistic_graph(dev):
    """kernels/bench.host_graph: 1,000,000 hosts, about 5M edges, Zipf
    hubs near 45,000 in-edges, 95 % of the hosts dangling."""
    _k17_matches_plain(dev, KBench.host_graph())


# ---------------------------------------------------------------------------
# the mesh store's kernels: K4 batched, K16 split, K7's docid column, K18
# xjoin, and the store on 2 x 2 cells of the card against its CPU twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", [1, 8])
@pytest.mark.parametrize("runs,kk", [(1, 16), (4, 16), (4, 1024), (8, 2048)])
@pytest.mark.parametrize("case", ["random", "tied", "empty"])
def test_gather_topk_batch_matches_plain(dev, bs, runs, kk, case):
    """K4 batched over bs slots of `runs` cells' pruned runs: all-tied
    runs, cells with none of the term, runs out of tie order; each slot's
    merge and ok (the cells' pmin) equal to the plain version's."""
    rng = np.random.default_rng(bs * 1000 + runs + kk)
    g = KBench.pruned_runs(bs, runs, kk, rng, tied=case == "tied",
                      empty=(0, runs - 1) if case == "empty" else ())
    b0 = LAUNCHES["gather_topk_batch"]
    for k in (kk, min(kk * runs, kk + 5)):
        got = KT.gather_topk_batch(g.to(dev), kk, k, False, kk, 2 * kk)
        want = KT.gather_topk_batch_plain(g, kk, k, False, kk, 2 * kk)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    got = KT.gather_topk_batch(g[:, :, :2 * kk].contiguous().to(dev), kk,
                               kk * runs, False, kk)
    want = KT.gather_topk_batch_plain(g[:, :, :2 * kk], kk, kk * runs,
                                      False, kk)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert LAUNCHES["gather_topk_batch"] == b0 + 3


@pytest.mark.parametrize("n_doc,t", [(2, 1), (2, 3), (4, 8)])
def test_bm25_split_matches_plain(dev, n_doc, t):
    """K16's halves as a 2-row mesh runs them: each cell's sums, their
    sum over the doc axis, each cell's rows over its term columns against
    it; equal to the plain halves to the bit, and the halves summed equal
    to bm25_pass on the whole block where one cell holds every term."""
    rng = np.random.default_rng(n_doc * 10 + t)
    n = 200_003
    tf = rng.integers(0, 9, (n, 2 * t)).astype(np.float32)
    dl = rng.integers(40, 800, n).astype(np.int32)
    df = rng.integers(1, n, 2 * t).astype(np.int32)
    valid = rng.random(n) < 0.9
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    rows = np.array_split(np.arange(n), n_doc)
    b0, r0 = LAUNCHES["bm25_sums"], LAUNCHES["bm25_rows"]
    accs = [R.bm25_sums(put(dl[r]), put(valid[r])) for r in rows]
    acc = sum(accs[1:], accs[0])
    pacc = R.bm25_sums_plain(torch.from_numpy(dl), torch.from_numpy(valid))
    assert torch.equal(acc.cpu(), pacc)
    for r in rows:
        for cols in (slice(0, t), slice(t, 2 * t)):
            got = R.bm25_rows(put(tf[r][:, cols]), put(dl[r]), put(df[cols]),
                              n, put(valid[r]), acc)
            want = R.bm25_rows_plain(
                torch.from_numpy(np.ascontiguousarray(tf[r][:, cols])),
                torch.from_numpy(dl[r]), torch.from_numpy(df[cols]), n,
                torch.from_numpy(valid[r]), pacc)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32))
    whole = R.bm25_rows(put(tf), put(dl), put(df), n, put(valid), acc)
    assert torch.equal(whole, R.bm25_scores(put(tf), put(dl), put(df), n,
                                            put(valid)))
    assert LAUNCHES["bm25_sums"] == b0 + n_doc
    assert LAUNCHES["bm25_rows"] == r0 + 2 * n_doc + 1


@pytest.mark.parametrize("filt", [None, (0x6465, -1, -(2**30), 2**30)])
@pytest.mark.parametrize("with_delta", [False, True])
def test_span_score_docid_column_matches_plain(edge_store, filt,
                                               with_delta):
    """K7 with its docid column over the edge store's extents (ragged
    last tile, every row tombstoned, several extents) and a RAM delta
    after them: scores and docids equal to the plain version's, -1 past
    the rows; the scores equal to K7 without the column."""
    f, fl, d, dead, _pm = _arena(edge_store)
    ext = KBench.edge_extents(edge_store, 4)
    delta = (convert.delta_from_numpy(*KBench.edge_delta(edge_store, 1000),
                                      device=f.device)
             if with_delta else None)
    st = KD.span_stats(f, d, dead, ext, flags=fl, filt=filt, delta=delta)
    rows = sum(c for _s, c in ext) + (delta[2].shape[0] if delta else 0)
    b0 = LAUNCHES["span_score_docids"]
    got_s, got_d = KD.span_score(f, fl, d, dead, ext, st, _consts_on(f.device),
                                 rows + 77, filt=filt, delta=delta,
                                 with_docids=True)
    want_s, want_d = KD.span_score_plain(
        f.cpu(), fl.cpu(), d.cpu(), dead.cpu(), ext, st.cpu(),
        _consts_on("cpu"), rows + 77, filt,
        tuple(a.cpu() for a in delta) if delta else None, None, True)
    plain = KD.span_score(f, fl, d, dead, ext, st, _consts_on(f.device),
                          rows + 77, filt=filt, delta=delta)
    torch.cuda.synchronize()
    assert torch.equal(got_s.cpu(), want_s)
    assert torch.equal(got_d.cpu(), want_d)
    assert torch.equal(got_s, plain)
    assert (got_d[rows:] == -1).all()
    assert LAUNCHES["span_score_docids"] == b0 + 1


def _consts_on(device):
    return R.profile_consts(R.RankingProfile(), 0x656E, device)


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("filt", [None, (0x656E, 3, 5_000, 25_000)])
def test_xjoin_matches_plain(join_store, case, filt):
    """K18: the probe of each term in turn (its prior the earlier terms'
    outputs), then the apply on the rare rows; every output equal to the
    plain versions' on the same inputs, as the mesh runs them."""
    label, rare, wins, n_inc = KBench.xjoin_edge_cases(join_store)[case]
    f, fl, d, dead, _pm = _arena(join_store)
    jd, jp = KBench.xjoin_table(join_store, wins)
    dev = f.device
    cand = d[rare.start:rare.start + rare.count]
    contrib = torch.empty((len(wins), KD.XJOIN_ROWS, rare.count),
                          dtype=torch.int32, device=dev)
    pcontrib = contrib.cpu().clone()
    p0, a0 = LAUNCHES["xjoin_probe"], LAUNCHES["xjoin_apply"]
    for j, (lo, cnt) in enumerate(wins):
        got = KD.xjoin_probe(cand, dead, contrib[:j] if j else None, n_inc,
                             jd, jp, lo, cnt, f, fl)
        want = KD.xjoin_probe_plain(
            cand.cpu(), dead.cpu(), pcontrib[:j] if j else None, n_inc,
            jd.cpu(), jp.cpu(), lo, cnt, f.cpu(), fl.cpu())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (label, j)
        contrib[j].copy_(got)
        pcontrib[j].copy_(want)
    got = KD.xjoin_apply(f, fl, d, dead, rare.start, rare.count, contrib,
                         n_inc, filt)
    want = KD.xjoin_apply_plain(f.cpu(), fl.cpu(), d.cpu(), dead.cpu(),
                                rare.start, rare.count, pcontrib, n_inc,
                                filt)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w), label
    assert LAUNCHES["xjoin_probe"] == p0 + len(wins)
    assert LAUNCHES["xjoin_apply"] == a0 + 1


def test_mesh_store_on_the_card_matches_cpu_twin(dev):
    """A 2 x 2 MeshSegmentStore with all four cells on the card and its
    twin on four CPU cells (kernels/bench.mesh_twin): mesh_edges' queries
    (pruned and escalating, k = 1000, every filter, column-local and
    cross-row joins with excludes) before and after tombstones and with
    a RAM delta, and 8 threads through the batcher; every answer and
    counter equal to the twin's, and the mesh kernels launched."""
    import threading

    from yacy_search_server_tpu_torch.kernels import reset_launches
    store, idx, ths = KBench.mesh_edges([dev] * 4, n_term=2)
    twin, lis = KBench.mesh_twin(store, ["cpu"] * 4)
    idx.listener = lis
    keys = ("prune_rounds", "pruned_tiles", "fallbacks", "queries_served")

    def check(tag):
        for label, fn in KBench.mesh_edge_queries(ths):
            store._topk_cache.clear()
            twin._topk_cache.clear()
            a, b = fn(store), fn(twin)
            assert (a is None) == (b is None), (tag, label)
            if a is not None:
                assert np.array_equal(a[0], b[0]), (tag, label)
                assert np.array_equal(a[1], b[1]), (tag, label)
                assert a[2] == b[2], (tag, label)
        ca, cb = store.counters(), twin.counters()
        assert {k: ca[k] for k in keys} == {k: cb[k] for k in keys}, tag

    reset_launches()
    check("packed")
    assert store.pruned_tiles > 0
    for name in ("pruned_tile", "gather_topk_batch", "span_stats",
                 "span_score_docids", "tie_topk", "join_member",
                 "xjoin_probe", "xjoin_apply", "cardinal_stats",
                 "cardinal_score"):
        assert LAUNCHES[name] > 0, name
    feats, _d, _h, _r = KBench.make_term(5_000, 99)
    idx.add_many(ths["big"], P.PostingsList(
        np.arange(3_000_001, 3_005_001, dtype=np.int32), feats))
    check("delta")
    for d in idx.get(ths["rare"]).docids[::53][:40]:
        idx.delete_doc(int(d))
    check("tombstones")
    idx.flush()
    store.enable_batching()
    twin.enable_batching()
    prof = R.RankingProfile()
    want = {th: twin.rank_term(th, prof, k=10) for th in ths.values()}
    got, errors = {}, []

    def worker(th):
        try:
            got[th] = store.rank_term(th, prof, k=10)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)
    store._topk_cache.enabled = False
    ts = [threading.Thread(target=worker, args=(th,))
          for th in ths.values() for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors
    for th, w in want.items():
        if w is None:
            assert got[th] is None
            continue
        assert np.array_equal(got[th][0], w[0])
        assert np.array_equal(got[th][1], w[1])
    store.close()
    twin.close()


# ---------------------------------------------------------------------------
# K10 rerank_sort (one block a slot, or a cluster of CTAs a slot) and K18's
# probe (a fence table in shared memory, one launch a call)
# ---------------------------------------------------------------------------

def _k10_equal(dev, ns, nb, pad=-(2 ** 31 - 1), edit=None, seed=0):
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    from yacy_search_server_tpu_torch.kernels import k10_k18_bench as KKB
    fin, qi = KKB.rerank_case(np.random.default_rng(seed), ns, nb, pad)
    if edit is not None:
        edit(fin, qi)
    f, q = torch.from_numpy(fin).to(dev), torch.from_numpy(qi).to(dev)
    c0 = LAUNCHES["rerank_sort"]
    got = KDn.rerank_sort(f, q, nb)
    want = KDn.rerank_sort_plain(f.cpu(), q.cpu(), nb)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert LAUNCHES["rerank_sort"] == c0 + 1
    return f, q, want


@pytest.mark.parametrize("nb", [1 << s for s in range(4, 15)])
@pytest.mark.parametrize("bs", [1, 2, 16, 20])
def test_rerank_sort_every_nb_matches_plain(dev, nb, bs):
    ns = [int(x) for x in np.random.default_rng(nb + bs).integers(
        0, nb + 1, bs)]
    ns[0] = nb
    if bs > 1:
        ns[1] = 0
    _k10_equal(dev, ns, nb, seed=nb * bs)


@pytest.mark.parametrize("live", [9000, 16384])
def test_rerank_sort_serving_solo_shape(dev, live):
    """A solo rerank as rerank_boost issues it: 16 slots at nb = 16,384,
    one live, 15 pad slots (copies)."""
    _k10_equal(dev, [live] + [0] * 15, 16384, seed=live)


@pytest.mark.parametrize("nb,nv", [(1024, 511), (1024, 512), (1024, 513),
                                   (1024, 1024), (2048, 1024),
                                   (2048, 1025), (4096, 2049),
                                   (16384, 8192), (16384, 8193)])
def test_rerank_sort_both_sides_of_the_cluster_threshold(dev, nb, nv):
    """nb below 1,024 takes one block a slot, from 1,024 a cluster (2 CTAs
    at 1,024, 4 at 2,048, 16 at 16,384), whose CTAs each take a share of a
    slot's live prefix (one CTA for a prefix that fits in its lanes): slots
    of each size in one call, with pad slots."""
    _k10_equal(dev, [nv, 3, 0, nb], nb, seed=nv)


def _ties_pad(fin, qi):
    # slot 1: a live lane that ties a pad key, finals that wrap
    qi[1, 2] = 2 ** 31 - 1
    fin[1, 0] = -(2 ** 31 - 1)
    fin[1, 1:4] = -(2 ** 31)


def _all_equal(fin, qi):
    nb = fin.shape[1]
    for s in range(fin.shape[0]):
        n = int(qi[s, 0])
        fin[s, :n] = 777
        qi[s, 2:2 + n] = 4242


@pytest.mark.parametrize("nb", [512, 4096, 16384])
@pytest.mark.parametrize("case", ["ties_pad", "all_equal", "pad_final"])
def test_rerank_sort_edge_keys_match_plain(dev, nb, case):
    ns = [nb, nb // 2 + 1, 1, 0]
    if case == "pad_final":
        # pad lanes whose final is not -(2^31-1): the whole slot sorts
        _k10_equal(dev, ns, nb, pad=5, seed=nb)
    else:
        _k10_equal(dev, ns, nb, edit=_ties_pad if case == "ties_pad"
                   else _all_equal, seed=nb + 1)


@pytest.fixture(scope="module")
def xwin():
    """The mesh shape's probe inputs on the card (k10_k18_bench.xjoin_case:
    10M odd docids, 2,001,217 candidates)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yacy_search_server_tpu_torch.kernels import k10_k18_bench as KKB
    d = torch.device("cuda")
    return [torch.from_numpy(a).to(d)
            for a in KKB.xjoin_case(np.random.default_rng(3))]


@pytest.mark.parametrize("cnt", [0, 1, 252, 253, 511, 512, 513, 65_535,
                                 65_536, 65_537, 10_000_000])
def test_xjoin_probe_windows_match_plain(xwin, cnt):
    """Windows staged whole (up to 252 entries), through fence tables
    on both sides of a stride (512 entries: 256 fences of 2; 513: of 4),
    empty, of one entry and the 10M-entry one; the candidates around the
    window (its first and last entries, those just outside), then the mesh
    shape's. Twice: the counters are left at zero."""
    cand, dead, jd, jp, f16, flags = xwin
    lo = 0 if cnt == 10_000_000 else 7
    rng = np.random.default_rng(cnt)
    c = rng.integers(max(0, 2 * lo - 4), 2 * (lo + cnt) + 4,
                     50_000).astype(np.int32)
    if cnt:
        c[:4] = (2 * lo + 1, 2 * (lo + cnt) - 1, 2 * lo - 1, 2 * (lo + cnt) + 1)
    cs = [torch.from_numpy(c).to(jd.device)]
    if cnt == 10_000_000:
        cs.append(cand)
    for ci in cs:
        want = KD.xjoin_probe_plain(ci.cpu(), dead.cpu(), None, 1, jd.cpu(),
                                    jp.cpu(), lo, cnt, f16.cpu(), flags.cpu())
        for _ in range(2):
            p0 = LAUNCHES["xjoin_probe"]
            got = KD.xjoin_probe(ci, dead, None, 1, jd, jp, lo, cnt, f16,
                                 flags)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want)
            assert LAUNCHES["xjoin_probe"] == p0 + 1


@pytest.mark.parametrize("dead_last", [False, True])
def test_xjoin_probe_high_rows_twice(dev, dead_last):
    """Valid candidates at and above 2^29 spread over many blocks against
    a window holding 2^29: only the largest valid row matches, its partner
    read by the last block; the next call (another last row) starts from
    counters at zero."""
    rng = np.random.default_rng(9)
    jd = np.append(2 * np.arange(200_000) + 1, 2 ** 29).astype(np.int32)
    jp = rng.permutation(len(jd)).astype(np.int32)
    f16 = rng.integers(0, 3000, (len(jd), 17), dtype=np.int16)
    fl = rng.integers(0, 2 ** 30, len(jd), dtype=np.int32)
    dead = np.zeros(1_000_000, bool)
    t = [torch.from_numpy(a).to(dev) for a in (jd, jp, f16, fl)]
    for call in range(2):
        c = rng.choice(400_000, 300_000, replace=False).astype(np.int32)
        rows = np.sort(rng.choice(300_000, 40, replace=False))
        c[rows] = 2 ** 29 + rng.integers(0, 2 ** 20, 40)
        if dead_last:
            c[rows[-1]] = -3        # not live: the one before it matches
        prior = np.ones((1, 5, len(c)), np.int32)
        prior[0, 0, rows[-2 - call]] = 0    # failed an earlier include
        cd, pd = torch.from_numpy(c).to(dev), torch.from_numpy(prior).to(dev)
        want = KD.xjoin_probe_plain(cd.cpu(), torch.from_numpy(dead), pd.cpu(),
                                    1, *(x.cpu() for x in t[:2]), 0, len(jd),
                                    t[2].cpu(), t[3].cpu())
        got = KD.xjoin_probe(cd, torch.from_numpy(dead).to(dev), pd, 1,
                             t[0], t[1], 0, len(jd), t[2], t[3])
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        hi = (want[0] == 1) & (cd.cpu() >= 2 ** 29)
        assert int(hi.sum()) == 1
