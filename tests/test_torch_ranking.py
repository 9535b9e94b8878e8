"""PyTorch port of ops/ranking: bit-identical to the JAX package.

The same numpy inputs, made from a seed, go through the JAX functions
(CPU backend) and the port's plain versions (device="cpu"). Cardinal
scores, docids and order must match to the bit; BM25 is f32 summed in
another order and agrees to rtol=1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.ops import ranking as JR
from yacy_search_server_tpu_torch import convert
from yacy_search_server_tpu_torch.index import postings as TP
from yacy_search_server_tpu_torch.ops import ranking as TR

PROFILES = {
    "default": {},
    "authority15": {"authority": 15},
    "language5": {"language": 5},
}


def _profiles(name):
    jp = JR.RankingProfile(**PROFILES[name])
    return jp, convert.profile_from_jax(jp.to_external_string())


def _feats(n, seed, lo=0, hi=500):
    rng = np.random.default_rng(seed)
    feats = rng.integers(lo, hi, (n, JP.NF)).astype(np.int32)
    feats[:, JP.F_FLAGS] = rng.integers(0, 2**30, n)
    feats[:, JP.F_LANGUAGE] = np.where(rng.random(n) < 0.5,
                                       JP.pack_language("en"),
                                       JP.pack_language("de"))
    feats[:, JP.F_DOMLENGTH] = rng.integers(0, 256, n)
    return feats


def _jax_consts(jp, lang="en"):
    bits, shifts = jp.flag_coeffs()
    return (jnp.asarray(jp.norm_coeffs()), jnp.asarray(bits),
            jnp.asarray(shifts), jnp.int32(jp.domlength), jnp.int32(jp.tf),
            jnp.int32(jp.language), jnp.int32(jp.authority),
            jnp.int32(JP.pack_language(lang)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block(n, seed, span0=False, extremes=False, tf_edge=None):
    """int32 feats, valid (some rows invalid), hostids. `tf_edge` puts
    rows whose tf denominator is 0 in: hitcount 0 (tf NaN) or 5 (inf)."""
    rng = np.random.default_rng(seed + 100)
    feats = _feats(n, seed)
    if span0:
        feats[:, JP.F_LASTMOD] = 77
        feats[:, JP.F_URL_LENGTH] = 5
    if extremes:
        ext = rng.choice(np.array([-32768, -32767, -1, 0, 1, 32766, 32767]),
                         (n, JP.NF))
        feats[:, :10] = ext[:, :10]
        feats[:, 12:16] = ext[:, 12:16]
        feats[:, JP.F_HITCOUNT] = rng.integers(0, 256, n)
        feats[:, JP.F_WORDS_IN_TEXT] = rng.integers(0, 32768, n)
        feats[:, JP.F_WORDS_IN_TITLE] = rng.integers(0, 32768, n)
        feats[:, JP.F_LANGUAGE] = JP.pack_language("en")
    if tf_edge is not None:
        feats[::97, JP.F_WORDS_IN_TEXT] = -1
        feats[::97, JP.F_WORDS_IN_TITLE] = 0
        feats[::97, JP.F_HITCOUNT] = tf_edge
    valid = rng.random(n) < 0.9
    hostids = rng.integers(0, 37, n).astype(np.int32)
    return feats, valid, hostids


def _assert_stats_equal(jst, tst):
    tf = TR.stats_fields(tst)
    for key in ("col_min", "col_max", "host_counts"):
        np.testing.assert_array_equal(np.asarray(jst[key]),
                                      tf[key].numpy(), err_msg=key)
    for key in ("tf_min", "tf_max"):
        np.testing.assert_array_equal(np.float32(jst[key]),
                                      np.float32(tf[key].item()), err_msg=key)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("with_hosts", [False, True])
def test_local_stats_bit_identical(compact, with_hosts):
    feats, valid, hostids = _block(3000, seed=1)
    f = JR.compact_feats(feats)[0] if compact else feats
    jst = JR.local_stats(jnp.asarray(f), jnp.asarray(valid),
                         jnp.asarray(hostids), num_hosts=64,
                         with_host_counts=with_hosts)
    tst = TR.local_stats(_t(f), _t(valid), _t(hostids), num_hosts=64,
                         with_host_counts=with_hosts)
    _assert_stats_equal(jst, tst)


@pytest.mark.parametrize("mix", ["uniform", "zipf", "one"])
def test_local_stats_host_mix_bit_identical(mix):
    """The host counts with hosts drawn evenly, Zipf-skewed and all on one
    host (kernels/bench.host_mix, the mixes the card times)."""
    from yacy_search_server_tpu_torch.kernels import bench as KB
    feats, valid, _ = _block(5000, seed=3)
    hostids = KB.host_mix(mix, 5000, np.random.default_rng(4), hosts=1000)
    jst = JR.local_stats(jnp.asarray(feats), jnp.asarray(valid),
                         jnp.asarray(hostids), num_hosts=1000)
    tst = TR.local_stats(_t(feats), _t(valid), _t(hostids), num_hosts=1000)
    _assert_stats_equal(jst, tst)
    top = int(np.bincount(hostids[valid], minlength=1000).max())
    assert int(TR.stats_fields(tst)["host_counts"].max()) == top


def test_local_stats_no_valid_rows_gives_sentinels():
    feats, _, hostids = _block(256, seed=2)
    valid = np.zeros(256, bool)
    jst = JR.local_stats(jnp.asarray(feats), jnp.asarray(valid),
                         jnp.asarray(hostids), num_hosts=8)
    tst = TR.local_stats(_t(feats), _t(valid), _t(hostids), num_hosts=8)
    _assert_stats_equal(jst, tst)


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("case", ["random", "span0", "extremes", "tf_nan",
                                  "tf_inf"])
@pytest.mark.parametrize("compact", [False, True])
def test_cardinal_from_stats_bit_identical(profile, case, compact):
    jp, tp = _profiles(profile)
    edge = {"tf_nan": 0, "tf_inf": 5}.get(case)
    feats, valid, hostids = _block(4000, seed=3, span0=case == "span0",
                                   extremes=case == "extremes", tf_edge=edge)
    n = len(feats)
    if compact:
        f, flags = JR.compact_feats(feats)
    else:
        f, flags = feats, None
    jst = JR.local_stats(jnp.asarray(f), jnp.asarray(valid),
                         jnp.asarray(hostids), num_hosts=n)
    want = JR.cardinal_from_stats(
        jnp.asarray(f), jnp.asarray(valid), jnp.asarray(hostids), jst,
        *_jax_consts(jp), fast_div=compact,
        flags=None if flags is None else jnp.asarray(flags))
    consts = TR.profile_consts(tp, TP.pack_language("en"), "cpu")
    tst = TR.local_stats(_t(f), _t(valid), _t(hostids), num_hosts=n)
    got = TR.cardinal_from_stats(_t(f), _t(valid), _t(hostids), tst, consts,
                                 fast_div=compact,
                                 flags=None if flags is None else _t(flags))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_cardinal_from_stats_int32_edges_bit_identical(profile):
    """The int32 path against column bounds at int32's edges: spans of 0,
    1, 2, 2^31-1 and wrapped ones, and (f - min) * 256 on and beside both
    wrap boundaries (the block the card tests hold the kernel to)."""
    from yacy_search_server_tpu_torch.kernels import bench as KB
    jp, tp = _profiles(profile)
    feats, cmin, cmax = KB.edge_block(4000, seed=5)
    rng = np.random.default_rng(5)
    valid = rng.random(4000) < 0.9
    hostids = rng.integers(0, 37, 4000).astype(np.int32)
    jst = dict(JR.local_stats(jnp.asarray(feats), jnp.asarray(valid),
                              jnp.asarray(hostids), num_hosts=4000))
    jst["col_min"], jst["col_max"] = jnp.asarray(cmin), jnp.asarray(cmax)
    want = JR.cardinal_from_stats(jnp.asarray(feats), jnp.asarray(valid),
                                  jnp.asarray(hostids), jst,
                                  *_jax_consts(jp))
    tst = TR.local_stats(_t(feats), _t(valid), _t(hostids), num_hosts=4000)
    st = tst["stats"].clone()
    st[0:JP.NF], st[JP.NF:2 * JP.NF] = _t(cmin), _t(cmax)
    consts = TR.profile_consts(tp, TP.pack_language("en"), "cpu")
    got = TR.cardinal_from_stats(_t(feats), _t(valid), _t(hostids),
                                 {"stats": st,
                                  "host_counts": tst["host_counts"]}, consts)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_fast_div_equals_floor_div_at_int16_extremes():
    """The compact path's reciprocal division equals floor division over
    every int16 difference against every span."""
    rng = np.random.default_rng(4)
    from yacy_search_server_tpu_torch.kernels import cardinal as KC
    diff = np.concatenate([np.arange(0, 65536, 37), [65535, 65534, 1, 0]])
    span = np.concatenate([rng.integers(1, 65536, 400), [1, 2, 3, 65535]])
    prod = torch.from_numpy(diff.astype(np.int64) * 256)[:, None]
    safe = torch.from_numpy(span.astype(np.int64))[None, :]
    rcp = 1.0 / safe.to(torch.float32)
    q0 = KC.f32_to_i32(prod.to(torch.float32) * rcp)
    r = prod - q0 * safe
    fast = q0 + (r >= safe).long() - (r < 0).long()
    np.testing.assert_array_equal(
        fast.numpy(), torch.div(prod, safe, rounding_mode="floor").numpy())


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_score_topk16_packed_bit_identical(profile):
    jp, tp = _profiles(profile)
    feats, valid, hostids = _block(6000, seed=5)
    docids = np.arange(len(feats), dtype=np.int32) * 3
    # constructed ties: the best row duplicated, so equal scores fill the
    # top-k and only the lowest-index rule orders them
    best = feats[np.argmax(JR.cardinal_scores_host(feats, jp))].copy()
    feats[100:200] = best
    feats[4000:4100] = best
    valid[100:200] = True
    f16, flags = JR.compact_feats(feats)
    auth = jp.authority > 12
    want = JR.score_topk16_packed(
        jnp.asarray(f16), jnp.asarray(flags), jnp.asarray(docids),
        jnp.asarray(valid), jnp.asarray(hostids), *_jax_consts(jp), 64,
        with_authority=auth)
    consts = TR.profile_consts(tp, TP.pack_language("en"), "cpu")
    got = TR.score_topk16_packed(_t(f16), _t(flags), _t(docids), _t(valid),
                                 _t(hostids), consts, 64,
                                 with_authority=auth)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_score_topk_int32_bit_identical():
    jp, tp = _profiles("authority15")
    feats, valid, hostids = _block(2000, seed=6)
    docids = np.arange(len(feats), dtype=np.int32)
    ws, wd, wi = JR.score_topk(jnp.asarray(feats), jnp.asarray(docids),
                               jnp.asarray(valid), jnp.asarray(hostids),
                               *_jax_consts(jp), 40)
    consts = TR.profile_consts(tp, TP.pack_language("en"), "cpu")
    gs, gd, gi = TR.score_topk(_t(feats), _t(docids), _t(valid),
                               _t(hostids), consts, 40)
    for w, g in ((ws, gs), (wd, gd), (wi, gi)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _plist(n, seed, ties=False):
    feats = _feats(n, seed)
    if ties:
        feats[1::3] = feats[np.argmax(JR.cardinal_scores_host(feats,
                                                              JR.RankingProfile()))]
    docids = np.sort(np.random.default_rng(seed).choice(
        10 * n, n, replace=False)).astype(np.int32)
    hosts = [bytes([i % 13, 7]) for i in range(n)]
    return feats, docids, hosts


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("n,k,ties", [
    (300, 10, False),          # host path (n <= SMALL_RANK_N)
    (300, 500, True),          # host path, k > n, ties
    (4097, 10, False),         # just above SMALL_RANK_N: device path
    (9000, 100, True),         # device path with constructed ties
    (4200, 5000, False),       # device path, k > n
])
def test_cardinal_ranker_rank_bit_identical(profile, n, k, ties):
    jp, tp = _profiles(profile)
    feats, docids, hosts = _plist(n, seed=n + k, ties=ties)
    ws, wd = JR.CardinalRanker(jp).rank(JP.PostingsList(docids, feats),
                                        hosts, k=k)
    gs, gd = TR.CardinalRanker(tp, device="cpu").rank(
        TP.PostingsList(docids, feats), hosts, k=k)
    np.testing.assert_array_equal(ws, gs)
    np.testing.assert_array_equal(wd, gd)
    assert len(gs) == min(k, n)


def test_cardinal_ranker_empty():
    s, d = TR.CardinalRanker(device="cpu").rank(TP.PostingsList.empty())
    assert len(s) == 0 and len(d) == 0


def test_host_twins_identical():
    feats = _feats(500, seed=7)
    prof = JR.RankingProfile(authority=15)
    tp = convert.profile_from_jax(prof.to_external_string())
    hostids = np.random.default_rng(7).integers(0, 9, 500).astype(np.int32)
    np.testing.assert_array_equal(
        JR.cardinal_scores_host(feats, prof, "en", hostids),
        TR.cardinal_scores_host(feats, tp, "en", hostids))
    for a, b in zip(JR.compact_feats(feats), TR.compact_feats(feats)):
        np.testing.assert_array_equal(a, b)
    assert TR.pad_to(129) == JR.pad_to(129)
    assert TR.SMALL_RANK_N == JR.SMALL_RANK_N


def test_profile_round_trip():
    jp = JR.RankingProfile.for_contentdom(JR.CD_IMAGE)
    jp.authority, jp.tf = 13, 4
    tp = convert.profile_from_jax(jp.to_external_string())
    assert tp.to_external_string() == jp.to_external_string()
    np.testing.assert_array_equal(tp.norm_coeffs(), jp.norm_coeffs())
    for a, b in zip(tp.flag_coeffs(), jp.flag_coeffs()):
        np.testing.assert_array_equal(a, b)


def test_bm25_topk_matches_jax():
    rng = np.random.default_rng(8)
    n, t, k = 3000, 4, 50
    tf = rng.integers(0, 9, (n, t)).astype(np.float32)
    dl = rng.integers(40, 800, n).astype(np.int32)
    df = rng.integers(1, n, t).astype(np.int32)
    valid = rng.random(n) < 0.95
    docids = np.arange(n, dtype=np.int32)
    ws, wd = JR.bm25_topk(jnp.asarray(tf), jnp.asarray(dl), jnp.asarray(df),
                          jnp.int32(n), jnp.asarray(valid),
                          jnp.asarray(docids), k)
    gs, gd = TR.bm25_topk(_t(tf), _t(dl), _t(df), n, _t(valid), _t(docids), k)
    ws, wd = np.asarray(ws), np.asarray(wd)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=1e-5)
    # docids agree wherever the neighbouring scores are apart by more
    # than the tolerance (inside a near-tie the order may swap)
    gap = np.abs(np.diff(ws)) > 1e-5 * np.abs(ws[1:])
    sep = np.ones(k, bool)
    sep[1:] &= gap
    sep[:-1] &= gap
    np.testing.assert_array_equal(gd.numpy()[sep], wd[sep])


def _jax_bm25_all(tf, dl, df, n, valid):
    """Every row's JAX BM25 score (bm25_topk at k = n, scattered back)."""
    rows = len(dl)
    ws, wd = JR.bm25_topk(jnp.asarray(tf), jnp.asarray(dl), jnp.asarray(df),
                          jnp.int32(n), jnp.asarray(valid),
                          jnp.arange(rows, dtype=jnp.int32), rows)
    out = np.empty(rows, np.float32)
    out[np.asarray(wd)] = np.asarray(ws)
    return out


@pytest.mark.parametrize("t", [1, 4, 8])
@pytest.mark.parametrize("tf_dtype", [np.float32, np.int32])
def test_bm25_pass_plain_matches_jax(t, tf_dtype):
    """K16's plain version (the CPU path of bm25_scores) on every row:
    the JAX pass's scores at rtol 1e-5, -inf on the invalid rows in both,
    int32 tf as f32 tf, ndocs as a number or an int32 tensor."""
    rng = np.random.default_rng(30 + t)
    n = 5000
    tf = rng.integers(0, 9, (n, t)).astype(tf_dtype)
    dl = rng.integers(40, 800, n).astype(np.int32)
    df = rng.integers(1, n, t).astype(np.int32)
    valid = rng.random(n) < 0.9
    want = _jax_bm25_all(tf, dl, df, n, valid)
    for nd in (n, torch.tensor(n, dtype=torch.int32)):
        got = TR.bm25_scores(_t(tf), _t(dl), _t(df), nd, _t(valid)).numpy()
        assert np.array_equal(np.isinf(got), ~valid)
        assert np.array_equal(np.isinf(want), ~valid)
        np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5)
        assert np.array_equal(got, TR.bm25_scores_plain(
            _t(tf), _t(dl), _t(df), nd, _t(valid)).numpy())
    # the float64 oracle averages doclen over every row: all rows valid
    every = TR.bm25_scores(_t(tf), _t(dl), _t(df), n,
                           torch.ones(n, dtype=torch.bool)).numpy()
    np.testing.assert_allclose(every, TR.bm25_scores_np(tf, dl, df, n),
                               rtol=1e-5)


def test_bm25_topk_numpy_needs_a_device():
    rng = np.random.default_rng(9)
    tf = rng.integers(0, 9, (100, 3)).astype(np.float32)
    args = (tf, rng.integers(40, 800, 100).astype(np.int32),
            np.array([3, 7, 50], np.int32), 100, np.ones(100, bool),
            np.arange(100, dtype=np.int32))
    s, d = TR.bm25_topk(*args, 10, device="cpu")
    ts, td = TR.bm25_topk(*(_t(a) if isinstance(a, np.ndarray) else a
                            for a in args), 10)
    assert torch.equal(s, ts) and torch.equal(d, td)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TR.bm25_topk(*args, 10)
