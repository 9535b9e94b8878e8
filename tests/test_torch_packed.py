"""The port's bit-packed block format and its kernels' plain versions
against the JAX package's, on the CPU.

- ops/packed: `pack_block` word for word (words, offsets, widths, minima)
  and `unpack_block` over tests/test_packed_blocks.py's adversarial
  ranges (all-equal columns, the full int16 range, negatives, 30-bit
  flags, 32-bit docid spreads) at n = 0, 1, 31, 32, 33, TILE - 1 and
  TILE + 1; `unpack_rows_plain` against `unpack_rows_dev` at a nonzero
  word base and row, rows past the count and a block whose last straddle
  reads the store's final word; `bp_topk_oracle`.
- kernels/packed: K13's plain version and ingest/devbuild.pack_block_batch
  against `_pack_block_batch_kernel` / `pack_block_batch` (ragged lanes,
  an empty lane, the host/device routing at 63/64 and 2^18/2^18 + 1
  rows); K5bp's against `_rank_pruned_batch1_bp_kernel` on a JAX packed
  store's own words, raw (the garbage docids of rows past a span
  included); the packed scan (K6bp, K7bp, kernel 3, topk_finish_bp)
  against `_rank_scan_batch_bp_kernel` wherever a score is live.
No tolerance: every output is an integer, equal to the bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from yacy_search_server_tpu.index import devstore as JD
from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.index.rwi import RWIIndex as JRWI
from yacy_search_server_tpu.ingest import devbuild as JB
from yacy_search_server_tpu.ops import packed as JPK
from yacy_search_server_tpu.ops.ranking import RankingProfile as JProf
from yacy_search_server_tpu_torch import convert
from yacy_search_server_tpu_torch.index import devstore as TD
from yacy_search_server_tpu_torch.ingest import devbuild as TB
from yacy_search_server_tpu_torch.kernels import bench as KB
from yacy_search_server_tpu_torch.kernels import devstore as KD
from yacy_search_server_tpu_torch.kernels import packed as KP
from yacy_search_server_tpu_torch.kernels.topk import tie_topk_plain
from yacy_search_server_tpu_torch.ops import packed as TPK
from yacy_search_server_tpu_torch.ops import ranking as TR

TILE = KD.TILE
SIZES = [0, 1, 31, 32, 33, TILE - 1, TILE + 1]
CASES = ("random", "all_equal", "full_int16", "negatives", "flags30",
         "docid32")


def _block(case, n, seed=0):
    """(feats16, flags, docids) of one adversarial range."""
    rng = np.random.default_rng(seed)
    f16 = rng.integers(0, 1000, (n, JP.NF)).astype(np.int16)
    fl = rng.integers(0, 2 ** 20, n).astype(np.int32)
    dd = np.sort(rng.choice(10 * n + 10, n, replace=False)).astype(np.int32)
    if case == "all_equal":
        f16[:] = 77
        fl[:] = 5
        dd[:] = 123
    elif case == "full_int16":
        f16 = rng.integers(-32768, 32768, (n, JP.NF)).astype(np.int16)
        if n >= 2:
            f16[0], f16[1] = -32768, 32767
    elif case == "negatives":
        f16 = rng.integers(-500, -1, (n, JP.NF)).astype(np.int16)
        fl = rng.integers(-2 ** 31, -1, n, dtype=np.int64).astype(np.int32)
    elif case == "flags30":
        fl = rng.integers(0, 2 ** 30, n).astype(np.int32)
        if n >= 2:
            fl[0], fl[1] = 0, 2 ** 30 - 1
    elif case == "docid32":
        dd = rng.integers(-2 ** 31, 2 ** 31 - 1, n,
                          dtype=np.int64).astype(np.int32)
        if n >= 2:
            dd[0], dd[1] = -2 ** 31, 2 ** 31 - 1
    return f16, fl, dd


def _same_block(got, want):
    assert got.count == want.count
    for name in ("words", "word_offs", "widths", "mins"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_pack_block_matches_jax(case, n):
    f16, fl, dd = _block(case, n)
    got = TPK.pack_block(f16, fl, dd)
    _same_block(got, JPK.pack_block(f16, fl, dd))
    for a, b in zip(TPK.unpack_block(got), (f16, fl, dd)):
        np.testing.assert_array_equal(a, b)
    assert got.row_bits == JPK.pack_block(f16, fl, dd).row_bits
    assert got.int16_bytes == n * 42


@pytest.mark.parametrize("case", ["random", "full_int16", "docid32"])
def test_unpack_block_matches_jax(case):
    blk = TPK.pack_block(*_block(case, 5_000, seed=3))
    jblk = JPK.PackedBlock(blk.words, blk.count, blk.word_offs, blk.widths,
                           blk.mins)
    for a, b in zip(TPK.unpack_block(blk), JPK.unpack_block(jblk)):
        np.testing.assert_array_equal(a, b)


# word base, first row, rows (past the count where row0 + rows > n)
DECODES = {"base0": (0, 0, None), "base_row": (7, 5, None),
           "past_count": (7, 100, 2_000), "last_word": ("end", 0, None)}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("where", list(DECODES))
def test_unpack_rows_plain_matches_jax(case, where):
    """The plain decode and K12's wrapper on the CPU against
    unpack_rows_dev over a store of two blocks: the first at word `base`
    (or ending at the store's last word), rows from `row0`."""
    n = 1_500
    blk = TPK.pack_block(*_block(case, n, seed=5))
    other = TPK.pack_block(*_block("random", 300, seed=6)).words
    base, row0, rows = DECODES[where]
    if base == "end":
        store = np.concatenate([other, blk.words])
        base = len(other)
    else:
        store = np.concatenate([other[:base], blk.words, other])
    rows = n - row0 if rows is None else rows
    meta = blk.meta_vector()
    want = JPK.unpack_rows_dev(JPK.bitcast_words(jnp.asarray(store)),
                               jnp.int32(base), jnp.asarray(meta),
                               jnp.int32(row0), rows)
    tw = torch.from_numpy(store)
    for got in (TPK.unpack_rows_plain(tw, base, meta, row0, rows),
                KP.unpack_rows(tw, base, meta, row0, rows)):
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _lanes(sizes, seed):
    """Blocks of the given row counts (the last column ranges of each
    adversarial case in turn) and their padded lanes at `rows`."""
    parts = [_block(CASES[i % len(CASES)], m, seed=seed + i)
             for i, m in enumerate(sizes)]
    rows = JB.rows_bucket(max(sizes))
    b = len(sizes)
    f16 = np.zeros((b, rows, JP.NF), np.int16)
    fl = np.zeros((b, rows), np.int32)
    dd = np.zeros((b, rows), np.int32)
    n = np.asarray(sizes, np.int32)
    for j, (bf, bl, bd) in enumerate(parts):
        f16[j, :len(bd)], fl[j, :len(bd)], dd[j, :len(bd)] = bf, bl, bd
    return parts, rows, f16, fl, dd, n


@pytest.mark.parametrize("sizes", [[300], [1, 0, 64, 257, 1000, 999],
                                   [2048, 33, 2047, 700]])
def test_pack_block_batch_plain_matches_jax(sizes):
    """K13's plain version against _pack_block_batch_kernel (ragged
    lanes, an empty one), and each lane against the host pack."""
    parts, rows, f16, fl, dd, n = _lanes(sizes, 11)
    jw, jm, jt = (np.asarray(a) for a in JB._pack_block_batch_kernel(
        f16, fl, dd, n, rows=rows))
    t = torch.from_numpy
    tw, tm, tt = KP.pack_block_batch(t(f16), t(fl), t(dd), t(n))
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(tt.numpy(), jt)
    for j, part in enumerate(parts):
        blk = TPK.pack_block(*part)
        np.testing.assert_array_equal(tw.numpy()[j, :tt[j]], blk.words)
        np.testing.assert_array_equal(tm.numpy()[j], blk.meta_vector())
        assert not tw.numpy()[j, tt[j]:].any()


def test_pack_block_batch_rejects_bad_lanes():
    z = torch.zeros
    with pytest.raises(ValueError):
        KP.pack_block_batch(z((2, 8, 17), dtype=torch.int16),
                            z((2, 8), dtype=torch.int32),
                            z((2, 8), dtype=torch.int32),
                            torch.tensor([3, 9], dtype=torch.int32))


@pytest.mark.parametrize("sizes,on_device", [
    ([63, 64], [False, True]),
    ([2 ** 18, 2 ** 18 + 1], [True, False]),
    ([5, 100, 3000, 100, 70_000], [False, True, True, True, True])])
def test_devbuild_routing_matches_jax(monkeypatch, sizes, on_device):
    """devbuild.pack_block_batch: blocks of [64, 2^18] rows through K13
    (the plain version here), the rest on the host pack, every block the
    JAX build's and the host pack's, in input order."""
    parts = [_block(CASES[i % len(CASES)], m, seed=20 + i)
             for i, m in enumerate(sizes)]
    lanes = []
    real = KP.pack_block_batch

    def spy(f16, fl, dd, n):
        lanes.extend(int(x) for x in n)
        return real(f16, fl, dd, n)
    monkeypatch.setattr(KP, "pack_block_batch", spy)
    got = TB.pack_block_batch(parts, "cpu")
    want = JB.pack_block_batch(parts)
    assert sorted(lanes) == sorted(m for m, d in zip(sizes, on_device) if d)
    for g, w, part in zip(got, want, parts):
        _same_block(g, w)
        _same_block(g, TPK.pack_block(*part))


@pytest.mark.parametrize("kw", [{}, {"lang_filter": JP.pack_language("de")},
                                {"flag_bit": 3, "from_days": 100},
                                {"to_days": 400}, {"stats": True}])
def test_bp_topk_oracle_matches_jax(kw):
    f = KB.make_term(3_000, 9)[0]
    f16, fl = TR.compact_feats(f)
    dd = np.arange(3_000, dtype=np.int32) * 3
    blk = TPK.pack_block(f16, fl, dd)
    jblk = JPK.PackedBlock(blk.words, blk.count, blk.word_offs, blk.widths,
                           blk.mins)
    kw = dict(kw)
    if kw.pop("stats", False):
        kw["stats"] = TR.pack_stats_host(f16, fl)
    prof = JProf(domlength=8)
    got = TPK.bp_topk_oracle(blk, TR.RankingProfile(domlength=8), "en", 50,
                             **kw)
    want = JPK.bp_topk_oracle(jblk, prof, "en", 50, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert set(TPK.BP_ORACLES) == set(JPK.BP_ORACLES)


# -- the scorers' plain versions on a JAX packed store's words ---------------

NAMES = [b"bpbigAAAAAAA", b"bpmidAAAAAAA", b"bpsmallAAAAA", b"bpdeadAAAAAA"]


@pytest.fixture(scope="module")
def pstore():
    """A JAX packed store and the port's over one RWI: terms of 70,000,
    33,000 and 900 rows of kernels/bench.make_term (its repeated best row
    makes ties) and one of 5,000 whose docids are tombstoned in part."""
    idx = JRWI()
    j = JD.DeviceSegmentStore(idx, packed_residency=True)
    t = TD.DeviceSegmentStore(idx, device="cpu", packed_residency=True)
    idx.listener = KB.Fanout(j, t)
    run = {}
    for i, (th, n) in enumerate(zip(NAMES, (70_000, 33_000, 900, 5_000))):
        f, d, _h, _r = KB.make_term(n, 40 + i)
        run[th] = JP.PostingsList(d + 3 * i, f)
    idx.ingest_run(run)
    for d in run[NAMES[3]].docids[::3][:200]:
        idx.delete_doc(int(d))
    return idx, j, t


def test_packed_words_store_equals_jax(pstore):
    _idx, j, t = pstore
    used = j.arena._pw_used
    assert t.arena._pw_used == used and t.arena._pw_cap == j.arena._pw_cap
    np.testing.assert_array_equal(t.arena.packed_array().numpy()[:used],
                                  np.asarray(j.arena.packed_array())[:used])
    for th in NAMES:
        a, b = t.spans_for(th)[0], j.spans_for(th)[0]
        assert (a.start, a.pbase, a.count, a.tstart, a.tcount, a.jstart,
                a.row_bits) == (b.start, b.pbase, b.count, b.tstart,
                                b.tcount, b.jstart, b.row_bits)
        np.testing.assert_array_equal(a.pmeta, b.pmeta)


def _tconsts(prof, lang="en"):
    return TR.profile_consts(convert.profile_from_jax(
        prof.to_external_string()), JP.pack_language(lang), "cpu")


@pytest.fixture(scope="module")
def pstore_tile_edges():
    """A JAX packed store and the port's over kernels/bench.TILE_EDGE_TERMS
    (bench.tile_edges: a span shorter than every kk, one of exactly one
    tile, one all dead, one of equal scores live across places
    2,047/2,048 and 4,095/4,096)."""
    port = {}

    def make(idx):
        j = JD.DeviceSegmentStore(idx, packed_residency=True)
        port["t"] = TD.DeviceSegmentStore(idx, device="cpu",
                                          packed_residency=True)
        idx.listener = KB.Fanout(j, port["t"])
        return j
    idx = JRWI()
    j = KB.tile_edges(idx, make, plist=JP.PostingsList)
    return idx, j, port["t"]


@pytest.mark.parametrize("kk", [16, 128, 1024, 2048])
@pytest.mark.parametrize("names", [NAMES[:1], NAMES, NAMES[2:3] * 3,
                                   list(KB.TILE_EDGE_TERMS)])
@pytest.mark.parametrize("prof", [JProf(), JProf(domlength=15, tf=13)],
                         ids=["default", "bound_fails"])
def test_pruned_tile_bp_matches_jax(request, pstore, names, kk, prof):
    """K5bp's plain version against _rank_pruned_batch1_bp_kernel, raw:
    rows past a span's count decode the same garbage docids; the tile
    edges (names3) in one descriptor."""
    _idx, j, t = pstore
    if names[0] in KB.TILE_EDGE_TERMS:
        _idx, j, t = request.getfixturevalue("pstore_tile_edges")
    sps = [j.spans_for(th)[0] for th in names]
    shift, lang = JD.prune_bound_consts(prof)
    bs = len(sps)
    col = lambda f: np.asarray([f(sp) for sp in sps])  # noqa: E731
    qiq, nbs = JD._pack_batch1_bp(
        col(lambda sp: sp.pbase).astype(np.int32),
        col(lambda sp: sp.count).astype(np.int32),
        col(lambda sp: sp.tstart).astype(np.int32),
        col(lambda sp: sp.tcount).astype(np.int32),
        np.stack([sp.pmeta for sp in sps]),
        np.stack([sp.stats["col_min"] for sp in sps]),
        np.stack([sp.stats["col_max"] for sp in sps]),
        col(lambda sp: sp.stats["tf_min"]).astype(np.float32),
        col(lambda sp: sp.stats["tf_max"]).astype(np.float32), shift, lang)
    want = np.asarray(JD._rank_pruned_batch1_bp_kernel(
        j.arena.packed_array(), j.arena.dead_array(), j.arena._pmax, qiq,
        *j._profile_consts(prof, "en"), k=kk,
        maxt=JD._pmax_window(j._max_tcount), bs=nbs))
    desc = KP.pack_desc_bp(
        [(sp.pbase, sp.count, sp.tstart, sp.tcount, sp.stats["col_min"],
          sp.stats["col_max"], sp.stats["tf_min"], sp.stats["tf_max"])
         for sp in sps], [sp.pmeta for sp in sps], int(shift), int(lang))
    assert KP.desc_slots_bp(desc) == bs
    got = KP.pruned_tile_bp(t.arena.packed_array(), t.arena.dead_array(),
                            t.arena._pmax, desc, kk, _tconsts(prof))
    np.testing.assert_array_equal(got.numpy(), want)
    # the store's solo route over the first span: the same row
    one = TD.pruned_query_bp(t.arena.packed_array(), t.arena.dead_array(),
                             t.arena._pmax, t.spans_for(names[0])[0], shift,
                             lang, _tconsts(prof), kk)
    np.testing.assert_array_equal(one.numpy(), want[0])


FILTERS = {"none": KD.NO_FILTER, "lang": (JP.pack_language("de"), -1,
                                          KD.DAYS_NONE_LO, KD.DAYS_NONE_HI),
           "flag_days": (0, 5, 8_000, 20_000), "nothing": (0x7777, -1,
                                                          KD.DAYS_NONE_LO,
                                                          KD.DAYS_NONE_HI)}


@pytest.mark.parametrize("kk", [16, 1024, 4096])
@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("name", NAMES)
def test_scan_bp_matches_jax(pstore, name, filt, kk):
    """The packed scan (K6bp, K7bp, kernel 3, topk_finish_bp) against
    _rank_scan_batch_bp_kernel: equal where a score is live, and the
    same live places; K6bp's statistics against K6's on the int16 rows
    the block decodes to."""
    _idx, j, t = pstore
    sp = j.spans_for(name)[0]
    q = FILTERS[filt]
    qi = np.zeros((1, 6 + JPK.META_LEN), np.int32)
    qi[0, 0], qi[0, 1] = sp.pbase, sp.count
    qi[0, 2:2 + JPK.META_LEN] = sp.pmeta
    qi[0, 2 + JPK.META_LEN:] = q
    prof = JProf()
    want = np.asarray(JD._rank_scan_batch_bp_kernel(
        j.arena.packed_array(), j.arena.dead_array(), qi,
        *j._profile_consts(prof, "en"), k=kk, bs=1))[0]
    tsp = t.spans_for(name)[0]
    words, dead = t.arena.packed_array(), t.arena.dead_array()
    got = TD.scan_query_bp(words, dead, tsp, _tconsts(prof), kk, q).numpy()
    live = want[:kk] > KD.INT32_MAX * -1
    np.testing.assert_array_equal(got[:kk] > -KD.INT32_MAX, live)
    np.testing.assert_array_equal(got[:kk][live], want[:kk][live])
    np.testing.assert_array_equal(got[kk:][live], want[kk:][live])
    assert (got[kk:][~live] == -1).all()
    # K6bp against K6 over the decoded rows as an int16 extent
    f, fl, d = KP.unpack_rows(words, tsp.pbase, tsp.pmeta, 0, tsp.count)
    st = KP.span_stats_bp(words, dead, tsp.pbase, tsp.pmeta, tsp.count, q)
    want_st = KD.span_stats(f.to(torch.int16), d, dead, [(0, tsp.count)],
                            flags=fl, filt=q)
    np.testing.assert_array_equal(st.numpy(), want_st.numpy())


def test_topk_finish_bp_tail_matches_topk_finish(pstore):
    """The packed finish with a tail check against topk_finish over the
    decoded rows: the same docids, scores and ok."""
    _idx, _j, t = pstore
    sp = t.spans_for(NAMES[0])[0]
    words, dead, pmax = (t.arena.packed_array(), t.arena.dead_array(),
                         t.arena._pmax)
    stats = torch.from_numpy(sp.stats38())
    consts = _tconsts(JProf())
    buf = KP.span_score_bp(words, dead, sp.pbase, sp.pmeta, TILE, stats,
                           consts, TILE)
    top_s, top_rows, _ = tie_topk_plain(buf, 64)
    shift, lang = (int(x) for x in JD.prune_bound_consts(JProf()))
    got = KP.topk_finish_bp(top_s, top_rows, words, sp.pbase, sp.pmeta, TILE,
                            pmax=pmax, tail=(sp.tstart, sp.tcount, shift,
                                             lang))
    f, fl, d = KP.unpack_rows(words, sp.pbase, sp.pmeta, 0, TILE)
    want = KD.topk_finish(top_s, top_rows, d, [(0, TILE)], pmax=pmax,
                          tail=(sp.tstart, 1, sp.tcount, shift, lang))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# -- the packed scan at the edges of K7bp's tiles and selection --------------

# (case, rows): counts about a 32-row group and a 1,024-row tile, one below
# every kk, every row dead, every row equal (equal scores at every place)
SCAN_BLOCKS = [("rows", 1), ("rows", 31), ("rows", 33), ("rows", 1023),
               ("rows", 1025), ("dead", 1000), ("equal", 3000),
               ("rows", 5000)]
SCAN_FILTERS = {"none": KD.NO_FILTER,
                "smoke": (JP.pack_language("en"), 5, 3_000, 27_000)}


def _scan_block(case, n, seed):
    """(feats16, flags, docids) of make_term's rows with flags over all of
    int32 (a column of width 32), a constant column (width 1) and odd
    docids; "dead": docids the tombstone bitmap holds; "equal": every row
    the first."""
    feats, _d, _h, rng = KB.make_term(n, seed)
    f16, _fl = TR.compact_feats(feats)
    f16[:, JP.F_WORDS_IN_TITLE] = 3
    fl = rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64).astype(
        np.int32)
    fl[:2] = (-2 ** 31, 2 ** 31 - 1)[:n]
    dd = (1 + 2 * np.arange(n)).astype(np.int32)
    if case == "dead":
        dd = (3 * np.arange(n)).astype(np.int32)
    elif case == "equal":
        f16[:] = f16[0]
        fl[:] = fl[0]
    return f16, fl, dd


@pytest.fixture(scope="module")
def scan_store():
    """The SCAN_BLOCKS packed into one words store, block i at a word base
    of residue i mod 4 (garbage words between), the last ending on the
    store's last word; a tombstone bitmap over every third docid. Returns
    (words, dead, [(wbase, block)])."""
    parts, blocks, at = [], [], 0
    for i, (case, n) in enumerate(SCAN_BLOCKS):
        pad = (i - at) % 4 + 4
        parts.append(np.full(pad, -0x5A5A5A5B, np.int32))
        at += pad
        blk = TPK.pack_block(*_scan_block(case, n, 90 + i))
        blocks.append((at, blk))
        parts.append(blk.words)
        at += len(blk.words)
    dead = np.zeros(20_000, bool)
    dead[::3] = True
    return np.concatenate(parts), dead, blocks


def _width0(meta):
    """The meta vector with the constant column read at width 0 (its value
    is the minimum, the same rows)."""
    m = np.array(meta, np.int32)
    assert m[JPK.NCOLS + JP.F_WORDS_IN_TITLE] == 1
    m[JPK.NCOLS + JP.F_WORDS_IN_TITLE] = 0
    return m


def _case(block):
    return "rows" if block == "width0" else SCAN_BLOCKS[block][0]


@pytest.mark.parametrize("filt", list(SCAN_FILTERS))
@pytest.mark.parametrize("kk", [16, 128, 2048, 2049])
@pytest.mark.parametrize("block", list(range(len(SCAN_BLOCKS)))
                         + ["width0"])
def test_scan_bp_edges_match_jax(scan_store, block, kk, filt):
    """scan_query_bp (K6bp and span_topk_bp's plain versions at kk <=
    2048, the buffer route past it) and span_topk_bp_plain against
    _rank_scan_batch_bp_kernel: equal where a score is live, the same
    live places, (-(2^31-1), -1) past them; span_topk_bp refuses kk
    2049."""
    words, dead, blocks = scan_store
    wbase, blk = blocks[-1 if block == "width0" else block]
    meta = blk.meta_vector()
    if block == "width0":
        meta = _width0(meta)
    q = SCAN_FILTERS[filt]
    qi = np.zeros((1, 6 + JPK.META_LEN), np.int32)
    qi[0, 0], qi[0, 1] = wbase, blk.count
    qi[0, 2:2 + JPK.META_LEN] = meta
    qi[0, 2 + JPK.META_LEN:] = q
    prof = JProf()
    jconsts = (*(jnp.asarray(a) for a in (prof.norm_coeffs(),
                                          *prof.flag_coeffs())),
               *(jnp.int32(v) for v in (prof.domlength, prof.tf,
                                        prof.language, prof.authority,
                                        JP.pack_language("en"))))
    want = np.asarray(JD._rank_scan_batch_bp_kernel(
        jnp.asarray(words), jnp.asarray(dead), qi, *jconsts, k=kk,
        bs=1))[0]
    tw, td = torch.from_numpy(words), torch.from_numpy(dead)
    sp = TD.Span(start=0, count=blk.count, tstart=0, tcount=0, stats={},
                 jstart=0, pbase=wbase, pmeta=meta, row_bits=blk.row_bits)
    consts = _tconsts(prof)
    got = TD.scan_query_bp(tw, td, sp, consts, kk, q).numpy()
    live = want[:kk] > -KD.INT32_MAX
    np.testing.assert_array_equal(got[:kk] > -KD.INT32_MAX, live)
    np.testing.assert_array_equal(got[:kk][live], want[:kk][live])
    np.testing.assert_array_equal(got[kk:][live], want[kk:][live])
    assert (got[kk:][~live] == -1).all()
    if _case(block) == "dead":
        assert not live.any()
    st = KP.span_stats_bp(tw, td, wbase, meta, blk.count, q)
    if kk <= KD.FUSED_KK:
        plain = KP.span_topk_bp_plain(tw, td, wbase, meta, blk.count, st,
                                      consts, kk, q)
        np.testing.assert_array_equal(plain.numpy(), got)
    else:
        with pytest.raises(ValueError):
            KP.span_topk_bp(tw, td, wbase, meta, blk.count, st, consts, kk,
                            q)
