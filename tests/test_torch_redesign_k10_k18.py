"""The properties K10 (`rerank_sort`) and K18's probe (`xjoin_probe`)
rest on, held against the JAX package on the CPU.

K10 sorts only a slot's live prefix: a pad lane (at or past n_valid)
carries final -(2^31-1) and docid INT32_MAX, the largest key there is, so
the stable sort of nb lanes is the sort of lanes [0, m) (m the power of
two at least n_valid) followed by the pad lanes in lane order. A slot
of 1,024 lanes and more is sorted by a thread-block cluster: runs
merged pairwise, each CTA writing its share of the merged run found by a
merge-path split. The plain version, the prefix rule and a numpy replay
of the cluster's rounds (kernels/csrc/dense.cu's layout) must all equal
JAX's `_rerank_fwd_batch_packed_kernel` at nb = 4,096 and 16,384: slots
of n_valid 0, 1, nb/2 + 1 and nb, a live lane that ties a pad key,
finals of INT32_MIN (the negation wraps), every live lane equal. With
alpha 0 no lane is boosted (every lane's final is its sparse score), so
the finals are the test's own.

K18's probe is held to the JAX membership test it replaces
(`devstore._membership_sorted`, as `meshstore._mesh_xjoin_shard` calls
it) on its raw outputs, and a cross-row join of the mesh stores (the JAX
MeshSegmentStore on 8 virtual CPU devices, the port's on 8 CPU cells)
must answer alike: several valid candidates at or above 2^29 of which
only the last can match the window's 2^29, a window of one entry,
candidates equal to a window's first and last entries and to the entries
just outside it. (A span never holds a docid twice, so the candidates
are distinct: only the clip to 2^29 makes two keys equal.)
"""

import jax
import numpy as np
import pytest
import torch

from yacy_search_server_tpu.index import devstore as JDS
from yacy_search_server_tpu.index import meshstore as JMS
from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.index.rwi import RWIIndex as JRWI
from yacy_search_server_tpu.ops import dense as JD
from yacy_search_server_tpu.ops.ranking import RankingProfile as JProf
from yacy_search_server_tpu.utils.hashes import word2hash
from yacy_search_server_tpu_torch.index import meshstore as TMS
from yacy_search_server_tpu_torch.kernels import bench as KB
from yacy_search_server_tpu_torch.kernels import dense as KDn
from yacy_search_server_tpu_torch.kernels import devstore as KD
from yacy_search_server_tpu_torch.ops import ranking as TR

DIM = 256
NEG = -(2 ** 31 - 1)
IMAX = 2 ** 31 - 1
CAP = 2 ** 29


# -- K10 ----------------------------------------------------------------------

def _k10_wave(nb, case, seed):
    """Descriptors of four slots (alpha 0, docids past a 16-row forward
    index) and the finals the test wants: n_valid 0, 1, nb/2 + 1, nb."""
    rng = np.random.default_rng(seed)
    ns = [0, 1, nb // 2 + 1, nb]
    qi = np.zeros((len(ns), 2 + 2 * nb + DIM), np.int32)
    for i, n in enumerate(ns):
        qi[i, 0] = n
        qi[i, 2:2 + nb] = rng.integers(0, 1 << 20, nb)   # pad lanes too
        d = 100 + rng.choice(1 << 28, n, replace=False)
        s = rng.integers(-(2 ** 31), IMAX, n, dtype=np.int64)
        s[:n // 3] = s[0] if n else 0
        if case == "all_equal":
            d[:] = 12345
            s[:] = 777
        elif case == "int_min" and n:
            s[::3] = -(2 ** 31)
        elif case == "ties_pad" and n:
            d[n // 2] = IMAX      # final -(2^31-1), docid INT32_MAX: a pad key
            s[n // 2] = NEG
            s[-1] = NEG
        qi[i, 2:2 + n] = d
        qi[i, 2 + nb:2 + nb + n] = s.astype(np.int32)
    return qi


def _keys(final, qi, nb):
    """K10's 64-bit keys (the score half the wrapping negation, the docid
    half docid ^ 0x80000000, INT32_MAX past n_valid) as numpy uint64."""
    valid = np.arange(nb)[None, :] < qi[:, :1]
    neg = (-final.astype(np.int64)) & 0xFFFFFFFF
    hi = neg ^ 0x80000000
    d = np.where(valid, qi[:, 2:2 + nb], IMAX).astype(np.int64) & 0xFFFFFFFF
    return (hi.astype(np.uint64) << np.uint64(32)) | (
        d ^ 0x80000000).astype(np.uint64)


def _corank(a, b, t):
    """The merge-path split of diagonal t of runs a, b (lists of unique
    (key, lane) pairs): how many of the merged run's first t come from a
    (dense.cu:rs_split's answer)."""
    lo, hi = max(0, t - len(b)), min(t, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] < b[t - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _k10_replay(keys, nv, nb):
    """One slot as rerank_sort_k lays it out: the pad check, the prefix m,
    the CTAs a slot (RS_CHUNK 512 lanes a CTA from RS_CLUSTER_NB 1024, up
    to 16), each active CTA's run sorted, then the pairwise rounds where CTA r
    merges the places [t0, t0 + k) of its pair's run between its two
    splits. Returns the lane order."""
    pad_ok = all(keys[i] == np.uint64(2 ** 64 - 1) for i in range(nv, nb))
    m = nb if not pad_ok else (0 if nv == 0 else 1 << (nv - 1).bit_length())
    ctas = 1 if nb < 1024 else min(16, nb // 512)
    kc = nb // ctas
    if m == 0:
        return list(range(nb))
    k = min(m, kc)
    A = m // k
    runs = [sorted((int(keys[i]), i) for i in range(r * k, r * k + k))
            for r in range(A)]
    half = 1
    while half < A:
        new = []
        for r in range(A):
            g = r & ~(2 * half - 1)
            a = sum(runs[g:g + half], [])
            b = sum(runs[g + half:g + 2 * half], [])
            t0 = (r - g) * k
            i0, i1 = _corank(a, b, t0), _corank(a, b, t0 + k)
            new.append(sorted(a[i0:i1] + b[t0 - i0:t0 + k - i1]))
        runs = new
        half *= 2
    return [lane for _k, lane in sum(runs, [])] + list(range(m, nb))


@pytest.mark.parametrize("nb", [4096, 16384])
@pytest.mark.parametrize("case", ["plain", "ties_pad", "int_min",
                                  "all_equal"])
def test_rerank_sort_prefix_and_merge_match_jax(nb, case):
    qi = _k10_wave(nb, case, seed=nb + len(case))
    fwd = np.zeros((16, DIM), np.float16)
    want = np.asarray(JD._rerank_fwd_batch_packed_kernel(
        jax.device_put(fwd), qi, nb=nb, bs=qi.shape[0]))
    qd = torch.from_numpy(qi)
    final = KDn.dense_gather_boost_plain(torch.from_numpy(fwd), qd, nb)
    fin = final.numpy()
    assert (fin[np.arange(nb)[None, :] >= qi[:, :1]] == NEG).all()
    got = KDn.rerank_sort_plain(final, qd, nb).numpy()
    assert np.array_equal(got, want)
    keys = _keys(fin, qi, nb)
    for s in range(qi.shape[0]):
        order = _k10_replay(keys[s], int(qi[s, 0]), nb)
        replay = np.concatenate([fin[s, order], qi[s, 2:2 + nb][order]])
        assert np.array_equal(replay, want[s]), s
        # the pad lanes come out last, in lane order, as they were
        nv = int(qi[s, 0])
        assert np.array_equal(want[s, nb + nv:], qi[s, 2 + nv:2 + nb])


def test_rerank_sort_pad_lane_with_another_final_sorts_the_slot():
    """A pad lane whose final is not -(2^31-1) (not what K9 writes, but
    the wrapper takes any finals) breaks the prefix rule: the replay then
    sorts the whole slot, as the plain version does."""
    nb = 4096
    qi = _k10_wave(nb, "plain", seed=3)
    fin = np.full((qi.shape[0], nb), NEG, np.int32)
    for s in range(qi.shape[0]):
        fin[s, :qi[s, 0]] = qi[s, 2 + nb:2 + nb + qi[s, 0]]
    fin[2, nb - 1] = 5                      # a pad lane of slot 2
    got = KDn.rerank_sort_plain(torch.from_numpy(fin), torch.from_numpy(qi),
                                nb).numpy()
    keys = _keys(fin, qi, nb)
    for s in range(qi.shape[0]):
        order = _k10_replay(keys[s], int(qi[s, 0]), nb)
        assert np.array_equal(
            np.concatenate([fin[s, order], qi[s, 2:2 + nb][order]]), got[s])
    assert got[2, nb - 1] != 5 or got[2, 2 * nb - 1] != qi[2, 2 + nb - 1]


# -- K18's probe --------------------------------------------------------------

def _xjoin_inputs(case, seed=5):
    """(cand, dead, jdocids, jpos, lo, cnt, feats16, flags, prior) for one
    case; the window is jdocids[lo:lo + cnt] of a table with entries
    before and after it."""
    rng = np.random.default_rng(seed)
    doc_cap = 60_000
    dead = np.zeros(doc_cap, bool)
    if case == "one_entry":
        jd = np.array([3, 10, 17, 40], np.int32)
        lo, cnt = 2, 1
        cand = np.array([17, 10, 40, 16, 18, 3, -1, 0], np.int32)
    else:
        jd = np.sort(rng.choice(50_000, 6_000, replace=False)).astype(
            np.int32)
        lo, cnt = 500, 4_000
        cand = rng.choice(50_000, 3_000, replace=False).astype(np.int32)
        # the window's first and last entries and the two just outside it
        cand[:4] = [jd[lo], jd[lo + cnt - 1], jd[lo - 1], jd[lo + cnt]]
        if case.startswith("high"):
            jd = np.append(jd, [CAP, CAP + 9]).astype(np.int32)
            cnt = len(jd) - lo
            cand[[10, 700, 1500, 2999]] = [CAP + 3, CAP, 2 ** 30, CAP + 9]
            if case == "high_last_dead":
                dead = np.zeros(doc_cap, bool)   # doc_cap below 2^29:
                cand[2999] = -5                  # the last one not live
    dead[rng.choice(50_000, 300, replace=False)] = True
    n = len(cand)
    jp = rng.permutation(len(jd)).astype(np.int32)
    f16 = rng.integers(0, 3000, (len(jd), 17), dtype=np.int16)
    flags = rng.integers(0, 2 ** 30, len(jd), dtype=np.int32)
    prior = None
    if case == "with_prior":
        # an include that found 2/3 of the candidates, an exclude that hit
        # a tenth
        prior = np.zeros((2, 5, n), np.int32)
        prior[0, 0] = rng.random(n) < 0.66
        prior[1, 0] = rng.random(n) < 0.1
    return cand, dead, jd, jp, lo, cnt, f16, flags, prior


@pytest.mark.parametrize("case", ["edges", "one_entry", "high",
                                  "high_last_dead", "with_prior"])
def test_xjoin_probe_plain_matches_jax_membership(case):
    cand, dead, jd, jp, lo, cnt, f16, flags, prior = _xjoin_inputs(case)
    n_inc = 1
    valid = (cand >= 0) & ~np.where((cand >= 0) & (cand < len(dead)),
                                    dead[np.clip(cand, 0, len(dead) - 1)],
                                    False)
    if prior is not None:
        valid &= (prior[0, 0] > 0) & (prior[1, 0] == 0)
    found, prow = JDS._membership_sorted(
        jax.device_put(jd), jax.device_put(jp), lo, cnt,
        jax.device_put(cand), jax.device_put(valid))
    found, prow = np.asarray(found), np.asarray(prow)
    big = np.int32(IMAX)
    pf = f16[prow].astype(np.int32)
    want = np.stack([
        found.astype(np.int32),
        np.where(found, pf[:, JP.F_POSINTEXT], big),
        np.where(found, pf[:, JP.F_POSINTEXT], -big),
        np.where(found, pf[:, JP.F_HITCOUNT], big),
        np.where(found, flags[prow], 0)]).astype(np.int32)
    t = torch.from_numpy
    got = KD.xjoin_probe(t(cand), t(dead), None if prior is None else
                         t(prior), n_inc, t(jd), t(jp), lo, cnt, t(f16),
                         t(flags)).numpy()
    np.testing.assert_array_equal(got, want)
    if case.startswith("high"):
        high = np.nonzero(got[0] & (cand >= CAP))[0].tolist()
        last = max(i for i in range(len(cand)) if valid[i] and
                   cand[i] >= CAP)
        assert high == [last]
    if case == "edges":
        assert got[0, :4].tolist() == [1, 1, 0, 0]


def _mesh_pair():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("need 8 cpu devices")
    idx = JRWI()
    j = JMS.MeshSegmentStore(idx, devices=devs[:8], n_term=2)
    t = TMS.MeshSegmentStore(idx, devices=["cpu"] * 8, n_term=2)
    idx.listener = KB.Fanout(j, t)
    return idx, j, t


def _feats(rng, n):
    f = rng.integers(0, 1000, (n, JP.NF)).astype(np.int32)
    f[:, JP.F_LANGUAGE] = int(JP.pack_language("en"))
    return f


@pytest.fixture(scope="module")
def mesh_pair():
    idx, j, t = _mesh_pair()
    rows = KB.words_on_rows(2, per_row=3)
    rng = np.random.default_rng(11)
    # the rare term on term row 1, its partners on row 0; the rare term's
    # docids at and above 2^29 share doc column 0 (docid % 4) with the
    # partner's 2^29; the narrow partner's one docid, and the wide
    # partner's first and last docids, are among the rare term's
    rare = np.sort(np.concatenate([
        rng.choice(200_000, 3_000, replace=False) * 4,
        [CAP + 4, CAP + 8, 2 ** 30 + 4]])).astype(np.int32)
    wide = np.sort(np.concatenate([
        rng.choice(rare[:3_000], 1_500, replace=False),
        rng.choice(800_000, 20_000, replace=False), [CAP]]))
    wide = np.unique(wide).astype(np.int32)
    one = np.array([rare[17]], np.int32)
    terms = {"rare": (rows[1][0], rare), "wide": (rows[0][0], wide),
             "one": (rows[0][1], one)}
    run = {}
    for name, (word, d) in terms.items():
        run[word2hash(word)] = JP.PostingsList(d, _feats(rng, len(d)))
    idx.ingest_run(run)
    yield j, t, {k: word2hash(v[0]) for k, v in terms.items()}
    j.close()
    t.close()


@pytest.mark.parametrize("partner", ["wide", "one"])
@pytest.mark.parametrize("k", [10, 3_000])
def test_cross_row_join_matches_jax_mesh_store(mesh_pair, partner, k):
    j, t, ths = mesh_pair
    inc = [ths["rare"], ths[partner]]
    j._topk_cache._d.clear()
    t._topk_cache.clear()
    want = j.rank_join(inc, [], JProf(), k=k)
    got = t.rank_join(inc, [], TR.RankingProfile(), k=k)
    assert want is not None and got is not None
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    if partner == "wide" and k == 3_000:
        high = [d for d in np.asarray(got[1]).tolist() if d >= CAP]
        assert len(high) == 1


def test_cross_row_exclude_matches_jax_mesh_store(mesh_pair):
    """The partner as an exclude: of the rare rows at or above 2^29 only
    the last is dropped by the partner's 2^29."""
    j, t, ths = mesh_pair
    j._topk_cache._d.clear()
    t._topk_cache.clear()
    want = j.rank_join([ths["rare"]], [ths["wide"]], JProf(), k=3_000)
    got = t.rank_join([ths["rare"]], [ths["wide"]], TR.RankingProfile(),
                      k=3_000)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    high = [d for d in np.asarray(got[1]).tolist() if d >= CAP]
    assert len(high) == 2
