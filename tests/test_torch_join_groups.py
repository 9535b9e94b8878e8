"""K8's call on the host (kernels/devstore.join_wave_groups and
join_words): which slots of a join wave share a group, the words handed
to the card's kernel, and the rule that kernel relies on for a group: a
slot's answer is the group's filter-free answer with that slot's filter
applied to the valid byte, clip rows included. CPU only."""

import numpy as np
import pytest
import torch

from yacy_search_server_tpu_torch.index import postings as P
from yacy_search_server_tpu_torch.kernels import devstore as KD

LANG = (0x656E, KD.NO_FLAG, KD.DAYS_NONE_LO, KD.DAYS_NONE_HI)
FLAG = (KD.NO_LANG, 3, KD.DAYS_NONE_LO, KD.DAYS_NONE_HI)
DAYS = (KD.NO_LANG, KD.NO_FLAG, 100, 5_000)
PA = [(0, 50, -1), (50, 30, 0)]
PB = [(0, 50, -1), (80, 20, -1)]


def _desc(slots, n_inc=1):
    return KD.join_wave_desc(slots, n_inc, len(slots[0][3]) - n_inc)


@pytest.mark.parametrize("slots,groups", [
    # one span and its partners under four filters: one group
    ([(0, 100, f, PA) for f in (None, LANG, FLAG, LANG)], [[0, 1, 2, 3]]),
    # another span, other partners, another partner mode: groups of one
    ([(0, 100, None, PA), (1, 100, None, PA), (0, 99, None, PA),
      (0, 100, None, PB)], [[0], [1], [2], [3]]),
    # groups of several sizes mixed with slots that share nothing
    ([(0, 100, None, PA), (7, 10, LANG, PB), (0, 100, LANG, PA),
      (7, 10, None, PB), (3, 0, None, PA), (0, 100, DAYS, PA),
      (7, 10, FLAG, PA)], [[0, 2, 5], [1, 3], [4], [6]]),
    # a partner's slot and count are part of the key
    ([(0, 100, None, [(0, 50, -1), (50, 30, 0)]),
      (0, 100, None, [(0, 50, -1), (50, 30, 1)]),
      (0, 100, None, [(0, 50, -1), (50, 31, 0)])], [[0], [1], [2]]),
], ids=["one group", "all apart", "mixed", "partner key"])
def test_join_wave_groups(slots, groups):
    assert KD.join_wave_groups(_desc(slots), 1) == groups


def test_join_wave_groups_of_sixteen_slots():
    slots = [(0, 4_000_000, (None, LANG, FLAG, DAYS)[i % 4], PA)
             for i in range(16)]
    assert KD.join_wave_groups(_desc(slots), 1) == [list(range(16))]


def test_join_words():
    groups = [(0, 4_000_000, [(0, 10_000_000, 0), (10_000_000, 30_000, -1)]),
              (5, 1_000, [(0, 10_000_000, 0), (10_000_010, 7, -1)])]
    slots = [(0, 0, KD.NO_FILTER), (4_000_000, 0, LANG),
             (8_000_000, 1, FLAG)]
    gw, sw = KD.join_words(groups, slots)
    assert gw.typecode == sw.typecode == "q"
    assert list(gw) == [0, 4_000_000, 0, 10_000_000, 0, 10_000_000, 30_000,
                        -1, 5, 1_000, 0, 10_000_000, 0, 10_000_010, 7, -1]
    assert list(sw) == [0, 0, *KD.NO_FILTER, 4_000_000, 0, *LANG,
                        8_000_000, 1, *FLAG]


@pytest.mark.parametrize("n_inc,n_exc", [(0, 1), (1, 0), (2, 3), (5, 6)])
def test_join_words_of_a_wave(n_inc, n_exc):
    """A wave's groups and slots as join_member_batch hands them to the
    card: one group's words per group (2 + 3 a partner), six a slot, each
    slot pointing at its group, each region from its offset."""
    np_ = n_inc + n_exc
    pa = [(10 * i, 5 + i, (i if i % 2 else -1)) for i in range(np_)]
    pb = [(10 * i + 1, 5 + i, -1) for i in range(np_)]
    slots = [(0, 100, None, pa), (0, 100, LANG, pa), (3, 40, None, pb),
             (0, 100, FLAG, pa), (3, 40, DAYS, pb), (9, 0, None, pa)]
    desc = KD.join_wave_desc(slots, n_inc, n_exc)
    off = KD.join_wave_offsets(desc)
    members = KD.join_wave_groups(desc, n_inc)
    assert members == [[0, 1, 3], [2, 4], [5]]
    wave = KD.join_wave_slots(desc, n_inc)
    group_of = {i: g for g, m in enumerate(members) for i in m}
    gw, sw = KD.join_words(
        [(wave[m[0]][0], wave[m[0]][1], wave[m[0]][3]) for m in members],
        [(int(off[i]), group_of[i], wave[i][2]) for i in range(len(wave))])
    assert len(gw) == len(members) * (2 + 3 * np_)
    assert len(sw) == 6 * len(slots)
    for g, m in enumerate(members):
        w = gw[g * (2 + 3 * np_):(g + 1) * (2 + 3 * np_)]
        start, count, _f, parts = slots[m[0]]
        assert list(w[:2]) == [start, count]
        assert [tuple(w[2 + 3 * p:5 + 3 * p]) for p in range(np_)] == parts
    for i in range(len(slots)):
        assert sw[6 * i] == off[i] and sw[6 * i + 1] == group_of[i]
        assert tuple(sw[6 * i + 2:6 * i + 6]) == KD.filter_args(slots[i][2])


# -- the group rule on the plain version --------------------------------

def _arena(n, seed, high=()):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 3000, (n, P.NF)).astype(np.int16)
    f[:, P.F_LANGUAGE] = np.where(rng.random(n) < 0.5, 0x656E, 0x6465)
    f[:, P.F_LASTMOD] = rng.integers(0, 6_000, n)
    flags = rng.integers(0, 2**30, n).astype(np.int32)
    docids = (2 * np.arange(n) + 1).astype(np.int64)
    for i, r in enumerate(high):
        docids[r] = KD.JOIN_DOCID_CAP + i
    dead = np.zeros(2 * n + 2, bool)
    dead[docids[(docids < 2 * n) & (rng.random(n) < 0.05)]] = True
    return f, flags, docids.astype(np.int32), dead


def _tables(docids, segs):
    jd, jp, parts, at = [], [], [], 0
    for rows in segs:
        rows = np.asarray(rows)
        o = np.argsort(docids[rows], kind="stable")
        jd.append(docids[rows][o])
        jp.append(rows[o].astype(np.int32))
        parts.append((at, len(rows), -1))
        at += len(rows)
    return np.concatenate(jd), np.concatenate(jp), parts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_slot_is_its_group_with_its_filter(seed):
    """join_member_plain under a filter equals the filter-free answer
    with the filter applied to the valid byte: merged rows and flags the
    same, valid = filter-free valid & the filter. With rows at or above
    2^29 in the span (the clip rule's last-match decided before the
    filter) and a sort partner and exclude that hold 2^29."""
    n = 3_000
    high = (100, 1_500, 2_000, 2_900)
    rng = np.random.default_rng(seed)
    f, flags, docids, dead = _arena(n, 40 + seed, high)
    low = np.setdiff1d(np.arange(n), high)
    segs = [np.concatenate([[high[0]], rng.choice(low, n // 2, False)]),
            np.concatenate([[high[0]], rng.choice(low, n // 8, False)]),
            rng.choice(low, n // 3, False)]
    jd, jp, parts = _tables(docids, segs)
    t = torch.from_numpy
    arena = (t(f), t(flags), t(docids), t(dead))
    jt = (t(jd), t(jp), torch.zeros((1, 1, 2), dtype=torch.int32))
    for ps, n_inc in (([parts[0]], 1), ([parts[0], parts[1]], 1),
                      ([parts[2], parts[0]], 2), ([parts[1]], 0)):
        m0, fo0, v0 = KD.join_member_plain(*arena, 0, n, *jt, ps, n_inc)
        for q in (LANG, FLAG, DAYS):
            m, fo, v = KD.join_member_plain(*arena, 0, n, *jt, ps, n_inc, q)
            assert torch.equal(m, m0) and torch.equal(fo, fo0)
            assert torch.equal(v, v0 & KD.constraint_valid(t(f), fo0, q))
        assert int(v0.sum()) > 0
    # the same through a wave: its groups' slots under their filters
    slots = [(0, n, q, [parts[0], parts[1]]) for q in (None, LANG, FLAG)]
    desc = KD.join_wave_desc(slots, 1, 1)
    assert KD.join_wave_groups(desc, 1) == [[0, 1, 2]]
    off = KD.join_wave_offsets(desc)
    m, fo, v = KD.join_member_batch_plain(*arena, *jt, desc, 1, off)
    for i, (_s, _c, q, _p) in enumerate(slots):
        o = int(off[i])
        assert torch.equal(m[o:o + n], m[0:n])
        assert torch.equal(v[o:o + n], v[0:n] & KD.constraint_valid(
            t(f), fo[0:n], KD.filter_args(q)))
