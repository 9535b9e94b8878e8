"""PyTorch port of ops/streaming: bit-identical to the JAX package, with
tiles and chunks smaller than the block so the running merge runs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yacy_search_server_tpu.index import postings as JP
from yacy_search_server_tpu.ops import ranking as JR
from yacy_search_server_tpu.ops import streaming as JS
from yacy_search_server_tpu_torch import convert
from yacy_search_server_tpu_torch.index import postings as TP
from yacy_search_server_tpu_torch.ops import ranking as TR
from yacy_search_server_tpu_torch.ops import streaming as TS


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block(n, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 900, (n, JP.NF)).astype(np.int32)
    feats[:, JP.F_FLAGS] = rng.integers(0, 2**20, n)
    feats[:, JP.F_DOMLENGTH] = rng.integers(0, 256, n)
    feats[:, JP.F_LANGUAGE] = JP.pack_language("en")
    if ties:     # the best row repeated across tiles/chunks
        best = np.argmax(JR.cardinal_scores_host(feats, JR.RankingProfile()))
        feats[::41] = feats[best]
    docids = np.arange(n, dtype=np.int32)
    hostids = rng.integers(0, 50, n).astype(np.int32)
    return feats, docids, hostids


def _jax_consts(prof):
    return (jnp.asarray(prof.norm_coeffs()),
            *map(jnp.asarray, prof.flag_coeffs()),
            jnp.int32(prof.domlength), jnp.int32(prof.tf),
            jnp.int32(prof.language), jnp.int32(prof.authority))


def _port_consts(prof):
    tp = convert.profile_from_jax(prof.to_external_string())
    return TR.profile_consts(tp, TP.pack_language("en"), "cpu")


@pytest.mark.parametrize("n,k,tile,ties", [
    (4096, 50, 512, False),
    (3000, 64, 512, True),      # partial last tile, ties across tiles
    (300, 100, 128, False),     # k > tile
    (40, 100, 512, False),      # fewer rows than k: sentinel tail
])
def test_scan_score_topk_bit_identical(n, k, tile, ties):
    feats, docids, hostids = _block(n, seed=n, ties=ties)
    valid = np.random.default_rng(1).random(n) < 0.9
    prof = JR.RankingProfile()
    f16, flags = JR.compact_feats(feats)
    jst = JR.local_stats(jnp.asarray(f16), jnp.asarray(valid),
                         jnp.asarray(hostids), num_hosts=1,
                         with_host_counts=False)
    ws, wd = JS.scan_score_topk(
        jnp.asarray(f16), jnp.asarray(flags), jnp.asarray(docids),
        jnp.asarray(valid), jnp.asarray(hostids), jst, *_jax_consts(prof),
        jnp.int32(JP.pack_language("en")), k, tile)
    tst = TR.local_stats(_t(f16), _t(valid), _t(hostids), num_hosts=1,
                         with_host_counts=False)
    gs, gd = TS.scan_score_topk(_t(f16), _t(flags), _t(docids), _t(valid),
                                _t(hostids), tst, _port_consts(prof), k,
                                tile)
    np.testing.assert_array_equal(np.asarray(ws), gs.numpy())
    np.testing.assert_array_equal(np.asarray(wd), gd.numpy())


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("n,k,chunk,ties", [
    (10_000, 64, 2048, False),
    (7000, 100, 1500, True),
    (10, 100, 4, False),
])
def test_stream_score_topk_bit_identical(compact, n, k, chunk, ties):
    feats, docids, hostids = _block(n, seed=n + 1, ties=ties)
    prof = JR.RankingProfile()
    if compact:
        f, flags = JR.compact_feats(feats)
    else:
        f, flags = feats, feats[:, JP.F_FLAGS].copy()
    ws, wd = JS.stream_score_topk(f, flags, docids, hostids,
                                  _jax_consts(prof),
                                  jnp.int32(JP.pack_language("en")), k=k,
                                  chunk=chunk)
    gs, gd = TS.stream_score_topk(f, flags, docids, hostids,
                                  _port_consts(prof), k=k, chunk=chunk,
                                  device="cpu")
    np.testing.assert_array_equal(ws, gs)
    np.testing.assert_array_equal(wd, gd)


def test_merge_stats_matches_one_block():
    feats, _docids, hostids = _block(5000, seed=9)
    f16, _ = JR.compact_feats(feats)
    valid = torch.ones(5000, dtype=torch.bool)
    whole = TR.local_stats(_t(f16), valid, _t(hostids), num_hosts=1,
                           with_host_counts=False)
    merged = None
    for lo in range(0, 5000, 1234):
        hi = min(5000, lo + 1234)
        merged = TS.merge_stats(merged, TR.local_stats(
            _t(f16[lo:hi]), valid[lo:hi], _t(hostids[lo:hi]), num_hosts=1,
            with_host_counts=False))
    assert torch.equal(whole["stats"], merged["stats"])
    assert torch.equal(whole["host_counts"], merged["host_counts"])


def test_stream_empty():
    s, d = TS.stream_score_topk(
        np.empty((0, JP.NF), np.int16), np.empty(0, np.int32),
        np.empty(0, np.int32), np.empty(0, np.int32),
        _port_consts(JR.RankingProfile()), k=10, device="cpu")
    assert len(s) == 0 and len(d) == 0
