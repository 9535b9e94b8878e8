"""The port's dense rerank (ops/dense.py, kernels/dense.py, index/dense.py)
against the JAX package's, on the CPU.

The encoder, the constants and the descriptor packing must equal the JAX
package's to the bit. Each of the four device functions runs its plain
versions (CPU tensors) on the inputs the JAX function gets (numpy from
one seed, at DIM = 256: the kernel's width). The port fixes the dot's
order of summation and XLA's CPU dot has its own, so the cardinal-domain
answers are held to the JAX package's own bar for its kernel against its
oracle (tests/test_rerank_batching.py:72-83): the same docids, each
score within 64 units, and the port's order (score DESC, then docid or
row ASC) on its own scores; the f32 blend is held to atol 1e-6. Where
every dot has one nonzero product (alpha 0, one-hot doc vectors, one-hot
queries) the order cannot matter, and the answers must equal JAX's to
the bit. Each comparison prints the largest difference it saw.

The DenseVectorStore is compared with the JAX one: gathers, versions,
row buckets, the patch path against a full upload, the budget release,
and the dirty rows restored after a failed upload.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yacy_search_server_tpu.index.dense import DenseVectorStore as JStore
from yacy_search_server_tpu.ops import dense as JD
from yacy_search_server_tpu_torch import convert
from yacy_search_server_tpu_torch.index import dense as TDI
from yacy_search_server_tpu_torch.kernels import bench as KB
from yacy_search_server_tpu_torch.ops import dense as TD
from yacy_search_server_tpu_torch.utils import faultinject

DIM = TD.DIM
TOL = 64           # cardinal units a docid (the JAX package's own bar)
F32_TOL = 1e-6


# -- encoder, constants, packing ------------------------------------------------

TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "schnelle braune Füchse springen über faule Hunde",
    "快速的棕色狐狸跳过懒狗 分布式 搜索 引擎",
    "быстрые коричневые лисы", "الثعلب البني السريع",
    "", "   ", "a", "repeated repeated word word",
    "word " * 600, " ".join(f"w{i}" for i in range(700)),
]


def test_encoder_bit_identical_to_jax():
    j, t = JD.HashingEncoder(), TD.HashingEncoder()
    for s in TEXTS:
        a, b = j.encode(s), t.encode(s)
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.uint32), b.view(np.uint32)), s[:20]
    a, b = j.encode_batch(TEXTS), t.encode_batch(TEXTS)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    assert t.encode_batch([]).shape == (0, DIM)


def test_constants_equal_jax():
    assert (TD.DIM, TD.ENCODER_VERSION, TD.DENSE_BOOST_SCALE,
            TD.RERANK_MAX_N, TD._SEED) == (
        JD.DIM, JD.ENCODER_VERSION, JD.DENSE_BOOST_SCALE, JD.RERANK_MAX_N,
        JD._SEED)
    for n in (0, 1, 15, 16, 17, 100, 128, 129, 1000, 16384):
        assert TD.rerank_bucket(n) == JD.rerank_bucket(n)
    for x in ("w:abc", "t:^ab", "", "ü"):
        assert TD._stable_hash(x) == JD._stable_hash(x)


def test_pack_rerank_row_byte_identical():
    rng = np.random.default_rng(1)
    for n, nb in ((0, 16), (3, 16), (16, 16), (100, 128)):
        q = rng.standard_normal(DIM).astype(np.float32)
        sp = rng.integers(-5, 1 << 20, n).astype(np.int32)
        dd = rng.integers(-1, 5000, n).astype(np.int32)
        a = JD.pack_rerank_row(q, sp, dd, 0.37, nb)
        b = TD.pack_rerank_row(q, sp, dd, 0.37, nb)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_bf16_rounding_matches_ml_dtypes():
    import ml_dtypes
    x = np.random.default_rng(2).standard_normal(100_000).astype(np.float32)
    x[:4] = (1.0, 1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8))   # ties to even
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    assert np.array_equal(TD.bf16_np(x), want)
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    assert np.array_equal(KDn.bf16(torch.from_numpy(x)).numpy(), want)


# -- the bar ---------------------------------------------------------------------

def _close(label, ks, kd, es, ed, tol=TOL):
    """Same docids, each score within `tol`; prints and returns the
    largest difference."""
    ks, kd, es, ed = (np.asarray(a) for a in (ks, kd, es, ed))
    assert sorted(kd.tolist()) == sorted(ed.tolist()), label
    e = dict(zip(ed.tolist(), es.astype(np.float64).tolist()))
    worst = max((abs(float(s) - e[d]) for s, d in
                 zip(ks.astype(np.float64).tolist(), kd.tolist())),
                default=0.0)
    print(f"{label}: largest |delta| {worst:g}")
    assert worst <= tol, label
    return worst


def _ordered(scores, keys):
    """(score DESC, key ASC) over the whole answer."""
    s = np.asarray(scores).astype(np.float64)
    k = np.asarray(keys).astype(np.int64)
    assert np.all(s[:-1] >= s[1:])
    same = s[:-1] == s[1:]
    assert np.all(k[:-1][same] < k[1:][same])


# -- the packed rerank -----------------------------------------------------------

def _forward(cap, n_real, seed, onehot=False):
    """A forward index of `cap` rows, the first n_real unit vectors (or
    one-hot rows), the rest zero (rows past the store's _n inside its
    bucket), every 41st real row a copy of row 3 (equal boosts)."""
    rng = np.random.default_rng(seed)
    fwd = np.zeros((cap, DIM), np.float16)
    if onehot:
        fwd[np.arange(n_real), rng.integers(0, DIM, n_real)] = 1.0
    else:
        fwd[:n_real] = KB.unit_vectors(n_real, rng)
    fwd[:n_real:41] = fwd[3]
    return fwd


def _wave(seed, cap, ns, alpha, onehot_q=False):
    qi, nb, slots = KB.rerank_wave(np.random.default_rng(seed), cap, ns,
                                   alpha=alpha)
    if onehot_q:
        for i, (q, sp, dd) in enumerate(slots):
            q = np.zeros(DIM, np.float32)
            q[(seed + i) % DIM] = 0.75
            qi[i] = TD.pack_rerank_row(q, sp, dd, alpha, nb)
            slots[i] = (q, sp, dd)
    return qi, nb, slots


WAVES = {"bs1": (1, (16,)), "bs3": (3, (100, 0, 128)),
         "bs16": (16, (5, 16, 1, 0, 13, 16, 2, 0, 9, 16, 3, 7, 0, 11, 16, 4)),
         "bs16-nb1024": (16, (1000, 513, 0, 1, 1024) + (0,) * 11)}


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("wave", list(WAVES))
def test_rerank_fwd_batch_matches_jax(wave, alpha):
    cap, n_real = 1024, 900
    fwd = _forward(cap, n_real, seed=4)
    _bs, ns = WAVES[wave]
    qi, nb, slots = _wave(len(ns) * 7 + int(alpha * 10), cap, ns, alpha)
    want = np.asarray(JD._rerank_fwd_batch_packed_kernel(
        jax.device_put(fwd), qi, nb=nb, bs=len(ns)))
    got = TD.rerank_fwd_batch_packed(torch.from_numpy(fwd), qi, nb).numpy()
    assert got.shape == want.shape == (len(ns), 2 * nb)
    for i, (q, sp, dd) in enumerate(slots):
        n = len(dd)
        _close(f"{wave} a={alpha} slot {i} vs JAX", got[i, :n],
               got[i, nb:nb + n], want[i, :n], want[i, nb:nb + n])
        _close(f"{wave} a={alpha} slot {i} vs oracle", got[i, :n],
               got[i, nb:nb + n], *TD.rerank_fwd_np(q, fwd, sp, dd, alpha))
        _ordered(got[i, :n], got[i, nb:nb + n])
        # pad lanes: -(2^31-1), their descriptor's docid (0), as JAX
        assert np.array_equal(got[i, n:nb], want[i, n:nb])
        assert np.array_equal(got[i, nb + n:], want[i, nb + n:])
    if alpha == 0.0:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["onehot-docs", "onehot-query"])
@pytest.mark.parametrize("wave", list(WAVES))
def test_rerank_fwd_batch_exact_cases_bit_identical(wave, case):
    """One nonzero product a dot: the order of the sum cannot matter, so
    the gather, the coverage mask, the boost's rounding, the pad lanes
    and the two-key sort must give JAX's answer to the bit."""
    cap = 1024
    fwd = _forward(cap, 900, seed=5, onehot=case == "onehot-docs")
    _bs, ns = WAVES[wave]
    qi, nb, _slots = _wave(11, cap, ns, 0.5, onehot_q=case == "onehot-query")
    want = np.asarray(JD._rerank_fwd_batch_packed_kernel(
        jax.device_put(fwd), qi, nb=nb, bs=len(ns)))
    got = TD.rerank_fwd_batch_packed(torch.from_numpy(fwd), qi, nb).numpy()
    assert np.array_equal(got, want)


def test_out_of_coverage_keeps_sparse_score():
    fwd = np.random.default_rng(4).standard_normal((256, DIM)).astype(
        np.float16)
    q = np.ones(DIM, np.float32)
    sp = np.array([1000, 2000, 3000], np.int32)
    dd = np.array([5000, -1, 300], np.int32)
    nb = TD.rerank_bucket(3)
    qi = TD.pack_rerank_row(q, sp, dd, 0.9, nb)[None, :]
    out = TD.rerank_fwd_batch_packed(torch.from_numpy(fwd), qi, nb).numpy()
    np.testing.assert_array_equal(out[0, :3], [3000, 2000, 1000])
    np.testing.assert_array_equal(out[0, nb:nb + 3], [300, -1, 5000])


def test_rerank_sort_is_stable_on_full_ties():
    """Equal (score, docid) keys keep lane order (lax.sort is stable):
    pad lanes carrying docids come out in lane order."""
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    nb = 16
    qi = np.zeros((1, 2 + 2 * nb + DIM), np.int32)
    qi[0, 0] = 4
    qi[0, 2:2 + nb] = np.arange(nb)[::-1] + 100
    qi[0, 2 + nb:2 + nb + 4] = 7
    final = torch.full((1, nb), -(2**31 - 1), dtype=torch.int32)
    final[0, :4] = 7
    got = KDn.rerank_sort(final, torch.from_numpy(qi), nb).numpy()
    want = np.asarray(JD._rerank_fwd_batch_packed_kernel(
        jax.device_put(np.zeros((4, DIM), np.float16)), qi, nb=nb, bs=1))
    assert np.array_equal(got, want)


# -- dense_boost_topk, hybrid_rerank_topk(_batch) ------------------------------

def _block(n, seed, onehot=False):
    rng = np.random.default_rng(seed)
    docs = _forward(n, n, seed, onehot)
    q = KB.unit_vectors(1, rng, dtype=np.float32)[0]
    sp = rng.integers(0, 1 << 20, n).astype(np.int32)
    sp[::5] = sp[0]
    valid = rng.random(n) < 0.85
    return docs, q, sp, valid


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("n,k", [(16, 16), (128, 10), (1024, 100),
                                 (1024, 1024)])
def test_dense_boost_topk_matches_jax(n, k, alpha):
    docs, q, sp, valid = _block(n, n + k)
    ws, wi = JD.dense_boost_topk(jnp.asarray(q), jnp.asarray(docs),
                                 jnp.asarray(sp), jnp.asarray(valid),
                                 jnp.float32(alpha), k)
    gs, gi = TD.dense_boost_topk(q, docs, sp, valid, alpha, k, device="cpu")
    gs, gi = gs.numpy(), gi.numpy()
    _close(f"dense_boost_topk n={n} k={k} a={alpha} vs JAX", gs, gi,
           np.asarray(ws), np.asarray(wi))
    _close(f"dense_boost_topk n={n} k={k} a={alpha} vs oracle", gs, gi,
           *TD.dense_boost_topk_np(q, docs, sp, valid, alpha, k))
    _ordered(gs, gi)
    if alpha == 0.0:
        assert np.array_equal(gs, np.asarray(ws))
        assert np.array_equal(gi, np.asarray(wi))


def test_dense_boost_topk_onehot_bit_identical():
    docs, q, sp, valid = _block(1024, 9, onehot=True)
    ws, wi = JD.dense_boost_topk(jnp.asarray(q), jnp.asarray(docs),
                                 jnp.asarray(sp), jnp.asarray(valid),
                                 jnp.float32(0.5), 300)
    gs, gi = TD.dense_boost_topk(q, docs, sp, valid, 0.5, 300, device="cpu")
    assert np.array_equal(gs.numpy(), np.asarray(ws))
    assert np.array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("n,k", [(16, 5), (1024, 10), (1024, 1024)])
def test_hybrid_rerank_topk_matches_jax(n, k, alpha):
    docs, q, sp, valid = _block(n, 3 * n + k)
    sparse = sp.astype(np.float32)
    ws, wi = JD.hybrid_rerank_topk(jnp.asarray(q), jnp.asarray(docs),
                                   jnp.asarray(sparse), jnp.asarray(valid),
                                   jnp.float32(alpha), k)
    gs, gi = TD.hybrid_rerank_topk(q, docs, sparse, valid, alpha, k,
                                   device="cpu")
    gs, gi = gs.numpy(), gi.numpy()
    fin = np.isfinite(np.asarray(ws))
    assert np.array_equal(np.isfinite(gs), fin)
    _close(f"hybrid_rerank_topk n={n} k={k} a={alpha} vs JAX", gs[fin],
           gi[fin], np.asarray(ws)[fin], np.asarray(wi)[fin], F32_TOL)
    _ordered(gs[fin], gi[fin])
    # the oracle takes no bf16 rounding: the JAX test's own bar for it
    # (tests/test_dense.py: 8 of 10 shared, the best three within 2e-2)
    os_, oi = TD.hybrid_rerank_topk_np(q, docs, sparse, valid, alpha, k)
    top = min(10, k)
    assert len(set(gi[:top].tolist()) & set(oi[:top].tolist())) >= 0.8 * top
    assert np.allclose(gs[:3], os_[:3], atol=2e-2)
    if alpha == 0.0:
        assert np.array_equal(gs, np.asarray(ws))
        assert np.array_equal(gi, np.asarray(wi))


@pytest.mark.parametrize("b,n,k", [(1, 64, 8), (3, 1024, 10), (16, 512, 32)])
def test_hybrid_rerank_topk_batch_matches_jax_and_solo(b, n, k):
    rng = np.random.default_rng(b * n)
    docs = _forward(n, n, b)
    qs = KB.unit_vectors(b, rng, dtype=np.float32)
    sparse = rng.integers(0, 1000, (b, n)).astype(np.float32)
    valid = rng.random((b, n)) < 0.9
    ws, wi = JD.hybrid_rerank_topk_batch(
        jnp.asarray(qs), jnp.asarray(docs), jnp.asarray(sparse),
        jnp.asarray(valid), jnp.float32(0.5), k)
    gs, gi = TD.hybrid_rerank_topk_batch(qs, docs, sparse, valid, 0.5, k,
                                         device="cpu")
    for i in range(b):
        _close(f"hybrid batch b={b} slot {i} vs JAX", gs[i].numpy(),
               gi[i].numpy(), np.asarray(ws[i]), np.asarray(wi[i]), F32_TOL)
        ss, si = TD.hybrid_rerank_topk(qs[i], docs, sparse[i], valid[i], 0.5,
                                       k, device="cpu")
        assert torch.equal(gs[i], ss) and torch.equal(gi[i], si)


def test_hybrid_rerank_onehot_bit_identical():
    docs, q, sp, valid = _block(512, 10, onehot=True)
    sparse = sp.astype(np.float32)
    ws, wi = JD.hybrid_rerank_topk(jnp.asarray(q), jnp.asarray(docs),
                                   jnp.asarray(sparse), jnp.asarray(valid),
                                   jnp.float32(0.5), 100)
    gs, gi = TD.hybrid_rerank_topk(q, docs, sparse, valid, 0.5, 100,
                                   device="cpu")
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gs.numpy().view(np.uint32),
                          np.asarray(ws).view(np.uint32))


def test_entry_points_take_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    docs, q, sp, valid = _block(16, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.dense_boost_topk(q, docs, sp, valid, 0.5, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.dense_from_numpy(docs)


def test_kernels_take_dim_256_only():
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    with pytest.raises(ValueError, match="256"):
        KDn.dense_sims(torch.zeros((4, 64)), torch.zeros((1, 64)))


def test_kernels_take_f16_rows_only():
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    docs, q, sp, valid = _block(16, 1)
    with pytest.raises(TypeError, match="f16"):
        KDn.dense_sims(torch.zeros((4, DIM)), torch.zeros((1, DIM)))
    with pytest.raises(TypeError, match="f16"):
        TD.dense_boost_topk(q, docs.astype(np.float32), sp, valid, 0.5, 4,
                            device="cpu")
    with pytest.raises(TypeError, match="f16"):
        TD.hybrid_rerank_topk(q, docs.astype(np.float32),
                              sp.astype(np.float32), valid, 0.5, 4,
                              device="cpu")


# -- the dense vector store ------------------------------------------------------

def _fill(stores, n, seed, dim=16):
    rng = np.random.default_rng(seed)
    for i in range(n):
        v = rng.normal(size=dim).astype(np.float32)
        for st in stores:
            st.put(int(i * 3 % (n + 7)), v)


def test_store_matches_jax_store():
    j, t = JStore(dim=16), TDI.DenseVectorStore(dim=16)
    for n in (0, 1, 200, 300, 700):
        _fill((j, t), n, seed=n)
        ids = np.array([-1, 0, 3, 299, 10_000, n + 5])
        assert np.array_equal(t.get_block(ids), j.get_block(ids))
        assert (t.version, t.device_rows(), len(t)) == (
            j.version, j.device_rows(), len(j))


def _spy(monkeypatch, st):
    got = []
    real = st._transfer

    def transfer(dev, patch, *a):
        got.append(patch)
        return real(dev, patch, *a)
    monkeypatch.setattr(st, "_transfer", transfer)
    return got


@pytest.mark.parametrize("writes,patched", [(1, True), (64, True),
                                            (65, False)])
def test_patch_equals_full_upload(monkeypatch, writes, patched):
    """rows = 256: up to rows/4 = 64 dirty rows patch the block (out of
    place: the block a reader holds is not changed), more re-upload it;
    either way the block equals a fresh upload of the same vectors, and
    the JAX store's."""
    rng = np.random.default_rng(writes)
    j, t = JStore(dim=16), TDI.DenseVectorStore(dim=16)
    _fill((j, t), 200, seed=1)
    old, v0 = t.device_block("cpu")
    old_copy = old.clone()
    kinds = _spy(monkeypatch, t)
    for i in rng.choice(256, writes, replace=False):
        v = rng.normal(size=16).astype(np.float32)
        j.put(int(i), v)
        t.put(int(i), v)
    fwd, v1 = t.device_block("cpu")
    assert kinds == [patched] and v1 == v0 + writes
    assert torch.equal(old, old_copy) and fwd is not old
    fresh = TDI.DenseVectorStore(dim=16)
    fresh._vecs, fresh._n = t._vecs.copy(), t._n
    assert torch.equal(fwd, fresh.device_block("cpu")[0])
    assert np.array_equal(fwd.numpy(),
                          np.asarray(j.device_block(jax.devices()[0])[0]))
    again, v2 = t.device_block("cpu")
    assert again is fwd and v2 == v1 and kinds == [patched]


def test_over_budget_releases_block():
    t = TDI.DenseVectorStore(dim=16)
    t.put(0, np.ones(16, np.float32))
    assert t.device_block("cpu") is not None and t._fwd is not None
    t.device_budget_bytes = 1
    assert t.device_block("cpu") is None
    assert t._fwd is None and t._fwd_device is None


@pytest.mark.parametrize("path", ["patch", "full"])
def test_failed_upload_restores_dirty_rows(path):
    t = TDI.DenseVectorStore(dim=16)
    _fill((t,), 200, seed=2)
    base, _v = t.device_block("cpu")
    rows = [3, 7, 9] if path == "patch" else list(range(100))
    for i in rows:
        t.put(i, np.full(16, i + 0.5, np.float32))
    faultinject.set_fault("dense.upload_fail", 1)
    try:
        with pytest.raises(TDI.DenseUploadError):
            t.device_block("cpu")
    finally:
        faultinject.clear()
    assert t._fwd is base
    assert t._fwd_dirty == set(rows) or (path == "full"
                                         and t._fwd_dirty is not None)
    fwd, _v = t.device_block("cpu")
    assert np.array_equal(fwd.numpy()[rows], t._vecs[rows])


def test_dirty_overflow_then_full_upload(monkeypatch):
    monkeypatch.setattr(TDI.DenseVectorStore, "_DIRTY_CAP", 8)
    t = TDI.DenseVectorStore(dim=16)
    _fill((t,), 200, seed=3)
    t.device_block("cpu")
    kinds = _spy(monkeypatch, t)
    for i in range(9):
        t.put(i, np.ones(16, np.float32))
    assert t._fwd_dirty is None
    fwd, _v = t.device_block("cpu")
    assert kinds == [False] and np.array_equal(fwd.numpy()[:9],
                                               t._vecs[:9])


def test_dense_from_numpy_matches_puts():
    rng = np.random.default_rng(6)
    vecs = KB.unit_vectors(300, rng)
    j = JStore(dim=DIM)
    for i, v in enumerate(vecs):
        j.put(i, v.astype(np.float32))
    t = convert.dense_from_numpy(j._vecs, len(j), device="cpu")
    assert (len(t), t.version, t.device_rows()) == (len(j), j.version,
                                                    j.device_rows())
    assert t._vecs.shape == j._vecs.shape
    assert np.array_equal(t._vecs, j._vecs)
    fwd, _v = t.device_block("cpu")
    assert np.array_equal(fwd.numpy(),
                          np.asarray(j.device_block(jax.devices()[0])[0]))
    t.put(len(j), vecs[0].astype(np.float32))
    j.put(len(j), vecs[0].astype(np.float32))
    assert np.array_equal(t._vecs, j._vecs)
