"""The port's memory-only MetadataStore and the uniqueness postprocessing
against the JAX package's, on the CPU.

Both stores (the JAX one without a data_dir, i.e. memory-only too) take
the same rows, numpy-seeded; every read must be equal: the row views, the
batched getters, the int columns, the facet indexes, the hosthash groups,
and after `postprocess_uniqueness` the changed count and every flag it
writes. No tolerance: the stores hold Python values, compared with ==.
"""

import types

import numpy as np
import pytest

from yacy_search_server_tpu.index import metadata as JM
from yacy_search_server_tpu.index.postprocess import (
    host_doc_groups as j_groups, postprocess_uniqueness as j_unique)
from yacy_search_server_tpu_torch.index import metadata as TM
from yacy_search_server_tpu_torch.index.postprocess import (
    host_doc_groups as t_groups, postprocess_uniqueness as t_unique)
from yacy_search_server_tpu_torch.utils.hashes import url2hash

HOSTS = ("a.test", "b.test", "www.a.test", "c.test")


def _rows(n, seed):
    """n documents: urls over four hosts with http/https and www twins,
    repeated titles, descriptions and signatures, some sentinel (0)
    signatures, file extensions and protocols for the facets."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        host = HOSTS[int(rng.integers(0, len(HOSTS)))]
        proto = "https" if rng.random() < 0.3 else "http"
        ext = ("html", "pdf", "")[int(rng.integers(0, 3))]
        url = f"{proto}://{host}/p{int(rng.integers(0, n // 2 + 1))}" \
            + (f".{ext}" if ext else "")
        fields = dict(
            sku=url, host_s=host, url_protocol_s=proto, url_file_ext_s=ext,
            title=f"Title {int(rng.integers(0, 5))} ",
            description_txt=("", "some description")[int(rng.integers(0, 2))],
            exact_signature_l=int(rng.integers(0, 6)),
            fuzzy_signature_l=int(rng.integers(0, 4)) * 1_000_003,
            wordcount_i=int(rng.integers(0, 500)),
            cr_host_norm_d=float(rng.random()),
            process_sxt="citation" if rng.random() < 0.5 else "",
        )
        out.append((url2hash(url), fields))
    return out


def _fill(store, rows, M):
    for uh, fields in rows:
        store.put(M.DocumentMetadata(uh, **fields))
    return store


def _pair(n=200, seed=0):
    rows = _rows(n, seed)
    return _fill(JM.MetadataStore(), rows, JM), \
        _fill(TM.MetadataStore(), rows, TM), rows


def _same_store(j, t):
    assert j.capacity() == t.capacity() and len(j) == len(t)
    for d in range(j.capacity()):
        assert j.is_deleted(d) == t.is_deleted(d)
        assert j.urlhash_of(d) == t.urlhash_of(d)
        jg, tg = j.get(d), t.get(d)
        assert (jg is None) == (tg is None)
        if jg is not None:
            assert jg.fields == tg.fields and jg.urlhash == tg.urlhash
        jr, tr = j.row(d), t.row(d)
        assert (jr is None) == (tr is None)
        if jr is not None:
            for k in ("id", "sku", "host_s", "coordinate_p", "load_date_dt",
                      "cr_host_norm_d", "nonexistent"):
                assert jr.get(k, "dflt") == tr.get(k, "dflt")
    docids = list(range(j.capacity()))
    for f in ("title", "host_s", "sku"):
        assert j.text_values(docids, f) == t.text_values(docids, f)
    for f in ("wordcount_i", "exact_signature_l", "title_unique_b"):
        assert j.int_values(docids, f) == t.int_values(docids, f)
        np.testing.assert_array_equal(j.int_column(f), t.int_column(f))
    np.testing.assert_array_equal(j.alive_mask(), t.alive_mask())
    for f, vals in (("host_s", HOSTS + ("none.test",)),
                    ("url_file_ext_s", ("html", "pdf", "")),
                    ("url_protocol_s", ("http", "HTTPS"))):
        for v in vals:
            np.testing.assert_array_equal(j.facet_docids(f, v),
                                          t.facet_docids(f, v))
        pred = lambda x: x.startswith("h") or x.endswith("test")  # noqa
        np.testing.assert_array_equal(j.facet_docids(f, pred),
                                      t.facet_docids(f, pred))
    assert j.hosthash_groups() == t.hosthash_groups()
    assert j.facet_version == t.facet_version


def test_schema_and_multi_value_helpers_match_jax():
    assert TM.schema_field_names() == JM.schema_field_names()
    assert (TM.TEXT_FIELDS, TM.INT_FIELDS, TM.DOUBLE_FIELDS) == \
        (JM.TEXT_FIELDS, JM.INT_FIELDS, JM.DOUBLE_FIELDS)
    assert TM.FIELD_ALIASES == JM.FIELD_ALIASES
    assert TM.FACET_FIELDS == JM.FACET_FIELDS
    for vals in (["a", "", "b|c", None], [], ["", ""], ["x"]):
        assert TM.join_multi_positional(vals) == \
            JM.join_multi_positional(vals)
        clean = [v for v in vals if v is not None]
        assert TM.join_multi(clean) == JM.join_multi(clean)
    for s in ("", "a|b||c", "|", "x"):
        assert TM.split_multi(s) == JM.split_multi(s)
        assert TM.split_multi_positional(s) == JM.split_multi_positional(s)
    with pytest.raises(KeyError):
        TM.DocumentMetadata(b"x" * 12, no_such_field=1)


def test_put_reput_and_getters_match_jax():
    j, t, rows = _pair()
    _same_store(j, t)
    # a re-put of a known url: a new docid, the old one deleted, its text
    # blanked
    uh, fields = rows[5]
    fields = dict(fields, title="again")
    assert j.put(JM.DocumentMetadata(uh, **fields)) == \
        t.put(TM.DocumentMetadata(uh, **fields))
    for uh, _f in rows[:20]:
        assert j.docid(uh) == t.docid(uh)
        assert j.exists(uh) == t.exists(uh)
        jg, tg = j.get_by_urlhash(uh), t.get_by_urlhash(uh)
        assert jg.fields == tg.fields
    assert j.docid(b"nosuchhash!!") is None and t.docid(b"nosuchhash!!") \
        is None
    _same_store(j, t)


def test_set_fields_delete_and_bulk_load_match_jax():
    j, t, rows = _pair(seed=1)
    for d in (0, 3, 17, 40):
        for s in (j, t):
            s.set_fields(d, host_s="moved.test", wordcount_i="7",
                         cr_host_norm_d=1, title="")
            s.set_field(d + 1, "url_file_ext_s", "PDF")
            s.set_fields(d + 2, wordcount_i=s.int_values([d + 2],
                                                         "wordcount_i")[0])
    for s in (j, t):
        with pytest.raises(KeyError):
            s.set_fields(0, no_such_field=1)
    for uh, _f in rows[50:60]:
        assert j.delete(uh) == t.delete(uh)
    assert j.delete(b"nosuchhash!!") is None is t.delete(b"nosuchhash!!")
    hashes = [url2hash(f"http://bulk.test/{i}") for i in range(30)]
    cols = dict(host_s=["bulk.test"] * 30, wordcount_i=list(range(30)),
                url_file_ext_s=["html", ""] * 15)
    assert j.bulk_load(hashes, **cols) == t.bulk_load(hashes, **cols)
    for bad in (dict(no_such_field=[1] * 30), dict(title=["x"])):
        with pytest.raises((KeyError, ValueError)):
            t.bulk_load(hashes, **bad)
    _same_store(j, t)


def test_metadata_from_parsed_and_memory_only(tmp_path):
    url = "http://www.example.com/a/b.html"
    jd = JM.metadata_from_parsed(url2hash(url), url, "T", "text",
                                 host_s="www.example.com")
    td = TM.metadata_from_parsed(url2hash(url), url, "T", "text",
                                 host_s="www.example.com")
    assert jd.fields == td.fields and jd.urlhash == td.urlhash
    with pytest.raises(NotImplementedError):
        TM.MetadataStore(data_dir=str(tmp_path))


def test_postprocess_uniqueness_matches_jax():
    j, t, rows = _pair(n=300, seed=2)
    for uh, _f in rows[::37]:
        j.delete(uh)
        t.delete(uh)
    jseg = types.SimpleNamespace(metadata=j)
    tseg = types.SimpleNamespace(metadata=t)
    assert j_groups(jseg) == t_groups(tseg)
    changed = j_unique(jseg)
    assert changed > 0
    assert t_unique(tseg) == changed
    _same_store(j, t)
    flags = ("exact_signature_copycount_i", "fuzzy_signature_copycount_i",
             "exact_signature_unique_b", "fuzzy_signature_unique_b",
             "title_unique_b", "description_unique_b", "http_unique_b",
             "www_unique_b", "host_extent_i", "cr_host_count_i")
    for f in flags:
        np.testing.assert_array_equal(j.int_column(f), t.int_column(f))
    for d in range(j.capacity()):
        if not j.is_deleted(d):
            assert j.row(d).get("cr_host_chance_d") == \
                t.row(d).get("cr_host_chance_d")
            assert t.row(d).get("process_sxt") == ""
    # a second pass changes nothing, on both
    assert j_unique(jseg) == t_unique(tseg) == 0
