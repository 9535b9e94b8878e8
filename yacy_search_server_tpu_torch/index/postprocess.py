"""Index postprocessing — duplicate/uniqueness flags over the whole store.

Capability equivalent of the reference's collection postprocessing
(reference: search/schema/CollectionConfiguration.java postprocessing /
postprocessing_doublecontent: after indexing, documents are compared and
the *_unique_b flags plus signature copycounts are written back, feeding
the "unique heuristic" result-list preference). Here the store is
columnar, so each uniqueness dimension is one vectorized group-by over an
int or (host, text) key instead of per-document Solr queries:

- exact_signature_l / fuzzy_signature_l group globally (identical or
  near-identical content anywhere in the index);
- title / description group within one host (the reference's
  same-host uniqueness rule — two hosts may legitimately share a title).

The port's copy of the JAX package's index/postprocess.py; `segment` is
duck-typed: anything with a `.metadata` (the port's MetadataStore or the
JAX package's).
"""

from __future__ import annotations

from collections import Counter, defaultdict

from ..document.signature import exact_signature, fuzzy_signature

# Sentinel signatures that must never form a duplicate group: the unset
# default (0 — bulk imports, rows journaled before the signature fields
# existed, peer stubs) and the signature of empty text (noindex pages).
_SENTINEL_EXACT = frozenset({0, exact_signature("")})
_SENTINEL_FUZZY = frozenset({0, fuzzy_signature("")})


def postprocess_uniqueness(segment) -> int:
    """Recompute *_unique_b and *_copycount_i for every live document;
    returns the number of documents whose flags changed. Sentinel
    signatures (unset / empty content) are treated as unique rather than
    clustering the whole corpus into one duplicate group."""
    meta = segment.metadata
    alive = [d for d in range(meta.capacity()) if not meta.is_deleted(d)]

    exact: Counter = Counter()
    fuzzy: Counter = Counter()
    titles: Counter = Counter()
    descriptions: Counter = Counter()
    stubs: Counter = Counter()        # protocol-less url (http/https twins)
    # www-less key -> set of stubs: a doc is www-NON-unique only when an
    # ACTUAL www twin exists (a stub different from its own) — protocol
    # twins share one stub and belong to http_unique_b, not here
    wwwgroups: dict = defaultdict(set)
    hosts: Counter = Counter()        # docs per host (host_extent_i)
    rows = []
    for d in alive:
        row = meta.row(d)
        e = row.get("exact_signature_l", 0)
        f = row.get("fuzzy_signature_l", 0)
        host = row.get("host_s", "")
        sku = row.get("sku", "")
        stub = sku.split("://", 1)[-1]
        wkey = stub[4:] if stub.startswith("www.") else stub
        t = (host, row.get("title", "").strip().lower())
        de = (host, row.get("description_txt", "").strip().lower())
        if e not in _SENTINEL_EXACT:
            exact[e] += 1
        if f not in _SENTINEL_FUZZY:
            fuzzy[f] += 1
        if t[1]:
            titles[t] += 1
        if de[1]:
            descriptions[de] += 1
        if stub:
            stubs[stub] += 1
            wwwgroups[wkey].add(stub)
        hosts[host] += 1
        rows.append((d, e, f, t, de, stub, wkey, host))

    changed = 0
    for d, e, f, t, de, stub, wkey, host in rows:
        e_copies = exact.get(e, 1)      # sentinel -> counts as unique
        f_copies = fuzzy.get(f, 1)
        n_host = hosts.get(host, 1)
        fields = dict(
            exact_signature_copycount_i=e_copies - 1,
            fuzzy_signature_copycount_i=f_copies - 1,
            exact_signature_unique_b=int(e_copies == 1),
            fuzzy_signature_unique_b=int(f_copies == 1),
            title_unique_b=int(titles.get(t, 0) <= 1),
            description_unique_b=int(descriptions.get(de, 0) <= 1),
            # http/www duplicate detection (reference postprocessing
            # http_unique_b / www_unique_b: is this doc the only
            # protocol / www variant of its url?)
            http_unique_b=int(stubs.get(stub, 1) <= 1),
            www_unique_b=int(
                len(wwwgroups.get(wkey, set()) - {stub}) == 0),
            host_extent_i=n_host,
            cr_host_count_i=n_host,
            cr_host_chance_d=1.0 / max(n_host, 1),
            # the bookkeeping tag set at store time is consumed here
            process_sxt="",
        )
        row = meta.row(d)
        if any(row.get(k) != v for k, v in fields.items()):
            meta.set_fields(d, **fields)
            changed += 1
    return changed


def host_doc_groups(segment) -> dict[str, list[int]]:
    """host -> live docids (shared helper for host-scoped postprocessing)."""
    meta = segment.metadata
    groups: dict[str, list[int]] = defaultdict(list)
    for d in range(meta.capacity()):
        if not meta.is_deleted(d):
            groups[meta.text_value(d, "host_s")].append(d)
    return dict(groups)
