"""Columnar document metadata store, memory-only — the fulltext/metadata
side of the index.

The port's copy of the JAX package's index/metadata.py (capability
equivalent of the reference's Solr-backed metadata store, reference:
source/net/yacy/search/index/Fulltext.java:90-230 over the ~200-field
schema in search/schema/CollectionSchema.java:34+): the same schema, the
same docid <-> urlhash identity (a re-put allocates a new docid and
deletes the old one), the same facet indexes and column views, and the
same postprocessing setters.

Memory-only: every row lives in the RAM tail, as in a JAX MetadataStore
opened without a data_dir. The frozen segment files, the override maps
that update them, the journal and its replay wait for the port's
persistence; a `data_dir` raises.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..utils.hashes import dom_length_normalized, hosthash, url_comps

# Load-bearing schema fields (name -> default), subset of CollectionSchema.
# Text-like fields live in python lists; numeric ranking signals get numpy
# column views for device upload.
# Multi-valued (_sxt/_txt list) fields are stored "|"-joined ("|" cannot
# appear unescaped in a URL and the reference's text fields never carry
# it); split with split_multi() below.
MULTI_SEP = "|"

TEXT_FIELDS = (
    "sku",            # url (CollectionSchema.sku)
    "title",
    "author",
    "description_txt",
    "keywords",
    "text_t",         # full extracted text (snippet source)
    "host_s",
    "language_s",
    "url_file_ext_s",
    "collection_sxt",  # crawl collections (comma-joined)
    "vocabulary_sxt",  # autotagging facets "voc:tag,..." (vocabulary_* fields)
    # -- content/transport identity (CollectionSchema content_type etc.)
    "content_type",
    "charset_s",
    "canonical_s",
    "referrer_id_s",   # urlhash of the page that linked here
    "publisher_t",
    "metagenerator_t",
    # -- link arrays (CollectionSchema *_sxt / anchortext fields)
    "inboundlinks_urlstub_sxt",
    "outboundlinks_urlstub_sxt",
    "inboundlinks_anchortext_txt",
    "outboundlinks_anchortext_txt",
    "images_urlstub_sxt",
    "images_alt_sxt",
    "images_protocol_sxt",
    "icons_urlstub_sxt",
    # -- heading zone texts (h1_txt..h6_txt)
    "h1_txt", "h2_txt", "h3_txt", "h4_txt", "h5_txt", "h6_txt",
    # -- dates found in the content (ISO strings; dates_in_content_dts)
    "dates_in_content_dts",
    # -- url decomposition (url_* fields)
    "url_protocol_s",
    "url_file_name_s",
    "url_paths_sxt",
    # -- host decomposition (host_* fields)
    "host_organization_s",
    "host_subdomain_s",
    "host_dnc_s",              # domain-name-core reversed ("com.example")
    "host_organizationdnc_s",
    # -- identity / transport (host_id_s, ip_s, md5_s)
    "host_id_s",               # 6-char host hash (DigestURL host part)
    "ip_s",
    "md5_s",                   # content digest
    # -- postprocessing bookkeeping (process_sxt/harvestkey_s: tags a
    # doc as awaiting a postprocessing pass; cleared when it runs)
    "process_sxt",
    "harvestkey_s",
    # -- failure docs (ErrorCache rows share the collection schema)
    "failreason_s",
    "failtype_s",
    # -- indexing-time term expansion record
    "synonyms_sxt",
    "author_sxt",
    # -- link protocol arrays (positional, like images_protocol_sxt)
    "inboundlinks_protocol_sxt",
    "outboundlinks_protocol_sxt",
    "icons_protocol_sxt",
    "icons_rel_sxt",
    "icons_sizes_sxt",
    # -- image long tail (alt-joined text + positional dimension arrays)
    "images_text_t",
    "images_height_val",
    "images_width_val",
    "images_pixel_val",
    # -- structure text groups (li/dt/dd/article/bold/italic/underline)
    "li_txt", "dt_txt", "dd_txt", "article_txt",
    "bold_txt", "italic_txt", "underline_txt",
    # -- page machinery (css/scripts/frames/iframes/refresh/flash)
    "css_url_sxt",
    "scripts_sxt",
    "frames_sxt",
    "iframes_sxt",
    "refresh_s",
    # -- alternate-language + navigation link relations
    "hreflang_url_sxt",
    "hreflang_cc_sxt",
    "navigation_url_sxt",
    "navigation_type_sxt",
    # -- opengraph group
    "opengraph_title_t",
    "opengraph_type_s",
    "opengraph_url_s",
    "opengraph_image_s",
    "publisher_url_s",
    # -- url decomposition long tail
    "url_file_name_tokens_t",
    "url_parameter_key_sxt",
    "url_parameter_value_sxt",
    # -- structure occurrence counts (positional ints over the deduped
    #    *_txt lists — CollectionSchema bold_val/italic_val/underline_val)
    "bold_val",
    "italic_val",
    "underline_val",
    # -- raw stylesheet link tags (css_tag_sxt; css_url_sxt has the urls)
    "css_tag_sxt",
    # -- near-duplicate grouping evidence (fuzzy_signature_text_t)
    "fuzzy_signature_text_t",
    # -- names of vocabularies that matched this doc (vocabularies_sxt;
    #    vocabulary_sxt carries the matched "voc:tag" pairs)
    "vocabularies_sxt",
    # -- page-technology evaluation (document/evaluation.py; each
    #    category stores detected names + positional match counts)
    "ext_ads_txt", "ext_ads_val",
    "ext_cms_txt", "ext_cms_val",
    "ext_community_txt", "ext_community_val",
    "ext_maps_txt", "ext_maps_val",
    "ext_title_txt", "ext_title_val",
    "ext_tracker_txt", "ext_tracker_val",
)
INT_FIELDS = (
    "size_i",          # byte size
    "wordcount_i",
    "phrasecount_i",
    "imagescount_i",
    "linkscount_i",
    "inboundlinkscount_i",
    "outboundlinkscount_i",
    "crawldepth_i",
    "references_i",        # citation count (postprocessing signal)
    "references_exthosts_i",
    "httpstatus_i",
    "last_modified_days_i",
    "load_date_days_i",
    "doctype_i",
    "flags_i",             # condenser content flags (bitfield)
    "domlength_i",         # derived from url-hash flag byte
    "urllength_i",
    "urlcomps_i",
    # -- media link counts
    "audiolinkscount_i",
    "videolinkscount_i",
    "applinkscount_i",
    # -- nofollow-split link counts
    "linksnofollowcount_i",
    "inboundlinksnofollowcount_i",
    "outboundlinksnofollowcount_i",
    # -- robots/meta flags and heading census
    "robots_i",            # document.ROBOTS_* bitfield
    "htags_i",             # bitmask: bit(l-1) set when an h<l> exists
    "h1_i", "h2_i", "h3_i", "h4_i", "h5_i", "h6_i",   # per-level counts
    "images_withalt_i",
    # -- dates in content
    "dates_in_content_count_i",
    # -- title/description shape (counts the reference keeps as *_val)
    "title_count_i",
    "title_words_val",
    "description_count_i",
    "description_words_val",
    # -- url decomposition counts
    "url_paths_count_i",
    "url_parameter_i",
    "url_chars_i",
    # -- citation split (references_i above is the total)
    "references_internal_i",
    "references_external_i",
    # -- canonical/duplicate signals
    "canonical_equal_sku_b",
    "exact_signature_l",
    "fuzzy_signature_l",
    "exact_signature_copycount_i",
    "fuzzy_signature_copycount_i",
    "title_unique_b",
    "description_unique_b",
    "exact_signature_unique_b",
    "fuzzy_signature_unique_b",
    # -- transport
    "responsetime_i",
    # -- structure counts (schema long tail)
    "csscount_i",
    "scriptscount_i",
    "licount_i", "dtcount_i", "ddcount_i", "articlecount_i",
    "boldcount_i", "italiccount_i", "underlinecount_i",
    "framesscount_i",
    "iframesscount_i",
    "flash_b",
    # -- per-field signatures + protocol/www duplicate detection
    "title_exact_signature_l",
    "description_exact_signature_l",
    "http_unique_b",           # this doc is the unique http(s) variant
    "www_unique_b",            # this doc is the unique www/non-www variant
    # -- shape counts
    "title_chars_val",
    "description_chars_val",
    "host_extent_i",           # docs this host contributes to the index
    # -- citation-rank bookkeeping + misc
    "cr_host_count_i",
    "cr_host_norm_i",      # integer citation-rank partition (0..9)
    "rating_i",
    "schema_org_breadcrumb_i",
    # -- content freshness date (day granularity, like the other dates)
    "fresh_date_days_i",
)
DOUBLE_FIELDS = (
    "lat_d",
    "lon_d",
    "cr_host_norm_d",      # citation rank (postprocessing)
    "cr_host_chance_d",    # citation-rank transition probability
)

# Reference schema names whose CONTENT this store carries under a
# different representation (checklist closure against
# CollectionSchema.java:34 — these are API aliases, not absent fields):
# readers resolve them through LazyRow.get / schema surfaces, writers use
# the canonical column.
FIELD_ALIASES = {
    "id": "urlhash",                      # docid IS the urlhash alias
    "last_modified": "last_modified_days_i",   # ISO date -> day number
    "load_date_dt": "load_date_days_i",
    "fresh_date_dt": "fresh_date_days_i",
    "coordinate_p": ("lat_d", "lon_d"),   # "lat,lon" point
    "coordinate_p_0_coordinate": "lat_d",
    "coordinate_p_1_coordinate": "lon_d",
}


def schema_field_names() -> list[str]:
    """Every reference-schema-visible field name this store serves
    (columns + representation aliases) — the parity surface
    tests/test_schema_longtail.py checks against CollectionSchema."""
    return sorted(set(TEXT_FIELDS) | set(INT_FIELDS) | set(DOUBLE_FIELDS)
                  | set(FIELD_ALIASES))


def join_multi(values) -> str:
    """Join a multi-valued field for storage (see MULTI_SEP)."""
    return MULTI_SEP.join(v.replace(MULTI_SEP, " ") for v in values if v)


def split_multi(value: str) -> list[str]:
    return [v for v in value.split(MULTI_SEP) if v] if value else []


def join_multi_positional(values) -> str:
    """Positional variant: EMPTY entries survive, so two parallel arrays
    (e.g. images_urlstub_sxt + images_alt_sxt) stay index-aligned."""
    return MULTI_SEP.join((v or "").replace(MULTI_SEP, " ")
                          for v in values)


def split_multi_positional(value: str) -> list[str]:
    return value.split(MULTI_SEP) if value else []


class DocumentMetadata:
    """One document's metadata row (dict-backed, schema-checked)."""

    __slots__ = ("urlhash", "fields")

    def __init__(self, urlhash: bytes, **fields):
        self.urlhash = urlhash
        self.fields = fields
        for k in fields:
            if k not in TEXT_FIELDS and k not in INT_FIELDS and k not in DOUBLE_FIELDS:
                raise KeyError(f"unknown metadata field: {k}")

    def get(self, k, default=None):
        return self.fields.get(k, default)


class LazyRow:
    """Read-on-demand view of one doc's metadata (DocumentMetadata.get
    interface over the live columns; no row materialization)."""

    __slots__ = ("_store", "_docid", "urlhash")

    def __init__(self, store: "MetadataStore", docid: int):
        self._store = store
        self._docid = docid
        self.urlhash = store.urlhash_of(docid)

    def get(self, k, default=None):
        s, d = self._store, self._docid
        if k in s._text:
            return s._get_text(d, k)
        if k in s._ints:
            return s._get_int(d, k)
        if k in s._doubles:
            return s._get_double(d, k)
        alias = FIELD_ALIASES.get(k)
        if alias == "urlhash":
            return (self.urlhash or b"").decode("ascii", "replace")
        if alias == ("lat_d", "lon_d"):
            return f"{s._get_double(d, 'lat_d')},{s._get_double(d, 'lon_d')}"
        if alias is not None:
            return self.get(alias, default)
        return default


# low-cardinality columns carrying query modifiers (site:/filetype:/
# protocol:): an inverted value->docids index turns the per-row filter
# loop into a per-distinct-value loop + one isin
FACET_FIELDS = ("host_s", "url_file_ext_s", "url_protocol_s")


class MetadataStore:
    """docid-addressed columnar store with urlhash identity index
    (memory-only: every docid is a row of the RAM columns)."""

    def __init__(self, data_dir: str | None = None):
        if data_dir:
            raise NotImplementedError(
                "the port's MetadataStore is memory-only: persistence "
                "(segment files, journal, replay) is not ported yet")
        self._lock = threading.RLock()
        self._tail_hashes: list[bytes] = []
        self._tail_map: dict[bytes, int] = {}
        self._text: dict[str, list] = {f: [] for f in TEXT_FIELDS}
        self._ints: dict[str, list] = {f: [] for f in INT_FIELDS}
        self._doubles: dict[str, list] = {f: [] for f in DOUBLE_FIELDS}
        self._deleted: set[int] = set()
        self._facets: dict[str, dict[str, list[int]]] = {
            f: {} for f in FACET_FIELDS}
        # bumped on every mutation that can change facet membership —
        # the device filter-bitmap cache keys on it
        self.facet_version = 0

    # -- write ---------------------------------------------------------------

    def put(self, doc: DocumentMetadata) -> int:
        """Insert by urlhash; returns the docid.

        Re-putting an existing urlhash allocates a NEW docid and marks the
        old row deleted (versioned append), so that RWI tombstones for the
        old docid stay valid forever; the dead row's text payload is
        blanked.
        """
        with self._lock:
            self.facet_version += 1
            old = self.docid(doc.urlhash)
            if old is not None:
                self._deleted.add(old)
                for f in TEXT_FIELDS:
                    self._text[f][old] = ""
            docid = len(self._tail_hashes)
            self._tail_map[doc.urlhash] = docid
            self._tail_hashes.append(doc.urlhash)
            for f in TEXT_FIELDS:
                self._text[f].append(doc.get(f, ""))
            for f in INT_FIELDS:
                self._ints[f].append(int(doc.get(f, 0)))
            for f in DOUBLE_FIELDS:
                self._doubles[f].append(float(doc.get(f, 0.0)))
            for f in FACET_FIELDS:
                v = str(doc.get(f, "") or "").lower()
                if v:
                    self._facets[f].setdefault(v, []).append(docid)
            return docid

    def bulk_load(self, urlhashes: list[bytes], **columns) -> int:
        """Bulk-append rows column-wise (one list extend per column instead
        of per-document put()). Unlisted columns fill with defaults;
        urlhashes must be new. Returns the first allocated docid."""
        n = len(urlhashes)
        for name, col in columns.items():
            if name not in TEXT_FIELDS and name not in INT_FIELDS \
                    and name not in DOUBLE_FIELDS:
                raise KeyError(f"unknown metadata field: {name}")
            if len(col) != n:
                raise ValueError(f"column {name}: {len(col)} rows != {n}")
        with self._lock:
            self.facet_version += 1
            base = len(self._tail_hashes)
            self._tail_map.update(
                (uh, base + i) for i, uh in enumerate(urlhashes))
            self._tail_hashes.extend(urlhashes)
            for f in TEXT_FIELDS:
                self._text[f].extend(columns.get(f) or [""] * n)
            for f in INT_FIELDS:
                self._ints[f].extend(columns.get(f) or [0] * n)
            for f in DOUBLE_FIELDS:
                self._doubles[f].extend(columns.get(f) or [0.0] * n)
            for f in FACET_FIELDS:
                col = columns.get(f)
                if col:
                    idx = self._facets[f]
                    for i, v in enumerate(col):
                        v = str(v or "").lower()
                        if v:
                            idx.setdefault(v, []).append(base + i)
            return base

    def set_field(self, docid: int, field: str, value) -> None:
        """Postprocessing update (e.g. references_i from the citation index)."""
        self.set_fields(docid, **{field: value})

    def set_fields(self, docid: int, **fields) -> None:
        """Batched postprocessing update; unchanged values are skipped."""
        with self._lock:
            self.facet_version += 1
            for field, value in fields.items():
                if field in INT_FIELDS:
                    value = int(value)
                elif field in DOUBLE_FIELDS:
                    value = float(value)
                elif field not in TEXT_FIELDS:
                    raise KeyError(field)
                old = self._get_value(docid, field)
                if old == value:
                    continue
                if field in FACET_FIELDS:
                    self._facet_update_locked(field, docid, old, value)
                if field in INT_FIELDS:
                    self._ints[field][docid] = value
                elif field in DOUBLE_FIELDS:
                    self._doubles[field][docid] = value
                else:
                    self._text[field][docid] = value

    def _facet_update_locked(self, field: str, docid: int, old, new) -> None:
        old_v = str(old or "").lower()
        new_v = str(new or "").lower()
        if old_v and docid in self._facets[field].get(old_v, ()):
            self._facets[field][old_v].remove(docid)
        if new_v:
            self._facets[field].setdefault(new_v, []).append(docid)

    def delete(self, urlhash: bytes) -> int | None:
        with self._lock:
            self.facet_version += 1
            docid = self.docid(urlhash)
            if docid is not None:
                self._deleted.add(docid)
            return docid

    # -- low-level reads -----------------------------------------------------

    def _get_text(self, docid: int, field: str) -> str:
        with self._lock:
            return self._text[field][docid]

    def _get_int(self, docid: int, field: str) -> int:
        with self._lock:
            return self._ints[field][docid]

    def _get_double(self, docid: int, field: str) -> float:
        with self._lock:
            return self._doubles[field][docid]

    def _get_value(self, docid: int, field: str):
        if field in INT_FIELDS:
            return self._get_int(docid, field)
        if field in DOUBLE_FIELDS:
            return self._get_double(docid, field)
        return self._get_text(docid, field)

    # -- read ----------------------------------------------------------------

    def text_value(self, docid: int, field: str) -> str:
        """Single text column read — the query-path accessor."""
        return self._get_text(docid, field)

    def text_values(self, docids, field: str) -> list[str]:
        """Batched text reads."""
        with self._lock:
            col = self._text[field]
            return [col[d] for d in docids]

    def int_values(self, docids, field: str) -> list[int]:
        """Batched int reads."""
        with self._lock:
            col = self._ints[field]
            return [col[d] for d in docids]

    def docid(self, urlhash: bytes) -> int | None:
        with self._lock:
            d = self._tail_map.get(urlhash)
            return None if d is None or d in self._deleted else d

    def urlhash_of(self, docid: int) -> bytes:
        with self._lock:
            return self._tail_hashes[docid]

    def exists(self, urlhash: bytes) -> bool:
        return self.docid(urlhash) is not None

    def is_deleted(self, docid: int) -> bool:
        return docid in self._deleted

    def row(self, docid: int) -> "LazyRow | None":
        """Column-backed row view: reads fields on demand."""
        if docid is None or docid >= self.capacity() \
                or docid in self._deleted:
            return None
        return LazyRow(self, docid)

    def get(self, docid: int) -> DocumentMetadata | None:
        with self._lock:
            if docid is None or docid >= self.capacity() \
                    or docid in self._deleted:
                return None
            fields = {}
            for f in TEXT_FIELDS:
                fields[f] = self._get_text(docid, f)
            for f in INT_FIELDS:
                fields[f] = self._get_int(docid, f)
            for f in DOUBLE_FIELDS:
                fields[f] = self._get_double(docid, f)
            return DocumentMetadata(self.urlhash_of(docid), **fields)

    def get_by_urlhash(self, urlhash: bytes) -> DocumentMetadata | None:
        d = self.docid(urlhash)
        return None if d is None else self.get(d)

    def __len__(self) -> int:
        with self._lock:
            return self.capacity() - len(self._deleted)

    def capacity(self) -> int:
        """Highest docid + 1 (dense device columns size to this)."""
        with self._lock:
            return len(self._tail_hashes)

    # -- device columns ------------------------------------------------------

    def int_column(self, field: str) -> np.ndarray:
        """A numeric field as int32 [capacity] (deleted rows zeroed)."""
        with self._lock:
            col = np.zeros(self.capacity(), dtype=np.int32)
            if self._tail_hashes:
                col[:] = np.asarray(self._ints[field], dtype=np.int32)
            if self._deleted:
                col[list(self._deleted)] = 0
            return col

    def alive_mask(self) -> np.ndarray:
        with self._lock:
            m = np.ones(self.capacity(), dtype=bool)
            if self._deleted:
                m[list(self._deleted)] = False
            return m

    def facet_docids(self, field: str, match) -> np.ndarray:
        """Sorted docids whose `field` value satisfies `match` (a value
        string for equality, or a predicate over the lowercased value).
        Iterates DISTINCT VALUES, not rows. Deleted docids are excluded."""
        with self._lock:
            lists: list[np.ndarray] = []
            idx = self._facets[field]
            if callable(match):
                lists += [np.asarray(d, np.int32)
                          for v, d in idx.items() if d and match(v)]
            else:
                d = idx.get(str(match).lower())
                if d:
                    lists.append(np.asarray(d, np.int32))
            if not lists:
                return np.empty(0, np.int32)
            out = np.sort(np.concatenate(lists))
            if self._deleted and len(out):
                out = out[self._alive_array()[out]]
            return out

    def _alive_array(self) -> np.ndarray:
        """Cached per-docid liveness (caller holds the lock): rebuilt only
        when deletions changed."""
        cached = getattr(self, "_alive_cache", None)
        if cached is not None and cached[0] == len(self._deleted) \
                and len(cached[1]) >= self.capacity():
            return cached[1]
        m = np.ones(self.capacity(), dtype=bool)
        if self._deleted:
            m[np.fromiter(self._deleted, dtype=np.int64,
                          count=len(self._deleted))] = False
        self._alive_cache = (len(self._deleted), m)
        return m

    def hosthash_groups(self) -> dict[bytes, list[int]]:
        """hosthash -> docids (authority/doubledom signals)."""
        with self._lock:
            groups: dict[bytes, list[int]] = {}
            for docid, uh in enumerate(self._tail_hashes):
                if docid in self._deleted:
                    continue
                groups.setdefault(hosthash(uh), []).append(docid)
            return groups



def metadata_from_parsed(urlhash: bytes, url: str, title: str, text: str,
                         **extra) -> DocumentMetadata:
    """Convenience constructor filling derived fields (domlength etc.)."""
    fields = dict(
        sku=url,
        title=title,
        text_t=text,
        domlength_i=dom_length_normalized(urlhash),
        urllength_i=len(url),
        urlcomps_i=url_comps(url),
        load_date_days_i=int(time.time() // 86400),
    )
    fields.update(extra)
    return DocumentMetadata(urlhash, **fields)
