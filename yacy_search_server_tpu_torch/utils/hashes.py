"""Word and URL hashing — identity layer of the whole framework.

Reference behavior being reproduced (not the implementation):
- word hash: 12 base64(enhanced) chars of MD5(lowercased word)
  (reference: source/net/yacy/kelondro/data/word/Word.java:113-130)
- URL hash: 12 chars =
    [0:5]  base64(MD5(normalized url))        -- the "local" part
    [5]    hash of subdomain+port+rootpath    -- 1 char
    [6:11] host hash ("hosthash5")            -- the "global" part
    [11]   flag byte: protocol | domain-id | dom-length-key
  (reference: source/net/yacy/cora/document/id/DigestURL.java urlHashComputation)
- hosthash of a url hash = chars [6:12] (DigestURL.java:61-100)
- domain-length estimation decoded from the flag byte
  (DigestURL.java:352-375) feeding the ranking's domlength signal.

The layout is kept so DHT partition routing (horizontal by word hash,
vertical by url hash — Distribution.java) and host-grouping semantics
(hosthash prefix match) behave like the reference's network.

The port's copy of the JAX package's utils/hashes.py (numpy and stdlib
only), so that the port imports nothing of that package.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from urllib.parse import urlsplit

from .base64order import enhanced_coder

COMMON_HASH_LENGTH = 12
HOST_HASH_LENGTH = 6

_PRIVATE_PREFIX = b"_____"


@lru_cache(maxsize=100_000)
def word2hash(word: str) -> bytes:
    """12-char base64 hash of a (lowercased) word. Ring key of the RWI."""
    wordlc = word.lower()
    h = enhanced_coder.encode_substring(
        hashlib.md5(wordlc.encode("utf-8")).digest(), COMMON_HASH_LENGTH
    )
    # keep the '_____'-prefixed range reserved for private/local hashes
    while h[:5] == _PRIVATE_PREFIX:
        h = h[1:] + b"A"
    return h


def word_hashes(words: list[str]) -> list[bytes]:
    """Batch word2hash (the JAX package's native C++ batch is not part of
    the port: the lru-cached Python path gives the same bytes)."""
    return [word2hash(w) for w in words]


def _md5_b64(s: str) -> bytes:
    return enhanced_coder.encode(hashlib.md5(s.encode("utf-8")).digest())


def hosthash5(protocol: str, host: str, port: int) -> bytes:
    """5-char host hash — the 'global' part shared by all urls of a host."""
    return _md5_b64(f"{protocol}:{host}:{port}")[:5]


def _subdom_port_path_char(subdom: str, port: int, rootpath: str) -> bytes:
    return _md5_b64(f"{subdom}:{port}:{rootpath}")[:1]


def _split_host(host: str) -> tuple[str, str]:
    """Return (subdomain, domain-without-tld)."""
    if not host or ":" in host:
        return "", ""
    p = host.rfind(".")
    dom = host[:p] if p > 0 else ""
    p = dom.rfind(".")
    if p <= 0:
        return "", dom
    return dom[:p], dom[p + 1 :]


def _split(url: str):
    """(scheme, host, port, path, query) with malformed urls tolerated —
    scraped hrefs must never crash the identity layer."""
    try:
        parts = urlsplit(url)
    except ValueError:
        # e.g. unbalanced-bracket IPv6 literal; treat as opaque path
        return "http", "", 80, "/" + url, ""
    scheme = (parts.scheme or "http").lower()
    try:
        host = (parts.hostname or "").lower()
    except ValueError:
        host = ""
    try:
        port = parts.port or default_port(scheme)
    except ValueError:
        port = default_port(scheme)
    return scheme, host, port, parts.path or "/", parts.query


def safe_host(url: str) -> str:
    """Hostname of a possibly-malformed url, lowercased; '' when absent."""
    return _split(url)[1]


def url_file_ext(url: str) -> str:
    """File extension of the url path, lowercased, capped at 8 chars;
    '' when the file name has none (CollectionSchema.url_file_ext_s /
    WebgraphSchema.target_file_ext_s normalization)."""
    path = _split(url)[3]
    name = path.rsplit("/", 1)[-1]
    return name.rsplit(".", 1)[-1].lower()[:8] if "." in name else ""


def normalform(url: str) -> str:
    scheme, host, port, path, query = _split(url)
    netloc = host if port == default_port(scheme) else f"{host}:{port}"
    q = f"?{query}" if query else ""
    return f"{scheme}://{netloc}{path}{q}"


def default_port(scheme: str) -> int:
    return {"http": 80, "https": 443, "ftp": 21, "smb": 445, "file": 0}.get(scheme, 80)


def url2hash(url: str) -> bytes:
    """12-char url hash with the reference's positional layout."""
    scheme, host, port, path, _ = _split(url)
    subdom, dom = _split_host(host)

    rootpath_start = 1 if path.startswith("/") else 0
    rootpath_end = len(path) - 2 if path.endswith("/") else len(path) - 1
    p = path.find("/", rootpath_start)
    rootpath = path[rootpath_start:p] if 0 < p < rootpath_end else ""

    l = len(dom)
    domlength_key = 0 if l <= 8 else 1 if l <= 12 else 2 if l <= 16 else 3
    is_http = scheme in ("http", "https")
    # domain-id: the reference resolves DNS to classify local/global nets
    # (Domains.getDomainID); here: 7 marks intranet-style hosts, 0 global.
    dom_id = 7 if (not dom or host in ("localhost", "127.0.0.1")) else 0
    flagbyte = (0 if is_http else 32) | (dom_id << 2) | domlength_key

    h = bytearray()
    h += _md5_b64(normalform(url))[:5]
    h += _subdom_port_path_char(subdom, port, rootpath)
    h += hosthash5(scheme, host, port)
    h += enhanced_coder.encode_long(flagbyte, 1)
    assert len(h) == COMMON_HASH_LENGTH
    return bytes(h)


def hosthash(urlhash: bytes) -> bytes:
    """6-char host hash part of a url hash (positions 6..12)."""
    return urlhash[6:12]


def url_comps(url: str) -> int:
    """Number of url path/host components — the single source for the
    `urlcomps` ranking signal (postings column and metadata column must
    agree, or the same doc scores differently per read path)."""
    return min(len([c for c in url.split("/") if c]), 255)


def dom_length_estimation(urlhash: bytes) -> int:
    """Estimated domain length from the url-hash flag byte."""
    flagbyte = enhanced_coder.decode_byte(urlhash[11])
    return {0: 4, 1: 10, 2: 14, 3: 20}.get(flagbyte & 3, 20)


def dom_length_normalized(urlhash: bytes) -> int:
    # NB: reproduces the reference expression `domLengthEstimation(h) << 8 / 20`
    # which Java parses as `est << (8 / 20)` == est << 0 == est.
    return dom_length_estimation(urlhash)


def is_local_urlhash(urlhash: bytes) -> bool:
    flagbyte = enhanced_coder.decode_byte(urlhash[11])
    return ((flagbyte >> 2) & 7) == 7


def host_dnc(host: str) -> tuple[str, str]:
    """(dnc, organizationdnc): the reversed "domain name core" pair
    (reference Domains.getDNC — "www.example.com" -> dnc "com.example",
    organizationdnc "com.example.www"). Dotless hosts ("localhost") have
    no core: both come back empty."""
    if not host or "." not in host:
        return "", ""
    _sub, org = _split_host(host)
    tld = host.rsplit(".", 1)[-1]
    dnc = ".".join(reversed([p for p in (org, tld) if p]))
    return dnc, ".".join(reversed(host.split(".")))
