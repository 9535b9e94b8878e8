"""Base64 ordering, encoding and cardinal projection.

TPU-native re-design of the reference's byte-order substrate
(reference: source/net/yacy/cora/order/Base64Order.java). The DHT ring
position of every term and document is derived from the *cardinal* of its
base64 hash (reference: source/net/yacy/cora/federate/yacy/Distribution.java:74-78),
so this module is kept bit-compatible with the reference:

- alphabet "enhanced" (filename-safe): A-Za-z0-9-_  (Base64Order.java:38)
- alphabet "standard" (rfc1521):       A-Za-z0-9+/  (Base64Order.java:37)
- cardinal(key): first 10 base64 chars -> 60 bits, shifted left 3, OR 7,
  producing a value in [0, 2^63) (Base64Order.java:307-325 `cardinalI`).

Unlike the reference (per-byte Java loops), bulk variants here are
vectorized with numpy so millions of hashes can be projected onto the DHT
ring in one shot — that array then feeds device-side partition routing.

The port's copy of the JAX package's module of the same name.
"""

from __future__ import annotations

import numpy as np

ALPHA_STANDARD = b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"
ALPHA_ENHANCED = b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_"

LONG_MAX = (1 << 63) - 1


def _inverse(alpha: bytes) -> np.ndarray:
    # 256 entries so any byte value indexes in-range and fails the v<0 check
    inv = np.full(256, -1, dtype=np.int16)
    for i, c in enumerate(alpha):
        inv[c] = i
    return inv


class Base64Order:
    """Order, codec and cardinal projection over a base64 alphabet."""

    def __init__(self, rfc1521compliant: bool = False):
        self.rfc1521compliant = rfc1521compliant
        self.alpha = ALPHA_STANDARD if rfc1521compliant else ALPHA_ENHANCED
        self.ahpla = _inverse(self.alpha)

    # -- codec ---------------------------------------------------------------

    def encode_long(self, value: int, length: int) -> bytes:
        """Encode an integer into `length` base64 chars, most significant first."""
        out = bytearray(length)
        for i in range(length - 1, -1, -1):
            out[i] = self.alpha[value & 0x3F]
            value >>= 6
        return bytes(out)

    def decode_long(self, key: bytes | str) -> int:
        if isinstance(key, str):
            key = key.encode("ascii")
        c = 0
        for b in key:
            v = int(self.ahpla[b])
            if v < 0:
                raise ValueError(f"not base64: {key!r}")
            c = (c << 6) | v
        return c

    def encode(self, data: bytes) -> bytes:
        """Encode bytes to base64. Non-rfc variant emits no '=' padding."""
        out = bytearray()
        n = len(data)
        i = 0
        while i + 3 <= n:
            x = (data[i] << 16) | (data[i + 1] << 8) | data[i + 2]
            out += self.encode_long(x, 4)
            i += 3
        rem = n - i
        if rem == 2:
            x = (data[i] << 16) | (data[i + 1] << 8)
            out += self.encode_long(x, 4)[:3]
            if self.rfc1521compliant:
                out += b"="
        elif rem == 1:
            x = data[i] << 16
            out += self.encode_long(x, 4)[:2]
            if self.rfc1521compliant:
                out += b"=="
        return bytes(out)

    def encode_substring(self, data: bytes, length: int) -> bytes:
        """First `length` chars of the base64 encoding (hash truncation)."""
        return self.encode(data)[:length]

    def decode(self, key: bytes | str) -> bytes:
        if isinstance(key, str):
            key = key.encode("ascii")
        key = key.rstrip(b"=")
        out = bytearray()
        i = 0
        n = len(key)
        while i + 4 <= n:
            x = self.decode_long(key[i : i + 4])
            out += bytes(((x >> 16) & 0xFF, (x >> 8) & 0xFF, x & 0xFF))
            i += 4
        rem = n - i
        if rem == 3:
            x = self.decode_long(key[i : i + 3]) << 6
            out += bytes(((x >> 16) & 0xFF, (x >> 8) & 0xFF))
        elif rem == 2:
            x = self.decode_long(key[i : i + 2]) << 12
            out += bytes(((x >> 16) & 0xFF,))
        elif rem == 1:
            raise ValueError(f"truncated base64 input (length % 4 == 1): {key!r}")
        return bytes(out)

    def decode_byte(self, b: int) -> int:
        v = int(self.ahpla[b])
        if v < 0:
            raise ValueError(f"not base64 char: {b}")
        return v

    # -- ordering ------------------------------------------------------------

    def compare(self, a: bytes, b: bytes) -> int:
        for x, y in zip(a, b):
            vx, vy = int(self.ahpla[x]), int(self.ahpla[y])
            if vx != vy:
                return -1 if vx < vy else 1
        return (len(a) > len(b)) - (len(a) < len(b))

    def wellformed(self, a: bytes) -> bool:
        return all(b < 128 and self.ahpla[b] >= 0 for b in a)

    # -- cardinal projection -------------------------------------------------

    def cardinal(self, key: bytes | str) -> int:
        """Project a base64 key onto [0, 2^63): 10 chars = 60 bits, <<3 | 7."""
        if isinstance(key, str):
            key = key.encode("ascii")
        c = 0
        lim = min(10, len(key))
        for i in range(lim):
            v = int(self.ahpla[key[i]])
            if v < 0:
                raise ValueError(f"not base64: {key!r}")
            c = (c << 6) | v
        c <<= 6 * (10 - lim)
        return (c << 3) | 7

    def uncardinal(self, c: int) -> bytes:
        """Inverse of cardinal (up to the 3 dropped low bits): 10 chars."""
        c >>= 3
        return self.encode_long(c, 10)

    def cardinal_array(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized cardinal over an array of fixed-width base64 keys.

        keys: uint8 array [n, width] of ascii base64 chars (width >= 1).
        Returns int64 [n] of ring positions. This is the bulk DHT-projection
        primitive that replaces the reference's per-key Java calls.
        """
        assert keys.ndim == 2
        vals = self.ahpla[keys.astype(np.int64)].astype(np.int64)
        if np.any(vals < 0):
            raise ValueError("non-base64 byte in key array")
        width = min(10, keys.shape[1])
        c = np.zeros(len(keys), dtype=np.int64)
        for i in range(width):
            c = (c << 6) | vals[:, i]
        c = c << (6 * (10 - width))
        return (c << 3) | 7


standard_coder = Base64Order(rfc1521compliant=True)
enhanced_coder = Base64Order(rfc1521compliant=False)


def hashes_to_uint8(hashes: list[bytes], width: int = 12) -> np.ndarray:
    """Pack a list of fixed-width hash byte-strings into a uint8 [n, width] array."""
    arr = np.frombuffer(b"".join(hashes), dtype=np.uint8)
    return arr.reshape(len(hashes), width)
