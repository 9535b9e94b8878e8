"""DHT partition math — horizontal (term) ring x vertical (doc) partitions.

Port of yacy_search_server_tpu/parallel/distribution.py (it imports no
JAX; the port keeps its own copy on its own utils/base64order), used by
index/meshstore.term_shard to place a term on its mesh row.

Bit-compatible re-implementation of the reference's partition model
(reference: source/net/yacy/cora/federate/yacy/Distribution.java:35-93):

- horizontal position: base64 cardinal of the word hash -> [0, 2^63)
- ring distance: closed-at-the-end cardinal distance
- vertical partitions: 2^e sub-shards selected by the *url* hash, so one
  url's postings land on the same vertical position for every word.

TPU-first additions: bulk numpy projections for whole postings batches
(used when routing an index-transfer buffer) and the mapping of the
vertical axis onto a device-mesh axis (parallel/mesh.py) — the 16 vertical
partitions of the freeworld network become 16-way data parallelism at
query time.
"""

from __future__ import annotations

import numpy as np

from ..utils.base64order import enhanced_coder

LONG_MAX = (1 << 63) - 1


def horizontal_dht_position(word_hash: bytes) -> int:
    """Word hash -> cardinal ring position in [0, 2^63)."""
    return enhanced_coder.cardinal(word_hash)


def horizontal_dht_distance(from_pos: int, to_pos: int) -> int:
    """Closed-ring distance from `from_pos` forward to `to_pos`."""
    if to_pos >= from_pos:
        return to_pos - from_pos
    return (LONG_MAX - from_pos) + to_pos + 1


def horizontal_positions_bulk(word_hashes: np.ndarray) -> np.ndarray:
    """uint8 [n, 12] hash array -> int64 [n] ring positions."""
    return enhanced_coder.cardinal_array(word_hashes)


class Distribution:
    """Vertical (doc-hash) partitioning on top of the horizontal ring."""

    def __init__(self, vertical_partition_exponent: int):
        self.vertical_partition_exponent = vertical_partition_exponent
        self.partition_count = 1 << vertical_partition_exponent
        self.shift_length = 63 - vertical_partition_exponent
        self.partition_size = 1 << self.shift_length
        self.partition_mask = self.partition_size - 1

    def vertical_partitions(self) -> int:
        return self.partition_count

    def vertical_dht_partition(self, url_hash: bytes) -> int:
        """Which of the 2^e vertical partitions this url belongs to."""
        return int(enhanced_coder.cardinal(url_hash) >> self.shift_length)

    def vertical_dht_position(self, word_hash: bytes, vertical_partition: int) -> int:
        """Ring position of (word, partition): word position folded into the
        partition's segment of the ring."""
        h = horizontal_dht_position(word_hash)
        return (h & self.partition_mask) | (vertical_partition << self.shift_length)

    def vertical_partitions_bulk(self, url_hashes: np.ndarray) -> np.ndarray:
        """uint8 [n, 12] url-hash array -> int32 [n] partition ids.

        This is the routing primitive of the DHT dispatcher: one call
        splits a whole postings container by target partition
        (replacing the reference's per-entry splitContainer loop,
        peers/Dispatcher.java:234).
        """
        pos = enhanced_coder.cardinal_array(url_hashes)
        return (pos >> self.shift_length).astype(np.int32)
