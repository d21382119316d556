"""ASCII polynomial row hashing + hash-table lookup (reference:
bionumpy/util/ascii_hash.py).

The TPU build's StringEncoding uses the same row-hash plus a sorted-key
searchsorted instead of an open hash table; this module keeps the
reference's names for compatibility."""
from __future__ import annotations

import numpy as np

from ..encodings.string_encodings import ascii_row_hash as get_ascii_hash


class AsciiHashTable:
    """Maps byte-string rows to their index in the construction set."""

    big_mod = (2 ** 31) - 1

    def __init__(self, sorted_hashes, sorted_values, sequences):
        self._sorted_hashes = sorted_hashes
        self._sorted_values = sorted_values
        self._sequences = sequences

    @classmethod
    def from_sequences(cls, encoded_ragged_array, modulo: int = 103):
        hashes = get_ascii_hash(encoded_ragged_array)
        assert len(set(hashes.tolist())) == len(hashes), \
            "hash collision among keys"
        order = np.argsort(hashes, kind="stable")
        return cls(hashes[order], order.astype(np.int64),
                   encoded_ragged_array)

    def contains(self, hashes) -> np.ndarray:
        pos = np.searchsorted(self._sorted_hashes, hashes)
        pos = np.minimum(pos, len(self._sorted_hashes) - 1)
        return self._sorted_hashes[pos] == hashes

    def __getitem__(self, encoded_array):
        hashes = get_ascii_hash(encoded_array)
        pos = np.searchsorted(self._sorted_hashes, hashes)
        pos_clipped = np.minimum(pos, len(self._sorted_hashes) - 1)
        found = self._sorted_hashes[pos_clipped] == hashes
        if not np.all(found):
            raise IndexError(
                f"missing keys; available: {self._sequences}")
        return self._sorted_values[pos_clipped]
