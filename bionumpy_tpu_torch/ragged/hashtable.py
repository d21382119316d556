"""Static key->value hash table (reference: npstructures.HashTable used
at bionumpy/util/ascii_hash.py:59-84; the port's copy of
bionumpy_tpu/ragged/hashtable.py).

Implemented as sorted-key binary search instead of open addressing: one
sort at build, one vectorized searchsorted per query batch."""
from __future__ import annotations

import numpy as np


class HashTable:
    def __init__(self, keys, values, mod=None):
        keys = np.asarray(keys)
        values = np.asarray(values)
        assert len(keys) == len(values)
        order = np.argsort(keys, kind="stable")
        self._sorted_keys = keys[order]
        self._sorted_values = values[order]
        self._mod = mod

    def _positions(self, keys):
        keys = np.asarray(keys)
        pos = np.searchsorted(self._sorted_keys, keys)
        return np.minimum(pos, max(len(self._sorted_keys) - 1, 0))

    def contains(self, keys) -> np.ndarray:
        if len(self._sorted_keys) == 0:
            return np.zeros(np.asarray(keys).shape, dtype=bool)
        return self._sorted_keys[self._positions(keys)] == keys

    def __getitem__(self, keys):
        pos = self._positions(keys)
        if len(self._sorted_keys) == 0 or \
                not np.all(self._sorted_keys[pos] == keys):
            raise IndexError("key(s) not in table")
        return self._sorted_values[pos]

    def __len__(self):
        return len(self._sorted_keys)
