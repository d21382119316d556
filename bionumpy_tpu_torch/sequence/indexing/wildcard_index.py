"""Wildcard pattern index via per-letter position intersection
(reference: bionumpy/sequence/indexing/wildcard_index.py; the port's copy of
bionumpy_tpu/sequence/indexing/wildcard_index.py)."""
from __future__ import annotations

from functools import reduce

import numpy as np

from ...encoded_array import EncodedRaggedArray
from .kmer_indexing import KmerLookup


class WildCardIndex:
    def __init__(self, starts, ends, letter_map):
        self._starts = starts
        self._ends = ends
        self._letter_map = letter_map

    @classmethod
    def create_index(cls, sequences: EncodedRaggedArray) -> "WildCardIndex":
        flat = sequences.ravel()
        letter_map = {
            letter: np.flatnonzero(np.asarray(flat == letter))
            for letter in sequences.encoding.get_labels()}
        return cls(sequences.starts, sequences.ends, letter_map)

    def get_indices(self, pattern: str) -> np.ndarray:
        index_sets = (self._letter_map[letter] - index
                      for index, letter in enumerate(pattern)
                      if letter != ".")
        common = reduce(np.intersect1d, index_sets)
        seq_idx = np.searchsorted(self._starts, common, side="right") - 1
        mask = common + len(pattern) <= self._ends[seq_idx]
        return np.unique(seq_idx[mask])


class WildCardLookup(KmerLookup):
    index_class = WildCardIndex

    def __repr__(self):
        return f"Lookup on WildcardIndex of {len(self._sequences)} sequences"
