"""K-mer -> read-index lookup (reference:
bionumpy/sequence/indexing/kmer_indexing.py; the port's copy of
bionumpy_tpu/sequence/indexing/kmer_indexing.py).  The k-mers of the
indexed sequences and of each string query come from get_kmers, which
runs the kmer_keys kernel on `device` (None is the card)."""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from ...encoded_array import EncodedRaggedArray, as_encoded_array
from ..kmers import get_kmers


class KmerIndex:
    def __init__(self, k, lookup, sequences_encoding, device=None):
        self._k = k
        self._lookup = lookup
        self._sequences_encoding = sequences_encoding
        self._device = device

    def __repr__(self):
        return f"{self._k}-merIndex of sequences with " \
               f"{self._sequences_encoding}"

    @property
    def k(self) -> int:
        return self._k

    @classmethod
    def create_index(cls, sequences: EncodedRaggedArray, k: int,
                     device=None) -> "KmerIndex":
        kmers = get_kmers(sequences, k, device=device).raw()
        flat = np.asarray(kmers.ravel())
        rows = np.repeat(np.arange(len(kmers)), kmers.lengths)
        order = np.argsort(flat, kind="stable")
        sorted_kmers = flat[order]
        sorted_rows = rows[order]
        boundaries = np.flatnonzero(
            np.concatenate([[True], sorted_kmers[1:] != sorted_kmers[:-1]]))
        lookup = defaultdict(lambda: np.empty(0, dtype=np.int64))
        splits = np.split(sorted_rows, boundaries[1:])
        for start, group in zip(boundaries, splits):
            lookup[int(sorted_kmers[start])] = np.unique(group)
        return cls(k, lookup, sequences.encoding, device)

    def get_indices(self, kmer):
        if isinstance(kmer, str):
            assert len(kmer) == self._k
            encoded = get_kmers(
                as_encoded_array(kmer, self._sequences_encoding),
                self._k, device=self._device).raw()
            return self._lookup[int(np.asarray(encoded)[0])]
        return self._lookup[int(kmer)]


class KmerLookup:
    index_class = KmerIndex

    def __init__(self, kmer_index, sequences: EncodedRaggedArray):
        self._kmer_index = kmer_index
        self._sequences = sequences

    def __repr__(self):
        return (f"Lookup on {self._kmer_index.k}-merIndex of "
                f"{len(self._sequences)} sequences")

    @classmethod
    def create_lookup(cls, sequences: EncodedRaggedArray, *args,
                      **kwargs) -> "KmerLookup":
        index = cls.index_class.create_index(sequences=sequences, *args,
                                             **kwargs)
        return cls(index, sequences)

    def get_sequences(self, kmer):
        return self._sequences[self._kmer_index.get_indices(kmer)]
