"""Bloom filters over k-mer hash values (the port's copy of
bionumpy_tpu/sequence/bloom_filter.py).

Same membership semantics as the reference (xor-offset hash family,
boolean mask, AND across hash functions — reference:
bionumpy/sequence/bloom_filter.py:21-61), vectorized over the hash
family: slots for every (kmer, hash) pair are computed as one stacked
array so insert/query are single fancy-index operations instead of
per-function Python loops.
"""
from __future__ import annotations

import numpy as np


def hash_function(offset):
    """The xor-offset hash family member used by from_m_and_k."""
    def apply(kmer):
        return np.asarray(kmer) ^ offset
    return apply


class BloomFilter:
    """Approximate k-mer membership: no false negatives, false-positive
    rate set by mask size / hash count."""

    def __init__(self, mask_size, hash_functions):
        self._hash_functions = list(hash_functions)
        self._mask = np.zeros(mask_size, dtype=bool)

    @classmethod
    def from_m_and_k(cls, m, k, seed=12345):
        """m-bit mask with k xor-offset hash functions."""
        offsets = np.random.RandomState(seed).randint(0, m, k)
        return cls(m, [hash_function(o) for o in offsets])

    @classmethod
    def from_hash_functions_and_sequences(cls, hash_functions, kmers,
                                          mask_size):
        filt = cls(mask_size, hash_functions)
        filt.insert(kmers)
        return filt

    # reference spelling kept for compatibility
    from_hash_functions_and_seqeuences = from_hash_functions_and_sequences

    def _slots(self, kmers):
        """(n_hash, ...) mask positions for every (hash, kmer) pair."""
        return np.stack([np.asarray(h(kmers))
                         for h in self._hash_functions]) % self._mask.size

    def insert(self, kmers):
        self._mask[self._slots(kmers)] = True

    def __getitem__(self, kmers):
        return self._mask[self._slots(kmers)].all(axis=0)


class InterleavedBloomFilter:
    """One bloom column per sequence: query (kmer, sequence_index)
    pairs; rows are mask slots, columns sequences."""

    def __init__(self, hash_functions, mask):
        self._hash_functions = list(hash_functions)
        self._mask = mask

    @classmethod
    def from_hash_functions_and_sequences(cls, hash_functions, sequences,
                                          mask_size):
        mask = np.zeros((mask_size, len(sequences)), dtype=bool)
        filt = cls(hash_functions, mask)
        for column, kmers in enumerate(sequences):
            mask[filt._slots(kmers), column] = True
        return filt

    from_hash_functions_and_seqeuences = from_hash_functions_and_sequences

    def _slots(self, kmers):
        return np.stack([np.asarray(h(kmers))
                         for h in self._hash_functions]) \
            % self._mask.shape[0]

    def __getitem__(self, idx):
        kmer, seq_idx = idx
        return self._mask[self._slots(kmer), seq_idx].all(axis=0)
