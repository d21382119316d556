"""K-mer label-space encoding (the port's copy of
bionumpy_tpu/encodings/kmer_encodings.py).

The hash convention matches the reference exactly: little-endian polynomial
``hash = sum(code_i * alphabet_size**i)`` where ``code_0`` is the first base
of the window.  The port's kmer_keys kernel (ops/kmer_kernels.py) produces the same
values from 2-bit-packed words, as one int64 key per window.
"""
from __future__ import annotations

from typing import List, Union

import numpy as np

from ..encoded_array import (EncodedArray, EncodedRaggedArray, Encoding)
from ..ragged import RaggedArray
from .alphabet_encoding import AlphabetEncoding


class KmerEncoding(Encoding):
    def __init__(self, alphabet_encoding: AlphabetEncoding, k: int):
        assert isinstance(alphabet_encoding, AlphabetEncoding), alphabet_encoding
        self._alphabet_encoding = alphabet_encoding
        self._k = int(k)

    @property
    def k(self) -> int:
        return self._k

    @property
    def alphabet_encoding(self) -> AlphabetEncoding:
        return self._alphabet_encoding

    def encode(self, data: Union[str, list, EncodedRaggedArray]):
        n = self._alphabet_encoding.alphabet_size
        powers = n ** np.arange(self._k, dtype=np.int64)
        if isinstance(data, str):
            assert len(data) == self._k
            letters = self._alphabet_encoding.encode(data).raw().astype(np.int64)
            return EncodedArray(letters.dot(powers), self)
        if isinstance(data, (list, EncodedRaggedArray)):
            assert all(len(row) == self._k for row in data)
            letters = self._alphabet_encoding.encode(data).raw()
            if isinstance(letters, RaggedArray):
                letters = letters.to_numpy_array()
            return EncodedArray(letters.astype(np.int64).dot(powers), self)
        raise NotImplementedError(f"cannot kmer-encode {type(data)}")

    def to_string(self, kmer) -> str:
        if np.asarray(kmer).ndim > 0:
            return ",".join(self.to_string(k) for k in kmer)
        kmer = int(kmer)
        n = self._alphabet_encoding.alphabet_size
        if n == 4:
            codes = (kmer >> (2 * np.arange(self._k))) & 3
        else:
            codes = (kmer // n ** np.arange(self._k)) % n
        return bytes(self._alphabet_encoding.decode_table[codes]).decode("ascii")

    def get_labels(self) -> List[str]:
        assert self._k <= 8, "get_labels only supported for k <= 8"
        return [self.to_string(h)
                for h in range(self._alphabet_encoding.alphabet_size ** self._k)]

    def __str__(self):
        return f"{self._k}merEncoding({self._alphabet_encoding})"

    def __repr__(self):
        return f"KmerEncoding({self._alphabet_encoding}, {self._k})"

    def __eq__(self, other):
        if not isinstance(other, KmerEncoding):
            return False
        return (self._k == other._k and
                self._alphabet_encoding == other._alphabet_encoding)

    def __hash__(self):
        return hash((self._k, self._alphabet_encoding))
