"""VCF genotype-column encodings (reference:
bionumpy/encodings/vcf_encoding.py:9-187).

Each genotype cell like ``0|1`` / ``./.`` is encoded positionally over the
alphabet [alleles + separators]; phased variants use the compact 0..3 code.
"""
from __future__ import annotations

import itertools

import numpy as np

from ..encoded_array import BaseEncoding, EncodedArray, Encoding


def _make_lookup(alphabet: str) -> tuple:
    reverse = np.array([ord(c) for c in alphabet], dtype=np.uint8)
    forward = np.zeros(256, dtype=np.uint8)
    forward[reverse] = np.arange(len(reverse))
    return forward, reverse


class _GenotypeRowEncoding(Encoding):
    """Positional base-6 code over (allele, separator, allele); supports
    phased/unphased/missing, bi- and tri-allelic."""

    returns_raw = True
    _alleles = ["0", "1", "2", "."]
    _separators = ["|", "/"]
    _alphabet = _alleles + _separators
    _alphabet_lookup, _reverse_alphabet_lookup = _make_lookup(
        "".join(_alphabet))
    _genotypes = list(itertools.product(_alleles, _separators, _alleles))
    _alphabet_size = len(_alphabet)

    def get_labels(self):
        pass

    def decode_lookup(self) -> np.ndarray:
        codes = [
            sum(self._alphabet_size ** (2 - i) *
                int(self._alphabet_lookup[ord(g)])
                for i, g in enumerate(genotype))
            for genotype in self._genotypes]
        table = np.zeros((256, 4), dtype=np.uint8)
        table[codes] = np.array(
            [[ord(g) for g in genotype] + [ord("\t")]
             for genotype in self._genotypes])
        return table

    def _preprocess(self, genotype_rows) -> EncodedArray:
        """Raw tab-separated genotype text -> (n_cells, 3) char matrix."""
        if isinstance(genotype_rows, EncodedArray) and genotype_rows.ndim == 3:
            return genotype_rows.reshape(-1, 3)
        from ..io.strops import replace_inplace
        if isinstance(genotype_rows, list):
            assert len(genotype_rows) == 0
            return EncodedArray(np.zeros((0, 3), dtype=np.uint8), BaseEncoding)
        data = genotype_rows.ravel()
        replace_inplace(data, "\n", "\t")
        indices = np.flatnonzero(np.asarray(data == "\t"))
        indices = np.insert(indices, 0, -1)
        return data[indices[:-1, np.newaxis] + np.array([1, 2, 3])]

    def encode(self, genotype_rows):
        data = self._preprocess(genotype_rows)
        n_rows = len(genotype_rows)
        if n_rows == 0:
            return np.zeros((0, 1), dtype=np.int8)
        encoded = (
            self._alphabet_size ** 2 * self._alphabet_lookup[data[:, 0].raw()]
            + self._alphabet_size * self._alphabet_lookup[data[:, 1].raw()]
            + self._alphabet_lookup[data[:, 2].raw()])
        return encoded.reshape(n_rows, -1).astype(np.int8)

    def decode(self, genotype):
        if len(np.shape(genotype)) == 0:
            return self.decode_lookup()[genotype]
        genotype = genotype.raw() if hasattr(genotype, "raw") else genotype
        new_shape = genotype.shape[:-1] + (4 * genotype.shape[-1],)
        decoded = self.decode_lookup()[genotype].reshape(new_shape)
        return decoded[..., :-1]

    def to_string(self, e):
        if isinstance(e, np.ndarray):
            e = np.atleast_1d(e)
        if len(e.shape) == 2:
            return "\n".join(self.to_string(c) for c in e)
        return "".join(chr(c) for c in self.decode(e))

    def __repr__(self):
        return "GenotypeRowEncoding"

    def __eq__(self, other):
        return type(other) is type(self)

    def __hash__(self):
        return hash(type(self).__name__)


class _PhasedGenotypeRowEncoding(_GenotypeRowEncoding):
    """0|0 / 0|1 / 1|0 / 1|1 -> 0..3 (reference:
    bionumpy/encodings/vcf_encoding.py:139-163)."""

    genotypes = ["0|0", "0|1", "1|0", "1|1"]

    def decode_lookup(self):
        return np.array([[ord(c) for c in genotype] + [ord("\t")]
                         for genotype in self.genotypes], dtype=np.uint8)

    def encode(self, genotype_rows):
        if len(genotype_rows) == 0:
            return np.zeros((0, 1), dtype=np.int8)
        data = self._preprocess(genotype_rows)
        n_rows = len(genotype_rows)
        encoded = np.asarray(data[:, 0] == "1") * 2 + \
            np.asarray(data[:, 2] == "1")
        return encoded.reshape(n_rows, -1).astype(np.int8)

    def __repr__(self):
        return "PhasedGenotypeRowEncoding"


class _PhasedHaplotypeRowEncoding(_GenotypeRowEncoding):
    """Per-haplotype int8 matrix (two columns per sample)."""

    _alleles = [str(i) for i in range(5)] + ["."]
    _alphabet = _alleles
    _alphabet_lookup, _reverse_alphabet_lookup = _make_lookup(
        "".join(_alphabet))
    _alphabet_size = len(_alphabet)

    def encode(self, genotype_rows):
        if len(genotype_rows) == 0:
            return np.zeros((0, 1), dtype=np.int8)
        data = self._preprocess(genotype_rows)
        n_rows = len(genotype_rows)
        first = self._alphabet_lookup[data[:, 0].raw()]
        second = self._alphabet_lookup[data[:, 2].raw()]
        out = np.zeros(len(first) * 2, dtype=np.int8)
        out[::2] = first
        out[1::2] = second
        return out.reshape(n_rows, -1)

    def __repr__(self):
        return "PhasedHaplotypeRowEncoding"


PhasedGenotypeRowEncoding = _PhasedGenotypeRowEncoding()
PhasedHaplotypeRowEncoding = _PhasedHaplotypeRowEncoding()
GenotypeRowEncoding = _GenotypeRowEncoding()
