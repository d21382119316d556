"""Alphabet encodings: 256-entry LUT byte->code, case-insensitive (the
port's copy of bionumpy_tpu/encodings/alphabet_encoding.py).

The LUTs are plain numpy arrays exposed via ``.lookup_table`` /
``.decode_table``; the device parse (ops/parse.py) uploads the same table
and runs the same gather on the card.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..encoded_array import OneToOneEncoding
from .exceptions import EncodingError

_INVALID = 255


class AlphabetEncoding(OneToOneEncoding):
    def __init__(self, alphabet: str):
        self._raw_alphabet = "".join(c.upper() for c in alphabet)
        alpha_bytes = np.frombuffer(self._raw_alphabet.encode("ascii"),
                                    dtype=np.uint8)
        lower = alpha_bytes + (ord("a") - ord("A"))
        lut = np.full(256, _INVALID, dtype=np.uint8)
        codes = np.arange(len(alpha_bytes), dtype=np.uint8)
        lut[alpha_bytes] = codes
        lut[lower] = codes
        self._alphabet = alpha_bytes
        self._lookup = lut

    @property
    def lookup_table(self) -> np.ndarray:
        """256-entry encode LUT (byte -> code, 255 = invalid)."""
        return self._lookup

    @property
    def decode_table(self) -> np.ndarray:
        """code -> ASCII byte."""
        return self._alphabet

    def _encode(self, byte_array):
        ret = self._lookup[np.asarray(byte_array, dtype=np.uint8)]
        if ret.size and int(ret.max(initial=0)) >= self.alphabet_size:
            flat_ret = ret.ravel()
            flat_in = np.asarray(byte_array).ravel()
            offset = int(np.flatnonzero(flat_ret == _INVALID)[0])
            bad = [chr(c) for c in flat_in[flat_ret == _INVALID][:10]]
            context = "".join(chr(c) for c in flat_in[:100])
            raise EncodingError(
                f"Error when encoding {context} to {self.__class__.__name__}. "
                f"Invalid character(s): {bad}{[ord(c) for c in bad]}", offset)
        return ret

    def _decode(self, encoded):
        return self._alphabet[np.asarray(encoded)]

    @property
    def alphabet_size(self) -> int:
        return self._alphabet.size

    def get_alphabet(self) -> List[str]:
        return [chr(c) for c in self._alphabet]

    def get_labels(self) -> List[str]:
        return self.get_alphabet()

    def __str__(self):
        return f"AlphabetEncoding('{self._raw_alphabet}')"

    __repr__ = __str__

    def __eq__(self, other):
        if not isinstance(other, AlphabetEncoding):
            return False
        return self._raw_alphabet == other._raw_alphabet

    def __hash__(self):
        return hash((type(self).__name__, self._raw_alphabet))


ACTGEncoding = AlphabetEncoding("ACTG")
ACGTEncoding = AlphabetEncoding("ACGT")
ACTGnEncoding = AlphabetEncoding("ACTGn")
ACGTnEncoding = AlphabetEncoding("ACGTn")
DigitEncoding = AlphabetEncoding("0123456789")
DNAEncoding = ACGTEncoding
ACUGEncoding = AlphabetEncoding("ACUG")
RNAENcoding = ACUGEncoding
RNAEncoding = ACUGEncoding
AminoAcidEncoding = AlphabetEncoding("ACDEFGHIKLMNPQRSTVWY*")
BamEncoding = AlphabetEncoding("=ACMGRSVTWYHKDBN")
CigarOpEncoding = AlphabetEncoding("MIDNSHP=X")


class FlatAlphabetEncoding(AlphabetEncoding):
    def _encode(self, *args, **kwargs):
        return super()._encode(*args, **kwargs).ravel()


StrandEncoding = FlatAlphabetEncoding("+-.")


def get_alphabet_encodings():
    return [ACTGEncoding, ACGTEncoding, ACTGnEncoding, ACGTnEncoding,
            DigitEncoding, DNAEncoding, ACUGEncoding, RNAENcoding,
            AminoAcidEncoding, BamEncoding, CigarOpEncoding, StrandEncoding]
