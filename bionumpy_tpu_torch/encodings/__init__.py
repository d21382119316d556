"""Encodings subpackage (the port's copy of bionumpy_tpu/encodings/__init__.py,
without its set_backend, which only raises).  The VCF genotype encodings
are in vcf_encoding.py."""
import numpy as np

from ..encoded_array import BaseEncoding, Encoding, NumericEncoding
from .alphabet_encoding import (ACGTEncoding, ACGTnEncoding, ACTGEncoding,
                                ACTGnEncoding, ACUGEncoding, AlphabetEncoding,
                                AminoAcidEncoding, BamEncoding,
                                CigarOpEncoding, DNAEncoding,
                                FlatAlphabetEncoding, RNAENcoding,
                                RNAEncoding, StrandEncoding,
                                get_alphabet_encodings)
from .exceptions import EncodingError

__all__ = ["BaseEncoding", "Encoding", "NumericEncoding", "AlphabetEncoding",
           "AminoAcidEncoding", "DNAEncoding", "RNAEncoding", "ACGTEncoding",
           "StrandEncoding", "CigarOpEncoding", "BamEncoding",
           "QualityEncoding", "CigarEncoding", "DigitEncoding",
           "EncodingError", "KmerEncoding", "StringEncoding",
           "BoolStringEncoding", "bool_string"]


class DigitEncodingFactory(NumericEncoding):
    """ASCII digit-offset numeric encoding (reference:
    bionumpy/encodings/__init__.py:11-26)."""

    def __init__(self, min_code: str):
        self._min_code = ord(min_code)

    @property
    def min_code(self) -> int:
        return self._min_code

    def _encode(self, byte_array):
        return np.asarray(byte_array) - self._min_code

    def _decode(self, digits):
        return np.asarray(digits) + self._min_code

    def __repr__(self):
        return f"DigitEncoding(min_code={self._min_code})"

    def __eq__(self, other):
        return isinstance(other, DigitEncodingFactory) and \
            self._min_code == other._min_code

    def __hash__(self):
        return hash(("DigitEncodingFactory", self._min_code))


DigitEncoding = DigitEncodingFactory("0")
QualityEncoding = DigitEncodingFactory("!")
CigarEncoding = DigitEncodingFactory(chr(0))

from .kmer_encodings import KmerEncoding  # noqa: E402
from .string_encodings import StringEncoding  # noqa: E402
from .bool_encoding import BoolStringEncoding, bool_string  # noqa: E402
