"""CIGAR ops: 4-bit op / 28-bit length words (reference:
bionumpy/alignments/cigar.py:8-24)."""
from __future__ import annotations

import numpy as np

from ..encoded_array import (EncodedArray, EncodedRaggedArray,
                             as_encoded_array)
from ..encodings.alphabet_encoding import CigarOpEncoding
from ..ragged import RaggedArray, RaggedShape


def split_cigar(cigars):
    if isinstance(cigars, RaggedArray):
        symbol, lengths = split_cigar(np.asarray(cigars.ravel()))
        return (EncodedRaggedArray(symbol, RaggedShape(cigars.lengths)),
                RaggedArray(lengths, RaggedShape(cigars.lengths)))
    cigars = np.asarray(cigars)
    symbol = EncodedArray((cigars & np.uint32(2 ** 4 - 1)).astype(np.uint8),
                          CigarOpEncoding)
    lengths = (cigars >> 4).astype(np.int64)
    return symbol, lengths


def count_reference_length(symbol, lengths) -> np.ndarray:
    """Sum of lengths of reference-consuming ops (M, D, N, =, X)."""
    consuming = as_encoded_array("MDN=X", CigarOpEncoding)
    mask = symbol == consuming[0]
    for consuming_symbol in consuming[1:]:
        mask = mask | (symbol == consuming_symbol)
    return np.asarray(np.sum(mask * lengths, axis=-1)).astype(np.int64)
