"""Reverse complement and strand-aware sequence extraction
(reference: bionumpy/sequence/dna.py; the port's copy of
bionumpy_tpu/sequence/dna.py).  Host numpy: a reversed array is a new
array, so a k-mer call on it uploads it once (ops/resident.py)."""
from __future__ import annotations

import numpy as np

from ..bnpdataclass.bnpdataclassfunction import apply_to_npdataclass
from ..datatypes import Interval
from ..encoded_array import (BaseEncoding, EncodedArray, EncodedRaggedArray,
                             as_encoded_array)
from ..encodings.alphabet_encoding import AlphabetEncoding
from ..ragged import RaggedShape, RaggedView
from ..streams import streamable
from .lookup import Lookup

_complements = {"A": "T", "G": "C", "C": "G", "T": "A", "N": "N",
                "a": "t", "g": "c", "c": "g", "t": "a", "n": "n"}


def _get_complement_lookup(encoding):
    if isinstance(encoding, AlphabetEncoding):
        alphabet = encoding.get_alphabet()
        new_alphabet = "".join(_complements[c] for c in alphabet)
        return Lookup(as_encoded_array(new_alphabet, encoding), encoding)
    if encoding == BaseEncoding:
        values = np.zeros(256, dtype=np.uint8)
        for key, value in _complements.items():
            values[ord(key)] = ord(value)
        return Lookup(EncodedArray(values, BaseEncoding))
    raise ValueError(f"Invalid encoding for dna-complement: {encoding}")


def complement(_array):
    array = _array.ravel() if isinstance(_array, EncodedRaggedArray) \
        else _array
    assert isinstance(array, EncodedArray)
    lookup = _get_complement_lookup(array.encoding)
    new_data = lookup[array]
    if isinstance(_array, EncodedRaggedArray):
        return EncodedRaggedArray(new_data, RaggedShape(_array.lengths))
    return new_data


def _reverse_rows(era: EncodedRaggedArray) -> EncodedRaggedArray:
    """Per-row reversal of a ragged array via a single gather."""
    lengths = np.asarray(era.lengths)
    flat = era.ravel().raw()
    ends = np.cumsum(lengths)
    starts = ends - lengths
    total = int(ends[-1]) if len(ends) else 0
    within = np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)
    indices = np.repeat(ends - 1, lengths) - within
    return EncodedRaggedArray(EncodedArray(flat[indices], era.encoding),
                              RaggedShape(lengths))


@streamable()
@apply_to_npdataclass("sequence")
def get_reverse_complement(sequence):
    """Reverse complement of DNA sequences.

    Examples
    --------
    >>> import bionumpy_tpu_torch as bnp
    >>> bnp.sequence.get_reverse_complement(
    ...     bnp.as_encoded_array("AAGT", bnp.DNAEncoding))
    encoded_array('ACTT', AlphabetEncoding('ACGT'))
    """
    sequence = as_encoded_array(sequence)
    comped = complement(sequence)
    if isinstance(comped, EncodedRaggedArray):
        return _reverse_rows(comped)
    return comped[..., ::-1]


@streamable()
def get_strand_specific_sequences(encoded_array: EncodedArray,
                                  stranded_intervals) -> EncodedRaggedArray:
    """Extract interval sequences; reverse-complement minus-strand ones
    (reference: bionumpy/sequence/dna.py:69-92)."""
    starts = np.asarray(stranded_intervals.start)
    stops = np.asarray(stranded_intervals.stop)
    flat = encoded_array.raw()
    view = RaggedView(starts, stops - starts)
    seqs = EncodedRaggedArray(
        EncodedArray(flat[view.get_flat_indices()], encoded_array.encoding),
        view.get_shape())
    rev = _reverse_rows(complement(seqs))
    is_minus = np.asarray(stranded_intervals.strand.ravel() == "-")
    out_flat = np.where(np.repeat(is_minus, seqs.lengths),
                        rev.ravel().raw(), seqs.ravel().raw())
    return EncodedRaggedArray(
        EncodedArray(out_flat, encoded_array.encoding),
        RaggedShape(seqs.lengths))


@streamable()
def get_sequences(sequence: EncodedArray, intervals) -> EncodedRaggedArray:
    starts = np.asarray(intervals.start)
    stops = np.asarray(intervals.stop)
    view = RaggedView(starts, stops - starts)
    return EncodedRaggedArray(
        EncodedArray(sequence.raw()[view.get_flat_indices()],
                     sequence.encoding),
        view.get_shape())
