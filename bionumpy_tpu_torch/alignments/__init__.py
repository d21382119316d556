"""Alignment utilities (reference: bionumpy/alignments/__init__.py)."""
from __future__ import annotations

import numpy as np

from ..datatypes import BamEntry, Bed6
from ..encoded_array import EncodedArray
from ..encodings import BaseEncoding
from ..streams import streamable
from .cigar import count_reference_length, split_cigar


@streamable()
def alignment_to_interval(alignment: BamEntry) -> Bed6:
    """Stranded reference interval covered by each alignment."""
    strand = np.asarray(alignment.flag) & np.uint16(16)
    strand = EncodedArray(
        np.where(strand, ord("-"), ord("+"))[:, None].astype(np.uint8),
        encoding=BaseEncoding)
    length = count_reference_length(alignment.cigar_op,
                                    alignment.cigar_length)
    return Bed6(alignment.chromosome, alignment.position,
                np.asarray(alignment.position) + length, alignment.name,
                alignment.mapq, strand)


__all__ = ["alignment_to_interval", "split_cigar",
           "count_reference_length"]
