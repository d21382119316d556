"""Spliced transcript sequence extraction (reference:
bionumpy/sequence/genes.py:13-31; the port's copy of
bionumpy_tpu/sequence/genes.py)."""
from __future__ import annotations

import itertools

import numpy as np

from ..datatypes import SequenceEntry
from ..encoded_array import (BaseEncoding, EncodedRaggedArray,
                             as_encoded_array, change_encoding)
from ..encodings.alphabet_encoding import ACGTnEncoding
from ..ragged import RaggedShape
from ..streams import streamable
from .dna import _reverse_rows, complement, get_sequences


@streamable()
def get_transcript_sequences(gtf_entries, reference_sequence):
    """Concatenate exon sequences per transcript; reverse-complement
    minus-strand transcripts."""
    if len(gtf_entries) == 0:
        return SequenceEntry.empty()
    reference_sequence = as_encoded_array(reference_sequence, ACGTnEncoding)
    exon_entries = gtf_entries.get_exons()
    exon_sequences = get_sequences(reference_sequence, exon_entries)
    flat_exons = exon_sequences.ravel()
    infos = []
    groups = itertools.groupby(exon_entries,
                               key=lambda entry: str(entry.transcript_id))
    for transcript_id, entries in groups:
        entries = list(entries)
        strand = str(entries[0].strand)
        seq_length = sum(int(np.asarray(entry.stop)) -
                         int(np.asarray(entry.start)) for entry in entries)
        infos.append((transcript_id, strand, seq_length))
    names, strands, lengths = zip(*infos)
    transcripts = EncodedRaggedArray(flat_exons, list(lengths))
    rev = _reverse_rows(complement(transcripts))
    is_minus = np.array([s == "-" for s in strands])
    out_flat = np.where(np.repeat(is_minus, transcripts.lengths),
                        rev.ravel().raw(), transcripts.ravel().raw())
    out = EncodedRaggedArray(
        type(flat_exons)(out_flat, flat_exons.encoding),
        RaggedShape(transcripts.lengths))
    return SequenceEntry(list(names), change_encoding(out, BaseEncoding))
