"""RNA-seq read simulation (the port's copy of
bionumpy_tpu/simulate/rnaseq.py; reference: bionumpy/simulate/rnaseq.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
from numpy.random import default_rng

from ..datatypes import SequenceEntryWithQuality
from ..encoded_array import (EncodedArray, EncodedRaggedArray,
                             as_encoded_array)
from ..encodings import DNAEncoding, StrandEncoding
from ..sequence import get_reverse_complement

rng = default_rng()


@dataclasses.dataclass
class RNASeqSimulationSettings:
    """Knobs for the transcript -> fragment -> read simulation."""
    transcript_counts: list = None  # copies per transcript (default 1)
    fragment_size: int = 100
    sampling_rate: float = 0.9
    read_length: int = 75


def get_transcript_copies(sequences, sequence_counts):
    """Repeat each transcript by its copy count (row gather)."""
    if sequence_counts is None:
        return sequences
    counts = np.asarray(sequence_counts, dtype=np.int64)
    return sequences[np.repeat(np.arange(len(counts)), counts)]


def fragment_transcript_copies(sequences, fragment_size: int):
    fragments = [sequence[i: i + fragment_size]
                 for sequence in sequences
                 for i in range(0, len(sequence) - fragment_size + 1,
                                fragment_size)]
    return as_encoded_array(fragments)


def sample_transcript_fragments(sequences, sampling_rate: float):
    mask = rng.choice([True, False], size=len(sequences),
                      p=[sampling_rate, 1 - sampling_rate])
    return sequences[mask]


def get_rnaseq_reads(fragments, read_length: int, strands=None):
    reverse_fragments = get_reverse_complement(fragments)
    if strands is None:
        strands = EncodedArray(
            rng.choice([0, 1], replace=True,
                       size=len(fragments)).astype(np.uint8),
            StrandEncoding)
    forward = fragments[:, 0:read_length]
    reverse = reverse_fragments[:, 0:read_length]
    is_plus = np.asarray(strands == "+")
    flat = np.where(np.repeat(is_plus, forward.lengths),
                    forward.ravel().raw(), reverse.ravel().raw())
    return EncodedRaggedArray(EncodedArray(flat, forward.encoding),
                              forward.lengths)


def simulate_rnaseq(reference_sequences,
                    settings: RNASeqSimulationSettings
                    ) -> SequenceEntryWithQuality:
    reference_sequences = as_encoded_array(reference_sequences,
                                           DNAEncoding)
    copies = get_transcript_copies(reference_sequences,
                                   settings.transcript_counts)
    fragments = fragment_transcript_copies(copies, settings.fragment_size)
    sampled = sample_transcript_fragments(fragments,
                                          settings.sampling_rate)
    reads = get_rnaseq_reads(sampled, settings.read_length)
    return SequenceEntryWithQuality(
        [f"read_{i}" for i in range(len(reads))], reads,
        ["!" * int(length) for length in reads.lengths])
