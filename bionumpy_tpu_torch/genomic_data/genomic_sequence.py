"""Genomic sequence access (reference:
bionumpy/genomic_data/genomic_sequence.py:16-78; the port's copy of
bionumpy_tpu/genomic_data/genomic_sequence.py)."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..encoded_array import (EncodedArray, EncodedRaggedArray,
                             as_encoded_array)
from ..encodings.alphabet_encoding import ACGTnEncoding
from ..io.indexed_fasta import IndexedFasta
from ..sequence import get_reverse_complement
from .genomic_track import GenomicData


def dna_encode(output):
    return as_encoded_array(output, ACGTnEncoding)


class GenomicSequence(GenomicData):
    def __init__(self, indexed_fasta: IndexedFasta, genome_context=None):
        self._genome_context = genome_context
        self._fasta = indexed_fasta

    @property
    def genome_context(self):
        if self._genome_context is None:
            from .genome_context import GenomeContext
            return GenomeContext(self._fasta.get_contig_lengths())
        return self._genome_context

    def __repr__(self):
        return (f"GenomicSequence over chromosomes: "
                f"{list(self._fasta.keys())}")

    @classmethod
    def from_indexed_fasta(cls, indexed_fasta: IndexedFasta,
                           genome_context=None):
        return GenomicSequenceIndexedFasta(indexed_fasta, genome_context)

    @classmethod
    def from_dict(cls, sequence_dict: Dict[str, str]):
        return GenomicSequenceDict(sequence_dict)

    def extract_chromsome(self, chromosome):
        return dna_encode(self._fasta[chromosome])

    extract_chromosome = extract_chromsome

    def _extract_intervals(self, intervals):
        raise NotImplementedError

    def _index_boolean(self, boolean_array):
        return self.extract_intervals(boolean_array.get_data(),
                                      stranded=False).ravel()

    def extract_intervals(self, intervals,
                          stranded: bool = False) -> EncodedRaggedArray:
        if hasattr(intervals, "get_data") and not hasattr(intervals,
                                                          "start"):
            intervals = intervals.get_data()
        if hasattr(intervals, "data") and not hasattr(intervals, "start"):
            intervals = intervals.data
        data = intervals.data if hasattr(intervals, "data") and \
            not hasattr(intervals, "position") else intervals
        sequences = dna_encode(self._extract_intervals(data))
        if stranded:
            is_plus = np.asarray(data.strand.ravel() == "+")
            rev = get_reverse_complement(sequences)
            flat = np.where(np.repeat(is_plus, sequences.lengths),
                            sequences.ravel().raw(), rev.ravel().raw())
            sequences = EncodedRaggedArray(
                EncodedArray(flat, sequences.encoding), sequences.lengths)
        return sequences


class GenomicSequenceIndexedFasta(GenomicSequence):
    def _extract_intervals(self, intervals):
        return self._fasta.get_interval_sequences(intervals)


class GenomicSequenceDict(GenomicSequence):
    def __init__(self, sequence_dict: Dict[str, str]):
        self._genome_context = None
        self._dict = {name: as_encoded_array(seq,
                                             target_encoding=ACGTnEncoding)
                      for name, seq in sequence_dict.items()}

    def __repr__(self):
        return f"GenomicSequence over chromosomes: {list(self._dict)}"

    @property
    def genome_context(self):
        from .genome_context import GenomeContext
        return GenomeContext({name: len(seq)
                              for name, seq in self._dict.items()})

    def extract_chromsome(self, chromosome):
        return self._dict[chromosome]

    extract_chromosome = extract_chromsome

    @property
    def _flat_codes(self):
        """Concatenated per-chromosome code buffer + name offsets,
        built once: interval extraction is then ONE vectorized window
        gather instead of a per-interval python loop (was the whole
        cost of SBS96 counting at 83k variants)."""
        if not hasattr(self, "_flat_cache"):
            offsets = {}
            parts = []
            off = 0
            for name, seq in self._dict.items():
                offsets[name] = off
                arr = np.asarray(seq.raw())
                off += len(arr)
                parts.append(arr)
            flat = np.concatenate(parts) if parts else \
                np.empty(0, np.uint8)
            self._flat_cache = (flat, offsets)
        return self._flat_cache

    def _chromosome_tables(self, chrom):
        """(base offset, chromosome length) per entry, from either a
        StringEncoding-coded or plain string chromosome column."""
        from ..encodings.string_encodings import StringEncoding
        _, offsets = self._flat_codes
        lengths = {name: len(seq) for name, seq in self._dict.items()}
        if hasattr(chrom, "encoding") and \
                isinstance(chrom.encoding, StringEncoding):
            labels = chrom.encoding.get_labels()
            ids = np.asarray(chrom.raw())
            base = np.array([offsets[label] for label in labels],
                            np.int64)[ids]
            size = np.array([lengths[label] for label in labels],
                            np.int64)[ids]
            return base, size
        names = np.asarray([str(s) for s in chrom.tolist()])
        uniq, inverse = np.unique(names, return_inverse=True)
        base = np.array([offsets[u] for u in uniq], np.int64)[inverse]
        size = np.array([lengths[u] for u in uniq], np.int64)[inverse]
        return base, size

    def _chromosome_offsets(self, chrom, n: int) -> np.ndarray:
        """Per-interval base offset of each interval's chromosome in
        the concatenated buffer."""
        return self._chromosome_tables(chrom)[0]

    def window_matrix(self, chrom, positions: np.ndarray,
                      flank: int):
        """Fixed-width (n, 2*flank+1) window gather centered on
        `positions` — the SBS96 fast path.  None when any window would
        cross a chromosome boundary (callers fall back to the clipped
        interval machinery)."""
        flat, _ = self._flat_codes
        positions = np.asarray(positions, np.int64)
        if len(positions) == 0:
            return None
        base, size = self._chromosome_tables(chrom)
        if int(positions.min()) < flank or \
                np.any(positions + flank >= size):
            return None
        idx = (base + positions)[:, None] + np.arange(-flank, flank + 1)
        return EncodedArray(flat[idx], ACGTnEncoding)

    def _extract_intervals(self, intervals):
        from ..ragged import RaggedView
        starts = np.asarray(intervals.start, dtype=np.int64)
        stops = np.asarray(intervals.stop, dtype=np.int64)
        if len(starts) == 0:
            return as_encoded_array([], ACGTnEncoding)
        flat, _ = self._flat_codes
        base, size = self._chromosome_tables(intervals.chromosome)
        # Clip to the chromosome like the reference's python slicing
        # (seq[start:stop]): a stop past the end must not read into the
        # next chromosome's buffer or past the flat buffer.
        starts = np.clip(starts, 0, size)
        stops = np.minimum(stops, size)
        lens = np.maximum(stops - starts, 0)
        idx = RaggedView(base + starts, lens).get_flat_indices()
        return EncodedRaggedArray(EncodedArray(flat[idx], ACGTnEncoding),
                                  lens)
