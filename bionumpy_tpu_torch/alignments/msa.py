"""Multiple sequence alignment matrix (the port's copy of
bionumpy_tpu/alignments/msa.py; reference: bionumpy/alignments/msa.py)."""
from __future__ import annotations

import numpy as np


class MultipleSequenceAlignment:
    def __init__(self, matrix, sequence_names):
        self.matrix = matrix
        self.sequence_names = sequence_names

    @classmethod
    def from_sequence_entries(cls, entries):
        sequences = entries.sequence
        length = int(sequences.lengths[0])
        assert np.all(np.asarray(sequences.lengths) == length)
        matrix = sequences.ravel().reshape(len(sequences), length)
        return cls(matrix, entries.name)

    def mask(self):
        return np.asarray(self.matrix != "-")
