"""Position weight matrices (the port's copy of the PWM class of
bionumpy_tpu/sequence/position_weight_matrix.py:17-97).

A sequence is a `str` over the PWM's alphabet or a numpy array of its
codes; encoded and ragged arrays (get_motif_scores and the like) are still
to be ported.  The scans
over whole files run on the card through pipeline.get_motif_matches_fastq;
the host methods here score in float64, as the JAX package's do.
"""
from __future__ import annotations

import typing
from typing import Dict

import numpy as np

from ..encodings import AlphabetEncoding, EncodingError


def _pwm_from_counts(count_matrix):
    with_pseudo = count_matrix + 1
    return np.log(with_pseudo / with_pseudo.sum(axis=0, keepdims=True))


class PWM:
    """Position Weight Matrix of log-likelihood ratios, (alphabet size,
    window size)."""

    def __init__(self, matrix, alphabet):
        self._matrix = np.asarray(matrix, dtype=float)
        self._alphabet = alphabet
        self._encoding = AlphabetEncoding(alphabet)
        self._indices = np.arange(self.window_size)

    @property
    def alphabet(self) -> str:
        return self._alphabet

    @property
    def matrix(self) -> np.ndarray:
        return self._matrix

    @property
    def window_size(self) -> int:
        return self._matrix.shape[-1]

    def _codes(self, sequence) -> np.ndarray:
        """Codes of a str over the alphabet, or a validated code array."""
        if isinstance(sequence, str):
            try:
                return self._encoding.encode(sequence).raw()
            except EncodingError as err:
                raise ValueError(err.message) from err
        if isinstance(sequence, np.ndarray) and sequence.dtype.kind in "iu":
            if sequence.size and (int(sequence.min()) < 0 or int(
                    sequence.max()) >= len(self._alphabet)):
                raise ValueError(f"codes outside alphabet {self._alphabet}")
            return sequence
        raise NotImplementedError(
            "encoded and ragged sequence arrays are not ported yet (ROADMAP "
            "queue 1 item 9, with the encoded-array API); pass a str or an "
            "integer code array")

    def calculate_score(self, sequence):
        codes = self._codes(sequence)
        assert codes.shape[-1] == self.window_size
        return self._matrix[codes, self._indices].sum(axis=-1)

    def calculate_scores(self, sequence) -> np.ndarray:
        """Scores at every flat position; windows running off the end get
        partial sums, as in the JAX package."""
        codes = self._codes(sequence)
        scores = np.zeros(codes.size, dtype=float)
        for offset, row in enumerate(self._matrix.T):
            scores[: scores.size - offset] += row[codes[offset:]]
        return scores

    @classmethod
    def from_dict(cls, dictionary: Dict[str, typing.Any],
                  background: Dict[str, float] = None) -> "PWM":
        if background is None:
            background = {key: 1 / len(dictionary) for key in dictionary}
        alphabet = "".join(dictionary.keys())
        with np.errstate(divide="ignore"):
            matrix = np.log(np.array(list(dictionary.values()))) - \
                np.log([background[key] for key in dictionary])[:, np.newaxis]
        return cls(matrix, alphabet)

    @classmethod
    def from_counts(cls, counts: Dict[str, typing.List[int]]) -> "PWM":
        return cls(_pwm_from_counts(np.array(list(counts.values()))),
                   "".join(counts.keys()))

    def __str__(self):
        matrix = self._matrix.transpose()
        return ("PWM with alphabet " + self._alphabet + "\n" +
                "\n".join(" ".join(str(round(c, 2)) for c in row)
                          for row in matrix))
