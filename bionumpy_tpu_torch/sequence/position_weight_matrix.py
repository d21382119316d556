"""Position weight matrices and motif scans (the port of
bionumpy_tpu/sequence/position_weight_matrix.py; reference:
bionumpy/sequence/position_weight_matrix.py).

A sequence is an encoded array (flat or ragged), a `str` over the PWM's
alphabet, or a numpy array of its codes.  The host methods score in
float64, as the JAX package's do.  get_motif_scores on a ragged array of
more than 2^15 bases and get_motif_matches run on a device (`device`:
None is the card, which must be present; "cpu" runs the plain versions):
for a 4-letter alphabet through pwm_scores_kernel (ops/pwm_kernels.py)
over the array's resident packed words (ops/resident.py, the upload
shared with the k-mer and minimizer calls), else over its codes
(ops/pwm.pwm_scores).  The scans over whole files run through
pipeline.get_motif_matches_fastq.
"""
from __future__ import annotations

import typing
from typing import Dict

import numpy as np
import torch

from ..encoded_array import (EncodedArray, EncodedRaggedArray,
                             as_encoded_array)
from ..encodings import AlphabetEncoding, EncodingError
from ..instrument import call_span, stage
from ..ragged import RaggedArray, RaggedShape
from .rollable import RollableFunction


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

    def as_valid_encoded_array(self, sequence):
        """The sequence as an array encoded over this PWM's alphabet: an
        alphabet-encoded array whose alphabet starts with the PWM's (and
        whose codes stay inside it) as it is, a code array wrapped, and
        anything else encoded.  The largest code of an encoded array is
        read once and cached on it (ops/resident.max_code)."""
        from ..ops.resident import max_code

        if isinstance(sequence, (EncodedArray, EncodedRaggedArray)):
            if isinstance(sequence.encoding, AlphabetEncoding):
                alphabet = list(sequence.encoding.get_alphabet())
                own = list(self._alphabet)
                if alphabet[: len(own)] != own or \
                        max_code(sequence) >= len(own):
                    raise ValueError(
                        f"Cannot calculate pwm for alphabet {own} on "
                        f"{alphabet}-encoded array")
                return sequence
        elif isinstance(sequence, np.ndarray) and sequence.dtype.kind in "iu":
            if sequence.size and (int(sequence.min()) < 0 or int(
                    sequence.max()) >= len(self._alphabet)):
                raise ValueError(f"codes outside alphabet {self._alphabet}")
            return EncodedArray(sequence, self._encoding)
        try:
            return as_encoded_array(sequence, self._encoding)
        except EncodingError as err:
            raise ValueError(err.message) from err

    def calculate_score(self, sequence):
        sequence = self.as_valid_encoded_array(sequence)
        assert sequence.shape[-1] == self.window_size
        return self._matrix[sequence.raw(), self._indices].sum(axis=-1)

    def calculate_scores(self, sequence) -> np.ndarray:
        """Scores at every flat position; windows running off the end get
        partial sums, as in the JAX package."""
        codes = np.asarray(self.as_valid_encoded_array(sequence).raw())
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


class PositionWeightMatrix(RollableFunction):
    def __init__(self, pwm: PWM):
        self._pwm = pwm
        self._encoding = pwm._encoding
        self.window_size = pwm.window_size

    def __call__(self, sequence):
        return self._pwm.calculate_score(sequence)


def _device_matrix(pwm: PWM, device) -> torch.Tensor:
    """The PWM as the (4, w) float32 matrix the packed scans take: on
    the card a pageable copy, which waits for the stream."""
    matrix = np.zeros((4, pwm.window_size), np.float32)
    matrix[: pwm.matrix.shape[0]] = pwm.matrix  # codes stay below the rows
    return torch.from_numpy(matrix).to(device)


def _four_letters(sequence, pwm: PWM) -> bool:
    return pwm.matrix.shape[0] <= 4 and \
        getattr(sequence.encoding, "alphabet_size", 0) == 4


def _device_motif_scores(sequence: EncodedRaggedArray, pwm: PWM,
                         device=None) -> np.ndarray:
    """float32 scores of every flat position, computed on the device and
    returned as float64."""
    from ..ops.device import bucket_size, resolve_device
    from ..ops.pwm import pwm_scores, pwm_scores_range
    from ..ops.resident import device_seqs

    if _four_letters(sequence, pwm):
        ds = device_seqs(sequence, device)
        matrix = _device_matrix(pwm, ds.words.device)
        scores = pwm_scores_range(ds.words, matrix, pwm.window_size, 0,
                                  ds.n_positions)
        return scores[: ds.n].cpu().numpy().astype(float)
    device = resolve_device(device)
    flat = np.asarray(sequence.ravel().raw())
    n = len(flat)
    codes = np.zeros(bucket_size(n + pwm.window_size, 1 << 14), np.uint8)
    codes[:n] = flat
    scores = pwm_scores(torch.from_numpy(codes).to(device),
                        torch.from_numpy(pwm.matrix.astype(np.float32)).to(
                            device), pwm.window_size)
    return scores[:n].cpu().numpy().astype(float)


@call_span
def get_motif_matches(sequence, pwm: PWM, threshold: float,
                      cap: int = 1 << 20, device=None) -> RaggedArray:
    """Within-row positions whose motif score (float32) exceeds
    `threshold`, for a 4-letter alphabet: the scores never leave the
    device, and the match positions are compacted there
    (ops/pwm.pwm_scan_matches), so the copy to the host holds the
    matches only; their rows and in-row positions are made on the host
    (the `result` span, rows: the matches).  Windows up to 32 take one
    launch of kernel 3 in match mode a resident block, and one more at
    the exact count where a block has more than `cap` matches; wider
    windows are scored block by block of 2^27 positions, each block
    compacted at its match count.  An
    array of more than 2^31 bases is held as resident blocks of whole
    rows (ops/resident.device_seq_blocks).  The check that the array's
    codes lie inside the PWM's alphabet reads them once per array and
    keeps the largest beside the resident blocks (ops/resident.max_code):
    mutate the array through `__setitem__`, or call
    `ops.resident.invalidate(sequence)` after a write through a view
    (`sequence.ravel().raw()[i] = c`), else both are stale.

    Examples
    --------
    >>> import numpy as np
    >>> import bionumpy_tpu_torch as bnp
    >>> pwm = bnp.PWM.from_dict({"A": [0.8, 0.1], "C": [0.1, 0.8],
    ...                          "G": [0.05, 0.05], "T": [0.05, 0.05]})
    >>> m = bnp.get_motif_matches(
    ...     bnp.as_encoded_array(["TTACTT", "ACAC"], bnp.DNAEncoding),
    ...     pwm, threshold=1.0, device="cpu")
    >>> [[int(x) for x in np.asarray(row)] for row in m]
    [[2], [0, 2]]
    """
    from ..ops import resident
    from ..ops.device import fetch_rows
    from ..ops.pwm import pwm_scan_matches

    with stage("check-codes") as span:
        read = resident.CODES_READ
        try:
            sequence = pwm.as_valid_encoded_array(as_encoded_array(sequence))
        finally:
            span.rows = resident.CODES_READ - read
    if isinstance(sequence, EncodedArray):
        sequence = EncodedRaggedArray(sequence, [len(sequence)])
    if pwm.matrix.shape[0] != 4 or not _four_letters(sequence, pwm):
        raise ValueError("device motif matching needs a 4-letter alphabet")
    blocks = resident.device_seq_blocks(sequence, device)
    with stage("pwm-matrix"):
        matrix = _device_matrix(pwm, blocks[0].words.device)
    parts, base = [], 0
    for ds in blocks:
        found, cap = pwm_scan_matches(ds.words, ds.ends, ds.lengths, ds.n,
                                      matrix, pwm.window_size, threshold,
                                      cap, base)
        parts += found
        base += ds.n
    n = sum(p.numel() for p in parts)
    flat = fetch_rows(*parts, rows=n) if parts else np.empty(0, np.int64)
    with stage("result", rows=n):
        lengths = np.concatenate([ds.lengths for ds in blocks])
        starts = np.insert(np.cumsum(lengths), 0, 0)
        row = np.searchsorted(starts, flat, side="right") - 1
        return RaggedArray((flat - starts[row]).astype(np.int64),
                           np.bincount(row, minlength=len(lengths)))


def get_motif_scores(sequence, pwm: PWM, device=None) -> RaggedArray:
    """Log-likelihood motif score of every window that fits its sequence
    (reference: bionumpy/sequence/position_weight_matrix.py:166-196):
    each row has length L - w + 1.  A ragged array of more than 2^15
    bases is scored on the device in float32 and returned as float64;
    smaller ones and flat arrays on the host in float64, as in the JAX
    package, so both return the same floats.

    Examples
    --------
    >>> import numpy as np
    >>> import bionumpy_tpu_torch as bnp
    >>> pwm = bnp.PWM.from_dict({"A": [0.4, 0.25], "C": [0.2, 0.25],
    ...                          "G": [0.2, 0.25], "T": [0.2, 0.25]})
    >>> scores = bnp.get_motif_scores(
    ...     bnp.as_encoded_array(["ACGT"], bnp.DNAEncoding), pwm)
    >>> np.round(np.asarray(scores.ravel()), 3)
    array([ 0.47 , -0.223, -0.223])
    """
    sequence = pwm.as_valid_encoded_array(as_encoded_array(sequence))
    if not isinstance(sequence, EncodedRaggedArray):
        scores = pwm.calculate_scores(sequence)
        if pwm.window_size == 1:
            return scores
        return scores[: -pwm.window_size + 1]
    # -inf cells flow through the device sums exactly: -inf + finite is
    # -inf, and no path forms inf - inf
    if sequence.size > (1 << 15):
        scores = _device_motif_scores(sequence, pwm, device)
    else:
        scores = pwm.calculate_scores(sequence.ravel())
    ragged = RaggedArray(scores, RaggedShape(sequence.lengths))
    if pwm.window_size == 1:
        return ragged
    return ragged[:, : -pwm.window_size + 1]
