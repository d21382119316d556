"""ChIP-seq fragment/read simulation from PWM probabilities (the port of
bionumpy_tpu/simulate/chipseq.py; reference:
bionumpy/simulate/chipseq.py:28-73).

The fragments are drawn with the motif score of every window of the
reference as log-probabilities.  The JAX package scores the flat
reference on the host in float64; the port scores a reference of more
than 2^15 bases as one row on `device` (kernel 3 on the card, its plain
version with device="cpu", float32 sums either way) and shorter ones as
the JAX package does.  Seeded alike, both packages draw the same
uniforms; a draw differs only where one falls between the float32 and
the float64 cumulative probabilities."""
from __future__ import annotations

import dataclasses

import numpy as np
from numpy.random import default_rng

from ..datatypes import Bed6, Interval
from ..encoded_array import EncodedArray, EncodedRaggedArray, as_encoded_array
from ..encodings import StrandEncoding
from ..encodings.alphabet_encoding import AlphabetEncoding
from ..sequence.position_weight_matrix import get_motif_scores
from ..streams import streamable
from ..string_array import as_string_array

rng = default_rng()


@dataclasses.dataclass
class ChipSeqSimulationSettings:
    motif: object
    fragment_length: int = 200
    read_length: int = 100
    coverage: int = 10


def simulate_sequence(alphabet, length):
    numbers = rng.choice(np.arange(len(alphabet)), size=length)
    return EncodedArray(numbers.astype(np.uint8),
                        AlphabetEncoding(alphabet))


def _window_scores(reference_sequence, motif, device) -> np.ndarray:
    """Motif score of every window of a flat reference, float64."""
    sequence = as_encoded_array(reference_sequence)
    if not isinstance(sequence, EncodedRaggedArray) and \
            sequence.size > (1 << 15):
        row = EncodedRaggedArray(sequence, [sequence.size])
        return np.asarray(get_motif_scores(row, motif, device=device).ravel())
    return np.asarray(get_motif_scores(sequence, motif, device=device))


@streamable()
def simulate_chip_seq_fragments(reference_sequence, motif,
                                n_fragments: int = 1000,
                                fragment_size: int = 100,
                                device=None) -> Interval:
    log_prob = _window_scores(reference_sequence, motif, device)
    prob = np.exp(log_prob)
    prob /= prob.sum()
    points = rng.choice(np.arange(prob.size), size=n_fragments,
                        replace=True, p=prob)
    left_extend = rng.poisson(fragment_size // 2, size=points.size)
    right_extend = rng.poisson(fragment_size // 2, size=points.size)
    start = np.maximum(points - left_extend, 0)
    stop = np.minimum(points + right_extend + 1, log_prob.size)
    return Interval(["."] * len(start), start, stop)


@streamable()
def simulate_read_fragments(fragments: Interval,
                            read_length: int) -> Bed6:
    strands = EncodedArray(
        rng.choice([0, 1], replace=True,
                   size=len(fragments)).astype(np.uint8), StrandEncoding)
    frag_starts = np.asarray(fragments.start)
    frag_stops = np.asarray(fragments.stop)
    is_plus = np.asarray(strands == "+")
    starts = np.where(is_plus, frag_starts, frag_stops - read_length)
    stops = np.where(~is_plus, frag_stops, frag_starts + read_length)
    starts = np.maximum(starts, frag_starts)
    stops = np.minimum(stops, frag_stops)
    return Bed6(fragments.chromosome, starts, stops,
                ["."] * len(stops), [0] * len(stops), strands)


@streamable()
def simulate_chip_seq_reads(reference_sequence, settings,
                            sequence_name=None, device=None) -> Bed6:
    n_fragments = settings.coverage * len(reference_sequence) // \
        settings.read_length
    fragments = simulate_chip_seq_fragments(
        reference_sequence, settings.motif, n_fragments,
        settings.fragment_length, device=device)
    reads = simulate_read_fragments(fragments, settings.read_length)
    if sequence_name is not None:
        reads = dataclasses_replace_chromosome(reads, sequence_name)
    return reads


def dataclasses_replace_chromosome(reads, sequence_name):
    from ..bnpdataclass import replace
    return replace(reads,
                   chromosome=as_string_array(
                       [sequence_name] * len(reads)))
