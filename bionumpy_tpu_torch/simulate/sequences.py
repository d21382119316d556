"""Sequence simulation (the port's copy of
bionumpy_tpu/simulate/sequences.py; reference:
bionumpy/simulate/sequences.py)."""
from __future__ import annotations

from typing import Dict

import numpy as np
from numpy.random import default_rng

from ..datatypes import Interval, SequenceEntry, SequenceEntryWithQuality
from ..encoded_array import EncodedArray, EncodedRaggedArray, as_encoded_array
from ..encodings.alphabet_encoding import AlphabetEncoding
from ..ragged import RaggedArray


def simulate_sequence(alphabet: str, length: int,
                      rng=None) -> EncodedArray:
    rng = rng or default_rng()
    numbers = rng.choice(np.arange(len(alphabet)), size=length)
    return EncodedArray(numbers.astype(np.uint8),
                        AlphabetEncoding(alphabet))


def simulate_sequences(alphabet: str, lengths: Dict[str, int],
                       rng=None) -> SequenceEntry:
    rng = rng or default_rng()
    total_length = sum(lengths.values())
    flat_sequence = simulate_sequence(alphabet, total_length, rng=rng)
    sequences = EncodedRaggedArray(flat_sequence, list(lengths.values()))
    return SequenceEntry(list(lengths.keys()), sequences)


def simulate_reads_from_genome(genome, length: int = 150,
                               n_reads: int = 100,
                               chunk_size: int = 10000,
                               sequence_name_prefix: str = "", rng=None,
                               ignore_reads_with_n: bool = False):
    """Yield chunks of simulated reads sampled uniformly from the genome
    (reference: bionumpy/simulate/sequences.py:57-99)."""
    if isinstance(rng, int):
        rng = default_rng(rng)
    rng = rng or default_rng()
    chromosomes = genome.genome_context.chrom_sizes
    genome_size = sum(chromosomes.values())
    for chromosome, chromosome_size in chromosomes.items():
        n_on_chrom = int(n_reads * chromosome_size / genome_size)
        n_simulated = 0
        while n_simulated < n_on_chrom:
            n_now = min(n_on_chrom - n_simulated, chunk_size)
            starts = rng.integers(0, chromosome_size - length, size=n_now)
            intervals = Interval(
                as_encoded_array([chromosome] * n_now), starts,
                starts + length)
            sequences = genome.extract_intervals(intervals)
            names = as_encoded_array(
                [f"{sequence_name_prefix}{i}"
                 for i in range(n_simulated, n_simulated + n_now)])
            qualities = RaggedArray(np.full(sequences.size, 40),
                                    sequences.lengths)
            entry = SequenceEntryWithQuality(names, sequences, qualities)
            if ignore_reads_with_n:
                n_mask = np.asarray(
                    (sequences == "N").any(axis=-1))
                entry = entry[~n_mask]
            yield entry
            n_simulated += n_now
