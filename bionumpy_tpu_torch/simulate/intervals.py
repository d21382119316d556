"""Interval simulation (the port's copy of
bionumpy_tpu/simulate/intervals.py; reference:
bionumpy/simulate/intervals.py)."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..datatypes import Interval
from ..encoded_array import as_encoded_array


def simulate_intervals(chrom_sizes: Dict[str, int], interval_size: int,
                       n_intervals: int, rng=None) -> Interval:
    rng = rng or np.random.default_rng()
    names = as_encoded_array(list(chrom_sizes.keys()))
    sizes = np.array(list(chrom_sizes.values()))
    chromosome_probs = sizes / sizes.sum()
    simulated = rng.choice(np.arange(len(sizes)), n_intervals,
                           p=chromosome_probs)
    start = rng.integers(0, sizes[simulated] - interval_size)
    return Interval(names[simulated], start, start + interval_size)


def simulate_fixed_size_uniform_intervals(genome, n_intervals: int,
                                          interval_size: int) -> Interval:
    chrom_sizes = genome.get_genome_context().chrom_sizes
    return simulate_intervals(chrom_sizes, interval_size, n_intervals)
