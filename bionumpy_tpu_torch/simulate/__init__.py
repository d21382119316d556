"""Simulators of sequences, reads, intervals, variants and ChIP-seq and
RNA-seq data (the port's copy of bionumpy_tpu/simulate/; numpy draws
from module-level generators, so both packages draw alike when seeded
alike)."""
from . import rnaseq
from .chipseq import (ChipSeqSimulationSettings, simulate_chip_seq_fragments,
                      simulate_chip_seq_reads, simulate_read_fragments)
from .intervals import (simulate_fixed_size_uniform_intervals,
                        simulate_intervals)
from .sequences import (simulate_reads_from_genome, simulate_sequence,
                        simulate_sequences)
from .variants import simulate_variants

__all__ = ["simulate_sequence", "simulate_sequences",
           "simulate_reads_from_genome", "simulate_intervals",
           "simulate_fixed_size_uniform_intervals", "simulate_variants",
           "simulate_chip_seq_fragments", "simulate_chip_seq_reads",
           "simulate_read_fragments", "ChipSeqSimulationSettings",
           "rnaseq"]
