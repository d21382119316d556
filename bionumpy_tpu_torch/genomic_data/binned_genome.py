"""Fixed-bin counting of locations over the genome (reference:
bionumpy/genomic_data/binned_genome.py:7-44; the port's copy of
bionumpy_tpu/genomic_data/binned_genome.py)."""
from __future__ import annotations

import numpy as np


class BinnedGenome:
    def __init__(self, genome_context, bin_size: int = 1000):
        self._genome_context = genome_context
        self._bin_size = bin_size
        chrom_sizes = np.array(list(genome_context.chrom_sizes.values()))
        self._n_bins = (chrom_sizes + bin_size - 1) // bin_size
        self._bin_offsets = np.insert(np.cumsum(self._n_bins), 0, 0)
        self._counts = np.zeros(self._bin_offsets[-1], dtype=np.int64)

    @classmethod
    def from_file(cls, filename: str, bin_size: int = 1000):
        from .genome import Genome
        genome = Genome.from_file(filename)
        return cls(genome.get_genome_context(), bin_size)

    @property
    def genome_context(self):
        return self._genome_context

    @property
    def bin_size(self) -> int:
        return self._bin_size

    def count(self, entries, position_field: str = "position"):
        chrom_nrs = self._genome_context.encoding.encode(
            entries.chromosome).raw()
        offsets = np.asarray(getattr(entries, position_field)) // \
            self._bin_size
        bin_nr = self._bin_offsets[chrom_nrs] + offsets
        self._counts += np.bincount(bin_nr,
                                    minlength=self._bin_offsets[-1])

    def count_file(self, filename: str, position_field: str = "position"):
        from ..io import bnp_open
        for chunk in bnp_open(filename, "r").read_chunks():
            self.count(chunk, position_field=position_field)

    @property
    def count_dict(self):
        return {chrom: self._counts[self._bin_offsets[i]:
                                    self._bin_offsets[i + 1]]
                for i, chrom in enumerate(self._genome_context.chrom_sizes)}

    def __getitem__(self, chromosome: str):
        i = int(self._genome_context.encoding.encode(chromosome).raw())
        return self._counts[self._bin_offsets[i]: self._bin_offsets[i + 1]]
