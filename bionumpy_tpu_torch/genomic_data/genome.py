"""User-facing Genome facade (reference:
bionumpy/genomic_data/genome.py:19-445; the port's copy of
bionumpy_tpu/genomic_data/genome.py)."""
from __future__ import annotations

import os
from pathlib import PurePath
from typing import Dict, List, Optional

import numpy as np

from ..bnpdataclass import BNPDataClass, replace
from ..datatypes import BedGraph, Interval, LocationEntry
from ..encoded_array import as_encoded_array
from ..io import buffer_types, bnp_open
from ..io.bam import BamBuffer, BamIntervalBuffer
from ..io.delimited_buffers import Bed6Buffer, BedBuffer
from ..io.indexed_fasta import create_index
from ..io.indexed_files import IndexBuffer, open_indexed
from .annotation import GenomicAnnotation
from .genome_context import GenomeContext, ignore_underscores, keep_all
from .genomic_intervals import GenomicIntervals, GenomicLocation
from .genomic_sequence import GenomicSequence
from .genomic_track import GenomicArray


class Genome:
    def __init__(self, chrom_sizes: Dict[str, int],
                 fasta_filename: str = None, sort_names: bool = False,
                 filter_function=keep_all):
        if sort_names:
            chrom_sizes = {key: chrom_sizes[key]
                           for key in sorted(chrom_sizes)}
        self._genome_context = GenomeContext.from_dict(chrom_sizes,
                                                       filter_function)
        self._fasta_filename = fasta_filename

    @classmethod
    def from_dict(cls, chrom_sizes: Dict[str, int], *args,
                  **kwargs) -> "Genome":
        return cls(chrom_sizes, *args, **kwargs)

    @classmethod
    def from_file(cls, filename: str, sort_names: bool = False,
                  filter_function=ignore_underscores) -> "Genome":
        """Read genome info from chrom.sizes / .fa(.fai) file."""
        path = PurePath(filename)
        suffix = path.suffixes[-1]
        index_file_name = path.with_suffix(path.suffix + ".fai")
        fasta_filename = None
        if suffix in (".fa", ".fasta", ".fna"):
            if not os.path.isfile(index_file_name):
                bnp_open(str(index_file_name), "w",
                         buffer_type=IndexBuffer).write(
                    create_index(path))
            fasta_filename = filename
            filename = index_file_name
        split_lines = (line.split()[:2] for line in open(filename))
        return cls({name: int(length) for name, length in split_lines},
                   fasta_filename=fasta_filename, sort_names=sort_names,
                   filter_function=filter_function)

    def with_ignored_added(self, ignored: List[str]) -> "Genome":
        new = self.__class__.__new__(self.__class__)
        new._genome_context = self._genome_context.with_ignored_added(
            ignored)
        new._fasta_filename = self._fasta_filename
        return new

    @staticmethod
    def _open(filename, stream, buffer_type=None):
        f = bnp_open(str(filename), buffer_type=buffer_type)
        return f.read_chunks() if stream else f.read()

    # -- tracks ---------------------------------------------------------------
    def get_track(self, bedgraph: BedGraph) -> GenomicArray:
        bedgraph = self._mask_data_on_extra_chromosomes(bedgraph)
        return GenomicArray.from_bedgraph(bedgraph, self._genome_context)

    def read_track(self, filename: str,
                   stream: bool = False) -> GenomicArray:
        content = self._open(filename, stream)
        return self.get_track(content)

    # -- intervals ------------------------------------------------------------
    def get_intervals(self, intervals,
                      stranded: bool = False) -> GenomicIntervals:
        """Represent interval data on this genome.

        Examples
        --------
        >>> import bionumpy_tpu_torch as bnp
        >>> peaks = bnp.Interval(chromosome=['chrA', 'chrA', 'chrB'],
        ...                      start=[2, 4, 1], stop=[6, 8, 3])
        >>> genome = bnp.Genome.from_dict({'chrA': 10, 'chrB': 5})
        >>> genome.get_intervals(peaks)
        Genomic Intervals on ['chrA', 'chrB']:
        Interval with 3 entries
                       chromosome                    start                     stop
                             chrA                        2                        6
                             chrA                        4                        8
                             chrB                        1                        3
        >>> genome.get_intervals(peaks).get_pileup()["chrA"]\\
        ...     .to_array().astype(int)
        array([0, 0, 1, 1, 2, 2, 1, 1, 0, 0])
        """
        # NOTE: never probe stream attributes here — a hasattr() on a
        # one-look-ahead NpDataclassStream consumes a chunk.  from_intervals
        # dispatches full-vs-stream itself (reference:
        # bionumpy/genomic_data/genome.py:209).
        return GenomicIntervals.from_intervals(
            intervals, self._genome_context, is_stranded=stranded)

    def read_intervals(self, filename: str, stranded: bool = False,
                       stream: bool = False,
                       buffer_type=None) -> GenomicIntervals:
        if buffer_type is None:
            from ..io.files import _effective_suffix
            buffer_type = buffer_types[_effective_suffix(filename)[0]]
            # interval-producing specializations of the suffix default:
            # stranded BED needs the 6-column variant, BAM the
            # cigar-to-interval projection
            overrides = {(BedBuffer, True): Bed6Buffer,
                         (BamBuffer, True): BamIntervalBuffer,
                         (BamBuffer, False): BamIntervalBuffer}
            buffer_type = overrides.get((buffer_type, stranded),
                                        buffer_type)
        content = self._open(filename, stream, buffer_type=buffer_type)
        return self.get_intervals(content, stranded)

    # -- locations ------------------------------------------------------------
    def get_locations(self, data: LocationEntry,
                      has_numeric_chromosomes=False) -> GenomicLocation:
        if has_numeric_chromosomes:
            data = replace(
                data,
                chromosome=as_encoded_array(
                    ["chr" + c.to_string() for c in data.chromosome]))
        data = self._mask_data_on_extra_chromosomes(data)
        return GenomicLocation.from_data(data, self._genome_context)

    def read_locations(self, filename: str, stranded: bool = False,
                       stream: bool = False, has_numeric_chromosomes=False,
                       buffer_type=None) -> GenomicLocation:
        assert not (stream and has_numeric_chromosomes)
        assert not stranded, "stranded locations not supported yet"
        f = bnp_open(str(filename), buffer_type=buffer_type)
        data = f.read_chunks()
        if not stream:
            data_list = list(data)
            data = np.concatenate(data_list) if data_list else \
                LocationEntry.empty()
        return self.get_locations(
            data, has_numeric_chromosomes=has_numeric_chromosomes)

    def _mask_data_on_extra_chromosomes(self, data,
                                        chromosome_field_name="chromosome"):
        if not isinstance(data, BNPDataClass) or len(data) == 0:
            return data
        encoded = self._genome_context.encoding.encode(
            getattr(data, chromosome_field_name))
        data = replace(data, **{chromosome_field_name: encoded})
        mask = self._genome_context.is_included(encoded)
        return data[mask]

    # -- sequence / annotation ------------------------------------------------
    def read_sequence(self, filename: Optional[str] = None
                      ) -> GenomicSequence:
        if filename is None:
            assert self._fasta_filename is not None
            filename = self._fasta_filename
        return GenomicSequence.from_indexed_fasta(
            open_indexed(str(filename)),
            genome_context=self._genome_context)

    def read_annotation(self, filename: str) -> GenomicAnnotation:
        gtf_entries = self._open(filename, stream=False)
        return GenomicAnnotation.from_gtf_entries(gtf_entries,
                                                  self._genome_context)

    # -- misc -----------------------------------------------------------------
    def get_genome_context(self) -> GenomeContext:
        return self._genome_context

    @property
    def size(self) -> int:
        return self._genome_context.size

    def __repr__(self):
        return f"{self.__class__.__name__}({self._genome_context!r})"

    def __str__(self):
        lines = [f"{'Chromosome':>20}{'Size':>15}"]
        for key, value in self._genome_context.chrom_sizes.items():
            if "_" not in key:
                lines.append(f"{key:>20}{value:>15}")
        return "\n".join(lines)
