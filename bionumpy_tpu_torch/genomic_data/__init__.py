"""Genome-wide data: genomes, intervals, locations, tracks, sequences and
annotations over one genome context (the port's copy of
bionumpy_tpu/genomic_data/)."""
from .annotation import Exons, Genes, GenomicAnnotation, Transcripts
from .binned_genome import BinnedGenome
from .genome import Genome
from .genome_context import GenomeContext, GenomeError
from .genomic_intervals import (GenomicIntervals, GenomicIntervalsFull,
                                GenomicIntervalsStreamed, GenomicLocation,
                                GenomicLocationGlobal)
from .genomic_sequence import GenomicSequence
from .genomic_track import (GenomicArray, GenomicArrayGlobal,
                            GenomicArrayNode, GenomicData)
from .global_offset import GlobalOffset
from .geometry import Geometry, StreamedGeometry

__all__ = ["Genome", "GenomeContext", "GenomeError", "GlobalOffset",
           "GenomicArray", "GenomicArrayGlobal", "GenomicArrayNode",
           "GenomicData", "GenomicIntervals", "GenomicIntervalsFull",
           "GenomicIntervalsStreamed", "GenomicLocation",
           "GenomicLocationGlobal", "GenomicSequence",
           "GenomicAnnotation", "Genes", "Transcripts", "Exons",
           "BinnedGenome", "Geometry", "StreamedGeometry"]

from .genome_context import ignore_underscores, keep_all  # noqa: E402,F401
