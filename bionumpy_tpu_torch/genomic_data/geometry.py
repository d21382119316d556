"""Legacy pre-Genome geometry API (reference:
bionumpy/genomic_data/geometry.py:13-308; the port's copy of
bionumpy_tpu/genomic_data/geometry.py).

Kept for API parity; the in-memory jaccard-all-vs-all path is the one
the reference's benchmark beats BEDTools with (masks stay resident
between comparisons)."""
from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np

from ..arithmetics.intervals import (GenomicRunLengthArray, clip as
                                     clip_intervals, extend_to_size,
                                     get_boolean_mask, get_pileup,
                                     merge_intervals, sort_intervals)
from ..bnpdataclass import replace
from ..datatypes import BedGraph, ChromosomeSize, Interval
from .genome_context import GenomeContext
from .genomic_track import GenomicArray


class GeometryBase:
    def __init__(self, chrom_sizes: dict):
        self._chrom_sizes = chrom_sizes
        self._genome_context = GenomeContext.from_dict(chrom_sizes,
                                                       filter_function=None)
        self._global_size = self._genome_context.size

    @classmethod
    def from_chrom_sizes(cls, chrom_sizes: ChromosomeSize):
        names = chrom_sizes.name.tolist()
        sizes = np.asarray(chrom_sizes.size)
        return cls({str(name): int(size)
                    for name, size in zip(names, sizes)})

    def chrom_size(self, chromosome: str) -> int:
        return self._chrom_sizes[chromosome]

    def names(self) -> List[str]:
        return list(self._chrom_sizes.keys())

    def size(self) -> int:
        return self._genome_context.size

    def __repr__(self):
        return f"{self.__class__.__name__}({self._chrom_sizes})"


class Geometry(GeometryBase):
    def get_global_mask(self, intervals) -> GenomicRunLengthArray:
        if isinstance(intervals, GenomicRunLengthArray):
            return intervals
        go = self._genome_context.global_offset.from_local_interval(
            intervals)
        return get_boolean_mask(go, self._genome_context.size)

    def jaccard(self, intervals_a, intervals_b) -> float:
        a = self.get_global_mask(intervals_a)
        b = self.get_global_mask(intervals_b)
        intersect = (a & b).sum()
        union = a.sum() + b.sum() - intersect
        assert union >= 0
        return intersect / union

    def jaccard_all_vs_all(self, intervals_list) -> np.ndarray:
        """All-pairs jaccard; masks are computed once and reused."""
        masks = [self.get_global_mask(iv) for iv in intervals_list]
        n = len(masks)
        out = np.eye(n)
        for i in range(n):
            for j in range(i + 1, n):
                intersect = (masks[i] & masks[j]).sum()
                union = masks[i].sum() + masks[j].sum() - intersect
                out[i, j] = out[j, i] = intersect / union if union else 0.0
        return out

    def get_mask(self, intervals) -> GenomicArray:
        return GenomicArray.from_global_data(
            self.get_global_mask(intervals), self._genome_context)

    def get_pileup(self, intervals) -> GenomicArray:
        go = self._genome_context.global_offset.from_local_interval(
            intervals)
        return GenomicArray.from_global_data(
            get_pileup(go, self._genome_context.size),
            self._genome_context)

    def get_track(self, bedgraph: BedGraph) -> GenomicArray:
        return GenomicArray.from_bedgraph(bedgraph, self._genome_context)

    def clip(self, intervals) -> Interval:
        sizes = self._genome_context.global_offset.get_size(
            intervals.chromosome)
        return clip_intervals(intervals, sizes)

    def extend_to_size(self, intervals, fragment_length: int) -> Interval:
        sizes = self._genome_context.global_offset.get_size(
            intervals.chromosome)
        return extend_to_size(intervals, fragment_length, sizes)

    def merge_intervals(self, intervals, distance: int = 0) -> Interval:
        return merge_intervals(intervals, distance=distance)

    def sort(self, intervals) -> Interval:
        return sort_intervals(intervals,
                              sort_order=list(self._chrom_sizes.keys()))


class StreamedGeometry(GeometryBase):
    """Streamed per-chromosome variant working on interval iterables."""

    def get_track(self, bedgraph: Iterable[BedGraph]) -> GenomicArray:
        return GenomicArray.from_bedgraph(bedgraph, self._genome_context)

    def get_pileup(self, intervals: Iterable[Interval]) -> GenomicArray:
        from ..computation_graph import ComputationNode, StreamNode
        from .genomic_track import GenomicArrayNode
        filled = self._genome_context.iter_chromosomes(intervals, Interval)
        from ..streams import BnpStream
        size_stream = StreamNode(iter(
            self._genome_context.chrom_sizes.values()))
        return GenomicArrayNode(
            ComputationNode(get_pileup, [StreamNode(filled), size_stream]),
            self._genome_context)

    def extend_to_size(self, intervals, fragment_length: int):
        from ..computation_graph import ComputationNode, StreamNode
        filled = self._genome_context.iter_chromosomes(intervals, Interval)
        size_stream = StreamNode(iter(
            self._genome_context.chrom_sizes.values()))
        return ComputationNode(extend_to_size,
                               [StreamNode(filled), fragment_length,
                                size_stream])

    def clip(self, intervals):
        from ..computation_graph import ComputationNode, StreamNode
        filled = self._genome_context.iter_chromosomes(intervals, Interval)
        size_stream = StreamNode(iter(
            self._genome_context.chrom_sizes.values()))
        return ComputationNode(clip_intervals,
                               [StreamNode(filled), size_stream])

    def merge_intervals(self, intervals, distance: int = 0):
        from ..computation_graph import ComputationNode, StreamNode
        filled = self._genome_context.iter_chromosomes(intervals, Interval)
        return ComputationNode(merge_intervals, [StreamNode(filled)],
                               {"distance": distance})
