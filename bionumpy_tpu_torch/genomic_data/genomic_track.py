"""Whole-genome arrays over the concatenated coordinate system
(reference: bionumpy/genomic_data/genomic_track.py; the port's copy of
bionumpy_tpu/genomic_data/genomic_track.py)."""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple, Union

import numpy as np

from ..arithmetics.intervals import GenomicRunLengthArray
from ..computation_graph import ComputationNode, Node, StreamNode
from ..datatypes import BedGraph, Interval
from ..ragged.rle import RunLengthRaggedArray, concatenate_rle
from .genome_context import GenomeContext


class GenomicData:
    """Base: indexable by chromosome name, intervals, locations or boolean
    genomic arrays (reference: bionumpy/genomic_data/genomic_data.py)."""

    def __getitem__(self, idx):
        if isinstance(idx, str):
            return self.extract_chromsome(idx)
        if hasattr(idx, "start") and hasattr(idx, "stop") and \
                hasattr(idx, "chromosome"):
            stranded = hasattr(idx, "is_stranded") and idx.is_stranded()
            return self.extract_intervals(idx, stranded=stranded)
        if hasattr(idx, "position") and hasattr(idx, "chromosome"):
            return self.extract_locations(idx)
        if isinstance(idx, list):
            if len(idx) == 0:
                return self.empty()
            if isinstance(idx[0], str):
                return self.extract_chromsome(idx)
        if isinstance(idx, GenomicData) and idx.dtype == bool:
            return self._index_boolean(idx)
        raise ValueError(f"invalid index for GenomicData: {idx!r}")

    @property
    def genome_context(self):
        return self._genome_context

    def extract_chromsome(self, chromosome):
        raise NotImplementedError

    extract_chromosome = extract_chromsome

    def extract_intervals(self, intervals, stranded: bool = False):
        raise NotImplementedError

    def _index_boolean(self, idx):
        raise NotImplementedError


class GenomicArray(GenomicData):
    def sum(self, axis=None):
        raise NotImplementedError

    def to_bedgraph(self) -> "BedGraph":
        raise NotImplementedError

    @classmethod
    def from_global_data(cls, global_pileup: GenomicRunLengthArray,
                         genome_context) -> "GenomicArray":
        return GenomicArrayGlobal(global_pileup, genome_context)

    @classmethod
    def from_bedgraph(cls, bedgraph, genome_context,
                      is_stream: bool = False) -> "GenomicArray":
        if isinstance(bedgraph, BedGraph):
            go = genome_context.global_offset
            gi = go.from_local_interval(bedgraph)
            rle = GenomicRunLengthArray.from_bedgraph(gi, go.total_size())
            return cls.from_global_data(rle, genome_context)
        filled = genome_context.iter_chromosomes(bedgraph, BedGraph)
        interval_stream = StreamNode(filled)
        return GenomicArrayNode(
            ComputationNode(GenomicRunLengthArray.from_bedgraph,
                            [interval_stream,
                             StreamNode(iter(
                                 genome_context.chrom_sizes.values()))]),
            genome_context)

    def _get_intervals_from_data(self, name, data):
        if data.dtype == bool:
            intervals = Interval([name] * len(data.starts), data.starts,
                                 data.ends)
            return intervals[data.values]
        return BedGraph([name] * len(data.starts), data.starts, data.ends,
                        data.values)


class GenomicArrayGlobal(GenomicArray, np.lib.mixins.NDArrayOperatorsMixin):
    def __init__(self, global_track: GenomicRunLengthArray, genome_context):
        assert isinstance(global_track, GenomicRunLengthArray), global_track
        self._global_track = global_track
        self._genome_context = genome_context

    @property
    def dtype(self):
        return self._global_track.dtype

    def _index_boolean(self, idx):
        assert isinstance(idx, GenomicArrayGlobal) and idx.dtype == bool
        return self._global_track[idx._global_track.to_array()]

    def sum(self, axis=None):
        assert axis is None
        return self._global_track.sum()

    def mean(self, axis=None):
        return self._global_track.mean()

    def extract_chromsome(self, chromosome):
        assert isinstance(chromosome, str)
        go = self._genome_context.global_offset
        offset = int(go.get_offset([chromosome])[0])
        size = int(go.get_size([chromosome])[0])
        return self._global_track[offset: offset + size]

    extract_chromosome = extract_chromsome

    def __repr__(self):
        lines = []
        for name, _ in zip(self._genome_context.chrom_sizes, range(10)):
            lines.append(f"{name}: {self[name]}")
        if len(self._genome_context.chrom_sizes) > 10:
            lines.append("...")
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, np.ndarray]:
        go = self._genome_context.global_offset
        names = go.names()
        offsets = go.get_offset(names)
        sizes = go.get_size(names)
        return {name: self._global_track[int(o): int(o) + int(s)].to_array()
                for name, o, s in zip(names, offsets, sizes)}

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        inputs = [i._global_track if isinstance(i, GenomicArrayGlobal)
                  else i for i in inputs]
        result = self._global_track.__array_ufunc__(ufunc, method, *inputs,
                                                    **kwargs)
        if result is NotImplemented:
            return NotImplemented
        return self.__class__(GenomicRunLengthArray.from_rle(result),
                              self._genome_context)

    def __array_function__(self, func, types, args, kwargs):
        args = [i._global_track if isinstance(i, GenomicArrayGlobal)
                else i for i in args]
        if func is np.histogram:
            return np.histogram(*args, **kwargs)
        if func is np.sum:
            return self.sum(*args[1:], **kwargs)
        if func is np.mean:
            return self.mean()
        if func in (np.max, np.amax):
            return np.max(self._global_track, **kwargs)
        if func in (np.min, np.amin):
            return np.min(self._global_track, **kwargs)
        return NotImplemented

    def get_data(self) -> Union[Interval, BedGraph]:
        go = self._genome_context.global_offset
        names = go.names()
        starts = go.get_offset(names)
        stops = starts + go.get_size(names)
        parts = [self._get_intervals_from_data(
            name, self._global_track[int(start): int(stop)])
            for name, start, stop in zip(names, starts, stops)]
        return np.concatenate(parts)

    def to_bedgraph(self) -> BedGraph:
        """Whole-genome BedGraph of the run-length values (reference:
        bionumpy/genomic_data/genomic_track.py:33-34 protocol)."""
        go = self._genome_context.global_offset
        names = go.names()
        starts = go.get_offset(names)
        stops = starts + go.get_size(names)
        parts = []
        for name, start, stop in zip(names, starts, stops):
            rle = self._global_track[int(start): int(stop)]
            parts.append(BedGraph([name] * len(rle.starts), rle.starts,
                                  rle.ends, rle.values))
        return np.concatenate(parts)

    def extract_intervals(self, intervals,
                          stranded: bool = False) -> RunLengthRaggedArray:
        starts, stops = self._genome_context.global_offset \
            .start_ends_from_intervals(intervals)
        rle = self._global_track.extract_intervals(starts, stops)
        if not stranded:
            return rle
        reversed_rows = rle[:, ::-1]
        is_plus = np.asarray(intervals.strand.ravel() == "+")
        return np.where(is_plus[:, np.newaxis], rle, reversed_rows)

    def extract_locations(self, locations) -> np.ndarray:
        positions = self._genome_context.global_offset \
            .from_local_coordinates(locations.chromosome,
                                    locations.position)
        return self._global_track[np.asarray(positions)]

    @classmethod
    def from_dict(cls, d: Dict[str, GenomicRunLengthArray],
                  genome_context=None) -> "GenomicArrayGlobal":
        if genome_context is None:
            genome_context = GenomeContext.from_dict(
                {name: len(a) for name, a in d.items()},
                filter_function=None)
        array = concatenate_rle(
            [GenomicRunLengthArray.from_rle(v) if
             not isinstance(v, GenomicRunLengthArray) else v
             for v in d.values()])
        return cls(GenomicRunLengthArray.from_rle(array), genome_context)

    @classmethod
    def from_stream(cls, stream: Iterable[Tuple[str, GenomicRunLengthArray]],
                    genome_context) -> "GenomicArrayGlobal":
        return cls.from_dict(dict(stream), genome_context)


class GenomicArrayNode(GenomicArray, np.lib.mixins.NDArrayOperatorsMixin):
    """Streamed per-chromosome variant building ComputationNodes
    (reference: bionumpy/genomic_data/genomic_track.py:298-433)."""

    def __init__(self, run_length_node: Node, genome_context):
        self._run_length_node = run_length_node
        self._genome_context = genome_context

    @property
    def dtype(self):
        return None

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        assert method == "__call__"
        inputs = [i._run_length_node if isinstance(i, GenomicArrayNode)
                  else i for i in inputs]
        return self.__class__(ComputationNode(ufunc, inputs, kwargs),
                              self._genome_context)

    def __array_function__(self, func, types, args, kwargs):
        unwrapped = [a._run_length_node if isinstance(a, GenomicArrayNode)
                     else a for a in args]
        node = self._run_length_node.__array_function__(
            func, [Node], unwrapped, kwargs)
        return node

    def sum(self, axis=None):
        return np.sum(self)

    def mean(self, axis=None):
        """Streamed mean over the whole track (a (sum, n) fold; beyond
        the reference, which only routes np.mean through the
        protocol)."""
        return np.mean(self, axis=axis)

    def extract_intervals(self, intervals, stranded: bool = False):
        def _extract(track, ivals):
            return track.extract_intervals(np.asarray(ivals.start),
                                           np.asarray(ivals.stop))
        node = intervals if isinstance(intervals, Node) else None
        if hasattr(intervals, "as_stream"):
            intervals = intervals.as_stream()
        return ComputationNode(_extract,
                               [self._run_length_node,
                                getattr(intervals, "_intervals_node",
                                        intervals)])

    def extract_chromsome(self, chromosome):
        raise NotImplementedError(
            "chromosome extraction not supported on streamed arrays")

    extract_chromosome = extract_chromsome

    def get_data(self):
        names = iter(self._genome_context.chrom_sizes.keys())

        def _convert(track):
            return self._get_intervals_from_data(next(names), track)
        return ComputationNode(_convert, [self._run_length_node])

    def compute(self):
        from ..computation_graph import compute
        chunks = list(self._run_length_node.get_iter())
        track = concatenate_rle(
            [GenomicRunLengthArray.from_rle(c) for c in chunks])
        return GenomicArrayGlobal(GenomicRunLengthArray.from_rle(track),
                                  self._genome_context)

    def to_dict(self):
        return self.compute().to_dict()

    def to_bedgraph(self) -> BedGraph:
        return self.compute().to_bedgraph()

    def extract_locations(self, locations) -> ComputationNode:
        def _extract(track, positions):
            return track[np.asarray(positions)]
        positions = getattr(locations, "position", locations)
        return ComputationNode(_extract,
                               [self._run_length_node, positions])

    @classmethod
    def from_dict(cls, d: Dict[str, GenomicRunLengthArray],
                  genome_context=None) -> "GenomicArrayNode":
        if genome_context is None:
            genome_context = GenomeContext.from_dict(
                {name: len(a) for name, a in d.items()},
                filter_function=None)
        values = [v if isinstance(v, GenomicRunLengthArray)
                  else GenomicRunLengthArray.from_rle(v)
                  for v in d.values()]
        return cls(StreamNode(iter(values)), genome_context)

    @classmethod
    def from_stream(cls, stream: Iterable[Tuple[str, GenomicRunLengthArray]],
                    genome_context) -> "GenomicArrayNode":
        values = (a if isinstance(a, GenomicRunLengthArray)
                  else GenomicRunLengthArray.from_rle(a)
                  for _, a in stream)
        return cls(StreamNode(values), genome_context)

    @property
    def genome_context(self):
        return self._genome_context
