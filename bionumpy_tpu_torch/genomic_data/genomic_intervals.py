"""Genomic intervals and locations (reference:
bionumpy/genomic_data/genomic_intervals.py; the port's copy of
bionumpy_tpu/genomic_data/genomic_intervals.py)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..arithmetics.intervals import (RawInterval, clip, extend_to_size,
                                     get_boolean_mask, get_pileup,
                                     merge_intervals)
from ..bnpdataclass import BNPDataClass, replace
from ..computation_graph import ComputationNode, Node, StreamNode
from ..datatypes import (Bed6, Interval, LocationEntry, StrandedInterval,
                         StrandedLocationEntry)
from ..encoded_array import EncodedArray, as_encoded_array
from ..string_array import StringArray
from .genomic_track import GenomicArray
from .coordinate_mapping import find_indices


class GenomicPlace:
    @property
    def genome_context(self):
        return self._genome_context

    def get_data_field(self, field_name: str):
        raise NotImplementedError

    def set_strand(self, strand):
        raise NotImplementedError


class GenomicLocation(GenomicPlace):
    @classmethod
    def from_fields(cls, genome_context, chromosome: List[str],
                    position: List[int],
                    strand: Optional[List[str]] = None) -> "GenomicLocation":
        is_stranded = strand is not None
        if is_stranded:
            data = StrandedLocationEntry(chromosome, position, strand)
        else:
            data = LocationEntry(chromosome, position)
        data = genome_context.mask_data(data)
        return GenomicLocationGlobal(data, genome_context, is_stranded)

    @classmethod
    def from_data(cls, data, genome_context, is_stranded=None,
                  chromosome_name: str = "chromosome",
                  position_name: str = "position") -> "GenomicLocation":
        if isinstance(data, Node) or not isinstance(data, BNPDataClass):
            if not isinstance(data, BNPDataClass):
                # chunk stream -> per-chromosome stream node
                entry_class = StrandedLocationEntry if is_stranded else \
                    LocationEntry
                data = StreamNode(
                    genome_context.iter_chromosomes(data, entry_class))
            return GenomicLocationStreamed(
                data, genome_context, bool(is_stranded),
                field_dict={"chromosome": chromosome_name,
                            "position": position_name,
                            "strand": "strand"})
        if is_stranded is None:
            is_stranded = hasattr(data, "strand")
        return GenomicLocationGlobal(data, genome_context, is_stranded,
                                     chromosome_name=chromosome_name,
                                     position_name=position_name)


class GenomicLocationGlobal(GenomicLocation):
    def __init__(self, locations, genome_context, is_stranded: bool,
                 chromosome_name: str = "chromosome",
                 position_name: str = "position"):
        self._locations = locations
        self._genome_context = genome_context
        self._is_stranded = is_stranded
        self._chromosome_name = chromosome_name
        self._position_name = position_name

    @property
    def data(self):
        return self._locations

    def __len__(self):
        return len(self._locations)

    def __repr__(self):
        return f"Genomic locations on {self._genome_context}"

    def __replace__(self, **kwargs):
        return self.__class__(replace(self._locations, **kwargs),
                              self._genome_context, self._is_stranded,
                              self._chromosome_name, self._position_name)

    @property
    def chromosome(self):
        return getattr(self._locations, self._chromosome_name)

    @property
    def position(self):
        return getattr(self._locations, self._position_name)

    @property
    def strand(self):
        assert self._is_stranded
        return self._locations.strand

    def is_stranded(self) -> bool:
        return self._is_stranded

    def get_data_field(self, field_name: str):
        return getattr(self._locations, field_name)

    def __getitem__(self, idx):
        return self.__class__(self._locations[idx], self._genome_context,
                              self._is_stranded, self._chromosome_name,
                              self._position_name)

    def get_windows(self, flank: Optional[int] = None,
                    window_size: Optional[int] = None) -> "GenomicIntervals":
        """Clipped windows around the locations."""
        assert (flank is None) != (window_size is None), \
            "specify exactly one of flank/window_size"
        if flank is None:
            flank_left = window_size // 2
            flank_right = window_size // 2 + window_size % 2
        else:
            # full window is flank*2 + 1 wide, centered on the position
            flank_left = flank
            flank_right = flank + 1
        position = np.asarray(self.position)
        starts = position - flank_left
        stops = position + flank_right
        if self._is_stranded:
            intervals = StrandedInterval(self.chromosome, starts, stops,
                                         self.strand)
        else:
            intervals = Interval(self.chromosome, starts, stops)
        return GenomicIntervals.from_intervals(
            intervals, self._genome_context,
            is_stranded=self._is_stranded).clip()

    def sorted(self) -> "GenomicLocationGlobal":
        chrom = as_encoded_array(self.chromosome,
                                 self._genome_context.encoding)
        args = np.lexsort((self.position, chrom.raw()))
        return self[args]


class GenomicLocationStreamed(GenomicLocation):
    """Per-chromosome lazily evaluated locations: attribute access
    builds ComputationNodes evaluated chromosome-by-chromosome
    (reference: bionumpy/genomic_data/genomic_intervals.py:291-443)."""

    is_stream = True

    def __init__(self, data_node: Node, genome_context,
                 is_stranded: bool = False,
                 field_dict: Optional[dict] = None):
        if field_dict is None:
            field_dict = {name: name
                          for name in ("chromosome", "position", "strand")}
        self._data_node = data_node
        self._genome_context = genome_context
        self._is_stranded = is_stranded
        self._field_dict = field_dict

    def __repr__(self):
        return "GLS:" + str(self._data_node)

    def is_stranded(self) -> bool:
        return self._is_stranded

    def _field_node(self, name: str) -> ComputationNode:
        return ComputationNode(getattr, [self._data_node, name])

    @property
    def chromosome(self) -> ComputationNode:
        return self._field_node(self._field_dict["chromosome"])

    @property
    def position(self) -> ComputationNode:
        return self._field_node(self._field_dict["position"])

    @property
    def strand(self) -> ComputationNode:
        assert self._is_stranded
        return self._field_node(self._field_dict["strand"])

    def get_data_field(self, field_name: str) -> ComputationNode:
        return self._field_node(field_name)

    def sorted(self):
        return NotImplemented

    def __getitem__(self, idx):
        return self.__class__(
            ComputationNode(lambda x, i: x[i], [self._data_node, idx]),
            self._genome_context, self._is_stranded, self._field_dict)

    def get_windows(self, flank: Optional[int] = None,
                    window_size: Optional[int] = None) -> "GenomicIntervals":
        """Clipped windows around the locations, as streamed intervals."""
        assert (flank is None) != (window_size is None), \
            "specify exactly one of flank/window_size"
        if flank is None:
            flank_left = window_size // 2
            flank_right = window_size // 2 + window_size % 2
        else:
            flank_left = flank
            flank_right = flank + 1
        position = self.position
        if self._is_stranded:
            intervals = ComputationNode(
                StrandedInterval, [self.chromosome, position - flank_left,
                                   position + flank_right, self.strand])
        else:
            intervals = ComputationNode(
                Interval, [self.chromosome, position - flank_left,
                           position + flank_right])
        return GenomicIntervalsStreamed(
            intervals, self._genome_context,
            is_stranded=self._is_stranded).clip()

    def compute(self) -> "GenomicLocationGlobal":
        chunks = [c for c in ComputationNode(
            lambda d: d, [self._data_node]).get_iter() if len(c)]
        data = np.concatenate(chunks) if chunks else LocationEntry.empty()
        return GenomicLocationGlobal(
            data, self._genome_context, self._is_stranded,
            chromosome_name=self._field_dict["chromosome"],
            position_name=self._field_dict["position"])


class GenomicIntervals(GenomicPlace):
    @classmethod
    def from_intervals(cls, intervals, genome_context,
                       is_stranded: Optional[bool] = None
                       ) -> "GenomicIntervalsFull":
        if not isinstance(intervals, BNPDataClass):
            # a chunk stream (reference dispatches the same way:
            # bionumpy/genomic_data/genomic_intervals.py:585-588)
            return cls.from_interval_stream(
                intervals, genome_context,
                is_stranded=bool(is_stranded))
        if is_stranded is None:
            is_stranded = hasattr(intervals, "strand")
        intervals = genome_context.mask_data(intervals)
        return GenomicIntervalsFull(intervals, genome_context, is_stranded)

    @classmethod
    def from_interval_stream(cls, interval_stream, genome_context,
                             is_stranded: bool = False
                             ) -> "GenomicIntervalsStreamed":
        interval_class = StrandedInterval if is_stranded else Interval
        grouped = genome_context.iter_chromosomes(interval_stream,
                                                  interval_class)
        return GenomicIntervalsStreamed(StreamNode(grouped), genome_context,
                                        is_stranded)

    @classmethod
    def from_fields(cls, genome_context, chromosome, start, stop,
                    strand=None) -> "GenomicIntervalsFull":
        if strand is None:
            intervals = Interval(chromosome, start, stop)
        else:
            intervals = StrandedInterval(chromosome, start, stop, strand)
        return cls.from_intervals(intervals, genome_context)

    @classmethod
    def from_track(cls, track: GenomicArray) -> "GenomicIntervalsFull":
        data = track.get_data()
        return cls.from_intervals(data, track.genome_context)


class GenomicIntervalsFull(GenomicIntervals):
    is_stream = False

    def __init__(self, intervals, genome_context, is_stranded=False):
        self._intervals = intervals
        self._genome_context = genome_context
        self._is_stranded = is_stranded

    @property
    def data(self):
        return self._intervals

    def get_data(self):
        return self._intervals

    def __len__(self):
        return len(self._intervals)

    def __repr__(self):
        return (f"Genomic Intervals on {self._genome_context}:\n"
                f"{self._intervals}")

    def __array_function__(self, func, types, args, kwargs):
        if func is np.concatenate:
            return self.__class__(
                np.concatenate([obj._intervals for obj in args[0]]),
                self._genome_context, self._is_stranded)
        return NotImplemented

    def __getitem__(self, idx):
        return self.__class__(self._intervals[idx], self._genome_context,
                              self._is_stranded)

    def __replace__(self, **kwargs):
        return self.__class__(replace(self._intervals, **kwargs),
                              self._genome_context, self._is_stranded)

    @property
    def start(self):
        return self._intervals.start

    @property
    def stop(self):
        return self._intervals.stop

    @property
    def chromosome(self):
        return self._intervals.chromosome

    @property
    def strand(self):
        if not self._is_stranded:
            raise ValueError("Unstranded interval has no strand")
        return self._intervals.strand

    def is_stranded(self) -> bool:
        return self._is_stranded

    def get_data_field(self, field_name: str):
        return getattr(self._intervals, field_name)

    def sorted(self) -> "GenomicIntervalsFull":
        args = np.lexsort([self.stop, self.start,
                           self.chromosome.raw()])
        return self[args]

    def get_location(self, where: str = "start") -> GenomicLocation:
        if where in ("start", "stop"):
            if not self.is_stranded():
                data = self._intervals
                if where == "stop":
                    data = replace(data, start=np.asarray(data.stop) - 1)
            else:
                location = np.where(
                    np.asarray(self.strand.ravel() == "+"),
                    np.asarray(self.start) if where == "start"
                    else np.asarray(self.stop) - 1,
                    np.asarray(self.stop) - 1 if where == "start"
                    else np.asarray(self.start))
                data = replace(self._intervals, start=location)
        else:
            assert where == "center"
            location = (np.asarray(self.start) +
                        np.asarray(self.stop)) // 2
            data = replace(self._intervals, start=location)
        return GenomicLocationGlobal.from_data(
            data, self._genome_context, is_stranded=self.is_stranded(),
            position_name="start")

    def extended_to_size(self, size: int) -> "GenomicIntervalsFull":
        chrom_sizes = self._genome_context.global_offset.get_size(
            self._intervals.chromosome)
        return self.from_intervals(
            extend_to_size(self._intervals, size, chrom_sizes),
            self._genome_context)

    def merged(self, distance: int = 0) -> "GenomicIntervalsFull":
        assert distance == 0, \
            "distance merging might cross chromosome boundaries"
        go = self._genome_context.global_offset
        global_intervals = go.from_local_interval(self._intervals)
        global_merged = merge_intervals(
            global_intervals[np.argsort(
                np.asarray(global_intervals.start), kind="mergesort")])
        return self.from_intervals(go.to_local_interval(global_merged),
                                   self._genome_context)

    def get_pileup(self) -> GenomicArray:
        go = self._genome_context.global_offset.from_local_interval(
            self._intervals)
        return GenomicArray.from_global_data(
            get_pileup(go, self._genome_context.size),
            self._genome_context)

    def get_mask(self) -> GenomicArray:
        starts, stops = self._genome_context.global_offset \
            .start_ends_from_intervals(self._intervals)
        global_mask = get_boolean_mask(RawInterval(starts, stops),
                                       self._genome_context.size)
        return GenomicArray.from_global_data(global_mask,
                                             self._genome_context)

    def clip(self) -> "GenomicIntervalsFull":
        chrom_sizes = self._genome_context.global_offset.get_size(
            self._intervals.chromosome)
        return self.__replace__(
            start=np.maximum(0, np.asarray(self.start)),
            stop=np.minimum(chrom_sizes, np.asarray(self.stop)))

    def map_locations(self, locations):
        """Map locations into interval-relative coordinates
        (reference: genomic_intervals.py:664-689)."""
        go = self._genome_context.global_offset
        global_intervals = go.from_local_interval(self._intervals)
        global_positions = go.from_local_coordinates(locations.chromosome,
                                                     locations.position)
        order = np.argsort(np.asarray(global_positions), kind="mergesort")
        sorted_positions = np.asarray(global_positions)[order]
        location_indices, interval_indices = find_indices(
            sorted_positions, global_intervals)
        new_entries = locations[order][location_indices]
        names = self._intervals.name if hasattr(self._intervals, "name") \
            else StringArray(np.arange(len(self._intervals)).astype("S"))
        return replace(
            new_entries, chromosome=names[interval_indices],
            position=np.asarray(new_entries.position) -
            np.asarray(self.start)[interval_indices])

    def compute(self):
        return self

    def as_stream(self) -> "GenomicIntervalsStreamed":
        interval_class = StrandedInterval if self._is_stranded else Interval
        filled = self._genome_context.iter_chromosomes(self._intervals,
                                                       interval_class)
        return GenomicIntervalsStreamed(StreamNode(filled),
                                        self._genome_context,
                                        self._is_stranded)

    def get_sorted_stream(self) -> "GenomicIntervalsStreamed":
        """Sort, then stream per chromosome (reference:
        bionumpy/genomic_data/genomic_intervals.py:845-847)."""
        return self.sorted().as_stream()


class GenomicIntervalsStreamed(GenomicIntervals):
    """Per-chromosome lazily evaluated intervals (reference:
    bionumpy/genomic_data/genomic_intervals.py:853-998)."""

    is_stream = True

    def __init__(self, intervals_node: Node, genome_context,
                 is_stranded=False):
        self._intervals_node = intervals_node
        self._genome_context = genome_context
        self._is_stranded = is_stranded
        self._chrom_size_node = StreamNode(
            iter(genome_context.chrom_sizes.values()))

    def is_stranded(self):
        return self._is_stranded

    @property
    def start(self):
        return ComputationNode(lambda iv: iv.start, [self._intervals_node])

    @property
    def stop(self):
        return ComputationNode(lambda iv: iv.stop, [self._intervals_node])

    @property
    def chromosome(self):
        return ComputationNode(lambda iv: iv.chromosome,
                               [self._intervals_node])

    @property
    def strand(self):
        assert self._is_stranded
        return ComputationNode(lambda iv: iv.strand,
                               [self._intervals_node])

    def __replace__(self, **kwargs):
        return self.__class__(
            ComputationNode(lambda iv, **kw: replace(iv, **kw),
                            [self._intervals_node], kwargs),
            self._genome_context, self._is_stranded)

    def sorted(self):
        return self.__class__(
            ComputationNode(
                lambda iv: iv[np.lexsort((iv.stop, iv.start))],
                [self._intervals_node]),
            self._genome_context, self._is_stranded)

    def merged(self, distance: int = 0):
        return self.__class__(
            ComputationNode(merge_intervals,
                            [self._intervals_node],
                            {"distance": distance}),
            self._genome_context, self._is_stranded)

    def extended_to_size(self, size: int):
        return self.__class__(
            ComputationNode(extend_to_size,
                            [self._intervals_node, size,
                             self._chrom_size_node]),
            self._genome_context, self._is_stranded)

    def clip(self):
        return self.__class__(
            ComputationNode(clip, [self._intervals_node,
                                   self._chrom_size_node]),
            self._genome_context, self._is_stranded)

    def get_pileup(self):
        from .genomic_track import GenomicArrayNode
        return GenomicArrayNode(
            ComputationNode(get_pileup, [self._intervals_node,
                                         self._chrom_size_node]),
            self._genome_context)

    def get_mask(self):
        from .genomic_track import GenomicArrayNode
        return GenomicArrayNode(
            ComputationNode(get_boolean_mask, [self._intervals_node,
                                               self._chrom_size_node]),
            self._genome_context)

    def get_data(self):
        return ComputationNode(lambda iv: iv, [self._intervals_node])

    def as_stream(self):
        return self

    def compute(self) -> GenomicIntervalsFull:
        chunks = [c for c in ComputationNode(
            lambda iv: iv, [self._intervals_node]).get_iter() if len(c)]
        data = np.concatenate(chunks) if chunks else Interval.empty()
        return GenomicIntervalsFull(data, self._genome_context,
                                    self._is_stranded)

    def get_location(self, where: str = "start") -> GenomicLocation:
        """Streamed locations at 'start' of the intervals (reference:
        bionumpy/genomic_data/genomic_intervals.py:980-998)."""
        assert where == "start" and not self.is_stranded(), \
            "streamed get_location supports where='start', unstranded"
        return GenomicLocationStreamed(
            self._intervals_node, self._genome_context, False,
            field_dict={"chromosome": "chromosome", "position": "start",
                        "strand": "strand"})

    def __repr__(self):
        return f"Streamed genomic intervals on {self._genome_context}"
