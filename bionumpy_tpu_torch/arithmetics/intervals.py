"""Interval arithmetic on run-length tracks (reference:
bionumpy/arithmetics/intervals.py; the port's copy of
bionumpy_tpu/arithmetics/intervals.py).  Host numpy but for
get_pileup_device, whose pileup runs on a torch device (ops/tracks.py)."""
from __future__ import annotations

from operator import itemgetter
from typing import List

import numpy as np
import torch

from ..bnpdataclass import bnpdataclass, replace
from ..datatypes import BedGraph, Interval
from ..encodings.string_encodings import StringEncoding
from ..ops.device import resolve_device
from ..ops.tracks import binned_pileup, dense_pileup
from ..ragged.rle import RunLengthArray, RunLengthRaggedArray
from ..streams.decorators import streamable
from ..string_array import StringArray


class GenomicRunLengthArray(RunLengthArray):
    """RLE array with genomics constructors (reference:
    bionumpy/arithmetics/intervals.py:19-128)."""

    @classmethod
    def from_intervals(cls, starts, ends, size: int, values=True,
                       default_value=0) -> "GenomicRunLengthArray":
        starts = np.asarray(starts)
        ends = np.asarray(ends)
        assert np.all(ends > starts)
        assert np.all(starts[1:] >= ends[:-1]), \
            "intervals must be sorted and non-overlapping"
        events = np.empty(2 * len(starts) + 2, dtype=np.int64)
        events[0] = 0
        events[1:-1:2] = starts
        events[2:-1:2] = ends
        events[-1] = size
        if np.isscalar(values) or isinstance(values, (bool, int, float)):
            vals = np.empty(2 * len(starts) + 1,
                            dtype=np.asarray(values).dtype
                            if not isinstance(values, bool) else bool)
            vals[0::2] = default_value
            vals[1::2] = values
        else:
            values = np.asarray(values)
            vals = np.empty(2 * len(starts) + 1, dtype=values.dtype)
            vals[0::2] = default_value
            vals[1::2] = values
        return cls(events, vals, do_clean=True)

    @classmethod
    def from_bedgraph(cls, bedgraph,
                      size=None) -> "GenomicRunLengthArray":
        if len(bedgraph) == 0:
            assert size is not None
            return cls(np.array([0, size], dtype=np.int64), np.array([0]))
        start = np.asarray(bedgraph.start)
        stop = np.asarray(bedgraph.stop)
        value = np.asarray(bedgraph.value)
        missing_idx = np.flatnonzero(start[1:] != stop[:-1])
        if len(missing_idx):
            start = np.insert(start, missing_idx + 1, stop[missing_idx])
            value = np.insert(value, missing_idx + 1, 0)
        if size is not None:
            assert stop[-1] <= size, (stop[-1], size)
        if size is None or size == stop[-1]:
            events = np.append(start, stop[-1])
            values = value
        else:
            events = np.append(start, [stop[-1], size])
            values = np.append(value, 0)
        if events[0] != 0:
            events = np.insert(events, 0, 0)
            values = np.insert(values, 0, 0)
        return cls(events, values)

    def to_bedgraph(self, sequence_name) -> BedGraph:
        return BedGraph([sequence_name] * len(self.starts), self.starts,
                        self.ends, self.values)

    @classmethod
    def from_rle(cls, rle) -> "GenomicRunLengthArray":
        return cls(rle.events, rle.values)


@bnpdataclass
class RawInterval:
    start: int
    stop: int


def get_pileup(intervals, chromosome_size: int) -> GenomicRunLengthArray:
    """Coverage depth per position via event sort + ±1 cumsum
    (reference flat algorithm: bionumpy/arithmetics/bedgraph.py:22-34).

    Examples
    --------
    >>> from bionumpy_tpu_torch.arithmetics import get_pileup
    >>> from bionumpy_tpu_torch.datatypes import Interval
    >>> depth = get_pileup(Interval(["chr1", "chr1"], [0, 8], [10, 20]), 22)
    >>> depth.to_array().astype(int)
    array([1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0])
    """
    if len(intervals) == 0:
        return GenomicRunLengthArray(
            np.array([0, chromosome_size], dtype=np.int64),
            np.array([0], dtype=np.int64))
    starts = np.asarray(intervals.start)
    stops = np.asarray(intervals.stop)
    positions = np.concatenate(([0], starts, stops, [chromosome_size]))
    args = np.argsort(positions, kind="mergesort")
    values = np.where(args >= len(starts) + 1, -1, 1)
    values[0] = 0
    np.cumsum(values, out=values)
    positions = positions[args]
    dup = np.flatnonzero(positions[1:] == positions[:-1])
    positions = np.delete(positions, dup)
    values = np.delete(values, dup)
    return GenomicRunLengthArray(positions, values[:-1], do_clean=True)


def get_pileup_device(intervals, chromosome_size: int,
                      bin_size: int = None, device=None):
    """Device twin of get_pileup: boundary scatter + cumsum on the card
    (ops/tracks.dense_pileup), fetched once and RLE-compressed on the
    host so the result type matches the host path.  With `bin_size`,
    returns the covered-base count per bin instead (ops/tracks.
    binned_pileup), as a host int32 array.  `device`: None is the card,
    which must be present; pass "cpu" to run the plain torch ops on the
    host.

    >>> from bionumpy_tpu_torch.arithmetics import get_pileup_device
    >>> from bionumpy_tpu_torch.datatypes import Interval
    >>> iv = Interval(["chr1", "chr1"], [0, 8], [10, 20])
    >>> get_pileup_device(iv, 22, device="cpu").to_array().astype(int)
    array([1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0])
    >>> get_pileup_device(iv, 22, bin_size=10, device="cpu")
    array([12, 10,  0], dtype=int32)
    """
    device = resolve_device(device)
    starts = np.asarray(intervals.start, dtype=np.int32) \
        if len(intervals) else np.empty(0, np.int32)
    stops = np.asarray(intervals.stop, dtype=np.int32) \
        if len(intervals) else np.empty(0, np.int32)
    starts_d = torch.from_numpy(starts).to(device)
    stops_d = torch.from_numpy(stops).to(device)
    valid = torch.ones(len(starts), dtype=torch.bool, device=device)
    if bin_size is not None:
        n_bins = -(-int(chromosome_size) // bin_size)
        return binned_pileup(starts_d, stops_d, valid, n_bins,
                             bin_size)[:n_bins].cpu().numpy()
    depth = dense_pileup(starts_d, stops_d, valid,
                         int(chromosome_size)).cpu().numpy()
    return GenomicRunLengthArray.from_array(depth)


def get_boolean_mask(intervals, chromosome_size: int):
    """Boolean RLE mask of positions covered by any interval
    (reference: bionumpy/arithmetics/intervals.py:166-221).

    Examples
    --------
    >>> from bionumpy_tpu_torch.arithmetics import get_boolean_mask
    >>> from bionumpy_tpu_torch.datatypes import Interval
    >>> mask = get_boolean_mask(Interval(["chr1"], [5], [12]), 15)
    >>> mask.to_array()
    array([False, False, False, False, False,  True,  True,  True,  True,
            True,  True,  True, False, False, False])
    """
    stops = np.asarray(intervals.stop)
    assert len(intervals) == 0 or np.all(stops <= chromosome_size)
    if len(intervals) == 0:
        return GenomicRunLengthArray(
            np.array([0, int(chromosome_size)], dtype=np.int64),
            np.array([False]))
    merged = merge_intervals(
        intervals[np.argsort(np.asarray(intervals.start))])
    m = np.asarray(merged.start) != np.asarray(merged.stop)
    return GenomicRunLengthArray.from_intervals(
        np.asarray(merged.start)[m], np.asarray(merged.stop)[m],
        size=int(chromosome_size), values=True, default_value=False)


def human_key_func(chrom_name: str):
    assert chrom_name.startswith("chr"), chrom_name
    parts = chrom_name[3:].split("_", maxsplit=1)
    is_numeric = 1 - parts[0].isdigit()
    b = parts[0] if is_numeric else int(parts[0])
    c = parts[-1] if len(parts) == 2 else ""
    return (is_numeric, b, c)


def sort_intervals(intervals, chromosome_key_function=lambda x: x,
                   sort_order: List[str] = None):
    """Sort by (chromosome, start) (reference:
    bionumpy/arithmetics/intervals.py:235-257)."""
    chrom = intervals.chromosome
    if hasattr(chrom, "encoding") and \
            isinstance(chrom.encoding, StringEncoding):
        args = np.lexsort((intervals.start, chrom.raw()))
        return intervals[args]
    if sort_order is not None:
        order_map = {name: i for i, name in enumerate(sort_order)}
        chromosome_key_function = order_map.__getitem__
    names = chrom.tolist()
    starts = np.asarray(intervals.start)
    stops = np.asarray(intervals.stop)
    order = sorted(
        ((chromosome_key_function(str(names[i])), starts[i], stops[i], i)
         for i in range(len(intervals))))
    return intervals[list(map(itemgetter(-1), order))]


def fast_sort_intervals(intervals):
    chrom = intervals.chromosome
    if hasattr(chrom, "encoding") and \
            isinstance(chrom.encoding, StringEncoding):
        return intervals[np.lexsort((intervals.start, chrom.raw()))]
    if isinstance(chrom, StringArray):
        return intervals[np.lexsort((intervals.start, chrom.raw()))]
    raise ValueError("fast_sort_intervals needs StringEncoding or "
                     "StringArray chromosomes")


@streamable()
def merge_intervals(intervals, distance: int = 0):
    """Merge overlapping sorted intervals (reference:
    bionumpy/arithmetics/intervals.py:271-304).

    Examples
    --------
    >>> from bionumpy_tpu_torch.arithmetics import merge_intervals
    >>> from bionumpy_tpu_torch.datatypes import Interval
    >>> merge_intervals(Interval(["chr1", "chr1"], [0, 8], [10, 20]))
    Interval with 1 entries
                   chromosome                    start                     stop
                         chr1                        0                       20
    """
    if len(intervals) == 0:
        return intervals
    starts = np.asarray(intervals.start)
    assert np.all(starts[:-1] <= starts[1:]), \
        "merge_intervals requires intervals sorted on start"
    stops = np.maximum.accumulate(np.asarray(intervals.stop))
    if distance > 0:
        stops = stops + distance
    valid_start_mask = starts[1:] > stops[:-1]
    start_mask = np.concatenate(([True], valid_start_mask))
    stop_mask = np.concatenate((valid_start_mask, [True]))
    new_stops = stops[stop_mask]
    if distance > 0:
        new_stops = new_stops - distance
    return replace(intervals[start_mask], stop=new_stops)


@streamable(sum)
def count_overlap(intervals_a, intervals_b) -> int:
    starts = np.concatenate([intervals_a.start, intervals_b.start])
    stops = np.concatenate([intervals_a.stop, intervals_b.stop])
    starts.sort(kind="mergesort")
    stops.sort(kind="mergesort")
    return int(np.sum(np.maximum(stops[:-1] - starts[1:], 0)))


@streamable()
def intersect(intervals_a, intervals_b):
    """Pairwise intersection of two sorted interval sets on one
    chromosome (reference: bionumpy/arithmetics/intervals.py:318-326).

    Examples
    --------
    >>> from bionumpy_tpu_torch.arithmetics import intersect
    >>> from bionumpy_tpu_torch.datatypes import Interval
    >>> a = Interval(["chr1", "chr1"], [0, 8], [10, 20])
    >>> b = Interval(["chr1"], [5], [12])
    >>> intersect(a, b)
    Interval with 2 entries
                   chromosome                    start                     stop
                         chr1                        5                       10
                         chr1                        8                       12
    """
    all_intervals = np.concatenate([intervals_a, intervals_b])
    all_intervals = all_intervals[
        np.argsort(np.asarray(all_intervals.start), kind="mergesort")]
    stops = np.sort(np.asarray(all_intervals.stop), kind="mergesort")
    mask = stops[:-1] > np.asarray(all_intervals.start)[1:]
    result = all_intervals[1:][mask]
    return replace(result, stop=stops[:-1][mask])


@streamable()
def global_intersect(intervals_a, intervals_b):
    all_intervals = np.concatenate([intervals_a, intervals_b])
    chrom = all_intervals.chromosome
    chrom_key = chrom.raw() if hasattr(chrom, "raw") else chrom
    all_intervals = all_intervals[
        np.lexsort((all_intervals.start, chrom_key))]
    chrom = all_intervals.chromosome
    chrom_key = chrom.raw() if hasattr(chrom, "raw") else chrom
    stops = np.asarray(all_intervals.stop)[
        np.lexsort((all_intervals.stop, chrom_key))]
    mask = stops[:-1] > np.asarray(all_intervals.start)[1:]
    result = all_intervals[1:][mask]
    return replace(result, stop=stops[:-1][mask])


def unique_intersect(intervals_a, intervals_b, genome_size):
    """Entries of a that overlap any interval of b
    (reference: bionumpy/arithmetics/intervals.py:338-341)."""
    genome_mask = get_boolean_mask(intervals_b, genome_size)
    entry_mask = genome_mask[intervals_a].any(axis=-1)
    return intervals_a[entry_mask]


@streamable()
def extend(intervals, both=None, forward=None, reverse=None, left=None,
           right=None):
    directed = (forward is not None) or (reverse is not None)
    undirected = (left is not None) or (right is not None)
    assert sum([both is not None, directed, undirected]) == 1
    starts = np.asarray(intervals.start)
    stops = np.asarray(intervals.stop)
    if both is not None:
        return replace(intervals, start=starts - both, stop=stops + both)
    if undirected:
        new_starts = starts - left if left is not None else starts
        new_stops = stops + right if right is not None else stops
        return replace(intervals, start=new_starts, stop=new_stops)
    forward = forward or 0
    reverse = reverse or 0
    is_forward = np.asarray(intervals.strand.ravel() == "+")
    return replace(
        intervals,
        start=np.where(is_forward, starts - reverse, starts - forward),
        stop=np.where(is_forward, stops + forward, stops + reverse))


def extend_to_size(intervals, fragment_length: int, chromosome_size):
    """Stranded resize keeping 5' anchor (reference:
    bionumpy/arithmetics/intervals.py:375-402)."""
    is_forward = np.asarray(intervals.strand.ravel() == "+")
    starts = np.asarray(intervals.start)
    stops = np.asarray(intervals.stop)
    start = np.where(is_forward, starts,
                     np.maximum(stops - fragment_length, 0))
    stop = np.where(is_forward,
                    np.minimum(starts + fragment_length, chromosome_size),
                    stops)
    return replace(intervals, start=start, stop=stop)


def clip(intervals, chrom_sizes):
    return replace(intervals,
                   start=np.maximum(0, intervals.start),
                   stop=np.minimum(chrom_sizes, intervals.stop))


def pileup(intervals) -> "BedGraph":
    """Flat pileup over one chromosome's intervals: concat starts/stops,
    mergesort, +/-1 cumsum, merge equal-value runs (reference:
    bionumpy/arithmetics/intervals.py:405-423)."""
    from ..datatypes import BedGraph
    chroms = np.concatenate([intervals.chromosome, intervals.chromosome])
    positions = np.concatenate((intervals.start, intervals.stop))
    args = np.argsort(positions, kind="mergesort")
    values = np.where(args >= len(intervals), -1, 1)
    np.cumsum(values, out=values)
    positions = positions[args]
    windows = np.lib.stride_tricks.sliding_window_view(positions, 2)
    mask = np.flatnonzero(windows[:, 0] == windows[:, 1])
    windows = np.delete(windows, mask, axis=0)
    values = np.delete(values, mask)
    mask = np.flatnonzero(values[1:] == values[:-1])
    values = np.delete(values, mask)
    starts = np.delete(windows[:, 0], mask + 1)
    stops = np.delete(windows[:, 1], mask)
    return BedGraph(chroms[: values.size - 1], starts, stops, values[:-1])
