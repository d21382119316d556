"""Concatenated-genome coordinate system (reference:
bionumpy/genomic_data/global_offset.py:12-85; the port's copy of
bionumpy_tpu/genomic_data/global_offset.py).

All chromosomes become one long axis (pipeline.binned_pileup_bed rebases
intervals onto it)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..bnpdataclass import replace
from ..encoded_array import EncodedArray, as_encoded_array
from ..encodings.string_encodings import StringEncoding

global_encoding = StringEncoding(["global"])


class GlobalOffset:
    def __init__(self, sequence_sizes, string_encoding=None):
        if isinstance(sequence_sizes, dict):
            self._names = as_encoded_array(list(sequence_sizes.keys()))
            self._sizes = np.array(list(sequence_sizes.values()),
                                   dtype=np.int64)
        else:
            self._names = sequence_sizes.name
            self._sizes = np.asarray(sequence_sizes.size)
        self._offset = np.insert(np.cumsum(self._sizes), 0, 0)
        self._encoding = string_encoding if string_encoding is not None \
            else StringEncoding(self._names)

    def total_size(self) -> int:
        return int(self._sizes.sum())

    def names(self):
        return self._names.tolist()

    def get_offset(self, seq_name):
        seq_name = as_encoded_array(seq_name, target_encoding=self._encoding)
        return self._offset[seq_name.raw()]

    def get_size(self, seq_name):
        seq_name = as_encoded_array(seq_name, target_encoding=self._encoding)
        return self._sizes[seq_name.raw()]

    def from_local_coordinates(self, sequence_name, local_offset):
        mask = np.asarray(local_offset) >= self.get_size(sequence_name)
        if np.any(np.atleast_1d(mask)):
            raise ValueError("Coordinate outside of reference")
        return self.get_offset(sequence_name) + local_offset

    def to_local_coordinates(self,
                             global_offset) -> Tuple[EncodedArray,
                                                     np.ndarray]:
        chromosome_idxs = np.searchsorted(self._offset, global_offset,
                                          side="right") - 1
        local_offset = global_offset - self._offset[chromosome_idxs]
        return (EncodedArray(chromosome_idxs, self._encoding),
                local_offset)

    def to_local_interval(self, global_interval):
        chromosome_idxs = np.searchsorted(
            self._offset, global_interval.start, side="right") - 1
        start = np.asarray(global_interval.start) - \
            self._offset[chromosome_idxs]
        stop = np.asarray(global_interval.stop) - \
            self._offset[chromosome_idxs]
        assert np.all(stop <= self._sizes[chromosome_idxs])
        chromosome = EncodedArray(chromosome_idxs, self._encoding)
        return replace(global_interval, chromosome=chromosome, start=start,
                       stop=stop)

    def from_local_interval(self, interval, do_clip: bool = False):
        start_offsets, stop_offsets = self.start_ends_from_intervals(
            interval, do_clip)
        zeros = EncodedArray(
            np.zeros(len(interval), dtype=np.uint8), global_encoding)
        return replace(interval, chromosome=zeros, start=start_offsets,
                       stop=stop_offsets)

    def start_ends_from_intervals(self, interval, do_clip: bool = False):
        chromosome = as_encoded_array(interval.chromosome,
                                      target_encoding=self._encoding)
        offsets = self.get_offset(chromosome)
        sizes = self.get_size(chromosome)
        starts = np.asarray(interval.start)
        if np.any(starts >= sizes):
            raise ValueError("Interval start beyond chromosome size")
        stop = np.asarray(interval.stop)
        if do_clip:
            stop = np.minimum(stop, sizes)
        else:
            assert np.all(stop <= sizes)
        return starts + offsets, stop + offsets
