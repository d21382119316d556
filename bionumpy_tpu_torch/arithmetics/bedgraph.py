"""Bedgraph helpers (reference: bionumpy/arithmetics/bedgraph.py; the
port's copy of bionumpy_tpu/arithmetics/bedgraph.py)."""
from __future__ import annotations

from functools import reduce

import numpy as np

from ..datatypes import BedGraph
from ..ragged.rle import RunLengthArray


def sum_largest(stream):
    return reduce(
        lambda a, b: np.pad(a, (0, max(a.size, b.size) - a.size)) +
        np.pad(b, (0, max(a.size, b.size) - b.size)), stream)


def value_hist(graph) -> np.ndarray:
    weights = np.asarray(graph.stop) - np.asarray(graph.start)
    return np.bincount(np.asarray(graph.value).astype(int),
                       weights=weights)


def from_runlength_array(chromosome_name, rle_array) -> BedGraph:
    return BedGraph([chromosome_name] * len(rle_array.starts),
                    rle_array.starts, rle_array.ends, rle_array.values)


def get_pileup(intervals, size: int) -> RunLengthArray:
    from .intervals import get_pileup as _pileup
    return _pileup(intervals, size)
