"""Associative stream reductions (reference semantics:
bionumpy/streams/reductions.py:6-23; re-expressed around a
pad-to-common-length combiner; the port's copy of
bionumpy_tpu/streams/reductions.py).

The folds (bincount pad-and-add, histogram add, (sum, n) mean) are
associative, so chunks may be folded in any grouping.
"""
from __future__ import annotations

from functools import reduce

import numpy as np

from .decorators import streamable


def _pad_add(short, long):
    """Add a shorter count vector into a longer one, in place."""
    long[: short.size] += short
    return long


def bincount_reduce(a, b):
    """Combine two bincounts of possibly different lengths."""
    return _pad_add(a, b) if a.size < b.size else _pad_add(b, a)


bincount = streamable(lambda x: reduce(bincount_reduce, x))(np.bincount)


def histogram_reduce(results):
    """Fold per-chunk (hist, edges) pairs: identical edges, summed
    counts."""
    total, edges = None, None
    for hist, chunk_edges in results:
        if total is None:
            total, edges = hist.copy(), chunk_edges
        else:
            total += hist
    return total, edges


histogram = streamable(histogram_reduce)(np.histogram)


def _count_for_axis(array, axis):
    """Denominator contributed by one chunk for a sum-over-axis mean."""
    return len(array) if axis == 0 else array.size


@streamable(sum)
def sum_and_n(array, axis=None):
    """Per-chunk (sum, count) packed in one vector so the stream fold is
    a plain elementwise add."""
    partial = np.sum(array, axis=axis)
    return np.append(partial, _count_for_axis(array, axis))


# row-axis reductions are independent per chunk: concatenation (the
# @streamable() default) IS the fold
_per_row_mean = streamable()(np.mean)


def mean(array, axis=None):
    """Streaming mean.  axis in {None, 0} folds (sum, n) pairs across
    chunks; a row axis concatenates per-chunk row means."""
    if axis not in (None, 0):
        return _per_row_mean(array, axis=axis)
    packed = sum_and_n(array, axis=axis)
    if packed.ndim == 0:
        return packed
    return packed[:-1] / packed[-1]


def quantile(array, quantiles, axis=None):
    """Quantiles of non-negative ints via a cumulative bincount (one
    streaming pass; mirrors the reference's quantile-through-bincount)."""
    cumulative = np.cumsum(bincount(array))
    targets = np.asarray(quantiles) * cumulative[-1]
    return np.searchsorted(cumulative, targets)
