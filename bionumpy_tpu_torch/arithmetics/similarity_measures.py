"""Interval-set similarity (reference:
bionumpy/arithmetics/similarity_measures.py; the port's copy of
bionumpy_tpu/arithmetics/similarity_measures.py, whose floats it computes
in the same order)."""
from __future__ import annotations

import numpy as np

from ..streams import MultiStream, streamable
from .intervals import get_boolean_mask


@streamable(sum)
def get_contingency_table(intervals_a, intervals_b, sequence_length):
    boolean_a = get_boolean_mask(intervals_a, sequence_length)
    boolean_b = get_boolean_mask(intervals_b, sequence_length)
    not_a = ~boolean_a
    not_b = ~boolean_b
    return np.array([
        [(boolean_a & boolean_b).sum(), (boolean_a & not_b).sum()],
        [(not_a & boolean_b).sum(), (not_a & not_b).sum()]])


def _base_pair_contingency(chromosome_sizes, intervals_a, intervals_b):
    """2x2 base-pair contingency table of two sorted interval sets,
    folded over synchronized per-chromosome streams."""
    ms = MultiStream(chromosome_sizes, a=intervals_a, b=intervals_b)
    return get_contingency_table(ms.a, ms.b, ms.lengths)


def forbes(chromosome_sizes, intervals_a, intervals_b) -> float:
    """Forbes similarity index for two sorted interval sets.

    Examples
    --------
    >>> from bionumpy_tpu_torch.arithmetics import forbes, sort_intervals
    >>> from bionumpy_tpu_torch.datatypes import Interval
    >>> x = Interval.from_entry_tuples([("chr1", 0, 10), ("chr2", 5, 15)])
    >>> y = Interval.from_entry_tuples([("chr2", 0, 10), ("chr1", 5, 20)])
    >>> order = ["chr1", "chr2"]
    >>> forbes({"chr1": 50, "chr2": 50},
    ...        sort_intervals(x, sort_order=order),
    ...        sort_intervals(y, sort_order=order))
    2.0
    """
    table = _base_pair_contingency(chromosome_sizes, intervals_a,
                                   intervals_b)
    (both, a_only), (b_only, _) = table
    in_a, in_b = both + a_only, both + b_only
    return float(both * table.sum() / (in_a * in_b))


def jaccard(chromosome_sizes, intervals_a, intervals_b) -> float:
    """Jaccard similarity index for two sorted interval sets."""
    table = _base_pair_contingency(chromosome_sizes, intervals_a,
                                   intervals_b)
    (both, a_only), (b_only, neither) = table
    return float(both / (table.sum() - neither))
