"""Sorted-key grouping with cross-chunk joining (reference:
bionumpy/streams/groupby_func.py:12-121; the port's copy of
bionumpy_tpu/streams/groupby_func.py)."""
from __future__ import annotations

import itertools

import numpy as np

from ..encoded_array import EncodedArray
from ..encodings.string_encodings import StringEncoding
from ..ragged import RaggedArray
from ..string_array import StringArray
from .decorators import streamable
from .stream import grouped_stream


def get_changes(array) -> np.ndarray:
    """Indices where consecutive rows differ."""
    if isinstance(array, EncodedArray) and \
            isinstance(array.encoding, StringEncoding):
        return np.flatnonzero(array.raw()[1:] != array.raw()[:-1]) + 1
    if isinstance(array, StringArray):
        return np.flatnonzero(array.raw()[1:] != array.raw()[:-1]) + 1
    if isinstance(array, RaggedArray):
        return get_ragged_changes(array)
    array = np.asarray(array.raw() if hasattr(array, "raw") else array)
    array = array.reshape(len(array), -1)
    return np.flatnonzero(np.any(array[1:] != array[:-1], axis=-1)) + 1


def get_ragged_changes(ragged_array: RaggedArray) -> np.ndarray:
    lengths = ragged_array.lengths
    if len(ragged_array) <= 1:
        return np.empty(0, dtype=np.int64)
    changes = lengths[1:] != lengths[:-1]
    flat = ragged_array.ravel()
    flat = flat.raw() if hasattr(flat, "raw") else flat
    # compare each row with the next: gather next-row windows of this row's
    # length (only meaningful where lengths match; mismatches already flagged)
    starts = ragged_array.starts
    this_lens = lengths[:-1]
    within = _within_row(this_lens)
    next_idx = np.minimum(np.repeat(starts[1:], this_lens) + within,
                          max(flat.size - 1, 0))
    this_idx = np.repeat(starts[:-1], this_lens) + within
    neq = flat[next_idx] != flat[this_idx]
    any_neq = RaggedArray(neq.astype(np.int64), this_lens).sum(axis=-1) > 0
    changes = changes | np.asarray(any_neq)
    return np.flatnonzero(changes) + 1


def _within_row(lengths: np.ndarray) -> np.ndarray:
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    row_starts = np.empty(len(lengths), dtype=np.int64)
    row_starts[0] = 0
    np.cumsum(lengths[:-1], out=row_starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(row_starts, lengths)


def join_groupbys(grouped_generator):
    """Merge groups that span chunk boundaries."""
    double_grouped = itertools.groupby(
        itertools.chain.from_iterable(grouped_generator), lambda x: x[0])

    def merge(groups):
        parts = [g[1] for g in groups]
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    merged = ((key, merge(groups)) for key, groups in double_grouped)
    return grouped_stream(
        merged, getattr(grouped_generator, "attribute_name", None))


def key_func(x):
    if hasattr(x, "to_string"):
        return x.to_string()
    if hasattr(x, "tolist") and not isinstance(x, np.ndarray):
        out = x.tolist()
        if isinstance(out, str):
            return out
    return str(x)


@streamable(join_groupbys)
def groupby(data, column: str = None, key: callable = key_func):
    """Group sorted data by the values in `column`, yielding
    (name, batch) pairs.

    Examples
    --------
    >>> import bionumpy_tpu_torch as bnp
    >>> from bionumpy_tpu_torch.streams import groupby
    >>> iv = bnp.Interval(["chr1", "chr1", "chr2"], [0, 5, 1], [3, 8, 4])
    >>> [(name, len(grp)) for name, grp in groupby(iv, "chromosome")]
    [('chr1', 2), ('chr2', 1)]
    """
    if column is not None:
        assert hasattr(data, column), (data.__class__, column)
        keys = getattr(data, column)
    else:
        keys = data
    if len(data) == 0:
        return grouped_stream(iter([]), column)
    changes = get_changes(keys)
    changes = np.append(np.insert(changes, 0, 0), len(data))
    return grouped_stream(
        ((key(keys[start]), data[start:end])
         for start, end in zip(changes[:-1], changes[1:])),
        column)
