"""Run-length-encoded arrays: the genome-track substrate (the port's copy
of bionumpy_tpu/ragged/rle.py).

Replaces npstructures.RunLengthArray / RunLength2dArray /
RunLengthRaggedArray (reference usage: bionumpy/arithmetics/intervals.py,
bionumpy/genomic_data/genomic_track.py).  Genome-length tracks are
(events, values) pairs, so hg38-scale arrays cost O(#segments) — the
reference's long-sequence strategy: dense windows are materialized on
demand per extraction.  Host numpy throughout; the ragged rows are the
port's ragged/core.py.
"""
from __future__ import annotations

from numbers import Number
from typing import Union

import numpy as np

from .core import RaggedArray, RaggedShape


class RunLengthArray:
    """events: n+1 increasing ints starting at 0; values: n."""

    def __init__(self, events, values, do_clean: bool = False):
        events = np.asarray(events)
        values = np.asarray(values)
        if do_clean:
            events, values = self._clean(events, values)
        self._events = events
        self._values = values

    @staticmethod
    def _clean(events, values):
        # remove empty runs
        lengths = np.diff(events)
        keep = lengths > 0
        values = values[keep[: len(values)]] if len(values) else values
        events = np.concatenate([events[:1][events[:1] == 0],
                                 events[1:][keep]])
        if events.size == 0 or events[0] != 0:
            events = np.insert(events, 0, 0)
        # merge equal adjacent values
        if len(values) > 1:
            same = values[1:] == values[:-1]
            if np.any(same):
                keep_val = np.insert(~same, 0, True)
                values = values[keep_val]
                inner_keep = np.append(~same, True)
                events = np.concatenate([events[:1], events[1:][inner_keep]])
        return events, values

    # -- properties -----------------------------------------------------------
    @property
    def starts(self) -> np.ndarray:
        return self._events[:-1]

    @property
    def ends(self) -> np.ndarray:
        return self._events[1:]

    @property
    def values(self) -> np.ndarray:
        return self._values

    @property
    def events(self) -> np.ndarray:
        return self._events

    @property
    def dtype(self):
        return self._values.dtype

    def __len__(self) -> int:
        return int(self._events[-1]) if len(self._events) else 0

    @property
    def size(self) -> int:
        return len(self)

    @property
    def shape(self):
        return (len(self),)

    def astype(self, dtype) -> "RunLengthArray":
        return self.__class__(self._events, self._values.astype(dtype))

    # -- conversions ----------------------------------------------------------
    @classmethod
    def from_array(cls, array) -> "RunLengthArray":
        array = np.asarray(array)
        if array.size == 0:
            return cls(np.array([0]), array)
        changes = np.flatnonzero(array[1:] != array[:-1]) + 1
        events = np.concatenate([[0], changes, [len(array)]])
        return cls(events, array[np.insert(changes, 0, 0)])

    def to_array(self) -> np.ndarray:
        if len(self) == 0:
            return np.empty_like(self._values, shape=(0,))
        return np.repeat(self._values, np.diff(self._events))

    def tolist(self):
        return self.to_array().tolist()

    def __repr__(self):
        if len(self) < 200:
            return str(self.to_array())
        return (f"RunLengthArray(len={len(self)}, "
                f"{len(self._values)} runs)")

    __str__ = __repr__

    # -- elementwise ----------------------------------------------------------
    def _binary(self, other, op):
        if isinstance(other, (Number, np.generic, bool)):
            return self.__class__(self._events, op(self._values, other),
                                  do_clean=True)
        if isinstance(other, RunLengthArray):
            assert len(self) == len(other), (len(self), len(other))
            events = np.union1d(self._events, other._events)
            mids = events[:-1]
            va = self._values[np.searchsorted(self._events, mids,
                                              side="right") - 1]
            vb = other._values[np.searchsorted(other._events, mids,
                                               side="right") - 1]
            return self.__class__(events, op(va, vb), do_clean=True)
        if isinstance(other, np.ndarray) and other.shape == (len(self),):
            return op(self.to_array(), other)
        return NotImplemented

    def _rbinary(self, other, op):
        return self._binary(other, lambda a, b: op(b, a))

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__":
            return NotImplemented
        if len(inputs) == 1:
            return self.__class__(self._events, ufunc(self._values),
                                  do_clean=True)
        a, b = inputs
        if a is self:
            return self._binary(b, ufunc)
        return self._rbinary(a, ufunc)

    def __add__(self, o): return self._binary(o, np.add)
    def __radd__(self, o): return self._rbinary(o, np.add)
    def __sub__(self, o): return self._binary(o, np.subtract)
    def __rsub__(self, o): return self._rbinary(o, np.subtract)
    def __mul__(self, o): return self._binary(o, np.multiply)
    def __rmul__(self, o): return self._rbinary(o, np.multiply)
    def __truediv__(self, o): return self._binary(o, np.true_divide)
    def __rtruediv__(self, o): return self._rbinary(o, np.true_divide)
    def __and__(self, o): return self._binary(o, np.logical_and if
                                              self.dtype == bool else
                                              np.bitwise_and)
    def __rand__(self, o): return self.__and__(o)
    def __or__(self, o): return self._binary(o, np.logical_or if
                                             self.dtype == bool else
                                             np.bitwise_or)
    def __ror__(self, o): return self.__or__(o)
    def __xor__(self, o): return self._binary(o, np.logical_xor if
                                              self.dtype == bool else
                                              np.bitwise_xor)
    def __invert__(self):
        values = ~self._values if self.dtype != bool else \
            np.logical_not(self._values)
        return self.__class__(self._events, values)
    def __neg__(self):
        return self.__class__(self._events, -self._values)
    def __eq__(self, o): return self._binary(o, np.equal)
    def __ne__(self, o): return self._binary(o, np.not_equal)
    def __lt__(self, o): return self._binary(o, np.less)
    def __le__(self, o): return self._binary(o, np.less_equal)
    def __gt__(self, o): return self._binary(o, np.greater)
    def __ge__(self, o): return self._binary(o, np.greater_equal)

    # -- reductions -----------------------------------------------------------
    def _run_lengths(self) -> np.ndarray:
        return np.diff(self._events)

    def sum(self, axis=None, dtype=None):
        out = np.sum(self._values * self._run_lengths(), dtype=dtype)
        return out

    def mean(self, axis=None):
        return self.sum() / max(len(self), 1)

    def max(self, axis=None):
        return self._values.max()

    def min(self, axis=None):
        return self._values.min()

    def any(self, axis=None):
        return bool(np.any(self._values))

    def all(self, axis=None):
        return bool(np.all(self._values))

    def argmax(self, axis=None):
        return int(self.starts[int(np.argmax(self._values))])

    # -- indexing -------------------------------------------------------------
    def _value_at(self, positions):
        idx = np.searchsorted(self._events, positions, side="right") - 1
        idx = np.minimum(idx, len(self._values) - 1)
        return self._values[idx]

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            if idx < 0:
                idx += len(self)
            return self._values[
                np.searchsorted(self._events, idx, side="right") - 1]
        if isinstance(idx, slice):
            assert idx.step is None or idx.step == 1
            start = idx.start or 0
            stop = len(self) if idx.stop is None else idx.stop
            if start < 0:
                start += len(self)
            if stop < 0:
                stop += len(self)
            stop = min(stop, len(self))
            return self._slice(start, stop)
        if hasattr(idx, "start") and hasattr(idx, "stop") and \
                not isinstance(idx, slice):
            # Interval-like record batch -> per-interval RLE rows
            return self.extract_intervals(np.asarray(idx.start),
                                          np.asarray(idx.stop))
        idx = np.asarray(idx)
        if idx.dtype == bool:
            return self.to_array()[idx]
        if idx.ndim == 1:
            return self._value_at(idx)
        raise IndexError(idx)

    def _slice(self, start: int, stop: int) -> "RunLengthArray":
        first = np.searchsorted(self._events, start, side="right") - 1
        last = np.searchsorted(self._events, stop, side="left")
        events = self._events[first: last + 1].copy()
        values = self._values[first: last]
        if len(events) == 0:
            return self.__class__(np.array([0]), values[:0])
        events[0] = start
        events[-1] = stop
        return self.__class__(events - start, values, do_clean=True)

    def extract_intervals(self, starts, stops) -> "RunLengthRaggedArray":
        return RunLengthRaggedArray.from_rle_and_intervals(self, starts,
                                                           stops)

    def __array_function__(self, func, types, args, kwargs):
        if func is np.concatenate:
            return concatenate_rle(list(args[0]))
        if func is np.histogram:
            rla = args[0]
            return np.histogram(rla._values, *args[1:],
                                weights=rla._run_lengths() *
                                kwargs.pop("weights", 1), **kwargs)
        if func is np.sum:
            return args[0].sum(*args[1:], **kwargs)
        if func is np.mean:
            return args[0].mean()
        if func in (np.max, np.amax):
            return args[0].max(**kwargs)
        if func in (np.min, np.amin):
            return args[0].min(**kwargs)
        if func is np.where:
            cond, a, b = args
            return a._binary(b, lambda x, y: np.where(
                cond if np.isscalar(cond) else cond, x, y)) \
                if isinstance(a, RunLengthArray) else NotImplemented
        return NotImplemented


def concatenate_rle(arrays) -> "RunLengthArray":
    """Concatenate run-length arrays along the (single) axis."""
    cls = type(arrays[0])
    offsets = np.insert(np.cumsum([len(a) for a in arrays]), 0, 0)
    events = np.concatenate(
        [a.events[:-1] + off for a, off in zip(arrays, offsets)] +
        [[offsets[-1]]])
    values = np.concatenate([a.values for a in arrays])
    return cls(events, values, do_clean=True)


class RunLengthRaggedArray:
    """Rows of run-length arrays sharing flat (events, values) buffers —
    the return type of per-interval track extraction (reference:
    npstructures.RunLengthRaggedArray used at
    bionumpy/genomic_data/genomic_track.py:220-239)."""

    def __init__(self, events: RaggedArray, values: RaggedArray,
                 row_lengths: np.ndarray):
        self._events = events  # per-row event offsets (0..row_len)
        self._values = values
        self._row_lengths = np.asarray(row_lengths)

    @classmethod
    def from_rle_and_intervals(cls, rle: RunLengthArray, starts,
                               stops) -> "RunLengthRaggedArray":
        starts = np.asarray(starts)
        stops = np.asarray(stops)
        first = np.searchsorted(rle.events, starts, side="right") - 1
        last = np.searchsorted(rle.events, stops, side="left")
        n_runs = last - first
        # gather per-row runs
        from .core import RaggedView
        values_view = RaggedView(first, n_runs)
        flat_values = rle.values[values_view.get_flat_indices()]
        events_view = RaggedView(first + 1, np.maximum(n_runs - 1, 0))
        inner_events = rle.events[events_view.get_flat_indices()]
        # build per-row event arrays: [0, inner-start, ..., row_len]
        row_lengths = stops - starts
        values_ragged = RaggedArray(flat_values, n_runs)
        event_lens = n_runs + 1
        flat_events = np.zeros(int(event_lens.sum()), dtype=np.int64)
        offsets = np.insert(np.cumsum(event_lens), 0, 0)
        flat_events[offsets[:-1]] = 0
        flat_events[offsets[1:] - 1] = row_lengths
        n_inner = np.maximum(n_runs - 1, 0)
        middle_positions = RaggedView(offsets[:-1] + 1,
                                      n_inner).get_flat_indices()
        flat_events[middle_positions] = inner_events - \
            np.repeat(starts, n_inner)
        ev = RaggedArray(flat_events, event_lens)
        return cls(ev, values_ragged, row_lengths)

    def __len__(self):
        return len(self._row_lengths)

    @property
    def lengths(self) -> np.ndarray:
        return self._row_lengths

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return RunLengthArray(self._events[idx], self._values[idx])
        if isinstance(idx, tuple) and len(idx) == 2 and \
                idx[0] == slice(None) and idx[1] == slice(None, None, -1):
            return self._reversed_rows()
        raise IndexError(idx)

    def _reversed_rows(self) -> "RunLengthRaggedArray":
        """Reverse every row (for minus-strand extraction)."""
        new_events_rows = []
        new_values_rows = []
        for i in range(len(self)):
            ev = np.asarray(self._events[i])
            va = np.asarray(self._values[i])
            new_events_rows.append(self._row_lengths[i] - ev[::-1])
            new_values_rows.append(va[::-1])
        events = RaggedArray(
            np.concatenate(new_events_rows) if new_events_rows
            else np.empty(0, dtype=np.int64), self._events.lengths)
        values = RaggedArray(
            np.concatenate(new_values_rows) if new_values_rows
            else np.empty(0), self._values.lengths)
        return self.__class__(events, values, self._row_lengths)

    def __array_function__(self, func, types, args, kwargs):
        if func is np.where:
            cond, a, b = args
            cond = np.asarray(cond)
            if cond.ndim == 2 and cond.shape[1] == 1:
                cond = cond[:, 0]
            assert isinstance(a, RunLengthRaggedArray) and \
                isinstance(b, RunLengthRaggedArray)
            take_a = cond.astype(bool)
            ev_rows = [np.asarray((a if t else b)._events[i])
                       for i, t in enumerate(take_a)]
            va_rows = [np.asarray((a if t else b)._values[i])
                       for i, t in enumerate(take_a)]
            events = RaggedArray(
                np.concatenate(ev_rows) if ev_rows
                else np.empty(0, dtype=np.int64),
                [len(r) for r in ev_rows])
            values = RaggedArray(
                np.concatenate(va_rows) if va_rows else np.empty(0),
                [len(r) for r in va_rows])
            return self.__class__(events, values, a._row_lengths)
        reducers = {np.max: self.max, np.amax: self.max,
                    np.min: self.min, np.amin: self.min,
                    np.sum: self.sum, np.mean: self.mean,
                    np.any: self.any, np.all: self.all}
        if func in reducers:
            axis = kwargs.pop("axis", -1)
            assert axis in (-1, 1), axis
            assert not kwargs, kwargs
            return reducers[func](axis=-1)
        return NotImplemented

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def _row_run_lengths(self) -> RaggedArray:
        from .core import RaggedView
        flat = np.asarray(self._events.ravel())
        global_diff = np.append(flat[1:] - flat[:-1], 0)
        offsets = np.insert(np.cumsum(self._events.lengths), 0, 0)
        run_counts = self._events.lengths - 1
        positions = RaggedView(offsets[:-1], run_counts).get_flat_indices()
        return RaggedArray(global_diff[positions], run_counts)

    def sum(self, axis=-1) -> np.ndarray:
        weighted = self._values * self._row_run_lengths()
        return np.asarray(weighted.sum(axis=-1))

    def mean(self, axis=-1) -> np.ndarray:
        return self.sum(axis=-1) / np.maximum(self._row_lengths, 1)

    def max(self, axis=-1) -> np.ndarray:
        return self._values.max(axis=-1)

    def min(self, axis=-1) -> np.ndarray:
        return self._values.min(axis=-1)

    def any(self, axis=-1) -> np.ndarray:
        return np.asarray((self._values != 0).sum(axis=-1)) > 0

    def all(self, axis=-1) -> np.ndarray:
        nonzero = (self._values != 0)
        return np.asarray(nonzero.sum(axis=-1)) == self._values.lengths

    def to_array(self, side="right", fill_value=0) -> np.ndarray:
        """Dense padded matrix of the rows."""
        width = int(self._row_lengths.max()) if len(self) else 0
        out = np.full((len(self), width), fill_value,
                      dtype=self._values.ravel().dtype)
        for i in range(len(self)):
            row = self[i].to_array()
            if side == "right":
                out[i, : len(row)] = row
            else:
                out[i, width - len(row):] = row
        return out

    def to_ragged_array(self) -> RaggedArray:
        flat = np.concatenate([self[i].to_array()
                               for i in range(len(self))]) \
            if len(self) else np.empty(0)
        return RaggedArray(flat, self._row_lengths)
