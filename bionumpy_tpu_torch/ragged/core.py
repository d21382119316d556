"""Ragged arrays: the port's copy of bionumpy_tpu/ragged/core.py.

- Host representation: one flat 1-D numpy buffer + an int row-length vector
  (offsets are the cumulative sum).  This is the layout the card receives:
  the flat codes are packed into words and the offsets become the row ends
  of the k-mer kernels (ops/resident.py).
- No ndarray subclassing: explicit ``__array_ufunc__`` /
  ``__array_function__`` interception on a plain object.
- A RaggedView gather of more than 1024 byte rows (the columns of the
  delimited readers) takes the host library's one-pass row copy
  (native.gather_rows); other gathers take numpy's index plan.
"""
from __future__ import annotations

from numbers import Number
from typing import List, Sequence, Union

import numpy as np

__all__ = [
    "RaggedShape",
    "RaggedView",
    "RaggedArray",
    "ragged_slice",
    "unsafe_extend_left",
    "unsafe_extend_right",
]


def _as_index_array(x) -> np.ndarray:
    arr = np.asarray(x)
    if arr.dtype == bool:
        raise ValueError("boolean array not valid here")
    return arr.astype(np.int64, copy=False)


class RaggedShape:
    """Shape of a 2-D ragged array: row lengths + derived offsets.

    Mirrors the parts of ``npstructures.RaggedShape`` that bionumpy uses
    (reference usage: bionumpy/io/strops.py:20-54): ``starts``, ``ends``,
    ``lengths`` and ``ravel_multi_index``.
    """

    __slots__ = ("_lengths", "_offsets")

    def __init__(self, lengths):
        if isinstance(lengths, RaggedShape):
            self._lengths = lengths._lengths
            self._offsets = lengths._offsets
            return
        lengths = _as_index_array(lengths)
        if lengths.ndim != 1:
            lengths = lengths.ravel()
        self._lengths = lengths
        self._offsets = None

    @property
    def lengths(self) -> np.ndarray:
        return self._lengths

    @property
    def offsets(self) -> np.ndarray:
        """len(lengths)+1 cumulative offsets (0, l0, l0+l1, ...)."""
        if self._offsets is None:
            out = np.empty(len(self._lengths) + 1, dtype=np.int64)
            out[0] = 0
            np.cumsum(self._lengths, out=out[1:])
            self._offsets = out
        return self._offsets

    @property
    def starts(self) -> np.ndarray:
        return self.offsets[:-1]

    @property
    def ends(self) -> np.ndarray:
        return self.offsets[1:]

    @property
    def n_rows(self) -> int:
        return len(self._lengths)

    @property
    def size(self) -> int:
        return int(self.offsets[-1])

    def ravel_multi_index(self, indices) -> np.ndarray:
        rows, cols = indices
        return self.starts[rows] + np.asarray(cols)

    def view_rows(self, row_index) -> "RaggedView":
        return RaggedView(self.starts[row_index], self._lengths[row_index])

    def __len__(self) -> int:
        return self.n_rows

    def __eq__(self, other) -> bool:
        if not isinstance(other, RaggedShape):
            return NotImplemented
        return len(self._lengths) == len(other._lengths) and bool(
            np.all(self._lengths == other._lengths)
        )

    def __repr__(self) -> str:
        return f"RaggedShape({self._lengths!r})"


class RaggedView:
    """Gather plan: extract per-row slices ``[start, start+length)`` from a
    flat buffer (reference: RaggedView/RaggedView2 used by the file parsers,
    bionumpy/io/file_buffers.py:231-237)."""

    __slots__ = ("starts", "lengths")

    def __init__(self, starts, lengths):
        self.starts = _as_index_array(starts).ravel()
        self.lengths = _as_index_array(lengths)
        if self.lengths.ndim == 0:
            self.lengths = np.full(len(self.starts), int(self.lengths))
        self.lengths = self.lengths.ravel()

    def get_flat_indices(self) -> np.ndarray:
        """Vectorized index plan: out[i] = starts[row(i)] + offset_in_row(i)."""
        lens = self.lengths
        total = int(lens.sum())
        if total == 0:
            return np.empty(0, dtype=np.int64)
        row_out_start = np.empty(len(lens), dtype=np.int64)
        row_out_start[0] = 0
        np.cumsum(lens[:-1], out=row_out_start[1:])
        within = np.arange(total, dtype=np.int64) - np.repeat(row_out_start, lens)
        return within + np.repeat(self.starts, lens)

    def get_shape(self) -> RaggedShape:
        return RaggedShape(self.lengths)


def _gather_view(flat: np.ndarray, view: RaggedView) -> np.ndarray:
    """The rows of `view` from `flat`, packed: byte columns of more than
    1024 rows in one native memcpy pass, the rest (and a plan with rows
    out of bounds) by numpy's index plan."""
    if flat.dtype.itemsize == 1 and flat.flags["C_CONTIGUOUS"] and \
            len(view.starts) > 1024:
        from .. import native
        gathered = native.gather_rows(flat.view(np.uint8), view.starts,
                                      view.lengths)
        if gathered is not None:
            return gathered.view(flat.dtype)
    return flat[view.get_flat_indices()]


def _build_from_nested(data) -> tuple:
    rows = [np.asarray(row).ravel() for row in data]
    lengths = np.array([len(r) for r in rows], dtype=np.int64)
    if rows:
        flat = np.concatenate(rows) if len(rows) > 1 else rows[0].copy()
    else:
        flat = np.empty(0)
    return flat, RaggedShape(lengths)


class RaggedArray:
    """2-D ragged array: flat buffer + row lengths.

    Supports the ``npstructures.RaggedArray`` surface that bionumpy relies on
    (broadcasting ufuncs, row indexing, per-row reductions, padded export).

    Examples
    --------
    >>> from bionumpy_tpu_torch.ragged import RaggedArray
    >>> ra = RaggedArray([[1, 2, 3], [4]])
    >>> ra * 2
    ragged_array([[2, 4, 6], [8]])
    >>> ra.sum(axis=-1)
    array([6, 4])
    """

    def __init__(self, data, shape=None, dtype=None, safe_mode=True):
        if isinstance(data, RaggedArray) and shape is None:
            flat, rshape = data._data, data._shape
        elif shape is None:
            flat, rshape = _build_from_nested(data)
        else:
            flat = np.asarray(data)
            if isinstance(shape, RaggedView):
                flat = _gather_view(flat.ravel(), shape)
                rshape = shape.get_shape()
            else:
                flat = flat.ravel()
                rshape = RaggedShape(shape)
        if dtype is not None:
            flat = flat.astype(dtype, copy=False)
        self._data = flat
        self._shape = rshape

    # -- construction helpers -------------------------------------------------
    @classmethod
    def from_flat(cls, flat, lengths) -> "RaggedArray":
        return cls(flat, RaggedShape(lengths))

    @property
    def _cls(self):
        return self.__class__

    def _wrap(self, flat, shape) -> "RaggedArray":
        return self.__class__(flat, shape)

    # -- basic properties -----------------------------------------------------
    @property
    def lengths(self) -> np.ndarray:
        return self._shape.lengths

    @property
    def starts(self) -> np.ndarray:
        return self._shape.starts

    @property
    def ends(self) -> np.ndarray:
        return self._shape.ends

    @property
    def size(self) -> int:
        return self._data.size

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def shape(self):
        return (len(self), self._shape.lengths)

    @property
    def ndim(self) -> int:
        return 2

    def __len__(self) -> int:
        return self._shape.n_rows

    def __iter__(self):
        offsets = self._shape.offsets
        for i in range(len(self)):
            yield self._data[offsets[i]: offsets[i + 1]]

    def astype(self, dtype) -> "RaggedArray":
        return self._wrap(self._data.astype(dtype), self._shape)

    def copy(self) -> "RaggedArray":
        return self._wrap(self._data.copy(), RaggedShape(self.lengths.copy()))

    def ravel(self) -> np.ndarray:
        return self._data

    def tolist(self) -> List[list]:
        return [row.tolist() for row in self]

    def raw(self):
        return self

    # -- indexing -------------------------------------------------------------
    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            return self._getitem_tuple(idx)
        if isinstance(idx, (int, np.integer)):
            if idx < 0:
                idx += len(self)
            off = self._shape.offsets
            return self._data[off[idx]: off[idx + 1]]
        if isinstance(idx, slice):
            rows = np.arange(len(self))[idx]
            return self._gather_rows(rows)
        idx = np.asarray(idx)
        if idx.dtype == bool:
            if idx.shape == (len(self),):
                return self._gather_rows(np.flatnonzero(idx))
            raise IndexError(f"bad boolean index shape {idx.shape}")
        if isinstance(idx, RaggedArray):
            raise IndexError("ragged boolean indexing: use subset_flat")
        return self._gather_rows(idx.astype(np.int64).ravel()).reshape_like(idx)

    def reshape_like(self, idx) -> "RaggedArray":
        # row gather of a >1-D integer index keeps 2-D ragged semantics here
        return self

    def _gather_rows(self, rows: np.ndarray) -> "RaggedArray":
        view = self._shape.view_rows(rows)
        return self._wrap(self._data[view.get_flat_indices()], view.get_shape())

    def _getitem_tuple(self, idx):
        row_idx, col_idx = idx
        if row_idx is Ellipsis:
            row_idx = slice(None)
        if isinstance(row_idx, (int, np.integer)):
            return self[row_idx][col_idx]
        if isinstance(row_idx, slice) and row_idx == slice(None):
            if isinstance(col_idx, slice):
                return self._col_slice(col_idx)
            col = np.asarray(col_idx)
            if col.ndim == 0:
                flat_idx = self._shape.ravel_multi_index(
                    (np.arange(len(self)), np.where(col < 0, self.lengths + col, col))
                )
                return self._data[flat_idx]
        if isinstance(col_idx, slice):
            rows = np.arange(len(self))[row_idx] \
                if isinstance(row_idx, slice) else np.asarray(row_idx)
            if rows.dtype == bool:
                rows = np.flatnonzero(rows)
            return self._gather_rows(rows)._col_slice(col_idx)
        row = np.asarray(row_idx)
        col = np.asarray(col_idx)
        if row.ndim >= 1 and col.ndim >= 1 or (row.ndim >= 1 and col.ndim == 0):
            col = np.where(col < 0, self.lengths[row] + col, col)
            return self._data[self._shape.ravel_multi_index((row, col))]
        raise IndexError(f"unsupported ragged index {idx}")

    def _col_slice(self, sl: slice) -> "RaggedArray":
        assert sl.step is None or sl.step == 1, sl
        lengths = self.lengths
        start = sl.start if sl.start is not None else 0
        starts = np.where(start < 0, np.maximum(lengths + start, 0), np.minimum(start, lengths))
        if sl.stop is None:
            stops = lengths
        elif sl.stop < 0:
            stops = np.maximum(lengths + sl.stop, 0)
        else:
            stops = np.minimum(sl.stop, lengths)
        new_lens = np.maximum(stops - starts, 0)
        view = RaggedView(self._shape.starts + starts, new_lens)
        return self._wrap(self._data[view.get_flat_indices()], view.get_shape())

    def __setitem__(self, idx, value):
        if isinstance(idx, (int, np.integer)):
            off = self._shape.offsets
            self._data[off[idx]: off[idx + 1]] = value
            return
        if isinstance(idx, slice) and idx == slice(None):
            if isinstance(value, RaggedArray):
                value = value.ravel()
            self._data[:] = value
            return
        if isinstance(idx, tuple):
            row_idx, col_idx = idx
            if isinstance(row_idx, slice):
                rows = np.arange(len(self))[row_idx]
            else:
                rows = np.asarray(row_idx)
                if rows.dtype == bool:
                    rows = np.flatnonzero(rows)
            lengths = self.lengths[rows]
            starts = self._shape.starts[rows]
            if isinstance(col_idx, slice):
                assert col_idx.step in (None, 1)
                c0 = col_idx.start if col_idx.start is not None else 0
                c0 = np.where(c0 < 0, np.maximum(lengths + c0, 0),
                              np.minimum(c0, lengths))
                if col_idx.stop is None:
                    c1 = lengths
                elif col_idx.stop < 0:
                    c1 = np.maximum(lengths + col_idx.stop, 0)
                else:
                    c1 = np.minimum(col_idx.stop, lengths)
                view = RaggedView(starts + c0, np.maximum(c1 - c0, 0))
                flat_idx = view.get_flat_indices()
            else:
                col = np.asarray(col_idx)
                col = np.where(col < 0, lengths + col, col)
                flat_idx = starts + col
            if isinstance(value, RaggedArray):
                value = value.ravel()
            elif hasattr(value, "raw") and not isinstance(value, np.ndarray):
                value = value.raw()
                if isinstance(value, RaggedArray):
                    value = value.ravel()
            if isinstance(value, np.ndarray) and value.ndim > 1 and \
                    value.size == flat_idx.size:
                value = value.ravel()
            self._data[flat_idx] = value
            return
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        view = self._shape.view_rows(idx)
        flat = view.get_flat_indices()
        if isinstance(value, RaggedArray):
            value = value.ravel()
        self._data[flat] = value

    # -- ufuncs / broadcasting ------------------------------------------------
    def _broadcast_other(self, other):
        """Return flat operand aligned with self._data, or None."""
        if isinstance(other, RaggedArray):
            if not (self._shape == other._shape):
                raise ValueError("ragged shape mismatch")
            return other._data
        if isinstance(other, (Number, np.generic)):
            return other
        arr = np.asarray(other)
        if arr.ndim == 0:
            return arr
        if arr.ndim == 2 and arr.shape == (len(self), 1):
            return np.repeat(arr[:, 0], self.lengths)
        if arr.ndim == 1 and arr.shape == (len(self),):
            # column-vector broadcast per row (npstructures semantics use
            # (n, 1); accept (n,) only when unambiguous: data len differs)
            if len(self) == self.size and arr.shape[0] == self.size:
                return arr  # ambiguous, treat as flat
            return np.repeat(arr, self.lengths)
        if arr.ndim == 1 and arr.size == self.size:
            return arr
        raise ValueError(f"cannot broadcast {arr.shape} against ragged array")

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__":
            return NotImplemented
        flat_inputs = []
        for inp in inputs:
            if inp is self or isinstance(inp, RaggedArray):
                flat_inputs.append(inp._data if isinstance(inp, RaggedArray) else inp)
                if isinstance(inp, RaggedArray) and not (inp._shape == self._shape):
                    raise ValueError("ragged shape mismatch")
            else:
                flat_inputs.append(self._broadcast_other(inp))
        out = ufunc(*flat_inputs, **kwargs)
        return self._wrap(out, self._shape)

    def __array_function__(self, func, types, args, kwargs):
        from . import functions

        handler = functions.HANDLED_FUNCTIONS.get(func)
        if handler is None:
            return NotImplemented
        return handler(*args, **kwargs)

    # arithmetic operators via ufunc protocol
    def _binop(self, other, op):
        return self.__array_ufunc__(op, "__call__", self, other)

    def _rbinop(self, other, op):
        other_flat = self._broadcast_other(other)
        return self._wrap(op(other_flat, self._data), self._shape)

    def __add__(self, o): return self._binop(o, np.add)
    def __radd__(self, o): return self._rbinop(o, np.add)
    def __sub__(self, o): return self._binop(o, np.subtract)
    def __rsub__(self, o): return self._rbinop(o, np.subtract)
    def __mul__(self, o): return self._binop(o, np.multiply)
    def __rmul__(self, o): return self._rbinop(o, np.multiply)
    def __truediv__(self, o): return self._binop(o, np.true_divide)
    def __rtruediv__(self, o): return self._rbinop(o, np.true_divide)
    def __floordiv__(self, o): return self._binop(o, np.floor_divide)
    def __mod__(self, o): return self._binop(o, np.mod)
    def __pow__(self, o): return self._binop(o, np.power)
    def __rpow__(self, o): return self._rbinop(o, np.power)
    def __eq__(self, o): return self._binop(o, np.equal)
    def __ne__(self, o): return self._binop(o, np.not_equal)
    def __lt__(self, o): return self._binop(o, np.less)
    def __le__(self, o): return self._binop(o, np.less_equal)
    def __gt__(self, o): return self._binop(o, np.greater)
    def __ge__(self, o): return self._binop(o, np.greater_equal)
    def __and__(self, o): return self._binop(o, np.bitwise_and)
    def __or__(self, o): return self._binop(o, np.bitwise_or)
    def __xor__(self, o): return self._binop(o, np.bitwise_xor)
    def __invert__(self):
        return self._wrap(np.invert(self._data), self._shape)
    def __neg__(self):
        return self._wrap(-self._data, self._shape)
    def __rshift__(self, o): return self._binop(o, np.right_shift)
    def __lshift__(self, o): return self._binop(o, np.left_shift)
    def __abs__(self):
        return self._wrap(np.abs(self._data), self._shape)

    # -- reductions -----------------------------------------------------------
    def _row_reduce(self, ufunc, empty_value=None):
        off = self._shape.offsets
        if self.size == 0:
            if empty_value is None:
                raise ValueError("reduction of empty rows without identity")
            return np.full(len(self), empty_value, dtype=self._data.dtype)
        has_empty = np.any(self.lengths == 0)
        if has_empty and empty_value is None:
            raise ValueError("reduction of empty rows without identity")
        starts = np.minimum(off[:-1], self.size - 1)
        result = ufunc.reduceat(self._data, starts)
        result = np.where(self.lengths == 0,
                          empty_value if empty_value is not None else 0,
                          result)
        # reduceat quirk: when starts[i] >= starts[i+1] it returns data[starts[i]]
        return result

    def _column_counts(self) -> np.ndarray:
        """Number of rows that reach each column index (for axis=0
        reductions over ragged rows; same fold as the reference's
        sum_and_n axis-0 path, bionumpy/computation_graph.py:18-40)."""
        max_len = int(self.lengths.max()) if len(self) else 0
        counts = np.bincount(self.lengths, minlength=max_len + 1)
        return np.cumsum(counts[::-1])[::-1][1:]

    def _column_sum(self, dtype=None):
        data = self._data if dtype is None else self._data.astype(dtype)
        if data.dtype == bool:
            data = data.astype(np.int64)
        max_len = int(self.lengths.max()) if len(self) else 0
        cols = np.arange(self.size, dtype=np.int64) - np.repeat(
            self._shape.starts, self.lengths)
        return np.bincount(cols, weights=data,
                           minlength=max_len).astype(
            np.float64 if np.issubdtype(data.dtype, np.floating)
            else np.int64)

    def sum(self, axis=None, dtype=None, keepdims=False):
        if axis is None:
            return self._data.sum(dtype=dtype)
        if axis in (0, -2):
            res = self._column_sum(dtype=dtype)
            return res[None, :] if keepdims else res
        assert axis in (-1, 1)
        if len(self) == 0:
            res = np.zeros(0, dtype=dtype or self._data.dtype)
        elif self.size == 0:
            res = np.zeros(len(self), dtype=dtype or self._data.dtype)
        else:
            data = self._data if dtype is None else self._data.astype(dtype)
            if data.dtype == bool:
                data = data.astype(np.int64)
            starts = np.minimum(self._shape.starts, self.size - 1)
            res = np.add.reduceat(data, starts)
            # reduceat returns data[start] for empty rows; zero them out
            empty = self.lengths == 0
            if np.any(empty):
                res = np.where(empty, data.dtype.type(0), res)
        if np.issubdtype(res.dtype, np.integer) and dtype is None:
            res = res.astype(np.int64)
        if keepdims:
            res = res[:, None]
        return res

    def mean(self, axis=None, keepdims=False):
        if axis is None:
            return self._data.mean()
        if axis in (0, -2):
            res = self._column_sum() / np.maximum(self._column_counts(), 1)
            return res[None, :] if keepdims else res
        assert axis in (-1, 1)
        res = self.sum(axis=-1) / np.maximum(self.lengths, 1)
        res = np.where(self.lengths == 0, np.nan, res)
        if keepdims:
            res = res[:, None]
        return res

    def max(self, axis=None, keepdims=False):
        if axis is None:
            return self._data.max()
        assert axis in (-1, 1)
        res = self._row_reduce(np.maximum, empty_value=None)
        return res[:, None] if keepdims else res

    def min(self, axis=None, keepdims=False):
        if axis is None:
            return self._data.min()
        assert axis in (-1, 1)
        res = self._row_reduce(np.minimum, empty_value=None)
        return res[:, None] if keepdims else res

    def any(self, axis=None, keepdims=False):
        if axis is None:
            return bool(np.any(self._data))
        assert axis in (-1, 1)
        res = self.sum(axis=-1) if self._data.dtype == bool else (self != 0).sum(axis=-1)
        res = np.asarray(res) > 0
        return res[:, None] if keepdims else res

    def all(self, axis=None, keepdims=False):
        if axis is None:
            return bool(np.all(self._data))
        assert axis in (-1, 1)
        nonzero = (np.asarray(self._data) != 0)
        cnt = self._wrap(nonzero, self._shape).sum(axis=-1)
        res = cnt == self.lengths
        return res[:, None] if keepdims else res

    def argmax(self, axis=-1):
        assert axis in (-1, 1)
        padded = self.as_padded_matrix(fill_value=self._neg_inf())
        return np.argmax(padded, axis=-1)

    def argmin(self, axis=-1):
        assert axis in (-1, 1)
        padded = self.as_padded_matrix(fill_value=self._pos_inf())
        return np.argmin(padded, axis=-1)

    def _neg_inf(self):
        dt = self._data.dtype
        return np.iinfo(dt).min if np.issubdtype(dt, np.integer) else -np.inf

    def _pos_inf(self):
        dt = self._data.dtype
        return np.iinfo(dt).max if np.issubdtype(dt, np.integer) else np.inf

    def cumsum(self, axis=None, dtype=None):
        if axis is None:
            return np.cumsum(self._data, dtype=dtype)
        assert axis in (-1, 1)
        cums = np.cumsum(self._data, dtype=dtype)
        # subtract cumulative total of previous rows
        totals = np.insert(np.cumsum(self.sum(axis=-1)), 0, 0)[:-1]
        out = cums - np.repeat(totals, self.lengths)
        return self._wrap(out, self._shape)

    # -- export ---------------------------------------------------------------
    def as_padded_matrix(self, side="right", fill_value=0, width=None) -> np.ndarray:
        lengths = self.lengths
        n = len(self)
        w = int(width) if width is not None else (int(lengths.max()) if n else 0)
        out = np.full((n, w), fill_value, dtype=self._data.dtype)
        cols = np.arange(w)
        if side == "right":
            mask = cols[None, :] < lengths[:, None]
        else:
            mask = cols[None, :] >= (w - lengths)[:, None]
        out[mask] = self._data
        return out

    def to_numpy_array(self) -> np.ndarray:
        lengths = self.lengths
        if len(self) and not np.all(lengths == lengths[0]):
            raise ValueError("cannot convert ragged rows of unequal length")
        w = int(lengths[0]) if len(self) else 0
        return self._data.reshape(len(self), w)

    def __repr__(self) -> str:
        rows = [str(row.tolist()) for row in self[:8]]
        suffix = ", ..." if len(self) > 8 else ""
        return f"ragged_array([{', '.join(rows)}{suffix}])"

    def __str__(self) -> str:
        return self.__repr__()


def ragged_slice(arr, starts=None, ends=None):
    """Per-row slicing (reference: npstructures.ragged_slice used at
    bionumpy/io/bam.py:77-92).  A FLAT input (1-D ndarray or
    EncodedArray) with explicit starts/ends gathers one window per
    (start, end) pair — the reference's chromosome-sequence window
    extraction (bionumpy/simulate/variants.py ref_seq slices)."""
    flat_input = getattr(arr, "ndim", 0) == 1 and \
        not hasattr(arr, "lengths")
    if flat_input and starts is not None:
        starts = np.asarray(starts, dtype=np.int64)
        stops = np.full(len(starts), len(arr), dtype=np.int64) \
            if ends is None else np.asarray(ends, dtype=np.int64)
        window_lens = np.maximum(np.minimum(stops, len(arr)) - starts, 0)
        idx = RaggedView(starts, window_lens).get_flat_indices()
        if hasattr(arr, "encoding"):  # EncodedArray -> encoded ragged rows
            from ..encoded_array import EncodedRaggedArray
            return EncodedRaggedArray(arr[idx], window_lens)
        return RaggedArray(np.asarray(arr)[idx], window_lens)
    if isinstance(arr, np.ndarray) and arr.ndim == 1:
        arr = RaggedArray(arr, [len(arr)]) if starts is None else arr
    if isinstance(arr, np.ndarray):
        n = len(arr)
        base_starts = np.zeros(n, dtype=np.int64)
        lengths = np.full(n, arr.shape[-1] if arr.ndim > 1 else len(arr))
        flat = arr.ravel()
        row_starts = np.arange(n) * (arr.shape[-1] if arr.ndim > 1 else 0)
    else:
        lengths = arr.lengths
        flat = arr.ravel()
        row_starts = arr.starts
        base_starts = np.zeros(len(arr), dtype=np.int64)
    s = base_starts if starts is None else np.where(np.asarray(starts) < 0,
                                                    lengths + starts, starts)
    e = lengths if ends is None else np.where(np.asarray(ends) < 0, lengths + ends,
                                              np.minimum(ends, lengths))
    new_lens = np.maximum(e - s, 0)
    view = RaggedView(row_starts + s, new_lens)
    cls = arr._cls if isinstance(arr, RaggedArray) else RaggedArray
    return cls(flat[view.get_flat_indices()], view.get_shape())


def unsafe_extend_right(arr: np.ndarray, n: int = 1) -> np.ndarray:
    """Safe re-implementation of npstructures' buffer over-read trick: append
    ``n`` zero elements (reference: bionumpy/io/strops.py:325-336)."""
    return np.append(arr, np.zeros(n, dtype=arr.dtype))


def unsafe_extend_left(arr: np.ndarray, n: int = 1) -> np.ndarray:
    return np.insert(arr, 0, np.zeros(n, dtype=arr.dtype))
