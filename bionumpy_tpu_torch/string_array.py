"""Fixed-width identifier array (sequence names, chromosome ids).

Reference: bionumpy/string_array.py:6-152.  Backed by a numpy 'S' array
(fixed-width byte rows).  The port's copy of bionumpy_tpu/string_array.py.
"""
from __future__ import annotations

import numpy as np

from .encoded_array import (BaseEncoding, EncodedArray, EncodedRaggedArray)


class StringArray:
    def __init__(self, data):
        self._data = np.asarray(data, dtype="S")

    @property
    def encoding(self):
        return None

    @property
    def size(self): return self._data.size

    @property
    def shape(self): return self._data.shape

    @property
    def ndim(self): return self._data.ndim

    @property
    def T(self): return self.__class__(self._data.T)

    def __len__(self): return len(self._data)

    def raw(self) -> np.ndarray:
        return self._data

    def copy(self):
        return self.__class__(self._data.copy())

    def as_bytes(self) -> np.ndarray:
        data = self._data
        if not data.flags["C_CONTIGUOUS"]:
            data = data.flatten()
        itemsize = data.dtype.itemsize
        if itemsize == 0:
            return np.zeros(data.shape + (0,), dtype=np.uint8)
        return data.view(np.uint8).reshape(data.shape + (-1,))

    @property
    def lengths(self) -> np.ndarray:
        return np.count_nonzero(self.as_bytes(), axis=-1)

    def ravel(self):
        raveled = self.as_bytes().ravel()
        return self.__class__(raveled[raveled != 0].view("S1"))

    def tolist(self):
        byte_list = self._data.tolist()
        if isinstance(byte_list, bytes):
            return byte_list.decode()
        return [s.decode() if isinstance(s, bytes) else
                [b.decode() for b in s] for s in byte_list]

    to_string = tolist

    def to_ragged(self) -> EncodedRaggedArray:
        byte_matrix = self.as_bytes().reshape(len(self._data.ravel()), -1)
        mask = byte_matrix != 0
        return EncodedRaggedArray(
            EncodedArray(byte_matrix[mask], BaseEncoding), mask.sum(axis=-1))

    def _convert_operand(self, value):
        if isinstance(value, str):
            return value.encode("ascii")
        if isinstance(value, StringArray):
            return value.raw()
        if isinstance(value, (EncodedArray, EncodedRaggedArray)):
            return string_array(value).raw()
        return np.asarray(value, dtype="S")

    def __eq__(self, other):
        return self._data == self._convert_operand(other)

    def __ne__(self, other):
        return self._data != self._convert_operand(other)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__" or ufunc.__name__ not in ("equal", "not_equal"):
            return NotImplemented
        a, b = [self._convert_operand(i) if not isinstance(i, np.ndarray) else i
                for i in inputs]
        return a == b if ufunc.__name__ == "equal" else a != b

    def __array_function__(self, func, types, args, kwargs):
        if func is np.isin:
            target = args[1]
            if isinstance(target, list) and all(isinstance(t, str) for t in target):
                target = as_string_array(target)
            elif not isinstance(target, StringArray):
                return NotImplemented
            return np.isin(self._data, target.raw())
        if func is np.concatenate:
            if not all(isinstance(a, StringArray) for a in args[0]):
                return NotImplemented
            return self.__class__(np.concatenate([a.raw() for a in args[0]]))
        if func is np.unique:
            return self.__class__(np.unique(args[0].raw(), **kwargs))
        if func is np.argsort:
            return np.argsort(args[0].raw(), **kwargs)
        if func is np.lexsort:
            arrays = [a.raw() if isinstance(a, StringArray) else np.asarray(a)
                      for a in args[0]]
            return np.lexsort(arrays)
        if func is np.zeros_like:
            return self.__class__(np.zeros_like(args[0].raw()))
        return NotImplemented

    def __getitem__(self, item):
        out = self._data[item]
        return self.__class__(out)

    def __setitem__(self, item, value):
        self._data[item] = self._convert_operand(value)

    def __iter__(self):
        return (self.__class__(x) for x in self._data)

    def __repr__(self):
        if self._data.ndim == 0:
            return self._data.tolist().decode()
        if self._data.ndim == 1:
            return "\n".join(b.decode() for b in self._data[:5].tolist())
        return "\n".join("\t".join(b.decode() for b in line)
                         for line in self._data[:5].tolist())


def string_array(input_data) -> StringArray:
    """Construct a StringArray from lists/arrays/encoded arrays
    (reference: bionumpy/string_array.py:126-150)."""
    if isinstance(input_data, list) and len(input_data) > 0 and \
            isinstance(input_data[0], StringArray):
        return string_array([i.raw() for i in input_data])
    if isinstance(input_data, (list, str)):
        return StringArray(np.array(input_data, dtype="S"))
    if isinstance(input_data, np.ndarray):
        return StringArray(input_data)
    if isinstance(input_data, StringArray):
        return input_data.copy()
    if isinstance(input_data, (EncodedRaggedArray, EncodedArray)):
        if input_data.encoding != BaseEncoding:
            input_data = input_data.encoding.decode(input_data)
        raw = input_data.raw()
        if isinstance(input_data, EncodedRaggedArray):
            if len(input_data) == 0:
                return StringArray(np.array([], dtype="S"))
            raw = raw.as_padded_matrix(side="right")
        raw = np.ascontiguousarray(raw, dtype=np.uint8)
        n_bytes = raw.shape[-1]
        if n_bytes == 0:
            return StringArray(np.array([b""] * len(raw), dtype="S1"))
        return StringArray(raw.reshape(len(raw), -1).flatten().view(f"|S{n_bytes}"))
    if hasattr(input_data, "to_numpy"):
        return string_array(input_data.to_numpy().tolist())
    raise TypeError(f"cannot convert {type(input_data)} to StringArray")


def as_string_array(input_data) -> StringArray:
    if isinstance(input_data, StringArray):
        return input_data
    return string_array(input_data)
