"""Encodings + EncodedArray/EncodedRaggedArray: the data model (the
port's copy of bionumpy_tpu/encoded_array.py).

Public surface: `Encoding`, `OneToOneEncoding`, `NumericEncoding`,
`BaseEncoding`, `EncodedArray`, `EncodedRaggedArray`, `as_encoded_array`,
`change_encoding`, `from_encoded_array`, `EncodedLookup`.

- encode/decode are 256-entry LUT gathers on the host (numpy); the
  encoding object carries its LUTs as plain arrays, so the device paths
  upload the same table (ops/parse.py).
- no ndarray subclassing; EncodedArray is a thin wrapper around a numpy
  ``.data`` buffer.
- the two mutation paths (``__setitem__`` of EncodedArray and of
  EncodedRaggedArray) drop the array's device-resident copy
  (ops/resident.invalidate), so a later device call uploads it anew.
"""
from __future__ import annotations

from numbers import Number
from typing import List, Union

import numpy as np

from .ragged import RaggedArray, RaggedShape


class EncodingException(Exception):
    pass


class IncompatibleEncodingsException(Exception):
    pass


class Encoding:
    """Base for all encodings (reference: bionumpy/encoded_array.py:16-35)."""

    def encode(self, *args, **kwargs):
        raise NotImplementedError

    def get_labels(self):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.encode(*args, **kwargs)

    def is_base_encoding(self) -> bool:
        return False

    def is_one_to_one_encoding(self) -> bool:
        return False

    def is_numeric(self) -> bool:
        return False


class OneToOneEncoding(Encoding):
    """Element-wise invertible encoding; dispatches over
    str / List[str] / ndarray / RaggedArray inputs
    (reference semantics: bionumpy/encoded_array.py:38-117)."""

    def encode(self, data):
        if isinstance(data, (EncodedArray, EncodedRaggedArray)):
            if not data.encoding.is_base_encoding():
                raise EncodingException(
                    f"can only encode base-encoded data, got {data.encoding}")
            data = data.raw()
        if isinstance(data, str):
            return self._encode_string(data)
        if isinstance(data, list):
            return self._encode_list(data)
        if isinstance(data, RaggedArray):
            encoded = self.encode(data.ravel())
            if isinstance(encoded, EncodedArray):
                return EncodedRaggedArray(encoded, RaggedShape(data.lengths))
            return RaggedArray(encoded, RaggedShape(data.lengths))
        if isinstance(data, np.ndarray):
            out = self._encode(data)
            if self.is_numeric():
                return out
            return EncodedArray(out, self)
        raise TypeError(f"cannot encode {type(data)}")

    def _encode_string(self, string: str):
        byte_array = np.frombuffer(string.encode("ascii"), dtype=np.uint8)
        out = self._encode(byte_array)
        if self.is_numeric():
            return out
        return EncodedArray(out, self)

    def _encode_list(self, strings: List[str]):
        if len(strings) == 0:
            flat = np.empty(0, dtype=np.uint8)
            lengths = np.empty(0, dtype=np.int64)
        else:
            joined = "".join(strings)
            flat = np.frombuffer(joined.encode("ascii"), dtype=np.uint8)
            lengths = np.array([len(s) for s in strings], dtype=np.int64)
        out = self._encode(flat)
        if self.is_numeric():
            return RaggedArray(out, lengths)
        return EncodedRaggedArray(EncodedArray(out, self), RaggedShape(lengths))

    def decode(self, data):
        if isinstance(data, (int, np.integer)):
            return EncodedArray(self._decode(np.atleast_1d(data)), BaseEncoding)
        if isinstance(data, EncodedRaggedArray):
            return EncodedRaggedArray(
                EncodedArray(self._decode(data.raw().ravel()), BaseEncoding),
                RaggedShape(data.lengths))
        if isinstance(data, EncodedArray):
            return EncodedArray(self._decode(data.raw()), BaseEncoding)
        if isinstance(data, RaggedArray):
            assert self.is_numeric()
            return RaggedArray(self._decode(data.ravel()), RaggedShape(data.lengths))
        if isinstance(data, np.ndarray):
            assert self.is_numeric(), data
            return self._decode(data)
        raise TypeError(f"cannot decode {type(data)} with {self}")

    def is_one_to_one_encoding(self) -> bool:
        return True


class ASCIIEncoding(OneToOneEncoding):
    """Identity encoding over raw ASCII bytes (reference
    bionumpy/encoded_array.py:121-146)."""

    def _encode(self, byte_array):
        return np.asarray(byte_array, dtype=np.uint8)

    def _decode(self, encoded):
        return np.asarray(encoded, dtype=np.uint8)

    def is_base_encoding(self) -> bool:
        return True

    def __repr__(self):
        return "ASCIIEncoding()"

    def __eq__(self, other):
        return isinstance(other, ASCIIEncoding)

    def __hash__(self):
        return hash("ASCIIEncoding")


class NumericEncoding(OneToOneEncoding):
    def is_numeric(self) -> bool:
        return True


BaseEncoding = ASCIIEncoding()


class EncodedArray:
    """1-D/2-D array of encoded symbols + its encoding tag
    (reference: bionumpy/encoded_array.py:239-500)."""

    def __init__(self, data, encoding: Encoding):
        if isinstance(data, EncodedArray):
            assert data.encoding == encoding, (data.encoding, encoding)
            data = data.data
        self.encoding = encoding
        self.data = np.asarray(data, dtype=None if hasattr(data, "dtype") else np.uint8)

    # -- numpy-ish surface ----------------------------------------------------
    @property
    def size(self): return self.data.size

    @property
    def ndim(self): return self.data.ndim

    @property
    def shape(self): return self.data.shape

    @property
    def dtype(self): return self.data.dtype

    @property
    def T(self): return self.__class__(self.data.T, self.encoding)

    def __len__(self): return len(self.data)

    def raw(self) -> np.ndarray:
        return self.data

    def copy(self):
        return self.__class__(self.data.copy(), self.encoding)

    def reshape(self, *args, **kwargs):
        return self.__class__(self.data.reshape(*args, **kwargs), self.encoding)

    def ravel(self):
        return self.__class__(self.data.ravel(), self.encoding)

    def astype(self, dtype):
        return self.__class__(self.data.astype(dtype), self.encoding)

    def to_string(self) -> str:
        if not self.encoding.is_one_to_one_encoding():
            return self.encoding.to_string(self.data)
        raw = self.encoding.decode(self).raw()
        raw = np.atleast_1d(np.asarray(raw, dtype=np.uint8))
        return bytes(raw).decode("ascii")

    def tolist(self):
        if not self.encoding.is_one_to_one_encoding() and \
                self.data.ndim >= 1:
            # categorical (e.g. StringEncoding): one label per element
            return [self.encoding.to_string(e) for e in self.data]
        return self.to_string()

    def __str__(self):
        if not self.encoding.is_one_to_one_encoding():
            if self.data.ndim == 0:
                return self.encoding.to_string(self.data)
            shown = self.data if self.data.ndim == 1 else self.data[:10]
            return "[" + ", ".join(self.encoding.to_string(e).strip() for e in shown) + "]"
        if self.data.ndim == 0:
            return chr(int(self.encoding.decode(self).raw()))
        if self.data.ndim == 1:
            return self.to_string()
        return str(np.array([str(self.__class__(row, self.encoding))
                             for row in self.data.reshape(-1, self.data.shape[-1])]
                            ).reshape(self.data.shape[:-1])[:20])

    def __repr__(self):
        quotes = "'" if self.encoding.is_one_to_one_encoding() else ""
        if self.encoding.is_base_encoding():
            return f"encoded_array({quotes}{self}{quotes})"
        return f"encoded_array({quotes}{self}{quotes}, {self.encoding})"

    def __hash__(self):
        return hash(self.to_string())

    def __iter__(self):
        return (self.__class__(e, self.encoding) for e in self.data)

    def __getitem__(self, idx):
        new_data = self.data[idx]
        if isinstance(new_data, RaggedArray):
            return EncodedRaggedArray(
                EncodedArray(new_data.ravel(), self.encoding),
                RaggedShape(new_data.lengths))
        return self.__class__(new_data, self.encoding)

    def __setitem__(self, idx, value):
        value = as_encoded_array(value, self.encoding)
        self.data[idx] = value.data
        from .ops.resident import invalidate
        invalidate(self)

    # -- comparison -----------------------------------------------------------
    def _comparand(self, other):
        return as_encoded_array(other, self.encoding).raw()

    def __eq__(self, other):
        return np.equal(self.data, self._comparand(other))

    def __ne__(self, other):
        return np.not_equal(self.data, self._comparand(other))

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__" or ufunc.__name__ not in ("equal", "not_equal"):
            return NotImplemented
        if not all(isinstance(a, (str, list, EncodedArray, EncodedRaggedArray))
                   for a in inputs):
            return NotImplemented
        args = [as_encoded_array(a, self.encoding).raw() for a in inputs]
        return ufunc(*args)

    def __array_function__(self, func, types, args, kwargs):
        if func is np.bincount:
            return np.bincount(args[0].data, *args[1:], **kwargs)
        if func is np.argsort:
            return np.argsort(args[0].data, *args[1:], **kwargs)
        if func is np.concatenate:
            return self.__class__(
                np.concatenate([as_encoded_array(e, self.encoding).raw()
                                for e in args[0]]), self.encoding)
        if func is np.where:
            return self.__class__(np.where(args[0], args[1].data, args[2].data),
                                  self.encoding)
        if func is np.zeros_like:
            return self.__class__(np.zeros_like(args[0].data, *args[1:], **kwargs),
                                  self.encoding)
        if func is np.append:
            return self.__class__(np.append(args[0].data, args[1].data,
                                            *args[2:], **kwargs), self.encoding)
        if func is np.insert:
            return self.__class__(np.insert(args[0].data, args[1], args[2].data,
                                            *args[3:], **kwargs), self.encoding)
        if func is np.full_like:
            return full_like(*args, **kwargs)
        if func is np.lexsort:
            arrays = [a.raw() if isinstance(a, EncodedArray) else np.asarray(a)
                      for a in args[0]]
            return np.lexsort(arrays)
        if func in (np.lib.stride_tricks.sliding_window_view,
                    np.lib.stride_tricks.as_strided):
            return self.__class__(func(args[0].data, *args[1:], **kwargs),
                                  self.encoding)
        if func is np.unique:
            return np.unique(args[0].data, **kwargs)
        if func is np.repeat:
            return self.__class__(np.repeat(args[0].data, *args[1:], **kwargs),
                                  self.encoding)
        if func is np.atleast_1d:
            return self.__class__(np.atleast_1d(args[0].data), self.encoding)
        return NotImplemented

    def as_strided(self, *args, **kwargs):
        """Strided view over the raw codes, re-wrapped (reference method:
        bionumpy/encoded_array.py:487-500 — use with care)."""
        assert isinstance(self.data, np.ndarray)
        return self.__class__(
            np.lib.stride_tricks.as_strided(self.data, *args, **kwargs),
            self.encoding)


class EncodedRaggedArray(RaggedArray):
    """Ragged array of encoded symbols (reference:
    bionumpy/encoded_array.py:161-232)."""

    def __init__(self, data, shape=None, *args, safe_mode=True, **kwargs):
        if isinstance(data, EncodedRaggedArray) and shape is None:
            self._encoding = data.encoding
            super().__init__(data.ravel().raw(), RaggedShape(data.lengths))
            return
        assert isinstance(data, EncodedArray), type(data)
        self._encoding = data.encoding
        super().__init__(data.raw(), shape, *args, **kwargs)

    @property
    def encoding(self):
        return self._encoding

    @property
    def _cls(self):
        enc = self._encoding
        cls = self.__class__
        return lambda data, shape: cls(EncodedArray(data, enc), shape)

    def _wrap(self, flat, shape):
        if np.asarray(flat).dtype == bool or np.issubdtype(np.asarray(flat).dtype,
                                                           np.floating):
            return RaggedArray(flat, shape)
        return self.__class__(EncodedArray(flat, self._encoding), shape)

    def raw(self) -> RaggedArray:
        return RaggedArray(self._data, RaggedShape(self.lengths))

    def ravel(self) -> EncodedArray:
        return EncodedArray(self._data, self._encoding)

    def copy(self):
        return self.__class__(EncodedArray(self._data.copy(), self._encoding),
                              RaggedShape(self.lengths.copy()))

    def __iter__(self):
        off = self._shape.offsets
        for i in range(len(self)):
            yield EncodedArray(self._data[off[i]: off[i + 1]], self._encoding)

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return EncodedArray(super().__getitem__(idx), self._encoding)
        out = super().__getitem__(idx)
        if isinstance(out, RaggedArray) and not isinstance(out, EncodedRaggedArray):
            return self.__class__(EncodedArray(out.ravel(), self._encoding),
                                  RaggedShape(out.lengths))
        if isinstance(out, np.ndarray):
            return EncodedArray(out, self._encoding)
        return out

    def __setitem__(self, idx, value):
        value = as_encoded_array(value, self._encoding)
        if isinstance(value, (EncodedArray, EncodedRaggedArray)):
            raw = value.raw()
            raw = raw.ravel() if isinstance(raw, RaggedArray) else raw
        else:
            raw = value
        super().__setitem__(idx, raw)
        from .ops.resident import invalidate
        invalidate(self)

    def _broadcast_other(self, other):
        if isinstance(other, (str, list, EncodedArray, EncodedRaggedArray)):
            other = as_encoded_array(other, self._encoding)
            if isinstance(other, EncodedArray):
                if other.ndim == 0 or other.size == 1:
                    return other.raw().ravel()[0] if other.ndim else other.raw()
                return super()._broadcast_other(other.raw())
            return super()._broadcast_other(other.raw())
        return super()._broadcast_other(other)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__":
            return NotImplemented
        flat_inputs = []
        for inp in inputs:
            if inp is self:
                flat_inputs.append(self._data)
            else:
                flat_inputs.append(self._broadcast_other(inp))
        out = ufunc(*flat_inputs, **kwargs)
        return self._wrap(out, RaggedShape(self.lengths))

    def __eq__(self, other): return self.__array_ufunc__(np.equal, "__call__", self, other)
    def __ne__(self, other): return self.__array_ufunc__(np.not_equal, "__call__", self, other)

    def tolist(self):
        return [row.to_string() for row in self]

    def __repr__(self):
        if len(self) == 0:
            return "encoded_ragged_array([])"
        rows = [str(row) for row in self[: min(len(self), 8)]]
        quotes = "'" if self.encoding.is_one_to_one_encoding() else ""
        body = ",\n ".join(f"{quotes}{r}{quotes}" for r in rows)
        suffix = ", ..." if len(self) > 8 else ""
        enc = "" if self.encoding.is_base_encoding() else f", {self.encoding}"
        return f"encoded_ragged_array([{body}{suffix}]{enc})"

    __str__ = __repr__


def _list_of_encoded_arrays(array_list):
    encoding = array_list[0].encoding
    assert all(a.encoding == encoding for a in array_list)
    if all(a.data.ndim == 0 for a in array_list):
        return EncodedArray(np.array([a.data for a in array_list]), encoding)
    flat = np.concatenate([np.atleast_1d(a.data) for a in array_list])
    lengths = [a.size for a in array_list]
    return EncodedRaggedArray(EncodedArray(flat, encoding), lengths)


def as_encoded_array(s, target_encoding: Encoding = None):
    """Convert str / List[str] / arrays to encoded arrays
    (reference semantics: bionumpy/encoded_array.py:547-613).

    Examples
    --------
    >>> import bionumpy_tpu_torch as bnp
    >>> bnp.as_encoded_array(["ACGT", "AC"])
    encoded_ragged_array(['ACGT',
     'AC'])
    >>> bnp.as_encoded_array(["ACGT", "AC"], bnp.DNAEncoding)
    encoded_ragged_array(['ACGT',
     'AC'], AlphabetEncoding('ACGT'))
    """
    if isinstance(s, (EncodedArray, EncodedRaggedArray)):
        if target_encoding is None or s.encoding == target_encoding:
            return s
        if not s.encoding.is_base_encoding():
            if hasattr(s.encoding, "get_alphabet") and hasattr(target_encoding,
                                                               "get_alphabet"):
                raw = s.raw()
                m = int(raw.ravel().max() if isinstance(raw, RaggedArray)
                        else raw.max()) if s.size else 0
                src_alpha = s.encoding.get_alphabet()
                dst_alpha = target_encoding.get_alphabet()
                if src_alpha[:m] == dst_alpha[:m]:
                    if m >= len(dst_alpha):
                        raise EncodingException(
                            f"cannot reinterpret {s.encoding} as {target_encoding}: "
                            f"value {m} out of range")
                    if isinstance(s, EncodedArray):
                        return EncodedArray(s.raw(), target_encoding)
                    return EncodedRaggedArray(
                        EncodedArray(s.ravel().raw(), target_encoding),
                        RaggedShape(s.lengths))
            raise EncodingException(
                f"Trying to encode already encoded array with encoding "
                f"{s.encoding} to encoding {target_encoding}. "
                f"Use change_encoding instead.")
        return target_encoding.encode(s)
    if target_encoding is None:
        target_encoding = BaseEncoding
    if target_encoding.is_numeric():
        if type(s) in (np.ndarray, RaggedArray):
            return s
        if isinstance(s, list) and (len(s) == 0 or
                                    isinstance(s[0], (list, Number, np.ndarray))):
            return RaggedArray(s)
    elif isinstance(s, list) and len(s) > 0 and isinstance(s[0], EncodedArray):
        return _list_of_encoded_arrays(s)
    if not isinstance(s, (EncodedArray, EncodedRaggedArray, RaggedArray)) and \
            hasattr(s, "to_numpy"):
        s = s.to_numpy()
    if isinstance(s, np.ndarray) and (s.dtype == object or
                                      np.issubdtype(s.dtype, np.character)):
        s = [str(x) for x in s.tolist()]
    return target_encoding.encode(s)


def full_like(a, fill_value, dtype=None, order="K", subok=True, shape=None):
    fill = a.encoding.encode(fill_value)
    fill = fill.raw() if hasattr(fill, "raw") else fill
    return EncodedArray(np.full_like(a.raw(), fill, shape=shape), a.encoding)


def from_encoded_array(encoded_array) -> Union[str, List[str]]:
    """Decode into str / List[str] (reference:
    bionumpy/encoded_array.py:627-652)."""
    if isinstance(encoded_array, EncodedRaggedArray):
        return [from_encoded_array(row) for row in encoded_array]
    return encoded_array.to_string()


def change_encoding(encoded_array, new_encoding: Encoding):
    """Decode then re-encode with another encoding
    (reference: bionumpy/encoded_array.py:655-696).

    Examples
    --------
    >>> import bionumpy_tpu_torch as bnp
    >>> from bionumpy_tpu_torch.encoded_array import change_encoding
    >>> base = bnp.as_encoded_array("acgt")
    >>> change_encoding(base, bnp.DNAEncoding)
    encoded_array('ACGT', AlphabetEncoding('ACGT'))
    """
    assert isinstance(encoded_array, (EncodedArray, EncodedRaggedArray))
    new_data = new_encoding.encode(
        encoded_array.encoding.decode(encoded_array.ravel()))
    if isinstance(encoded_array, EncodedArray):
        return EncodedArray(new_data.raw() if hasattr(new_data, "raw") else new_data,
                            new_encoding)
    return EncodedRaggedArray(
        EncodedArray(new_data.raw() if hasattr(new_data, "raw") else new_data,
                     new_encoding),
        RaggedShape(encoded_array.lengths))


class EncodedLookup:
    """Lookup table indexed by encoded symbols
    (reference: bionumpy/encoded_array.py:698-716)."""

    def __init__(self, lookup: np.ndarray, encoding: Encoding):
        self._lookup = lookup
        self._encoding = encoding

    @property
    def encoding(self):
        return self._encoding

    def _translate(self, key):
        if isinstance(key, tuple):
            return tuple(self._translate(k) for k in key)
        out = as_encoded_array(key, self._encoding)
        if isinstance(out, (EncodedArray, EncodedRaggedArray)):
            out = out.raw()
            if isinstance(out, RaggedArray):
                out = out.ravel()
        return out

    def __getitem__(self, key):
        return self._lookup[self._translate(key)]

    def __setitem__(self, key, value):
        self._lookup[self._translate(key)] = value


def encoded_array_from_nparray(column) -> EncodedRaggedArray:
    """S-dtype numpy array -> base-encoded ragged array
    (reference: bionumpy/encoded_array.py:718-726)."""
    if hasattr(column, "raw"):
        column = column.raw()
    if not column.flags["C_CONTIGUOUS"]:
        column = column.flatten()
    byte_matrix = column.view(np.uint8).reshape(len(column), -1)
    mask = byte_matrix != 0
    return EncodedRaggedArray(EncodedArray(byte_matrix[mask], BaseEncoding),
                              mask.sum(axis=-1))
