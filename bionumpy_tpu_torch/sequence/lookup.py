"""Encoded-indexed lookup tables (reference: bionumpy/sequence/lookup.py;
the port's copy of bionumpy_tpu/sequence/lookup.py)."""
from __future__ import annotations

from ..encoded_array import BaseEncoding, as_encoded_array


class Lookup:
    def __init__(self, values, encoding=BaseEncoding):
        self._values = values
        self._encoding = encoding

    def _translate(self, idx):
        from ..ragged import RaggedArray
        if isinstance(idx, tuple):
            return tuple(self._translate(i) for i in idx)
        if isinstance(idx, slice) or idx is Ellipsis:
            return idx
        raw = as_encoded_array(idx, self._encoding).raw()
        if isinstance(raw, RaggedArray):
            raw = raw.ravel()
        return raw

    def __getitem__(self, idx):
        return self._values[self._translate(idx)]

    def __setitem__(self, idx, value):
        self._values[self._translate(idx)] = value
