"""'True'/'False' string <-> bool encoding (reference:
bionumpy/encodings/bool_encoding.py:9-35)."""
from __future__ import annotations

from typing import List

import numpy as np

from ..encoded_array import EncodedArray, Encoding
from .string_encodings import StringEncoding


class BoolStringEncoding(Encoding):
    returns_raw = True

    def __init__(self, true_string: str = "True", false_string: str = "False"):
        self._true_string = true_string
        self._false_string = false_string
        self._string_encoding = StringEncoding([false_string, true_string])

    def get_labels(self) -> List[str]:
        return [self._false_string, self._true_string]

    def encode(self, data):
        return self._string_encoding.encode(data).raw().astype(bool)

    def decode(self, encoded_array):
        values = EncodedArray(np.asarray(encoded_array).astype(int),
                              self._string_encoding)
        return self._string_encoding.decode(values)


bool_string = BoolStringEncoding()
