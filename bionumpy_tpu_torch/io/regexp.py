"""Regex over decoded text — deliberate host-side scalar escape hatch
(reference: bionumpy/io/regexp.py)."""
from __future__ import annotations

import re

import numpy as np

from ..encoded_array import (BaseEncoding, EncodedArray, EncodedRaggedArray,
                             as_encoded_array)
from ..string_array import as_string_array


def match_regexp(encoded_array, regexp: str) -> EncodedRaggedArray:
    encoded_array = as_encoded_array(encoded_array)
    matches = re.findall(regexp, encoded_array.to_string())
    return EncodedRaggedArray(
        EncodedArray(np.frombuffer("".join(matches).encode("ascii"),
                                   dtype=np.uint8), BaseEncoding),
        [len(m) for m in matches])


def match_regexp_string_array(encoded_array, regexp: str):
    encoded_array = as_encoded_array(encoded_array)
    return as_string_array(re.findall(regexp, encoded_array.to_string()))
