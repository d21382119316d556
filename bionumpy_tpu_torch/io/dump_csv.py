"""Typed column -> text rendering + column interleave for writers
(reference: bionumpy/io/dump_csv.py)."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..encoded_array import (BaseEncoding, EncodedArray, EncodedRaggedArray,
                             Encoding, as_encoded_array, change_encoding,
                             encoded_array_from_nparray)
from ..encodings.bool_encoding import bool_string
from ..encodings.string_encodings import StringEncoding
from ..ragged import RaggedArray, RaggedShape
from ..string_array import StringArray
from ..typing import SequenceID
from ..util import is_subclass_or_instance
from .strops import (float_to_strings, int_lists_to_strings, ints_to_strings)


def _str_func(column):
    if isinstance(column, StringArray):
        return column.to_ragged()
    if column.encoding == BaseEncoding:
        return column
    if isinstance(column.encoding, StringEncoding):
        return column.encoding.decode(column)
    return change_encoding(column, BaseEncoding)


def _seq_id_func(column):
    if isinstance(column, (EncodedArray, EncodedRaggedArray)):
        # identifiers held as encoded text (e.g. a lazily-overwritten
        # name field) render like any string column
        return _str_func(column)
    if isinstance(column, StringArray):
        column = column.raw()
    return encoded_array_from_nparray(column)


def _optional_ints_to_strings(number, missing_string="."):
    number = np.asarray(number)
    if number.dtype == float:
        missing = np.isnan(number)
        if np.all(missing):
            return as_encoded_array([missing_string] * len(number))
        out = ints_to_strings(np.where(missing, 0, number).astype(np.int64))
        if np.any(missing):
            out = as_encoded_array(
                [missing_string if m else s
                 for m, s in zip(missing, out.tolist())])
        return out
    return ints_to_strings(number)


def _str_matrix_func(column):
    n_rows, n_cols = column.shape
    a = column.as_bytes().reshape(n_rows * n_cols, -1)
    tabs = np.full((n_rows * n_cols, 1), ord("\t"), dtype=np.uint8)
    b = np.hstack([a, tabs]).reshape((n_rows, -1))[:, :-1]
    return EncodedRaggedArray(EncodedArray(b.ravel(), BaseEncoding),
                              np.full(b.shape[0], b.shape[-1]))


def get_column(values, field_type) -> EncodedRaggedArray:
    """Render one typed column as text rows
    (reference: bionumpy/io/dump_csv.py:54-80)."""
    from typing import List as TList
    if is_subclass_or_instance(field_type, Encoding) and \
            field_type != bool_string:
        encoding = field_type if isinstance(field_type, Encoding) \
            else field_type()

        def render_encoded(x):
            if isinstance(x, EncodedRaggedArray):
                return EncodedRaggedArray(
                    EncodedArray(encoding.decode(x.ravel()).raw(),
                                 BaseEncoding),
                    RaggedShape(x.lengths))
            decoded = encoding.decode(x)
            return decoded if isinstance(decoded, EncodedArray) else \
                EncodedArray(decoded, BaseEncoding)
        return render_encoded(values)
    funcs = {
        int: lambda x: ints_to_strings(np.asarray(x).astype(np.int64)),
        Optional[int]: _optional_ints_to_strings,
        str: _str_func,
        bool_string: bool_string.decode,
        SequenceID: _seq_id_func,
        TList[int]: int_lists_to_strings,
        float: float_to_strings,
        Optional[float]: float_to_strings,
        TList[bool]: lambda x: int_lists_to_strings(x.astype(int), sep=""),
        bool: lambda x: ints_to_strings(np.asarray(x).astype(int)),
        TList[str]: _str_matrix_func,
    }
    return funcs[field_type](values)


def join_columns(columns: List[EncodedRaggedArray],
                 sep: str) -> EncodedRaggedArray:
    """Interleave rendered columns + separators into one ragged line buffer
    (reference: bionumpy/io/dump_csv.py:100-130)."""
    def column_lengths(column):
        if isinstance(column, RaggedArray):
            return column.lengths
        if len(column.shape) == 2:
            return np.full(len(column), column.shape[-1])
        return np.ones(len(column), dtype=np.int64)

    lengths = np.stack([column_lengths(c) + 1 for c in columns],
                       axis=-1).ravel()
    lines = EncodedRaggedArray(
        EncodedArray(np.empty(int(lengths.sum()), dtype=np.uint8),
                     BaseEncoding), lengths)
    n_columns = len(columns)
    for i, column in enumerate(columns):
        if isinstance(column, EncodedArray) and column.ndim == 1:
            column = EncodedRaggedArray(column, np.ones(len(column),
                                                        dtype=np.int64))
        lines[i::n_columns, :-1] = column
    lines[:, -1] = sep
    lines[(n_columns - 1)::n_columns, -1] = "\n"
    return lines


def dump_csv(data_dict: List[Tuple], sep: str = "\t") -> EncodedArray:
    columns = [get_column(value, key) for key, value in data_dict]
    return join_columns(columns, sep).ravel()
