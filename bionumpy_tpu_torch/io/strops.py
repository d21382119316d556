"""Vectorized string algorithms over byte tensors.

The port's copy of bionumpy_tpu/io/strops.py, a re-design of bionumpy's
io/strops.py: same semantics (signed int parse, decimal/scientific float
parse, int rendering, join/split/str_equal) expressed directly on flat
buffers + row lengths instead of via ragged power-array construction.
All inner loops are numpy gathers/cumsums on the host.
"""
from __future__ import annotations

from typing import List, Union

import numpy as np

from ..encoded_array import (BaseEncoding, EncodedArray, EncodedRaggedArray,
                             as_encoded_array)
from ..encodings import DigitEncoding
from ..ragged import (RaggedArray, RaggedShape, ragged_slice,
                      unsafe_extend_left, unsafe_extend_right)
from ..string_array import StringArray
from .exceptions import FormatException

__all__ = ["int_to_str", "str_to_int", "str_to_float", "ints_to_strings",
           "float_to_strings", "int_lists_to_strings", "join", "split",
           "str_equal", "str_to_int_with_missing",
           "str_to_float_with_missing", "replace_inplace"]


def _column_indices(lengths: np.ndarray) -> np.ndarray:
    """Within-row column index of every element of a ragged buffer."""
    total = int(np.sum(lengths))
    if total == 0:
        return np.empty(0, dtype=np.int64)
    row_starts = np.empty(len(lengths), dtype=np.int64)
    row_starts[0] = 0
    np.cumsum(lengths[:-1], out=row_starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(row_starts, lengths)


def int_to_str(number: int) -> EncodedArray:
    number = int(number)
    digits = [int(c) for c in str(abs(number))]
    arr = np.array(digits, dtype=np.uint8)
    out = DigitEncoding.decode(arr)
    if number < 0:
        out = np.insert(out, 0, ord("-"))
    return EncodedArray(out, BaseEncoding)


def replace_inplace(number_text: EncodedArray, replace_from: str,
                    replace_to: str) -> None:
    number_text[number_text == replace_from] = replace_to


def _digit_values(flat: EncodedArray) -> np.ndarray:
    raw = flat.raw()
    digits = raw.astype(np.int64) - ord("0")
    bad = (digits < 0) | (digits > 9)
    if np.any(bad):
        offset = int(np.flatnonzero(bad)[0])
        raise FormatException(
            f"invalid digit {chr(int(raw[offset]))!r} while parsing number",
            offset)
    return digits


def str_to_int(number_text, is_negative=None, is_positive=None) -> np.ndarray:
    """Parse signed decimal integer strings (reference semantics:
    bionumpy/io/strops.py:86-123)."""
    number_text = as_encoded_array(number_text)
    if not isinstance(number_text, EncodedRaggedArray):
        number_text = EncodedRaggedArray(number_text, [len(number_text)])
        return str_to_int(number_text)[0]
    if len(number_text) == 0:
        return np.array([], dtype=np.int64)
    lengths = number_text.lengths.copy()
    flat = number_text.ravel().raw()
    if is_negative is None:
        first = np.zeros(len(lengths), dtype=np.uint8)
        nonzero = lengths > 0
        first[nonzero] = flat[number_text.starts[nonzero]]
        is_negative = first == ord("-")
        is_positive = first == ord("+")
    has_sign = is_negative | is_positive
    starts_mask = np.zeros(len(flat), dtype=bool)
    starts_mask[number_text.starts[has_sign & (lengths > 0)]] = True
    digits = np.where(starts_mask, 0,
                      flat.astype(np.int64) - ord("0"))
    bad = (digits < 0) | (digits > 9)
    if np.any(bad):
        offset = int(np.flatnonzero(bad)[0])
        raise FormatException(
            f"invalid digit {chr(int(flat[offset]))!r} while parsing int",
            offset)
    cols = _column_indices(lengths)
    powers = np.repeat(lengths, lengths) - 1 - cols
    terms = digits * 10 ** powers
    values = RaggedArray(terms, lengths).sum(axis=-1)
    return np.asarray(values) * np.where(is_negative, -1, 1)


def _scale_by_pow10(values: np.ndarray, exps: np.ndarray) -> np.ndarray:
    """values * 10**exps with one rounding step where possible.

    For |exp| <= 22 both the power of ten and (for typical mantissas) the
    operand are exact doubles, so a single multiply/divide is correctly
    rounded — this is what makes ``str(x)`` round-trip bit-exactly, which
    the reference's two-step scaling does not guarantee (its own property
    test is xfailed, reference: tests/property_tests/test_strops.py:41-50).
    """
    values = np.asarray(values, dtype=float)
    out = np.empty_like(values)
    pos = exps >= 0
    if np.any(pos):
        e = exps[pos]
        first = np.minimum(e, 290)
        out[pos] = values[pos] * 10.0 ** first * 10.0 ** (e - first)
    if not np.all(pos):
        neg = ~pos
        e = -exps[neg]
        first = np.minimum(e, 290)
        out[neg] = values[neg] / 10.0 ** first / 10.0 ** (e - first)
    return out


def _decimal_mantissa_and_exp(number_text: EncodedRaggedArray):
    """Signed digits (ignoring the dot) as an integer-valued float, plus
    the implied decimal exponent (-count of digits after the dot)."""
    lengths = number_text.lengths
    flat = number_text.ravel().raw().copy()
    starts = number_text.starts
    first = np.zeros(len(lengths), dtype=np.uint8)
    nonzero = lengths > 0
    first[nonzero] = flat[starts[nonzero]]
    is_negative = first == ord("-")
    sign_mask = np.zeros(len(flat), dtype=bool)
    sign_mask[starts[is_negative]] = True
    is_dot = flat == ord(".")
    digits = np.where(sign_mask | is_dot, 0, flat.astype(np.int64) - ord("0"))
    bad = (digits < 0) | (digits > 9)
    if np.any(bad):
        offset = int(np.flatnonzero(bad)[0])
        raise FormatException(
            f"invalid char {chr(int(flat[offset]))!r} while parsing float",
            offset)
    # power of each digit = count of digit (non-dot) positions strictly to
    # its right within the row
    is_digit_pos = (~is_dot).astype(np.int64)
    ra_digits = RaggedArray(is_digit_pos, lengths)
    digits_per_row = ra_digits.sum(axis=-1)
    prefix_incl = np.asarray(ra_digits.cumsum(axis=-1).ravel())
    powers = np.repeat(digits_per_row, lengths) - prefix_incl
    base = np.asarray(RaggedArray(digits * 10.0 ** powers, lengths).sum(axis=-1))
    # decimals = digits after the dot
    dot_rows, dot_cols = np.nonzero(RaggedArray(is_dot.astype(np.int64),
                                                lengths))
    exponents = np.zeros(len(lengths), dtype=np.int64)
    exponents[dot_rows] = lengths[dot_rows] - dot_cols - 1
    signs = np.where(is_negative, -1.0, 1.0)
    return signs * base, -exponents


def _decimal_str_to_float(number_text: EncodedRaggedArray) -> np.ndarray:
    mantissa, exps = _decimal_mantissa_and_exp(number_text)
    return _scale_by_pow10(mantissa, exps)


def _scientific_str_to_float(number_text: EncodedRaggedArray) -> np.ndarray:
    marker = (number_text == "e") | (number_text == "E")
    rows, cols = np.nonzero(marker)
    decimal_text = ragged_slice(number_text, ends=cols)
    mantissa, dec_exps = _decimal_mantissa_and_exp(decimal_text)
    power_text = ragged_slice(number_text, starts=cols + 1)
    powers = str_to_int(power_text)
    return _scale_by_pow10(mantissa, dec_exps + powers)


def str_to_float(number_text) -> np.ndarray:
    """Parse decimal/scientific float strings (reference:
    bionumpy/io/strops.py:126-183)."""
    number_text = as_encoded_array(number_text)
    assert number_text.encoding == BaseEncoding
    if not isinstance(number_text, EncodedRaggedArray):
        number_text = EncodedRaggedArray(number_text, [len(number_text)])
        return str_to_float(number_text)[0]
    if len(number_text) == 0:
        return np.array([], dtype=float)
    has_e = np.asarray(((number_text == "e") | (number_text == "E"))
                       .any(axis=-1))
    is_nan = str_equal(number_text, "nan") | str_equal(number_text, "NaN")
    out = np.empty(len(number_text), dtype=float)
    plain = ~has_e & ~is_nan
    if np.any(plain):
        out[plain] = _decimal_str_to_float(number_text[plain])
    if np.any(has_e):
        out[has_e] = _scientific_str_to_float(number_text[has_e])
    out[is_nan] = np.nan
    return out


def parse_with_missing(missing_value, number_text, parser, dtype):
    number_text = as_encoded_array(number_text)
    if len(number_text) and np.all(number_text.lengths == 1):
        if np.all(np.asarray((number_text == ".").all(axis=-1))):
            return np.full(len(number_text), missing_value, dtype=dtype)
    is_dot = str_equal(number_text, ".")
    mask = (number_text.lengths > 0) & ~is_dot
    values = np.full(len(number_text), missing_value, dtype=dtype)
    if np.any(mask):
        values[mask] = parser(number_text[mask])
    return values


def str_to_int_with_missing(number_text, missing_value=0) -> np.ndarray:
    return parse_with_missing(missing_value, number_text, str_to_int, int)


def str_to_float_with_missing(number_text, missing_value=np.nan) -> np.ndarray:
    return parse_with_missing(missing_value, number_text, str_to_float, float)


def ints_to_strings(number) -> EncodedRaggedArray:
    """Render ints as decimal strings (reference:
    bionumpy/io/strops.py:186-215)."""
    number = np.asarray(number).astype(np.int64).ravel()
    is_negative = number < 0
    # uint64 absolutes: |int64 min| and 10**19 both exceed int64 but fit uint64
    abs_num = np.where(is_negative, -number.view(np.uint64),
                       number.view(np.uint64))
    # digit count by threshold comparison (log10 rounds wrong near 2**63 and
    # 10**n_digits overflows int64 for 19-digit values)
    thresholds = np.array([10 ** p for p in range(1, 20)], dtype=np.uint64)
    n_digits = np.searchsorted(thresholds, abs_num, side="right") + 1
    lengths = n_digits + is_negative
    cols = _column_indices(lengths)
    powers = np.repeat(lengths, lengths) - 1 - cols
    pow10 = np.array([10 ** p for p in range(20)],
                     dtype=np.uint64)[np.minimum(powers, 19)]
    digits = np.repeat(abs_num, lengths) // pow10 % np.uint64(10)
    flat = (digits + ord("0")).astype(np.uint8)
    out = EncodedRaggedArray(EncodedArray(flat, BaseEncoding), lengths)
    if np.any(is_negative):
        out[is_negative, 0] = "-"
    return out


def float_to_strings(floats: np.ndarray) -> EncodedRaggedArray:
    """Render floats (vanilla repr; exact dragon4 parity with the
    reference which also falls back to Python str —
    bionumpy/io/strops.py:218-240)."""
    return as_encoded_array([str(f) for f in np.asarray(floats).ravel()])


def int_lists_to_strings(int_lists: RaggedArray, sep: str = ",",
                         keep_last: bool = False) -> EncodedRaggedArray:
    """Join ints of each row into one string per row (reference:
    bionumpy/io/strops.py:243-273)."""
    if len(sep) == 0:
        flat = DigitEncoding.decode(np.asarray(int_lists.ravel()))
        return EncodedRaggedArray(EncodedArray(flat, BaseEncoding),
                                  RaggedShape(int_lists.lengths))
    int_strings = ints_to_strings(int_lists.ravel())
    str_lengths = RaggedArray(int_strings.lengths, int_lists.lengths)
    joined = join(int_strings, sep=sep, keep_last=True)
    row_lens = np.asarray(str_lengths.sum(axis=-1)) + int_lists.lengths
    out = EncodedRaggedArray(joined, row_lens)
    if not keep_last:
        out = out[:, :-1]
    return out


def join(sequences: EncodedRaggedArray, sep: str = "\t",
         keep_last: bool = False) -> EncodedArray:
    """Join rows with a separator char (reference:
    bionumpy/io/strops.py:276-304)."""
    new_lengths = sequences.lengths + 1
    total = int(np.sum(new_lengths))
    flat = np.empty(total, dtype=np.uint8)
    out = EncodedRaggedArray(EncodedArray(flat, sequences.encoding),
                             new_lengths)
    out[:, :-1] = sequences
    out[:, -1] = sep
    result = out.ravel()
    if keep_last:
        return result
    return result[:-1]


def split(sequence: EncodedArray,
          sep: Union[str, List[str]] = ",") -> EncodedRaggedArray:
    """Split a flat sequence on separator char(s) (reference:
    bionumpy/io/strops.py:307-337)."""
    extended = unsafe_extend_right(sequence.raw())
    if isinstance(sep, list):
        mask = np.zeros(len(extended), dtype=bool)
        for s in sep:
            mask |= extended == ord(s)
    else:
        mask = extended == ord(sep)
    mask[-1] = True
    sep_idx = np.flatnonzero(mask)
    lens = np.diff(unsafe_extend_left(sep_idx))
    if len(lens):
        lens[0] = sep_idx[0] + 1
    out = EncodedRaggedArray(EncodedArray(extended, sequence.encoding), lens)
    return out[:, :-1]


def str_equal(sequences, match_string) -> np.ndarray:
    """Per-row equality against a string (or row-wise against another
    ragged set) — reference: bionumpy/io/strops.py:340-380."""
    if isinstance(sequences, StringArray):
        return sequences == match_string
    sequences = as_encoded_array(sequences)
    if isinstance(sequences, EncodedRaggedArray) and \
            isinstance(match_string, EncodedRaggedArray):
        lengths_match = sequences.lengths == match_string.lengths
        out = lengths_match.copy()
        if np.any(lengths_match):
            sub = sequences[lengths_match] == match_string[lengths_match]
            out[lengths_match] &= np.asarray(sub.all(axis=-1))
        return out
    if isinstance(sequences, EncodedArray):
        return len(sequences) == len(match_string) and \
            bool(np.all(sequences == match_string))
    L = len(match_string)
    mask = sequences.lengths == L
    if not np.any(mask):
        return mask
    starts = sequences.starts[mask]
    matrix = sequences.ravel()[starts[:, np.newaxis] + np.arange(L)]
    mask[mask] &= np.asarray(np.all(matrix == match_string, axis=-1))
    return mask
