"""Utility helpers (reference: bionumpy/util/__init__.py)."""
from __future__ import annotations

import functools
import inspect

import numpy as np


def is_subclass_or_instance(obj, cls) -> bool:
    return (inspect.isclass(obj) and issubclass(obj, cls)) or \
        isinstance(obj, cls)


cached_property = functools.cached_property


def as_strided(arr, shape=None, strides=None, **kwargs):
    """Strided view helper (reference: bionumpy/util/__init__.py)."""
    if hasattr(arr, "as_strided"):
        return arr.as_strided(shape=shape, strides=strides, **kwargs)
    return np.lib.stride_tricks.as_strided(arr, shape=shape,
                                           strides=strides, **kwargs)


def interleave(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.empty(len(a) + len(b), dtype=a.dtype)
    out[0::2] = a
    out[1::2] = b
    return out


def rolling_window_function(func):
    """Lift a windows-matrix function to ragged/flat sequences with the
    reference's trim-at-row-end semantics (reference:
    bionumpy/util/__init__.py:35-46)."""
    from ..ragged import RaggedArray

    def wrapper(sequence, window_size, *args, **kwargs):
        flat = sequence.ravel() if hasattr(sequence, "ravel") \
            else np.asarray(sequence)
        windows = np.lib.stride_tricks.sliding_window_view(
            np.asarray(flat), window_size)
        values = func(windows, window_size, *args, **kwargs)
        if isinstance(sequence, RaggedArray):
            padded = RaggedArray(
                np.append(values,
                          np.zeros(window_size - 1, values.dtype)),
                sequence.lengths)
            return padded[..., : -(window_size - 1) or None]
        # flat input: the n-w+1 valid windows ARE the result (the
        # reference reaches the same length via strided pad + trim)
        return np.asarray(values)

    return wrapper


def pprint_one(sequence) -> str:
    """One byte-code row as a string."""
    raw = sequence.raw() if hasattr(sequence, "raw") else sequence
    return "".join(chr(int(c)) for c in np.asarray(raw))


def pprint(sequences):
    """Rows of byte codes as strings (ragged or 1/2-D arrays)."""
    arr = sequences
    if hasattr(arr, "lengths"):  # ragged
        return [pprint_one(row) for row in arr]
    arr = np.asarray(arr.raw() if hasattr(arr, "raw") else arr)
    if arr.ndim == 1:
        return pprint_one(arr)
    return [pprint(row) for row in arr]


def plot(obj):
    """Dispatch to an object's __plot__ hook if present (reference:
    bionumpy/util/__init__.py:62-64)."""
    import logging
    if not hasattr(obj, "__plot__"):
        logging.getLogger(__name__).warning(
            "%r has no __plot__ method", obj)
        return None
    return obj.__plot__()


from . import testing  # noqa: E402,F401  (submodule parity: bnp.util.testing)
