"""numpy __array_function__ handlers for RaggedArray.

Covers the whitelist of numpy functions bionumpy calls on ragged arrays
(reference: npstructures behaviour observed at usage sites such as
bionumpy/sequence/count_encoded.py, bionumpy/streams/reductions.py).
"""
from __future__ import annotations

import numpy as np

from .core import RaggedArray, RaggedShape

HANDLED_FUNCTIONS = {}


def implements(np_function):
    def decorator(func):
        HANDLED_FUNCTIONS[np_function] = func
        return func
    return decorator


def _flat(ra):
    return ra.ravel() if isinstance(ra, RaggedArray) else np.asarray(ra)


@implements(np.concatenate)
def concatenate(arrays, axis=0):
    arrays = list(arrays)
    assert axis in (0, None)
    first = next(a for a in arrays if isinstance(a, RaggedArray))
    flats = [_flat(a) for a in arrays]
    lengths = np.concatenate([
        a.lengths if isinstance(a, RaggedArray) else np.array([len(a)])
        for a in arrays
    ])
    return first._cls(np.concatenate(flats), RaggedShape(lengths))


@implements(np.zeros_like)
def zeros_like(a, dtype=None, shape=None):
    if shape is not None:
        return RaggedArray(np.zeros(int(np.sum(shape)), dtype=dtype or a.dtype), shape)
    return a._cls(np.zeros_like(a.ravel(), dtype=dtype), RaggedShape(a.lengths))


@implements(np.ones_like)
def ones_like(a, dtype=None, shape=None):
    if shape is not None:
        return RaggedArray(np.ones(int(np.sum(shape)), dtype=dtype or a.dtype), shape)
    return a._cls(np.ones_like(a.ravel(), dtype=dtype), RaggedShape(a.lengths))


@implements(np.full_like)
def full_like(a, fill_value, dtype=None, shape=None):
    if shape is not None:
        return RaggedArray(
            np.full(int(np.sum(shape)), fill_value, dtype=dtype or a.dtype), shape)
    return a._cls(np.full_like(a.ravel(), fill_value, dtype=dtype),
                  RaggedShape(a.lengths))


@implements(np.empty_like)
def empty_like(a, dtype=None, shape=None):
    return zeros_like(a, dtype=dtype, shape=shape)


@implements(np.sum)
def sum_(a, axis=None, dtype=None, keepdims=False):
    return a.sum(axis=axis, dtype=dtype, keepdims=keepdims)


@implements(np.mean)
def mean(a, axis=None, keepdims=False):
    return a.mean(axis=axis, keepdims=keepdims)


@implements(np.max)
def max_(a, axis=None, keepdims=False):
    return a.max(axis=axis, keepdims=keepdims)


@implements(np.min)
def min_(a, axis=None, keepdims=False):
    return a.min(axis=axis, keepdims=keepdims)


@implements(np.amax)
def amax(a, axis=None, keepdims=False):
    return a.max(axis=axis, keepdims=keepdims)


@implements(np.amin)
def amin(a, axis=None, keepdims=False):
    return a.min(axis=axis, keepdims=keepdims)


@implements(np.any)
def any_(a, axis=None, keepdims=False):
    return a.any(axis=axis, keepdims=keepdims)


@implements(np.all)
def all_(a, axis=None, keepdims=False):
    return a.all(axis=axis, keepdims=keepdims)


@implements(np.argmax)
def argmax(a, axis=-1):
    return a.argmax(axis=axis)


@implements(np.argmin)
def argmin(a, axis=-1):
    return a.argmin(axis=axis)


@implements(np.cumsum)
def cumsum(a, axis=None, dtype=None):
    return a.cumsum(axis=axis, dtype=dtype)


@implements(np.bincount)
def bincount(a, weights=None, minlength=0):
    return np.bincount(_flat(a), weights=_flat(weights) if weights is not None
                       else None, minlength=minlength)


@implements(np.where)
def where(cond, x=None, y=None):
    if x is None:
        raise NotImplementedError("np.where(ragged_condition) not supported")
    first = next(a for a in (cond, x, y) if isinstance(a, RaggedArray))

    def align(v):
        if isinstance(v, RaggedArray):
            return v.ravel()
        arr = np.asarray(v)
        if arr.ndim == 0:
            return arr
        if arr.ndim == 2 and arr.shape[1] == 1:
            return np.repeat(arr[:, 0], first.lengths)
        if arr.ndim == 1 and arr.shape[0] == len(first):
            return np.repeat(arr, first.lengths)
        return arr
    out = np.where(align(cond), align(x), align(y))
    return first._cls(out, RaggedShape(first.lengths))


@implements(np.diff)
def diff(a, n=1, axis=-1):
    assert axis in (-1, 1)
    out = a
    for _ in range(n):
        out = out[:, 1:] - out[:, :-1]
    return out


@implements(np.unique)
def unique(a, return_counts=False):
    return np.unique(_flat(a), return_counts=return_counts)


@implements(np.repeat)
def repeat(a, repeats, axis=None):
    assert axis is None
    return np.repeat(_flat(a), repeats)


@implements(np.nonzero)
def nonzero(a):
    flat_nz = np.flatnonzero(a.ravel())
    rows = np.searchsorted(a.ends, flat_nz, side="right")
    cols = flat_nz - a.starts[rows]
    return rows, cols
