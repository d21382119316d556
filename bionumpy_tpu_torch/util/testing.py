"""Assertion helpers for tests (reference: bionumpy/util/testing.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
from numpy.testing import assert_array_almost_equal, assert_array_equal

from ..encoded_array import (EncodedArray, EncodedRaggedArray,
                             as_encoded_array)
from ..encodings.string_encodings import StringEncoding
from ..ragged import RaggedArray
from ..string_array import StringArray


def assert_raggedarray_equal(a, b):
    assert len(a) == len(b), (len(a), len(b))
    assert_array_equal(np.asarray(a.lengths), np.asarray(b.lengths))
    ar = a.ravel()
    br = b.ravel()
    ar = ar.raw() if hasattr(ar, "raw") else ar
    br = br.raw() if hasattr(br, "raw") else br
    assert_array_equal(np.asarray(ar), np.asarray(br))


def assert_encoded_array_equal(array1, array2):
    array1, array2 = (as_encoded_array(a) for a in (array1, array2))
    assert np.all(np.asarray(array1 == array2)), (array1, array2)


def assert_raggedshape_equal(shape1, shape2):
    assert shape1[0] == shape2[0], (shape1, shape2)
    assert_array_equal(np.asarray(shape1[1]), np.asarray(shape2[1]))


def assert_string_array_equal(array1, array2):
    array1, array2 = (a.tolist() if isinstance(a, StringArray) else a
                      for a in (array1, array2))
    assert array1 == array2, (array1, array2)


def assert_encoded_raggedarray_equal(array1, array2):
    array1, array2 = (as_encoded_array(a) for a in (array1, array2))
    assert isinstance(array1, EncodedRaggedArray), array1
    assert isinstance(array2, EncodedRaggedArray), array2
    assert_raggedshape_equal(array1.shape, array2.shape)
    eq = array1 == array2
    assert np.all(np.asarray(eq.ravel())), (array1, array2)


def assert_float_close_enough(a, b):
    if np.allclose(a, b, equal_nan=True):
        return
    fa, ma = np.frexp(a)
    fb, mb = np.frexp(b)
    fa = np.where(ma > mb, fa * 2.0 ** np.maximum(ma - mb, 0), fa)
    fb = np.where(mb > ma, fb * 2.0 ** np.maximum(mb - ma, 0), fb)
    assert_array_almost_equal(fa, fb)


def _decode_categorical(value):
    """StringEncoding-encoded fields compare by their decoded strings."""
    if isinstance(value, EncodedArray) and \
            isinstance(value.encoding, StringEncoding):
        return value.encoding.decode(value)
    return value


def _field_comparator(s, o, declared_type):
    """Pick the equality assertion for one dataclass field pair."""
    if isinstance(s, StringArray) or isinstance(o, StringArray):
        return assert_string_array_equal
    for cls, fn in ((EncodedRaggedArray, assert_encoded_raggedarray_equal),
                    (EncodedArray, assert_encoded_array_equal),
                    (RaggedArray, assert_raggedarray_equal)):
        if isinstance(s, cls):
            return fn
    if isinstance(s, np.ndarray):
        if declared_type == float:
            return assert_float_close_enough
        return lambda x, y: assert_array_equal(x, np.asarray(y))
    if hasattr(s, "from_entry_tuples"):  # nested record type
        return assert_bnpdataclass_equal
    return None


def assert_bnpdataclass_equal(a, b):
    names = [f.name for f in dataclasses.fields(a)]
    assert names == [f.name for f in dataclasses.fields(b)], (a, b)
    for field in dataclasses.fields(a):
        s = _decode_categorical(getattr(a, field.name))
        o = _decode_categorical(getattr(b, field.name))
        compare = _field_comparator(s, o, field.type)
        if compare is not None:
            compare(s, o)
        else:
            assert np.all(np.equal(s, o)), (field.name, s, o)
