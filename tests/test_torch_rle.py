"""The port's run-length arrays and hash table (ragged/rle.py,
ragged/hashtable.py) against the JAX package's, on the CPU: the same
seeded runs through both, results array-equal with their dtypes (floats
compared with ==, since both packages run the same numpy in the same
order)."""
import numpy as np
import pytest

from bionumpy_tpu.ragged import hashtable as jhash
from bionumpy_tpu.ragged import rle as jrle
from bionumpy_tpu_torch.ragged import hashtable as thash
from bionumpy_tpu_torch.ragged import rle as trle

SEEDS = [0, 1, 2]


def _runs(seed, n_runs=40, dtype=np.int64, max_len=9):
    """A dense array of `n_runs` seeded runs (lengths 1..max_len, values
    that sometimes repeat, so that cleaning merges runs)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, max_len + 1, n_runs)
    if dtype == bool:
        values = rng.random(n_runs) < 0.5
    elif np.issubdtype(dtype, np.floating):
        values = rng.integers(-3, 4, n_runs).astype(dtype) / 2
    else:
        values = rng.integers(-3, 4, n_runs).astype(dtype)
    return np.repeat(values, lengths)


def _pair(dense):
    return trle.RunLengthArray.from_array(dense), \
        jrle.RunLengthArray.from_array(dense)


def assert_same(got, want):
    """Equal values of the same type and dtype, through RLEs, ragged
    RLEs, arrays, tuples and numpy scalars."""
    if isinstance(want, jrle.RunLengthArray):
        assert isinstance(got, trle.RunLengthArray)
        assert type(got).__name__ == type(want).__name__
        for a, b in ((got.events, want.events), (got.values, want.values)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    elif isinstance(want, jrle.RunLengthRaggedArray):
        assert isinstance(got, trle.RunLengthRaggedArray)
        for a, b in ((got._events, want._events),
                     (got._values, want._values)):
            np.testing.assert_array_equal(a.lengths, b.lengths)
            np.testing.assert_array_equal(np.asarray(a.ravel()),
                                          np.asarray(b.ravel()))
            assert np.asarray(a.ravel()).dtype == np.asarray(b.ravel()).dtype
        np.testing.assert_array_equal(got.lengths, want.lengths)
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for a, b in zip(got, want):
            assert_same(a, b)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        assert type(got) is type(want)
        assert got == want or (got != got and want != want)


# -- construction and conversion ---------------------------------------------

@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64, bool])
@pytest.mark.parametrize("seed", SEEDS)
def test_from_array_to_array(seed, dtype):
    dense = _runs(seed, dtype=dtype)
    t, j = _pair(dense)
    assert_same(t, j)
    assert_same(t.to_array(), j.to_array())
    np.testing.assert_array_equal(t.to_array(), dense)
    assert (len(t), t.size, t.shape, t.dtype) == \
        (len(j), j.size, j.shape, j.dtype)
    assert t.tolist() == j.tolist()
    assert_same(t.starts, j.starts)
    assert_same(t.ends, j.ends)
    assert_same(t.astype(np.float32), j.astype(np.float32))


def test_empty_and_repr():
    t, j = _pair(np.array([], dtype=np.int32))
    assert_same(t, j)
    assert_same(t.to_array(), j.to_array())
    assert len(t) == 0
    short = _pair(np.array([1, 1, 2, 3, 3]))
    assert repr(short[0]) == repr(short[1]) == str(short[0])
    long = _pair(_runs(0, n_runs=100))
    assert repr(long[0]).replace("RunLengthArray", "") == \
        repr(long[1]).replace("RunLengthArray", "")


@pytest.mark.parametrize("seed", SEEDS)
def test_clean_merges_empty_and_equal_runs(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 4, 30)
    lengths[0] = rng.integers(0, 2)
    events = np.insert(np.cumsum(lengths), 0, 0)
    values = rng.integers(0, 3, 30)
    assert_same(trle.RunLengthArray(events, values, do_clean=True),
                jrle.RunLengthArray(events, values, do_clean=True))


# -- elementwise ----------------------------------------------------------------

BINARY = ["__add__", "__sub__", "__mul__", "__truediv__", "__eq__",
          "__ne__", "__lt__", "__le__", "__gt__", "__ge__", "__and__",
          "__or__", "__xor__"]


@pytest.mark.parametrize("op", BINARY)
@pytest.mark.parametrize("seed", SEEDS)
def test_binary_ops_between_runs_with_different_events(seed, op):
    """Two RLEs with different event sets: the union of events, values
    looked up on each side, cleaned, dtypes as numpy gives them."""
    dtype = bool if op in ("__and__", "__or__", "__xor__") and seed == 0 \
        else np.int64
    a = _runs(seed, dtype=dtype)
    b = _runs(seed + 10, n_runs=60, dtype=dtype, max_len=5)[: len(a)]
    b = np.concatenate([b, np.zeros(len(a) - len(b), b.dtype)])
    ta, ja = _pair(a)
    tb, jb = _pair(b)
    if op == "__truediv__":
        tb, jb = _pair(np.where(b == 0, 7, b))
    with np.errstate(divide="ignore", invalid="ignore"):
        assert_same(getattr(ta, op)(tb), getattr(ja, op)(jb))


@pytest.mark.parametrize("op", ["__add__", "__radd__", "__sub__",
                                "__rsub__", "__mul__", "__rmul__",
                                "__truediv__", "__rtruediv__", "__lt__",
                                "__ge__", "__eq__"])
def test_scalar_and_reflected_ops(op):
    t, j = _pair(_runs(3) + 4)
    for scalar in (2, np.int32(3), 1.5):
        assert_same(getattr(t, op)(scalar), getattr(j, op)(scalar))


def test_dense_operand_unary_and_ufuncs():
    dense = _runs(4)
    t, j = _pair(dense)
    other = np.arange(len(dense))
    assert_same(t + other, j + other)
    assert_same(-t, -j)
    assert_same(~t, ~j)
    tb, jb = _pair(dense > 0)
    assert_same(~tb, ~jb)
    assert_same(np.add(t, 3), np.add(j, 3))
    assert_same(np.multiply(2, t), np.multiply(2, j))
    assert_same(np.abs(t), np.abs(j))
    assert_same(np.maximum(t, trle.RunLengthArray.from_array(dense[::-1])),
                np.maximum(j, jrle.RunLengthArray.from_array(dense[::-1])))
    assert t.__add__("x") is NotImplemented is j.__add__("x")
    assert t.__array_ufunc__(np.add, "reduce", t) is NotImplemented


# -- reductions and numpy functions ----------------------------------------------

@pytest.mark.parametrize("dtype", [np.int64, np.float64, bool])
@pytest.mark.parametrize("seed", SEEDS)
def test_reductions(seed, dtype):
    t, j = _pair(_runs(seed, dtype=dtype))
    for name in ("sum", "mean", "max", "min"):
        assert_same(getattr(t, name)(), getattr(j, name)())
    assert t.any() == j.any() and t.all() == j.all()
    assert t.argmax() == j.argmax()
    assert_same(t.sum(dtype=np.int32), j.sum(dtype=np.int32))
    for fn in (np.sum, np.mean, np.max, np.amax, np.min, np.amin):
        assert_same(fn(t), fn(j))


@pytest.mark.parametrize("seed", SEEDS)
def test_array_functions(seed):
    parts = [_runs(seed + i, n_runs=10 + i) for i in range(3)]
    tparts = [trle.RunLengthArray.from_array(p) for p in parts]
    jparts = [jrle.RunLengthArray.from_array(p) for p in parts]
    assert_same(np.concatenate(tparts), np.concatenate(jparts))
    assert_same(trle.concatenate_rle(tparts), jrle.concatenate_rle(jparts))
    np.testing.assert_array_equal(np.concatenate(tparts).to_array(),
                                  np.concatenate(parts))
    t, j = tparts[0], jparts[0]
    assert_same(np.histogram(t, bins=4), np.histogram(j, bins=4))
    assert_same(np.histogram(t, bins=[-3, 0, 3], weights=2),
                np.histogram(j, bins=[-3, 0, 3], weights=2))
    other = _runs(seed + 20, n_runs=30)[: len(parts[0])]
    other = np.concatenate([other, np.ones(len(parts[0]) - len(other),
                                           other.dtype)])
    to, jo = _pair(other)
    assert_same(np.where(True, t, to), np.where(True, j, jo))
    assert_same(np.where(False, t, to), np.where(False, j, jo))
    with pytest.raises(TypeError):
        np.cumsum(t)


# -- indexing ----------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_indexing(seed):
    dense = _runs(seed)
    t, j = _pair(dense)
    n = len(dense)
    rng = np.random.default_rng(seed)
    for i in (0, 5, n - 1, -1, -n, np.int64(7)):
        assert_same(t[i], j[i])
        assert t[i] == dense[i]
    for sl in (slice(None), slice(3, 40), slice(-20, None), slice(None, -5),
               slice(10, 10), slice(0, n + 100), slice(7, 8)):
        assert_same(t[sl], j[sl])
        np.testing.assert_array_equal(t[sl].to_array(), dense[sl])
    positions = rng.integers(0, n, 50)
    assert_same(t[positions], j[positions])
    assert_same(t[list(positions)], j[list(positions)])
    mask = rng.random(n) < 0.3
    assert_same(t[mask], j[mask])
    with pytest.raises(IndexError):
        t[np.zeros((2, 2), int)]


class _Iv:
    def __init__(self, start, stop):
        self.start, self.stop = start, stop


@pytest.mark.parametrize("seed", SEEDS)
def test_extract_intervals_ragged(seed):
    dense = _runs(seed)
    t, j = _pair(dense)
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(dense) - 10, 25)
    stops = starts + rng.integers(1, 10, 25)
    tr, jr = t[_Iv(starts, stops)], j[_Iv(starts, stops)]
    assert_same(tr, jr)
    assert_same(t.extract_intervals(starts, stops),
                j.extract_intervals(starts, stops))
    assert len(tr) == len(jr) == 25
    for i in (0, 3, 24):
        assert_same(tr[i], jr[i])
        np.testing.assert_array_equal(tr[i].to_array(),
                                      dense[starts[i]:stops[i]])
    assert_same(tr[:, ::-1], jr[:, ::-1])
    np.testing.assert_array_equal(tr[:, ::-1][2].to_array(),
                                  dense[starts[2]:stops[2]][::-1])
    for side in ("right", "left"):
        assert_same(tr.to_array(side=side, fill_value=-9),
                    jr.to_array(side=side, fill_value=-9))
    tra, jra = tr.to_ragged_array(), jr.to_ragged_array()
    np.testing.assert_array_equal(tra.ravel(), jra.ravel())
    np.testing.assert_array_equal(tra.lengths, jra.lengths)
    for name in ("sum", "mean", "max", "min", "any", "all"):
        assert_same(getattr(tr, name)(), getattr(jr, name)())
    for fn in (np.sum, np.mean, np.max, np.amax, np.min, np.amin, np.any,
               np.all):
        assert_same(fn(tr, axis=-1), fn(jr, axis=-1))
    assert [r.tolist() for r in tr] == [r.tolist() for r in jr]
    with pytest.raises(IndexError):
        tr["x"]


def test_ragged_where_picks_rows():
    dense = _runs(5)
    t, j = _pair(dense)
    other = dense[::-1].copy()
    to, jo = _pair(other)
    starts, stops = np.array([0, 4, 9, 30]), np.array([3, 12, 10, 41])
    ta, ja = t.extract_intervals(starts, stops), \
        j.extract_intervals(starts, stops)
    tb, jb = to.extract_intervals(starts, stops), \
        jo.extract_intervals(starts, stops)
    cond = np.array([[True], [False], [True], [False]])
    assert_same(np.where(cond, ta, tb), np.where(cond, ja, jb))
    assert_same(np.where(cond[:, 0], ta, tb), np.where(cond[:, 0], ja, jb))


# -- hash table ----------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_hashtable(seed):
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 20, 500, replace=False)
    values = rng.integers(0, 1000, 500)
    t, j = thash.HashTable(keys, values), jhash.HashTable(keys, values)
    assert len(t) == len(j) == 500
    queries = np.concatenate([keys[::7], rng.integers(0, 1 << 20, 100)])
    assert_same(t.contains(queries), j.contains(queries))
    assert_same(t[keys[::3]], j[keys[::3]])
    np.testing.assert_array_equal(t[keys], values)
    missing = np.setdiff1d(np.arange(1 << 10), keys)[:3]
    for table in (t, j):
        with pytest.raises(IndexError, match="not in table"):
            table[missing]


def test_empty_hashtable():
    t = thash.HashTable(np.empty(0, np.int64), np.empty(0, np.int64))
    j = jhash.HashTable(np.empty(0, np.int64), np.empty(0, np.int64))
    assert_same(t.contains(np.array([1, 2])), j.contains(np.array([1, 2])))
    for table in (t, j):
        with pytest.raises(IndexError):
            table[np.array([1])]
