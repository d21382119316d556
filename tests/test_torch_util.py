"""Parity of the port's util/ (cached_property, as_strided, interleave,
rolling_window_function, pprint, plot; typing, formating, ascii_hash and
the assert_*_equal helpers of testing) and alignments/cigar with the JAX
package's, on the CPU: the same calls through both packages, compared as
plain values; the testing helpers pass and fail on the same inputs, each
on its own package's objects."""
import importlib

import numpy as np
import pytest

PACKAGES = ("bionumpy_tpu", "bionumpy_tpu_torch")


def _m(root, name):
    return importlib.import_module(root + name)


def same(fn):
    want, got = (fn(root) for root in PACKAGES)
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
    return got


def test_is_subclass_or_instance_alike():
    def run(root):
        util = _m(root, ".util")
        return [util.is_subclass_or_instance(obj, int)
                for obj in (int, bool, 3, True, "3", str, None)]

    same(run)


def test_cached_property_is_functools():
    import functools
    util = _m("bionumpy_tpu_torch", ".util")
    assert util.cached_property is functools.cached_property

    class Counter:
        calls = 0

        @util.cached_property
        def value(self):
            Counter.calls += 1
            return 7

    c = Counter()
    assert (c.value, c.value, Counter.calls) == (7, 7, 1)


def test_as_strided_and_interleave_alike():
    def run(root):
        util = _m(root, ".util")
        a = np.arange(10, dtype=np.int64)
        windows = util.as_strided(a, shape=(8, 3), strides=(8, 8))
        mixed = util.interleave(np.arange(4), np.arange(10, 14))
        return np.concatenate([windows.ravel(), mixed])

    same(run)


@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("window", [1, 3, 5])
def test_rolling_window_function_alike(ragged, window):
    def run(root):
        util = _m(root, ".util")
        ragged_mod = _m(root, ".ragged")

        @util.rolling_window_function
        def window_sums(windows, window_size):
            return windows.sum(axis=-1)

        rng = np.random.default_rng(window)
        lengths = [0, 1, 4, 7, 2, 12]
        flat = rng.integers(0, 9, sum(lengths))
        seq = ragged_mod.RaggedArray(flat, lengths) if ragged else flat
        out = window_sums(seq, window)
        if ragged:
            return [np.asarray(out.lengths).tolist(),
                    np.asarray(out.ravel()).tolist()]
        return np.asarray(out).tolist()

    same(run)


def test_pprint_alike():
    def run(root):
        bnp = importlib.import_module(root)
        util = _m(root, ".util")
        seqs = bnp.as_encoded_array(["ACGT", "", "GG"])
        codes = np.frombuffer(b"ACGTAC", np.uint8).reshape(2, 3)
        return (util.pprint(seqs), util.pprint(codes), util.pprint(codes[0]),
                util.pprint_one(np.frombuffer(b"xyz", np.uint8)))

    assert same(run) == (["ACGT", "", "GG"], ["ACG", "TAC"], "ACG", "xyz")


def test_plot_alike():
    class Plottable:
        def __plot__(self):
            return "plotted"

    def run(root):
        util = _m(root, ".util")
        return util.plot(Plottable()), util.plot(object())

    assert same(run) == ("plotted", None)


def test_table_alike():
    def run(root):
        formating = _m(root, ".util.formating")
        return (formating.table([[1, "abc"], [2.5, "x" * 30]],
                                headers=["n", "name"]),
                formating.table([[1]], col_width=3))

    same(run)


def test_typing_names_alike():
    def run(root):
        typing = _m(root, ".util.typing")
        return [getattr(typing, name).__name__ for name in (
            "SingleEncodedArrayLike", "EncodedRaggedArrayLike",
            "EncodedArrayLike")]

    same(run)


def test_ascii_hash_table_alike():
    def run(root):
        bnp = importlib.import_module(root)
        ascii_hash = _m(root, ".util.ascii_hash")
        keys = bnp.as_encoded_array(["chr1", "chr2", "chrX", "a", ""])
        table = ascii_hash.AsciiHashTable.from_sequences(keys)
        query = bnp.as_encoded_array(["chrX", "a", "chr1", "chrX"])
        hashes = ascii_hash.get_ascii_hash(bnp.as_encoded_array(
            ["chr2", "nope"]))
        with pytest.raises(IndexError):
            table[bnp.as_encoded_array(["chr3"])]
        return (np.asarray(table[query]).tolist(),
                np.asarray(table.contains(hashes)).tolist(),
                np.asarray(hashes).tolist())

    assert same(run)[0] == [2, 3, 0, 2]


def _outcome(fn, *args):
    try:
        fn(*args)
    except AssertionError:
        return "fails"
    return "passes"


def test_testing_helpers_alike():
    """Each assert_*_equal passes on equal inputs and fails on unequal
    ones, alike in both packages, each on its own package's objects."""
    def run(root):
        bnp = importlib.import_module(root)
        testing = _m(root, ".util.testing")
        ragged = _m(root, ".ragged")
        string_array = _m(root, ".string_array")
        datatypes = _m(root, ".datatypes")
        encodings = _m(root, ".encodings")
        out = []
        ra = ragged.RaggedArray([[1, 2], [3]])
        for other in ([[1, 2], [3]], [[1, 2], [4]], [[1], [2, 3]]):
            out.append(_outcome(testing.assert_raggedarray_equal, ra,
                                ragged.RaggedArray(other)))
        for a, b in ((["AC", "G"], ["AC", "G"]), (["AC", "G"], ["AC", "T"]),
                     (["AC", "G"], ["A", "CG"])):
            out.append(_outcome(testing.assert_encoded_raggedarray_equal,
                                a, b))
        out.append(_outcome(testing.assert_encoded_array_equal, "ACG",
                            "ACG"))
        out.append(_outcome(testing.assert_encoded_array_equal, "ACG",
                            "ACT"))
        out.append(_outcome(testing.assert_raggedshape_equal,
                            (2, [1, 2]), (2, [1, 2])))
        out.append(_outcome(testing.assert_raggedshape_equal,
                            (2, [1, 2]), (2, [2, 1])))
        sa = string_array.as_string_array(["x", "yy"])
        out.append(_outcome(testing.assert_string_array_equal, sa,
                            ["x", "yy"]))
        out.append(_outcome(testing.assert_string_array_equal, sa,
                            ["x", "y"]))
        out.append(_outcome(testing.assert_float_close_enough,
                            np.array([1.0, 1e-300]),
                            np.array([1.0 + 1e-12, 1.0000000001e-300])))
        out.append(_outcome(testing.assert_float_close_enough,
                            np.array([1.0]), np.array([1.5])))
        iv = datatypes.Interval(["c1", "c2"], [1, 5], [3, 9])
        for other in (datatypes.Interval(["c1", "c2"], [1, 5], [3, 9]),
                      datatypes.Interval(["c1", "c2"], [1, 5], [3, 8]),
                      datatypes.Interval(["c1", "c3"], [1, 5], [3, 9])):
            out.append(_outcome(testing.assert_bnpdataclass_equal, iv,
                                other))
        entry = datatypes.SequenceEntry(["a", "b"], ["ACG", "T"])
        out.append(_outcome(testing.assert_bnpdataclass_equal, entry,
                            datatypes.SequenceEntry(["a", "b"],
                                                    ["ACG", "T"])))
        enc = encodings.StringEncoding(["c1", "c2"])
        cat = enc.encode(bnp.as_encoded_array(["c2", "c1"]))
        out.append(_outcome(testing.assert_encoded_array_equal,
                            testing._decode_categorical(cat), ["c2", "c1"]))
        return out

    got = same(run)
    assert got[:3] == ["passes", "fails", "fails"]
    assert got.count("passes") == 9


def test_cigar_alike():
    def run(root):
        cigar = _m(root, ".alignments.cigar")
        ragged = _m(root, ".ragged")
        words = np.array([10 << 4 | 0, 3 << 4 | 1, 5 << 4 | 2, 7 << 4 | 4,
                          2 << 4 | 3, 4 << 4 | 7, 1 << 4 | 8], np.uint32)
        symbol, lengths = cigar.split_cigar(ragged.RaggedArray(words,
                                                               [3, 0, 4]))
        flat_symbol, flat_lengths = cigar.split_cigar(words)
        ref = cigar.count_reference_length(symbol, lengths)
        return (np.asarray(symbol.ravel().raw()).tolist(),
                np.asarray(lengths.ravel()).tolist(),
                np.asarray(flat_symbol.raw()).tolist(),
                flat_lengths.tolist(), ref.tolist(), str(ref.dtype))

    assert same(run)[4] == [15, 0, 7]
