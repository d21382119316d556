"""The file readers' host helpers of the port (native.py over
csrc/host/host_kernels.cpp: find_positions, parse_ints, bam_find_starts,
gather_rows) against their numpy twins and against the JAX package's
native functions, at every length 0-1025 and at the chunk edges where a
twin could part from the C++: a delimiter in the first or last byte, empty
fields, signs, 18 and 19 digits, rows out of bounds, a BAM record cut by
the chunk's end.  The row gather of RaggedArray (ragged/core.py) goes
through gather_rows above 1024 byte rows and must equal numpy's plan."""
import struct

import numpy as np
import pytest

from bionumpy_tpu import native as jnative
from bionumpy_tpu_torch import native
from bionumpy_tpu_torch.ragged import RaggedArray, RaggedView

LENGTHS = range(0, 1026)


def _buffer(n, seed, alphabet=b"\t\nab1-"):
    rng = np.random.default_rng(seed)
    return np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), n)].copy()


def test_find_positions_every_length():
    for n in LENGTHS:
        buf = _buffer(n, n)
        for a, b in ((9, 10), (10, None), (10, 10)):
            got = native.find_positions(buf, a, b)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got,
                                          native._find_positions_py(buf, a, b))
            np.testing.assert_array_equal(got, jnative.find_positions(buf, a,
                                                                      b))


@pytest.mark.parametrize("text", [b"", b"\n", b"\t", b"\n\n\n", b"abc",
                                  b"\nabc", b"abc\n", b"a\tb\n" * 17,
                                  b"\t" * 33 + b"\n"])
def test_find_positions_edges(text):
    buf = np.frombuffer(text, np.uint8)
    got = native.find_positions(buf, 10, 9)
    np.testing.assert_array_equal(got, native._find_positions_py(buf, 10, 9))
    np.testing.assert_array_equal(got, jnative.find_positions(buf, 10, 9))


def test_find_positions_on_a_view():
    buf = _buffer(500, 1)[3:-5]
    np.testing.assert_array_equal(native.find_positions(buf, 10, 9),
                                  np.flatnonzero((buf == 10) | (buf == 9)))


def _int_rows(n_rows, seed):
    """A buffer of tab-separated signed ints of 1-18 digits and their
    (starts, ends, values)."""
    rng = np.random.default_rng(seed)
    digits = rng.integers(1, 19, n_rows)
    values = [int(rng.integers(0, 10 ** int(d), dtype=np.uint64))
              for d in digits]
    signs = rng.choice(["", "-", "+"], n_rows)
    fields = [f"{s}{v}" for s, v in zip(signs, values)]
    text = "\t".join(fields) + "\n"
    ends = np.cumsum([len(f) + 1 for f in fields]) - 1
    starts = ends - [len(f) for f in fields]
    want = np.array([-v if s == "-" else v for s, v in zip(signs, values)],
                    np.int64)
    return np.frombuffer(text.encode(), np.uint8), starts, ends, want


def test_parse_ints_every_row_count():
    for n in range(0, 300):
        buf, starts, ends, want = _int_rows(n, n)
        got = native.parse_ints(buf, starts, ends)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(native._parse_ints_py(buf, starts,
                                                            ends), want)
        np.testing.assert_array_equal(jnative.parse_ints(buf, starts, ends),
                                      want)


@pytest.mark.parametrize("field", [
    "", "-", "+", "1x", "x1", "--1", "1-", " 1", "1234567890123456789",
    "-1234567890123456789", "12.5"])
def test_parse_ints_anomalies_give_none(field):
    text = f"7\t{field}\t8\n".encode()
    buf = np.frombuffer(text, np.uint8)
    starts = np.array([0, 2, 3 + len(field)])
    ends = np.array([1, 2 + len(field), 4 + len(field)])
    for fn in (native.parse_ints, native._parse_ints_py, jnative.parse_ints):
        assert fn(buf, starts, ends) is None, fn


@pytest.mark.parametrize("field, value", [
    ("0", 0), ("-0", 0), ("+7", 7), ("123456789012345678", 123456789012345678),
    ("-999999999999999999", -999999999999999999), ("000042", 42)])
def test_parse_ints_edge_values(field, value):
    buf = np.frombuffer(field.encode(), np.uint8)
    for fn in (native.parse_ints, native._parse_ints_py, jnative.parse_ints):
        np.testing.assert_array_equal(fn(buf, [0], [len(field)]), [value])


def test_parse_ints_rows_out_of_bounds_give_none():
    buf = np.frombuffer(b"12\t34", np.uint8)
    for starts, ends in (([0, 3], [2, 6]), ([-1], [2]), ([3], [3])):
        for fn in (native.parse_ints, native._parse_ints_py,
                   jnative.parse_ints):
            assert fn(buf, np.array(starts), np.array(ends)) is None


def _bam_chunk(n_records, seed, cut=0):
    rng = np.random.default_rng(seed)
    records = [bytes(rng.integers(0, 256, int(rng.integers(0, 90)),
                                  dtype=np.uint8)) for _ in range(n_records)]
    raw = b"".join(struct.pack("<I", len(r)) + r for r in records)
    return np.frombuffer(raw[: len(raw) - cut], np.uint8)


def test_bam_find_starts_every_length():
    for n in LENGTHS:
        chunk = _bam_chunk(40, n)[:n]
        got = native.bam_find_starts(chunk)
        assert got.dtype == np.int64 and got[0] == 0
        np.testing.assert_array_equal(got, native._bam_find_starts_py(chunk))
        np.testing.assert_array_equal(got, jnative.bam_find_starts(chunk))


@pytest.mark.parametrize("cut", [0, 1, 3, 4, 5])
def test_bam_find_starts_record_cut_at_the_end(cut):
    chunk = _bam_chunk(25, 9, cut)
    got = native.bam_find_starts(chunk)
    np.testing.assert_array_equal(got, native._bam_find_starts_py(chunk))
    np.testing.assert_array_equal(got, jnative.bam_find_starts(chunk))
    assert (got[-1] == len(chunk)) == (cut == 0)


def _rows(n_rows, src_len, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 20, n_rows)
    starts = rng.integers(0, max(src_len - 20, 1), n_rows)
    return starts, lens


def test_gather_rows_every_row_count():
    src = _buffer(2000, 5, bytes(range(256)))
    for n in LENGTHS:
        starts, lens = _rows(n, len(src), n)
        got = native.gather_rows(src, starts, lens)
        want = np.concatenate([src[s: s + ln] for s, ln in zip(starts, lens)]
                              ) if n else np.empty(0, np.uint8)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(native._gather_rows_py(src, starts,
                                                             lens), want)
        np.testing.assert_array_equal(jnative.gather_rows(src, starts, lens),
                                      want)


@pytest.mark.parametrize("starts, lens", [
    ([0, 5], [3, -1]), ([-1], [2]), ([9], [2]), ([0, 8], [1, 3])])
def test_gather_rows_bad_plan_gives_none(starts, lens):
    src = np.arange(10, dtype=np.uint8)
    for fn in (native.gather_rows, native._gather_rows_py,
               jnative.gather_rows):
        assert fn(src, np.array(starts), np.array(lens)) is None


def test_gather_rows_at_the_buffer_end():
    src = np.arange(20, dtype=np.uint8)
    starts, lens = np.array([19, 12, 0, 15]), np.array([1, 8, 0, 5])
    want = np.concatenate([src[s: s + n] for s, n in zip(starts, lens)])
    np.testing.assert_array_equal(native.gather_rows(src, starts, lens), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, bool, np.int64])
def test_ragged_view_gather_equals_numpy_plan(dtype):
    """RaggedArray over a RaggedView: the native row copy (byte columns
    past 1024 rows) and numpy's plan give the same rows."""
    rng = np.random.default_rng(2)
    flat = rng.integers(0, 2 if dtype is bool else 100, 50_000).astype(dtype)
    starts, lens = _rows(3000, len(flat), 3)
    view = RaggedView(starts, lens)
    got = RaggedArray(flat, view)
    np.testing.assert_array_equal(got.lengths, lens)
    np.testing.assert_array_equal(got.ravel(),
                                  flat[view.get_flat_indices()])
    assert got.ravel().dtype == flat.dtype


def test_helpers_raise_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    buf = np.zeros(4, np.uint8)
    for call in (lambda: native.find_positions(buf, 10),
                 lambda: native.parse_ints(buf, [0], [1]),
                 lambda: native.bam_find_starts(buf),
                 lambda: native.gather_rows(buf, [0], [1])):
        with pytest.raises(RuntimeError, match="did not build"):
            call()
