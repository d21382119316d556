"""Tables built in passes over resident blocks (ops/kmers.blocked_table):
count_minimizers and count_kmers past k = 12 over arrays of more than
one pass of whole rows, with the resident blocks and the passes forced
to a few thousand bases, against the same call as one pass, against the
JAX package on the same array, and against the benchmark's plain
reference (portbench/reference.py); the passes' layout, the spans and
counters a folded table opens, the rerun of a table past its cap, and a
row longer than a pass (one pass, no fold).  On the CPU, with the
kernels' plain versions; exact equality of keys, counts and dtypes."""
import os
import sys

import numpy as np
import pytest

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu_torch import instrument
from bionumpy_tpu_torch.ops import kmers as tkmers
from bionumpy_tpu_torch.ops import resident

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import reference as R  # noqa: E402

BLOCK = 7000  # bases a resident block holds, at most
PASS = 1500   # bases a pass keys, at most (a longer row is a pass alone)
# (function, k, window): minimap2's sketch, and count_kmers past k = 12
TABLES = [("count_minimizers", 15, 24), ("count_minimizers", 5, 12),
          ("count_kmers", 15, 15), ("count_kmers", 21, 21),
          ("count_kmers", 31, 31)]


def _genome(seed, n_rows=30, hi=2000):
    """Seeded rows of 0..hi bases, some empty or shorter than a window,
    one longer than a pass."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, hi, n_rows)
    lengths[[2, 9, 10]] = [0, 7, 23]
    lengths[5] = PASS + 700
    return rng.integers(0, 4, int(lengths.sum())).astype(np.uint8), lengths


def _arrays(flat, lengths):
    strings = ["".join("ACGT"[c] for c in flat[s: s + n]) for s, n in
               zip(np.concatenate([[0], np.cumsum(lengths)[:-1]]), lengths)]
    return (tbnp.EncodedRaggedArray(tbnp.EncodedArray(flat, tbnp.DNAEncoding),
                                    lengths),
            jbnp.as_encoded_array(strings, jbnp.DNAEncoding))


def _count(fn, seqs, k, w, **kw):
    if fn == "count_kmers":
        return tbnp.count_kmers(seqs, k, device="cpu")
    return tbnp.count_minimizers(seqs, k, w, device="cpu", **kw)


def _jax_count(fn, jseqs, k, w):
    if fn == "count_kmers":
        return jbnp.count_kmers(jseqs, k)
    return jbnp.sequence.count_minimizers(jseqs, k, w)


def _assert_same_table(got, want):
    np.testing.assert_array_equal(got.label_codes, want.label_codes)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.label_codes.dtype == np.uint64 == want.label_codes.dtype
    assert got.counts.dtype == np.int64 == np.asarray(want.counts).dtype
    assert str(got.encoding) == str(want.encoding)


@pytest.fixture
def small_passes(monkeypatch):
    monkeypatch.setattr(tkmers, "MAX_PACKED_BASES", BLOCK)
    monkeypatch.setattr(tkmers, "TABLE_PASS_POSITIONS", PASS)
    monkeypatch.setattr(tkmers, "FOLD_ROWS", 1)  # a fold at every pass


@pytest.mark.parametrize("fn,k,w", TABLES)
def test_folded_table_equals_one_pass_jax_and_reference(monkeypatch, fn, k,
                                                        w):
    flat, lengths = _genome(k + w)
    seqs, jseqs = _arrays(flat, lengths)
    whole = _count(fn, seqs, k, w)
    monkeypatch.setattr(tkmers, "MAX_PACKED_BASES", BLOCK)
    monkeypatch.setattr(tkmers, "TABLE_PASS_POSITIONS", PASS)
    monkeypatch.setattr(tkmers, "FOLD_ROWS", 1)  # a fold at every pass
    seqs = _arrays(flat, lengths)[0]
    instrument.reset()
    got = _count(fn, seqs, k, w)
    rep = instrument.report()
    blocks = resident.device_seq_blocks(seqs, "cpu")
    n_passes = len(tkmers.table_passes(blocks))
    assert len(blocks) > 1 and n_passes >= 8
    assert rep["table-passes"]["calls"] == 1
    assert rep["table-passes"]["rows"] == n_passes
    assert rep["table-pass"]["calls"] == n_passes
    assert rep["table-fold"]["calls"] == n_passes - 1
    assert rep["D2H-meta"]["calls"] == 1  # one wait a table
    assert rep["D2H"]["calls"] == 1 and rep["D2H"]["rows"] == len(got.counts)
    assert "cap-rerun" not in rep
    _assert_same_table(got, whole)
    _assert_same_table(got, _jax_count(fn, jseqs, k, w))
    keys, counts = R.minimizer_table(flat, lengths, k, w, "cpu")
    np.testing.assert_array_equal(got.label_codes.view(np.int64),
                                  keys.numpy())
    np.testing.assert_array_equal(got.counts, counts.numpy())
    assert int(got.counts.sum()) == int(
        np.maximum(lengths - w + 1, 0).sum())


@pytest.mark.parametrize("cap,passes_cut", [(64, True), (4096, False)])
def test_a_table_past_its_cap_runs_the_passes_once_more(small_passes, cap,
                                                        passes_cut):
    """cap = 64 cuts every pass's table and the accumulator; at 4096 each
    pass's table fits and only the accumulator is cut.  Either way the
    passes run once more, at caps that fit, and the table is whole."""
    flat, lengths = _genome(3)
    seqs, jseqs = _arrays(flat, lengths)
    instrument.reset()
    got = tbnp.count_minimizers(seqs, 15, 24, cap=cap, device="cpu")
    rep = instrument.report()
    n_passes = len(tkmers.table_passes(resident.device_seq_blocks(seqs,
                                                                  "cpu")))
    assert rep["cap-rerun"]["calls"] == 1
    assert rep["table-passes"]["calls"] == rep["D2H-meta"]["calls"] == 2
    assert rep["table-passes"]["rows"] == 2 * n_passes
    pass_rows = [s["rows"] for s in instrument.spans()
                 if s["name"] == "table-pass"]
    assert len(pass_rows) == 2 * n_passes
    assert len(got.label_codes) > cap
    assert (max(pass_rows[:n_passes]) > cap) == passes_cut
    _assert_same_table(got, jbnp.sequence.count_minimizers(jseqs, 15, 24))


def test_one_row_longer_than_a_pass_is_one_pass(small_passes):
    """A row longer than a pass is a pass alone; an array of that row
    alone takes one whole_table: one sort, no fold, no pass span."""
    rng = np.random.default_rng(7)
    lengths = np.array([3 * PASS + 11])
    flat = rng.integers(0, 4, int(lengths[0])).astype(np.uint8)
    seqs, jseqs = _arrays(flat, lengths)
    assert len(tkmers.table_passes(resident.device_seq_blocks(seqs,
                                                              "cpu"))) == 1
    for fn, k, w in (("count_minimizers", 15, 24), ("count_kmers", 31, 31)):
        instrument.reset()
        got = _count(fn, seqs, k, w)
        rep = instrument.report()
        assert rep["sort"]["calls"] == 1
        assert not {"table-pass", "table-fold", "table-passes"} & set(rep)
        _assert_same_table(got, _jax_count(fn, jseqs, k, w))


def test_passes_are_runs_of_whole_rows(small_passes):
    flat, lengths = _genome(11, n_rows=60)
    lengths[40] = BLOCK  # a block of one row
    seqs = _arrays(np.zeros(int(lengths.sum()), np.uint8), lengths)[0]
    blocks = resident.device_seq_blocks(seqs, "cpu")
    passes = tkmers.table_passes(blocks)
    covered = {id(ds): [] for ds in blocks}
    for ds, r0, r1, p0, p1 in passes:
        ends = np.cumsum(ds.lengths)
        assert p0 == (ends[r0 - 1] if r0 else 0) and p1 == ends[r1 - 1]
        # at most a pass of bases, or one row longer than that
        assert p1 - p0 <= PASS or np.count_nonzero(ds.lengths[r0:r1]) == 1
        assert p1 > p0  # no pass of empty rows alone
        covered[id(ds)] += list(range(r0, r1))
    # every row with bases, in order, once
    for ds in blocks:
        rows = covered[id(ds)]
        assert rows == sorted(set(rows))
        assert set(np.flatnonzero(ds.lengths)) <= set(rows)
    assert len(blocks) > 2 and len(passes) > 20


def test_one_block_that_fits_a_pass_reads_no_rows():
    """The common case costs a length check: the cached handle is served
    without flattening the array, and one pass is the whole block."""
    flat, lengths = _genome(13)
    seqs = _arrays(flat, lengths)[0]
    ds = resident.device_seqs(seqs, "cpu")
    assert resident.device_seq_blocks(seqs, "cpu") == [ds]
    assert tkmers.table_passes([ds]) == [(ds, 0, len(lengths), 0, ds.n)]


@pytest.mark.parametrize("fold_rows", [1, 6 * PASS, None])
def test_tables_wait_for_a_fold_until_they_fill_one(small_passes,
                                                    monkeypatch, fold_rows):
    """The pass tables are merged once the rows held would pass FOLD_ROWS
    with the next table: at 1 after every pass, at the default (far
    above this array) once for all, in between in groups; the table is
    the same."""
    if fold_rows is None:
        monkeypatch.undo()
        monkeypatch.setattr(tkmers, "MAX_PACKED_BASES", BLOCK)
        monkeypatch.setattr(tkmers, "TABLE_PASS_POSITIONS", PASS)
    else:
        monkeypatch.setattr(tkmers, "FOLD_ROWS", fold_rows)
    flat, lengths = _genome(17)
    seqs, jseqs = _arrays(flat, lengths)
    n_passes = len(tkmers.table_passes(resident.device_seq_blocks(seqs,
                                                                  "cpu")))
    instrument.reset()
    got = tbnp.count_minimizers(seqs, 15, 24, device="cpu")
    names = [s["name"] for s in instrument.spans()
             if s["name"] in ("table-pass", "table-fold")]
    folds = names.count("table-fold")
    assert names.count("table-pass") == n_passes >= 8
    if fold_rows == 1:
        assert folds == n_passes - 1
        assert names[:3] == ["table-pass", "table-pass", "table-fold"]
    elif fold_rows is None:
        assert folds == 1 and names[-1] == "table-fold"
    else:
        assert 1 < folds < n_passes - 1
        assert names[:3] == ["table-pass"] * 3  # the first tables waited
    _assert_same_table(got, jbnp.sequence.count_minimizers(jseqs, 15, 24))


@pytest.mark.parametrize("fn,k,w", [("count_minimizers", 15, 24),
                                    ("count_kmers", 31, 31)])
@pytest.mark.parametrize("limit", [1 << 15, 1 << 16])
def test_one_block_past_the_whole_table_limit_takes_passes(monkeypatch, fn,
                                                           k, w, limit):
    """One resident block whose bucket (2^16 positions here) is at most
    WHOLE_TABLE_POSITIONS is one whole_table sort, as before passes
    existed; past it, the block is counted in passes and folded, with the
    same table."""
    flat, lengths = _genome(19)
    seqs, jseqs = _arrays(flat, lengths)
    monkeypatch.setattr(tkmers, "TABLE_PASS_POSITIONS", PASS)
    monkeypatch.setattr(tkmers, "WHOLE_TABLE_POSITIONS", limit)
    blocks = resident.device_seq_blocks(seqs, "cpu")
    assert len(blocks) == 1 and blocks[0].n_positions == 1 << 16
    n_passes = len(tkmers.table_passes(blocks))
    instrument.reset()
    got = _count(fn, seqs, k, w)
    rep = instrument.report()
    if limit == 1 << 16:
        assert n_passes == 1 and rep["sort"]["calls"] == 1
        assert not {"table-pass", "table-fold", "table-passes"} & set(rep)
    else:
        assert n_passes >= 8 and rep["table-passes"]["rows"] == n_passes
        assert rep["table-pass"]["calls"] == n_passes
    _assert_same_table(got, _jax_count(fn, jseqs, k, w))
