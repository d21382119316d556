"""Canonical k-mer tables (count_kmers(..., canonical=True)) and k-mer
spectra (kmer_spectrum) against the benchmark's plain reference
(portbench/kmer_spectrum_reference.py), on seeded reads from both
strands of a small genome with substitutions: at k 15, 21 and 31, on the
one-pass route (one whole_table sort) and on the passes route (resident
blocks and passes forced to a few thousand bases, as in
tests/test_torch_table_passes.py).  Also: a read set and its reverse
complements have one spectrum, counts past max_count land in the last
bin, canonical=False is count_kmers' table as before, k outside
12 < k < 32 raises, only the spectrum is fetched, and kernel 1's plain
canonical mode against a window-by-window recount, passes that start
inside a word included.  The JAX package has no canonical mode, so the
plain reference holds these.  On the CPU, with the kernels' plain
versions; exact equality."""
import os
import sys

import numpy as np
import pytest
import torch

import bionumpy_tpu_torch as tbnp
from bionumpy_tpu_torch import instrument
from bionumpy_tpu_torch.ops import kmer_kernels as kk
from bionumpy_tpu_torch.ops import kmers as tkmers
from bionumpy_tpu_torch.ops import resident

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import kmer_spectrum_reference as S  # noqa: E402

BLOCK = 7000  # bases a resident block holds, at most
PASS = 1500   # bases a pass keys, at most
KS = [15, 21, 31]
ROUTES = ["one_pass", "passes"]


def _reads(seed, n_reads=240, genome=2500, rate=0.01):
    """Seeded reads of 20-120 bases (one shorter than any k here, one
    empty) from both strands of a seeded genome, with substitutions at
    `rate`: a k-mer recurs in reads of either strand."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, genome).astype(np.uint8)
    rc = (3 - g[::-1]).copy()
    lengths = rng.integers(20, 121, n_reads)
    lengths[[3, 7]] = [0, 9]
    rows = []
    for n in lengths:
        src = rc if rng.integers(2) else g
        s = int(rng.integers(0, genome - n + 1))
        row = src[s: s + n].copy()
        hit = rng.random(n) < rate
        row[hit] = (row[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        rows.append(row)
    return np.concatenate(rows).astype(np.uint8), lengths


def _array(flat, lengths):
    return tbnp.EncodedRaggedArray(tbnp.EncodedArray(flat, tbnp.DNAEncoding),
                                   lengths)


def _reverse_complements(flat, lengths):
    """Every read reverse-complemented, in the same order."""
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    rows = [(3 - flat[s: s + n][::-1]) for s, n in zip(starts, lengths)]
    return np.concatenate(rows).astype(np.uint8), lengths


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    if request.param == "passes":
        monkeypatch.setattr(tkmers, "MAX_PACKED_BASES", BLOCK)
        monkeypatch.setattr(tkmers, "TABLE_PASS_POSITIONS", PASS)
        monkeypatch.setattr(tkmers, "FOLD_ROWS", 3 * PASS)
    return request.param


def _n_passes(seqs):
    return len(tkmers.table_passes(resident.device_seq_blocks(seqs, "cpu")))


@pytest.mark.parametrize("k", KS)
def test_canonical_table_equals_reference(route, k):
    flat, lengths = _reads(k)
    seqs = _array(flat, lengths)
    got = tbnp.count_kmers(seqs, k, device="cpu", canonical=True)
    assert (_n_passes(seqs) > 4) == (route == "passes")
    keys, counts = S.kmer_table(flat, lengths, k, True, "cpu")
    np.testing.assert_array_equal(got.label_codes.view(np.int64),
                                  keys.numpy())
    np.testing.assert_array_equal(got.counts, counts.numpy())
    assert got.label_codes.dtype == np.uint64 and got.counts.dtype == np.int64
    assert int(got.counts.sum()) == int(np.maximum(lengths - k + 1, 0).sum())
    # reads of both strands: the canonical table merges rows
    forward = tbnp.count_kmers(_array(flat, lengths), k, device="cpu")
    assert len(got.counts) < len(forward.counts)
    assert got.counts.max() > forward.counts.max()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("canonical", [True, False])
def test_spectrum_equals_reference(route, k, canonical):
    flat, lengths = _reads(100 + k)
    seqs = _array(flat, lengths)
    got = tbnp.kmer_spectrum(seqs, k, canonical=canonical, max_count=50,
                             device="cpu")
    want = S.kmer_spectrum(flat, lengths, k, canonical, 50, "cpu")
    assert got.dtype == np.int64 and got.shape == (51,)
    np.testing.assert_array_equal(got, want.numpy())
    assert got[0] == 0 and got[1] > 0 and got[2:].sum() > 0
    # the spectrum of count_kmers' own table
    table = tbnp.count_kmers(_array(flat, lengths), k, device="cpu",
                             canonical=canonical)
    np.testing.assert_array_equal(
        got, np.bincount(np.minimum(table.counts, 50), minlength=51))


@pytest.mark.parametrize("k", KS)
def test_spectrum_of_reverse_complements_is_the_same(route, k):
    flat, lengths = _reads(200 + k)
    got = tbnp.kmer_spectrum(_array(flat, lengths), k, device="cpu")
    rc = tbnp.kmer_spectrum(_array(*_reverse_complements(flat, lengths)), k,
                            device="cpu")
    np.testing.assert_array_equal(got, rc)
    # the forward keys see another table: the same reads, other spectrum
    fwd = tbnp.kmer_spectrum(_array(flat, lengths), k, canonical=False,
                             device="cpu")
    assert not np.array_equal(got, fwd)


@pytest.mark.parametrize("max_count", [1, 2, 7])
def test_counts_past_max_count_land_in_the_last_bin(route, max_count):
    """A read repeated 12 times: its k-mers count 12 (24 with its
    reverse complement among the reads) and land in h[max_count]."""
    flat, lengths = _reads(5)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    row = flat[starts[10]: starts[10] + lengths[10]]
    flat = np.concatenate([flat] + [row] * 12)
    lengths = np.concatenate([lengths, [lengths[10]] * 12])
    got = tbnp.kmer_spectrum(_array(flat, lengths), 21, max_count=max_count,
                             device="cpu")
    want = S.kmer_spectrum(flat, lengths, 21, True, max_count, "cpu")
    np.testing.assert_array_equal(got, want.numpy())
    counts = S.kmer_table(flat, lengths, 21, True, "cpu")[1].numpy()
    assert got[max_count] == int((counts >= max_count).sum())
    assert got.sum() == len(counts)
    assert counts.max() >= 12 > max_count


@pytest.mark.parametrize("k", KS)
def test_forward_table_is_unchanged(route, k):
    """canonical=False is count_kmers' table without the argument, and
    the plain reference's forward table."""
    flat, lengths = _reads(300 + k)
    got = tbnp.count_kmers(_array(flat, lengths), k, device="cpu",
                           canonical=False)
    before = tbnp.count_kmers(_array(flat, lengths), k, device="cpu")
    np.testing.assert_array_equal(got.label_codes, before.label_codes)
    np.testing.assert_array_equal(got.counts, before.counts)
    keys, counts = S.kmer_table(flat, lengths, k, False, "cpu")
    np.testing.assert_array_equal(got.label_codes.view(np.int64),
                                  keys.numpy())
    np.testing.assert_array_equal(got.counts, counts.numpy())


@pytest.mark.parametrize("k", [1, 5, 12, 32, 40])
def test_k_outside_the_table_range_raises(k):
    seqs = _array(*_reads(1, n_reads=20))
    with pytest.raises(ValueError, match="12 < k < 32"):
        tbnp.count_kmers(seqs, k, device="cpu", canonical=True)
    with pytest.raises(ValueError, match="12 < k < 32"):
        tbnp.kmer_spectrum(seqs, k, device="cpu")


def test_other_arguments_raise():
    seqs = _array(*_reads(1, n_reads=20))
    with pytest.raises(ValueError, match="axis"):
        tbnp.count_kmers(seqs, 21, axis=-1, device="cpu", canonical=True)
    with pytest.raises(ValueError, match="max_count"):
        tbnp.kmer_spectrum(seqs, 21, max_count=0, device="cpu")
    protein = tbnp.as_encoded_array(["MKVLAAGGHHWWMKVLAAGGHH"],
                                    tbnp.encodings.AminoAcidEncoding)
    with pytest.raises(TypeError, match="4-letter"):
        tbnp.kmer_spectrum(protein, 15, device="cpu")


def test_strings_are_encoded_as_dna():
    reads = ["ACGGTCATTGCAGCA", "TGCTGCAATGACCGT"]
    np.testing.assert_array_equal(
        tbnp.kmer_spectrum(reads, 13, max_count=4, device="cpu"),
        [0, 0, 3, 0, 0])
    got = tbnp.count_kmers(reads, 13, device="cpu", canonical=True)
    assert list(got.counts) == [2, 2, 2]


def test_only_the_spectrum_is_fetched(route):
    """One fetch a call, of the spectrum's bins; the kmer-spectrum span
    reads the table's rows and the bytes fetched; a cap that fits the
    table runs no pass twice, a small one reruns and agrees."""
    flat, lengths = _reads(9)
    table = S.kmer_table(flat, lengths, 21, True, "cpu")[1]
    for cap in (1 << 14, 64):
        instrument.reset()
        got = tbnp.kmer_spectrum(_array(flat, lengths), 21, max_count=30,
                                 cap=cap, device="cpu")
        rep = instrument.report()
        assert rep["D2H"]["calls"] == 1
        assert rep["D2H"]["rows"] == 31 and rep["D2H"]["bytes"] == 8 * 31
        assert rep["kmer-spectrum"]["calls"] == 1
        assert rep["kmer-spectrum"]["rows"] == table.numel()
        assert rep["kmer-spectrum"]["bytes"] == 8 * 31
        assert rep["kmer_spectrum"].get("call")
        assert ("cap-rerun" in rep) == (cap == 64)
        assert ("table-passes" in rep) == (route == "passes")
        np.testing.assert_array_equal(
            got, S.kmer_spectrum(flat, lengths, 21, True, 30, "cpu").numpy())


def test_a_read_set_past_its_cap_doubles_the_accumulator(monkeypatch):
    """The passes of a read set share most of their keys, so their
    distinct keys summed overstate the table many times.  Past
    RERUN_SUM_ROWS of that sum, count_kmers' and kmer_spectrum's default
    cap reruns the passes with the accumulator at the largest pass's
    table, doubled until the table fits: it ends under twice the
    table's rows, and the table is whole."""
    monkeypatch.setattr(tkmers, "MAX_PACKED_BASES", BLOCK)
    monkeypatch.setattr(tkmers, "TABLE_PASS_POSITIONS", PASS)
    monkeypatch.setattr(tkmers, "KMER_TABLE_CAP", 64)
    monkeypatch.setattr(tkmers, "RERUN_SUM_ROWS", 1 << 10)
    caps, fold = [], tkmers.fold_tables

    def recorded(key_passes, cap, pass_cap, on_card):
        caps.append(cap)
        return fold(key_passes, cap, pass_cap, on_card)

    monkeypatch.setattr(tkmers, "fold_tables", recorded)
    flat, lengths = _reads(11, n_reads=600)
    keys, counts = S.kmer_table(flat, lengths, 21, True, "cpu")
    n = counts.numel()
    instrument.reset()
    got = tbnp.count_kmers(_array(flat, lengths), 21, device="cpu",
                           canonical=True)
    rep = instrument.report()
    np.testing.assert_array_equal(got.label_codes.view(np.int64),
                                  keys.numpy())
    np.testing.assert_array_equal(got.counts, counts.numpy())
    n_passes = rep["table-passes"]["rows"] // len(caps)
    assert n_passes > 8 and rep["table-passes"]["calls"] == len(caps)
    assert rep["cap-rerun"]["calls"] == len(caps) - 1 >= 2
    assert caps[0] == 64 and caps[1] < n
    assert all(b == 2 * a for a, b in zip(caps[1:], caps[2:]))
    assert caps[-2] <= n < caps[-1] <= 2 * n
    caps.clear()
    h = tbnp.kmer_spectrum(_array(flat, lengths), 21, max_count=40,
                           device="cpu")
    np.testing.assert_array_equal(
        h, S.kmer_spectrum(flat, lengths, 21, True, 40, "cpu").numpy())
    assert caps[-2] <= n < caps[-1] <= 2 * n


def _recount(flat, lengths, k, n_true=None):
    """Each position's canonical key, window by window from the codes, the
    sentinel where the window leaves its row or starts at n_true or past
    it (kernel 1's rule)."""
    n = len(flat) if n_true is None else n_true
    ends = np.cumsum(lengths)
    row_end = np.repeat(ends, lengths)
    out = np.full(len(flat), kk.SENTINEL, np.int64)
    weights = 4 ** np.arange(k, dtype=np.int64)
    for p in range(len(flat)):
        if row_end[p] - p >= k and p < n:
            w = flat[p: p + k].astype(np.int64)
            fwd = int((w * weights).sum())
            rev = int(((3 - w[::-1]) * weights).sum())
            out[p] = min(fwd, rev)
    return out


@pytest.mark.parametrize("k", [1, 2, 13, 16, 17, 21, 31])
def test_plain_canonical_keys_equal_a_recount(k):
    flat, lengths = _reads(400 + k, n_reads=30)
    words, ends, n = tkmers.prepare_packed(flat, lengths)
    words = torch.from_numpy(words.view(np.int32))
    ends = torch.from_numpy(ends)
    for n_true in (n, n - 37):
        got = kk.kmer_keys(words, ends, k, n_true, canonical=True).numpy()
        want = _recount(flat, lengths, k, n_true)
        np.testing.assert_array_equal(got[:n], want)
        assert (got[n:] == kk.SENTINEL).all()
        forward = kk.kmer_keys(words, ends, k, n_true).numpy()
        assert (got <= forward).all() and (got < forward).any()


@pytest.mark.parametrize("k", [15, 31])
def test_canonical_pass_keys_from_inside_a_word(monkeypatch, k):
    """Each pass's canonical keys, keyed from the word of its first base
    (rarely a word boundary), equal the recount of the pass's windows."""
    monkeypatch.setattr(tkmers, "MAX_PACKED_BASES", BLOCK)
    monkeypatch.setattr(tkmers, "TABLE_PASS_POSITIONS", PASS)
    flat, lengths = _reads(500 + k)
    seqs = _array(flat, lengths)
    passes = tkmers.table_passes(resident.device_seq_blocks(seqs, "cpu"))
    want = _recount(flat, lengths, k)
    block_start = 0
    inside = 0
    blocks = []
    for ds, r0, r1, p0, p1 in passes:
        if not blocks or blocks[-1] is not ds:
            if blocks:
                block_start += blocks[-1].n
            blocks.append(ds)
        keys = tkmers._pass_keys((ds, r0, r1, p0, p1),
                                 tkmers.kmer_keys_of(k, canonical=True))
        off = p0 % kk.WORD_BASES
        inside += off != 0
        got = keys[off: off + p1 - p0].numpy()
        np.testing.assert_array_equal(
            got, want[block_start + p0: block_start + p1])
        assert (keys[:off] == kk.SENTINEL).all()
    assert len(passes) > 8 and inside > 4
