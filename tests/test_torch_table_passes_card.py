"""Tables built in passes over resident blocks on the card
(ops/kmers.blocked_table): the folded table of count_minimizers and of
count_kmers equals the same call as one pass, at a size whose blocks
and passes are forced small enough to make 3 or more passes; the spans,
the counter and kernel 1's launches are read just after.  The folds'
merge kernel (ops/table_kernels) equals its plain version bit for bit
at sizes that cross many tiles, and the chunked GC job, which folds
through it, equals the same job in one chunk.  Canonical tables
(count_kmers(..., canonical=True)) on the card equal the CPU's, one pass
and in passes, and kmer_spectrum over ~1.08 G bases of reads, in passes,
equals the benchmark's plain reference on the card.  The run table
kernel (table_kernels.run_table) equals its plain version bit for bit on
random, adversarial and 2^28-key sorted keys, rows past the runs
included; it launches once a table, and the tables and spectra it makes
equal the CPU's.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_table_passes_card.py
"""
import numpy as np
import pytest
import torch

import bionumpy_tpu_torch as bt
from bionumpy_tpu_torch import instrument
from bionumpy_tpu_torch.ops import kmer_kernels, kmers, resident
from bionumpy_tpu_torch.ops import table_kernels

S = table_kernels.SENTINEL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _genome(seed):
    """24 seeded rows of up to 900,000 bases, one shorter than a window."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 900_000, 24)
    lengths[7] = 20
    return rng.integers(0, 4, int(lengths.sum())).astype(np.uint8), lengths


def _seqs(flat, lengths):
    return bt.EncodedRaggedArray(bt.EncodedArray(flat, bt.DNAEncoding),
                                 lengths)


def _count(seqs, fn, k, w, device, cap=1 << 24):
    if fn == "count_kmers":
        return bt.count_kmers(seqs, k, device=device)
    return bt.count_minimizers(seqs, k, w, cap=cap, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("fold_rows", [1, None])  # a fold a pass; the default
@pytest.mark.parametrize("fn,k,w,cap", [
    ("count_minimizers", 15, 24, 1 << 24),
    ("count_minimizers", 15, 24, 1 << 12),  # every table past its cap
    # count_kmers' first cap, 2^20, lies below these tables' rows
    ("count_kmers", 21, 21, None), ("count_kmers", 31, 31, None)])
def test_folded_table_on_card_equals_one_pass(cuda, monkeypatch, fn, k, w,
                                              cap, fold_rows):
    flat, lengths = _genome(k + w)
    whole = _count(_seqs(flat, lengths), fn, k, w, cuda)
    monkeypatch.setattr(kmers, "MAX_PACKED_BASES", 1 << 23)
    monkeypatch.setattr(kmers, "TABLE_PASS_POSITIONS", 1 << 21)
    if fold_rows:
        monkeypatch.setattr(kmers, "FOLD_ROWS", fold_rows)
    seqs = _seqs(flat, lengths)
    n_passes = len(kmers.table_passes(resident.device_seq_blocks(seqs,
                                                                 cuda)))
    assert n_passes >= 3
    kmer_kernels.reset_launches()
    instrument.reset()
    got = _count(seqs, fn, k, w, cuda, cap)
    rep = instrument.report()
    launches = kmer_kernels.LAUNCHES["kmer_keys_kernel"]
    np.testing.assert_array_equal(got.label_codes, whole.label_codes)
    np.testing.assert_array_equal(got.counts, whole.counts)
    assert got.label_codes.dtype == np.uint64 and got.counts.dtype == np.int64
    assert int(got.counts.sum()) == int(np.maximum(lengths - w + 1, 0).sum())
    # a table past its first cap (count_kmers': 2^20) runs its passes twice
    runs = 1 + (len(whole.counts) >= (cap or 1 << 20))
    assert (runs == 2) == (cap != 1 << 24)
    assert rep.get("cap-rerun", {}).get("calls", 0) == runs - 1
    assert launches == rep["table-pass"]["calls"] == runs * n_passes
    # the default FOLD_ROWS holds all of these tables for one fold
    assert rep["table-fold"]["calls"] == runs * (n_passes - 1 if fold_rows
                                                 else 1)
    assert rep["table-passes"]["calls"] == rep["D2H-meta"]["calls"] == runs
    assert rep["table-passes"]["rows"] == runs * n_passes
    assert rep["table-fold"]["device_seconds"] > 0
    assert rep["table-pass"]["device_seconds"] > 0
    assert rep["D2H"]["rows"] == len(got.counts)


def _table(keys, rows, gen):
    """A sentinel table on the keys' device: the sorted unique `keys`
    (the first `rows`), seeded counts of 1-99, then (S, 0) rows."""
    keys = torch.unique(keys)[:rows]
    k = torch.full((rows,), S, dtype=torch.int64, device=keys.device)
    c = torch.zeros(rows, dtype=torch.int64, device=keys.device)
    k[:keys.numel()] = keys
    c[:keys.numel()] = torch.randint(1, 100, (keys.numel(),), generator=gen,
                                     device=keys.device)
    return k, c


def _merge_case(name, dev):
    """(tables, cap) of one named case on the card, across many tiles of
    2048 merged rows."""
    gen = torch.Generator(device=dev).manual_seed(sum(map(ord, name)))

    def rand(n, hi):
        return torch.randint(0, hi, (n,), generator=gen, device=dev)

    def ar(*a):
        return torch.arange(*a, device=dev)

    big, inf = (1 << 62) - 1, 1 << 40
    if name == "disjoint":
        return [_table(rand(300_000, 1 << 30), 300_000, gen),
                _table(rand(200_000, 1 << 30) + (1 << 31), 250_000, gen)], inf
    if name == "interleaved":
        return [_table(ar(0, 2_000_000, 2), 1_000_000, gen),
                _table(ar(1, 2_000_000, 2), 1_100_000, gen)], inf
    if name == "identical":
        keys = rand(500_000, 1 << 40)
        return [_table(keys, 600_000, gen), _table(keys, 500_000, gen)], inf
    if name == "straddle":
        # one key below the pairs puts each pair's A row last in a tile
        # and its B row first in the next
        pairs = ar(1, 400_001) * 2
        return [_table(torch.cat([ar(1), pairs]), 400_001, gen),
                _table(pairs, 400_000, gen)], inf
    if name == "extremes":
        edge = torch.tensor([0, big - 2, big], device=dev)
        return [_table(torch.cat([edge, rand(90_000, big)]), 100_000, gen),
                _table(torch.cat([edge - 1, rand(90_000, big)]).clamp(min=0),
                       95_000, gen)], inf
    if name == "all-padding":
        return [_table(ar(0), 100_000, gen),
                _table(rand(70_000, 1 << 20), 80_000, gen),
                _table(ar(0), 30_000, gen)], inf
    if name == "empty":
        return [_table(ar(0), 0, gen), _table(rand(70_000, 1 << 20), 80_000,
                                              gen)], inf
    if name == "truncated":
        tables = []
        for rows in (60_000, 45_000):
            k, c, meta = kmers.sentinel_table(rand(4 * rows, 1 << 24), rows)
            assert int(meta[0]) > rows and bool((k != S).all())
            tables.append((k, c))
        return tables, inf
    if name in ("cap", "cap+1"):
        a = _table(ar(0, 400_000, 2), 250_000, gen)  # 200,000 keys
        b = _table(ar(0, 200_000, 5), 50_000, gen)   # 40,000, 20,000 new
        return [a, b], 220_000 - (name == "cap+1")
    if name == "half-padding":  # ~2^26-row inputs, half of them padding
        return [_table(rand(1 << 25, 1 << 30), 1 << 26, gen),
                _table(rand(1 << 25, 1 << 30), 1 << 26, gen)], 1 << 27
    n = {"two": 2, "three": 3, "four": 4}[name]
    return [_table(rand(int(rows * 0.7), 3_000_000), rows, gen)
            for rows in (900_000, 300_000, 1_200_000, 50_000)[:n]], 2_500_000


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "disjoint", "interleaved", "identical", "straddle", "extremes",
    "all-padding", "empty", "truncated", "cap", "cap+1", "two", "three",
    "four", "half-padding"])
def test_merge_kernel_equals_its_plain_version(cuda, name):
    tables, cap = _merge_case(name, cuda)
    table_kernels.reset_launches()
    keys, counts, n_unique = table_kernels.merge_tables(tables, cap)
    torch.cuda.synchronize()
    assert table_kernels.LAUNCHES["merge_tables_kernel"] == len(tables) - 1
    want_k, want_c, want_n = table_kernels.merge_tables_plain(tables, cap)
    assert keys.dtype == counts.dtype == n_unique.dtype == torch.int64
    assert keys.device == counts.device == n_unique.device == tables[0][0].device
    assert n_unique.dim() == 0 and int(n_unique) == int(want_n)
    assert torch.equal(keys, want_k)
    whole = table_kernels.merge_tables_plain(tables, 1 << 40)
    distinct = int(whole[2])
    if distinct > cap:
        # past cap the kernel keeps the last total whole; the plain
        # version cuts it
        assert name == "cap+1" and int(n_unique) == cap
        assert torch.equal(counts[:-1], want_c[:-1])
        assert int(counts[-1]) == int(whole[1][cap - 1])
    else:
        assert torch.equal(counts, want_c)
    if name == "cap":
        assert distinct == cap == int(n_unique)


@pytest.mark.cuda
def test_folds_on_card_merge_without_a_sort(cuda, monkeypatch):
    """count_minimizers with small passes forced: the table of one pass,
    every fold through the merge kernel (one launch per table merged
    into the accumulator) and no sort inside a `table-fold` span."""
    flat, lengths = _genome(39)
    whole = _count(_seqs(flat, lengths), "count_minimizers", 15, 24, cuda)
    monkeypatch.setattr(kmers, "MAX_PACKED_BASES", 1 << 23)
    monkeypatch.setattr(kmers, "TABLE_PASS_POSITIONS", 1 << 21)
    monkeypatch.setattr(kmers, "FOLD_ROWS", 3 << 21)  # two folds or more
    table_kernels.reset_launches()
    instrument.reset()
    got = _count(_seqs(flat, lengths), "count_minimizers", 15, 24, cuda)
    rep = instrument.report()
    np.testing.assert_array_equal(got.label_codes, whole.label_codes)
    np.testing.assert_array_equal(got.counts, whole.counts)
    folds = rep["table-fold"]["calls"]
    assert folds >= 2 and rep["fold-merge"]["calls"] == folds
    assert table_kernels.LAUNCHES["merge_tables_kernel"] == \
        rep["fold-merge"]["rows"] - folds > 0
    assert not [s for s in instrument.spans()
                if s["name"] == "sort" and s["parent"] == "table-fold"]
    assert rep["sort"]["calls"] == rep["table-pass"]["calls"]


@pytest.mark.cuda
def test_chunked_gc_job_on_card_equals_one_chunk(cuda):
    flat, lengths = _genome(41)
    seqs = _seqs(flat, lengths)
    kw = dict(cap=1 << 24, bin_size=1000, device=cuda)
    one, gc_one = bt.count_minimizers_with_gc(seqs, 15, 24, **kw)
    table_kernels.reset_launches()
    instrument.reset()
    four, gc_four = bt.count_minimizers_with_gc(seqs, 15, 24, n_chunks=4,
                                                **kw)
    rep = instrument.report()
    np.testing.assert_array_equal(four.label_codes, one.label_codes)
    np.testing.assert_array_equal(four.counts, one.counts)
    np.testing.assert_array_equal(gc_four, gc_one)
    assert rep["fold-merge"]["calls"] == rep["table-fold"]["calls"] >= 1
    assert table_kernels.LAUNCHES["merge_tables_kernel"] == \
        rep["fold-merge"]["rows"] - rep["fold-merge"]["calls"]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [15, 21, 31])
@pytest.mark.parametrize("passes", [False, True])
def test_canonical_table_on_card_equals_cpu(cuda, monkeypatch, k, passes):
    rng = np.random.default_rng(k)
    lengths = rng.integers(0, 300, 20_000)
    lengths[::7] = 150
    flat = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    # every read's reverse complement among the reads too
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    flat = np.concatenate([flat] + [3 - flat[s: s + n][::-1]
                                    for s, n in zip(starts[:5000],
                                                    lengths[:5000])])
    lengths = np.concatenate([lengths, lengths[:5000]])
    want = bt.count_kmers(_seqs(flat, lengths), k, device="cpu",
                          canonical=True)
    if passes:
        monkeypatch.setattr(kmers, "MAX_PACKED_BASES", 1 << 21)
        monkeypatch.setattr(kmers, "TABLE_PASS_POSITIONS", 1 << 19)
    seqs = _seqs(flat, lengths)
    n_passes = len(kmers.table_passes(resident.device_seq_blocks(seqs,
                                                                 cuda)))
    assert (n_passes >= 3) == passes
    kmer_kernels.reset_launches()
    got = bt.count_kmers(seqs, k, device=cuda, canonical=True)
    np.testing.assert_array_equal(got.label_codes, want.label_codes)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert kmer_kernels.LAUNCHES["kmer_keys_kernel"] == 0
    assert kmer_kernels.LAUNCHES["kmer_keys_kernel.canonical"] >= n_passes


@pytest.mark.cuda
def test_spectrum_of_a_gigabase_of_reads_on_card_equals_reference(cuda):
    """7.2 M seeded reads of 150 bases (1.08 G bases, past one block's
    whole-table sort) from both strands of a 36 M-base genome with
    substitutions: kmer_spectrum in passes on the card, fetching the
    spectrum alone, against portbench/kmer_spectrum_reference.py on the
    card."""
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import kmer_spectrum_reference as ref
    from portbench import traffic

    config = {"genome": {"chromosome_sizes": {"a": 24_000_000,
                                              "b": 12_000_000}},
              "reads": {"read_length": 150,
                        "quality_weights": {"F": 17, "8": 3}}}
    inp = traffic.reads_input(config, 3_241_000_001, traffic.ARRAYS,
                              7_200_000)
    seqs = _seqs(inp.flat, inp.lengths)
    n_passes = len(kmers.table_passes(resident.device_seq_blocks(seqs,
                                                                 cuda)))
    assert n_passes >= 2 and inp.n_bases > kmers.WHOLE_TABLE_POSITIONS
    kmer_kernels.reset_launches()
    instrument.reset()
    got = bt.kmer_spectrum(seqs, 21, max_count=10000, cap=1 << 27,
                           device=cuda)
    rep = instrument.report()
    assert kmer_kernels.LAUNCHES["kmer_keys_kernel.canonical"] == n_passes
    assert rep["table-passes"]["rows"] == n_passes
    assert rep["D2H"]["calls"] == 1 and rep["D2H"]["bytes"] == 8 * 10001
    assert rep["kmer-spectrum"]["device_seconds"] > 0
    assert "cap-rerun" not in rep
    del seqs
    want = ref.kmer_spectrum(inp.flat, inp.lengths, 21, True, 10000, cuda)
    np.testing.assert_array_equal(got, want.cpu().numpy())
    # an error mass at count 1 and a genomic peak near 30 x 130/150
    assert got[0] == 0 and got[1] > got[5]
    assert 15 < int(np.argmax(got[5:])) + 5 < 35


def _sorted_keys(name, dev):
    """Sorted int64 keys of one named case on the card (the sentinel
    last), across many tiles of 2048 keys."""
    gen = torch.Generator(device=dev).manual_seed(sum(map(ord, name)))

    def rand(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    def sentinels(n):
        return torch.full((n,), S, dtype=torch.int64, device=dev)

    if name == "random":
        keys = rand(3_000_000, 0, 1 << 21)
        keys[rand(3_000_000, 0, 10) == 0] = S
    elif name == "distinct":  # no sentinel, runs of one
        keys = rand(2_500_000, 0, 1 << 62)
    elif name == "all-sentinel":
        keys = sentinels(1_000_003)
    elif name == "one-key":
        keys = torch.tensor([42], device=dev)
    elif name == "one-run":  # one run over ~490 tiles, then sentinels
        keys = torch.cat([torch.full((1_000_000,), 7, device=dev),
                          sentinels(77)])
    elif name == "runs-past-tiles":  # runs of 2-60 tiles
        lengths = rand(40, 4096, 120_000)
        keys = torch.repeat_interleave(rand(40, 0, 1 << 40), lengths)
    elif name == "tile-edges":  # runs of 2047, 2048 and 2049 keys
        lengths = torch.tensor([2047, 2048, 2049] * 300, device=dev)
        keys = torch.repeat_interleave(torch.arange(900, device=dev) * 5,
                                       lengths)
    elif name == "warp-edges":  # runs of 31, 32, 33 and 256 keys
        lengths = torch.tensor([31, 32, 33, 256] * 5000, device=dev)
        keys = torch.repeat_interleave(torch.arange(20_000, device=dev),
                                       lengths)
        keys = torch.cat([keys, sentinels(5)])
    elif name == "extremes":
        edge = torch.tensor([-(1 << 63), -1, 0, S - 1, S - 1], device=dev)
        keys = torch.cat([edge, rand(1_000_000, -(1 << 62), 1 << 62),
                          sentinels(3)])
    elif name == "pass-2^28":  # a pass of 2^28 keys, about half distinct
        keys = rand(1 << 28, 0, 145_000_000)
        keys[rand(1 << 28, 0, 16) == 0] = S
    else:
        raise KeyError(name)
    return torch.sort(keys)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "random", "distinct", "all-sentinel", "one-key", "one-run",
    "runs-past-tiles", "tile-edges", "warp-edges", "extremes", "pass-2^28"])
def test_run_table_kernel_equals_its_plain_version(cuda, name):
    s = _sorted_keys(name, cuda)
    n = s.numel()
    n_unique = int(torch.unique_consecutive(s[s != S]).numel())
    # every key; above, at and below the runs (the truncated last row)
    for rows in sorted({n, min(n, n_unique + 3), max(1, n_unique),
                        max(1, n_unique // 2), 1}):
        table_kernels.reset_launches()
        got = table_kernels.run_table(s, rows)
        torch.cuda.synchronize()
        assert table_kernels.LAUNCHES["run_table_kernel"] == 1
        want = table_kernels.run_table_plain(s, rows)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == torch.int64
            assert g.device == s.device
            assert torch.equal(g, w), (name, rows)
        assert int(got[2][0]) == n_unique
        del got, want


@pytest.mark.cuda
def test_run_table_launches_once_a_pass(cuda, monkeypatch):
    """count_minimizers in forced small passes: one run table launch a
    pass (`table-pass`, `run-table`), the table the CPU's."""
    flat, lengths = _genome(43)
    lengths = lengths[lengths.cumsum() <= 4_000_000]  # the first rows
    flat = flat[:int(lengths.sum())]
    want = _count(_seqs(flat, lengths), "count_minimizers", 15, 24, "cpu")
    monkeypatch.setattr(kmers, "MAX_PACKED_BASES", 1 << 21)
    monkeypatch.setattr(kmers, "TABLE_PASS_POSITIONS", 1 << 19)
    seqs = _seqs(flat, lengths)
    n_passes = len(kmers.table_passes(resident.device_seq_blocks(seqs,
                                                                 cuda)))
    assert n_passes >= 3
    table_kernels.reset_launches()
    instrument.reset()
    got = _count(seqs, "count_minimizers", 15, 24, cuda)
    rep = instrument.report()
    np.testing.assert_array_equal(got.label_codes, want.label_codes)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert table_kernels.LAUNCHES["run_table_kernel"] == n_passes == \
        rep["table-pass"]["calls"] == rep["run-table"]["calls"]
    assert rep["run-table"]["rows"] == rep["table-pass"]["rows"]


@pytest.mark.cuda
@pytest.mark.parametrize("job", ["count_kmers", "count_minimizers",
                                 "kmer_spectrum"])
def test_tables_through_the_run_table_on_card_equal_cpu(cuda, monkeypatch,
                                                       job):
    """count_kmers over one block (a whole table past its first cap: two
    run table launches from one sort), count_minimizers and kmer_spectrum
    in passes: the tables and spectra the CPU's plain versions give."""
    rng = np.random.default_rng(len(job))
    lengths = rng.integers(100, 200, 20_000)
    flat = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    # every fifth read again, so keys repeat
    flat = np.concatenate([flat, flat[:int(lengths[:4000].sum())]])
    lengths = np.concatenate([lengths, lengths[:4000]])

    def run(device):
        seqs = _seqs(flat, lengths)
        if job == "count_kmers":
            return bt.count_kmers(seqs, 31, device=device)
        if job == "count_minimizers":
            return bt.count_minimizers(seqs, 15, 24, cap=1 << 22,
                                       device=device)
        return bt.kmer_spectrum(seqs, 21, max_count=10000, device=device)

    want = run("cpu")
    if job != "count_kmers":
        monkeypatch.setattr(kmers, "MAX_PACKED_BASES", 1 << 21)
        monkeypatch.setattr(kmers, "TABLE_PASS_POSITIONS", 1 << 19)
    table_kernels.reset_launches()
    instrument.reset()
    got = run(cuda)
    rep = instrument.report()
    launches = table_kernels.LAUNCHES["run_table_kernel"]
    if job == "kmer_spectrum":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got.label_codes, want.label_codes)
        np.testing.assert_array_equal(got.counts, want.counts)
    if job == "count_kmers":
        # ~2.4 M distinct 31-mers pass count_kmers' first cap, 2^20
        assert len(got.counts) > 1 << 20
        assert launches == 2 and rep["cap-rerun"]["calls"] == 1
    else:
        assert launches == rep["table-pass"]["calls"] >= 3
    assert launches == rep["run-table"]["calls"]
