"""The plain reference against a brute-force count on tiny inputs, and
the table comparison and the control."""
from collections import Counter

import numpy as np
import torch

import tiny  # noqa: F401  (puts the repo root on sys.path)
from portbench import reference as R


def _rows(seed, n_rows=12, lo=0, hi=60):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi, n_rows)
    return rng.integers(0, 4, int(lengths.sum())).astype(np.uint8), lengths


def _brute_windows(flat, lengths, k, window):
    out, start = [], 0
    for n in lengths:
        row = [int(c) for c in flat[start:start + n]]
        start += n
        hashes = [sum(row[s + j] << (2 * j) for j in range(k))
                  for s in range(n - k + 1)]
        out += [min(hashes[s: s + window - k + 1])
                for s in range(n - window + 1)]
    return Counter(out)


def _as_counter(keys, counts):
    return dict(zip(keys.tolist(), counts.tolist()))


def test_kmer_table_matches_brute_force():
    for seed, k in ((1, 31), (2, 5), (3, 1), (4, 16)):
        flat, lengths = _rows(seed)
        keys, counts = R.kmer_table(flat, lengths, k, "cpu")
        assert _as_counter(keys, counts) == _brute_windows(flat, lengths,
                                                           k, k)
        assert bool((keys[1:] > keys[:-1]).all())


def test_minimizer_table_matches_brute_force():
    for seed, k, w in ((5, 21, 30), (6, 3, 7), (7, 4, 4)):
        flat, lengths = _rows(seed, hi=80)
        keys, counts = R.minimizer_table(flat, lengths, k, w, "cpu")
        assert _as_counter(keys, counts) == _brute_windows(flat, lengths,
                                                           k, w)


def test_blocks_cut_on_rows(monkeypatch):
    flat, lengths = _rows(8, n_rows=40, hi=90)
    whole = R.kmer_table(flat, lengths, 11, "cpu")
    monkeypatch.setattr(R, "BLOCK_BASES", 100)
    assert all(e - s >= 0 for s, e in R.row_blocks(lengths, 100))
    cut = R.count_table(torch.cat([R.window_values(
        flat, lengths, 11, 11, "cpu")]))
    assert torch.equal(whole[0], cut[0]) and torch.equal(whole[1], cut[1])
    ends = [e for _, e in R.row_blocks(lengths, 100)]
    assert ends[-1] == lengths.sum() and set(ends) <= set(np.cumsum(lengths))


def test_gc_bins():
    flat = np.array([0, 1, 2, 3, 1, 1, 0], np.uint8)
    assert R.gc_bins(flat, 3, "cpu").tolist() == [2, 2, 0]


def test_rows_differing():
    t = lambda *x: torch.tensor(x, dtype=torch.int64)  # noqa: E731
    assert R.rows_differing(t(1, 5, 9), t(2, 2, 2), t(1, 5, 9),
                            t(2, 2, 2)) == 0
    assert R.rows_differing(t(1, 5, 9), t(2, 2, 2), t(1, 5, 9),
                            t(2, 3, 2)) == 2
    assert R.rows_differing(t(1, 5, 9), t(2, 2, 2), t(1, 9),
                            t(2, 2)) == 1
    assert R.rows_differing(t(1, 5), t(2, 2), t(), t()) == 2


def test_control_merges_keys_that_share_low_bits():
    keys = torch.tensor([3, 3 + (1 << 32), 7, 9 + (5 << 32)])
    counts = torch.tensor([1, 4, 2, 3])
    k, c = R.fingerprint_control(keys, counts)
    assert k.tolist() == [3, 7, 9 + (5 << 32)]
    assert c.tolist() == [5, 2, 3]
    assert R.rows_differing(keys, counts, k, c) == 3
