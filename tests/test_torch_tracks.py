"""The port's genomic-track ops (ops/tracks.py) against the JAX package's,
on the CPU: the same seeded intervals and packed sequences through both,
exact equality of int32 results."""
import numpy as np
import pytest
import torch

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu.ops import tracks as jtracks
from bionumpy_tpu_torch.ops import kmers as tkmers
from bionumpy_tpu_torch.ops import resident
from bionumpy_tpu_torch.ops import tracks as ttracks

N_POSITIONS = 5000


def _intervals(seed, n=300, limit=N_POSITIONS):
    """Seeded intervals in [0, limit]: empty ones, one-base ones, some
    spanning many bins, some ending at the limit, a fifth invalid."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, limit, n)
    spans = np.where(rng.random(n) < 0.2, rng.integers(0, 3, n),
                     rng.integers(0, 900, n))
    stops = np.minimum(starts + spans, limit)
    stops[:5] = limit
    valid = rng.random(n) < 0.8
    return starts.astype(np.int32), stops.astype(np.int32), valid


def _both(fn, *args, **kw):
    got = getattr(ttracks, fn)(*(torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in args), **kw)
    want = np.asarray(getattr(jtracks, fn)(*args, **kw))
    return got.numpy(), want


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_pileup_matches_jax(seed):
    starts, stops, valid = _intervals(seed)
    got, want = _both("dense_pileup", starts, stops, valid, N_POSITIONS)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 == want.dtype
    depth = np.zeros(N_POSITIONS, np.int64)
    for s, e in zip(starts[valid], stops[valid]):
        depth[s:e] += 1
    np.testing.assert_array_equal(got, depth)


@pytest.mark.parametrize("bin_size", [1, 7, 100, 1000])
def test_binned_pileup_matches_jax(bin_size):
    n_bins = -(-N_POSITIONS // bin_size)
    starts, stops, valid = _intervals(bin_size, limit=n_bins * bin_size)
    got, want = _both("binned_pileup", starts, stops, valid, n_bins,
                      bin_size)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 == want.dtype
    covered = np.zeros(n_bins * bin_size, np.int64)
    for s, e in zip(starts[valid], stops[valid]):
        covered[s:e] += 1
    np.testing.assert_array_equal(got,
                                  covered.reshape(n_bins, bin_size).sum(1))


def test_pileup_out_of_range_index_is_dropped_like_jax():
    """A stop past n_positions falls outside the boundary array: JAX's
    scatter drops it, and so does the port's."""
    starts = np.array([10, 20, 4990], np.int32)
    stops = np.array([30, 6000, 7000], np.int32)
    valid = np.ones(3, bool)
    got, want = _both("dense_pileup", starts, stops, valid, N_POSITIONS)
    np.testing.assert_array_equal(got, want)
    got, want = _both("binned_pileup", starts, stops, valid, 50, 100)
    np.testing.assert_array_equal(got, want)


def _packed(seed, n_bases=9000):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 300, 60)
    lengths = lengths[np.cumsum(lengths) <= n_bases]
    codes = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    words, ends, n = tkmers.prepare_packed(codes, lengths)
    return codes, lengths, words, n


@pytest.mark.parametrize("bin_size", [1, 97, 1000, 1 << 14])
def test_gc_binned_from_packed_matches_jax(bin_size):
    codes, _, words, n = _packed(bin_size)
    for n_true in (n, n - 41, 0):
        got = ttracks.gc_binned_from_packed(
            torch.from_numpy(words.view(np.int32)), n_true, bin_size).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jtracks.gc_binned_from_packed(words, n_true, bin_size)))
        assert got.dtype == np.int32
        flags = np.zeros(-(-(len(words) - 2) * 16 // bin_size) * bin_size,
                         np.int64)
        flags[:n_true] = (codes[:n_true] == 1) | (codes[:n_true] == 2)
        np.testing.assert_array_equal(got, flags.reshape(-1, bin_size).sum(1))


@pytest.mark.parametrize("bin_size,phase", [(97, 0), (97, 41), (1000, 999),
                                            (1, 0)])
def test_gc_binned_phase_matches_jax(bin_size, phase):
    _, _, words, n = _packed(7)
    got = ttracks.gc_binned_phase(torch.from_numpy(words.view(np.int32)), n,
                                  bin_size, phase).numpy()
    want = np.asarray(jtracks.gc_binned_phase(words, n, bin_size, phase))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert len(got) == (len(words) - 2) * 16 // bin_size + 2


def test_chunk_bins_stitch_to_the_whole_track():
    """Two chunks cut inside a bin: each chunk's phase bins, added at its
    offset on the global grid, give the whole sequence's bins."""
    codes, lengths, _, _ = _packed(9)
    bin_size, cut = 97, int(np.cumsum(lengths)[20])
    assert cut % bin_size
    whole = np.zeros(-(-len(codes) // bin_size) + 2, np.int64)
    for start, part in ((0, codes[:cut]), (cut, codes[cut:])):
        words, _, n = tkmers.prepare_packed(part, np.array([len(part)]))
        bins = ttracks.gc_binned_phase(torch.from_numpy(words.view(np.int32)),
                                       n, bin_size, start % bin_size).numpy()
        off = start // bin_size
        whole[off: off + len(bins)] += bins[: len(whole) - off]
    flags = np.zeros(len(whole) * bin_size, np.int64)
    flags[: len(codes)] = (codes == 1) | (codes == 2)
    np.testing.assert_array_equal(whole, flags.reshape(-1, bin_size).sum(1))


def test_gc_track_matches_jax():
    codes, lengths, _, _ = _packed(11)
    alpha = np.array(list("ACGT"))
    ends = np.cumsum(lengths)
    strings = ["".join(alpha[codes[e - n: e]]) for e, n in zip(ends, lengths)]
    seqs = tbnp.as_encoded_array(strings, tbnp.DNAEncoding)
    jseqs = jbnp.as_encoded_array(strings, jbnp.DNAEncoding)
    resident.reset_transfer_counters()
    got = ttracks.gc_track(seqs, 100, device="cpu")
    want = np.asarray(jtracks.gc_track(jseqs, 100))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and len(got) == -(-len(codes) // 100)
    ttracks.gc_track(seqs, 1000, device="cpu")
    assert resident.TRANSFER_COUNT == 1
