"""The port's minimizers (sequence/minimizers.py, ops/minimizers.py and
ops/kmers.kmer_hash_limbs) against the JAX package's, on the CPU: the
same seeded sequences through both, exact equality of hashes, counts,
GC bins and dtypes.  Every input holds under 2^14 bases, so both
packages use one bucket.  The port's minimizer keys may differ from the
JAX package's only at windows that leave their row (the sentinel there);
those windows are masked before every comparison."""
import functools

import numpy as np
import pytest
import torch

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu.encodings import ACGTnEncoding as JACGTnEncoding
from bionumpy_tpu.ops import kmers as jkmers
from bionumpy_tpu.ops import minimizers as jmin
from bionumpy_tpu.ops import tracks as jtracks
from bionumpy_tpu_torch import instrument
from bionumpy_tpu_torch.encodings import ACGTnEncoding
from bionumpy_tpu_torch.ops import kmers as tkmers
from bionumpy_tpu_torch.ops import minimizers as tmin
from bionumpy_tpu_torch.ops.kmer_kernels import SENTINEL
from bionumpy_tpu_torch.sequence import minimizers as tseqmin

# (k, window_size): config 3's, a short one, and one k-mer per window
CASES = [(21, 30), (5, 12), (4, 4)]


def _strings(window_size, seed=0, alphabet="ACGT", n_random=30):
    """Rows of every length 0..window_size+3, then random rows of up to
    200 letters."""
    rng = np.random.default_rng(seed + window_size)
    lengths = list(range(window_size + 4)) + \
        list(rng.integers(0, 200, n_random))
    letters = np.array(list(alphabet))
    return ["".join(rng.choice(letters, n)) for n in lengths]


def _pair(strings, jenc=None, tenc=None):
    jenc = jbnp.DNAEncoding if jenc is None else jenc
    tenc = tbnp.DNAEncoding if tenc is None else tenc
    return (tbnp.as_encoded_array(strings, tenc),
            jbnp.as_encoded_array(strings, jenc))


def _assert_same_ragged(got, want):
    assert type(got).__name__ == type(want).__name__
    assert str(got.encoding) == str(want.encoding)
    if hasattr(want, "lengths"):
        np.testing.assert_array_equal(got.lengths, want.lengths)
        got, want = got.ravel(), want.ravel()
    np.testing.assert_array_equal(got.raw(), want.raw())
    assert got.raw().dtype == want.raw().dtype


def _assert_same_table(got, want):
    np.testing.assert_array_equal(got.label_codes, want.label_codes)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.label_codes.dtype == np.uint64 == want.label_codes.dtype
    assert got.counts.dtype == np.int64 == np.asarray(want.counts).dtype
    assert str(got.encoding) == str(want.encoding)


@pytest.mark.parametrize("k,w", CASES)
def test_get_minimizers_matches_jax(k, w):
    seqs, jseqs = _pair(_strings(w))
    got = tbnp.get_minimizers(seqs, k, w, device="cpu")
    _assert_same_ragged(got, jbnp.sequence.get_minimizers(jseqs, k, w))
    assert list(got.lengths[: w + 4]) == [0] * w + [1, 2, 3, 4]


def test_flat_input_gives_flat_result():
    s = "ACGTTGCAACGGTTTACG" * 5
    got = tbnp.get_minimizers(tbnp.as_encoded_array(s, tbnp.DNAEncoding),
                              5, 12, device="cpu")
    want = jbnp.sequence.get_minimizers(
        jbnp.as_encoded_array(s, jbnp.DNAEncoding), 5, 12)
    assert len(got) == len(s) - 11
    _assert_same_ragged(got, want)


@pytest.mark.parametrize("k,w", CASES)
@pytest.mark.parametrize("cap", [1 << 20, 16])
def test_count_minimizers_matches_jax(k, w, cap):
    """cap = 16 is below the distinct count: both double it until the
    table fits."""
    seqs, jseqs = _pair(_strings(w, seed=1))
    got = tbnp.count_minimizers(seqs, k, w, cap=cap, device="cpu")
    want = jbnp.sequence.count_minimizers(jseqs, k, w, cap=cap)
    _assert_same_table(got, want)
    assert len(got.label_codes) > 16
    assert int(got.counts.sum()) == int(
        np.maximum(seqs.lengths - w + 1, 0).sum())


@pytest.mark.parametrize("k,w,cap", [(21, 30, 1 << 20), (5, 12, 16)])
def test_count_minimizers_with_gc_matches_jax(k, w, cap):
    seqs, jseqs = _pair(_strings(w, seed=2))
    got_t, got_gc = tbnp.count_minimizers_with_gc(seqs, k, w, cap=cap,
                                                  bin_size=97, device="cpu")
    want_t, want_gc = jbnp.sequence.count_minimizers_with_gc(
        jseqs, k, w, cap=cap, bin_size=97)
    _assert_same_table(got_t, want_t)
    np.testing.assert_array_equal(got_gc, want_gc)
    assert got_gc.dtype == np.int32 == want_gc.dtype
    flat = seqs.ravel().raw()
    n = len(flat)
    assert len(got_gc) == -(-n // 97)
    np.testing.assert_array_equal(got_gc, np.add.reduceat(
        ((flat == 1) | (flat == 2)).astype(np.int64), np.arange(0, n, 97)))


@pytest.mark.parametrize("cap", [1, 64, None])
@pytest.mark.parametrize("table", ["count_kmers", "count_minimizers",
                                   "count_minimizers_with_gc"])
def test_one_sort_at_any_cap(monkeypatch, table, cap):
    """A resident table sorts its keys once whatever cap its first
    compaction takes (None: the default; 1 and 64 lie below the distinct
    count, so the table is compacted again from the same sort), and
    equals the JAX package's."""
    seqs, jseqs = _pair(_strings(30, seed=5))
    kw = {} if cap is None else {"cap": cap}
    if table == "count_kmers":
        # count_kmers takes no cap: its table's default is set here
        if cap is not None:
            monkeypatch.setattr(tkmers, "sparse_count_tables",
                                functools.partial(tkmers.sparse_count_tables,
                                                  cap=cap))
        want = jbnp.count_kmers(jseqs, 31)
        def run():
            return tbnp.count_kmers(seqs, 31, device="cpu")
    elif table == "count_minimizers":
        want = jbnp.sequence.count_minimizers(jseqs, 21, 30)
        def run():
            return tbnp.count_minimizers(seqs, 21, 30, device="cpu", **kw)
    else:
        want = jbnp.sequence.count_minimizers_with_gc(jseqs, 21, 30,
                                                      bin_size=97)[0]
        def run():
            return tbnp.count_minimizers_with_gc(seqs, 21, 30, bin_size=97,
                                                 device="cpu", **kw)[0]
    instrument.reset()
    got = run()
    rep = instrument.report()
    assert rep["sort"]["calls"] == 1
    assert rep.get("cap-rerun", {}).get("calls", 0) == (cap is not None)
    _assert_same_table(got, want)
    assert len(got.label_codes) > 64


def _chunk_starts(lengths, n_chunks):
    """Global base offsets of the chunks the chunked path cuts (its row
    bounds, recomputed)."""
    cum = np.cumsum(lengths)
    total = int(cum[-1])
    bounds = [0]
    for g in range(1, n_chunks):
        r = int(np.searchsorted(cum, total * g // n_chunks))
        bounds.append(max(bounds[-1], min(r + 1, len(lengths))))
    return [int(cum[b - 1]) if b else 0 for b in bounds]


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
@pytest.mark.parametrize("chunk_cap", [None, 64])
def test_chunked_with_gc_matches_jax(n_chunks, chunk_cap):
    """Chunk boundaries fall inside a bin (checked), so the stitched bins
    add two chunks' parts; chunk_cap = 64 truncates every chunk's table
    and both rerun the chunks at a cap that fits."""
    k, w, bin_size = 21, 30, 97
    seqs, jseqs = _pair(_strings(w, seed=3, n_random=60))
    starts = _chunk_starts(np.asarray(seqs.lengths), n_chunks)
    if n_chunks > 1:
        assert any(s % bin_size for s in starts[1:])
    kw = dict(cap=1 << 13, bin_size=bin_size, n_chunks=n_chunks,
              chunk_cap=chunk_cap)
    got_t, got_gc = tbnp.count_minimizers_with_gc(seqs, k, w, device="cpu",
                                                  **kw)
    want_t, want_gc = jbnp.sequence.count_minimizers_with_gc(jseqs, k, w,
                                                             **kw)
    _assert_same_table(got_t, want_t)
    np.testing.assert_array_equal(got_gc, want_gc)
    assert got_gc.dtype == np.int32 == want_gc.dtype
    whole_t, whole_gc = tbnp.count_minimizers_with_gc(
        seqs, k, w, bin_size=bin_size, device="cpu")
    _assert_same_table(got_t, whole_t)
    np.testing.assert_array_equal(got_gc, whole_gc)


def test_chunked_acc_overflow_raises_like_jax():
    seqs, jseqs = _pair(_strings(30, seed=4))
    kw = dict(cap=64, bin_size=100, n_chunks=2)
    with pytest.raises(ValueError, match="raise cap"):
        jbnp.sequence.count_minimizers_with_gc(jseqs, 21, 30, **kw)
    with pytest.raises(ValueError, match="raise cap"):
        tbnp.count_minimizers_with_gc(seqs, 21, 30, device="cpu", **kw)


def _numpy_minimizers(strings, alphabet, k, w):
    """Per row, the least sum(code_i * len(alphabet)^i) over the k-mers of
    every window of w letters (the reference's Minimizers)."""
    rows = []
    for s in strings:
        codes = np.array([alphabet.index(c) for c in s], np.int64)
        n = len(codes) - k + 1
        h = sum(codes[j: j + n] * len(alphabet) ** j for j in range(k)) \
            if n > 0 else np.zeros(0, np.int64)
        rows.append([int(h[i: i + w - k + 1].min())
                     for i in range(max(len(codes) - w + 1, 0))])
    return rows


@pytest.mark.parametrize("k,w", [(3, 7), (2, 2)])
def test_five_letter_alphabet_host_path(k, w):
    """Minimizers rolls each window's k-mers on the host.  The JAX
    package's rollable takes 1-D input only, so its 5-letter path raises
    where the port's gives the reference's values; the 4-letter device
    path is held to the same recount."""
    strings = _strings(w, seed=5, alphabet="ACGTN")
    seqs, jseqs = _pair(strings, JACGTnEncoding, ACGTnEncoding)
    with pytest.raises(ValueError, match="window_shape"):
        jbnp.sequence.get_minimizers(jseqs, k, w)
    got = tbnp.get_minimizers(seqs, k, w, device="cpu")
    want = _numpy_minimizers(strings, "ACGTN", k, w)
    assert [list(map(int, row)) for row in got.raw().tolist()] == want
    assert str(got.encoding) == f"{k}merEncoding(AlphabetEncoding('ACGTN'))"
    rolled = tseqmin.Minimizers(w - k + 1, tbnp.sequence.KmerEncoder(
        k, ACGTnEncoding))
    assert rolled.window_size == w
    np.testing.assert_array_equal(rolled.rolling_window(seqs).ravel().raw(),
                                  got.ravel().raw())
    dna = [s.replace("N", "A") for s in strings]
    four = tbnp.get_minimizers(tbnp.as_encoded_array(dna, tbnp.DNAEncoding),
                               k, w, device="cpu")
    assert [list(map(int, row)) for row in four.raw().tolist()] == \
        _numpy_minimizers(dna, "ACGT", k, w)


def test_bad_arguments_raise():
    seqs, jseqs = _pair(["ACGTACGTAC"])
    with pytest.raises(AssertionError):
        jbnp.sequence.get_minimizers(jseqs, 9, 8)
    with pytest.raises(ValueError):
        tbnp.get_minimizers(seqs, 9, 8, device="cpu")
    with pytest.raises(TypeError):  # not an alphabet encoding
        tbnp.get_minimizers(["ACGT"], 2, 3, device="cpu")
    five = tbnp.as_encoded_array(["ACGTN"], ACGTnEncoding)
    for fn in (tbnp.count_minimizers, tbnp.count_minimizers_with_gc):
        with pytest.raises(TypeError):  # the device paths need 4 letters
            fn(five, 2, 3, device="cpu")


# ---- ops -------------------------------------------------------------------

def _packed(seed, window_size):
    """The same packed inputs for both packages: numpy (words, ends, n)
    and the torch (words, ends)."""
    strings = _strings(window_size, seed=seed)
    codes = np.concatenate([tbnp.DNAEncoding.encode(s).raw()
                            for s in strings]).astype(np.uint8)
    lengths = np.array([len(s) for s in strings])
    words, ends, n = tkmers.prepare_packed(codes, lengths)
    return (words, ends, n), (torch.from_numpy(words.view(np.int32)),
                              torch.from_numpy(ends))


def _jax_valid(ends, n_positions, window_size, n_true):
    """Valid window starts by numpy: inside their row, below n_true."""
    lengths = np.diff(np.concatenate([[0], ends]))
    valid = np.zeros(n_positions, bool)
    start = 0
    for e, length in zip(ends, lengths):
        valid[start: start + max(length - window_size + 1, 0)] = True
        start = e
    valid[min(int(ends[-1]), n_true):] = False
    return valid


@pytest.mark.parametrize("k,w", CASES)
def test_minimizer_keys_equal_jax_at_valid_windows(k, w):
    (words, ends, n), (tw, te) = _packed(10, w)
    got = tmin.minimizer_keys_packed(tw, te, k, w - k + 1, n).numpy()
    pairs = np.asarray(jmin.minimizer_pairs_packed(words, k, w - k + 1))
    want = np.ascontiguousarray(pairs).reshape(-1).view(np.int64)[: len(got)]
    valid = tmin.window_valid(te, len(got), w, n).numpy()
    np.testing.assert_array_equal(valid, _jax_valid(ends, len(got), w, n))
    np.testing.assert_array_equal(got[valid], want[valid])
    assert valid.sum() > 100 and got.dtype == np.int64
    # beyond its row the port's min skips the k-mers that leave the row
    # (their keys are the sentinel), so it is never below JAX's
    assert np.all(got[~valid] >= want[~valid])
    assert np.any(got[~valid] == SENTINEL)


@pytest.mark.parametrize("k,w,cap", [(21, 30, 1 << 14), (5, 12, 32)])
def test_minimizer_table_and_groups_equal_jax(k, w, cap):
    (words, ends, n), (tw, te) = _packed(11, w)
    uniq, run_starts, meta = tmin.minimizer_table_packed(tw, te, n, k,
                                                         w - k + 1, cap)
    j_table, j_meta = jmin.minimizer_table_packed(words, ends, n, k,
                                                  w - k + 1, cap)
    j_table, j_meta = np.asarray(j_table), np.asarray(j_meta)
    np.testing.assert_array_equal(meta.numpy(), j_meta)
    rows = min(int(meta[0]), cap)
    j_keys = j_table[0].astype(np.int64) | (j_table[1].astype(np.int64) << 32)
    np.testing.assert_array_equal(uniq[:rows].numpy(), j_keys[:rows])
    np.testing.assert_array_equal(run_starts[:rows].numpy(),
                                  j_table[2, :rows])
    if cap == 32:
        assert int(meta[0]) > cap  # truncated, as in JAX
        return
    phase = 41
    keys, cnt, meta_g, gc = tmin.minimizer_sentinel_gc_group(
        tw, te, n, k, w - k + 1, cap, 100, phase)
    lo, hi, j_cnt, j_meta_g, j_gc = (np.asarray(a) for a in
                                     jmin.minimizer_sentinel_gc_group(
                                         words, ends, n, k, w - k + 1, cap,
                                         100, phase))
    live = np.arange(cap) < int(meta_g[0])
    j_sent = lo.astype(np.int64) | (hi.astype(np.int64) << 32)
    np.testing.assert_array_equal(keys.numpy()[live], j_sent[live])
    assert np.all(keys.numpy()[~live] == SENTINEL)
    assert np.all(j_sent[~live] == -1)  # JAX's: all-ones limbs
    np.testing.assert_array_equal(cnt.numpy(), j_cnt)
    np.testing.assert_array_equal(meta_g.numpy(), j_meta_g)
    np.testing.assert_array_equal(gc.numpy(), j_gc)
    u2, c2, meta2, gc2 = tmin.minimizer_gc_job_packed(tw, te, n, k,
                                                      w - k + 1, cap, 100)
    np.testing.assert_array_equal(gc2.numpy(), np.asarray(
        jtracks.gc_binned_from_packed(words, n, 100)))
    # the whole table: its n_unique rows, where the JAX package's has cap
    np.testing.assert_array_equal(c2.numpy(), j_cnt[live])
    np.testing.assert_array_equal(u2.numpy(), j_sent[live])
    np.testing.assert_array_equal(meta2.numpy(), j_meta)


def _codes_input(seed, window_size):
    """Padded codes and distances for the codes-input functions: a
    multiple of 16 codes plus 32 of padding."""
    strings = _strings(window_size, seed=seed)
    codes = np.concatenate([tbnp.DNAEncoding.encode(s).raw()
                            for s in strings]).astype(np.uint8)
    lengths = np.array([len(s) for s in strings])
    n = len(codes)
    size = -(-n // 16) * 16 + 32
    padded = np.zeros(size, np.uint8)
    padded[:n] = codes
    dist = np.zeros(size, np.int32)
    ends = np.cumsum(lengths)
    dist[:n] = np.repeat(ends, lengths) - np.arange(n)
    return padded, dist


@pytest.mark.parametrize("k", [1, 5, 16, 17, 31])
def test_kmer_hash_limbs_equal_jax(k):
    padded, _ = _codes_input(12, k)
    lo, hi = tkmers.kmer_hash_limbs(torch.from_numpy(padded), k)
    j_lo, j_hi = (np.asarray(a) for a in jkmers.kmer_hash_limbs(padded, k))
    np.testing.assert_array_equal(lo.numpy(), j_lo.astype(np.int64))
    np.testing.assert_array_equal(hi.numpy(), j_hi.astype(np.int64))
    assert lo.numel() == len(padded) - 32


@pytest.mark.parametrize("k,w", CASES)
def test_minimizer_limbs_equal_jax(k, w):
    padded, dist = _codes_input(13, w)
    lo, hi, valid = tmin.minimizer_limbs(torch.from_numpy(padded),
                                         torch.from_numpy(dist), k,
                                         w - k + 1)
    j_lo, j_hi, j_valid = (np.asarray(a) for a in jmin.minimizer_limbs(
        padded, dist, k, w - k + 1))
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    v = j_valid
    assert v.sum() > 100
    np.testing.assert_array_equal(lo.numpy()[v], j_lo[v].astype(np.int64))
    np.testing.assert_array_equal(hi.numpy()[v], j_hi[v].astype(np.int64))
