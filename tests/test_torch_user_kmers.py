"""The port's user-level k-mer API (get_kmers, count_kmers and the ops
under them) against the JAX package's, on the CPU: the same seeded
sequences through both, exact equality of hashes, labels and counts; the
host paths (axis, 5-letter alphabets), streams, the errors, and the
resident cache (one upload per array and device, dropped on mutation).
Every input holds under 2^14 bases, so both packages use one bucket."""
import numpy as np
import pytest
import torch

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu.encodings import ACGTnEncoding as JACGTnEncoding
from bionumpy_tpu.encodings.exceptions import EncodingError as JEncodingError
from bionumpy_tpu.ops import kmers as jkmers
from bionumpy_tpu.ops import resident as jresident
from bionumpy_tpu.streams import BnpStream as JStream
from bionumpy_tpu_torch.encodings import ACGTnEncoding
from bionumpy_tpu_torch.encodings.exceptions import EncodingError
from bionumpy_tpu_torch.ops import kmers as tkmers
from bionumpy_tpu_torch.ops import resident
from bionumpy_tpu_torch.streams import BnpStream

KS = [1, 5, 8, 9, 12, 13, 21, 31]


def _strings(k, seed=0, alphabet="ACGT"):
    """Rows of every length 0..k+3, then 30 random rows of up to 200
    letters, some upper and some lower case."""
    rng = np.random.default_rng(seed + k)
    lengths = list(range(k + 4)) + list(rng.integers(0, 200, 30))
    letters = np.array(list(alphabet + alphabet.lower()))
    return ["".join(rng.choice(letters[: len(alphabet)] if i % 3 else
                               letters, n)) for i, n in enumerate(lengths)]


def _pair(strings, jenc=None, tenc=None):
    jenc = jbnp.DNAEncoding if jenc is None else jenc
    tenc = tbnp.DNAEncoding if tenc is None else tenc
    return (tbnp.as_encoded_array(strings, tenc),
            jbnp.as_encoded_array(strings, jenc))


def _assert_same_kmers(got, want):
    assert type(got).__name__ == type(want).__name__
    assert str(got.encoding) == str(want.encoding)
    if hasattr(want, "lengths"):
        np.testing.assert_array_equal(got.lengths, want.lengths)
        got, want = got.ravel(), want.ravel()
    np.testing.assert_array_equal(got.raw(), want.raw())
    assert got.raw().dtype == want.raw().dtype


def _assert_same_counts(got, want):
    assert type(got).__name__ == type(want).__name__
    if type(want).__name__ == "SparseEncodedCounts":
        np.testing.assert_array_equal(got.label_codes, want.label_codes)
        assert str(got.encoding) == str(want.encoding)
    elif len(want.alphabet) <= 4 ** 9:
        assert list(got.alphabet) == want.alphabet
    else:  # 4^12 labels: the port keeps them as a range
        assert got.alphabet == range(len(want.alphabet))
        assert want.alphabet[:: 4 ** 8] == list(got.alphabet[:: 4 ** 8])
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.counts.dtype == np.int64 == np.asarray(want.counts).dtype


def test_dense_count_compares_and_adds_with_list_labels():
    """At k = 9 the port labels its dense counts with a range of label
    codes, the JAX package with the list of the same ints: the two must
    compare equal, add, and stack, the JAX package's own result included;
    other labels must not."""
    seqs, jseqs = _pair(_strings(9, seed=17))
    got = tbnp.count_kmers(seqs, 9, device="cpu")
    assert got.alphabet == range(4 ** 9)
    listed = tbnp.EncodedCounts(list(range(4 ** 9)), got.counts.copy())
    for other in (listed, jbnp.count_kmers(jseqs, 9)):
        assert got == other
        total = got + other
        np.testing.assert_array_equal(total.counts, 2 * got.counts)
        assert total.alphabet == range(4 ** 9)
        stacked = tbnp.EncodedCounts.vstack([got, other])
        assert stacked.counts.shape == (2, 4 ** 9)
    assert sum([got, listed]) == got + listed
    shifted = tbnp.EncodedCounts(list(range(1, 4 ** 9 + 1)), got.counts)
    assert not got == shifted
    with pytest.raises(AssertionError):
        got + shifted
    assert got == tbnp.EncodedCounts(range(4 ** 9), got.counts)


@pytest.mark.parametrize("k", KS)
def test_get_kmers_matches_jax(k):
    seqs, jseqs = _pair(_strings(k))
    got = tbnp.get_kmers(seqs, k, device="cpu")
    _assert_same_kmers(got, jbnp.get_kmers(jseqs, k))
    assert list(got.lengths[: k + 4]) == [0] * k + [1, 2, 3, 4]


@pytest.mark.parametrize("k", KS)
def test_count_kmers_matches_jax(k):
    seqs, jseqs = _pair(_strings(k))
    got = tbnp.count_kmers(seqs, k, device="cpu")
    _assert_same_counts(got, jbnp.count_kmers(jseqs, k))
    assert int(got.counts.sum()) == int(np.maximum(seqs.lengths - k + 1,
                                                   0).sum())


def test_flat_input_gives_flat_result():
    s = "ACGTTGCAACGGT" * 5
    seq, jseq = tbnp.as_encoded_array(s, tbnp.DNAEncoding), \
        jbnp.as_encoded_array(s, jbnp.DNAEncoding)
    got = tbnp.get_kmers(seq, 7, device="cpu")
    assert type(got).__name__ == "EncodedArray" and len(got) == len(s) - 6
    _assert_same_kmers(got, jbnp.get_kmers(jseq, 7))
    _assert_same_counts(tbnp.count_kmers(seq, 7, device="cpu"),
                        jbnp.count_kmers(jseq, 7))
    _assert_same_counts(tbnp.count_kmers(seq, 17, device="cpu"),
                        jbnp.count_kmers(jseq, 17))


@pytest.mark.parametrize("k", [3, 13])
def test_base_encoded_input_is_reencoded_like_jax(k):
    strings = _strings(k, seed=3)
    got = tbnp.get_kmers(tbnp.as_encoded_array(strings), k, device="cpu")
    _assert_same_kmers(got, jbnp.get_kmers(jbnp.as_encoded_array(strings),
                                           k))
    _assert_same_counts(tbnp.count_kmers(strings, k, device="cpu"),
                        jbnp.count_kmers(strings, k))


@pytest.mark.parametrize("where", ["get_kmers", "count_kmers"])
def test_non_acgt_letter_raises_like_jax(where):
    strings = ["ACGTACGT", "ACGNACGT"]
    with pytest.raises(JEncodingError):
        getattr(jbnp, where)(jbnp.as_encoded_array(strings), 3)
    with pytest.raises(EncodingError):
        getattr(tbnp, where)(tbnp.as_encoded_array(strings), 3, device="cpu")
    with pytest.raises(JEncodingError):
        jbnp.as_encoded_array(strings, jbnp.DNAEncoding)
    with pytest.raises(EncodingError):
        tbnp.as_encoded_array(strings, tbnp.DNAEncoding)


@pytest.mark.parametrize("k", [0, 32])
def test_k_outside_range_raises(k):
    seqs, jseqs = _pair(["ACGT"])
    with pytest.raises(AssertionError):
        jbnp.get_kmers(jseqs, k)
    with pytest.raises(ValueError):
        tbnp.get_kmers(seqs, k, device="cpu")


@pytest.mark.parametrize("k", [1, 4])
def test_axis_host_path_matches_jax(k):
    seqs, jseqs = _pair(_strings(k, seed=5))
    got = tbnp.count_kmers(seqs, k, axis=-1, device="cpu")
    _assert_same_counts(got, jbnp.count_kmers(jseqs, k, axis=-1))
    assert got.counts.shape == (len(seqs), 4 ** k)


@pytest.mark.parametrize("k", [1, 3, 9])
def test_five_letter_alphabet_host_path_matches_jax(k):
    strings = _strings(k, seed=9, alphabet="ACGTN")
    seqs, jseqs = _pair(strings, JACGTnEncoding, ACGTnEncoding)
    resident.reset_transfer_counters()
    _assert_same_kmers(tbnp.get_kmers(seqs, k, device="cpu"),
                       jbnp.get_kmers(jseqs, k))
    _assert_same_counts(tbnp.count_kmers(seqs, k, device="cpu"),
                        jbnp.count_kmers(jseqs, k))
    assert resident.TRANSFER_COUNT == 0  # no device work


@pytest.mark.parametrize("k", [5, 31])
def test_stream_of_chunks_folds_like_jax(k):
    chunks = [_strings(k, seed=s) for s in range(3)]
    got = tbnp.count_kmers(BnpStream(
        tbnp.as_encoded_array(c, tbnp.DNAEncoding) for c in chunks), k,
        device="cpu")
    want = jbnp.count_kmers(JStream(
        jbnp.as_encoded_array(c, jbnp.DNAEncoding) for c in chunks), k)
    _assert_same_counts(got, want)
    whole = tbnp.count_kmers(tbnp.as_encoded_array(
        sum(chunks, []), tbnp.DNAEncoding), k, device="cpu")
    np.testing.assert_array_equal(got.counts, whole.counts)


def test_chain_uploads_once_and_mutation_uploads_again():
    strings = _strings(20, seed=11)
    seqs, jseqs = _pair(strings)
    resident.reset_transfer_counters()
    jresident.reset_transfer_counters()
    for s, mod, ns in ((seqs, tbnp, {"device": "cpu"}), (jseqs, jbnp, {})):
        mod.count_kmers(s, 31, **ns)
        mod.get_kmers(s, 15, **ns)
        mod.count_kmers(s, 5, **ns)
    assert resident.TRANSFER_COUNT == jresident.TRANSFER_COUNT == 1
    assert resident.TRANSFER_BYTES > 0
    row = int(np.argmax(seqs.lengths))  # replace it with poly-A
    n = int(seqs.lengths[row])
    seqs[row] = "A" * n
    jseqs[row] = "A" * n
    got = tbnp.count_kmers(seqs, 31, device="cpu")
    want = jbnp.count_kmers(jseqs, 31)
    assert resident.TRANSFER_COUNT == jresident.TRANSFER_COUNT == 2
    _assert_same_counts(got, want)
    assert int(got["A" * 31]) >= n - 30
    fresh = tbnp.count_kmers(tbnp.as_encoded_array(
        seqs.tolist(), tbnp.DNAEncoding), 31, device="cpu")
    np.testing.assert_array_equal(got.counts, fresh.counts)


def test_cache_is_kept_per_device():
    seqs, _ = _pair(_strings(7, seed=13))
    resident.reset_transfer_counters()
    cpu = resident.device_seqs(seqs, "cpu")
    assert resident.device_seqs(seqs, "cpu") is cpu
    meta = resident.device_seqs(seqs, "meta")
    assert meta.words.device.type == "meta" and cpu.words.device.type == "cpu"
    assert resident.device_seqs(seqs, "cpu") is cpu
    assert resident.TRANSFER_COUNT == 2
    resident.invalidate(seqs)
    assert resident.device_seqs(seqs, "cpu") is not cpu


def _packed(seed, k):
    """The same packed inputs for both packages: a JAX array pair and a
    torch pair."""
    strings = _strings(k, seed=seed)
    flat = np.concatenate([np.frombuffer(s.upper().encode(), np.uint8)
                           for s in strings])
    codes = tbnp.DNAEncoding.lookup_table[flat]
    lengths = np.array([len(s) for s in strings])
    words, ends, n = tkmers.prepare_packed(codes, lengths)
    return (words, ends, n), (torch.from_numpy(words.view(np.int32)),
                              torch.from_numpy(ends))


@pytest.mark.parametrize("k", [1, 6, 12])
def test_kmer_count_small_packed_matches_jax(k):
    (words, ends, n), (tw, te) = _packed(21, k)
    got = tkmers.kmer_count_small_packed(tw, te, k, 4 ** k, n)
    want = jkmers.kmer_count_small_packed(words, ends, k, 4 ** k, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int64


@pytest.mark.parametrize("k,cap", [(13, 1 << 20), (31, 1 << 20), (31, 64)])
def test_sparse_count_tables_matches_jax(k, cap):
    """cap = 64 is below the distinct count: both rerun the compaction at a
    cap that fits."""
    (words, ends, n), (tw, te) = _packed(23, k)
    got = tkmers.sparse_count_tables(tw, te, k, n, cap)
    want = jkmers.sparse_count_tables(words, ends, k, n, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 64
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64


@pytest.mark.parametrize("k", [3, 31])
def test_window_hashes_are_get_kmers_values(k):
    (words, ends, n), (tw, te) = _packed(25, k)
    flat = tkmers.kmer_window_hashes(tw, te, k, n).numpy()
    pairs = np.asarray(jkmers.kmer_pairs_packed(words, k)).reshape(-1)
    all_hashes = np.ascontiguousarray(pairs).view(np.int64)[:n]
    lengths = np.diff(np.concatenate([[0], ends]))
    dist = np.repeat(ends, lengths) - np.arange(n)
    np.testing.assert_array_equal(flat, all_hashes[dist >= k])
