"""The port's encoded-array data model (its copies of encoded_array.py,
ragged/, encodings/, sequence/count_encoded.py) against the JAX package's
on the CPU: the same inputs through both, equal codes, shapes, reprs and
errors."""
import numpy as np
import pytest

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu import encoded_array as jea
from bionumpy_tpu.encodings import EncodingError as JEncodingError
from bionumpy_tpu.encodings.kmer_encodings import KmerEncoding as JKmer
from bionumpy_tpu.ragged import RaggedArray as JRagged
from bionumpy_tpu_torch import encoded_array as tea
from bionumpy_tpu_torch.encodings import EncodingError
from bionumpy_tpu_torch.encodings.kmer_encodings import KmerEncoding
from bionumpy_tpu_torch.ops import resident
from bionumpy_tpu_torch.ragged import RaggedArray

ROWS = ["ACGTTGCA", "", "acgt", "GATTACA", "T", "CCCCGGGGAAAATTTT"]


def _same(got, want):
    """Same class name, codes, row lengths, encoding and repr."""
    assert type(got).__name__ == type(want).__name__
    if hasattr(want, "lengths"):
        np.testing.assert_array_equal(got.lengths, want.lengths)
    g, w = got.raw(), want.raw()
    if hasattr(w, "ravel"):
        g, w = g.ravel(), w.ravel()
    np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    if hasattr(want, "encoding"):
        assert str(got.encoding) == str(want.encoding)
    assert repr(got) == repr(want)


def _both(data, dna=True):
    return (tbnp.as_encoded_array(data, tbnp.DNAEncoding if dna else None),
            jbnp.as_encoded_array(data, jbnp.DNAEncoding if dna else None))


@pytest.mark.parametrize("data", [ROWS, ROWS[0], ROWS[:1], [], ROWS[3]])
@pytest.mark.parametrize("dna", [True, False])
def test_as_encoded_array_matches_jax(data, dna):
    got, want = _both(data, dna)
    _same(got, want)
    assert tea.from_encoded_array(got) == jea.from_encoded_array(want)


@pytest.mark.parametrize("data", [ROWS, ROWS[3]])
def test_change_encoding_matches_jax(data):
    base, jbase = _both(data, dna=False)
    dna = tea.change_encoding(base, tbnp.DNAEncoding)
    jdna = jea.change_encoding(jbase, jbnp.DNAEncoding)
    _same(dna, jdna)
    _same(tea.change_encoding(dna, tea.BaseEncoding),
          jea.change_encoding(jdna, jea.BaseEncoding))


INDICES = [0, -1, 3, slice(1, 4), slice(None, None, 2), [0, 3, 5],
           np.array([True, False, True, False, True, False]),
           (slice(None), slice(1, 3)), (Ellipsis, slice(None, -1)),
           (slice(None), slice(-2, None)), (slice(0, 3), slice(1, None)),
           ([0, 3], 1)]


@pytest.mark.parametrize("idx", INDICES, ids=[str(i) for i in range(
    len(INDICES))])
def test_indexing_matches_jax(idx):
    got, want = _both(ROWS)
    _same(got[idx], want[idx])


@pytest.mark.parametrize("idx", [0, 2, slice(1, 5), -1])
def test_flat_indexing_matches_jax(idx):
    got, want = _both(ROWS[5])
    _same(got[idx], want[idx])


def test_ravel_lengths_and_comparisons_match_jax():
    got, want = _both(ROWS)
    _same(got.ravel(), want.ravel())
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal((got == "G").ravel(),
                                  (want == "G").ravel())
    np.testing.assert_array_equal((got == "G").sum(axis=-1),
                                  (want == "G").sum(axis=-1))
    assert got.tolist() == want.tolist()
    assert [r.to_string() for r in got] == [r.to_string() for r in want]


@pytest.mark.parametrize("idx,value", [
    (0, "TTTTAAAA"), ((slice(None), 0), "G"), ((3, slice(1, 3)), "CC")])
def test_setitem_matches_jax_and_drops_the_device_copy(idx, value):
    got, want = _both(ROWS)
    resident.device_seqs(got, "cpu")
    assert getattr(got, "_device_seqs_cache", None)
    got[idx] = value
    want[idx] = value
    _same(got, want)
    assert getattr(got, "_device_seqs_cache", None) is None


def test_flat_setitem_matches_jax():
    got, want = _both(ROWS[5])
    resident.device_seqs(got, "cpu")
    got[2:5] = "AAA"
    want[2:5] = "AAA"
    _same(got, want)
    assert getattr(got, "_device_seqs_cache", None) is None


def test_encoding_error_matches_jax():
    with pytest.raises(JEncodingError) as jerr:
        jbnp.as_encoded_array(["ACGT", "ACXT"], jbnp.DNAEncoding)
    with pytest.raises(EncodingError) as err:
        tbnp.as_encoded_array(["ACGT", "ACXT"], tbnp.DNAEncoding)
    assert err.value.offset == jerr.value.offset == 6


@pytest.mark.parametrize("k", [1, 3, 8, 13, 31])
def test_kmer_encoding_round_trips_match_jax(k):
    enc, jenc = KmerEncoding(tbnp.DNAEncoding, k), \
        JKmer(jbnp.DNAEncoding, k)
    rng = np.random.default_rng(k)
    kmers = ["".join(rng.choice(list("ACGT"), k)) for _ in range(5)]
    for kmer in kmers:
        code = int(enc.encode(kmer).raw())
        assert code == int(jenc.encode(kmer).raw())
        assert enc.to_string(code) == jenc.to_string(code) == kmer
    np.testing.assert_array_equal(enc.encode(kmers).raw(),
                                  jenc.encode(kmers).raw())
    assert str(enc) == str(jenc) and repr(enc) == repr(jenc)
    if k <= 3:
        assert enc.get_labels() == jenc.get_labels()


@pytest.mark.parametrize("axis", [-1, None])
def test_count_encoded_labels_match_jax(axis):
    got, want = _both(ROWS)
    g = tbnp.count_encoded(got, axis=axis)
    w = jbnp.count_encoded(want, axis=axis)
    assert g.alphabet == w.alphabet == list("ACGT")
    np.testing.assert_array_equal(g.counts, w.counts)
    assert repr(g) == repr(w)
    np.testing.assert_array_equal(g.proportions, w.proportions)
    if axis is None:
        assert g.most_common(2).alphabet == w.most_common(2).alphabet
    assert int(g["G"].sum()) == int(w["G"].sum())


def test_kmer_labels_and_proportion_matrix():
    kmers = tbnp.get_kmers(tbnp.as_encoded_array(ROWS, tbnp.DNAEncoding), 2,
                           device="cpu")
    jkmers = jbnp.get_kmers(jbnp.as_encoded_array(ROWS, jbnp.DNAEncoding), 2)
    g = tbnp.count_encoded(kmers, axis=None)
    w = jbnp.count_encoded(jkmers, axis=None)
    assert g.alphabet == w.alphabet and len(g.alphabet) == 16
    np.testing.assert_array_equal(g.counts, w.counts)
    assert g.as_dict().keys() == w.as_dict().keys()
    got, want = g.proportion_matrix, w.proportion_matrix
    assert type(got).__name__ == type(want).__name__ == "Matrix"
    np.testing.assert_array_equal(got.data, want.data)
    assert got.col_names == want.col_names and got.row_names is None


def test_ragged_array_matches_jax():
    rows = [[1, 2, 3], [], [4, 5]]
    got, want = RaggedArray(rows), JRagged(rows)
    for op in (lambda r: r * 2, lambda r: r + 1, lambda r: r[1:],
               lambda r: r[:, :-1]):
        g, w = op(got), op(want)
        assert g.tolist() == w.tolist()
    np.testing.assert_array_equal(got.sum(axis=-1), want.sum(axis=-1))
    np.testing.assert_array_equal(np.concatenate([got, got]).lengths,
                                  np.concatenate([want, want]).lengths)


def test_encoded_lookup_matches_jax():
    lookup = np.arange(4) * 10
    got = tea.EncodedLookup(lookup.copy(), tbnp.DNAEncoding)
    want = jea.EncodedLookup(lookup.copy(), jbnp.DNAEncoding)
    np.testing.assert_array_equal(got["GATT"], want["GATT"])
    got["C"] = 7
    want["C"] = 7
    np.testing.assert_array_equal(got["ACGT"], want["ACGT"])
