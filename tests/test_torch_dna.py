"""The port's reverse complement and interval sequence extraction
(sequence/dna.py, sequence/lookup.py) against the JAX package's, on the
CPU: the same seeded sequences through both, codes array-equal with their
dtypes; and a reverse-complemented array through count_kmers equals the
forward table with every hash mapped to its reverse complement."""
import numpy as np
import pytest

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu.sequence import dna as jdna
from bionumpy_tpu.sequence import lookup as jlookup
from bionumpy_tpu_torch.ops import resident
from bionumpy_tpu_torch.sequence import dna as tdna
from bionumpy_tpu_torch.sequence import lookup as tlookup

SEEDS = [0, 1, 2]
PACKAGES = ((tbnp, tdna), (jbnp, jdna))


def _reads(seed, n=40, letters="ACGT", max_len=60):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(letters), rng.integers(0, max_len)))
            for _ in range(n)]


def codes(arr):
    """(flat codes, lengths or None, encoding repr) of an encoded array."""
    if hasattr(arr, "lengths"):
        return (np.asarray(arr.ravel().raw()), np.asarray(arr.lengths),
                repr(arr.encoding))
    return np.asarray(arr.raw()), None, repr(arr.encoding)


def assert_same(got, want):
    for a, b in zip(codes(got), codes(want)):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        else:
            assert a == b
    assert type(got).__name__ == type(want).__name__


def _both(fn):
    return fn(*PACKAGES[0]), fn(*PACKAGES[1])


def revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGTNacgtn", "TGCANtgcan"))


@pytest.mark.parametrize("seed", SEEDS)
def test_reverse_complement_ragged_dna(seed):
    reads = _reads(seed)
    got, want = _both(lambda bnp, dna: bnp.get_reverse_complement(
        bnp.as_encoded_array(reads, bnp.DNAEncoding)))
    assert_same(got, want)
    assert got.tolist() == [revcomp(r) for r in reads]


@pytest.mark.parametrize("seed", SEEDS)
def test_reverse_complement_base_encoding(seed):
    reads = _reads(seed, letters="ACGTNacgtn")
    got, want = _both(lambda bnp, dna: dna.get_reverse_complement(reads))
    assert_same(got, want)
    assert got.tolist() == [revcomp(r) for r in reads]
    got, want = _both(lambda bnp, dna: dna.complement(
        bnp.as_encoded_array(reads)))
    assert_same(got, want)


def test_reverse_complement_flat_and_str():
    seq = _reads(5, n=1, max_len=200)[0]
    got, want = _both(lambda bnp, dna: dna.get_reverse_complement(
        bnp.as_encoded_array(seq, bnp.DNAEncoding)))
    assert_same(got, want)
    assert got.to_string() == revcomp(seq)
    got, want = _both(lambda bnp, dna: dna.get_reverse_complement(seq))
    assert_same(got, want)
    got, want = _both(lambda bnp, dna: dna.complement(
        bnp.as_encoded_array(seq, bnp.DNAEncoding)))
    assert_same(got, want)


def test_reverse_complement_of_records_and_streams():
    reads = _reads(7, n=12)

    def records(bnp, dna):
        entry = bnp.SequenceEntry([f"r{i}" for i in range(len(reads))],
                                  bnp.as_encoded_array(reads, bnp.DNAEncoding))
        return dna.get_reverse_complement(entry)
    got, want = _both(records)
    assert got.name.tolist() == want.name.tolist()
    assert_same(got.sequence, want.sequence)

    def streamed(bnp, dna):
        chunks = [bnp.as_encoded_array(reads[:5], bnp.DNAEncoding),
                  bnp.as_encoded_array(reads[5:], bnp.DNAEncoding)]
        return list(dna.get_reverse_complement(
            bnp.streams.BnpStream(iter(chunks))))
    got, want = _both(streamed)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert_same(a, b)


def test_complement_rejects_other_encodings():
    """An alphabet without complements fails on its first letter, any
    other encoding with ValueError, in both packages alike."""
    for bnp, dna in PACKAGES:
        with pytest.raises(KeyError, match="D"):
            dna.complement(bnp.as_encoded_array(
                "MKV", bnp.encodings.AminoAcidEncoding))
        names = bnp.encodings.string_encodings.StringEncoding(["a", "b"])
        with pytest.raises(ValueError, match="Invalid encoding"):
            dna.complement(names.encode(["b", "a"]))


@pytest.mark.parametrize("seed", SEEDS)
def test_strand_specific_and_plain_sequences(seed):
    rng = np.random.default_rng(seed)
    genome = _reads(seed, n=1, max_len=2)[0] + "".join(
        rng.choice(list("ACGT"), 500))
    starts = rng.integers(0, 450, 30)
    stops = starts + rng.integers(0, 50, 30)
    strand = np.where(rng.random(30) < 0.5, "+", "-").tolist()

    def run(bnp, dna):
        seq = bnp.as_encoded_array(genome, bnp.DNAEncoding)
        iv = bnp.datatypes.Bed6(["g"] * 30, starts, stops, ["x"] * 30,
                                np.zeros(30, int), strand)
        return (dna.get_strand_specific_sequences(seq, iv),
                dna.get_sequences(seq, iv))
    got, want = _both(run)
    for a, b in zip(got, want):
        assert_same(a, b)
    for i in range(30):
        piece = genome[starts[i]:stops[i]]
        assert got[0][i].to_string() == (piece if strand[i] == "+"
                                         else revcomp(piece))
        assert got[1][i].to_string() == piece


def test_lookup_get_and_set():
    def run(bnp, lookup):
        table = lookup.Lookup(np.arange(16).reshape(4, 4), bnp.DNAEncoding)
        out = [table["A", "C"], table["G"], table[:, "T"],
               table[bnp.as_encoded_array(["AC", "G"], bnp.DNAEncoding)]]
        table["T", "T"] = 99
        out.append(table[..., "T"])
        return out
    got, want = run(tbnp, tlookup), run(jbnp, jlookup)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(got[0], 1)
    np.testing.assert_array_equal(np.ravel(got[2]), [3, 7, 11, 15])
    assert np.ravel(got[4])[3] == 99
    got, want = _both(lambda bnp, dna: dna._get_complement_lookup(
        bnp.DNAEncoding)[bnp.as_encoded_array("ACGT", bnp.DNAEncoding)])
    assert_same(got, want)


def _kmer_revcomp(hashes: np.ndarray, k: int) -> np.ndarray:
    """The hash (sum code_j << 2j) of each k-mer's reverse complement."""
    out = np.zeros_like(hashes)
    for j in range(k):
        code = (hashes >> np.uint64(2 * j)) & np.uint64(3)
        out |= (np.uint64(3) - code) << np.uint64(2 * (k - 1 - j))
    return out


@pytest.mark.parametrize("k", [5, 12, 31])
def test_reverse_complement_into_count_kmers(k):
    """count_kmers of the reverse complement equals the forward table
    with each hash mapped to its reverse complement; the reversed array
    is new, so it uploads once of its own."""
    reads = _reads(11, n=200, max_len=120)
    seqs = tbnp.as_encoded_array(reads, tbnp.DNAEncoding)
    forward = tbnp.count_kmers(seqs, k, device="cpu")
    resident.reset_transfer_counters()
    rc = tbnp.get_reverse_complement(seqs)
    back = tbnp.count_kmers(rc, k, device="cpu")
    assert resident.TRANSFER_COUNT == 1
    jback = jbnp.count_kmers(jbnp.get_reverse_complement(
        jbnp.as_encoded_array(reads, jbnp.DNAEncoding)), k)
    np.testing.assert_array_equal(back.counts, np.asarray(jback.counts))
    if k <= 12:
        # dense tables: index h of the reversed count is rc(h)'s forward
        hashes = np.arange(4 ** k, dtype=np.uint64)
        np.testing.assert_array_equal(
            back.counts[_kmer_revcomp(hashes, k).astype(np.int64)],
            forward.counts)
    else:
        np.testing.assert_array_equal(back.label_codes,
                                      np.asarray(jback.label_codes))
        mapped = _kmer_revcomp(np.asarray(forward.label_codes, np.uint64), k)
        order = np.argsort(mapped)
        np.testing.assert_array_equal(back.label_codes, mapped[order])
        np.testing.assert_array_equal(back.counts, forward.counts[order])
