"""Parity of the port's sequence ops (bionumpy_tpu_torch/ops/seq.py),
translation (sequence/translate.py) and bench config 1's job (gzip FASTQ
-> per-base composition) with the JAX package's on seeded inputs.  The
port runs on the CPU.  Counts and codes are integers, so equality is
exact; the port's counts are int64 where JAX's are int32."""
import gzip
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bionumpy_tpu as jbnp
import bionumpy_tpu_torch as tbnp
from bionumpy_tpu import pipeline as jpipe
from bionumpy_tpu.ops import seq as jseq
from bionumpy_tpu_torch import pipeline as tpipe
from bionumpy_tpu_torch.ops import seq as tseq


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_symbols", [4, 5])
def test_composition_counts(n_symbols):
    """Codes at and above n_symbols among the valid positions too (JAX's
    scatter drops them, the port's dump bin takes them)."""
    rng = np.random.default_rng(n_symbols)
    codes = rng.integers(0, 7, 3001).astype(np.uint8)
    valid = rng.random(3001) < 0.7
    want = jseq.composition_counts(jnp.asarray(codes), jnp.asarray(valid),
                                   n_symbols)
    got = tseq.composition_counts(_t(codes), _t(valid), n_symbols)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int64


@pytest.mark.parametrize("n_words,n_true", [
    (3, 0), (3, 1), (3, 16), (10, 17), (10, 127), (10, 128), (1026, 16383),
    (1026, 9999)])
def test_composition_from_packed(n_words, n_true):
    """Random words: every bit past n_true is set about half the time,
    so a count that read past n_true would differ."""
    rng = np.random.default_rng(n_words + n_true)
    words = rng.integers(0, 1 << 32, n_words, dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jseq.composition_from_packed(jnp.asarray(words),
                                                   n_true))
    port_words = _t(words.view(np.int32))
    got = tseq.composition_from_packed(port_words, n_true)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == n_true and got.dtype == torch.int64
    # and a numpy unpack of the codes below n_true
    codes = ((words[:-2, None] >> (2 * np.arange(16, dtype=np.uint32)))
             & 3).ravel()[:n_true]
    np.testing.assert_array_equal(want, np.bincount(codes, minlength=4))


def test_lut_gather_and_encode_with_validation():
    from bionumpy_tpu_torch.encodings import DNAEncoding
    rng = np.random.default_rng(1)
    table = DNAEncoding.lookup_table.astype(np.uint8)
    table = np.where(table > 3, 255, table).astype(np.uint8)
    good = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, 5000)]
    for bytes_ in (good, np.concatenate([good[:1234], [ord("N")], good,
                                         [ord("x")]]).astype(np.uint8)):
        np.testing.assert_array_equal(
            tseq.lut_gather(_t(table), _t(bytes_)).numpy(),
            np.asarray(jseq.lut_gather(jnp.asarray(table),
                                       jnp.asarray(bytes_))))
        jcodes, jfirst = jseq.encode_with_validation(jnp.asarray(table),
                                                     jnp.asarray(bytes_))
        codes, first = tseq.encode_with_validation(_t(table), _t(bytes_))
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        assert int(first) == int(jfirst) == (-1 if len(bytes_) == 5000
                                              else 1234)


def test_translate_codons():
    from bionumpy_tpu_torch.sequence.translate import DNAToProtein
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, 3 * 4001).astype(np.uint8)
    table = DNAToProtein.lookup_table.copy()
    want = jseq.translate_codons(jnp.asarray(codes), jnp.asarray(table))
    got = tseq.translate_codons(_t(codes), _t(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _dna_rows(seed, n_codes, n_rows):
    """Seeded ACGT rows whose lengths are multiples of 3 and sum to about
    n_codes, some of them empty."""
    rng = np.random.default_rng(seed)
    lengths = 3 * rng.integers(0, 2 * n_codes // (3 * n_rows) + 1, n_rows)
    lengths[::5] = 0
    alpha = np.array(list("ACGT"))
    flat = "".join(alpha[rng.integers(0, 4, int(lengths.sum()))])
    ends = np.cumsum(lengths)
    return [flat[e - n: e] for e, n in zip(ends, lengths)]


@pytest.mark.parametrize("n_codes", [3000, 3 * (1 << 14)])
def test_translate_dna_to_protein_ragged(n_codes):
    """Below and above 2^15 codes, where JAX and the port route the
    flat codes to their device op."""
    rows = _dna_rows(n_codes, n_codes, 40)
    total = sum(map(len, rows))
    assert (total >= 1 << 15) == (n_codes > 1 << 15)
    want = jbnp.translate_dna_to_protein(jbnp.as_encoded_array(rows))
    got = tbnp.translate_dna_to_protein(tbnp.as_encoded_array(rows),
                                        device="cpu")
    assert got.tolist() == want.tolist()
    np.testing.assert_array_equal(got.lengths, want.lengths)


@pytest.mark.parametrize("n_codes", [300, 3 * (1 << 14)])
def test_translate_dna_to_protein_flat(n_codes):
    row = "".join(_dna_rows(n_codes, n_codes, 1)) or "ATG"
    row = row[: len(row) // 3 * 3]
    want = jbnp.translate_dna_to_protein(jbnp.as_encoded_array(row))
    got = tbnp.translate_dna_to_protein(tbnp.as_encoded_array(row),
                                        device="cpu")
    assert isinstance(got, tbnp.EncodedArray)
    assert got.to_string() == want.to_string()


def test_translate_dna_to_protein_on_records():
    """A SequenceEntry batch: the sequence field is translated, the name
    kept (compared field by field, never across the packages' classes)."""
    rows = _dna_rows(5, 600, 12)
    names = [f"read{i}" for i in range(len(rows))]
    want = jbnp.translate_dna_to_protein(
        jbnp.SequenceEntry.from_entry_tuples(list(zip(names, rows))))
    got = tbnp.translate_dna_to_protein(
        tbnp.SequenceEntry.from_entry_tuples(list(zip(names, rows))),
        device="cpu")
    assert isinstance(got, tbnp.SequenceEntry)
    assert got.name.tolist() == want.name.tolist() == names
    assert got.sequence.tolist() == want.sequence.tolist()


def test_translate_needs_whole_codons():
    with pytest.raises(ValueError, match="multiple of 3"):
        tbnp.translate_dna_to_protein(tbnp.as_encoded_array(["ATGA"]),
                                      device="cpu")


def test_translate_large_input_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rows = _dna_rows(7, 3 * (1 << 14), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbnp.translate_dna_to_protein(tbnp.as_encoded_array(rows))


def _fastq_member(seed, n_reads=300):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 160, n_reads)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    seq = alpha[rng.integers(0, 4, int(lengths.sum()))].tobytes()
    ends = np.cumsum(lengths)
    raw = b"".join(b"@s%d.%d\n%s\n+\n%s\n" % (seed, i, seq[e - n: e],
                                             b"I" * n)
                   for i, (e, n) in enumerate(zip(ends, lengths)))
    return raw, np.bincount(np.frombuffer(seq, np.uint8), minlength=256)


def _composition_job(pipe, seq_mod, to_device, path):
    """Bench config 1's job (bench.py config1): entry-aligned batches,
    parsed and packed on the host, composition counted per batch and
    accumulated."""
    totals = np.zeros(4, np.int64)
    n_bases = n_reads = 0
    pool = ThreadPoolExecutor(2)
    try:
        for raw in pipe._prefetched(pipe._batch_arrays(path, 1 << 15, pool,
                                                       fused_parse=True)):
            words, ends, nb, nr = pipe._parse_batch(raw)
            totals += np.asarray(seq_mod.composition_from_packed(
                to_device(words), nb)).astype(np.int64)
            n_bases += nb
            n_reads += nr
    finally:
        pool.shutdown(wait=False)
    return totals, n_bases, n_reads


def test_config1_composition_job(tmp_path):
    """A multi-member gzip FASTQ of several batches: the port's
    _batch_arrays / _parse_batch / composition_from_packed against the
    JAX package's, and both against a bincount of the bases."""
    members, expected = [], np.zeros(256, np.int64)
    for s in range(6):
        raw, counts = _fastq_member(s)
        members.append(gzip.compress(raw, compresslevel=6, mtime=0))
        expected += counts
    path = tmp_path / "job.fq.gz"
    path.write_bytes(b"".join(members * 2))
    expected = 2 * expected[np.frombuffer(b"ACGT", np.uint8)]
    got = _composition_job(tpipe, tseq,
                           lambda w: _t(w.view(np.int32)), str(path))
    want = _composition_job(jpipe, jseq, jnp.asarray, str(path))
    assert got[1:] == want[1:] and got[2] == 3600
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], expected)
