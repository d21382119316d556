"""Parity of the port's checksum and dense-count k-mer ops
(bionumpy_tpu_torch/ops/kmers.py: prepare_codes, kmer_hashes_masked,
kmer_count_small, unique_kmer_stats, hash_checksum, kmer_checksum_packed,
kmer_checksum_pipeline_packed, kmer_checksum_pipeline) with the JAX
package's on seeded inputs.  The port runs on the CPU (its kernels
through their plain versions); every result is an integer, so equality
is exact.  JAX returns uint32 limbs and sums and int32 counts, the port
int64: the values are compared as integers."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bionumpy_tpu.ops import kmers as jk
from bionumpy_tpu_torch.ops import kmers as tk

KS = [1, 5, 12, 16, 17, 31]


def _reads(seed, n_rows=120, max_len=90):
    """Seeded flat codes and row lengths under 2^14 bases, with rows of
    length 0 and rows shorter than every k above 1."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len, n_rows)
    lengths[::11] = 0
    lengths[3::7] = rng.integers(1, 5, len(lengths[3::7]))
    flat = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    return flat, lengths


def _ints(values):
    return [int(v) for v in values]


@pytest.fixture(scope="module")
def batch():
    """Both packages' inputs: padded codes and distances (prepare_codes),
    and packed words with the row ends padded by repeating the last end
    (padding rows of length 0), as the pipeline pads them."""
    flat, lengths = _reads(0)
    codes, dist, n = jk.prepare_codes(flat, lengths)
    words, ends, _ = jk.prepare_packed(flat, lengths)
    ends = np.concatenate([ends, np.full(64, ends[-1], np.int32)])
    return dict(flat=flat, lengths=lengths, codes=codes, dist=dist, n=n,
                words=words, ends=ends)


def test_prepare_codes_matches(batch):
    codes, dist, n = tk.prepare_codes(batch["flat"], batch["lengths"])
    np.testing.assert_array_equal(codes, batch["codes"])
    np.testing.assert_array_equal(dist, batch["dist"])
    assert codes.dtype == np.uint8 and dist.dtype == np.int32
    assert n == batch["n"] < len(dist)


def _limbs(batch, k):
    jax_out = jk.kmer_hashes_masked(jnp.asarray(batch["codes"]),
                                    jnp.asarray(batch["dist"]), k)
    port_out = tk.kmer_hashes_masked(torch.from_numpy(batch["codes"]),
                                     torch.from_numpy(batch["dist"]), k)
    return jax_out, port_out


@pytest.mark.parametrize("k", KS)
def test_kmer_hashes_masked_every_position(batch, k):
    """The limbs at EVERY position, valid or not, and the validity."""
    (jlo, jhi, jvalid), (lo, hi, valid) = _limbs(batch, k)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < int(valid.sum()) <= batch["n"]


@pytest.mark.parametrize("k", [1, 5, 12])
def test_kmer_count_small(batch, k):
    want = jk.kmer_count_small(jnp.asarray(batch["codes"]),
                               jnp.asarray(batch["dist"]), k, 4 ** k)
    got = tk.kmer_count_small(torch.from_numpy(batch["codes"]),
                              torch.from_numpy(batch["dist"]), k, 4 ** k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int64


@pytest.mark.parametrize("k", KS)
def test_unique_kmer_stats(batch, k):
    (jlo, jhi, jvalid), (lo, hi, valid) = _limbs(batch, k)
    want = _ints(jk.unique_kmer_stats(jlo, jhi, jvalid))
    assert _ints(tk.unique_kmer_stats(lo, hi, valid)) == want
    # and a numpy recount of the distinct valid hashes
    keys = (lo.numpy() | (hi.numpy() << 32))[valid.numpy()]
    assert want == [len(np.unique(keys)), len(keys)]


@pytest.mark.parametrize("k", KS)
def test_hash_checksum(batch, k):
    (jlo, jhi, jvalid), (lo, hi, valid) = _limbs(batch, k)
    want = _ints(jk.hash_checksum(jlo, jhi, jvalid))
    assert _ints(tk.hash_checksum(lo, hi, valid)) == want


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 1025])
def test_hash_checksum_xor_fold_lengths(n):
    """The XOR fold pads to a power of two: every length, odd ones too,
    against numpy's XOR reduction."""
    rng = np.random.default_rng(n)
    lo = rng.integers(0, 1 << 32, n, dtype=np.int64)
    hi = rng.integers(0, 1 << 32, n, dtype=np.int64)
    valid = rng.random(n) < 0.8
    got = _ints(tk.hash_checksum(torch.from_numpy(lo), torch.from_numpy(hi),
                                 torch.from_numpy(valid)))
    m = np.uint64(0xFFFFFFFF)
    want = [int(np.sum(np.where(valid, x, 0).astype(np.uint64)) & m)
            for x in (lo, hi)]
    want += [int(np.bitwise_xor.reduce(np.where(valid, x, 0)))
             for x in (lo, hi)]
    assert got == want


def _packed(batch):
    return (torch.from_numpy(batch["words"].view(np.int32)),
            torch.from_numpy(batch["ends"]))


@pytest.mark.parametrize("k", KS)
def test_kmer_checksum_packed(batch, k):
    want = _ints(jk.kmer_checksum_packed(jnp.asarray(batch["words"]),
                                         jnp.asarray(batch["ends"]), k))
    assert _ints(tk.kmer_checksum_packed(*_packed(batch), k)) == want


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("cut", [0, 1, 77])
def test_kmer_checksum_pipeline_packed(batch, k, cut):
    """n_true at and below the last row end."""
    n_true = batch["n"] - cut
    want = _ints(jk.kmer_checksum_pipeline_packed(
        jnp.asarray(batch["words"]), jnp.asarray(batch["ends"]), k, n_true))
    assert _ints(tk.kmer_checksum_pipeline_packed(*_packed(batch), k,
                                                  n_true)) == want


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("cut", [0, 77])
def test_kmer_checksum_pipeline(batch, k, cut):
    n_true = batch["n"] - cut
    lengths = batch["lengths"].astype(np.int32)
    want = _ints(jk.kmer_checksum_pipeline(
        jnp.asarray(batch["codes"]), jnp.asarray(lengths), k, n_true))
    got = _ints(tk.kmer_checksum_pipeline(torch.from_numpy(batch["codes"]),
                                          torch.from_numpy(lengths), k,
                                          n_true))
    assert got == want


@pytest.mark.parametrize("k", [5, 31])
def test_checksums_agree_with_each_other(batch, k):
    """With n_true = the base count, the three checksums and the masked
    limb sums of hash_checksum give one answer."""
    packed = _ints(tk.kmer_checksum_packed(*_packed(batch), k))
    pipe = _ints(tk.kmer_checksum_pipeline_packed(*_packed(batch), k,
                                                  batch["n"]))
    lo, hi, valid = tk.kmer_hashes_masked(torch.from_numpy(batch["codes"]),
                                          torch.from_numpy(batch["dist"]), k)
    sums = _ints(tk.hash_checksum(lo, hi, valid))[:2]
    assert packed == pipe == [int(valid.sum())] + sums
