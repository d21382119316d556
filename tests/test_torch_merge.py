"""Parity of the port's device table merge and accumulator fold
(bionumpy_tpu_torch.parallel.sparse_parallel, pipeline._fold_program_impl)
with the JAX package, and the state carried between the two packages
(bionumpy_tpu_torch.convert).  Exact equality throughout."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bionumpy_tpu import pipeline as jpipe
from bionumpy_tpu.ops import kmers as jk
from bionumpy_tpu.parallel.sparse_parallel import merge_hash_tables as jmerge
from bionumpy_tpu_torch import convert
from bionumpy_tpu_torch import pipeline as tpipe
from bionumpy_tpu_torch.ops import kmers as tk
from bionumpy_tpu_torch.parallel.sparse_parallel import merge_hash_tables

U32 = 0xFFFFFFFF


def _random_tables(seed, n_tables=3, rows=400, n_keys=300):
    """(lo, hi, cnt) uint32/uint32/int32 rows: repeated keys across
    tables, sentinel-padded tails, hi halves up to 2^30 (k = 31)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 62, n_keys, dtype=np.int64)
    lo, hi, cnt = [], [], []
    for _ in range(n_tables):
        keys = np.unique(rng.choice(pool, rows // 2))
        pad = rows - len(keys)
        lo.append(np.concatenate([keys & U32, np.full(pad, U32)]))
        hi.append(np.concatenate([keys >> 32, np.full(pad, U32)]))
        cnt.append(np.concatenate([rng.integers(1, 50, len(keys)),
                                   np.zeros(pad, np.int64)]))
    cat = np.concatenate
    return (cat(lo).astype(np.uint32), cat(hi).astype(np.uint32),
            cat(cnt).astype(np.int32))


def _keys(lo, hi):
    return convert.table_from_jax((np.asarray(lo), np.asarray(hi),
                                   np.zeros(len(lo), np.int32)))[0].numpy()


@pytest.mark.parametrize("cap_out", [1 << 12, 500, 100])
def test_merge_hash_tables_matches_jax(cap_out):
    lo, hi, cnt = _random_tables(cap_out)
    m_lo, m_hi, m_cnt, n_u = jmerge(jnp.asarray(lo), jnp.asarray(hi),
                                    jnp.asarray(cnt), cap_out)
    keys, counts = convert.table_from_jax((lo, hi, cnt))
    t_keys, t_cnt, t_nu = merge_hash_tables(keys, counts, cap_out)
    assert int(t_nu) == int(n_u)
    np.testing.assert_array_equal(t_keys.numpy(), _keys(m_lo, m_hi))
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(m_cnt))


def test_merge_at_exactly_cap_out_keys_keeps_the_last_total():
    """With sentinel rows in the input and exactly cap_out distinct keys,
    the JAX merge cuts its last total (its run of sentinels counts
    against cap_out); the port's sort step leaves the sentinels out of
    the runs, so every total is whole.  The rest equals JAX's."""
    lo, hi, cnt = _random_tables(11)
    keys, counts = convert.table_from_jax((lo, hi, cnt))
    real = keys != tk.SENTINEL
    uniq, inverse = np.unique(keys[real].numpy(), return_inverse=True)
    totals = np.bincount(inverse, weights=counts[real].numpy())
    cap_out = len(uniq)
    assert (~real).any() and cap_out < len(keys)
    t_keys, t_cnt, t_nu = merge_hash_tables(keys, counts, cap_out)
    m_lo, m_hi, m_cnt, n_u = jmerge(jnp.asarray(lo), jnp.asarray(hi),
                                    jnp.asarray(cnt), cap_out)
    assert int(t_nu) == int(n_u) == cap_out
    np.testing.assert_array_equal(t_keys.numpy(), uniq)
    np.testing.assert_array_equal(t_keys.numpy(), _keys(m_lo, m_hi))
    np.testing.assert_array_equal(t_cnt.numpy(), totals.astype(np.int64))
    np.testing.assert_array_equal(t_cnt.numpy()[:-1], np.asarray(m_cnt)[:-1])
    assert t_cnt[-1] != int(np.asarray(m_cnt)[-1])


def _batches(seed, n_batches, k=31):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        lengths = rng.integers(0, 150, 120)
        flat = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
        # repeat a read set so tables overlap across batches
        flat[: len(flat) // 3] = 0
        words, ends, n = tk.prepare_packed(flat, lengths)
        out.append((words, ends, n))
    return out


def _jax_tables(batches, k, cap):
    return [jk.kmer_sentinel_table_packed(jnp.asarray(w), jnp.asarray(e),
                                          k, n, cap)[:3]
            for w, e, n in batches]


def _port_tables(batches, k, cap):
    return [tk.kmer_sentinel_table_packed(
        torch.from_numpy(w.view(np.int32)), torch.from_numpy(e), k, n,
        cap)[:2] for w, e, n in batches]


def _jax_fold(acc, tables, acc_cap):
    acc, n_u = jpipe._fold_program_impl(acc, tuple(tables), acc_cap)
    return acc, int(n_u)


def test_fold_matches_jax_and_carries_a_jax_accumulator():
    k, cap, acc_cap = 31, 1 << 14, 1 << 16
    batches = _batches(7, 6, k)
    jt = _jax_tables(batches, k, cap)
    tt = _port_tables(batches, k, cap)
    jacc = jnp.concatenate([jnp.full((2, acc_cap), jnp.uint32(U32)),
                            jnp.zeros((1, acc_cap), jnp.uint32)])

    # JAX folds the first half; its accumulator crosses to the port
    jacc_half, _ = _jax_fold(jacc, jt[:3], acc_cap)
    keys, counts = convert.table_from_jax(np.asarray(jacc_half))
    carried = (keys, counts, torch.zeros((), dtype=torch.int64))
    port_acc = tpipe._fold_program_impl(carried, tt[3:], acc_cap)

    # ... and equals JAX folding everything, and the port folding
    # everything itself
    jacc_all, n_u = _jax_fold(jacc_half, jt[3:], acc_cap)
    own = tpipe._make_acc(acc_cap, "cpu")
    own = tpipe._fold_program_impl(own, tt[:3], acc_cap)
    own = tpipe._fold_program_impl(own, tt[3:], acc_cap)
    expect = np.asarray(jacc_all)
    for acc in (port_acc, own):
        assert int(acc[2]) == n_u
        np.testing.assert_array_equal(convert.table_to_jax(acc[0], acc[1]),
                                      expect)


def test_table_round_trips():
    lo, hi, cnt = _random_tables(3)
    acc = np.stack([lo, hi, cnt.astype(np.uint32)])
    keys, counts = convert.table_from_jax(acc)
    assert int(keys.max()) == (1 << 63) - 1  # sentinel rows mapped
    np.testing.assert_array_equal(convert.table_to_jax(keys, counts), acc)
    again = convert.table_from_jax(convert.table_to_jax(keys, counts))
    assert torch.equal(again[0], keys) and torch.equal(again[1], counts)
    with pytest.raises(OverflowError):
        convert.table_to_jax(keys[:1], torch.tensor([1 << 32]))


def test_meta_from_jax():
    meta = np.array([77, 5, 2, 9, 1, U32, 3, 0], np.uint32)
    got = convert.meta_from_jax(meta).tolist()
    assert got == [77, 5 + (2 << 32), 9, 1, U32 + (3 << 32)]
    assert len(got) == len(tpipe.META_FIELDS)


def test_sparse_counts_and_kmer_encoding_match_jax():
    from bionumpy_tpu.encodings import DNAEncoding as JDNA
    from bionumpy_tpu.encodings.kmer_encodings import KmerEncoding as JKmer
    from bionumpy_tpu.sequence.count_encoded import \
        SparseEncodedCounts as JCounts
    from bionumpy_tpu_torch.encodings import DNAEncoding
    from bionumpy_tpu_torch.encodings.kmer_encodings import KmerEncoding
    from bionumpy_tpu_torch.sequence.count_encoded import \
        SparseEncodedCounts

    k = 7
    rng = np.random.default_rng(5)
    enc, jenc = KmerEncoding(DNAEncoding, k), JKmer(JDNA, k)
    tables = []
    for _ in range(2):
        h = np.unique(rng.integers(0, 4 ** k, 50)).astype(np.uint64)
        tables.append((h, rng.integers(1, 9, len(h)).astype(np.int64)))
    a, b = (SparseEncodedCounts(enc, h, c) for h, c in tables)
    ja, jb = (JCounts(jenc, h, c) for h, c in tables)
    total, jtotal = a + b, ja + jb
    np.testing.assert_array_equal(total.label_codes, jtotal.label_codes)
    np.testing.assert_array_equal(total.counts, jtotal.counts)
    assert total == sum([a, b]) and total != a
    assert total.alphabet == jtotal.alphabet
    for code in total.label_codes[:5].tolist() + [0, 4 ** k - 1]:
        kmer = jenc.to_string(code)
        assert enc.to_string(code) == kmer
        assert int(enc.encode(kmer).raw()) == code == \
            int(jenc.encode(kmer).raw())
        assert total[kmer] == jtotal[kmer]
    assert repr(total) == repr(jtotal).replace(str(jenc), str(enc))
