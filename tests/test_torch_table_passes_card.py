"""Tables built in passes over resident blocks on the card
(ops/kmers.blocked_table): the folded table of count_minimizers and of
count_kmers equals the same call as one pass, at a size whose blocks
and passes are forced small enough to make 3 or more passes; the spans,
the counter and kernel 1's launches are read just after.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_table_passes_card.py
"""
import numpy as np
import pytest
import torch

import bionumpy_tpu_torch as bt
from bionumpy_tpu_torch import instrument
from bionumpy_tpu_torch.ops import kmer_kernels, kmers, resident


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
