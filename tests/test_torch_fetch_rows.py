"""bionumpy_tpu_torch.ops.device.fetch_rows, the one fetch of a table to
the host: its dtype and values for every shape its callers fetch, that
no result shares memory with the next fetch's, and on the card that a
large fetch lands in a recycled page-locked block that stays intact
while a result holds it.  CPU cases need no card; the `cuda` cases skip
without one:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_fetch_rows.py
"""
import gc

import numpy as np
import pytest
import torch

import bionumpy_tpu_torch as bt
from bionumpy_tpu_torch import instrument
from bionumpy_tpu_torch import pipeline as tpipe
from bionumpy_tpu_torch.ops import kmers as tkmers
from bionumpy_tpu_torch.ops.device import PINNED_MIN_BYTES, fetch_rows
from bionumpy_tpu_torch.ops.resident import device_seqs


@pytest.fixture(autouse=True)
def fresh():
    instrument.reset()
    yield
    instrument.reset()


def one_part(g, n):
    return (torch.randint(0, 1 << 62, (n,), generator=g),), n


def two_parts(g, n):
    return (torch.randint(0, 1 << 62, (n,), generator=g),
            torch.randint(1, 1000, (n,), generator=g)), n


def gc_parts(g, n):
    # _count_minimizers_with_gc_chunked: table rows, then each chunk's
    # int32 GC bins
    return (torch.randint(0, 1 << 62, (n,), generator=g),
            torch.randint(1, 1000, (n,), generator=g),
            torch.randint(0, 1000, (37,), generator=g, dtype=torch.int32),
            torch.randint(0, 1000, (12,), generator=g, dtype=torch.int32)), n


def no_rows(g, n):
    return (torch.empty(0, dtype=torch.int64),
            torch.empty(0, dtype=torch.int64)), 0


def made(case, device, n=613, seed=5):
    """The case's parts on `device` and their row count, the same values
    for the same seed."""
    parts, rows = case(torch.Generator().manual_seed(seed), n)
    return tuple(p.to(device) for p in parts), rows


def expected(parts) -> np.ndarray:
    return np.concatenate([p.cpu().numpy().astype(np.int64)
                           for p in parts])


def fetch_twice(case, device, n=613):
    """Two fetches of equal tables built apart, as two calls build them."""
    parts, rows = made(case, device, n)
    first = fetch_rows(*parts, rows=rows)
    again, _ = made(case, device, n)
    return parts, first, fetch_rows(*again, rows=rows)


@pytest.mark.parametrize("case", [one_part, two_parts, gc_parts, no_rows])
def test_fetch_rows(case):
    parts, first, second = fetch_twice(case, "cpu")
    assert first.dtype == second.dtype == np.int64
    want = expected(parts)
    assert np.array_equal(first, want) and np.array_equal(second, want)
    assert not np.shares_memory(first, second)
    rep = instrument.report()
    assert rep["D2H"]["calls"] == 2
    # the CPU takes no page-locked path
    assert "fetch-pinned" not in rep and "fetch-host-alloc" not in rep


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: page-locked host memory and the "
                    "device-to-host copy have no CPU mode")
    return torch.device("cuda")


def large(device, seed=7):
    """One part of 2 * PINNED_MIN_BYTES, on the card."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 1 << 62, (PINNED_MIN_BYTES // 4,),
                         generator=g).to(device)


def pinned(a: np.ndarray) -> bool:
    """Whether `a`'s memory is page-locked (read through a signed view:
    `from_numpy` of uint64 is not in every PyTorch)."""
    return torch.from_numpy(a.view(np.int64)).is_pinned()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [one_part, two_parts, gc_parts, no_rows])
def test_fetch_rows_card(cuda, case):
    for n in (613, PINNED_MIN_BYTES // 8):
        parts, first, second = fetch_twice(case, cuda, n)
        want = expected(parts)
        assert first.dtype == np.int64
        assert np.array_equal(first, want) and np.array_equal(second, want)
        assert not np.shares_memory(first, second)


@pytest.mark.cuda
def test_large_fetch_is_page_locked_small_is_not(cuda):
    x = large(cuda)
    big = fetch_rows(x, rows=x.numel())
    assert pinned(big) and pinned(big[5:].view(np.uint64))
    small = fetch_rows(x[: PINNED_MIN_BYTES // 8 - 1], rows=1)
    assert not pinned(small)
    assert np.array_equal(big, x.cpu().numpy())
    assert np.array_equal(small, big[: small.size])
    rep = instrument.report()
    assert rep["fetch-pinned"]["calls"] == 1
    assert rep["fetch-pinned"]["bytes"] == big.nbytes
    assert rep.get("fetch-host-alloc", {"calls": 0})["calls"] <= 1


@pytest.mark.cuda
def test_held_result_survives_later_fetches(cuda):
    x = large(cuda)
    held = fetch_rows(x, rows=x.numel())
    want = held.copy()
    for seed in range(20):
        y = large(cuda, seed=100 + seed)
        out = fetch_rows(y, rows=y.numel())
        assert not np.shares_memory(out, held)
        del out
    assert np.array_equal(held, want)


@pytest.mark.cuda
def test_dropped_block_is_recycled(cuda):
    x = large(cuda)
    out = fetch_rows(x, rows=x.numel())
    del out
    gc.collect()
    instrument.reset()
    y = large(cuda, seed=8)
    out = fetch_rows(y, rows=y.numel())
    rep = instrument.report()
    assert rep["fetch-pinned"]["calls"] == 1
    assert "fetch-host-alloc" not in rep
    assert np.array_equal(out, y.cpu().numpy())


@pytest.mark.cuda
def test_uint64_views_outlive_their_parent(cuda):
    g = np.random.default_rng(11)
    flat = g.integers(0, 4, 400_000).astype(np.uint8)
    seqs = bt.EncodedRaggedArray(bt.EncodedArray(flat, bt.DNAEncoding),
                                 np.full(2000, 200))
    ds = device_seqs(seqs, cuda)
    h, c = tkmers.sparse_count_tables(ds.words, ds.ends, 31, ds.n,
                                      cap=1 << 19)
    assert pinned(h) and h.dtype == np.uint64 and c.dtype == np.int64
    ref = bt.count_kmers(seqs, 31, device="cpu")
    # the accumulator's fetch, from the same table
    n = h.size
    acc = (torch.as_tensor(h.view(np.int64), device=cuda),
           torch.as_tensor(c, device=cuda), torch.tensor(n, device=cuda))
    ah, ac = tpipe._fetch_acc(acc, n + 1)
    assert pinned(ah) and ah.dtype == np.uint64
    gc.collect()
    for seed in range(4):  # reuse whatever a dead parent left
        y = large(cuda, seed=200 + seed)
        fetch_rows(y, rows=y.numel())
    for keys, counts in ((h, c), (ah, ac)):
        assert np.array_equal(keys, ref.label_codes)
        assert np.array_equal(counts, ref.counts)
