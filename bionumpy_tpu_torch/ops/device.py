"""Device plumbing: the device an entry point runs on, power-of-two
bucket sizes, the flat ragged transport (the port's copy of
bionumpy_tpu/ops/device.py: bucket_size, flat_and_lengths,
distance_to_row_end) and the one fetch of a table's rows to the host
(fetch_rows), into page-locked host blocks that the caching host
allocator recycles.

The port runs eagerly and needs no static shapes, but it keeps the JAX
package's buckets so that both packages cut, pad and count every batch
identically."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import instrument
from ..instrument import add, stage

# Fetches of at least this many bytes land in page-locked memory.  On an
# H100 a recycled page-locked fetch overtakes a pageable one between 256
# and 512 KiB (PERF.md, the link probe); below 1 MiB the gain is tens of
# microseconds, too little to keep a small result pinned.
PINNED_MIN_BYTES = 1 << 20


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another.  Raises rather than falling back to the CPU when no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain versions on the host")
    return dev


def bucket_size(n: int, minimum: int = 1024) -> int:
    """Smallest power-of-two bucket >= n (and >= minimum)."""
    size = minimum
    while size < n:
        size *= 2
    return size


def flat_and_lengths(ragged) -> Tuple[np.ndarray, np.ndarray]:
    """Extract (flat uint8 codes, row lengths) from an EncodedRaggedArray /
    EncodedArray / RaggedArray."""
    from ..encoded_array import EncodedArray, EncodedRaggedArray
    from ..ragged import RaggedArray
    if isinstance(ragged, EncodedRaggedArray):
        return np.asarray(ragged.ravel().raw()), np.asarray(ragged.lengths)
    if isinstance(ragged, EncodedArray):
        data = np.asarray(ragged.raw())
        if data.ndim == 2:
            return data.ravel(), np.full(len(data), data.shape[1])
        return data, np.array([len(data)])
    if isinstance(ragged, RaggedArray):
        return np.asarray(ragged.ravel()), np.asarray(ragged.lengths)
    data = np.asarray(ragged)
    if data.ndim == 2:
        return data.ravel(), np.full(len(data), data.shape[1])
    return data.ravel(), np.array([data.size])


def distance_to_row_end(lengths: np.ndarray) -> np.ndarray:
    """d[i] = how many elements remain in i's row including i: a window of
    length k starting at flat position i stays inside its row iff
    d[i] >= k (the reference's trim rule, bionumpy/sequence/rollable.py)."""
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int32)
    ends = np.cumsum(lengths)
    return (np.repeat(ends, lengths) -
            np.arange(total, dtype=np.int64)).astype(np.int32)


def fetch_rows(*parts: torch.Tensor, rows: int) -> np.ndarray:
    """The device tensors as one int64 host array, in one copy: the
    fetch of a table's live rows (`rows` of them) and whatever rides
    with them.  The copy is the `D2H` span, with its bytes and rows.

    A card fetch of PINNED_MIN_BYTES or more copies straight into a
    page-locked block of PyTorch's caching host allocator and returns a
    NumPy view of it: the view (and every slice or view taken of it)
    holds the block, which returns to the allocator's cache when the
    last of them dies, for the next fetch of its size class to take
    with its pages already mapped.  Counted as `fetch-pinned` (bytes),
    and as `fetch-host-alloc` when the allocator had to lock a new
    block.  A smaller fetch, and a CPU tensor, take a pageable copy."""
    flat = parts[0].to(torch.int64) if len(parts) == 1 else \
        torch.cat([p.to(torch.int64) for p in parts])
    n_bytes = 8 * flat.numel()
    with stage("D2H", n_bytes=n_bytes, rows=rows, device=flat.is_cuda):
        if not flat.is_cuda or n_bytes < PINNED_MIN_BYTES:
            return flat.cpu().numpy()
        return _fetch_pinned(flat, n_bytes)


def _host_allocs() -> int:
    return torch.cuda.host_memory_stats().get("num_host_alloc", 0)


def _fetch_pinned(flat: torch.Tensor, n_bytes: int) -> np.ndarray:
    """`flat` copied into a page-locked block on the current stream,
    waited for on that stream alone."""
    counted = instrument.ENABLED
    before = _host_allocs() if counted else 0
    dst = torch.empty(flat.numel(), dtype=torch.int64, pin_memory=True)
    if counted:
        add("fetch-pinned", 0.0, n_bytes=n_bytes)
        if _host_allocs() > before:
            add("fetch-host-alloc", 0.0, n_bytes=n_bytes)
    dst.copy_(flat, non_blocking=True)
    torch.cuda.current_stream(flat.device).synchronize()
    return dst.numpy()
