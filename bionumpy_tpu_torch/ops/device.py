"""Device plumbing: the device an entry point runs on, power-of-two
bucket sizes and the flat ragged transport (the port's copy of
bionumpy_tpu/ops/device.py: bucket_size, flat_and_lengths,
distance_to_row_end).

The port runs eagerly and needs no static shapes, but it keeps the JAX
package's buckets so that both packages cut, pad and count every batch
identically."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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
