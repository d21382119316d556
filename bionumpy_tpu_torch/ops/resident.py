"""Device-resident sequence chunks: pack + upload ONCE, reuse everywhere
(the port's copy of bionumpy_tpu/ops/resident.py).

An EncodedRaggedArray (or EncodedArray) gets a cached device
materialization, one per device:

    words   int32[bucket/16 + 2]  2-bit-packed codes (uint32 bits)
    ends    int32[n_rows]         cumulative row ends
    n       int                   true base count
    lengths np.ndarray            host row lengths (for trims)

Every device path in sequence/ asks for `device_seqs(seq, device)`; the
first caller pays the host pack + one upload, later callers on the same
device get the cached handle, so a chained `count_kmers(s, 31);
get_kmers(s, 15); count_kmers(s, 5)` uploads the sequence data once
(TRANSFER_COUNT counts the uploads).  An upload is the `upload` span,
over `flatten` (the ragged array's flat codes), `pack` (the 2-bit pack,
its bytes) and `H2D` (the copy, with its device time).

The cache lives on the array under one attribute, a dict keyed by device,
so a handle made for the CPU is never served to a card call.  The only
mutation paths, EncodedArray.__setitem__ and
EncodedRaggedArray.__setitem__, call invalidate(), which drops the whole
dict; arrays made by indexing start with no cache.
"""
from __future__ import annotations

import numpy as np
import torch

from ..instrument import stage
from .device import flat_and_lengths, resolve_device
from .kmers import WORD_BASES, prepare_packed

# uploads of sequence payloads through this module, and their bytes
TRANSFER_COUNT = 0
TRANSFER_BYTES = 0

_CACHE_ATTR = "_device_seqs_cache"


class DeviceSeqs:
    """One ragged chunk's packed codes + row ends, resident on a device."""

    __slots__ = ("words", "ends", "n", "lengths", "n_positions")

    def __init__(self, words: torch.Tensor, ends: torch.Tensor, n: int,
                 lengths: np.ndarray):
        self.words = words
        self.ends = ends
        self.n = n
        self.lengths = lengths
        self.n_positions = (words.numel() - 2) * WORD_BASES

    def __repr__(self):
        return (f"DeviceSeqs(n={self.n}, rows={len(self.lengths)}, "
                f"bucket={self.n_positions}, device={self.words.device})")


def _device_key(device: torch.device) -> torch.device:
    """`device` with its index, so "cuda" and "cuda:0" share one entry."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _build(flat: np.ndarray, lengths: np.ndarray, min_bucket: int,
           device: torch.device) -> DeviceSeqs:
    global TRANSFER_COUNT, TRANSFER_BYTES
    with stage("pack") as span:
        words, ends, n = prepare_packed(flat, lengths, min_bucket)
        span.bytes = words.nbytes + ends.nbytes
    with stage("H2D", n_bytes=words.nbytes + ends.nbytes,
               device=device.type == "cuda"):
        words_d = torch.from_numpy(words.view(np.int32)).to(device)
        ends_d = torch.from_numpy(ends).to(device)
    TRANSFER_COUNT += 1
    TRANSFER_BYTES += words.nbytes + ends.nbytes
    return DeviceSeqs(words_d, ends_d, n, np.asarray(lengths))


def device_seqs(sequence, device=None,
                min_bucket: int = 1 << 14) -> DeviceSeqs:
    """Device-resident packed form of a 4-letter EncodedRaggedArray /
    EncodedArray on `device` (None: the card), cached on the array."""
    key = _device_key(resolve_device(device))
    cache = getattr(sequence, _CACHE_ATTR, None)
    cached = cache.get(key) if cache is not None else None
    if cached is not None and cached.n_positions >= min_bucket:
        return cached
    with stage("upload"):
        with stage("flatten"):
            flat, lengths = flat_and_lengths(sequence)
        ds = _build(flat, lengths, min_bucket, key)
    try:
        if cache is None:
            cache = {}
            setattr(sequence, _CACHE_ATTR, cache)
        cache[key] = ds
    except AttributeError:
        pass  # plain ndarrays etc. cannot carry the cache; still works
    return ds


def invalidate(sequence) -> None:
    """Drop every stale device materialization (called on mutation)."""
    try:
        if getattr(sequence, _CACHE_ATTR, None) is not None:
            delattr(sequence, _CACHE_ATTR)
    except AttributeError:
        pass


def reset_transfer_counters() -> None:
    global TRANSFER_COUNT, TRANSFER_BYTES
    TRANSFER_COUNT = 0
    TRANSFER_BYTES = 0
