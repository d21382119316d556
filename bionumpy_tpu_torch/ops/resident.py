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

An array of more than MAX_PACKED_BASES bases (whose int32 row ends would
wrap) is not one batch: device_seqs raises ValueError for it, and
device_seq_blocks, for callers that work block by block
(get_motif_matches; count_minimizers and count_kmers past k = 12, whose
tables ops/kmers.blocked_table builds in passes), holds it as
consecutive blocks of whole rows, each a DeviceSeqs of at most
MAX_PACKED_BASES bases with its own words and int32 ends, all uploaded
in one `upload` span.  A smaller array is one block, the handle
device_seqs makes.

The cache lives on the array under one attribute, a dict keyed by device
(and by (device, "blocks") for the blocks), so a handle made for the CPU
is never served to a card call.  max_code keeps the array's largest code
in the same dict (key "max_code"), so the motif scans' check of the
codes reads them once per array, not once per call.  The only mutation
paths, EncodedArray.__setitem__ and EncodedRaggedArray.__setitem__,
call invalidate(), which drops the whole dict; arrays made by indexing
start with no cache.  A write through a view (`s.ravel().raw()[i] = c`)
bypasses __setitem__ and leaves the handles and the largest code stale:
call invalidate(s) after one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..instrument import add, stage
from ..ragged import RaggedArray
from .device import flat_and_lengths, resolve_device
from . import kmers
from .kmers import WORD_BASES, prepare_packed

# uploads of sequence payloads through this module, and their bytes
TRANSFER_COUNT = 0
TRANSFER_BYTES = 0
# codes read on the host by max_code's pass over an array
CODES_READ = 0

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
    EncodedArray on `device` (None: the card), cached on the array.
    Raises ValueError for an array of more than MAX_PACKED_BASES bases
    (ops/kmers.prepare_packed)."""
    key = _device_key(resolve_device(device))
    cache = _cache_of(sequence)
    cached = cache.get(key) if cache is not None else None
    if cached is not None and cached.n_positions >= min_bucket:
        return cached
    with stage("upload"):
        with stage("flatten"):
            flat, lengths = flat_and_lengths(sequence)
        ds = _build(flat, lengths, min_bucket, key)
    if cache is not None:
        cache[key] = ds
    return ds


def _cache_of(sequence):
    """The array's cache dict, made on first use; None for objects that
    cannot carry one (plain ndarrays etc.: still served, never cached)."""
    cache = getattr(sequence, _CACHE_ATTR, None)
    if cache is None:
        try:
            cache = {}
            setattr(sequence, _CACHE_ATTR, cache)
        except AttributeError:
            return None
    return cache


def row_blocks(lengths: np.ndarray, limit: int) -> list:
    """(first row, end row) of consecutive runs of whole rows, each of at
    most `limit` bases, filled greedily from the first row.  Raises
    ValueError for a row longer than `limit`."""
    lengths = np.asarray(lengths, np.int64)
    if len(lengths) and int(lengths.max()) > limit:
        raise ValueError(f"a row of {int(lengths.max())} bases does not fit "
                         f"a packed batch of at most {limit}")
    ends = np.cumsum(lengths)
    out, r0, base = [], 0, 0
    while r0 < len(lengths):
        r1 = int(np.searchsorted(ends, base + limit, side="right"))
        out.append((r0, r1))
        base, r0 = int(ends[r1 - 1]), r1
    return out


def device_seq_blocks(sequence, device=None) -> list:
    """The array's resident blocks of whole rows on `device`, in row
    order: [device_seqs(sequence, device)] when it fits one packed batch,
    else one DeviceSeqs of at most MAX_PACKED_BASES bases a block, made
    once and cached on the array."""
    dev = _device_key(resolve_device(device))
    cache = _cache_of(sequence)
    if cache is not None and (dev, "blocks") in cache:
        return cache[(dev, "blocks")]
    if cache is not None and dev in cache:  # one batch, resident already
        return [cache[dev]]
    flat, lengths = flat_and_lengths(sequence)
    if len(flat) <= kmers.MAX_PACKED_BASES:
        return [device_seqs(sequence, device)]
    with stage("upload"):
        blocks, base = [], 0
        for r0, r1 in row_blocks(lengths, kmers.MAX_PACKED_BASES):
            n = int(np.sum(lengths[r0:r1], dtype=np.int64))
            blocks.append(_build(flat[base: base + n], lengths[r0:r1],
                                 1 << 14, dev))
            base += n
    if cache is not None:
        cache[(dev, "blocks")] = blocks
    return blocks


def max_code(sequence) -> int:
    """The largest flat code of an EncodedArray / EncodedRaggedArray (0
    when empty), read once and cached on the array until invalidate();
    a call served from the cache counts as `check-codes-cached`."""
    global CODES_READ
    cache = _cache_of(sequence)
    if cache is not None and "max_code" in cache:
        add("check-codes-cached", 0.0, rows=1)
        return cache["max_code"]
    raw = sequence.raw()
    flat = np.asarray(raw.ravel() if isinstance(raw, RaggedArray) else raw)
    value = int(np.max(flat, initial=0))
    CODES_READ += flat.size
    if cache is not None:
        cache["max_code"] = value
    return value


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
