"""Device-side FASTQ parsing: only raw file bytes cross to the device,
and the newline scan, the field spans, the encoding and the 2-bit pack run
there (the port of bionumpy_tpu/ops/parse.py).

The JAX package hashes every byte position of the raw buffer and masks
the windows outside sequence lines, so it sorts one key per raw byte.  The
port instead compacts the sequence bytes on the device, packs them into
words and hands them to the k-mer path's own kmer_keys kernel with the
sequence lines as rows, so it sorts one key per base, as the packed
transport does.  Both give the same windows, so the same tables, meta and
validity:

  ok  = '@' / '+' first bytes of the entries' lines 0 and 2
        & n_lines < max_lines & n_lines % 4 == 0 (the sparse table only)
        & no non-ACGT byte inside a sequence line (the sparse table only)

A line index at or past max_lines is not scanned (the JAX package's
static-size line arrays end there), and a window holding a non-ACGT byte
is dropped, as in the JAX package.  Learning the base count of a batch
(to size its packed bucket) takes one wait for the device per batch.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import bucket_size, resolve_device
from .kmer_kernels import SENTINEL
from .kmers import count_keys, kmer_keys, pack_codes, sentinel_table

NEWLINE = 10
_INVALID = 255  # the encoding LUT's code for a byte outside the alphabet


def _scan(raw: torch.Tensor, n_true: int, max_lines: int):
    """Per byte: whether it is a newline (below n_true) and the index of
    its line; the line count and the '@'/'+' structure check of the lines
    below min(n_lines, max_lines)."""
    is_nl = raw == NEWLINE
    is_nl[n_true:] = False
    nl_upto = torch.cumsum(is_nl, 0, dtype=torch.int32)
    line = nl_upto - is_nl.to(torch.int32)
    n_lines = nl_upto[-1].to(torch.int64)
    starts = torch.ones_like(is_nl)  # the byte begins a line
    starts[1:] = is_nl[:-1]
    scanned = starts & (line < torch.clamp(n_lines, max=max_lines))
    phase = line & 3
    bad = scanned & (((phase == 0) & (raw != ord("@")))
                     | ((phase == 2) & (raw != ord("+"))))
    return is_nl, line, n_lines, ~bad.any()


def fastq_scan(raw: torch.Tensor, n_true: int, max_lines: int):
    """Scan raw FASTQ bytes (padded, uint8) into per-line spans.

    Returns (line_starts, line_ends, n_lines, ok): int64 arrays of length
    `max_lines` (line ends past the real lines are the buffer length, as
    in the JAX package), the line count and whether every complete entry
    within them has the '@'/'+' structure."""
    n = raw.numel()
    is_nl, line, n_lines, ok = _scan(raw, int(n_true), max_lines)
    slot = torch.where(is_nl, line, max_lines).clamp(max=max_lines)
    line_ends = torch.full((max_lines + 1,), n, dtype=torch.int64,
                           device=raw.device)
    line_ends.scatter_(0, slot.to(torch.int64),
                       torch.arange(n, device=raw.device))
    line_ends = line_ends[:max_lines]
    line_starts = torch.cat([line_ends.new_zeros(1), line_ends[:-1] + 1])
    return line_starts, line_ends, n_lines, ok


def _sequence_codes(raw, encode_lut, n_true: int, max_lines: int):
    """The codes of the sequence lines of the entries (at most
    max_lines // 4), compacted in order, with their row ends; which codes
    are invalid (set to 0); the line count and the structure check."""
    is_nl, line, n_lines, ok = _scan(raw, n_true, max_lines)
    n_rows = torch.clamp(n_lines // 4, max=max_lines // 4)
    seq_line = ((line & 3) == 1) & (line < 4 * n_rows)
    in_seq = seq_line & ~is_nl
    codes = encode_lut[raw[in_seq].to(torch.int64)]
    # a sequence line's newline closes its row: the sequence bytes up to
    # it are the row's end
    ends = torch.cumsum(in_seq, 0, dtype=torch.int32)[seq_line & is_nl]
    bad = codes == _INVALID
    return torch.where(bad, 0, codes), bad, ends, n_lines, ok


def _pad_rows(ends: torch.Tensor) -> torch.Tensor:
    """The row ends padded into a power-of-two bucket by repeating the
    last end (a no-op for the kernel), as the packed transport pads."""
    rows = bucket_size(max(ends.numel(), 1), 4096)
    last = ends[-1:] if ends.numel() else ends.new_zeros(1)
    return torch.cat([ends, last.expand(rows - ends.numel())])


def _sequence_keys(codes, bad, ends, k: int) -> torch.Tensor:
    """kmer_keys over the compacted sequences, packed on the device, with
    the windows that hold an invalid byte set to the sentinel."""
    n = codes.numel()
    n_positions = bucket_size(max(n, 1), 1 << 14)
    keys = kmer_keys(pack_codes(codes, n_positions), _pad_rows(ends), k, n)
    if bool(bad.any()):
        bad_upto = torch.cat([bad.new_zeros(1, dtype=torch.int32),
                              torch.cumsum(bad, 0, dtype=torch.int32)])
        stop = torch.clamp(torch.arange(n, device=bad.device) + k, max=n)
        held = bad_upto[stop] > bad_upto[:n]
        keys[:n] = torch.where(held, SENTINEL, keys[:n])
    return keys


def fastq_to_kmer_counts(raw: torch.Tensor, encode_lut: torch.Tensor,
                         n_true: int, max_lines: int, k: int, n_counts: int):
    """Raw FASTQ bytes -> (k-mer counts over 4^k, composition over 4,
    n_entries, ok), all int64 on the device.  ok checks the '@'/'+'
    structure only, as in the JAX package; windows and bases holding a
    non-ACGT byte are left out of the counts."""
    codes, bad, ends, n_lines, ok = _sequence_codes(raw, encode_lut,
                                                    int(n_true), max_lines)
    keys = _sequence_keys(codes, bad, ends, k)
    counts = count_keys(keys, n_counts)
    composition = count_keys(torch.where(bad, 4, codes).to(torch.int64), 4)
    return counts, composition, n_lines // 4, ok


def fastq_to_sparse_kmer_table(raw: torch.Tensor, encode_lut: torch.Tensor,
                               n_true: int, max_lines: int, k: int, cap: int):
    """Raw FASTQ bytes -> a compacted sparse (hash, count) table, all on
    the device: scan + encode + pack + kmer_keys + sort/compact.

    Returns ((keys, counts) int64, min(cap, len(raw)) rows, sentinel-padded
    like kmer_sentinel_table_packed's, so they fold into the same
    accumulator; meta (5,) int64 [n_unique, n_valid, n_entries, ok,
    n_bases]).  n_unique is the true distinct count even where it
    exceeds the rows."""
    n = raw.numel()
    codes, bad, ends, n_lines, ok = _sequence_codes(raw, encode_lut,
                                                    int(n_true), max_lines)
    ok = ok & (n_lines < max_lines) & (n_lines % 4 == 0) & ~bad.any()
    t_keys, cnt, (n_unique, n_valid) = sentinel_table(
        _sequence_keys(codes, bad, ends, k), cap)
    # the JAX package's table has a row per raw byte up to cap; the live
    # rows (at most the windows, so the bases) fit either way
    rows = min(cap, n)
    pad = max(rows - t_keys.numel(), 0)
    table_keys = torch.cat([t_keys, t_keys.new_full((pad,), SENTINEL)])[:rows]
    table_counts = torch.cat([cnt, cnt.new_zeros(pad)])[:rows]
    meta = torch.stack([n_unique, n_valid, n_lines // 4, ok.to(torch.int64),
                        n_unique.new_tensor(codes.numel())])
    return (table_keys, table_counts), meta


def parse_fastq_chunk_on_device(raw_bytes: np.ndarray, k: int = 5,
                                min_bucket: int = 1 << 14, device=None):
    """Pad raw FASTQ bytes into a bucket and count them on `device` (None:
    the card).  Returns (counts over 4^k, composition over ACGT,
    n_entries) on the host; raises ValueError on a malformed chunk."""
    from ..encodings import DNAEncoding

    device = resolve_device(device)
    n = len(raw_bytes)
    size = bucket_size(max(n, 1), min_bucket)
    padded = np.zeros(size, dtype=np.uint8)
    padded[:n] = np.frombuffer(raw_bytes, np.uint8) \
        if isinstance(raw_bytes, bytes) else raw_bytes
    max_lines = size // 2  # '+\n' lines are 2 bytes, the shortest line
    counts, comp, n_entries, ok = fastq_to_kmer_counts(
        torch.from_numpy(padded).to(device),
        torch.from_numpy(DNAEncoding.lookup_table).to(device), n,
        max_lines, k, 4 ** k)
    if not bool(ok):
        raise ValueError("malformed FASTQ chunk (device scan)")
    return counts.cpu().numpy(), comp.cpu().numpy(), int(n_entries)
