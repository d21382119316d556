"""The plain reference of a canonical k-mer spectrum of a read set, in
parts of bounded memory on the card.

Plain PyTorch, worked out from the codes and row lengths the generator
made; it imports nothing of the program under test.  A window's key is
reference.kmer_hashes' sum(code[s + j] << 2j), first base lowest; its
canonical key is the lesser of that and the key of its reverse
complement, taken here as kmer_hashes of the whole block's complemented
codes (3 - c) in reverse order, read backwards.  Only windows inside
their row count (reference.inside_rows).  The keys are made a block of
whole rows at a time (reference.row_blocks) and split by their top
PART_BITS bits, so the distinct keys are counted one key range at a
time: each range's keys sorted and counted by unique_consecutive, so no
sort holds more than a range.  The spectrum h has max_count + 1 bins:
h[c] the distinct keys seen c times, counts above max_count in
h[max_count], h[0] = 0.

Where jellyfish differs: it packs a k-mer's first base highest (the keys
differ, the counts and the spectrum do not), counts in a hash table of
fixed size, and `jellyfish histo` writes its bins from --low 1 to
--high 10000 with the counts above --high in the last; here h[0] is
kept, always 0.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import reference as R

# the key's top bits that split it into ranges counted apart.  A canonical
# key's top digit is the least of two codes, 0 for 7/16 of the keys, so
# the ranges are uneven: at 3 bits the largest of the cell's held ~0.8 G
# keys and its sort ran the card out of memory once after a first
# reference had fragmented it; at 5 the largest holds ~6% of the keys
PART_BITS = 5


def canonical_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """int64 canonical key of the k-mer at every start 0..n-k of `codes`:
    the start s's reverse complement is the k-mer at n-k-s of the
    reversed complement."""
    forward = R.kmer_hashes(codes, k)
    reverse = R.kmer_hashes((3 - codes).flip(0), k).flip(0)
    return torch.minimum(forward, reverse)


def block_keys(flat: np.ndarray, lengths: np.ndarray, k: int,
               canonical: bool, device):
    """The keys of the windows inside their rows, a block of whole rows
    at a time, in row order."""
    lengths = np.asarray(lengths, np.int64)
    cum = np.concatenate([[0], np.cumsum(lengths)])
    for lo, hi in R.row_blocks(lengths):
        rows = slice(int(np.searchsorted(cum, lo)),
                     int(np.searchsorted(cum, hi)))
        codes = torch.as_tensor(flat[lo:hi], device=device)
        if codes.numel() < k:
            continue
        keys = (canonical_hashes(codes, k) if canonical
                else R.kmer_hashes(codes, k))
        yield keys[R.inside_rows(lengths[rows], keys.numel(), k, device)]
        del codes, keys


def kmer_table_parts(flat: np.ndarray, lengths: np.ndarray, k: int,
                     canonical: bool, device):
    """(ascending distinct keys, int64 counts) of each key range in turn,
    the ranges in ascending order."""
    shift = 2 * k - PART_BITS
    parts = [[] for _ in range(1 << PART_BITS)]
    for keys in block_keys(flat, lengths, k, canonical, device):
        part = keys >> shift
        for p, held in enumerate(parts):
            held.append(keys[part == p])
        del keys, part
    for p in range(len(parts)):
        keys = torch.cat(parts[p]) if parts[p] else \
            torch.empty(0, dtype=torch.int64, device=device)
        parts[p] = None
        yield R.count_table(keys)
        del keys


def kmer_table(flat, lengths, k: int, canonical: bool, device):
    """The whole (ascending distinct keys, int64 counts) table."""
    keys, counts = zip(*kmer_table_parts(flat, lengths, k, canonical,
                                         device))
    return torch.cat(keys), torch.cat(counts)


def spectrum_of(counts: torch.Tensor, max_count: int,
                h: torch.Tensor = None) -> torch.Tensor:
    """int64 spectrum of max_count + 1 bins of a table's counts, added to
    `h` where given."""
    if h is None:
        h = torch.zeros(max_count + 1, dtype=torch.int64,
                        device=counts.device)
    return h.index_add_(0, torch.clamp(counts, max=max_count),
                        torch.ones_like(counts))


def kmer_spectrum(flat: np.ndarray, lengths: np.ndarray, k: int,
                  canonical: bool, max_count: int, device) -> torch.Tensor:
    """The spectrum of the read set's k-mer table, one key range at a
    time."""
    h = torch.zeros(max_count + 1, dtype=torch.int64, device=device)
    for _, counts in kmer_table_parts(flat, lengths, k, canonical, device):
        spectrum_of(counts, max_count, h)
    return h
