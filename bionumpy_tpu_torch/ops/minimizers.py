"""Minimizers on the device (the port of bionumpy_tpu/ops/minimizers.py).

The minimizer of a window of `n_kmers` consecutive k-mers is the least
of their hashes.  The JAX package carries each hash as two uint32 limbs
and takes a lexicographic (hi, lo) min; the port keeps its one int64 key
per position from kernel 1 (ops/kmer_kernels.kmer_keys: the 2k-bit hash,
or the sentinel 2^63-1 where the k-mer leaves its row) and takes a plain
min, which orders the keys alike because every k <= 31 hash is below
2^62.  The windowed min is the JAX package's doubling sweep
(bionumpy_tpu/ops/minimizers.py:27-35): after steps of 1, 2, 4, ...
position i holds the min over [i, i + n_kmers), shifted copies padded
with the sentinel.

A minimizer window that fits its row holds only k-mers that fit it, so
the sentinel never wins there and the key equals the JAX package's
lo | hi << 32.  Where the window leaves its row the port may hold the
sentinel and the JAX package an unmasked min: every caller masks those
windows (window_valid) before using them.

Tables are fetched as live rows in one copy, as pipeline._fetch_acc
fetches them; the JAX package's 32-bit delta pack (ops/fetch_pack.py)
has no counterpart.  Nothing here waits for the device but
minimizer_gc_job_packed, which waits once for its table's row count.
"""
from __future__ import annotations

import torch

from .kmer_kernels import SENTINEL, WORD_BASES, kmer_keys
from .kmers import (counts_from_runs, kmer_hash_limbs, sorted_runs_from_keys,
                    whole_table)
from .tracks import gc_binned_from_packed, gc_binned_phase

__all__ = ["window_valid", "minimizer_keys_packed", "minimizer_keys_masked",
           "minimizer_table_packed", "minimizer_sentinel_table_packed",
           "minimizer_gc_job_packed", "minimizer_sentinel_gc_group",
           "minimizer_limbs"]


def _doubling_min(keys: torch.Tensor, n_kmers: int) -> torch.Tensor:
    """min over [i, i + n_kmers) at every position i, positions past the
    end read as the sentinel.  Two buffers serve every step; `keys` is
    one of them and is overwritten."""
    out, spare = keys, None
    span = 1
    while span < n_kmers:
        step = min(span, n_kmers - span)
        if spare is None:
            spare = torch.empty_like(keys)
        torch.minimum(out[:-step], out[step:], out=spare[:-step])
        spare[-step:] = out[-step:]
        out, spare = spare, out
        span += step
    return out


def window_valid(ends: torch.Tensor, n_positions: int, window_size: int,
                 n_true: int) -> torch.Tensor:
    """Bool per position: the window of `window_size` bases starting there
    lies inside its row and starts below min(ends[-1], n_true).  The JAX
    package's marks (bionumpy_tpu/ops/minimizers.py:67-72): +1 at
    max(e - window_size + 1, 0) and -1 at e for every row end e, and a
    cumulative sum that is positive exactly on the invalid starts."""
    device = ends.device
    if ends.numel() == 0:
        return torch.zeros(n_positions, dtype=torch.bool, device=device)
    e = ends.to(torch.int64)
    one = torch.ones_like(e, dtype=torch.int32)
    marks = torch.zeros(n_positions + 1, dtype=torch.int32, device=device)
    marks.index_add_(0, torch.clamp(e - (window_size - 1), min=0), one)
    marks.index_add_(0, e, -one)
    invalid = torch.cumsum(marks[:-1], 0, dtype=torch.int32)
    pos = torch.arange(n_positions, device=device)
    return (invalid == 0) & (pos < torch.clamp(e[-1], max=int(n_true)))


def minimizer_keys_packed(words: torch.Tensor, ends: torch.Tensor, k: int,
                          n_kmers: int, n_true: int = None) -> torch.Tensor:
    """int64 minimizer key at every window start of a packed batch: the
    least kernel-1 key over the window's `n_kmers` k-mers.  The port's
    counterpart of both minimizer_limbs_packed and minimizer_pairs_packed
    of the JAX package: equal to their lo | hi << 32 at every window that
    fits its row, possibly the sentinel elsewhere."""
    return _doubling_min(kmer_keys(words, ends, k, n_true), n_kmers)


def minimizer_keys_masked(words: torch.Tensor, ends: torch.Tensor, n_true,
                          k: int, n_kmers: int) -> torch.Tensor:
    """minimizer_keys_packed with the sentinel at every window of
    n_kmers + k - 1 bases that leaves its row or starts at or past
    min(ends[-1], n_true): the keys a minimizer table counts."""
    n_positions = (words.numel() - 2) * WORD_BASES
    mins = minimizer_keys_packed(words, ends, k, n_kmers, n_true)
    return mins.masked_fill_(~window_valid(ends, n_positions,
                                           n_kmers + k - 1, n_true),
                             SENTINEL)


def minimizer_table_packed(words: torch.Tensor, ends: torch.Tensor, n_true,
                           k: int, n_kmers: int, cap: int):
    """Sorted, compacted minimizer table of a packed batch: one entry per
    valid window of window_size = n_kmers + k - 1 bases, counted per
    window (count_encoded(get_minimizers(...))).  Returns (uniq keys,
    run starts, meta (2,) int64 [n_unique, n_valid]) with
    min(cap, n_positions) rows; n_unique may exceed cap (the table then
    holds the first cap runs)."""
    n_positions = (words.numel() - 2) * WORD_BASES
    uniq, run_starts, n_unique, n_valid = sorted_runs_from_keys(
        minimizer_keys_masked(words, ends, n_true, k, n_kmers),
        min(cap, n_positions))
    return uniq, run_starts, torch.stack([n_unique, n_valid])


def minimizer_sentinel_table_packed(words: torch.Tensor, ends: torch.Tensor,
                                    n_true, k: int, n_kmers: int, cap: int):
    """The minimizer table as fold-ready (keys, counts) int64 rows, the
    unused ones (SENTINEL, 0), plus the (2,) meta: the counterpart of
    pipeline._fold_program's input in the JAX package."""
    uniq, run_starts, meta = minimizer_table_packed(words, ends, n_true, k,
                                                    n_kmers, cap)
    rows = run_starts.numel()
    cnt = counts_from_runs(run_starts, meta[0], meta[1], rows)
    live = torch.arange(rows, device=uniq.device) < meta[0]
    return torch.where(live, uniq, SENTINEL), cnt, meta


def minimizer_gc_job_packed(words: torch.Tensor, ends: torch.Tensor, n_true,
                            k: int, n_kmers: int, cap: int, bin_size: int):
    """The whole config-3 job on one upload: the int32 GC count per bin of
    the padded bucket (ops/tracks.gc_binned_from_packed) and the whole
    minimizer table (ops/kmers.whole_table, first compacted at `cap`
    rows).  Returns (uniq keys, counts, meta (2,) int64 [n_unique,
    n_valid], bins), the table's n_unique rows long, for the caller to
    fetch with the real bins in one copy.  (The JAX package's returns
    the table at `cap` rows, and its caller reruns past it.)"""
    gc = gc_binned_from_packed(words, n_true, bin_size)
    uniq, counts, meta = whole_table(
        minimizer_keys_masked(words, ends, n_true, k, n_kmers), cap)
    return uniq, counts, meta, gc


def minimizer_sentinel_gc_group(words: torch.Tensor, ends: torch.Tensor,
                                n_true, k: int, n_kmers: int, cap: int,
                                bin_size: int, phase: int = 0):
    """One chunk of the chunked config-3 job: the fold-ready minimizer
    table (minimizer_sentinel_table_packed), its meta, and the chunk's
    GC bins on the global bin grid (phase = chunk_start % bin_size,
    ops/tracks.gc_binned_phase)."""
    keys, cnt, meta = minimizer_sentinel_table_packed(words, ends, n_true,
                                                      k, n_kmers, cap)
    return keys, cnt, meta, gc_binned_phase(words, n_true, bin_size, phase)


def minimizer_limbs(codes_padded: torch.Tensor, dist_padded: torch.Tensor,
                    k: int, n_kmers: int):
    """(lo, hi, valid) of the least unmasked k-mer hash over each window
    of `n_kmers` k-mers of a code buffer (kmer_hash_limbs' layout): lo
    and hi as int64 below 2^32, and valid where the window's
    n_kmers + k - 1 bases fit the row (dist_padded, the bases left in the
    row, at least that).  No kernel runs here."""
    lo, hi = kmer_hash_limbs(codes_padded, k)
    mins = _doubling_min(lo | (hi << 32), n_kmers)
    valid = dist_padded[: mins.numel()] >= n_kmers + k - 1
    return mins & 0xFFFFFFFF, mins >> 32, valid
