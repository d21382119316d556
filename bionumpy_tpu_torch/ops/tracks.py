"""Genomic tracks on the device: dense and binned pileups, GC content
(the port of bionumpy_tpu/ops/tracks.py).

The pileups are a +1/-1 boundary scatter and one cumulative sum; the GC
track unpacks the 2-bit words, takes one int32 cumulative sum of the
G/C flags and gathers it at the bin edges.  All of it is XLA code in
the JAX package, so torch ops serve here.  Outputs are int32, as there.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BASES = 16

__all__ = ["dense_pileup", "binned_pileup", "gc_binned_phase",
           "gc_binned_from_packed", "gc_track"]


def _scatter_add(size: int, index: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """int32 (size,) zeros with `values` added at `index`, indexed as
    JAX's `.at[index].add` indexes: a negative index counts from the end
    and an index outside [-size, size) is dropped."""
    index = index.to(torch.int64)
    index = torch.where(index < 0, index + size, index)
    index = torch.where((index >= 0) & (index < size), index, size)
    out = torch.zeros(size + 1, dtype=torch.int32, device=index.device)
    out.index_add_(0, index, values.to(torch.int32).expand(index.shape))
    return out[:size]


def dense_pileup(starts: torch.Tensor, stops: torch.Tensor,
                 valid: torch.Tensor, n_positions: int) -> torch.Tensor:
    """int32 interval depth over [0, n_positions): +1 at each valid
    interval's start, -1 at its stop, one cumulative sum."""
    s_idx = torch.where(valid, starts, n_positions)
    e_idx = torch.where(valid, stops, n_positions)
    one = torch.ones((), dtype=torch.int32, device=starts.device)
    diff = _scatter_add(n_positions + 1, torch.cat([s_idx, e_idx]),
                        torch.cat([one.expand(s_idx.shape),
                                   (-one).expand(e_idx.shape)]))
    return torch.cumsum(diff[:-1], 0, dtype=torch.int32)


def binned_pileup(starts: torch.Tensor, stops: torch.Tensor,
                  valid: torch.Tensor, n_bins: int,
                  bin_size: int) -> torch.Tensor:
    """int32 covered-base count per bin (the sum of the intervals'
    overlaps with it): full bins between an interval's first and last
    get bin_size each through a boundary diff and a cumulative sum; the
    first and last bins get their partial overlaps."""
    limit = n_bins * bin_size
    s = torch.where(valid, starts, limit).to(torch.int32)
    e = torch.where(valid, stops, limit).to(torch.int32)
    s_bin = torch.div(s, bin_size, rounding_mode="floor")
    e_bin = torch.div(e, bin_size, rounding_mode="floor")
    size = n_bins + 2
    one = torch.ones((), dtype=torch.int32, device=s.device)
    opens = _scatter_add(
        size, torch.cat([s_bin + 1, torch.maximum(e_bin, s_bin + 1)]),
        torch.cat([one.expand(s.shape), (-one).expand(s.shape)]))
    full = torch.cumsum(opens[:n_bins], 0, dtype=torch.int32) * bin_size
    own = _scatter_add(
        size, torch.cat([s_bin, e_bin]),
        torch.cat([torch.minimum((s_bin + 1) * bin_size - s, e - s),
                   torch.where(e_bin > s_bin, e - e_bin * bin_size,
                               torch.zeros_like(e))]))
    return full + own[:n_bins]


def _gc_cumsum(words: torch.Tensor, n_true: int) -> torch.Tensor:
    """int32 running count of G and C (codes 2 and 1) over the bucket's
    positions below n_true.  A code is 1 or 2 exactly when its two bits
    differ, so one xor per word gives every base's flag."""
    flags = (words[:-2] ^ (words[:-2] >> 1)) & 0x55555555
    bits = torch.arange(0, 2 * WORD_BASES, 2, dtype=torch.int32,
                        device=words.device)
    is_gc = ((flags[:, None] >> bits) & 1).to(torch.bool).reshape(-1)
    is_gc[int(n_true):] = False
    return torch.cumsum(is_gc, 0, dtype=torch.int32)


def gc_binned_phase(words: torch.Tensor, n_true, bin_size: int,
                    phase=0) -> torch.Tensor:
    """GC count per bin of a chunk whose global start S has
    S % bin_size == phase, on the global bin grid: bin b covers the
    chunk's positions [b*bin_size - phase, (b+1)*bin_size - phase), so
    the host adds chunk bins at offset S // bin_size and a bin cut by a
    chunk boundary sums its two parts.  n_positions // bin_size + 2 bins,
    the trailing ones zero."""
    csum = _gc_cumsum(words, n_true)
    n_positions = csum.numel()
    b = torch.arange(n_positions // bin_size + 2, device=words.device)
    end = torch.clamp((b + 1) * bin_size - phase, 0, n_positions)
    start = torch.clamp(b * bin_size - phase, 0, n_positions)
    zero = torch.zeros((), dtype=torch.int32, device=words.device)
    hi = torch.where(end > 0, csum[torch.clamp(end - 1, min=0)], zero)
    lo = torch.where(start > 0, csum[torch.clamp(start - 1, min=0)], zero)
    return hi - lo


def gc_binned_from_packed(words: torch.Tensor, n_true,
                          bin_size: int) -> torch.Tensor:
    """int32 GC count per bin of the 2-bit-packed words (int32 view,
    n_positions/16 + 2 words), ceil(n_positions / bin_size) bins, the
    positions at or past n_true not counted."""
    csum = _gc_cumsum(words, n_true)
    n_positions = csum.numel()
    b = torch.arange(-(-n_positions // bin_size), device=words.device)
    hi = csum[torch.clamp((b + 1) * bin_size, max=n_positions) - 1]
    lo = torch.where(b > 0, csum[torch.clamp(b * bin_size - 1, min=0)],
                     torch.zeros((), dtype=torch.int32, device=words.device))
    return hi - lo


def gc_track(sequence, bin_size: int = 1000, device=None) -> np.ndarray:
    """GC count per `bin_size` bases of a 4-letter encoded sequence, over
    its resident packed words (ops/resident.py; `device`: None is the
    card).  The last bin covers only the true tail.  Returns a host int32
    array of ceil(n / bin_size) bins."""
    from .resident import device_seqs

    ds = device_seqs(sequence, device)
    bins = gc_binned_from_packed(ds.words, ds.n, bin_size)
    return bins[: -(-ds.n // bin_size)].cpu().numpy()
