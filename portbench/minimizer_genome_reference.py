"""The plain reference of the minimizer table of a genome, in parts of
bounded memory on the card.

Plain PyTorch, worked out from the codes and row lengths the generator
made; it imports nothing of the program under test.  A window's value
is its minimizer, as reference.window_values gives it: the least k-mer
hash sum(code[s + j] << 2j) over the window's k-mers, for every window
inside its row.  reference.minimizer_table sorts all of them at once,
which at a genome's 3.09 G windows the card cannot hold; here the
values are made a block of whole rows at a time (reference.row_blocks)
and counted straight into a dense int64 count of every key, PART_KEYS
keys at a time: a histogram, where the program sorts and folds.  The
table is the keys with a count above 0, ascending, and their counts.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import reference as R

PART_KEYS = 1 << 30  # keys counted at once: one int64 count each (8 GiB)


def _block_values(flat: np.ndarray, lengths: np.ndarray, k: int,
                  window: int, device):
    """The window values of each block of whole rows, in row order."""
    lengths = np.asarray(lengths, np.int64)
    cum = np.concatenate([[0], np.cumsum(lengths)])
    for lo, hi in R.row_blocks(lengths):
        rows = slice(int(np.searchsorted(cum, lo)),
                     int(np.searchsorted(cum, hi)))
        yield R.window_values(flat[lo:hi], lengths[rows], k, window, device)


def minimizer_table(flat: np.ndarray, lengths: np.ndarray, k: int,
                    window: int, device):
    """(ascending int64 minimizers, int64 windows each) of every window of
    `window` bases inside its row; the keys lie below 4^k."""
    n_keys = 4 ** k
    keys, counts = [], []
    for lo in range(0, n_keys, PART_KEYS):
        size = min(PART_KEYS, n_keys - lo)
        count = torch.zeros(size, dtype=torch.int64, device=device)
        one = torch.ones(1, dtype=torch.int64, device=device)
        for values in _block_values(flat, lengths, k, window, device):
            if size < n_keys:
                values = values[(values >= lo) & (values < lo + size)] - lo
            count.index_add_(0, values, one.expand(values.numel()))
            del values
        seen = torch.nonzero(count).flatten()
        keys.append(seen + lo)
        counts.append(count[seen])
        del count
    return torch.cat(keys), torch.cat(counts)
