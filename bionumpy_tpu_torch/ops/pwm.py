"""Device PWM scanning (the port of the motif pipeline's subset of
bionumpy_tpu/ops/pwm.py).

scores[p] = sum_j matrix[code(p + j), j] at every position of a packed
batch, through pwm_scores_kernel (ops/pwm_kernels.py); the match
positions are then compacted on the device, so the host fetches the
matches and not the scores.  Nothing here waits for the card: the match
count is a device scalar until the caller fetches it.
"""
from __future__ import annotations

import numpy as np
import torch

from .kmer_kernels import valid_windows_plain
from .kmers import heads_first
from .pwm_kernels import pwm_scores

__all__ = ["pwm_scores_packed", "pwm_match_compact"]


def pwm_scores_packed(words: torch.Tensor, matrix: torch.Tensor,
                      window_size: int) -> torch.Tensor:
    """float32 scores of every window position of the 2-bit-packed words
    (int32 view, n_positions/16 + 2 words).  The JAX function also scores
    the halo words' positions; those hold no data and are left out here,
    so the port returns n_positions scores."""
    return pwm_scores(words, matrix, window_size)


def pwm_match_compact(scores: torch.Tensor, ends: torch.Tensor, n_true,
                      threshold: float, window_size: int, cap: int):
    """The positions whose window score exceeds `threshold`, whose window
    stays inside its row, and which lie below min(ends[-1], n_true),
    compacted in ascending order to the front of a min(cap, n)-slot
    buffer.  Returns (positions int64, n_matches int64 device scalar);
    n_matches may exceed cap, and the buffer then holds the first cap
    matches."""
    n = scores.numel()
    valid = valid_windows_plain(ends, n, window_size, int(n_true))
    # a float32 threshold, as the JAX package compares in float32
    hit = valid & (scores > float(np.float32(threshold)))
    return heads_first(hit, min(cap, n)), hit.sum()
