"""Device PWM scanning (the port of bionumpy_tpu/ops/pwm.py).

scores[p] = sum_j matrix[code(p + j), j] at every position of a packed
batch, through pwm_scores_kernel (ops/pwm_kernels.py); the match
positions are then compacted on the device, so the host fetches the
matches and not the scores.  Nothing here waits for the card: the match
count is a device scalar until the caller fetches it.

pwm_scores and pwm_best_scores take codes instead, for alphabets that
are not 4 letters (and windows past the kernel's 32); they are XLA code
in the JAX package, so torch ops serve, adding the cells in the same
order j = 0..w-1 from 0.0 so the float32 sums are bit-equal.
"""
from __future__ import annotations

import numpy as np
import torch

from .kmer_kernels import valid_windows_plain
from .kmers import heads_first
from . import pwm_kernels

__all__ = ["pwm_scores", "pwm_best_scores", "pwm_scores_packed",
           "pwm_match_compact"]


def pwm_scores(codes: torch.Tensor, matrix: torch.Tensor,
               window_size: int) -> torch.Tensor:
    """float32 score at every flat position of a code tensor (codes below
    the matrix's alphabet size, zero past the true length + w): the
    window's cells added j = 0..w-1 from 0.0, code 0 read past the end.
    `matrix`: (alphabet size, window_size) float32 log-likelihoods."""
    n = codes.numel()
    codes = codes.to(torch.int64)
    scores = torch.zeros(n, dtype=torch.float32, device=codes.device)
    for offset in range(window_size):
        shifted = torch.cat([codes[offset:], codes.new_zeros(offset)])
        scores = scores + matrix[:, offset][shifted]
    return scores


def pwm_best_scores(codes: torch.Tensor, dist: torch.Tensor,
                    matrix: torch.Tensor, window_size: int) -> torch.Tensor:
    """pwm_scores with -inf where the window leaves its row (`dist`, the
    codes left in the row, below window_size)."""
    scores = pwm_scores(codes, matrix, window_size)
    valid = dist[: scores.numel()] >= window_size
    return torch.where(valid, scores, float("-inf"))


def pwm_scores_packed(words: torch.Tensor, matrix: torch.Tensor,
                      window_size: int) -> torch.Tensor:
    """float32 scores of every window position of the 2-bit-packed words
    (int32 view, n_positions/16 + 2 words).  The JAX function also scores
    the halo words' positions; those hold no data and are left out here,
    so the port returns n_positions scores."""
    return pwm_kernels.pwm_scores(words, matrix, window_size)


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
