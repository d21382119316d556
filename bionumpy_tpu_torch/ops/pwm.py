"""Device PWM scanning (the port of bionumpy_tpu/ops/pwm.py).

scores[p] = sum_j matrix[code(p + j), j] at every position of a packed
batch, through pwm_scores_kernel (ops/pwm_kernels.py); the host fetches
the match positions and never the scores.  pwm_scan_matches scans a
resident batch: for windows up to the kernel's 32 with one launch of
the kernel in match mode, which applies the threshold and the row-end
mask and compacts the matches itself, so neither scores nor masks are
written (`pwm-scan`, rows: positions scored, one span a launch), then
one wait for the match count (`D2H-meta`) and a sort of the matches
(`pwm-compact`, rows: matches).  Wider windows are scored from the
codes SCAN_POSITIONS positions at a time and masked by torch ops,
and each block's matches are compacted at their count, after one wait
for it (`D2H-meta`).  The two routes give the same positions, bit for
bit, since both score in the same float32 order.  On hg38 (3.09 G
bases, two resident blocks) the match mode takes ~8 ms of device time a
strand where the blocked route took ~380 ms (NVIDIA H100 80GB HBM3 at
700 W).

pwm_scores and pwm_best_scores take codes instead, for alphabets that
are not 4 letters (and windows past the kernel's 32); they are XLA code
in the JAX package, so torch ops serve, adding the cells in the same
order j = 0..w-1 from 0.0 so the float32 sums are bit-equal.
"""
from __future__ import annotations

import numpy as np
import torch

from ..instrument import add, stage
from .kmer_kernels import WORD_BASES, valid_windows_plain
from .kmers import heads_first
from . import pwm_kernels

__all__ = ["pwm_scores", "pwm_best_scores", "pwm_scores_packed",
           "pwm_scores_range", "pwm_match_compact", "pwm_scan_matches"]

# positions a blocked scan scores, masks and compacts at once (a multiple
# of WORD_BASES); its scratch peaks near 46 bytes a position, 6.2 GB
SCAN_POSITIONS = 1 << 27


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


def pwm_scores_range(words: torch.Tensor, matrix: torch.Tensor,
                     window_size: int, lo: int, hi: int) -> torch.Tensor:
    """float32 scores of positions lo .. hi-1 of the packed words (lo and
    hi multiples of WORD_BASES, hi at most the words' n_positions):
    pwm_scores_kernel over the words from lo's on for windows up to its
    32, the codes scan beyond.  Each score is the one the whole batch's
    scan gives at that position."""
    first = lo // WORD_BASES
    if window_size <= pwm_kernels.MAX_WINDOW:
        return pwm_kernels.pwm_scores(
            words[first: hi // WORD_BASES + 2], matrix, window_size)
    last = hi // WORD_BASES + 2 + (window_size - 1) // WORD_BASES
    codes = pwm_kernels.unpack_codes(words[first: last])
    return pwm_scores(codes, matrix, window_size)[: hi - lo]


def _match_mask(scores: torch.Tensor, ends: torch.Tensor, n_true,
                threshold: float, window_size: int, offset: int):
    """True where a score of positions offset .. offset + n - 1 exceeds
    `threshold` and its window stays inside its row, below
    min(ends[-1], n_true)."""
    valid = valid_windows_plain(ends, scores.numel(), window_size,
                                int(n_true), offset)
    # a float32 threshold, as the JAX package compares in float32
    return valid & (scores > float(np.float32(threshold)))


def pwm_match_compact(scores: torch.Tensor, ends: torch.Tensor, n_true,
                      threshold: float, window_size: int, cap: int,
                      offset: int = 0):
    """The positions whose window score exceeds `threshold`, whose window
    stays inside its row, and which lie below min(ends[-1], n_true),
    compacted in ascending order to the front of a min(cap, n)-slot
    buffer.  `scores` are those of positions offset .. offset + n - 1
    (valid_windows_plain); the positions returned count from `offset`.
    Returns (positions int64, n_matches int64 device scalar); n_matches
    may exceed cap, and the buffer then holds the first cap matches."""
    hit = _match_mask(scores, ends, n_true, threshold, window_size, offset)
    return heads_first(hit, min(cap, scores.numel())), hit.sum()


def pwm_scan_matches(words: torch.Tensor, ends: torch.Tensor,
                     lengths: np.ndarray, n_true: int, matrix: torch.Tensor,
                     window_size: int, threshold: float, cap: int,
                     base: int = 0):
    """The match positions of one resident batch (pwm_match_compact's),
    plus `base`.  Windows up to the kernel's 32 take one launch of
    pwm_scores_kernel in match mode over the whole batch (_fused_scan);
    wider ones are scored from the codes SCAN_POSITIONS positions at a
    time (_blocked_scan).  Returns (int64 device tensors of positions,
    ascending, one per block with matches; the cap reached)."""
    if window_size <= pwm_kernels.MAX_WINDOW:
        return _fused_scan(words, ends, n_true, matrix, window_size,
                           threshold, cap, base)
    return _blocked_scan(words, ends, lengths, n_true, matrix, window_size,
                         threshold, cap, base)


def _fused_scan(words, ends, n_true, matrix, window_size, threshold, cap,
                base):
    """One match-mode launch over the batch's positions below n_true
    rounded up to a word (`pwm-scan`, rows: positions scored), one wait
    for its match count (`D2H-meta`), and, when more than `cap` matched,
    one more launch at the exact count (`cap-rerun`).  The kernel writes
    its matches in no fixed order, so they are sorted (`pwm-compact`,
    rows: matches)."""
    on_card = words.is_cuda
    n_scan = -(-n_true // WORD_BASES) * WORD_BASES
    scan = words[: n_scan // WORD_BASES + 2]  # no bucket padding scored

    def launch(cap):
        with stage("pwm-scan", rows=n_scan, device=on_card):
            return pwm_kernels.pwm_matches(scan, ends, n_true, matrix,
                                           window_size, threshold, cap,
                                           base)

    positions, n_matches = launch(cap)
    with stage("D2H-meta", device=on_card):
        n = int(n_matches)
    if n > cap:
        add("cap-rerun", 0.0)
        cap = n
        positions, _ = launch(cap)
    with stage("pwm-compact", rows=n, device=on_card):
        positions = torch.sort(positions[:n]).values
    return ([positions] if n else []), cap


def _blocked_scan(words, ends, lengths, n_true, matrix, window_size,
                  threshold, cap, base):
    """SCAN_POSITIONS positions at a time: each block is scored and
    masked against the rows that reach it, its match count waited for
    (`D2H-meta`), and its matches compacted at that count, so `cap`
    bounds nothing here and is returned as given."""
    on_card = words.is_cuda
    row_ends = np.cumsum(lengths, dtype=np.int64)
    n_scan = -(-n_true // WORD_BASES) * WORD_BASES
    parts = []
    for lo in range(0, n_scan, SCAN_POSITIONS):
        hi = min(lo + SCAN_POSITIONS, n_scan)
        with stage("pwm-scan", rows=hi - lo, device=on_card):
            scores = pwm_scores_range(words, matrix, window_size, lo, hi)
        # the rows that end past lo, through the first whose end lies
        # past every window of the block
        r0 = int(np.searchsorted(row_ends, lo, side="right"))
        r1 = int(np.searchsorted(row_ends, hi + window_size - 1)) + 1
        with stage("pwm-compact", device=on_card) as span:
            hit = _match_mask(scores, ends[r0:r1], n_true, threshold,
                              window_size, lo)
            with stage("D2H-meta", device=on_card):
                n = int(hit.sum())
            span.rows = n
            if n:
                parts.append(heads_first(hit, n) + (base + lo))
    return parts, cap
