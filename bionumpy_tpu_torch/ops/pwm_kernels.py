"""The motif scan's hand-written CUDA kernel (csrc/pwm.cu): wrapper,
launch count and plain PyTorch version.

The wrapper takes a tensor on the CPU to its plain version and, for a
CUDA tensor, launches its kernel or raises: there is no fallback.  The
kernel is built with nvcc at first launch (ops/_build.py) and bound with
ctypes; importing this module needs no compiler and no card.

pwm_scores_kernel -- replaces the Pallas `_pwm_block_kernel`
    (bionumpy_tpu/ops/pallas_pwm.py:32, via pallas_pwm_scores_packed)
    and the XLA offset scan the JAX pipeline runs in its place
    (bionumpy_tpu/ops/pwm.py:35 pwm_scores_packed).  The float32 score
    sum_j matrix[code(p + j), j] at every position p of a packed batch,
    accumulated in the order j = 0..w-1 from 0.0, so kernel, plain
    version and both JAX functions agree bit for bit; -inf cells flow
    through.  Windows that cross a row end score over the next row's
    codes and are trimmed by the caller (ops/pwm.pwm_match_compact), or
    by the kernel itself in match mode.
    Bound by bytes at w = 11: at one full batch of 2^25 positions it
    reads 8.4 MB of words and writes 134 MB of scores, ~43 us at
    3.35 TB/s.  Its first design (one thread per position, a runtime
    window, the matrix reloaded by each of 131,072 blocks) ran at 5.1x
    that bound on an NVIDIA H100 80GB HBM3 at 700 W.  Design now: one
    kernel per window 1..32 (a template), so the offset loop unrolls
    with constant shifts; a persistent grid loads the matrix into shared
    memory once per block, indexed [j][code]; a lane scores four
    consecutive positions and writes them as one evict-first float4.
    On that card it takes 0.063 ms at w = 11, 1.5x its bound, against
    0.052 ms for fill_ over the same bytes, and 0.154 ms at w = 32
    (chip_smoke.py).  Its plain version
    unpacks every code and adds one gathered matrix column per offset
    (the JAX package's XLA formulation), so the two cross-check two
    methods.

    Match mode (pwm_matches; no TPU kernel: the JAX package compacts
    with XLA ops after the scores, bionumpy_tpu/ops/pwm.py
    pwm_match_compact): the same kernel scores each position in the same
    order, then keeps the positions whose score is strictly above the
    float32 threshold and whose window lies inside its row, and writes
    them (plus a base) through one atomicAdd a warp, in no fixed order;
    neither scores nor masks reach memory.  Its matches are those of
    scores mode followed by pwm_match_compact, bit for bit, because the
    scores are.  Bound by operations at w = 19 (3.26 ms over the
    2,077,042,982 positions of hg38's chr1-12 at 67 T/s); on an NVIDIA
    H100 80GB HBM3 at 700 W it takes 5.3 ms there, against 255 ms for
    scores mode and the torch-op compaction in blocks of 2^27
    positions.  Its plain version composes pwm_scores_plain,
    valid_windows_plain and the threshold, and lists the matches in
    position order.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import _build
from .kmer_kernels import (WORD_BASES, _check_ends, _check_launch, _on_card,
                           valid_windows_plain)

MAX_WINDOW = 32  # a window spans at most three consecutive words

_SOURCE = os.path.join(_build.CSRC, "pwm.cu")

# launches since the last reset_launches(), each mode of the kernel under
# its own key; the wrappers count where they launch and nowhere else
LAUNCHES = {"pwm_scores_kernel": 0, "pwm_scores_kernel.match": 0}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> ctypes.CDLL:
    """The kernel's library, compiled (if stale) and loaded once."""
    global _lib
    if _lib is None:
        path = _build.build("pwm", [_SOURCE],
                            [_build.nvcc()] + _build.NVCC_FLAGS,
                            headers=(_build.SPAN_HEADER,))
        lib = ctypes.CDLL(path)
        vp = ctypes.c_void_p
        lib.pwm_scores_launch.restype = ctypes.c_int
        lib.pwm_scores_launch.argtypes = [vp, ctypes.c_longlong, vp,
                                          ctypes.c_int, vp, vp]
        lib.pwm_matches_launch.restype = ctypes.c_int
        lib.pwm_matches_launch.argtypes = [
            vp, ctypes.c_longlong, vp, ctypes.c_int, ctypes.c_longlong, vp,
            ctypes.c_int, ctypes.c_float, ctypes.c_longlong,
            ctypes.c_longlong, vp, vp, vp]
        _lib = lib
    return _lib


def _n_positions(words: torch.Tensor, matrix: torch.Tensor,
                 window: int) -> int:
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"window must lie in 1..{MAX_WINDOW}, got {window}")
    if words.dtype != torch.int32 or words.dim() != 1 or \
            not words.is_contiguous() or words.numel() < 2:
        raise ValueError("words must be a contiguous 1-D int32 tensor of "
                         "packed words plus two halo words")
    if matrix.dtype != torch.float32 or \
            tuple(matrix.shape) != (4, window) or \
            not matrix.is_contiguous() or matrix.device != words.device:
        raise ValueError(f"matrix must be a contiguous (4, {window}) "
                         f"float32 tensor on the words' device")
    return (words.numel() - 2) * WORD_BASES


def unpack_codes(words: torch.Tensor) -> torch.Tensor:
    """int64 2-bit code of every base of the packed words, halo words
    included.  Words are widened to int64 and masked first, because `>>`
    on int32 sign-extends."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = torch.arange(0, 2 * WORD_BASES, 2, device=words.device)
    return ((w[:, None] >> bits) & 3).reshape(-1)


def pwm_scores_plain(words: torch.Tensor, matrix: torch.Tensor,
                     window: int) -> torch.Tensor:
    """Plain PyTorch version of pwm_scores_kernel."""
    n_positions = _n_positions(words, matrix, window)
    codes = unpack_codes(words)
    scores = torch.zeros(n_positions, dtype=torch.float32,
                         device=words.device)
    for j in range(window):
        scores = scores + matrix[:, j][codes[j: j + n_positions]]
    return scores


def pwm_scores(words: torch.Tensor, matrix: torch.Tensor,
               window: int) -> torch.Tensor:
    """float32 PWM score of every window position of a packed batch.

    `words`: int32 view of the packed uint32 words (n_positions/16 + 2);
    `matrix`: (4, window) float32 log-likelihoods on the words' device,
    1 <= window <= 32."""
    n_positions = _n_positions(words, matrix, window)
    if not _on_card(words):
        return pwm_scores_plain(words, matrix, window)
    out = torch.empty(n_positions, dtype=torch.float32, device=words.device)
    lib = build()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check_launch(lib.pwm_scores_launch(
            words.data_ptr(), n_positions, matrix.data_ptr(), window,
            out.data_ptr(), stream), "pwm_scores_kernel")
    LAUNCHES["pwm_scores_kernel"] += 1
    return out


def pwm_matches_plain(words: torch.Tensor, ends: torch.Tensor, n_true: int,
                      matrix: torch.Tensor, window: int, threshold: float,
                      cap: int, base: int = 0):
    """Plain PyTorch version of pwm_scores_kernel's match mode: the scores
    of pwm_scores_plain, the row-end mask of valid_windows_plain, the
    float32 threshold, then the matches in position order."""
    n_positions = _n_positions(words, matrix, window)
    scores = pwm_scores_plain(words, matrix, window)
    hit = valid_windows_plain(ends, n_positions, window, n_true) & \
        (scores > float(np.float32(threshold)))
    found = torch.nonzero(hit).flatten()[:cap]
    out = torch.zeros(min(cap, n_positions), dtype=torch.int64,
                      device=words.device)
    out[: found.numel()] = found + base
    return out, hit.sum()


def pwm_matches(words: torch.Tensor, ends: torch.Tensor, n_true: int,
                matrix: torch.Tensor, window: int, threshold: float,
                cap: int, base: int = 0):
    """The positions p of a packed batch whose float32 score (pwm_scores')
    is strictly above float32(threshold) and whose window [p, p + window)
    lies inside its row, below min(ends[-1], n_true), plus `base`: one
    launch of pwm_scores_kernel in match mode, which stores no score and
    no mask.  `ends`: int32 cumulative row ends on the words' device.
    Returns (int64 positions, min(cap, n_positions) slots; n_matches,
    an int64 device scalar that counts every match, those past cap
    too).  When n_matches <= cap the first n_matches slots hold them,
    in position order in the plain version and in no fixed order on the
    card; past cap the card's slots hold some cap of them and the plain
    version's the first cap."""
    n_positions = _n_positions(words, matrix, window)
    _check_ends(ends, words)
    if cap < 0:
        raise ValueError(f"cap must not be negative, got {cap}")
    if not _on_card(words):
        return pwm_matches_plain(words, ends, n_true, matrix, window,
                                 threshold, cap, base)
    out = torch.empty(min(cap, n_positions), dtype=torch.int64,
                      device=words.device)
    count = torch.zeros((), dtype=torch.int64, device=words.device)
    lib = build()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check_launch(lib.pwm_matches_launch(
            words.data_ptr(), n_positions, ends.data_ptr(), ends.numel(),
            int(n_true), matrix.data_ptr(), window,
            float(np.float32(threshold)), int(base), out.numel(),
            count.data_ptr(), out.data_ptr(), stream),
            "pwm_scores_kernel")
    LAUNCHES["pwm_scores_kernel.match"] += 1
    return out, count
