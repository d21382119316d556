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
    codes and are trimmed by the caller (ops/pwm.pwm_match_compact).
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
"""
from __future__ import annotations

import ctypes
import os

import torch

from . import _build
from .kmer_kernels import WORD_BASES, _check_launch, _on_card

MAX_WINDOW = 32  # a window spans at most three consecutive words

_SOURCE = os.path.join(_build.CSRC, "pwm.cu")

# launches since the last reset_launches(); the wrapper counts where it
# launches its kernel and nowhere else
LAUNCHES = {"pwm_scores_kernel": 0}

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
