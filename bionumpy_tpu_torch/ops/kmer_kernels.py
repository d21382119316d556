"""The k-mer path's hand-written CUDA kernels (csrc/kmers.cu): wrappers,
launch counts and plain PyTorch versions.

Each wrapper takes a tensor on the CPU to its plain version and, for a
CUDA tensor, launches its kernel or raises: there is no fallback.  The
kernels are built with nvcc at first launch (ops/_build.py) and bound
with ctypes; importing this module needs no compiler and no card.

kmer_keys_kernel -- replaces the Pallas `_kmer_block_kernel`
    (bionumpy_tpu/ops/pallas_kmers.py:32, via pallas_kmer_hashes) and the
    XLA validity pass of kmer_sorted_runs_packed
    (bionumpy_tpu/ops/kmers.py:312-320).  One int64 key per position: the
    2k-bit window hash where the window lies inside its row and below
    min(ends[-1], n_true), the sentinel 2^63-1 elsewhere (above every
    k <= 31 hash, so invalid slots sort last).  Bound by bytes: at one
    full batch of 2^25 positions it reads 8.4 MB of words and writes
    268 MB of keys, ~83 us at 3.35 TB/s.  Its first design (one thread
    per position, each with a binary search over the row ends) ran at
    5.3x that bound on an NVIDIA H100 80GB HBM3 at 700 W, held back by
    the searches' dependent loads.  Design now: a warp owns a span of
    512 positions, finds the span's row once by a warp-wide 32-way
    search, and each lane walks the row ends forward (galloping over
    runs of empty or one-base rows); a lane writes two keys as one
    coalesced evict-first 16-byte store, and a persistent grid walks the
    spans.  On that card it takes 0.107 ms at k = 31, 1.3x its bound,
    against 0.094 ms for fill_ over the same bytes (chip_smoke.py).  Its
    plain version derives validity the way JAX does (row-end marks +
    cumsum), so the two cross-check two methods.  Its canonical mode
    (`canonical=True`, its own instance and launch count) keys each valid
    window by the lesser of its hash and its reverse complement's, the
    codes 3 - c in reverse order: in the kernel a bit reversal of the
    complemented key, in the plain version one 2-bit digit at a time.

kmer_fullsum_kernel -- replaces the Pallas `_fullsum_kernel`
    (bionumpy_tpu/ops/pallas_kmers.py:63, via pallas_fullsum_packed): the
    sums mod 2^32 of the low and the high 32 bits of every window hash,
    validity ignored.  Bound by bytes: 8.4 MB of words per full batch
    (~2.5 us at 3.35 TB/s).  Summed over the positions, each code counts
    with a weight fixed by k, (4^min(k,16) - 1)/3 in the low limb and
    (4^(k-16) - 1)/3 in the high one, except the k-1 codes at either end;
    so the kernel sums the codes (popcounts over 16-byte loads) and one
    warp adds the edge codes with their own weights, then one atomic
    pair per block.  On an NVIDIA H100 80GB HBM3 at 700 W it takes 3.2 us
    of device time at 2^25 positions (1.3x its bound) and 2.0 us over a
    2^22-position checksum chunk; its first design (a thread per
    position, three word loads each, an atomic pair per warp) took 53 us.
    Its plain version sums the windows one by one, so the card tests
    hold the closed form against the direct sum.
"""
from __future__ import annotations

import ctypes
import os

import torch

from . import _build

WORD_BASES = 16  # 2-bit bases per uint32 word
SENTINEL = (1 << 63) - 1  # key of an invalid window
MAX_K = 31

_SOURCE = os.path.join(_build.CSRC, "kmers.cu")

# launches per kernel since the last reset_launches(); a wrapper counts
# where it launches its kernel and nowhere else
LAUNCHES = {"kmer_keys_kernel": 0, "kmer_keys_kernel.canonical": 0,
            "kmer_fullsum_kernel": 0}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> ctypes.CDLL:
    """The kernels' library, compiled (if stale) and loaded once."""
    global _lib
    if _lib is None:
        path = _build.build("kmers", [_SOURCE],
                            [_build.nvcc()] + _build.NVCC_FLAGS,
                            headers=(_build.SPAN_HEADER,))
        lib = ctypes.CDLL(path)
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        for launch in (lib.kmer_keys_launch, lib.kmer_keys_canonical_launch):
            launch.restype = ctypes.c_int
            launch.argtypes = [vp, vp, ctypes.c_int, ll, ll, ctypes.c_int,
                               vp, vp]
        lib.kmer_fullsum_launch.restype = ctypes.c_int
        lib.kmer_fullsum_launch.argtypes = [vp, ll, ctypes.c_int, vp, vp]
        _lib = lib
    return _lib


def _n_positions(words: torch.Tensor, k: int) -> int:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must lie in 1..{MAX_K}, got {k}")
    if words.dtype != torch.int32 or words.dim() != 1 or \
            not words.is_contiguous() or words.numel() < 2:
        raise ValueError("words must be a contiguous 1-D int32 tensor of "
                         "packed words plus two halo words")
    return (words.numel() - 2) * WORD_BASES


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def _check_ends(ends: torch.Tensor, words: torch.Tensor) -> None:
    if ends.dtype != torch.int32 or ends.dim() != 1 or \
            not ends.is_contiguous() or ends.device != words.device:
        raise ValueError("ends must be a contiguous 1-D int32 tensor on "
                         "the words' device")


def _check_launch(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def window_limbs_plain(words: torch.Tensor, k: int):
    """(lo, hi) int64 tensors, each below 2^32: bits 0-31 and 32-63 of
    the 2k-bit hash of every window position (JAX's _window_limbs).
    Words are widened to int64 and masked first, because `>>` on int32
    sign-extends."""
    n_positions = _n_positions(words, k)
    return limbs_at(words, torch.arange(n_positions, device=words.device), k)


def limbs_at(words: torch.Tensor, pos: torch.Tensor, k: int):
    """(lo, hi) as window_limbs_plain gives them, at the window starts
    `pos` (any shape, each below n_positions) only."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    wi = pos >> 4
    bit = (pos & 15) * 2
    p0, p1, p2 = w[wi], w[wi + 1], w[wi + 2]
    inside = bit == 0
    inv = 32 - bit
    lo = torch.where(inside, p0, ((p0 >> bit) | (p1 << inv)) & 0xFFFFFFFF)
    hi = torch.where(inside, p1, ((p1 >> bit) | (p2 << inv)) & 0xFFFFFFFF)
    if k <= 16:
        return lo & ((1 << (2 * k)) - 1), torch.zeros_like(lo)
    return lo, hi & ((1 << (2 * (k - 16))) - 1)


def valid_windows_plain(ends: torch.Tensor, n_positions: int, k: int,
                        n_true: int, offset: int = 0) -> torch.Tensor:
    """Bool per position offset .. offset + n_positions - 1: the window
    starting there lies inside its row and below min(ends[-1], n_true).
    JAX's formulation (bionumpy_tpu/ops/kmers.py:315-320): a window at p
    is invalid iff p lies in [e-k+1, e) for a row end e, found with
    +1/-1 marks at the row ends (clipped to the positions) and a
    cumulative sum.  `ends` may leave out rows that end before `offset`
    and rows that start past the last window's end."""
    device = ends.device
    if ends.numel() == 0:
        return torch.zeros(n_positions, dtype=torch.bool, device=device)
    e = ends.to(torch.int64) - offset
    one = torch.ones_like(e, dtype=torch.int32)
    marks = torch.zeros(n_positions + 1, dtype=torch.int32, device=device)
    marks.index_add_(0, torch.clamp(e - (k - 1), 0, n_positions), one)
    marks.index_add_(0, torch.clamp(e, 0, n_positions), -one)
    invalid = torch.cumsum(marks[:-1], 0)
    pos = torch.arange(n_positions, device=device)
    return (invalid == 0) & (pos < torch.clamp(e[-1], max=n_true - offset))


def _reverse_complement_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The key of the reverse complement of each k-mer key (base j in bits
    2j..2j+1): digit j of the result is 3 less digit k-1-j of the key."""
    out = torch.zeros_like(keys)
    for j in range(k):
        out |= (3 - ((keys >> (2 * (k - 1 - j))) & 3)) << (2 * j)
    return out


def kmer_keys_plain(words: torch.Tensor, ends: torch.Tensor, k: int,
                    n_true: int = None,
                    canonical: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kmer_keys_kernel."""
    n_positions = _n_positions(words, k)
    if n_true is None:
        n_true = n_positions
    lo, hi = window_limbs_plain(words, k)
    keys = lo | (hi << 32)
    if canonical:
        keys = torch.minimum(keys, _reverse_complement_keys(keys, k))
    valid = valid_windows_plain(ends, n_positions, k, n_true)
    return torch.where(valid, keys, SENTINEL)


def kmer_keys(words: torch.Tensor, ends: torch.Tensor, k: int,
              n_true: int = None, canonical: bool = False) -> torch.Tensor:
    """int64 sort key of every window position of a packed batch.

    `words`: int32 view of the packed uint32 words (n_positions/16 + 2);
    `ends`: int32 cumulative row ends, padding rows repeating the last
    end; `n_true`: the real base count (None = every position);
    `canonical`: a valid window's key is the lesser of its hash and its
    reverse complement's."""
    n_positions = _n_positions(words, k)
    _check_ends(ends, words)
    if n_true is None:
        n_true = n_positions
    if not _on_card(words):
        return kmer_keys_plain(words, ends, k, n_true, canonical)
    keys = torch.empty(n_positions, dtype=torch.int64, device=words.device)
    lib = build()
    launch, name = ((lib.kmer_keys_canonical_launch,
                     "kmer_keys_kernel.canonical") if canonical else
                    (lib.kmer_keys_launch, "kmer_keys_kernel"))
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check_launch(launch(
            words.data_ptr(), ends.data_ptr(), ends.numel(), n_positions,
            int(n_true), k, keys.data_ptr(), stream), name)
    LAUNCHES[name] += 1
    return keys


def kmer_fullsum_plain(words: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of kmer_fullsum_kernel."""
    lo, hi = window_limbs_plain(words, k)
    return torch.stack([lo.sum(), hi.sum()]) & 0xFFFFFFFF


def kmer_fullsum(words: torch.Tensor, k: int) -> torch.Tensor:
    """(2,) int64 [lo_sum, hi_sum], each mod 2^32, over every window
    position of the packed words (validity ignored)."""
    n_positions = _n_positions(words, k)
    if not _on_card(words):
        return kmer_fullsum_plain(words, k)
    out = torch.zeros(2, dtype=torch.int32, device=words.device)
    lib = build()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check_launch(lib.kmer_fullsum_launch(
            words.data_ptr(), n_positions, k, out.data_ptr(), stream),
            "kmer_fullsum_kernel")
    LAUNCHES["kmer_fullsum_kernel"] += 1
    return out.to(torch.int64) & 0xFFFFFFFF
