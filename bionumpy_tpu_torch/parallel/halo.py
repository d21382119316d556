"""Sequence-parallel rolling windows over ONE long sequence: the halo
exchange (the port of bionumpy_tpu/parallel/halo.py).

Row-aligned sharding (kmer_parallel/sparse_parallel) cannot split a
single chromosome-scale sequence; here the flat base axis itself is
sharded contiguously over the mesh and each shard receives the FIRST
`halo` bases of its successor (JAX's ppermute with perm
[((i + 1) % n, i)]: the last shard receives shard 0's), so windows that
straddle a shard edge are computed locally, exactly like the reference's
chunk boundary carry on the host (reference: bionumpy/io/parser.py:
160-165, sequence/rollable.py:57-69).

Each shard packs its block and the halo into 2-bit words as one row and
runs kernel 1 (ops/kmer_kernels.kmer_keys) over it: every window that
starts inside the block fits the row, so its key is the hash, equal to
lo | hi << 32 of the JAX package's limbs; the minimizer step takes the
windowed min of those keys (ops/minimizers).  Validity comes from the
GLOBAL position, so the sharded result equals the single-shard one.
Steps return per-shard lists of (lo, hi) int64 limbs below 2^32 and
bool validity, one entry a shard.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kmer_kernels import kmer_keys
from ..ops.kmers import WORD_BASES, pack_codes
from ..ops.minimizers import _doubling_min
from .mesh import Mesh, ppermute

__all__ = ["shard_long_sequence", "sharded_kmer_hash_step",
           "sharded_minimizer_step"]


def _halo_len(window_size: int) -> int:
    """Smallest multiple of 16 that is >= window_size - 1."""
    need = max(window_size - 1, 1)
    return ((need + WORD_BASES - 1) // WORD_BASES) * WORD_BASES


def shard_long_sequence(codes: np.ndarray, n_shards: int,
                        window_size: int = None):
    """Host-side: pad one flat code vector to (n_shards, L) with L a
    multiple of 16.  Returns (blocks, n_true).

    Pass `window_size` to enforce L >= halo: a shard shorter than the
    halo would receive too few bases from its successor and windows
    spanning MORE than one shard boundary would silently hash over
    missing data (only reachable with tiny inputs on wide meshes)."""
    n = len(codes)
    per = -(-n // n_shards)
    per = ((per + WORD_BASES - 1) // WORD_BASES) * WORD_BASES
    if window_size is not None and per < _halo_len(window_size):
        raise ValueError(
            f"per-shard length {per} is smaller than the "
            f"{_halo_len(window_size)}-base halo for window size "
            f"{window_size}: use fewer shards for this input")
    blocks = np.zeros((n_shards, per), dtype=np.uint8)
    flat = blocks.reshape(-1)
    flat[:n] = codes
    return blocks, n


def _extended_row(codes: torch.Tensor, recv: torch.Tensor):
    """(int32 packed words, row ends) of the block followed by the
    received halo, as one row: kernel 1's input."""
    n = codes.numel() + recv.numel()
    words = pack_codes(torch.cat([codes, recv]), n)
    return words, torch.tensor([n], dtype=torch.int32, device=codes.device)


def _exchanged(mesh: Mesh, blocks, halo: int):
    """Each shard's block with the first `halo` codes of its successor."""
    n_dev = mesh.devices.size
    for b in blocks:
        if b.numel() < halo:
            raise ValueError(f"shard length {b.numel()} < halo {halo}: "
                             f"fewer shards needed")
    perm = [((i + 1) % n_dev, i) for i in range(n_dev)]
    return zip(blocks, ppermute(mesh, [b[:halo] for b in blocks], perm))


def _limbs_and_valid(keys, i: int, L: int, n_true: int, window: int):
    keys = keys[:L]
    gpos = i * L + torch.arange(L, device=keys.device)
    return keys & 0xFFFFFFFF, keys >> 32, gpos <= n_true - window


def sharded_kmer_hash_step(mesh: Mesh, k: int):
    """step(blocks, n_true) -> per-shard lists (lo, hi, valid): the hash
    limbs of EVERY global position of (n_shards, L) contiguous code
    blocks (one tensor a shard), the halo exchanged between shards."""
    halo = _halo_len(k)

    def step(blocks, n_true):
        out = ([], [], [])
        for i, (codes, recv) in enumerate(_exchanged(mesh, blocks, halo)):
            words, ends = _extended_row(codes, recv)
            keys = kmer_keys(words, ends, k)
            for part, t in zip(out, _limbs_and_valid(
                    keys, i, codes.numel(), int(n_true), k)):
                part.append(t)
        return out

    return step


def sharded_minimizer_step(mesh: Mesh, k: int, window_size: int):
    """step(blocks, n_true) -> per-shard lists (lo, hi, valid):
    minimizers (the least k-mer hash of each window of `window_size`
    bases, reference: bionumpy/sequence/minimizers.py) over one long
    sharded sequence."""
    n_kmers = window_size - k + 1
    if n_kmers < 1:
        raise ValueError(f"k={k} exceeds window_size={window_size}")
    halo = _halo_len(window_size)

    def step(blocks, n_true):
        out = ([], [], [])
        for i, (codes, recv) in enumerate(_exchanged(mesh, blocks, halo)):
            words, ends = _extended_row(codes, recv)
            mins = _doubling_min(kmer_keys(words, ends, k), n_kmers)
            for part, t in zip(out, _limbs_and_valid(
                    mins, i, codes.numel(), int(n_true), window_size)):
                part.append(t)
        return out

    return step
