"""Dense data-parallel k-mer counting over a device mesh (the port of
bionumpy_tpu/parallel/kmer_parallel.py).

Each shard holds a slice of the flat code buffer (with its own
distance-to-row-end vector, so windows never cross shard boundaries —
file shards are split on entry boundaries by the host reader exactly as
the reference carries incomplete entries between chunks,
reference: bionumpy/io/parser.py:160-165).  Per-shard partial counts
are merged with psum on the lead device — the twin of the reference's
stream-reduction combiners (bionumpy/streams/reductions.py:6-23).
Counts are int64 where the JAX package has int32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kmers import count_keys, kmer_hash_limbs
from .mesh import Mesh, psum

__all__ = ["parallel_count_kmers", "parallel_composition",
           "sharded_pipeline_step", "shard_flat_codes"]


def _local_count(codes, dist, k: int, n_counts: int):
    lo, _ = kmer_hash_limbs(codes, k)
    valid = dist[: lo.numel()] >= k
    return count_keys(torch.where(valid, lo, n_counts), n_counts)


def _local_composition(codes, dist, n_symbols: int):
    codes = codes[: dist.numel()].to(torch.int64)
    return count_keys(torch.where(dist >= 1, codes, n_symbols), n_symbols)


def parallel_count_kmers(mesh: Mesh, codes_sharded, dist_sharded, k: int,
                         n_counts: int) -> torch.Tensor:
    """codes_sharded: per-shard (shard_len + 32,) uint8 code tensors;
    dist_sharded: per-shard (shard_len,) int32.  Returns the merged
    counts (n_counts,) on the lead device."""
    return psum(mesh, [_local_count(c, d, k, n_counts)
                       for c, d in zip(codes_sharded, dist_sharded)])


def parallel_composition(mesh: Mesh, codes_sharded, dist_sharded,
                         n_symbols: int = 4) -> torch.Tensor:
    """Per-symbol composition counts merged over the mesh."""
    return psum(mesh, [_local_composition(c, d, n_symbols)
                       for c, d in zip(codes_sharded, dist_sharded)])


def sharded_pipeline_step(mesh: Mesh, k: int, n_counts: int,
                          n_symbols: int = 4):
    """The full multi-device step: per-shard codes and distances in,
    merged (kmer_counts, composition, n_valid_kmers) out on the lead
    device."""

    def step(codes_sharded, dist_sharded):
        counts, comp, n_kmers = [], [], []
        for codes, dist in zip(codes_sharded, dist_sharded):
            counts.append(_local_count(codes, dist, k, n_counts))
            comp.append(_local_composition(codes, dist, n_symbols))
            n_kmers.append((dist >= k).sum())
        return psum(mesh, counts), psum(mesh, comp), psum(mesh, n_kmers)

    return step


def shard_flat_codes(flat_codes, lengths, n_shards: int):
    """Host-side: split a ragged chunk into n_shards row-aligned shards of
    equal padded length; returns (codes (n,La+32), dist (n,La)) arrays."""
    from ..ops.device import distance_to_row_end

    offsets = np.insert(np.cumsum(lengths), 0, 0)
    targets = (np.arange(1, n_shards) * offsets[-1]) // n_shards
    split_rows = np.searchsorted(offsets, targets)
    row_bounds = np.concatenate([[0], split_rows, [len(lengths)]])
    dist_full = distance_to_row_end(np.asarray(lengths))
    shard_lens = [int(offsets[row_bounds[i + 1]] - offsets[row_bounds[i]])
                  for i in range(n_shards)]
    max_len = max(shard_lens + [16])
    padded = ((max_len + 15) // 16) * 16
    codes = np.zeros((n_shards, padded + 32), dtype=np.uint8)
    dist = np.zeros((n_shards, padded), dtype=np.int32)
    for i in range(n_shards):
        start = int(offsets[row_bounds[i]])
        stop = int(offsets[row_bounds[i + 1]])
        codes[i, : stop - start] = flat_codes[start:stop]
        dist[i, : stop - start] = dist_full[start:stop]
    return codes, dist
