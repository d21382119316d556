"""Mesh-level reduction algebra: the reference's stream-fold combiners
lifted onto the mesh axis with psum (the port of
bionumpy_tpu/parallel/reductions.py).

The reference folds per-chunk partials with four associative combiners
(reference: bionumpy/streams/reductions.py:6-23 — bincount pad-and-add,
histogram add, sum_and_n for mean — and the interval pileup,
bionumpy/arithmetics/intervals.py:137-163).  Each maps onto one
collective of parallel/mesh.py:

  bincount / composition   psum of fixed-width count vectors
                           (kmer_parallel.py)
  histogram                psum of per-shard bin counts
  sum_and_n (mean)         psum of (sum, n) pairs
  pileup                   psum of the +1/-1 boundary-diff vector, then
                           one cumulative sum on the lead device
  sparse kmer counts       gather + sorted merge (sparse_parallel.py)

Steps take lists of per-shard tensors (mesh.put_sharded) and return
their replicated results on the lead device.  Counts are int64 where the
JAX package has int32; pileups stay int32, as there.
"""
from __future__ import annotations

import torch

from ..ops.tracks import _scatter_add, binned_pileup
from .mesh import Mesh, psum

__all__ = ["sharded_histogram_step", "sharded_sum_and_n_step",
           "sharded_pileup_step", "sharded_binned_pileup_step"]


def sharded_histogram_step(mesh: Mesh, n_bins: int):
    """step(values, valid, edges) -> histogram counts (n_bins,) int64:
    the psum twin of np.histogram folding (reference:
    bionumpy/streams/reductions.py:17-23).  `edges`: (n_bins + 1,)."""

    def local(v, valid, edges):
        edges = edges.to(v.device)
        # np.histogram semantics: both edges of the last bin inclusive
        idx = torch.searchsorted(edges, v, right=True) - 1
        idx = torch.where(v == edges[-1], n_bins - 1, idx)
        idx = torch.where(valid & (idx >= 0) & (idx < n_bins), idx, n_bins)
        return torch.bincount(idx.reshape(-1), minlength=n_bins + 1)[:n_bins]

    def step(values, valid, edges):
        return psum(mesh, [local(v, m, edges) for v, m in zip(values, valid)])

    return step


def sharded_sum_and_n_step(mesh: Mesh):
    """step(values, valid) -> (sum, n): (sum, n) pairs psum-merged over
    the mesh — the mean combiner (reference:
    bionumpy/streams/reductions.py:27-57).  Each shard sums in float32
    (float64 for float64 values), then the shards' sums are added in
    shard order, so the float sum agrees with the JAX package's within
    float32 rounding, not bit for bit."""

    def local(v, valid):
        dtype = torch.float64 if v.dtype == torch.float64 else torch.float32
        return (torch.where(valid, v, torch.zeros_like(v)).to(dtype).sum(),
                valid.sum())

    def step(values, valid):
        parts = [local(v, m) for v, m in zip(values, valid)]
        return psum(mesh, [p[0] for p in parts]), \
            psum(mesh, [p[1] for p in parts])

    return step


def sharded_pileup_step(mesh: Mesh, n_positions: int):
    """step(starts, stops, valid) -> int32 depth (n_positions,): each shard
    scatters its +1/-1 boundary diff, psum merges the diffs, one cumsum
    makes the depth (the device twin of
    RunLength2dArray.from_intervals(...).sum(axis=0), reference:
    bionumpy/arithmetics/intervals.py:137-163)."""

    def local(starts, stops, valid):
        s_idx = torch.where(valid, starts, n_positions)
        e_idx = torch.where(valid, stops, n_positions)
        one = torch.ones((), dtype=torch.int32, device=starts.device)
        diff = _scatter_add(n_positions + 1, torch.cat([s_idx, e_idx]),
                            torch.cat([one.expand(s_idx.shape),
                                       (-one).expand(e_idx.shape)]))
        return diff[:-1]

    def step(starts, stops, valid):
        merged = psum(mesh, [local(s, e, m)
                             for s, e, m in zip(starts, stops, valid)])
        return torch.cumsum(merged, 0, dtype=torch.int32)

    return step


def sharded_binned_pileup_step(mesh: Mesh, n_bins: int, bin_size: int):
    """step(starts, stops, valid) -> int32 covered bases per bin: each
    shard computes its ops/tracks.binned_pileup partial, a psum merges
    them — the whole-genome pileup at genome scale without dense
    positions (reference algorithm:
    bionumpy/arithmetics/intervals.py:137-163)."""

    def step(starts, stops, valid):
        return psum(mesh, [binned_pileup(s, e, m, n_bins, bin_size)
                           for s, e, m in zip(starts, stops, valid)])

    return step
