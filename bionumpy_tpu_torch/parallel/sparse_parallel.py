"""Sparse k-mer, minimizer and motif steps over a device mesh (the port of
bionumpy_tpu/parallel/sparse_parallel.py).

Each shard compacts its packed reads to a sentinel-padded (key, count)
table on its own device (kernel 1 through ops/kmers or ops/minimizers),
the tables are gathered to the lead device and merged there with
ops/kmers.merge_hash_tables: one sort of the concatenated keys with the
counts as payload, run detection, and per-run totals from a
cumulative-sum difference.  This is the device twin of SparseEncodedCounts.__add__, the
associative fold the reference applies per chunk (reference:
bionumpy/streams/reductions.py:6-23), lifted to the mesh axis.

Keys are the port's int64 hashes with the sentinel 2^63-1 and counts are
int64 (the JAX package carries (lo, hi) uint32 limbs and int32 counts),
so the merge's cumulative sum cannot overflow.  Steps take per-shard
tensors (parallel/mesh.put_sharded) and host ints for the shards' true
base counts; replicated outputs come back on the lead device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kmers import (WORD_BASES, kmer_sentinel_table_packed,
                         merge_hash_tables)
from ..ops.minimizers import minimizer_sentinel_table_packed
from ..ops.pwm_kernels import pwm_matches
from .mesh import Mesh, all_gather, pmax, psum

__all__ = ["merge_hash_tables", "sharded_sparse_count_step",
           "sharded_sparse_count_fold_step",
           "sharded_minimizer_count_fold_step", "sharded_pwm_match_step",
           "shard_packed_reads", "host_merge_check"]


def _local_table(words, ends, n_true, k: int, cap: int):
    """Per-shard (keys, counts, meta) table, sentinel-padded to
    min(cap, positions) rows; meta is (2,) int64 [n_unique, n_valid]
    (kernel 1, then ops/kmers.sentinel_table: the sort and the run
    table)."""
    return kmer_sentinel_table_packed(words, ends, k, int(n_true), cap)


def _local_minimizer_table(words, ends, n_true, k: int, n_kmers: int,
                           cap: int):
    """Per-shard (keys, counts, meta) MINIMIZER table: one count per valid
    window, as count_encoded(get_minimizers(...)) counts."""
    return minimizer_sentinel_table_packed(words, ends, int(n_true), k,
                                           n_kmers, cap)


def _gathered(mesh: Mesh, tables):
    """The shards' tables gathered to the lead device: (keys, counts,
    max n_unique, total n_valid)."""
    keys = all_gather(mesh, [t[0] for t in tables])
    cnt = all_gather(mesh, [t[1] for t in tables])
    max_u = pmax(mesh, [t[2][0] for t in tables])
    tot_v = psum(mesh, [t[2][1] for t in tables])
    return keys, cnt, max_u, tot_v


def sharded_sparse_count_step(mesh: Mesh, k: int, cap: int,
                              cap_out: int = None):
    """Multi-device step: per-shard packed words/ends/n_true in, merged
    (keys, counts, n_unique) out on the lead device, cap_out rows
    (default cap * shards)."""
    if cap_out is None:
        cap_out = cap * mesh.devices.size

    def step(words, ends, n_true):
        tables = [_local_table(w, e, n, k, cap)
                  for w, e, n in zip(words, ends, n_true)]
        keys, cnt, _, _ = _gathered(mesh, tables)
        return merge_hash_tables(keys, cnt, cap_out)

    return step


def _fold_step(mesh: Mesh, local, acc_cap: int):
    """step(acc, meta_acc, words, ends, n_true) -> (new acc, new meta_acc,
    n_unique): the shards' tables merged WITH the (keys, counts)
    accumulator on the lead device, and the meta accumulator (int64,
    [max_unique, n_valid, ...]) folded across the shards: the maximum of
    their n_unique, the sum of their n_valid."""

    def step(acc, meta_acc, words, ends, n_true):
        tables = [local(w, e, n) for w, e, n in zip(words, ends, n_true)]
        keys, cnt, max_u, tot_v = _gathered(mesh, tables)
        meta_acc = torch.cat([torch.stack([torch.maximum(meta_acc[0], max_u),
                                           meta_acc[1] + tot_v]),
                              meta_acc[2:]])
        m_keys, m_cnt, n_u = merge_hash_tables(
            torch.cat([acc[0], keys]), torch.cat([acc[1], cnt]), acc_cap)
        return (m_keys, m_cnt), meta_acc, n_u

    return step


def sharded_sparse_count_fold_step(mesh: Mesh, k: int, cap: int,
                                   acc_cap: int):
    """Multi-device ACCUMULATING step of the streamed k-mer pipeline
    (pipeline.count_kmers_fastq(mesh=...)): per-shard packed batch in,
    per-shard tables counted locally, gathered and merged with the
    acc_cap-row accumulator; nothing crosses to the host."""
    return _fold_step(mesh, lambda w, e, n: _local_table(w, e, n, k, cap),
                      acc_cap)


def sharded_minimizer_count_fold_step(mesh: Mesh, k: int, window_size: int,
                                      cap: int, acc_cap: int):
    """Multi-device ACCUMULATING minimizer-count step of
    pipeline.count_minimizers_fastq(mesh=...): the shape and merge of
    sharded_sparse_count_fold_step with the windowed-min local table.
    The fold is exact because distinct-minimizer tables merge with the
    same associative (hash, count) sum (reference:
    bionumpy/streams/reductions.py:6-23,
    bionumpy/sequence/minimizers.py:8-54)."""
    n_kmers = window_size - k + 1
    return _fold_step(
        mesh, lambda w, e, n: _local_minimizer_table(w, e, n, k, n_kmers,
                                                     cap), acc_cap)


def sharded_pwm_match_step(mesh: Mesh, window_size: int, cap: int):
    """Multi-device PWM scan step: step(words, ends, n_true, matrix,
    threshold) -> (positions, n_matches, total).  Every shard scores its
    reads and compacts its match positions on its device (kernel 3 in
    match mode, ops/pwm_kernels.pwm_matches: on the card in no fixed
    order); matches are read-local, so `positions` (int64, min(cap,
    positions) rows) and `n_matches` (int64 scalars) stay per shard, one
    list entry a shard, and `total` is their sum on the lead device."""

    def step(words, ends, n_true, matrix, threshold):
        pos, n_matches = [], []
        for w, e, n in zip(words, ends, n_true):
            p, nm = pwm_matches(
                w, e, int(n), matrix.to(w.device, torch.float32).contiguous(),
                window_size, threshold, cap)
            pos.append(p)
            n_matches.append(nm)
        return pos, n_matches, psum(mesh, n_matches)

    return step


def shard_packed_reads(flat_codes: np.ndarray, lengths: np.ndarray,
                       n_shards: int, min_bucket: int = 1 << 10):
    """Host-side: split a ragged chunk on row boundaries into n_shards
    equal-bucket PACKED shards.  Returns (words (n, W+2) uint32,
    ends (n, R) int32, n_true (n,) int32) ready for put_sharded (words
    viewed as int32) — the packed twin of kmer_parallel.shard_flat_codes."""
    from ..native import pack_2bit_fill
    from ..ops.device import bucket_size

    offsets = np.insert(np.cumsum(lengths, dtype=np.int64), 0, 0)
    targets = (np.arange(1, n_shards) * offsets[-1]) // n_shards
    split_rows = np.searchsorted(offsets, targets)
    row_bounds = np.concatenate([[0], split_rows, [len(lengths)]])
    base_lens = [int(offsets[row_bounds[i + 1]] - offsets[row_bounds[i]])
                 for i in range(n_shards)]
    bucket = bucket_size(max(max(base_lens), 1), min_bucket)
    n_words = bucket // WORD_BASES + 2
    max_rows = max(int(row_bounds[i + 1] - row_bounds[i])
                   for i in range(n_shards))
    rows_bucket = bucket_size(max(max_rows, 1), 16)
    words = np.zeros((n_shards, n_words), dtype=np.uint32)
    ends = np.zeros((n_shards, rows_bucket), dtype=np.int32)
    n_true = np.zeros(n_shards, dtype=np.int32)
    for i in range(n_shards):
        a, b = int(row_bounds[i]), int(row_bounds[i + 1])
        part = flat_codes[offsets[a]: offsets[b]]
        words[i] = pack_2bit_fill(part, n_words * 4).view(np.uint32)
        e = np.cumsum(lengths[a:b], dtype=np.int64).astype(np.int32)
        ends[i, : len(e)] = e
        ends[i, len(e):] = e[-1] if len(e) else 0
        n_true[i] = len(part)
    return words, ends, n_true


def host_merge_check(flat_codes: np.ndarray, lengths: np.ndarray, k: int):
    """Independent host recompute of the sparse counts (for tests and
    the mesh checks on the card)."""
    codes = flat_codes.astype(np.uint64)
    ends = np.cumsum(lengths)
    dist = np.repeat(ends, lengths) - np.arange(len(codes))
    hashes = np.zeros(len(codes), dtype=np.uint64)
    for j in range(k):
        idx = np.arange(len(codes) - j)
        hashes[idx] |= codes[idx + j] << np.uint64(2 * j)
    valid = dist >= k
    return np.unique(hashes[valid], return_counts=True)
