"""Device k-mer counting core (the port of the main-path subset of
bionumpy_tpu/ops/kmers.py).

A window's 2k-bit hash is one int64 key, not the JAX package's two
uint32 limbs (the TPU has no int64).  Invalid windows carry the sentinel
2^63-1, above every k <= 31 hash, so a plain sort pushes them past every
real key.  A batch is counted by: kmer_keys (ops/kmer_kernels.py) ->
torch.sort -> run detection -> compaction of the run heads to the front
of a `cap`-row table -> counts from the run-start differences.

Everything here stays asynchronous on the card: no `.item()`, no
`nonzero`, no shape that depends on the data.  Counts are device
scalars and int64 tensors until the caller fetches them.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import bucket_size, resolve_device
from .kmer_kernels import (SENTINEL, WORD_BASES, kmer_fullsum, kmer_keys,
                           window_limbs_plain)

__all__ = ["WORD_BASES", "SENTINEL", "prepare_packed", "pack_codes_host",
           "pack_codes", "kmer_hash_limbs", "kmer_sorted_runs_packed",
           "sorted_runs_from_keys", "counts_from_runs", "kmer_sentinel_table_packed",
           "kmer_count_small_packed", "count_keys", "kmer_window_hashes",
           "sparse_count_tables", "kmer_fullsum_packed",
           "kmer_checksum_streamed", "heads_first"]


def prepare_packed(flat_codes: np.ndarray, lengths: np.ndarray,
                   min_bucket: int = 1 << 14):
    """Host-side transport of the k-mer kernels: 2-bit-packed uint32
    words (zero-filled into a power-of-two position bucket + 2 halo
    words), int32 row ends and the true base count."""
    n = len(flat_codes)
    n_positions = bucket_size(max(n, 1), min_bucket)
    words = pack_codes_host(flat_codes, n_positions)
    ends = np.cumsum(lengths, dtype=np.int64).astype(np.int32)
    return words, ends, n


def pack_codes_host(flat_codes: np.ndarray, n_positions: int) -> np.ndarray:
    """Host-side 2-bit pack, 4 codes per byte, as a uint32 view."""
    from ..native import pack_2bit_fill
    total = n_positions + 2 * WORD_BASES
    return pack_2bit_fill(flat_codes, total // 4).view(np.uint32)


def pack_codes(codes: torch.Tensor, n_positions: int) -> torch.Tensor:
    """Device twin of pack_codes_host: uint8 codes (each 0-3) packed 2 bits
    each into the int32 view of n_positions/16 + 2 words (zero-filled past
    the codes), the same little-endian layout: four codes a byte, code 0
    in the lowest bits, four bytes a word."""
    buf = torch.zeros(n_positions + 2 * WORD_BASES, dtype=torch.uint8,
                      device=codes.device)
    buf[: codes.numel()] = codes
    q = buf.view(-1, 4)
    packed = q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)
    return packed.view(torch.int32)


def kmer_hash_limbs(codes_padded: torch.Tensor, k: int):
    """(lo, hi) of the unmasked 2k-bit hash at every window start of a
    code buffer: bits 0-31 and 32-63, as int64 tensors below 2^32 (the
    JAX package returns them as uint32).  `codes_padded`: codes 0-3,
    their count a multiple of 16 and at least 32 past the last base; the
    result has len(codes_padded) - 32 positions.  Codes are packed as
    pack_codes_host packs them, then hashed with kernel 1's limb
    formulation (ops/kmer_kernels.window_limbs_plain): no kernel runs
    here."""
    n_positions = codes_padded.numel() - 2 * WORD_BASES
    if n_positions < 0 or codes_padded.numel() % WORD_BASES:
        raise ValueError("codes_padded needs a multiple of 16 codes, 32 of "
                         "them past the last base")
    return window_limbs_plain(pack_codes(codes_padded, n_positions), k)


def heads_first(is_head: torch.Tensor, cap: int) -> torch.Tensor:
    """Positions of the True entries of `is_head` in order, then those of
    the False entries in order, cut to `cap`: the stable sort of
    (~is_head, position) that JAX runs, as one cumulative sum and a
    scatter.  Every position has its own slot below n; slots at or past
    `cap` all land in one dump slot that is dropped."""
    n = is_head.numel()
    pos = torch.arange(n, device=is_head.device)
    heads_upto = torch.cumsum(is_head, 0)
    n_heads = heads_upto[-1]
    dest = torch.where(is_head, heads_upto - 1, n_heads + pos - heads_upto)
    out = torch.empty(cap + 1, dtype=torch.int64, device=is_head.device)
    out.scatter_(0, torch.clamp(dest, max=cap), pos)
    return out[:cap]


def sorted_runs_from_keys(keys: torch.Tensor, cap: int):
    """Sort/compact core: sort the keys, find the runs of equal valid
    keys, and compact the run starts to the front of a `cap`-row buffer.
    Returns (uniq_keys, run_starts, n_unique, n_valid); the last two are
    device scalars and n_unique may exceed cap (the table then holds the
    first cap runs)."""
    n = keys.numel()
    s = torch.sort(keys).values
    n_valid = (s != SENTINEL).sum()
    is_new = torch.ones(n, dtype=torch.bool, device=keys.device)
    is_new[1:] = s[1:] != s[:-1]
    pos = torch.arange(n, device=keys.device)
    is_start = is_new & (pos < n_valid)
    n_unique = is_start.sum()
    run_starts = heads_first(is_start, cap)
    return s[run_starts], run_starts, n_unique, n_valid


def kmer_sorted_runs_packed(words: torch.Tensor, ends: torch.Tensor,
                            k: int, n_true: int = None, cap: int = None):
    """Exact sparse k-mer counting core of one packed batch: the sorted,
    compacted (uniq_keys, run_starts, n_unique, n_valid).  `n_true` is
    the real base count (the rest of the bucket is padding) and `cap`
    bounds the rows returned."""
    n_positions = (words.numel() - 2) * WORD_BASES
    cap = n_positions if cap is None else min(cap, n_positions)
    keys = kmer_keys(words, ends, k, n_true)
    return sorted_runs_from_keys(keys, cap)


def counts_from_runs(run_starts: torch.Tensor, n_unique, n_valid,
                     cap: int) -> torch.Tensor:
    """Per-run counts from compacted run-start positions (the device
    twin of np.diff(starts, append=n_valid)); zero beyond n_unique."""
    iota = torch.arange(cap, device=run_starts.device)
    nxt = torch.cat([run_starts[1:], run_starts.new_zeros(1)])
    zero = torch.zeros_like(run_starts)
    return torch.where(iota < n_unique - 1, nxt - run_starts,
                       torch.where(iota == n_unique - 1,
                                   n_valid - run_starts, zero))


def kmer_sentinel_table_packed(words: torch.Tensor, ends: torch.Tensor,
                               k: int, n_true: int, cap: int):
    """Per-batch device-resident sparse count table: (keys, counts) int64
    rows sentinel-padded to cap, plus a (2,) int64 meta [n_unique,
    n_valid].  Unused slots carry (SENTINEL, 0), so tables of several
    batches concatenate and merge with merge_hash_tables."""
    uniq, run_starts, n_unique, n_valid = kmer_sorted_runs_packed(
        words, ends, k, n_true, cap)
    cap = run_starts.numel()
    cnt = counts_from_runs(run_starts, n_unique, n_valid, cap)
    live = torch.arange(cap, device=uniq.device) < n_unique
    keys = torch.where(live, uniq, SENTINEL)
    return keys, cnt, torch.stack([n_unique, n_valid])


def kmer_count_small_packed(words: torch.Tensor, ends: torch.Tensor, k: int,
                            n_counts: int, n_true: int) -> torch.Tensor:
    """Exact counts over the 4^k labels (k <= 15) of the windows inside
    their rows and below n_true, as int64 (n_counts,): the kmer_keys keys,
    the sentinel ones sent to a dump bin that is dropped.  Equal to the
    JAX package's kmer_count_small_packed, which counts every position
    and subtracts the row-crossing and padding windows."""
    if 4 ** k > n_counts or k > 15:
        raise ValueError(f"k={k} needs 4^k <= n_counts={n_counts}, k <= 15")
    return count_keys(kmer_keys(words, ends, k, n_true), n_counts)


def count_keys(keys: torch.Tensor, n_counts: int) -> torch.Tensor:
    """int64 (n_counts,) count of each value below n_counts among the
    int64 keys; larger keys (the sentinel) go to a dump bin that is
    dropped.  One index_add_, so nothing waits for the device."""
    counts = torch.zeros(n_counts + 1, dtype=torch.int64, device=keys.device)
    ones = torch.ones(1, dtype=torch.int64, device=keys.device)
    counts.index_add_(0, torch.clamp(keys, max=n_counts),
                      ones.expand(keys.numel()))
    return counts[:n_counts]


def kmer_window_hashes(words: torch.Tensor, ends: torch.Tensor, k: int,
                       n_true: int) -> torch.Tensor:
    """int64 hash of every window that lies inside its row and below
    n_true, in position order: the flat values of get_kmers.  (A k <= 31
    hash is below 2^62, so no real key equals the sentinel.)"""
    keys = kmer_keys(words, ends, k, n_true)
    return keys[keys != SENTINEL]


def sparse_count_tables(words: torch.Tensor, ends: torch.Tensor, k: int,
                        n_true: int, cap: int = 1 << 20):
    """Sorted (hashes uint64, counts int64) host table of one packed chunk:
    the device sort + compaction, then a fetch of the first n_unique rows
    only.  A chunk with more than `cap` distinct k-mers is compacted again
    at a cap that fits (the JAX package's doubling loop)."""
    n_positions = (words.numel() - 2) * WORD_BASES
    keys = kmer_keys(words, ends, k, n_true)
    while True:
        uniq, run_starts, n_unique, n_valid = sorted_runs_from_keys(
            keys, min(cap, n_positions))
        n_uni = int(n_unique)
        if n_uni <= cap or cap >= n_positions:
            break
        cap = max(cap * 2, 1 << max(n_uni - 1, 1).bit_length())
    counts = counts_from_runs(run_starts, n_unique, n_valid,
                              run_starts.numel())
    table = torch.stack([uniq[:n_uni], counts[:n_uni]]).cpu().numpy()
    return table[0].view(np.uint64), table[1]


def kmer_fullsum_packed(words: torch.Tensor, k: int) -> torch.Tensor:
    """Unmasked (lo_sum, hi_sum) mod 2^32 over ALL window positions, as
    a (2,) int64 tensor: the streaming device pass of the hybrid
    checksum.  Zero-padded windows hash to 0; the row-crossing windows
    are subtracted afterwards (native.kmer_correction_sums)."""
    return kmer_fullsum(words, k)


def kmer_checksum_streamed(flat_codes: np.ndarray, lengths: np.ndarray,
                           k: int, n_chunks: int = 4, device=None):
    """Chunked host->device k-mer checksum.

    Splits the reads into `n_chunks` parts on read boundaries and issues
    pack -> H2D -> unmasked-sum kernel per part without synchronizing;
    while the device sums, host threads recompute the O(rows*k)
    row-crossing windows (native.kmer_correction_sums) that the sums
    must not include.  One fetch at the end subtracts them.  Returns
    (n_valid_kmers, lo_checksum, hi_checksum) as Python ints (sums mod
    2^32 of the low and high halves of every valid hash)."""
    from ..native import kmer_correction_sums
    device = resolve_device(device)
    n_chunks = max(1, min(n_chunks, max(1, len(lengths))))
    bounds = np.linspace(0, len(lengths), n_chunks + 1).astype(np.int64)
    offsets = np.insert(np.cumsum(lengths, dtype=np.int64), 0, 0)
    sums = []
    corr_lo = corr_hi = 0
    for c in range(n_chunks):
        rows = slice(bounds[c], bounds[c + 1])
        part = flat_codes[offsets[bounds[c]]:offsets[bounds[c + 1]]]
        if len(part) == 0:
            continue
        ends = np.cumsum(lengths[rows], dtype=np.int64)
        words = pack_codes_host(part, bucket_size(len(part), 1 << 14))
        words_d = torch.from_numpy(words.view(np.int32)).to(device)
        sums.append(kmer_fullsum_packed(words_d, k))
        # host correction overlaps the asynchronous device work above
        starts = np.insert(ends[:-1], 0, 0)
        cl, ch = kmer_correction_sums(words, ends, starts, k)
        corr_lo += cl
        corr_hi += ch
    n_kmers = int(np.maximum(lengths.astype(np.int64) - (k - 1), 0).sum())
    lo = hi = 0
    if sums:
        total = torch.stack(sums).sum(0).cpu()
        lo, hi = int(total[0]), int(total[1])
    return (n_kmers, (lo - corr_lo) & 0xFFFFFFFF,
            (hi - corr_hi) & 0xFFFFFFFF)
