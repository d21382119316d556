"""Device k-mer counting core (the port's copy of bionumpy_tpu/ops/kmers.py).

A window's 2k-bit hash is one int64 key, not the JAX package's two
uint32 limbs (the TPU has no int64).  Invalid windows carry the sentinel
2^63-1, above every k <= 31 hash, so a plain sort pushes them past every
real key.  A batch is counted by: kmer_keys (ops/kmer_kernels.py) ->
sort and run detection (sort_runs, the one sort of every table of the
port, merges included) -> compaction of the run heads to the front of a
`cap`-row table (compact_runs) -> counts from the run-start differences.

whole_table owns the size policy of a table that its caller fetches
whole: it waits once for the table's row count and compacts again from
the same sort where `cap` was too small.  Everything else here stays
asynchronous on the card: no `.item()`, no `nonzero`, no shape that
depends on the data.  Counts are device scalars and int64 tensors until
the caller fetches them.

The limb functions (kmer_hash_limbs, kmer_hashes_masked, hash_checksum,
unique_kmer_stats) keep the JAX package's (lo, hi) outputs, as int64
tensors below 2^32 where JAX has uint32; counts and checksums are int64,
sums taken mod 2^32 as JAX's uint32 sums wrap.  The checksums reach the
kernels: kmer_checksum_packed the fullsum kernel, the two pipeline
checksums the keys kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..instrument import add, stage
from .device import (bucket_size, distance_to_row_end, fetch_rows,
                     resolve_device)
from .kmer_kernels import (SENTINEL, WORD_BASES, kmer_fullsum, kmer_keys,
                           limbs_at, window_limbs_plain)

_M32 = 0xFFFFFFFF
# the most bases one packed batch holds: its row ends are int32
MAX_PACKED_BASES = (1 << 31) - 1

__all__ = ["WORD_BASES", "SENTINEL", "prepare_packed", "pack_codes_host",
           "pack_codes", "kmer_hash_limbs", "kmer_sorted_runs_packed",
           "sort_runs", "compact_runs", "sorted_runs_from_keys",
           "whole_table", "merge_hash_tables",
           "counts_from_runs", "kmer_sentinel_table_packed",
           "kmer_count_small_packed", "count_keys", "kmer_window_hashes",
           "sparse_count_tables", "kmer_fullsum_packed",
           "kmer_checksum_streamed", "heads_first", "prepare_codes",
           "kmer_hashes_masked", "kmer_count_small", "unique_kmer_stats",
           "hash_checksum", "kmer_checksum_packed",
           "kmer_checksum_pipeline_packed", "kmer_checksum_pipeline"]


def prepare_packed(flat_codes: np.ndarray, lengths: np.ndarray,
                   min_bucket: int = 1 << 14):
    """Host-side transport of the k-mer kernels: 2-bit-packed uint32
    words (zero-filled into a power-of-two position bucket + 2 halo
    words), int32 row ends and the true base count.  Raises ValueError,
    before packing, when the row ends pass MAX_PACKED_BASES: int32 ends
    would wrap."""
    ends = np.cumsum(lengths, dtype=np.int64)
    if len(ends) and ends[-1] > MAX_PACKED_BASES:
        raise ValueError(
            f"{int(ends[-1])} bases do not fit one packed batch, whose "
            f"int32 row ends hold at most {MAX_PACKED_BASES}; "
            f"get_motif_matches takes such arrays (as resident blocks of "
            f"whole rows), the k-mer and minimizer tables do not")
    n = len(flat_codes)
    n_positions = bucket_size(max(n, 1), min_bucket)
    words = pack_codes_host(flat_codes, n_positions)
    return words, ends.astype(np.int32), n


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


def sort_runs(keys: torch.Tensor):
    """The sort step of every table: sort the keys and mark the runs of
    equal valid keys.  Returns (sorted keys, the sort's indices, is_start,
    n_unique, n_valid); the last two are device scalars.  Every table
    sort of the port runs here, as the `sort` span (its rows: the keys
    sorted)."""
    n = keys.numel()
    with stage("sort", rows=n, device=keys.is_cuda):
        s, order = torch.sort(keys)
    n_valid = (s != SENTINEL).sum()
    is_start = torch.ones(n, dtype=torch.bool, device=keys.device)
    is_start[1:] = s[1:] != s[:-1]
    is_start &= torch.arange(n, device=keys.device) < n_valid
    return s, order, is_start, is_start.sum(), n_valid


def compact_runs(s: torch.Tensor, is_start: torch.Tensor, cap: int):
    """The compaction step: the first `cap` run starts of a sort_runs
    result, as (their keys, their positions)."""
    run_starts = heads_first(is_start, cap)
    return s[run_starts], run_starts


def sorted_runs_from_keys(keys: torch.Tensor, cap: int):
    """Sort/compact core: sort_runs, then compact_runs at `cap`.  Returns
    (uniq_keys, run_starts, n_unique, n_valid); the last two are device
    scalars and n_unique may exceed cap (the table then holds the first
    cap runs, as in the JAX package)."""
    s, _, is_start, n_unique, n_valid = sort_runs(keys)
    return (*compact_runs(s, is_start, cap), n_unique, n_valid)


def whole_table(keys: torch.Tensor, cap: int):
    """The whole (keys, counts) table of the keys, for a caller that
    fetches it: one sort, a compaction at min(cap, n) rows and one wait
    for n_unique (`D2H-meta`).  A table past that is compacted again from
    the same sort at the power of two that fits it (`cap-rerun`).
    Returns (keys, counts) of n_unique rows and the (2,) int64 device
    meta [n_unique, n_valid]."""
    s, _, is_start, n_unique, n_valid = sort_runs(keys)

    def compacted(rows):
        uniq, run_starts = compact_runs(s, is_start, rows)
        return uniq, counts_from_runs(run_starts, n_unique, n_valid, rows)

    # counts and meta are enqueued before the wait: the card computes
    # them while the host waits, and a table that fits needs no launch after
    rows = min(cap, keys.numel())
    uniq, counts = compacted(rows)
    meta = torch.stack([n_unique, n_valid])
    with stage("D2H-meta", device=keys.is_cuda):
        n = int(n_unique)
    if n > rows:
        add("cap-rerun", 0.0)
        uniq, counts = compacted(min(bucket_size(n, 1), keys.numel()))
    return uniq[:n], counts[:n], meta


def merge_hash_tables(keys: torch.Tensor, cnt: torch.Tensor, cap_out: int):
    """Merge concatenated (key, count) tables: sum counts of equal keys
    and compact the unique keys to the front.  Sentinel keys are
    dropped.  Returns (keys, counts, n_unique) with min(cap_out, n) rows,
    the unused ones (SENTINEL, 0); n_unique is a device scalar of at most
    cap_out.  Past cap_out distinct keys the last total is cut, as in the
    JAX package; at exactly cap_out with sentinels in the input the JAX
    package cuts it too (its sentinels make a run), the port does not."""
    cap_out = min(cap_out, keys.numel())
    s, order, is_start, n_unique, n_valid = sort_runs(keys)
    m, starts = compact_runs(s, is_start, cap_out)
    csum = torch.cumsum(cnt[order], 0)
    ends = starts + counts_from_runs(starts, n_unique, n_valid, cap_out)
    before = torch.where(starts > 0, csum[torch.clamp(starts - 1, min=0)], 0)
    totals = csum[torch.clamp(ends - 1, min=0)] - before
    live = torch.arange(cap_out, device=keys.device) < n_unique
    return (torch.where(live, m, SENTINEL), torch.where(live, totals, 0),
            torch.clamp(n_unique, max=cap_out))


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
    the chunk's whole_table (first compacted at `cap` rows), then a fetch
    of its n_unique rows only."""
    uniq, counts, _ = whole_table(kmer_keys(words, ends, k, n_true), cap)
    n = uniq.numel()
    rows = fetch_rows(uniq, counts, rows=n)
    return rows[:n].view(np.uint64), rows[n:]


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


def prepare_codes(flat_codes: np.ndarray, lengths: np.ndarray,
                  min_bucket: int = 1 << 14):
    """Host-side: flat codes and each position's distance to its row end
    (ops/device.distance_to_row_end), zero-padded into a power-of-two
    position bucket, the codes with 32 halo bases more.  Returns (codes
    uint8, dist int32, n)."""
    n = len(flat_codes)
    n_positions = bucket_size(max(n, 1), min_bucket)
    codes = np.zeros(n_positions + 2 * WORD_BASES, dtype=np.uint8)
    codes[:n] = flat_codes
    dist = np.zeros(n_positions, dtype=np.int32)
    dist[:n] = distance_to_row_end(lengths)
    return codes, dist, n


def kmer_hashes_masked(codes_padded: torch.Tensor, dist_padded: torch.Tensor,
                       k: int):
    """(lo, hi, valid) at every position of a prepare_codes buffer: the
    unmasked limbs (kmer_hash_limbs) and whether the window lies inside
    its row (dist >= k).  Invalid positions keep their limbs, as in the
    JAX package, so kernel 1's sentinel keys cannot serve here."""
    lo, hi = kmer_hash_limbs(codes_padded, k)
    return lo, hi, dist_padded[: lo.numel()] >= k


def kmer_count_small(codes_padded: torch.Tensor, dist_padded: torch.Tensor,
                     k: int, n_counts: int) -> torch.Tensor:
    """int64 (n_counts,) counts of the valid windows' hashes (k <= 12,
    n_counts = 4^k): invalid windows, and hashes >= n_counts, go to a
    dump bin that is dropped."""
    lo, _, valid = kmer_hashes_masked(codes_padded, dist_padded, k)
    return count_keys(torch.where(valid, lo, n_counts), n_counts)


def unique_kmer_stats(lo: torch.Tensor, hi: torch.Tensor,
                      valid: torch.Tensor):
    """(n_unique, n_valid) of the valid 64-bit hashes, as int64 device
    scalars: one int64 key lo | hi << 32 per position, the sentinel where
    invalid, sorted; the run heads below n_valid are the distinct hashes.
    (A k <= 31 hash is below 2^62, so no valid key equals the
    sentinel.)"""
    keys = (lo.to(torch.int64) & _M32) | ((hi.to(torch.int64) & _M32) << 32)
    keys = torch.where(valid, keys, SENTINEL)
    return sort_runs(keys.reshape(-1))[3:]


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of each row of a 2-D int64 tensor: torch has no XOR reduction,
    so the rows are zero-padded to a power of two and folded in halves,
    log2(n) steps on the tensor's device."""
    n = x.shape[1]
    size = bucket_size(n, 1)
    buf = torch.zeros(x.shape[0], size, dtype=x.dtype, device=x.device)
    buf[:, :n] = x
    while size > 1:
        size //= 2
        buf = torch.bitwise_xor(buf[:, :size], buf[:, size:2 * size])
    return buf[:, 0]


def hash_checksum(lo: torch.Tensor, hi: torch.Tensor, valid: torch.Tensor):
    """Order-independent checksum of the valid hashes: (lo_sum, hi_sum,
    lo_xor, hi_xor), int64 device scalars, the sums mod 2^32.  Sums run
    in int64: below 2^31 positions of values below 2^32 they cannot
    overflow."""
    limbs = torch.stack([lo.reshape(-1), hi.reshape(-1)]).to(torch.int64)
    limbs = torch.where(valid.reshape(-1), limbs & _M32, 0)
    sums = limbs.sum(1) & _M32
    xors = _xor_reduce(limbs)
    return sums[0], sums[1], xors[0], xors[1]


def kmer_checksum_packed(words: torch.Tensor, ends: torch.Tensor, k: int):
    """(n_kmers, lo_sum, hi_sum), int64 device scalars, of the windows
    inside their rows of a packed batch (the sums mod 2^32).

    The fullsum kernel sums every window position, validity ignored;
    the windows that cross a row end, the last k-1 starts of each row,
    are then recomputed as one (rows, k-1) gather and subtracted.
    Windows past the last row end hash to 0 (the pack zero-fills them);
    padding rows repeat the last end, have length 0 and drop out.
    n_kmers follows from the row lengths."""
    total = kmer_fullsum(words, k)
    e = ends.to(torch.int64)
    starts = torch.cat([e.new_zeros(1), e[:-1]])
    offs = torch.arange(k - 1, 0, -1, device=words.device)
    pos = e[:, None] - offs[None, :]
    in_row = pos >= starts[:, None]
    lo, hi = limbs_at(words, torch.clamp(pos, min=0), k)
    corr = torch.stack([torch.where(in_row, lo, 0).sum(),
                        torch.where(in_row, hi, 0).sum()])
    sums = (total - corr) & _M32
    n_kmers = torch.clamp(e - starts - (k - 1), min=0).sum()
    return n_kmers, sums[0], sums[1]


def _checksum_keys(keys: torch.Tensor):
    valid = keys != SENTINEL
    lo = torch.where(valid, keys & _M32, 0).sum() & _M32
    hi = torch.where(valid, keys >> 32, 0).sum() & _M32
    return valid.sum(), lo, hi


def kmer_checksum_pipeline_packed(words: torch.Tensor, ends: torch.Tensor,
                                  k: int, n_true: int):
    """(n_kmers, lo_sum, hi_sum), int64 device scalars, of the windows
    inside their rows and below min(ends[-1], n_true): the keys kernel's
    keys (sentinel where invalid, the JAX package's mark + cumsum rule),
    then the sums of their low and high 32 bits mod 2^32 and their
    count."""
    return _checksum_keys(kmer_keys(words, ends, k, n_true))


def kmer_checksum_pipeline(codes_padded: torch.Tensor, lengths: torch.Tensor,
                           k: int, n_true: int):
    """kmer_checksum_pipeline_packed from codes and row lengths on a
    device: the codes (0-3, as prepare_codes pads them) are packed there,
    the row ends are the cumulative lengths."""
    n_positions = codes_padded.numel() - 2 * WORD_BASES
    words = pack_codes(codes_padded, n_positions)
    ends = torch.cumsum(lengths, 0).to(torch.int32)
    return _checksum_keys(kmer_keys(words, ends, k, n_true))
