"""Device k-mer counting core (the port's copy of bionumpy_tpu/ops/kmers.py).

A window's 2k-bit hash is one int64 key, not the JAX package's two
uint32 limbs (the TPU has no int64).  Invalid windows carry the sentinel
2^63-1, above every k <= 31 hash, so a plain sort pushes them past every
real key.  A batch is counted by: kmer_keys (ops/kmer_kernels.py) ->
the sort (sort_keys, the one sort of every table of the port,
merge_hash_tables' merges included; the folds' merge kernel sorts
nothing) -> the sorted keys' runs compacted into a `cap`-row table of
(key, run length) rows (table_kernels.run_table: a CUDA kernel on the
card, on the CPU its plain version, the run marks of run_marks, the
compaction of the run heads to the front (compact_runs) and counts from
the run-start differences (counts_from_runs)).

whole_table owns the size policy of a table that its caller fetches
whole: it waits once for the table's row count and compacts again from
the same sort where `cap` was too small.  blocked_table owns it for an
array's resident blocks (ops/resident.device_seq_blocks): one block
whose sort fits the card is one pass, whole_table; a larger array is
cut into passes of whole rows (table_passes) whose tables are folded on
the card into one accumulator (fold_tables: the sorted tables merged by
the merge kernel of ops/table_kernels, no sort), and the host waits once
for every pass's meta.  Everything else here stays
asynchronous on the card: no `.item()`, no `nonzero`, no shape that
depends on the data.  Counts are device scalars and int64 tensors until
the caller fetches them.  table_spectrum reduces a table's counts to its
k-mer spectrum on the card and fetches the spectrum alone.

The limb functions (kmer_hash_limbs, kmer_hashes_masked, hash_checksum,
unique_kmer_stats) keep the JAX package's (lo, hi) outputs, as int64
tensors below 2^32 where JAX has uint32; counts and checksums are int64,
sums taken mod 2^32 as JAX's uint32 sums wrap.  The checksums reach the
kernels: kmer_checksum_packed the fullsum kernel, the two pipeline
checksums the keys kernel.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..instrument import add, stage
from .device import (bucket_size, distance_to_row_end, fetch_rows,
                     resolve_device)
from .kmer_kernels import (SENTINEL, WORD_BASES, kmer_fullsum, kmer_keys,
                           limbs_at, window_limbs_plain)
from .table_kernels import merge_tables, run_table

_M32 = 0xFFFFFFFF
# the most bases one packed batch holds: its row ends are int32
MAX_PACKED_BASES = (1 << 31) - 1
# the most positions (the block's power-of-two bucket) of one resident
# block whose table is one whole_table sort: ~50 bytes a position at its
# peak, so 2^30 fits an 80 GB H100 and the next bucket, 2^31, does not
WHOLE_TABLE_POSITIONS = 1 << 30
# the most bases one pass of blocked_table keys, unless a row alone is
# longer.  A fold merges a pass's table (up to this many rows) into the
# accumulator: hg38's minimizers at k = 15 in 16 passes and a 2^29-row
# accumulator peak at 69.3 GB of an 80 GB H100, so 2^29 would not fit
TABLE_PASS_POSITIONS = 1 << 28
# the most rows fold_tables merges at once where it can choose when: the
# pass tables wait until one more would pass this, so small tables (the
# chunked GC job's) merge once, and the largest fold is the one above
FOLD_ROWS = 3 << 28
# count_kmers' first cap (its table is compacted again where it passes)
KMER_TABLE_CAP = 1 << 20
# the largest accumulator a cap-rerun of blocked_table sizes from its
# passes' distinct keys summed (16 bytes a row, twice at a fold); past
# it the accumulator doubles from the largest pass's until the table fits
RERUN_SUM_ROWS = 1 << 29
# copies of each bin that table_spectrum adds into: a table's counts
# crowd into a few bins (a read set's error k-mers all count 1), and
# atomic adds to one address serialise; each count goes to the copy its
# position picks, and the copies are summed after
SPECTRUM_SPREAD = 256

__all__ = ["WORD_BASES", "SENTINEL", "prepare_packed", "pack_codes_host",
           "pack_codes", "kmer_hash_limbs", "kmer_sorted_runs_packed",
           "sort_keys", "run_marks", "sort_runs", "compact_runs",
           "sorted_runs_from_keys",
           "whole_table", "sentinel_table", "merge_hash_tables",
           "fold_tables", "table_passes", "blocked_table", "fetched_table",
           "kmer_keys_of", "table_spectrum",
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


def sort_keys(keys: torch.Tensor):
    """The sort of every table of the port, the `sort` span (its rows: the
    keys sorted): (sorted keys, the sort's indices)."""
    with stage("sort", rows=keys.numel(), device=keys.is_cuda):
        return torch.sort(keys)


def run_marks(s: torch.Tensor):
    """The runs of equal valid keys of sorted keys `s`: (is_start,
    n_unique, n_valid); the last two are device scalars."""
    n = s.numel()
    n_valid = (s != SENTINEL).sum()
    is_start = torch.ones(n, dtype=torch.bool, device=s.device)
    is_start[1:] = s[1:] != s[:-1]
    is_start &= torch.arange(n, device=s.device) < n_valid
    return is_start, is_start.sum(), n_valid


def sort_runs(keys: torch.Tensor):
    """The sort step of the tables that keep their run starts: sort the
    keys (sort_keys) and mark the runs of equal valid keys (run_marks).
    Returns (sorted keys, the sort's indices, is_start, n_unique,
    n_valid); the last two are device scalars."""
    s, order = sort_keys(keys)
    return (s, order, *run_marks(s))


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
    fetches it: one sort, a compaction at min(cap, n) rows
    (table_kernels.run_table) and one wait for n_unique (`D2H-meta`).  A
    table past that is compacted again from the same sort at the power
    of two that fits it (`cap-rerun`).  Returns (keys, counts) of
    n_unique rows and the (2,) int64 device meta [n_unique, n_valid]."""
    s, _ = sort_keys(keys)
    # counts and meta are enqueued before the wait: the card computes
    # them while the host waits, and a table that fits needs no launch after
    rows = min(cap, keys.numel())
    uniq, counts, meta = run_table(s, rows)
    with stage("D2H-meta", device=keys.is_cuda):
        n = int(meta[0])
    if n > rows:
        add("cap-rerun", 0.0)
        uniq, counts, _ = run_table(s, min(bucket_size(n, 1), keys.numel()))
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


def sentinel_table(keys: torch.Tensor, cap: int):
    """The fold-ready table of the keys: (keys, counts) int64 rows, as
    many as min(cap, len(keys)), the unused ones (SENTINEL, 0), and the
    (2,) int64 meta [n_unique, n_valid]: one sort, then the sorted keys'
    runs compacted (table_kernels.run_table).  n_unique is the true
    distinct count even where it exceeds the rows (the table then holds
    the first runs, as in the JAX package), so tables of several batches
    concatenate and merge with merge_hash_tables."""
    s, _ = sort_keys(keys)
    return run_table(s, min(cap, keys.numel()))


def fold_tables(key_passes, cap: int, pass_cap: int, on_card: bool):
    """The tables of passes of keys folded into one, with no wait.  Each
    of `key_passes` is (rows, make_keys): make_keys() returns one pass's
    int64 keys, and rows bounds the rows of its table.  Each pass makes a
    sentinel_table of min(pass_cap, len(keys)) rows (the `table-pass`
    span: device time if `on_card`, rows the keys).  The tables wait
    until the rows held, the accumulator's included, would pass
    FOLD_ROWS with the next table; then they merge, with the accumulator
    once there is one, into an accumulator of `cap` rows: every one is a
    sorted sentinel table, so they merge without a sort
    (table_kernels.merge_tables, the kernel on the card, merge_hash_tables
    over their concatenation on the CPU; the `table-fold` span: device
    time, rows those merged, padding included; the `fold-merge` counter,
    rows the tables merged).  What waits at the end merges last; a
    single table is the accumulator as it is.  Counts once as
    `table-passes`, rows the passes.  Returns (keys, counts, probe): the
    accumulator and one int64 device tensor of each pass's [n_unique,
    n_valid] and then the accumulator's n_unique, at most its rows;
    `cap` or more there means the fold dropped keys past `cap`."""
    metas, held, acc = [], [], None

    def fold():
        nonlocal acc
        tables = held[:] if acc is None else [acc[:2], *held]
        acc = None
        held.clear()
        with stage("table-fold", rows=sum(t[0].numel() for t in tables),
                   device=on_card):
            acc = merge_tables(tables, cap)
            add("fold-merge", 0.0, rows=len(tables))

    for rows, make_keys in key_passes:
        held_rows = sum(t[0].numel() for t in held)
        if acc is not None:
            held_rows += acc[0].numel()
        if len(held) + (acc is not None) > 1 \
                and held_rows + rows > FOLD_ROWS:
            fold()
        with stage("table-pass", device=on_card) as span:
            keys = make_keys()
            span.rows = keys.numel()
            t_keys, t_cnt, meta = sentinel_table(keys, pass_cap)
            del keys  # freed before the next pass or the fold
        metas.append(meta)
        held.append((t_keys, t_cnt))
        del t_keys, t_cnt
    if acc is None and len(held) == 1:
        t_keys, t_cnt = held.pop()
        acc = t_keys, t_cnt, torch.clamp(metas[0][0], max=t_keys.numel())
    elif held:
        fold()
    add("table-passes", 0.0, rows=len(metas))
    return acc[0], acc[1], torch.cat([*metas, acc[2].reshape(1)])


def table_passes(blocks) -> list:
    """The passes of a table over an array's resident blocks
    (ops/resident.DeviceSeqs, in row order): (block, first row, end row,
    first base, end base).  An array of one block of at most
    WHOLE_TABLE_POSITIONS positions is one pass, without a look at its
    rows.  Any other is cut into runs of whole rows of one block, each of
    at most TABLE_PASS_POSITIONS bases, filled greedily from the block's
    first row; a row longer than that is a pass alone.  No window
    crosses a pass."""
    if len(blocks) == 1 and blocks[0].n_positions <= WHOLE_TABLE_POSITIONS:
        ds = blocks[0]
        return [(ds, 0, len(ds.lengths), 0, ds.n)]
    out = []
    for ds in blocks:
        ends = ds.row_ends
        r0, base = 0, 0
        while r0 < len(ends):
            r1 = max(int(np.searchsorted(ends, base + TABLE_PASS_POSITIONS,
                                         side="right")), r0 + 1)
            if ends[r1 - 1] > base:  # a pass of empty rows keys nothing
                out.append((ds, r0, r1, base, int(ends[r1 - 1])))
            base, r0 = int(ends[r1 - 1]), r1
    return out


def _pass_words(one_pass):
    """The word span of one pass of table_passes: (first word, end word),
    the end past the word of its last base and the 2 halo words."""
    _, _, _, p0, p1 = one_pass
    return p0 // WORD_BASES, -(-p1 // WORD_BASES) + 2


def _pass_keys(one_pass, keys_of) -> torch.Tensor:
    """keys_of(words, ends, n_true) over the words that hold one pass of
    table_passes, from the word of its first base: the row ends shifted
    to those words, a first row end put at the pass's first base, and
    the sentinel at the positions before it."""
    ds, r0, r1, p0, p1 = one_pass
    w0, w1 = _pass_words(one_pass)
    off = p0 - w0 * WORD_BASES
    ends = torch.cat([ds.ends.new_full((1,), off),
                      ds.ends[r0:r1] - w0 * WORD_BASES])
    keys = keys_of(ds.words[w0:w1], ends, p1 - w0 * WORD_BASES)
    keys[:off] = SENTINEL
    return keys


def blocked_table(passes, keys_of, cap: int):
    """The whole (keys, counts) table of the passes of an array's
    resident blocks (table_passes), for a caller that fetches it:
    n_unique rows each.  `keys_of(words, ends, n_true)` gives the int64
    key of every window of a packed batch, the sentinel where none
    counts (kmer_keys, minimizer_keys_masked).

    One pass is whole_table over the block's keys.  More passes are
    folded on the card (fold_tables): each pass's table at min(cap, its
    keys) rows, the accumulator at `cap` rows; the host waits once, for
    every pass's meta and the accumulator's row count (`D2H-meta`).
    Where a table passed its cap, the passes run once more
    (`cap-rerun`), each table at the power of two that fits the largest,
    the accumulator at the power of two that fits the passes' distinct
    keys summed (more memory than a `cap` that fits).  Where that sum
    passes RERUN_SUM_ROWS, as where the passes of a read set share most
    of their keys and the sum overstates the table many times, the
    accumulator starts at the largest table's rows (twice the cap at
    least) and doubles, the passes run again each time (`cap-rerun`),
    until the table fits: it holds at most twice the table's rows."""
    if len(passes) == 1:
        ds = passes[0][0]
        uniq, counts, _ = whole_table(keys_of(ds.words, ds.ends, ds.n), cap)
        return uniq, counts

    def folded(cap, pass_cap):
        keys, counts, probe = fold_tables(
            [(min(pass_cap, (w1 - w0 - 2) * WORD_BASES),
              functools.partial(_pass_keys, p, keys_of))
             for p, (w0, w1) in zip(passes, map(_pass_words, passes))],
            cap, pass_cap, passes[0][0].words.is_cuda)
        with stage("D2H-meta", device=probe.is_cuda):
            probe = probe.cpu().numpy()
        return keys, counts, probe

    keys, counts, probe = folded(cap, cap)
    if probe[-1] >= cap:
        # a pass's table past its cap makes the accumulator pass it too
        n_unique = probe[:-1:2]
        pass_cap = bucket_size(int(n_unique.max()), 1)
        most = bucket_size(int(min(n_unique.sum(), probe[1:-1:2].sum())), 1)
        cap = most if most <= RERUN_SUM_ROWS else \
            min(most, max(pass_cap, 2 * cap))
        while True:
            add("cap-rerun", 0.0)
            keys = counts = None
            keys, counts, probe = folded(cap, pass_cap)
            if probe[-1] < cap or cap >= most:
                break
            cap = min(2 * cap, most)
    n = int(probe[-1])
    return keys[:n], counts[:n]


def kmer_keys_of(k: int, canonical: bool = False):
    """The keys_of(words, ends, n_true) of a k-mer table that
    blocked_table takes: kernel 1's keys at k, canonical ones where
    `canonical`."""
    return lambda words, ends, n_true: kmer_keys(words, ends, k, n_true,
                                                 canonical=canonical)


def table_spectrum(counts: torch.Tensor, max_count: int) -> np.ndarray:
    """The spectrum of a table's counts, reduced on the counts' device and
    fetched alone: int64 h of max_count + 1 bins, h[c] the rows counted c
    times, every count above max_count in h[max_count].  A table's rows
    count at least once, so h[0] is 0.  The `kmer-spectrum` span (device
    time; rows: the rows reduced, bytes: those fetched)."""
    n_bins = max_count + 1
    with stage("kmer-spectrum", n_bytes=8 * n_bins, rows=counts.numel(),
               device=counts.is_cuda):
        copy = torch.arange(counts.numel(), device=counts.device) \
            % SPECTRUM_SPREAD
        slots = torch.clamp(counts, max=max_count) * SPECTRUM_SPREAD + copy
        h = count_keys(slots, n_bins * SPECTRUM_SPREAD).view(
            n_bins, SPECTRUM_SPREAD).sum(1)
        return fetch_rows(h, rows=n_bins)


def fetched_table(keys: torch.Tensor, counts: torch.Tensor):
    """A whole table on the host: (keys as uint64, int64 counts) of its
    rows, fetched in one copy (ops/device.fetch_rows)."""
    n = keys.numel()
    rows = fetch_rows(keys, counts, rows=n)
    return rows[:n].view(np.uint64), rows[n:]


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
    return sentinel_table(kmer_keys(words, ends, k, n_true), cap)


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
                        n_true: int, cap: int = KMER_TABLE_CAP,
                        canonical: bool = False):
    """Sorted (hashes uint64, counts int64) host table of one packed chunk:
    the chunk's whole_table (first compacted at `cap` rows), then a fetch
    of its n_unique rows only.  `canonical`: of the canonical keys."""
    uniq, counts, _ = whole_table(
        kmer_keys(words, ends, k, n_true, canonical=canonical), cap)
    return fetched_table(uniq, counts)


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
