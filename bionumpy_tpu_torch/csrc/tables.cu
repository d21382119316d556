// Hand-written Hopper (sm_90a) kernels of the device table: the merge of
// two sorted sentinel tables into one of at most `cap` rows, and the run
// table, a sorted key array's runs compacted into a sentinel table.
//
// A sentinel table is (keys, counts) int64 rows: its live keys sorted and
// unique, each with its count, then (2^63-1, 0) padding.  ops/kmers makes
// them (sentinel_table) and folds them (fold_tables), whose inputs are
// such tables by construction: the pass tables and the accumulator.  The
// merge keeps each distinct live key once, in order, with the counts of
// its rows added, and fills the rows past the last with the padding.
//
// It replaces no Pallas kernel.  The JAX package folds by XLA's sort of
// the concatenated tables (merge_hash_tables in bionumpy_tpu/ops/kmers.py,
// called from pipeline._fold_program_impl), and so did the port, with a
// 64-bit radix sort of every fold's ~805 M rows and the run marks,
// compaction and count sums around it (~245 ms a fold on an NVIDIA H100
// 80GB HBM3 at 700 W).  Both inputs are already sorted, so a merge needs
// no sort.
//
// Bound by bytes: the live rows of both inputs read once and the `cap`
// output rows written once, 16 bytes a row.  At the minimizer index's
// fold shape (a 2^29-row accumulator, a 2^28-row pass table) that is at
// most 21.5 GB, 6.4 ms at 3.35 TB/s, less where rows are padding.
//
// Design, one merge = six launches on the caller's stream, no wait:
//   live_rows: each input's live length, its first sentinel, by binary
//     search, so padding is never read;
//   partition: merge path, one co-rank binary search a tile boundary,
//     a tile being kTile rows of the merged sequence (equal keys: A first);
//   count: a block a tile loads its A and B keys into shared memory with
//     coalesced 8-byte loads, each thread merges kPer rows and counts the
//     distinct ones; a B row equal to the A row merged just before it is
//     the second of a pair, even where that A row lies in the tile before;
//   scan: one block turns the tiles' distinct counts into output offsets
//     and writes n_unique = min(distinct, cap);
//   merge_tables_kernel: the count's merge again with the counts, each
//     pair kept as its A row with both counts added (the B row may lie in
//     the next tile), staged in shared memory and written out coalesced;
//     rows at or past `cap` are dropped;
//   fill: (sentinel, 0) from n_unique to the output's end, 16-byte
//     stores (its first build, 8-byte stores, took as long as the write
//     pass in the minimizer index cell).
// Keys are read twice and counts once, so the passes move ~1.5x the
// floor's input bytes; the partition, the scan and the searches are
// small.  On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, the fold's
// shape with 429 M live rows in and 389 M out) a merge takes 10.9 ms:
// the write pass 7.1, the count 2.1, the fill 0.8, the scan 0.4, the
// partition 0.3; 2.4x its floor over the live rows (4.6 ms), 1.7x the
// floor over every row (6.4 ms), against 263-353 ms for the sort of the
// concatenation.  Where the distinct keys pass `cap`, the first `cap`
// keys are kept, each with its whole total.
//
// The run table (run_table_launch) makes each table the merge takes: the
// sorted keys of a pass (ops/kmers.sentinel_table) or of a whole table
// (whole_table) become the first `rows` runs of equal keys below the first
// sentinel, each as its key and its length, then (sentinel, 0) rows, and
// the meta [n_unique, n_valid].  It replaces no Pallas kernel either: the
// JAX package marks the runs, sorts (~is_head, position) and takes
// differences of the run starts in XLA (kmer_sentinel_table_packed), and
// the port did the same in ~20 torch ops a table (run marks, a cumsum and
// a scatter, aranges, wheres and a gather; 47.8 ms for 2^28 keys on an
// NVIDIA H100 80GB HBM3 at 700 W, about 15 int64 temporaries as long as
// the keys), which the CPU still runs as the plain version.  Bound by bytes: the live keys read once and the `rows`
// output rows written once, 6.3 GB (1.9 ms at 3.35 TB/s) for 2^28 keys.
// Design, five launches on the caller's stream, no wait:
//   live_rows: n_valid, the first sentinel, by binary search;
//   count: a block a tile of kTile keys, each warp kPer rounds of 32
//     coalesced 8-byte loads; a key heads a run where it lies below
//     n_valid and differs from the key before it (a shuffle, or the key
//     before the warp); per tile the heads and the first head's position;
//   scan: one block turns the tiles' heads into output offsets and
//     n_unique, and scans the first heads backward into the position of
//     the first head past each tile, which closes a run that crosses
//     tiles however many it spans;
//   run_table_kernel: the heads again, staged in shared memory with their
//     positions and written out coalesced as (key, next head's position
//     less its own); rows at or past `rows` are dropped, and where the
//     runs pass `rows` the last row's count is 0 less its position, as the
//     JAX package's table cuts it;
//   fill: (sentinel, 0) from min(n_unique, rows) to `rows`, the merge's
//     16-byte stores.
// Keys are read twice, so the passes move ~1.3x the floor's bytes.  On the
// same card (chip_smoke.py phase 25) a pass of 2^28 keys with 119 M runs
// takes 3.25 ms, 1.73x its floor: the count 0.70, the scan 0.24, the write
// pass 1.44, the fill 0.80 ms; the one-block scan weighs most at small
// shapes (2^26 keys at 2^20 rows: 0.32 ms, 3.3x).
//
// Every entry point launches on the caller's stream, allocates nothing
// (the caller passes the scratch) and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kThreads = 256;           // threads of a tile's block
constexpr int kPer = 8;                 // merged rows a thread
constexpr int kTile = kThreads * kPer;  // merged rows a tile
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 4;             // tiles a scan thread a round
constexpr int kFillThreads = 256;
constexpr int kFillBlocks = 132 * 8;

// scratch (int64): the two live lengths, then the n_tiles + 1 tile
// starts in A, then the n_tiles distinct counts, scanned in place into
// the tiles' output offsets
constexpr int kLiveA = 0;
constexpr int kLiveB = 1;
constexpr int kStarts = 2;

__device__ long long live_rows(const long long* keys, long long rows) {
    long long lo = 0, hi = rows;
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (keys[mid] == kSentinel) hi = mid; else lo = mid + 1;
    }
    return lo;
}

// the rows of A among the first d of the merge of A (na rows) and B (nb
// rows), an A row going first on equal keys
template <typename I>
__device__ __forceinline__ I co_rank(const long long* a, I na,
                                     const long long* b, I nb, I d) {
    I lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
    while (lo < hi) {
        const I mid = (lo + hi) >> 1;
        if (a[mid] <= b[d - 1 - mid]) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// exclusive prefix of v over the block's kThreads threads; *total the sum
__device__ __forceinline__ int block_exclusive(int v, int* total) {
    __shared__ int s_warp[kThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += n;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
        const int x = s_warp[w];
        before += w < warp ? x : 0;
        sum += x;
    }
    *total = sum;
    return before + incl - v;
}

// One tile of the merge path: A rows [a0, a0 + la), B rows [b0, b0 + lb).
struct Tile {
    long long a0, b0;
    int la, lb;
};

__device__ __forceinline__ Tile tile_of(const long long* scratch,
                                        long long na, long long nb) {
    const long long t = blockIdx.x, d0 = t * kTile;
    const long long d1 = min(d0 + kTile, na + nb);
    const long long a0 = scratch[kStarts + t], a1 = scratch[kStarts + t + 1];
    return {a0, d0 - a0, (int)(a1 - a0), (int)(d1 - a1 - (d0 - a0))};
}

// the tile's keys (or counts) into s: A's rows, then B's
__device__ __forceinline__ void load_tile(const long long* __restrict__ a,
                                          const long long* __restrict__ b,
                                          const Tile& t, long long* s) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        const int x = threadIdx.x + r * kThreads;
        if (x < t.la) s[x] = a[t.a0 + x];
        else if (x < t.la + t.lb) s[x] = b[t.b0 + x - t.la];
    }
}

__global__ void merge_tables_live_rows(const long long* a, long long rows_a,
                                       const long long* b, long long rows_b,
                                       long long* scratch) {
    if (threadIdx.x == 0) scratch[kLiveA] = live_rows(a, rows_a);
    if (threadIdx.x == 32) scratch[kLiveB] = live_rows(b, rows_b);
}

__global__ void merge_tables_partition(const long long* __restrict__ a,
                                       const long long* __restrict__ b,
                                       long long* scratch, long long n_tiles) {
    const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (t > n_tiles) return;
    const long long na = scratch[kLiveA], nb = scratch[kLiveB];
    scratch[kStarts + t] = co_rank<long long>(a, na, b, nb,
                                              min(t * kTile, na + nb));
}

__global__ void __launch_bounds__(kThreads)
merge_tables_count(const long long* __restrict__ a,
                   const long long* __restrict__ b, long long* scratch,
                   long long n_tiles) {
    __shared__ long long s_keys[kTile];
    const long long na = scratch[kLiveA], nb = scratch[kLiveB];
    long long* distinct = scratch + kStarts + n_tiles + 1;
    if ((long long)blockIdx.x * kTile >= na + nb) {
        if (threadIdx.x == 0) distinct[blockIdx.x] = 0;
        return;
    }
    const Tile t = tile_of(scratch, na, nb);
    const int n = t.la + t.lb;
    const bool has_prev = t.a0 > 0;
    const long long prev_a = has_prev ? a[t.a0 - 1] : 0;
    load_tile(a, b, t, s_keys);
    __syncthreads();
    const long long* sa = s_keys;
    const long long* sb = s_keys + t.la;
    const int d = min((int)threadIdx.x * kPer, n);
    int i = co_rank<int>(sa, t.la, sb, t.lb, d), j = d - i, heads = 0;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        if (d + r < n) {
            if (i < t.la && (j >= t.lb || sa[i] <= sb[j])) {
                ++heads;
                ++i;
            } else {
                const long long key = sb[j++];
                heads += !(i > 0 ? sa[i - 1] == key : has_prev && prev_a == key);
            }
        }
    }
    int total;
    block_exclusive(heads, &total);
    if (threadIdx.x == 0) distinct[blockIdx.x] = total;
}

__device__ __forceinline__ long long warp_inclusive(long long v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long n = __shfl_up_sync(0xFFFFFFFFu, v, o);
        if (lane >= o) v += n;
    }
    return v;
}

__global__ void __launch_bounds__(kScanThreads)
merge_tables_scan(long long* scratch, long long n_tiles, long long cap,
                  long long* n_unique) {
    __shared__ long long s_warp[kScanThreads / 32];
    __shared__ long long s_total;
    long long* distinct = scratch + kStarts + n_tiles + 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    long long carry = 0;
    for (long long base = 0; base < n_tiles;
         base += (long long)kScanThreads * kScanPer) {
        const long long first = base + (long long)threadIdx.x * kScanPer;
        long long v[kScanPer], sum = 0;
#pragma unroll
        for (int r = 0; r < kScanPer; ++r) {
            v[r] = first + r < n_tiles ? distinct[first + r] : 0;
            sum += v[r];
        }
        const long long incl = warp_inclusive(sum);
        if (lane == 31) s_warp[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            const long long w = s_warp[lane], wi = warp_inclusive(w);
            s_warp[lane] = wi - w;
            if (lane == 31) s_total = wi;
        }
        __syncthreads();
        long long off = carry + s_warp[warp] + incl - sum;
#pragma unroll
        for (int r = 0; r < kScanPer; ++r) {
            if (first + r < n_tiles) distinct[first + r] = off;
            off += v[r];
        }
        carry += s_total;
        __syncthreads();  // s_warp and s_total are written again
    }
    if (threadIdx.x == 0) *n_unique = min(carry, cap);
}

__global__ void __launch_bounds__(kThreads)
merge_tables_kernel(const long long* __restrict__ a,
                    const long long* __restrict__ ca,
                    const long long* __restrict__ b,
                    const long long* __restrict__ cb,
                    const long long* scratch, long long n_tiles,
                    long long cap, long long* __restrict__ out_keys,
                    long long* __restrict__ out_counts) {
    __shared__ long long s_keys[kTile];
    __shared__ long long s_counts[kTile];
    const long long na = scratch[kLiveA], nb = scratch[kLiveB];
    if ((long long)blockIdx.x * kTile >= na + nb) return;
    const Tile t = tile_of(scratch, na, nb);
    const int n = t.la + t.lb;
    const bool has_prev = t.a0 > 0;
    const long long prev_a = has_prev ? a[t.a0 - 1] : 0;
    // the B row after the tile's: the partner of its last A row, if equal
    const long long b_end = t.b0 + t.lb;
    const bool has_next = b_end < nb;
    const long long next_b = has_next ? b[b_end] : 0;
    const long long next_c = has_next ? cb[b_end] : 0;
    load_tile(a, b, t, s_keys);
    load_tile(ca, cb, t, s_counts);
    __syncthreads();
    const long long* sa = s_keys;
    const long long* sb = s_keys + t.la;
    const long long* sca = s_counts;
    const long long* scb = s_counts + t.la;
    const int d = min((int)threadIdx.x * kPer, n);
    int i = co_rank<int>(sa, t.la, sb, t.lb, d), j = d - i;
    long long keys[kPer], counts[kPer];
    unsigned heads = 0;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        keys[r] = counts[r] = 0;
        if (d + r < n) {
            if (i < t.la && (j >= t.lb || sa[i] <= sb[j])) {
                const long long key = sa[i];
                long long c = sca[i++];
                if (j < t.lb) c += sb[j] == key ? scb[j] : 0;
                else if (has_next && next_b == key) c += next_c;
                keys[r] = key;
                counts[r] = c;
                heads |= 1u << r;
            } else {
                const long long key = sb[j];
                if (!(i > 0 ? sa[i - 1] == key : has_prev && prev_a == key)) {
                    keys[r] = key;
                    counts[r] = scb[j];
                    heads |= 1u << r;
                }
                ++j;
            }
        }
    }
    int total;
    int p = block_exclusive(__popc(heads), &total);
    __syncthreads();  // every thread has read the tile's rows
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        if (heads >> r & 1) {
            s_keys[p] = keys[r];
            s_counts[p] = counts[r];
            ++p;
        }
    }
    __syncthreads();
    const long long base = scratch[kStarts + n_tiles + 1 + blockIdx.x];
    for (int x = threadIdx.x; x < total; x += kThreads) {
        const long long row = base + x;
        if (row < cap) {
            out_keys[row] = s_keys[x];
            out_counts[row] = s_counts[x];
        }
    }
}

// (sentinel, 0) in rows [first, out_rows): an odd first row alone, then
// two rows a thread as evict-first 16-byte stores (the outputs are
// 16-byte aligned), then an odd last row
__device__ __forceinline__ void fill_padding(long long first,
                                             long long out_rows,
                                             long long* __restrict__ out_keys,
                                             long long* __restrict__ out_counts) {
    const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    const long long even = first + (first & 1);
    if (tid == 0 && first < out_rows && (first & 1)) {
        out_keys[first] = kSentinel;
        out_counts[first] = 0;
    }
    if (even >= out_rows) return;
    const long long pairs = (out_rows - even) >> 1;
    longlong2* keys2 = (longlong2*)(out_keys + even);
    longlong2* counts2 = (longlong2*)(out_counts + even);
    const longlong2 pad = make_longlong2(kSentinel, kSentinel);
    const longlong2 zero = make_longlong2(0, 0);
    for (long long p = tid; p < pairs; p += (long long)gridDim.x * blockDim.x) {
        __stcs(keys2 + p, pad);
        __stcs(counts2 + p, zero);
    }
    if (tid == 0 && even + 2 * pairs < out_rows) {
        out_keys[out_rows - 1] = kSentinel;
        out_counts[out_rows - 1] = 0;
    }
}

__global__ void merge_tables_fill(const long long* n_unique,
                                  long long out_rows,
                                  long long* __restrict__ out_keys,
                                  long long* __restrict__ out_counts) {
    fill_padding(*n_unique, out_rows, out_keys, out_counts);
}

// ---- run_table: the runs of sorted keys as a sentinel table ----------
//
// A tile is kTile sorted keys; warp w of its block reads the tile's
// keys [w * kWarpRows, (w + 1) * kWarpRows) in kPer rounds of 32, each
// lane one key a round, so every load of a warp is 256 contiguous bytes.
// A key heads a run where it lies below n_valid (the first sentinel)
// and differs from the key before it, which the lane before holds, or
// lane 31 of the round before, or for a warp's first key the key before
// the warp, read alone.

constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kPer * 32;    // sorted keys a warp reads a tile
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kNone = 0x7FFFFFFFFFFFFFFFLL;  // a tile without heads

// scratch (int64): n_valid and n_unique, then the n_tiles head counts,
// scanned in place into the tiles' output offsets, then the n_tiles
// first heads, scanned in place into the position of the first head
// past each tile (n_valid past the last)
constexpr int kRunValid = 0;
constexpr int kRunUnique = 1;
constexpr int kRunTiles = 2;

// the tile at t0: each lane's kPer keys (the sentinel at or past
// n_valid, never read) and each round's ballot of heads; *w0 the warp's
// first position
__device__ __forceinline__ void warp_heads(const long long* __restrict__ s,
                                           long long n_valid, long long t0,
                                           long long* key, unsigned* heads,
                                           long long* w0) {
    const int lane = threadIdx.x & 31;
    const long long first = t0 + (long long)(threadIdx.x >> 5) * kWarpRows;
    *w0 = first;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        const long long p = first + r * 32 + lane;
        key[r] = p < n_valid ? __ldg(s + p) : kSentinel;
    }
    const long long before = lane == 0 && first > 0 && first <= n_valid
                                 ? __ldg(s + first - 1) : kSentinel;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        const long long p = first + r * 32 + lane;
        long long prev = __shfl_up_sync(kFull, key[r], 1);
        const long long carry = __shfl_sync(kFull, key[r > 0 ? r - 1 : 0],
                                            31);
        if (lane == 0) prev = r > 0 ? carry : before;
        heads[r] = __ballot_sync(kFull, p < n_valid &&
                                            (p == 0 || key[r] != prev));
    }
}

__global__ void run_table_live_rows(const long long* s, long long n,
                                    long long* scratch) {
    if (threadIdx.x == 0) scratch[kRunValid] = live_rows(s, n);
}

__global__ void __launch_bounds__(kThreads)
run_table_count(const long long* __restrict__ s, long long* scratch,
                long long n_tiles) {
    __shared__ int s_heads[kWarps];
    __shared__ long long s_first[kWarps];
    const long long n_valid = scratch[kRunValid];
    long long* heads = scratch + kRunTiles;
    long long* first = heads + n_tiles;
    const long long t0 = blockIdx.x * (long long)kTile;
    if (t0 >= n_valid) {
        if (threadIdx.x == 0) {
            heads[blockIdx.x] = 0;
            first[blockIdx.x] = kNone;
        }
        return;
    }
    long long key[kPer], w0;
    unsigned ballot[kPer];
    warp_heads(s, n_valid, t0, key, ballot, &w0);
    int count = 0;
    long long lead = kNone;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        count += __popc(ballot[r]);
        if (ballot[r] && lead == kNone)
            lead = w0 + r * 32 + __ffs(ballot[r]) - 1;
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        s_heads[warp] = count;
        s_first[warp] = lead;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int total = 0;
        long long f = kNone;
        for (int w = 0; w < kWarps; ++w) {
            total += s_heads[w];
            f = min(f, s_first[w]);
        }
        heads[blockIdx.x] = total;
        first[blockIdx.x] = f;
    }
}

__device__ __forceinline__ long long warp_inclusive_min(long long v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long n = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v = min(v, n);
    }
    return v;
}

// One block: the head counts scanned forward into output offsets
// (n_unique their sum), and the first heads scanned backward, as a
// prefix minimum over the tiles taken from the last, into the first
// head past each tile; both chunk by chunk with one carry each.  Writes
// meta = [n_unique, n_valid].
__global__ void __launch_bounds__(kScanThreads)
run_table_scan(long long* scratch, long long n_tiles, long long* meta) {
    __shared__ long long s_sum[kScanThreads / 32];
    __shared__ long long s_min[kScanThreads / 32];
    __shared__ long long s_sum_total, s_min_total;
    long long* heads = scratch + kRunTiles;
    long long* first = heads + n_tiles;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long n_valid = scratch[kRunValid];
    long long carry = 0, after = n_valid;
    for (long long base = 0; base < n_tiles;
         base += (long long)kScanThreads * kScanPer) {
        // the thread's tiles: j0 + r forward, n_tiles - 1 - (j0 + r) back
        const long long j0 = base + (long long)threadIdx.x * kScanPer;
        long long v[kScanPer], f[kScanPer], sum = 0, low = kNone;
#pragma unroll
        for (int r = 0; r < kScanPer; ++r) {
            const bool in = j0 + r < n_tiles;
            v[r] = in ? heads[j0 + r] : 0;
            f[r] = in ? first[n_tiles - 1 - (j0 + r)] : kNone;
            sum += v[r];
            low = min(low, f[r]);
        }
        const long long incl = warp_inclusive(sum);
        const long long low_incl = warp_inclusive_min(low);
        long long low_before = __shfl_up_sync(kFull, low_incl, 1);
        if (lane == 0) low_before = kNone;
        if (lane == 31) {
            s_sum[warp] = incl;
            s_min[warp] = low_incl;
        }
        __syncthreads();
        if (warp == 0) {
            const long long w = s_sum[lane], wi = warp_inclusive(w);
            const long long m = s_min[lane], mi = warp_inclusive_min(m);
            const long long m_before = __shfl_up_sync(kFull, mi, 1);
            s_sum[lane] = wi - w;
            s_min[lane] = lane == 0 ? kNone : m_before;
            if (lane == 31) {
                s_sum_total = wi;
                s_min_total = mi;
            }
        }
        __syncthreads();
        long long off = carry + s_sum[warp] + incl - sum;
        long long next = min(after, min(s_min[warp], low_before));
#pragma unroll
        for (int r = 0; r < kScanPer; ++r) {
            if (j0 + r < n_tiles) {
                heads[j0 + r] = off;
                first[n_tiles - 1 - (j0 + r)] = next;
            }
            off += v[r];
            next = min(next, f[r]);
        }
        carry += s_sum_total;
        after = min(after, s_min_total);
        __syncthreads();  // s_sum, s_min and the totals are written again
    }
    if (threadIdx.x == 0) {
        scratch[kRunUnique] = carry;
        meta[0] = carry;
        meta[1] = n_valid;
    }
}

// The tile's heads again, each staged in shared memory at its rank in
// the tile with its position, then written out coalesced from the
// tile's offset: the key and the next head's position less its own (the
// first head past the tile for the tile's last).  Rows at or past `rows`
// are dropped; where the runs pass `rows`, the last row's count is 0
// less its position, the truncation of the JAX package's table.
__global__ void __launch_bounds__(kThreads)
run_table_kernel(const long long* __restrict__ s, const long long* scratch,
                 long long n_tiles, long long rows,
                 long long* __restrict__ out_keys,
                 long long* __restrict__ out_counts) {
    __shared__ long long s_keys[kTile];
    __shared__ long long s_pos[kTile];
    __shared__ int s_warp[kWarps];
    const long long n_valid = scratch[kRunValid];
    const long long n_unique = scratch[kRunUnique];
    const long long t0 = blockIdx.x * (long long)kTile;
    const long long base = scratch[kRunTiles + blockIdx.x];
    if (t0 >= n_valid || base >= rows) return;
    long long key[kPer], w0;
    unsigned ballot[kPer];
    warp_heads(s, n_valid, t0, key, ballot, &w0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int count = 0;
#pragma unroll
    for (int r = 0; r < kPer; ++r) count += __popc(ballot[r]);
    if (lane == 0) s_warp[warp] = count;
    __syncthreads();
    int at = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const int c = s_warp[w];
        at += w < warp ? c : 0;
        total += c;
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        if (ballot[r] >> lane & 1u) {
            const int x = at + __popc(ballot[r] & below);
            s_keys[x] = key[r];
            s_pos[x] = w0 + r * 32 + lane;
        }
        at += __popc(ballot[r]);
    }
    __syncthreads();
    const long long next = scratch[kRunTiles + n_tiles + blockIdx.x];
    const bool cut = n_unique > rows;
    for (int x = threadIdx.x; x < total; x += kThreads) {
        const long long row = base + x;
        if (row >= rows) break;
        const long long pos = s_pos[x];
        const long long end = x + 1 < total ? s_pos[x + 1] : next;
        out_keys[row] = s_keys[x];
        out_counts[row] = cut && row == rows - 1 ? -pos : end - pos;
    }
}

__global__ void run_table_fill(const long long* scratch, long long rows,
                               long long* __restrict__ out_keys,
                               long long* __restrict__ out_counts) {
    fill_padding(min(scratch[kRunUnique], rows), rows, out_keys, out_counts);
}

long long tiles(long long rows_in) { return (rows_in + kTile - 1) / kTile; }

// blocks of a fill of out_rows rows
unsigned fill_blocks(long long out_rows) {
    const long long blocks = (out_rows + kFillThreads - 1) / kFillThreads;
    return (unsigned)(blocks < kFillBlocks ? blocks : kFillBlocks);
}

}  // namespace

extern "C" {

// int64 entries of the scratch a merge of rows_in input rows needs
long long merge_tables_scratch(long long rows_in) {
    return kStarts + 2 * tiles(rows_in) + 1;
}

// The merge of sentinel tables A (rows_a rows) and B (rows_b rows) into
// out_keys / out_counts (out_rows = min(cap, rows_a + rows_b) rows, each
// 16-byte aligned) and n_unique (one int64); scratch holds
// merge_tables_scratch(rows_a + rows_b) int64 entries.
int merge_tables_launch(const void* keys_a, const void* counts_a,
                        long long rows_a, const void* keys_b,
                        const void* counts_b, long long rows_b, long long cap,
                        void* out_keys, void* out_counts, long long out_rows,
                        void* n_unique, void* scratch, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const long long n_tiles = tiles(rows_a + rows_b);
    auto a = (const long long*)keys_a, b = (const long long*)keys_b;
    auto s = (long long*)scratch;
    if (n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    if ((uintptr_t)out_keys % 16 || (uintptr_t)out_counts % 16)
        return (int)cudaErrorMisalignedAddress;
    const unsigned grid = (unsigned)n_tiles;
    cudaError_t err;
    merge_tables_live_rows<<<1, 64, 0, st>>>(a, rows_a, b, rows_b, s);
    if ((err = cudaGetLastError())) return (int)err;
    if (n_tiles > 0) {
        merge_tables_partition<<<(unsigned)((n_tiles + 256) / 256), 256, 0,
                                 st>>>(
            a, b, s, n_tiles);
        if ((err = cudaGetLastError())) return (int)err;
        merge_tables_count<<<grid, kThreads, 0, st>>>(a, b, s, n_tiles);
        if ((err = cudaGetLastError())) return (int)err;
    }
    merge_tables_scan<<<1, kScanThreads, 0, st>>>(s, n_tiles, cap,
                                                   (long long*)n_unique);
    if ((err = cudaGetLastError())) return (int)err;
    if (n_tiles > 0) {
        merge_tables_kernel<<<grid, kThreads, 0, st>>>(
            a, (const long long*)counts_a, b, (const long long*)counts_b, s,
            n_tiles, cap, (long long*)out_keys, (long long*)out_counts);
        if ((err = cudaGetLastError())) return (int)err;
    }
    if (out_rows > 0) {
        merge_tables_fill<<<fill_blocks(out_rows), kFillThreads, 0, st>>>(
            (const long long*)n_unique, out_rows, (long long*)out_keys,
            (long long*)out_counts);
    }
    return (int)cudaGetLastError();
}

// int64 entries of the scratch a run table of n sorted keys needs
long long run_table_scratch(long long n) { return kRunTiles + 2 * tiles(n); }

// The sentinel table of n sorted int64 keys (sentinels last) into
// out_keys / out_counts (rows <= n rows, each 16-byte aligned): the
// first `rows` runs of equal keys below the first sentinel, each as its
// key and length, then (sentinel, 0) rows; meta (two int64) gets
// [n_unique, n_valid], the runs and the keys below the first sentinel.
// scratch holds run_table_scratch(n) int64 entries.
int run_table_launch(const void* sorted_keys, long long n, long long rows,
                     void* out_keys, void* out_counts, void* meta,
                     void* scratch, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const long long n_tiles = tiles(n);
    auto s = (const long long*)sorted_keys;
    auto sc = (long long*)scratch;
    if (n_tiles > 0x7FFFFFFFLL || rows < 0 || rows > n)
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)out_keys % 16 || (uintptr_t)out_counts % 16)
        return (int)cudaErrorMisalignedAddress;
    const unsigned grid = (unsigned)n_tiles;
    cudaError_t err;
    run_table_live_rows<<<1, 32, 0, st>>>(s, n, sc);
    if ((err = cudaGetLastError())) return (int)err;
    if (n_tiles > 0) {
        run_table_count<<<grid, kThreads, 0, st>>>(s, sc, n_tiles);
        if ((err = cudaGetLastError())) return (int)err;
    }
    run_table_scan<<<1, kScanThreads, 0, st>>>(sc, n_tiles, (long long*)meta);
    if ((err = cudaGetLastError())) return (int)err;
    if (n_tiles > 0) {
        run_table_kernel<<<grid, kThreads, 0, st>>>(
            s, sc, n_tiles, rows, (long long*)out_keys,
            (long long*)out_counts);
        if ((err = cudaGetLastError())) return (int)err;
    }
    if (rows > 0) {
        run_table_fill<<<fill_blocks(rows), kFillThreads, 0, st>>>(
            sc, rows, (long long*)out_keys, (long long*)out_counts);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
