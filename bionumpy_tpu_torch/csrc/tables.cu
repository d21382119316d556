// Hand-written Hopper (sm_90a) kernel of the device table: the merge of
// two sorted sentinel tables into one of at most `cap` rows.
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

// (sentinel, 0) in rows [*n_unique, out_rows): an odd first row alone,
// then two rows a thread as evict-first 16-byte stores (the outputs are
// 16-byte aligned), then an odd last row
__global__ void merge_tables_fill(const long long* n_unique,
                                  long long out_rows,
                                  long long* __restrict__ out_keys,
                                  long long* __restrict__ out_counts) {
    const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    const long long first = *n_unique;
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

long long tiles(long long rows_in) { return (rows_in + kTile - 1) / kTile; }

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
        const long long blocks = (out_rows + kFillThreads - 1) / kFillThreads;
        merge_tables_fill<<<(unsigned)(blocks < kFillBlocks ? blocks
                                                            : kFillBlocks),
                            kFillThreads, 0, st>>>(
            (const long long*)n_unique, out_rows, (long long*)out_keys,
            (long long*)out_counts);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
