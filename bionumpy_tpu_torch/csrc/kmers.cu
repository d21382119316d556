// Hand-written Hopper (sm_90a) kernels of the k-mer path.
//
// Both read the 2-bit-packed base stream (packed_span.cuh).  The window
// hash is the little-endian polynomial sum(code_j * 4^j), i.e. the 64
// stream bits starting at bit 2p, masked to 2k bits.
//
// kmer_keys_kernel replaces the Pallas _kmer_block_kernel
// (bionumpy_tpu/ops/pallas_kmers.py:32) together with the XLA validity
// pass of kmer_sorted_runs_packed (bionumpy_tpu/ops/kmers.py:312-320): one
// int64 sort key per position, the hash where the window lies inside its
// row and before the data's end, the sentinel 2^63-1 elsewhere.  It is
// bound by the bytes of the keys it writes (8 per position: 268 MB at one
// full batch of 2^25 positions, ~80 us at 3.35 TB/s).  Its first design,
// one thread per position with a binary search over the row ends each
// (18 dependent loads over 2^18 ends), ran at 5.3x that bound on an
// NVIDIA H100 80GB HBM3 at 700 W: the searches' latency, not the stores,
// set its time.  So the row is found once per span of 512 positions, by a
// warp-wide 32-way search (__ballot_sync over 32 probes a round, ~5
// rounds), and each lane then walks forward through the row ends as its
// positions rise, galloping over runs of empty or one-base rows.  Lane l
// takes positions 64i + 2l and 64i + 2l + 1 of the span and writes both
// keys as one evict-first 16-byte store, so every store instruction of a
// warp writes 512 contiguous bytes; the window words come by shuffle from
// the lane that loaded them, and a persistent grid walks the spans.  On
// that card (chip_smoke.py, 2^25 positions, k = 31) it takes 0.107 ms, 1.3x
// its bound, against 0.094 ms for fill_ over the same 268 MB: what is left
// is reading the words and the row ends inside the write stream.
//
// kmer_fullsum_kernel replaces the Pallas _fullsum_kernel
// (bionumpy_tpu/ops/pallas_kmers.py:63): sums mod 2^32 of the low and the
// high 32 bits of every window hash, validity ignored.  It writes nothing
// and reads 1/4 byte per position, so its bound is the dozen integer
// operations a position takes.  Design: one thread per position in a
// grid-stride loop, the three words through the read-only cache (__ldg).
//
// There is no de-interleaved (offset, word) layout: that exists for the
// TPU's vector unit only.  Every entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "packed_span.cuh"

namespace {

using packed::kSpan;
using packed::kThreads;

constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kMaxSumBlocks = 132 * 8;  // SMs x resident blocks per SM

__device__ __forceinline__ unsigned long long window_at(
        const uint32_t* __restrict__ words, long long p,
        unsigned long long mask) {
    const long long w = p >> 4;
    const unsigned bit = (unsigned)(p & 15) * 2u;
    const unsigned long long low =
        (unsigned long long)__ldg(words + w) |
        ((unsigned long long)__ldg(words + w + 1) << 32);
    unsigned long long v = low >> bit;
    // a shift by 64 is undefined: the third word joins only when the
    // window starts inside the first one (JAX's where(bit > 0, ...))
    if (bit) v |= (unsigned long long)__ldg(words + w + 2) << (64 - bit);
    return v & mask;
}

// The masked hash of the window starting `bit` (0..30, even) bits into
// word a of the words a, b, c: its low and high 32 bits are funnel shifts,
// which also take bit = 0 (the third word then does not join).
__device__ __forceinline__ long long window_key(const packed::Words3& w,
                                                unsigned bit, uint32_t mlo,
                                                uint32_t mhi) {
    const uint32_t lo = __funnelshift_r(w.a, w.b, bit) & mlo;
    const uint32_t hi = __funnelshift_r(w.b, w.c, bit) & mhi;
    return (long long)(((unsigned long long)hi << 32) | lo);
}

// Warp-wide: the first row whose end lies past s, given ends[last] > s.
// Each round the 32 lanes probe 32 evenly spaced rows of the candidates
// and the ballot keeps the stretch between the last probe at or before s
// and the first past it, so 2^18 rows take 4-5 rounds.  Every lane of the
// warp must call it; all get the same row.
__device__ int first_row_past(const int32_t* __restrict__ ends, int last,
                              long long s, int lane) {
    int lo = 0, hi = last;  // the row lies in [lo, hi]
    while (lo < hi) {
        const int step = (hi - lo + 31) >> 5;
        const long long q = lo + (long long)lane * step;
        const bool past = q >= hi || (long long)__ldg(ends + q) > s;
        const unsigned ballot = __ballot_sync(0xffffffffu, past);
        if (!ballot) {  // every probe at or before s
            lo += 31 * step + 1;
            continue;
        }
        const int j = __ffs(ballot) - 1;  // the past probes are a suffix
        if (j == 0) return lo;
        const int next_lo = lo + (j - 1) * step + 1;
        hi = min((long long)hi, lo + (long long)j * step);
        lo = next_lo;
    }
    return lo;
}

// The first row past r whose end lies past p, given ends[r] <= p <
// ends[last]: one step, then a gallop and a binary search, so a run of
// empty or one-base rows costs its logarithm.
__device__ int row_after(const int32_t* __restrict__ ends, int last, int r,
                         long long p) {
    int lo = r, hi, step = 1;  // ends[lo] <= p < ends[hi]
    for (;;) {
        hi = lo + step;
        if (hi >= last) {
            hi = last;
            break;
        }
        if ((long long)__ldg(ends + hi) > p) break;
        lo = hi;
        step *= 2;
    }
    while (hi - lo > 1) {
        const int mid = lo + ((hi - lo) >> 1);
        if ((long long)__ldg(ends + mid) > p) hi = mid;
        else lo = mid;
    }
    return hi;
}

__global__ void __launch_bounds__(kThreads)
kmer_keys_kernel(const uint32_t* __restrict__ words,
                 const int32_t* __restrict__ ends, int n_rows,
                 long long n_positions, long long n_true, int k,
                 unsigned long long mask, long long* __restrict__ keys) {
    const int lane = threadIdx.x & 31;
    const int last = n_rows - 1;
    long long limit = n_rows > 0 ? (long long)__ldg(ends + last) : 0;
    if (n_true < limit) limit = n_true;
    const uint32_t mlo = (uint32_t)mask, mhi = (uint32_t)(mask >> 32);
    // lane l's positions sit 2l and 2l+1 bases past a multiple of 64, so
    // 4l mod 32 bits into their word
    const unsigned bit = (unsigned)(lane & 7) * 4u;
    const long long n_spans = (n_positions + kSpan - 1) / kSpan;
    const long long n_warps = (long long)gridDim.x * packed::kWarpsPerBlock;
    long long span = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    packed::Words3 next =
        packed::load_span_words(words, span, lane, n_positions);
    for (; span < n_spans; span += n_warps) {
        const long long s = span * kSpan;
        const packed::Words3 held = next;
        next = packed::load_span_words(words, span + n_warps, lane,
                                       n_positions);
        // the lane's row r and its end e: once past the row of the lane's
        // last valid position, e > that position
        int r = 0;
        long long e = 0;
        if (s < limit) {  // the same for the whole warp
            r = first_row_past(ends, last, s, lane);
            e = __ldg(ends + r);
        }
#pragma unroll
        for (int i = 0; i < packed::kSpanWords / 4; ++i) {
            const packed::Words3 w =
                packed::span_words_at(held, 4 * i + (lane >> 3));
            const long long p = s + 64 * i + 2 * lane;
            long long key0 = kSentinel, key1 = kSentinel;
            if (p < limit) {
                if (e <= p) {
                    r = row_after(ends, last, r, p);
                    e = __ldg(ends + r);
                }
                if (e - p >= k) key0 = window_key(w, bit, mlo, mhi);
            }
            if (p + 1 < limit) {
                if (e <= p + 1) {
                    r = row_after(ends, last, r, p + 1);
                    e = __ldg(ends + r);
                }
                if (e - (p + 1) >= k)
                    key1 = window_key(w, bit + 2, mlo, mhi);
            }
            if (p + 1 < n_positions)
                packed::store_streaming(keys + p, key0, key1);
            else if (p < n_positions)
                keys[p] = key0;
        }
    }
}

__global__ void kmer_fullsum_kernel(const uint32_t* __restrict__ words,
                                    long long n_positions,
                                    unsigned long long mask,
                                    unsigned int* __restrict__ out) {
    unsigned int lo = 0, hi = 0;  // wrapping adds: exact mod 2^32
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         p < n_positions; p += stride) {
        const unsigned long long v = window_at(words, p, mask);
        lo += (unsigned int)v;
        hi += (unsigned int)(v >> 32);
    }
    for (int off = 16; off > 0; off >>= 1) {
        lo += __shfl_down_sync(0xffffffffu, lo, off);
        hi += __shfl_down_sync(0xffffffffu, hi, off);
    }
    if ((threadIdx.x & 31) == 0) {
        atomicAdd(out, lo);
        atomicAdd(out + 1, hi);
    }
}

unsigned long long hash_mask(int k) {
    return k >= 32 ? ~0ull : (1ull << (2 * k)) - 1;
}

}  // namespace

extern "C" {

// keys[p] for p < n_positions; words holds n_positions/16 + 2 words, ends
// n_rows cumulative row ends, and keys is 16-byte aligned.
int kmer_keys_launch(const void* words, const void* ends, int n_rows,
                     long long n_positions, long long n_true, int k,
                     void* keys, void* stream) {
    if ((uintptr_t)keys % 16) return (int)cudaErrorMisalignedAddress;
    if (n_positions > 0) {
        kmer_keys_kernel<<<packed::persistent_grid<kmer_keys_kernel>(
                               n_positions),
                           kThreads, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)words, (const int32_t*)ends, n_rows,
            n_positions, n_true, k, hash_mask(k), (long long*)keys);
    }
    return (int)cudaGetLastError();
}

// out[0] += sum of low halves, out[1] += sum of high halves (mod 2^32);
// the caller zeroes out first.
int kmer_fullsum_launch(const void* words, long long n_positions, int k,
                        void* out, void* stream) {
    if (n_positions > 0) {
        long long blocks = (n_positions + kThreads - 1) / kThreads;
        if (blocks > kMaxSumBlocks) blocks = kMaxSumBlocks;
        kmer_fullsum_kernel<<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
            (const uint32_t*)words, n_positions, hash_mask(k),
            (unsigned int*)out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
