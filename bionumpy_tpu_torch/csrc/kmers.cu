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
// positions rise, galloping over runs of empty or one-base rows (both in
// packed_span.cuh, which kernel 3's match mode shares).  Lane l
// takes positions 64i + 2l and 64i + 2l + 1 of the span and writes both
// keys as one evict-first 16-byte store, so every store instruction of a
// warp writes 512 contiguous bytes; the window words come by shuffle from
// the lane that loaded them, and a persistent grid walks the spans.  On
// that card (chip_smoke.py, 2^25 positions, k = 31) it takes 0.107 ms, 1.3x
// its bound, against 0.094 ms for fill_ over the same 268 MB: what is left
// is reading the words and the row ends inside the write stream.
//
// Its canonical mode (the template's Canonical = true, a launch of its own)
// keys each valid window by the lesser of its hash and the hash of its
// reverse complement, whose codes are 3 - c in reverse order.  The
// complement of the window's 2k bits is ~key; __brevll reverses all 64
// bits, which puts base j's 2-bit group at group 31 - j with its two bits
// swapped; one pair swap restores them and a shift by 64 - 2k brings group
// k-1-j down to j, pushing the complemented bits above 2k out.  So no
// second row walk and no second read of the words.  The forward instance
// compiles to the code it had before the mode existed.
//
// kmer_fullsum_kernel replaces the Pallas _fullsum_kernel
// (bionumpy_tpu/ops/pallas_kmers.py:63): sums mod 2^32 of the low and the
// high 32 bits of every window hash, validity ignored.  It writes 8 bytes
// and reads 1/4 byte per position (8.4 MB at 2^25 positions, 2.5 us at
// 3.35 TB/s).  Summed over the positions, every code of the stream counts
// with one weight fixed by k, except the k-1 codes at either end, so the
// kernel sums the codes (two popcounts per word, two 16-byte loads in
// flight a lane) and one warp adds the edge codes with their own weights;
// a block reduces by shuffle and shared memory and adds one atomic pair.
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) a launch takes
// 3.2 us of device time at 2^25 positions for k = 31 and k = 15, 1.3x its
// byte bound, and 2.0 us over a 2^22-position checksum chunk, where the
// launch and the reduction's tail are what is left; CUDA events around
// back-to-back launches read 4-9 us, the host's ctypes launch rate.  Its
// first design, one thread per position (28 SASS instructions each:
// three word loads, a 64-bit shift, a mask) and one atomic pair per warp,
// took 53-54 us of device time.  A window-by-window design (a lane per
// word, 16 funnel shifts a limb) was slower, held by integer issue.
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
using packed::kWordBases;
using packed::first_row_past;
using packed::row_after;

constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;

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

// Bits 2j and 2j+1 of x exchanged for every j.
__device__ __forceinline__ unsigned long long swap_pairs(
        unsigned long long x) {
    return ((x >> 1) & 0x5555555555555555ull) |
           ((x & 0x5555555555555555ull) << 1);
}

// The lesser of the k-mer key `key` (2k bits, base j in bits 2j..2j+1) and
// the key of its reverse complement.
__device__ __forceinline__ long long canonical_key(long long key,
                                                   unsigned rc_shift) {
    const unsigned long long rc =
        swap_pairs(__brevll(~(unsigned long long)key)) >> rc_shift;
    return min(key, (long long)rc);
}

// The window's sort key: its hash, or in canonical mode the canonical one.
template <bool Canonical>
__device__ __forceinline__ long long window_sort_key(
        const packed::Words3& w, unsigned bit, uint32_t mlo, uint32_t mhi,
        unsigned rc_shift) {
    const long long key = window_key(w, bit, mlo, mhi);
    if constexpr (Canonical) return canonical_key(key, rc_shift);
    return key;
}

template <bool Canonical>
__global__ void __launch_bounds__(kThreads)
kmer_keys_kernel(const uint32_t* __restrict__ words,
                 const int32_t* __restrict__ ends, int n_rows,
                 long long n_positions, long long n_true, int k,
                 unsigned long long mask, long long* __restrict__ keys) {
    const int lane = threadIdx.x & 31;
    const unsigned rc_shift = 64u - 2u * (unsigned)k;
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
                if (e - p >= k)
                    key0 = window_sort_key<Canonical>(w, bit, mlo, mhi,
                                                      rc_shift);
            }
            if (p + 1 < limit) {
                if (e <= p + 1) {
                    r = row_after(ends, last, r, p + 1);
                    e = __ldg(ends + r);
                }
                if (e - (p + 1) >= k)
                    key1 = window_sort_key<Canonical>(w, bit + 2, mlo, mhi,
                                                      rc_shift);
            }
            if (p + 1 < n_positions)
                packed::store_streaming(keys + p, key0, key1);
            else if (p < n_positions)
                keys[p] = key0;
        }
    }
}

// Adds lo and hi of every thread of the block and then, from thread 0,
// into out[0] and out[1]: one atomic pair per block.  Every thread of the
// block must call it.
__device__ __forceinline__ void block_add(unsigned lo, unsigned hi,
                                          unsigned* __restrict__ out) {
    __shared__ unsigned part[2][packed::kWarpsPerBlock];
    for (int off = 16; off > 0; off >>= 1) {
        lo += __shfl_down_sync(0xffffffffu, lo, off);
        hi += __shfl_down_sync(0xffffffffu, hi, off);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        part[0][warp] = lo;
        part[1][warp] = hi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        lo = hi = 0;
#pragma unroll
        for (int w = 0; w < packed::kWarpsPerBlock; ++w) {
            lo += part[0][w];
            hi += part[1][w];
        }
        atomicAdd(out, lo);
        atomicAdd(out + 1, hi);
    }
}

// The sum of the 16 base codes (2-bit digits) of a word.
__device__ __forceinline__ unsigned digit_sum(uint32_t x) {
    return __popc(x) + __popc(x & 0xAAAAAAAAu);
}

__device__ __forceinline__ unsigned digit_sum(const uint4& x) {
    return digit_sum(x.x) + digit_sum(x.y) + digit_sum(x.z) + digit_sum(x.w);
}

// 4^0 + ... + 4^(e-1): the weight of a code that every window of a limb
// of e bases covers once at each of its offsets.
__device__ __forceinline__ unsigned full_weight(int e) {
    return (unsigned)(((1ull << (2 * e)) - 1) / 3);
}

// The weight of code i in the sum over positions 0..n-1 of a limb that
// holds the window's bases o..o+e-1: sum of 4^(j-o) over the j in
// [o, o+e) with 0 <= i-j < n.
__device__ __forceinline__ unsigned edge_weight(long long i, long long n,
                                                int o, int e) {
    const long long first = max((long long)o, i - n + 1);
    const long long last = min((long long)(o + e - 1), i);
    if (first > last) return 0u;
    return (unsigned)(((1ull << (2 * (last - o + 1))) -
                       (1ull << (2 * (first - o)))) / 3);
}

// 16-byte loads a lane of kmer_fullsum_kernel has in flight at once.
constexpr int kSumLoads = 2;

// The sums of the low and high limbs by their closed form.  The low limb
// of window p is sum(code_{p+j} 4^j, j < e) with e = min(k, 16), so
// summed over the positions p < n every code i in [k-1, n) counts with
// the same weight G = (4^e - 1)/3; the high limb (bases 16..k-1) gives
// the codes in [k-1, n+16) the weight H = (4^(k-16) - 1)/3.  So
//   lo = G * D + edges,   hi = H * D + edges,
// with D the sum of the codes 0..n-1 (popcounts of the words) and the
// edges the codes in [0, k-1) and [n, n+k-1), each times its own weight
// less the full one it was counted with in D: at most 60 codes, one lane
// each in the first warp.  Exact mod 2^32 for every k in 1..31.
__global__ void __launch_bounds__(kThreads)
kmer_fullsum_kernel(const uint32_t* __restrict__ words,
                    long long n_positions, int k,
                    unsigned* __restrict__ out) {
    // the whole words as 16-byte loads from the first aligned one (the
    // body); the words before it, the whole words after it and the
    // partial word are loose words, one a lane of the first warp
    const long long n_whole = n_positions >> 4;
    const long long head = min(
        (long long)(((16u - ((uintptr_t)words & 15u)) & 15u) >> 2), n_whole);
    const uint4* body = reinterpret_cast<const uint4*>(words + head);
    const long long n_vec = (n_whole - head) >> 2;
    const long long tail = head + 4 * n_vec;
    const int rest = (int)(n_positions & 15);
    const long long edge = k - 1;
    // the first warp of block 0 loads its loose word and the words of its
    // edge codes (lane l: codes l and max(n, k-1) + l) before its share
    // of the body, so that all its loads are in flight together
    const bool edge_warp = blockIdx.x == 0 && threadIdx.x < 32;
    const int lane = threadIdx.x & 31;
    uint32_t loose = 0;
    const long long at[2] = {lane, max(n_positions, edge) + lane};
    const long long stops[2] = {edge, n_positions + edge};
    uint32_t at_word[2] = {0u, 0u};
    if (edge_warp) {
        const long long q = lane < head ? lane : tail + (lane - head);
        if (q < n_whole) {
            loose = __ldg(words + q);
        } else if (q == n_whole && rest) {
            loose = __ldg(words + q) & ((1u << (2 * rest)) - 1u);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
            if (at[r] < stops[r]) at_word[r] = __ldg(words + (at[r] >> 4));
    }
    unsigned digits = 0;
    const long long stride = (long long)gridDim.x * kThreads;
    long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
    for (; v + (kSumLoads - 1) * stride < n_vec; v += kSumLoads * stride) {
        uint4 x[kSumLoads];
#pragma unroll
        for (int u = 0; u < kSumLoads; ++u)
            x[u] = __ldg(body + v + u * stride);
#pragma unroll
        for (int u = 0; u < kSumLoads; ++u) digits += digit_sum(x[u]);
    }
    for (; v < n_vec; v += stride) digits += digit_sum(__ldg(body + v));
    const int e_lo = min(k, 16), e_hi = max(k - 16, 0);
    unsigned lo = 0, hi = 0;
    if (edge_warp) {
        digits += digit_sum(loose);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const long long i = at[r];
            if (i >= stops[r]) continue;
            const unsigned c = (at_word[r] >> (2 * (unsigned)(i & 15))) & 3u;
            const bool inside = i < n_positions;
            lo += c * (edge_weight(i, n_positions, 0, e_lo) -
                       (inside ? full_weight(e_lo) : 0u));
            hi += c * (edge_weight(i, n_positions, 16, e_hi) -
                       (inside ? full_weight(e_hi) : 0u));
        }
    }
    lo += full_weight(e_lo) * digits;
    hi += full_weight(e_hi) * digits;
    block_add(lo, hi, out);
}

unsigned long long hash_mask(int k) {
    return k >= 32 ? ~0ull : (1ull << (2 * k)) - 1;
}

template <bool Canonical>
int keys_launch(const void* words, const void* ends, int n_rows,
                long long n_positions, long long n_true, int k, void* keys,
                void* stream) {
    if ((uintptr_t)keys % 16) return (int)cudaErrorMisalignedAddress;
    if (n_positions > 0) {
        kmer_keys_kernel<Canonical>
            <<<packed::persistent_grid<kmer_keys_kernel<Canonical>>(
                   n_positions),
               kThreads, 0, (cudaStream_t)stream>>>(
                (const uint32_t*)words, (const int32_t*)ends, n_rows,
                n_positions, n_true, k, hash_mask(k), (long long*)keys);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// keys[p] for p < n_positions; words holds n_positions/16 + 2 words, ends
// n_rows cumulative row ends, and keys is 16-byte aligned.
int kmer_keys_launch(const void* words, const void* ends, int n_rows,
                     long long n_positions, long long n_true, int k,
                     void* keys, void* stream) {
    return keys_launch<false>(words, ends, n_rows, n_positions, n_true, k,
                              keys, stream);
}

// The same in canonical mode: the canonical key of each valid window.
int kmer_keys_canonical_launch(const void* words, const void* ends,
                               int n_rows, long long n_positions,
                               long long n_true, int k, void* keys,
                               void* stream) {
    return keys_launch<true>(words, ends, n_rows, n_positions, n_true, k,
                             keys, stream);
}

// out[0] += sum of low halves, out[1] += sum of high halves (mod 2^32)
// over positions 0..n_positions-1; words holds (n_positions+15)/16 + 2
// words.  The caller zeroes out first: the kernel only adds to it.
int kmer_fullsum_launch(const void* words, long long n_positions, int k,
                        void* out, void* stream) {
    if (n_positions > 0) {
        // enough blocks for kSumLoads 16-byte loads a lane
        const long long per_block = 64LL * kThreads * kSumLoads;
        kmer_fullsum_kernel<<<packed::persistent_blocks<kmer_fullsum_kernel>(
                                  (n_positions + per_block - 1) / per_block),
                              kThreads, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)words, n_positions, k, (unsigned*)out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
