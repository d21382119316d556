// What the kernels over the 2-bit-packed base stream share (kmers.cu,
// pwm.cu): the span of positions a warp owns, the span's words held one
// per lane, the walk through the cumulative row ends that finds the row
// of a position, and the persistent grid that walks the spans.
//
// Words are uint32, 16 bases each, base i of a word in bits 2i..2i+1,
// followed by two halo words, so the window (at most 32 bases) of every
// position p < n_positions lies inside words[p>>4 .. (p>>4)+2].  A span is
// 32 words (512 positions): lane l loads words w, w+1 and w+2 for the
// span's word w = 32*span + l with three coalesced loads, and a lane that
// needs the window words of word q takes them from lane q by shuffle.  A
// warp loads its next span's words while it works on this one: under the
// kernels' saturated write stream a read takes long to return.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace packed {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kWordBases = 16;
constexpr int kSpanWords = 32;  // one word per lane
constexpr long long kSpan = (long long)kSpanWords * kWordBases;

struct Words3 {
    uint32_t a, b, c;  // words q, q+1, q+2
};

// Lane `lane`'s words of span `span`; zero where the lane's word holds no
// position below n_positions, so nothing past the halo is read.
__device__ __forceinline__ Words3 load_span_words(
        const uint32_t* __restrict__ words, long long span, int lane,
        long long n_positions) {
    const long long w = span * kSpanWords + lane;
    if (w * kWordBases >= n_positions) return {0u, 0u, 0u};
    return {__ldg(words + w), __ldg(words + w + 1), __ldg(words + w + 2)};
}

// The words of the span's word q (0..31), from the lane that holds them;
// every lane of the warp must call it.
__device__ __forceinline__ Words3 span_words_at(const Words3& held, int q) {
    return {__shfl_sync(0xffffffffu, held.a, q),
            __shfl_sync(0xffffffffu, held.b, q),
            __shfl_sync(0xffffffffu, held.c, q)};
}

// 16-byte stores marked evict-first (st.global.cs): the output is written
// once, is far larger than L2, and should not push the words and the row
// ends out of it.  p is 16-byte aligned.
__device__ __forceinline__ void store_streaming(long long* p, long long a,
                                                long long b) {
    asm volatile("st.global.cs.v2.s64 [%0], {%1, %2};"
                 :: "l"(p), "l"(a), "l"(b) : "memory");
}

__device__ __forceinline__ void store_streaming(float* p, float a, float b,
                                                float c, float d) {
    asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
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

// Blocks of kThreads that fill every SM of the device with Kernel (SM
// count x resident blocks per SM), found at the first launch and kept, so
// later launches query nothing.  The kernels walk their spans in a
// grid-stride loop, so any grid computes the same result; this one fills
// the card.  0 when the device cannot be queried: the launch then fails
// and the caller's cudaGetLastError() reports it.
template <auto Kernel>
int resident_blocks() {
    static std::atomic<int> blocks{0};
    const int known = blocks.load(std::memory_order_relaxed);
    if (known) return known;
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      kThreads, 0) !=
            cudaSuccess)
        return 0;
    blocks.store(sms * per_sm, std::memory_order_relaxed);
    return sms * per_sm;
}

// Grid of a persistent launch that has work for `wanted` blocks: at most
// what stays resident.
template <auto Kernel>
unsigned persistent_blocks(long long wanted) {
    const long long resident = resident_blocks<Kernel>();
    return (unsigned)(wanted < resident ? wanted : resident);
}

// Grid of a persistent launch over n_positions: at most one warp a span.
template <auto Kernel>
unsigned persistent_grid(long long n_positions) {
    const long long spans = (n_positions + kSpan - 1) / kSpan;
    return persistent_blocks<Kernel>((spans + kWarpsPerBlock - 1) /
                                     kWarpsPerBlock);
}

}  // namespace packed
