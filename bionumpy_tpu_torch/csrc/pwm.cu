// Hand-written Hopper (sm_90a) kernel of the motif scan.
//
// pwm_scores_kernel replaces the Pallas _pwm_block_kernel
// (bionumpy_tpu/ops/pallas_pwm.py:32) and the XLA offset scan it stands in
// for off the TPU (bionumpy_tpu/ops/pwm.py:35 pwm_scores_packed): the
// float32 score sum_j M[code(p+j), j] at every position p of the 2-bit
// packed base stream (packed_span.cuh), in position order.  A -inf matrix
// cell flows through the sum as -inf.
//
// Exactness: every score is accumulated in float32 in the order
// j = 0..w-1, starting from 0.0f, exactly as the JAX package and the
// plain version add.  No table holds a sum of two cells ((a + b) + c
// rounds otherwise than a + (b + c)), there is no product to contract into
// an FMA, and the library is built without --use_fast_math, so every add
// rounds as IEEE float32.
//
// Bound: at w = 11 it reads 1/4 byte of words per position and writes 4
// bytes of score, so it is bound by bytes (2^25 positions: 142.6 MB,
// ~43 us at 3.35 TB/s); near w = 32 the lookups and adds take over.  Its
// first design, one thread per position, ran at 5.1x that bound on an
// NVIDIA H100 80GB HBM3 at 700 W: each of its 131,072 blocks reloaded the
// matrix with a division per cell, and the runtime window kept the offset
// loop rolled, with variable 64-bit shifts.  Now the kernel is a template
// on the window, so every shift and index is a constant and the loop
// unrolls; a persistent grid loads the matrix into shared memory once per
// block, as float[w][4] indexed [j][code] (the four codes a warp reads at
// offset j fall in four banks and never conflict), and walks the
// 512-position spans of packed_span.cuh.  Lane l scores the four positions
// 128i + 4l .. +3 of a span from one window string of 35 codes and writes
// them as one evict-first float4, so a warp's store is 512 contiguous
// bytes.  On that card (chip_smoke.py, 2^25 positions) it takes 0.063 ms
// at w = 11, 1.5x its bound, against 0.052 ms for fill_ over the same
// 134 MB, and 0.154 ms at w = 32, 1.8x its bound by operations, where
// the 4w shared-memory lookups per four positions set the time.
//
// Match mode (pwm_scores_kernel<W, true>, pwm_matches_launch) takes the
// place of the torch ops that a scan ran after the scores: the float32
// threshold, the row-end mask of valid_windows_plain and the compaction
// of the match positions (ops/pwm.pwm_match_compact), ~15 ops over int64
// positions that moved ~190 bytes a position and took 45x the kernel's
// time.  Each lane scores its four positions exactly as scores mode does,
// so the scores, and with them the matches, are bit for bit those of the
// scores mode followed by the torch ops; then a position matches when its
// score is strictly above the threshold, it lies below min(ends[last],
// n_true) and its window ends inside its row.  One ballot a 128-position
// step finds whether the warp holds a score above the threshold; only
// then is the span's row found (first_row_past, then row_after as a
// lane's positions rise, as kernel 1 walks them) and the warp's hits
// written, in position order, to slots that one atomicAdd a warp
// reserves.  Slots at or past the cap are counted, not written.  No score
// and no mask reaches memory: it reads the words (1/4 byte a position)
// and writes 8 bytes a match, so at w = 19 its operations bound it (105
// a position: 3.26 ms over 2,077,042,982 positions at 67 T/s).  On an
// NVIDIA H100 80GB HBM3 at 700 W it takes 5.3 ms there, 61% of that
// floor, against 6.0 ms for scores mode over the same positions and
// 255 ms for scores mode with the torch ops in blocks of 2^27.
//
// Every entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError().
#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

#include "packed_span.cuh"

namespace {

using packed::kSpan;
using packed::kThreads;

constexpr int kMaxWindow = 32;

// Code m of a lane's window string x: the string starts at the lane's
// first position, so code m is code m - t of its position t.  Bits
// 2m..2m+1 of x.a, x.b, x.c in turn; m < W + 3 <= 35 stays inside them.
// m is a constant once the loops unroll.
__device__ __forceinline__ unsigned code_at(const packed::Words3& x, int m) {
    const uint32_t word = m < 16 ? x.a : m < 32 ? x.b : x.c;
    return (word >> (2 * (m & 15))) & 3u;
}

// What match mode needs besides the words and the matrix (pwm_matches_launch).
struct Matches {
    const int32_t* ends;  // n_rows cumulative row ends
    int n_rows;
    long long n_true;  // the real base count
    float threshold;
    long long base;  // added to every position written
    long long cap;   // slots of `positions`
    unsigned long long* count;  // every match, those past cap too
    long long* positions;
};

// Writes the warp's hits of one 128-position step: bit j of `hits` marks
// position p + j of the lane.  The warp reserves its slots with one
// atomicAdd and writes them in position order, lane by lane; slots at or
// past cap are counted and not written.  Every lane of the warp must call
// it.
__device__ __forceinline__ void write_hits(unsigned hits, long long p,
                                           int lane, const Matches& m) {
    const unsigned below = (1u << lane) - 1u;
    unsigned before = 0, total = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const unsigned b = __ballot_sync(0xffffffffu, (hits >> j) & 1u);
        before += __popc(b & below);
        total += __popc(b);
    }
    if (!total) return;  // the same for the whole warp
    unsigned long long first = 0;
    if (lane == 0) first = atomicAdd(m.count, (unsigned long long)total);
    long long slot =
        (long long)__shfl_sync(0xffffffffu, first, 0) + (long long)before;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        if ((hits >> j) & 1u) {
            if (slot < m.cap) m.positions[slot] = m.base + p + j;
            ++slot;
        }
    }
}

// Scores mode (Match false): out[p] for every position.  Match mode: the
// positions p whose score is strictly above m.threshold and whose window
// [p, p + W) lies inside its row, below min(ends[last], n_true), written
// as m.base + p into m.positions and counted in m.count; no score is
// stored.  A step whose warp holds no score above the threshold costs one
// ballot; the rows are found (first_row_past, then row_after as the
// lane's positions rise) only for the spans and lanes that hold one.
template <int W, bool Match>
__global__ void __launch_bounds__(kThreads)
pwm_scores_kernel(const uint32_t* __restrict__ words, long long n_positions,
                  const float* __restrict__ matrix, float* __restrict__ out,
                  Matches m) {
    // matrix is (4, W) row-major
    __shared__ float cols[W][4];
    for (int i = threadIdx.x; i < 4 * W; i += kThreads)
        cols[i >> 2][i & 3] = matrix[(i & 3) * W + (i >> 2)];
    __syncthreads();
    const int lane = threadIdx.x & 31;
    // lane l's positions sit 4l bases past a multiple of 128, so 8l mod
    // 32 bits into their word
    const unsigned bit = (unsigned)(lane & 3) * 8u;
    // match mode: positions at or past limit start no valid window
    const int last = m.n_rows - 1;
    long long limit = 0;
    if (Match && m.n_rows > 0) {
        limit = min((long long)__ldg(m.ends + last), m.n_true);
        limit = min(limit, n_positions);
    }
    const long long n_spans = (n_positions + kSpan - 1) / kSpan;
    const long long n_warps = (long long)gridDim.x * packed::kWarpsPerBlock;
    long long span = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    packed::Words3 next =
        packed::load_span_words(words, span, lane, n_positions);
    for (; span < n_spans; span += n_warps) {
        const packed::Words3 held = next;
        next = packed::load_span_words(words, span + n_warps, lane,
                                       n_positions);
        // match mode: the lane's row r and its end e, found at the span's
        // first step with a hit (r < 0 until then, for the whole warp)
        int r = -1;
        long long e = 0;
#pragma unroll
        for (int i = 0; i < packed::kSpanWords / 8; ++i) {
            const packed::Words3 w =
                packed::span_words_at(held, 8 * i + (lane >> 2));
            const packed::Words3 x = {__funnelshift_r(w.a, w.b, bit),
                                      __funnelshift_r(w.b, w.c, bit),
                                      w.c >> bit};
            float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
#pragma unroll
            for (int j = 0; j < W; ++j) {
                acc0 += cols[j][code_at(x, j)];
                acc1 += cols[j][code_at(x, j + 1)];
                acc2 += cols[j][code_at(x, j + 2)];
                acc3 += cols[j][code_at(x, j + 3)];
            }
            const long long p = span * kSpan + 128 * i + 4 * lane;
            if constexpr (Match) {
                const float t = m.threshold;
                unsigned hits = (unsigned)(acc0 > t && p < limit) |
                                (unsigned)(acc1 > t && p + 1 < limit) << 1 |
                                (unsigned)(acc2 > t && p + 2 < limit) << 2 |
                                (unsigned)(acc3 > t && p + 3 < limit) << 3;
                if (!__ballot_sync(0xffffffffu, hits != 0u)) continue;
                if (r < 0) {  // a hit lies below limit, so ends[last] > s
                    r = packed::first_row_past(m.ends, last, span * kSpan,
                                               lane);
                    e = __ldg(m.ends + r);
                }
#pragma unroll 1
                for (int j = 0; j < 4; ++j) {  // rare: kept rolled
                    if (!((hits >> j) & 1u)) continue;
                    if (e <= p + j) {
                        r = packed::row_after(m.ends, last, r, p + j);
                        e = __ldg(m.ends + r);
                    }
                    if (e - (p + j) < W) hits &= ~(1u << j);
                }
                write_hits(hits, p, lane, m);
            } else if (p + 3 < n_positions) {
                packed::store_streaming(out + p, acc0, acc1, acc2, acc3);
            } else {  // the last positions of a count not a multiple of 4
                if (p < n_positions) out[p] = acc0;
                if (p + 1 < n_positions) out[p + 1] = acc1;
                if (p + 2 < n_positions) out[p + 2] = acc2;
            }
        }
    }
}

template <int W, bool Match>
void launch(const uint32_t* words, long long n_positions, const float* matrix,
            float* out, const Matches& m, cudaStream_t stream) {
    pwm_scores_kernel<W, Match>
        <<<packed::persistent_grid<pwm_scores_kernel<W, Match>>(n_positions),
           kThreads, 0, stream>>>(words, n_positions, matrix, out, m);
}

// Runs the kernel built for `window`, one of 1..sizeof...(Ws).
template <bool Match, int... Ws>
void launch_window(int window, std::integer_sequence<int, Ws...>,
                   const uint32_t* words, long long n_positions,
                   const float* matrix, float* out, const Matches& m,
                   cudaStream_t stream) {
    using Launch = void (*)(const uint32_t*, long long, const float*, float*,
                            const Matches&, cudaStream_t);
    constexpr Launch by_window[] = {&launch<Ws + 1, Match>...};
    by_window[window - 1](words, n_positions, matrix, out, m, stream);
}

}  // namespace

extern "C" {

// out[p] for p < n_positions; words holds n_positions/16 + 2 words, matrix
// 4 * window floats, 1 <= window <= 32, and out is 16-byte aligned.
int pwm_scores_launch(const void* words, long long n_positions,
                      const void* matrix, int window, void* out,
                      void* stream) {
    if (window < 1 || window > kMaxWindow)
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
    if (n_positions > 0) {
        launch_window<false>(window,
                             std::make_integer_sequence<int, kMaxWindow>(),
                             (const uint32_t*)words, n_positions,
                             (const float*)matrix, (float*)out, Matches{},
                             (cudaStream_t)stream);
    }
    return (int)cudaGetLastError();
}

// The match positions of the words' first n_positions positions (see
// pwm_scores_kernel's match mode): base + p into positions[0 .. cap), in
// no fixed order, and every match counted into *count, which the caller
// zeroes first.  ends holds n_rows int32 cumulative row ends.
int pwm_matches_launch(const void* words, long long n_positions,
                       const void* ends, int n_rows, long long n_true,
                       const void* matrix, int window, float threshold,
                       long long base, long long cap, void* count,
                       void* positions, void* stream) {
    if (window < 1 || window > kMaxWindow || cap < 0)
        return (int)cudaErrorInvalidValue;
    if (n_positions > 0) {
        const Matches m = {(const int32_t*)ends, n_rows,   n_true,
                           threshold,            base,     cap,
                           (unsigned long long*)count,
                           (long long*)positions};
        launch_window<true>(window,
                            std::make_integer_sequence<int, kMaxWindow>(),
                            (const uint32_t*)words, n_positions,
                            (const float*)matrix, nullptr, m,
                            (cudaStream_t)stream);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
