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
// the 4w shared-memory lookups per four positions set the time.  The
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().
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

template <int W>
__global__ void __launch_bounds__(kThreads)
pwm_scores_kernel(const uint32_t* __restrict__ words, long long n_positions,
                  const float* __restrict__ matrix, float* __restrict__ out) {
    // matrix is (4, W) row-major
    __shared__ float cols[W][4];
    for (int i = threadIdx.x; i < 4 * W; i += kThreads)
        cols[i >> 2][i & 3] = matrix[(i & 3) * W + (i >> 2)];
    __syncthreads();
    const int lane = threadIdx.x & 31;
    // lane l's positions sit 4l bases past a multiple of 128, so 8l mod
    // 32 bits into their word
    const unsigned bit = (unsigned)(lane & 3) * 8u;
    const long long n_spans = (n_positions + kSpan - 1) / kSpan;
    const long long n_warps = (long long)gridDim.x * packed::kWarpsPerBlock;
    long long span = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    packed::Words3 next =
        packed::load_span_words(words, span, lane, n_positions);
    for (; span < n_spans; span += n_warps) {
        const packed::Words3 held = next;
        next = packed::load_span_words(words, span + n_warps, lane,
                                       n_positions);
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
            if (p + 3 < n_positions) {
                packed::store_streaming(out + p, acc0, acc1, acc2, acc3);
            } else {  // the last positions of a count not a multiple of 4
                if (p < n_positions) out[p] = acc0;
                if (p + 1 < n_positions) out[p + 1] = acc1;
                if (p + 2 < n_positions) out[p + 2] = acc2;
            }
        }
    }
}

template <int W>
void launch(const uint32_t* words, long long n_positions, const float* matrix,
            float* out, cudaStream_t stream) {
    pwm_scores_kernel<W>
        <<<packed::persistent_grid<pwm_scores_kernel<W>>(n_positions),
           kThreads, 0, stream>>>(words, n_positions, matrix, out);
}

// Runs the kernel built for `window`, one of 1..sizeof...(Ws).
template <int... Ws>
void launch_window(int window, std::integer_sequence<int, Ws...>,
                   const uint32_t* words, long long n_positions,
                   const float* matrix, float* out, cudaStream_t stream) {
    using Launch = void (*)(const uint32_t*, long long, const float*, float*,
                            cudaStream_t);
    constexpr Launch by_window[] = {&launch<Ws + 1>...};
    by_window[window - 1](words, n_positions, matrix, out, stream);
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
        launch_window(window, std::make_integer_sequence<int, kMaxWindow>(),
                      (const uint32_t*)words, n_positions,
                      (const float*)matrix, (float*)out,
                      (cudaStream_t)stream);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
