// Hand-written Hopper (sm_90a) kernel of the motif scan.
//
// pwm_scores_kernel replaces the Pallas _pwm_block_kernel
// (bionumpy_tpu/ops/pallas_pwm.py:32) and the XLA offset scan it stands in
// for off the TPU (bionumpy_tpu/ops/pwm.py:35 pwm_scores_packed): the
// float32 score sum_j M[code(p+j), j] at every position p of the 2-bit
// packed base stream, in position order.  Words are uint32, 16 bases each,
// base i of a word in bits 2i..2i+1, followed by two halo words, so the
// window (at most 32 bases, 64 bits) of every position p < n_positions
// lies inside words[p>>4 .. (p>>4)+2].  A -inf matrix cell flows through
// the sum as -inf.
//
// Exactness: the score is accumulated in float32 in the order j = 0..w-1,
// starting from 0.0f, exactly as the JAX package and the plain version
// add; there is no product to contract into an FMA, and the library is
// built without --use_fast_math, so every add rounds as IEEE float32.
//
// Bound: at w = 11 it reads 1/4 byte of words per position and writes 4
// bytes of score, so it is bound by bytes (2^25 positions: 142.6 MB,
// ~43 us at 3.35 TB/s); near w = 32 the ~5 operations per offset take
// over.  Design: one thread per position; the three words of a window
// come through the read-only cache (__ldg), so neighbouring threads share
// each word from L1; the matrix sits in shared memory as float[32][4],
// indexed [j][code], so the four codes a warp reads at offset j fall in
// four banks and never conflict (__constant__ memory would serialise the
// divergent reads).  There is no de-interleaved (offset, word) layout:
// that exists for the TPU's vector unit only.  The entry point launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWindow = 32;

__global__ void pwm_scores_kernel(const uint32_t* __restrict__ words,
                                  long long n_positions,
                                  const float* __restrict__ matrix,
                                  int window, float* __restrict__ out) {
    __shared__ float cols[kMaxWindow][4];
    // matrix is (4, window) row-major: matrix[code * window + j]
    for (int i = threadIdx.x; i < 4 * window; i += blockDim.x)
        cols[i % window][i / window] = matrix[i];
    __syncthreads();
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n_positions) return;
    const long long w = p >> 4;
    const unsigned bit = (unsigned)(p & 15) * 2u;
    unsigned long long v =
        ((unsigned long long)__ldg(words + w) |
         ((unsigned long long)__ldg(words + w + 1) << 32)) >> bit;
    // a shift by 64 is undefined: the third word joins only when the
    // window starts inside the first one (JAX's where(bit > 0, ...))
    if (bit) v |= (unsigned long long)__ldg(words + w + 2) << (64 - bit);
    float acc = 0.0f;
    for (int j = 0; j < window; ++j)
        acc += cols[j][(v >> (2 * j)) & 3u];
    out[p] = acc;
}

}  // namespace

extern "C" {

// out[p] for p < n_positions; words holds n_positions/16 + 2 words and
// matrix 4 * window floats, 1 <= window <= 32.
int pwm_scores_launch(const void* words, long long n_positions,
                      const void* matrix, int window, void* out,
                      void* stream) {
    if (window < 1 || window > kMaxWindow)
        return (int)cudaErrorInvalidValue;
    if (n_positions > 0) {
        const long long blocks = (n_positions + kThreads - 1) / kThreads;
        pwm_scores_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
            (const uint32_t*)words, n_positions, (const float*)matrix,
            window, (float*)out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
