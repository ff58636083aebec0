// Product kernel: C = A^T B in float32 for row-major A (p, M) and B (p, K),
// C (M, K) row-major; or, asked for a symmetric product, C = A^T A.
//
// Serves the Gram form of the greedy and lasso kernels: alpha0 = X^T D
// (N, K), the D^T x that lyssandra_tpu/ops/pallas_fs.py::_kernel_fs_cold
// (K6) and lyssandra_tpu/ops/pallas_group.py::_kernel / ::_kernel_packed
// (K4/K5) compute inside their bodies, and the Gram matrix G = D^T D (K, K)
// that K1/K2 (csrc/omp_fused.cu), K4 and K6 read, once per call.  Every
// product is a float32 fma in order over p: no TF32, no tensor cores (the
// port's numerics policy is full float32).
//
// What bounds it on an H100: the operations, 2 p M K flops against
// 4 (p M + p K + M K) bytes (at p=64, M=16,384, K=1,024: 2.1 GFLOP, 0.032 ms
// at the 67 TFLOP/s float32 peak, against 72 MB, 0.021 ms at 3.35 TB/s).
// So the design feeds the fma units: a block of 256 threads owns a
// 128 x 128 tile of C, 8 x 8 outputs a thread (one 16-byte shared-memory
// load of A and of B per 32 fmas), and walks p in slices of 16 rows,
// staged in shared memory by cp.async into two buffers, so the next
// slice's loads overlap this slice's fmas, with one barrier a slice
// (csrc/gemm_tile.cuh).  At every main-path shape this tile ran faster on
// the H100 than 64 x 64 tiles at 4 x 4 a thread, even where it gives
// fewer blocks than SMs, and two buffers of deeper slices faster than
// three or four of shallower ones (PERF.md, section 6).
// A symmetric product computes only the tiles on or above the diagonal,
// 64 x 64 at 4 x 4 a thread (a 1,024^2 Gram matrix is only 36 such tiles
// of 128^2, against 136 of 64^2 for 132 SMs), slices of 32 rows, and
// writes each off-diagonal tile twice, the mirror through shared memory
// so that both writes are coalesced.  fma(a, b, c) =
// fma(b, a, c), so the mirror is bitwise the entry the other triangle would
// have computed.  Rows past M, columns past K and slices past p are zero
// filled, so any M, K and p >= 1 run.
#include <cuda_runtime.h>
#include <stddef.h>

#include "gemm_tile.cuh"

namespace {

constexpr int NSTAGE = 2;             // staged slices in the ring
constexpr int SMEM_FLOATS = 8192;     // NSTAGE BP (BM + BN) of both tiles

// SYM: C = A^T A from the tiles on or above the diagonal, each
// off-diagonal tile mirrored through shared memory.
template <int BM, int BN, int TM, int TN, int BP, int MIN_BLOCKS, bool SYM>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MIN_BLOCKS)
gram_kernel(const float* __restrict__ A, const float* __restrict__ B, int p,
            int M, int K, float* __restrict__ C) {
    using Tl = lyssa::Tile<BM, BN, TM, TN>;
    constexpr int NT = Tl::NT;
    static_assert(NSTAGE * BP * (BM + BN) <= SMEM_FLOATS, "staging ring");
    static_assert(!SYM || (BM == BN && BN * (BM + 1) <= SMEM_FLOATS),
                  "the mirror tile fits the staging ring");
    __shared__ __align__(16) float smem[SMEM_FLOATS];
    float* As = smem;                       // [NSTAGE][BP][BM]
    float* Bs = smem + NSTAGE * BP * BM;    // [NSTAGE][BP][BN]

    int bi = blockIdx.x, bj = blockIdx.y;
    if constexpr (SYM) {  // blockIdx.x counts the tiles on or above the
                          // diagonal
        const int nt = (K + BN - 1) / BN;
        int rem = blockIdx.x;
        bi = 0;
        while (rem >= nt - bi) {
            rem -= nt - bi;
            ++bi;
        }
        bj = bi + rem;
    }
    const long long m0 = (long long)bi * BM;
    const long long k0 = (long long)bj * BN;
    const int tx = threadIdx.x % Tl::TX;
    const int ty = threadIdx.x / Tl::TX;
    const bool va = (M & 3) == 0 && ((size_t)A & 15) == 0;
    const bool vb = (K & 3) == 0 && ((size_t)B & 15) == 0;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    lyssa::pipeline<NSTAGE>(
        (p + BP - 1) / BP,
        [&](int s, int buf) {
            lyssa::stage_tile<BP, BM, NT>(As + buf * BP * BM, A, p, M,
                                          s * BP, m0, va);
            lyssa::stage_tile<BP, BN, NT>(Bs + buf * BP * BN, B, p, K,
                                          s * BP, k0, vb);
        },
        [&](int, int buf) {
            Tl::template mma<BP>(acc, As + buf * BP * BM, BM,
                                 Bs + buf * BP * BN, BN, ty, tx);
        });

    const bool vc = (K & 3) == 0 && ((size_t)C & 15) == 0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long m = m0 + Tl::row(ty, i);
        if (m >= M) continue;
        float* crow = C + (size_t)m * K;
#pragma unroll
        for (int g = 0; g < TN / Tl::CV; ++g) {
            const long long k = k0 + Tl::col(tx, g * Tl::CV);
            if (vc && Tl::CV == 4) {
                if (k < K)
                    *reinterpret_cast<float4*>(crow + k) = make_float4(
                        acc[i][g * 4], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                        acc[i][g * 4 + 3]);
            } else {
#pragma unroll
                for (int j = 0; j < Tl::CV; ++j)
                    if (k + j < K) crow[k + j] = acc[i][g * Tl::CV + j];
            }
        }
    }

    // the mirror tile C[k0.., m0..] of a symmetric product
    if constexpr (SYM) {
        if (bi != bj) {
            float* Ts = smem;  // [BN][BM + 1]; the pipeline's last
                               // barrier freed the staging ring
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    Ts[Tl::col(tx, j) * (BM + 1) + Tl::row(ty, i)] =
                        acc[i][j];
            __syncthreads();
            for (int e = threadIdx.x; e < BN * BM; e += NT) {
                const int c = e / BM;
                const int r = e % BM;
                if (k0 + c < K && m0 + r < M)
                    C[(size_t)(k0 + c) * M + m0 + r] = Ts[c * (BM + 1) + r];
            }
        }
    }
}

}  // namespace

// A (p, M) and B (p, K) row-major float32; C (M, K) row-major float32.
// symmetric != 0: B is A (M == K) and C = A^T A from the tiles on or above
// the diagonal.  Returns cudaGetLastError() after the launch.
extern "C" int lyssa_gram(const float* A, const float* B, int p, int M, int K,
                          int symmetric, float* C, void* stream) {
    if (p < 1 || M < 1 || K < 1 || (symmetric && (M != K || A != B)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (symmetric) {
        const long long nt = (K + 63) / 64;
        const dim3 grid((unsigned)(nt * (nt + 1) / 2));
        gram_kernel<64, 64, 4, 4, 32, 4, true><<<grid, 256, 0, s>>>(A, A, p,
                                                                    M, K, C);
    } else {
        const dim3 grid((unsigned)((M + 127) / 128),
                        (unsigned)((K + 127) / 128));
        if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
        gram_kernel<128, 128, 8, 8, 16, 2, false><<<grid, 256, 0, s>>>(
            A, B, p, M, K, C);
    }
    return static_cast<int>(cudaGetLastError());
}
