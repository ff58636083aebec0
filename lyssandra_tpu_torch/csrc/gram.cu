// Product kernel: C = A^T B in float32 for row-major A (p, M) and B (p, K),
// C (M, K) row-major.
//
// Serves the Gram form of the greedy and lasso kernels: alpha0 = X^T D
// (N, K), the D^T x that lyssandra_tpu/ops/pallas_fs.py::_kernel_fs_cold
// (K6) and lyssandra_tpu/ops/pallas_group.py::_kernel / ::_kernel_packed
// (K4/K5) compute inside their bodies, and the Gram matrix G = D^T D (K, K),
// once per call.  Every product is a float32 fma in order over p: no TF32,
// no tensor cores (the port's numerics policy is full float32).
//
// Design, as csrc/select.cu tiles r D: one block of 256 threads owns a
// BM x BN = 64 x 64 tile of C and walks p in slices of BP = 16 rows, staging
// the slice's 16 x 64 tiles of A and of B in shared memory (rows of both are
// contiguous in memory, so each staging load is coalesced and needs no
// transpose).  Thread (ty, tx) keeps the 4 x 4 products of C rows
// 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 in registers.  Rows past M,
// columns past K and slices past p are masked, so any M, K and p >= 1 run.
//
// What bounds it on an H100: the operations, 2 p M K flops against
// 4 (p M + p K + M K) bytes (at p=64, M=16,384, K=1,024: 2.1 GFLOP, 0.032 ms
// at the 67 TFLOP/s float32 peak, against 72 MB, 0.021 ms at 3.35 TB/s).
// The simple design issues two 16-byte shared-memory loads per 16 fmas and
// two barriers per slice, with no double buffering; a larger register tile
// and TMA-fed slices are later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;  // rows of C (columns of A) per block
constexpr int BN = 64;  // columns of C (columns of B) per block
constexpr int BP = 16;  // rows of A and B per staged slice
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gram_kernel(const float* __restrict__ A, const float* __restrict__ B, int p,
            int M, int K, float* __restrict__ C) {
    __shared__ __align__(16) float As[BP][BM];
    __shared__ __align__(16) float Bs[BP][BN];
    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const long long m0 = (long long)blockIdx.x * BM;
    const long long k0 = (long long)blockIdx.y * BN;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < p; c0 += BP) {
        __syncthreads();  // the last slice's reads are done
        for (int e = tid; e < BP * BM; e += THREADS) {
            const int c = c0 + e / BM;
            const long long m = m0 + e % BM;
            const long long k = k0 + e % BN;
            As[e / BM][e % BM] = (c < p && m < M) ? A[(size_t)c * M + m] : 0.f;
            Bs[e / BN][e % BN] = (c < p && k < K) ? B[(size_t)c * K + k] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < BP; ++c) {
            const float4 a = *reinterpret_cast<const float4*>(&As[c][4 * ty]);
            const float4 b = *reinterpret_cast<const float4*>(&Bs[c][4 * tx]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const long long m = m0 + 4 * ty + i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const long long k = k0 + 4 * tx + j;
            if (k < K) C[(size_t)m * K + k] = acc[i][j];
        }
    }
}

}  // namespace

// A (p, M) and B (p, K) row-major float32; C (M, K) row-major float32.
// Returns cudaGetLastError() after the launch.
extern "C" int lyssa_gram(const float* A, const float* B, int p, int M, int K,
                          float* C, void* stream) {
    if (p < 1 || M < 1 || K < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const unsigned gy = (unsigned)((K + BN - 1) / BN);
    if (gy > 65535u) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((unsigned)((M + BM - 1) / BM), gy);
    gram_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        A, B, p, M, K, C);
    return static_cast<int>(cudaGetLastError());
}
