// Fused selection: k_n = the lowest index among the maxima of |r_n . d_k|
// over the atoms k, for every row n of r, without writing the (N, K)
// correlation to memory.
//
// Replaces lyssandra_tpu/ops/pallas_select.py::_kernel (K7), the OMP
// selection step behind greedy._omp_impl(fused_select=True).
//
// r (N, p) and D (p, K), both row-major float32; k_out (N,) int32.  With
// BF16 both operands are rounded to bfloat16 (round to nearest even) as
// they are staged, and the products are summed in float32: the product of
// two bf16 values is exact in float32, so only the order of the sums
// differs from the plain version r.bfloat16().float() @ D.bfloat16().float().
//
// Design: one block of 256 threads owns a tile of BM = 64 rows of r, which
// it keeps in shared memory (transposed, rows padded to the 16-float chunk)
// for the whole run.  It streams D through shared memory in tiles of
// BP = 16 rows by BN = 64 atoms.  Thread (ty, tx) computes the 4 x 4
// products of rows 4 ty .. 4 ty + 3 and atoms 4 tx .. 4 tx + 3 of each atom
// tile, over all of p, in registers, then folds them into a running
// (best, index) per row.  Atoms rise within a thread and the comparison is
// a strict >, so the first maximum stays; the 16 threads that share rows
// then combine with xor shuffles, taking the lower index on equal values.
// The (N, K) product never leaves registers.  Shapes need no padding:
// rows past N, p and K are masked.
//
// What bounds it on an H100: the operations.  At the Batch-OMP shape
// (N=262,144, p=64, K=1024) it does 2 N p K = 3.4e10 flops, 0.51 ms at the
// 67 TFLOP/s float32 peak outside the tensor cores, against 68 MB of r read
// once (0.020 ms at 3.35 TB/s).  With bf16 operands on the tensor cores
// (989 TFLOP/s) the operations would take 0.035 ms.  What holds this simple
// design back: each step of the inner loop issues two 16-byte shared-memory
// loads for 16 fused multiply-adds, D is staged with plain loads and two
// barriers per tile, with no double buffering, and the bf16 mode runs on
// the float32 units.  wgmma for the bf16 mode, TMA-fed tiles and a larger
// register tile are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;       // rows of r per block
constexpr int BN = 64;       // atoms per D tile
constexpr int BP = 16;       // rows of D per D tile
constexpr int AS = BM + 4;   // row stride of the transposed r tile
constexpr int THREADS = 256;

__host__ __device__ inline int padded_p(int p) {
    return (p + BP - 1) / BP * BP;
}

__host__ __device__ inline size_t smem_bytes(int p) {
    return sizeof(float) * ((size_t)padded_p(p) * AS + (size_t)BP * BN);
}

template <bool BF16>
__device__ __forceinline__ float stage(float v) {
    return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
select_kernel(const float* __restrict__ r, const float* __restrict__ D, int p,
              int K, int N, int* __restrict__ k_out) {
    extern __shared__ __align__(16) float smem[];
    const int pp = padded_p(p);
    float* As = smem;                        // (pp, AS): As[c][m] = r[n0+m][c]
    float* Bs = smem + (size_t)pp * AS;      // (BP, BN)
    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const long long n0 = (long long)blockIdx.x * BM;

    // the block's rows of r, read once (coalesced along p), zero past N, p
    for (int e = tid; e < BM * pp; e += THREADS) {
        const int m = e / pp;
        const int c = e - m * pp;
        const long long n = n0 + m;
        float v = 0.f;
        if (n < N && c < p) v = stage<BF16>(r[n * p + c]);
        As[c * AS + m] = v;
    }

    float best[4];
    int bidx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        best[i] = -1.f;
        bidx[i] = 0;
    }

    for (int k0 = 0; k0 < K; k0 += BN) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

        for (int c0 = 0; c0 < pp; c0 += BP) {
            __syncthreads();  // As is written; the last tile's reads are done
            for (int e = tid; e < BP * BN; e += THREADS) {
                const int c = c0 + e / BN;
                const int k = k0 + (e % BN);
                float v = 0.f;
                if (c < p && k < K) v = stage<BF16>(D[(size_t)c * K + k]);
                Bs[e] = v;
            }
            __syncthreads();
#pragma unroll
            for (int c = 0; c < BP; ++c) {
                const float4 a = *reinterpret_cast<const float4*>(
                    &As[(c0 + c) * AS + 4 * ty]);
                const float4 b =
                    *reinterpret_cast<const float4*>(&Bs[c * BN + 4 * tx]);
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
        }

        // atoms rise within the thread: a strict > keeps the first maximum
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int k = k0 + 4 * tx + j;
            if (k < K) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float s = fabsf(acc[i][j]);
                    if (s > best[i]) {
                        best[i] = s;
                        bidx[i] = k;
                    }
                }
            }
        }
    }

    // the 16 threads of one row group (tx = 0..15) are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int m = 8; m > 0; m >>= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, best[i], m);
            const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], m);
            if (ob > best[i] || (ob == best[i] && oi < bidx[i])) {
                best[i] = ob;
                bidx[i] = oi;
            }
        }
    }
    if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const long long n = n0 + 4 * ty + i;
            if (n < N) k_out[n] = bidx[i];
        }
    }
}

template <bool BF16>
cudaError_t launch(const float* r, const float* D, int p, int K, int N,
                   int* k_out, cudaStream_t stream) {
    const size_t smem = smem_bytes(p);
    cudaError_t e = cudaFuncSetAttribute(
        select_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    const unsigned blocks = (unsigned)((N + BM - 1) / BM);
    select_kernel<BF16><<<blocks, THREADS, smem, stream>>>(r, D, p, K, N,
                                                           k_out);
    return cudaGetLastError();
}

}  // namespace

// The dynamic shared memory one block takes at signal length p (what
// ops/cuda_select.py::smem_bytes must agree with).
extern "C" size_t lyssa_select_smem_bytes(int p) { return smem_bytes(p); }

// r (N, p) and D (p, K) row-major float32; k_out (N,) int32.  bf16 != 0
// rounds both operands to bfloat16.  Returns cudaGetLastError() after the
// launch.
extern "C" int lyssa_select_abs_argmax(const float* r, const float* D, int p,
                                       int K, int N, int bf16, int* k_out,
                                       void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = bf16 ? launch<true>(r, D, p, K, N, k_out, s)
                         : launch<false>(r, D, p, K, N, k_out, s);
    return static_cast<int>(e);
}
