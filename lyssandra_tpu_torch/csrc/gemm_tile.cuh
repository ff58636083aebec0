// Register-tiled float32 product C += A^T B over staged slices, shared by
// csrc/gram.cu (C = A^T B in device memory) and csrc/omp_fused.cu (alpha0
// = X^T D of a block of lanes, kept in shared memory).
//
// Both operands are row-major with the summed dimension p outermost: a
// slice of BP rows of A (p, M) and of B (p, K) is a BP x BM and a BP x BN
// tile whose rows are contiguous in device memory, so staging needs no
// transpose.  `stage_tile` copies such a tile to shared memory with
// cp.async (16-byte copies where the rows allow it, else 4-byte ones),
// zero-filling whatever lies past the matrix, so the next slice's loads
// overlap this slice's fmas.  `Tile<BM, BN, TM, TN>::mma` then adds the
// slice to each thread's TM x TN accumulators.  Each product is a float32
// fma in order over p (no TF32, no tensor cores): a zero-filled row adds
// fma(a, 0, acc) = acc, so the result does not depend on the tiling.
// csrc/select.cu uses `Tile` with a warp layout of its own (`WX`) and the
// cp.async helpers for bfloat16 tiles too.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace lyssa {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows r0 .. r0 + BP - 1 and columns c0 .. c0 + BW - 1 of S (rows x
// cols, row-major) into dst (BP x BW, row-major), zero past the matrix.
// `vec`: cols % 4 == 0, c0 % 4 == 0 and S 16-byte aligned, so each group
// of four columns is wholly inside or wholly outside the matrix.
template <int BP, int BW, int NT>
__device__ __forceinline__ void stage_tile(float* dst,
                                           const float* __restrict__ S,
                                           int rows, long long cols, int r0,
                                           long long c0, bool vec) {
    const int tid = threadIdx.x;
    if (vec) {
#pragma unroll
        for (int e = tid; e < BP * BW / 4; e += NT) {
            const int r = e / (BW / 4);
            const int c = 4 * (e % (BW / 4));
            const bool in = r0 + r < rows && c0 + c < cols;
            cp_async16(dst + r * BW + c,
                       in ? S + (size_t)(r0 + r) * cols + c0 + c : S,
                       in ? 16 : 0);
        }
    } else {
#pragma unroll 4
        for (int e = tid; e < BP * BW; e += NT) {
            const int r = e / BW;
            const int c = e % BW;
            const bool in = r0 + r < rows && c0 + c < cols;
            cp_async4(dst + r * BW + c,
                      in ? S + (size_t)(r0 + r) * cols + c0 + c : S,
                      in ? 4 : 0);
        }
    }
}

// A ring of NSTAGE shared-memory buffers over `steps` steps:
// stage(i, buf) issues step i's cp.async copies into buffer buf, and
// compute(i, buf) consumes them.  Copies run NSTAGE - 1 steps ahead of the
// sums, with one barrier a step: the buffer a step refills was last read
// the step before, which every thread has left once it passes the barrier.
// Ends with every copy landed and a barrier, so the buffers may be reused.
template <int NSTAGE, class Stage, class Compute>
__device__ __forceinline__ void pipeline(int steps, Stage&& stage,
                                         Compute&& compute) {
    static_assert(NSTAGE >= 2, "a ring of at least two buffers");
#pragma unroll
    for (int i = 0; i < NSTAGE - 1; ++i) {
        if (i < steps) stage(i, i);
        cp_async_commit();  // empty groups keep the count
    }
    for (int it = 0; it < steps; ++it) {
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();
        const int next = it + NSTAGE - 1;
        if (next < steps) stage(next, next % NSTAGE);
        cp_async_commit();
        compute(it, it % NSTAGE);
    }
    cp_async_wait<0>();
    __syncthreads();
}

template <int V>
__device__ __forceinline__ void load_vec(float* d, const float* s) {
    if constexpr (V == 4) {
        const float4 v = *reinterpret_cast<const float4*>(s);
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
    } else if constexpr (V == 2) {
        const float2 v = *reinterpret_cast<const float2*>(s);
        d[0] = v.x;
        d[1] = v.y;
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) d[i] = s[i];
    }
}

// A BM x BN output tile over (BM / TM) x (BN / TN) threads, TM x TN outputs
// a thread.  Thread (ty, tx) owns rows row(ty, i) and columns col(tx, j):
// groups of RV (CV) consecutive rows (columns), the groups BM / (TM / RV)
// apart, so that a warp's shared-memory reads of B are 16-byte loads of
// consecutive addresses and its reads of A broadcast.
//
// Warp layout: ty_of / tx_of place the threads so that a warp spans WY
// rows by WX columns of threads.  The default, WX = TX (up to 32), is the
// plain row-major order tx = tid % TX that gram.cu and omp_fused.cu
// compute themselves.  With TX = 16 a warp then spans 2 x 16 threads, and
// one warp-wide 16-byte read of B covers 256 bytes, two shared-memory
// wavefronts.  WX = 8 (a warp of 4 x 8 threads) makes that read 128
// contiguous bytes, one wavefront, and the read of A 64 bytes, broadcast
// to the 8 threads of a row; csrc/select.cu uses it.
template <int BM, int BN, int TM, int TN,
          int WX = (BN / TN < 32 ? BN / TN : 32)>
struct Tile {
    static constexpr int RV = TM < 4 ? TM : 4;
    static constexpr int CV = TN < 4 ? TN : 4;
    static constexpr int TX = BN / TN;
    static constexpr int TY = BM / TM;
    static constexpr int NT = TX * TY;
    static constexpr int WY = 32 / WX;
    static_assert(TM % RV == 0 && TN % CV == 0, "tile shape");
    static_assert(BM % TM == 0 && BN % TN == 0, "tile shape");
    static_assert(32 % WX == 0 && TX % WX == 0 && TY % WY == 0,
                  "warp layout");

    // thread coordinates: warps cover the TY x TX threads in WY x WX
    // blocks, TX / WX of them along a row of threads
    __device__ static __forceinline__ int tx_of(int tid) {
        return (tid / 32) % (TX / WX) * WX + tid % WX;
    }
    __device__ static __forceinline__ int ty_of(int tid) {
        return (tid / 32) / (TX / WX) * WY + tid % 32 / WX;
    }

    __device__ static __forceinline__ int row(int ty, int i) {
        return (i / RV) * (BM / (TM / RV)) + ty * RV + i % RV;
    }
    __device__ static __forceinline__ int col(int tx, int j) {
        return (j / CV) * (BN / (TN / CV)) + tx * CV + j % CV;
    }

    // acc[i][j] += sum_c As[c * lda + row(i)] * Bs[c * ldb + col(j)] over
    // the BP rows c of the staged slice, in order of c
    template <int BP>
    __device__ static __forceinline__ void mma(float (&acc)[TM][TN],
                                               const float* As, int lda,
                                               const float* Bs, int ldb,
                                               int ty, int tx) {
#pragma unroll
        for (int c = 0; c < BP; ++c) {
            float a[TM], b[TN];
#pragma unroll
            for (int g = 0; g < TM / RV; ++g)
                load_vec<RV>(a + g * RV, As + c * lda + row(ty, g * RV));
#pragma unroll
            for (int g = 0; g < TN / CV; ++g)
                load_vec<CV>(b + g * CV, Bs + c * ldb + col(tx, g * CV));
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }
};

}  // namespace lyssa
