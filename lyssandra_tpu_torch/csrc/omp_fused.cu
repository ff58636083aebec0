// Fused OMP: all pursuit steps of one signal in one warp.
//
// Replaces lyssandra_tpu/ops/pallas_omp.py::_kernel (fixed-T mode, K1) and
// ::_kernel_eps_exit (error-stopped mode with early exit, K2) as one kernel
// templated on EPS_MODE.
//
// Per lane (signal x, column n of X (p, N)), with r = x:
//   repeat t < T:
//     k      = lowest index among the maxima of |D^T r|
//     g_j    = d_j . d_k (j < t);  w = Linv g;  nu = 1 - ||w||^2
//     nu <= 1e-6  -> the lane freezes (a dependent or repeated atom)
//     Linv  += row t = [-l (w^T Linv), l],  l = rsqrt(max(nu, 1e-12))
//     a0_t   = d_k . x;  gamma = Linv^T (Linv a0);  r = x - sum_j gamma_j d_j
//     err    = ||r||^2; in EPS_MODE the lane is done once err <= eps^2
//   (in EPS_MODE a lane with ||x||^2 <= eps^2 is done on entry)
// A frozen or done lane never changes its state again, so leaving the step
// loop at that point is exact: the rows it would have written are the
// zeros the buffers start with, and gamma is the last solve.  That per-lane
// exit is the GPU form of the reference's per-block early exit.
//
// What bounds it on an H100: the correlation D^T r, 2 p K flops per lane
// and step, reads all of D (p K floats, 256 KB at p=64, K=1024).  D lives in
// global memory and stays resident in the 50 MB L2; it is too large for a
// block's 227 KB of shared memory.  One warp owns one lane: thread `lane`
// correlates atoms k = lane (mod 32), so the warp reads each row of D
// (row-major, K contiguous) in coalesced 128-byte pieces, and the residual
// r[i] is a shared-memory broadcast.  This simple design re-reads D from L2
// once per lane and step, so L2 bandwidth bounds it; sharing D tiles
// between the warps of a block (and wgmma) is later work.  The per-lane
// state — x, r, the selected atoms (T x p), Linv (T x T), a0 — sits in
// shared memory; the small triangular solves are spread over the warp's
// threads.  Reductions use xor butterflies, which give every thread the
// bitwise-same value, so all control flow is warp-uniform.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// max |corr| with the lowest index among equal values
__device__ __forceinline__ void warp_argmax(float& best, int& bk) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, m);
        const int ok = __shfl_xor_sync(0xffffffffu, bk, m);
        if (ov > best || (ov == best && ok < bk)) {
            best = ov;
            bk = ok;
        }
    }
}

// floats of shared memory one lane needs
__host__ __device__ inline size_t lane_floats(int p, int T) {
    return 2 * (size_t)p + (size_t)T * p + (size_t)T * T + 6 * (size_t)T;
}

template <bool EPS_MODE>
__global__ void omp_fused_kernel(const float* __restrict__ X,
                                 const float* __restrict__ D, int p, int K,
                                 int N, int T, float eps2,
                                 int* __restrict__ idx_out,
                                 float* __restrict__ gam_out,
                                 float* __restrict__ err_out,
                                 int* __restrict__ nsel_out) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long n = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
    if (n >= N) return;  // warp-uniform: no block-level barrier follows

    float* x = smem + warp * lane_floats(p, T);
    float* r = x + p;
    float* dsel = r + p;           // (T, p): row j = selected atom j
    float* L = dsel + (size_t)T * p;  // (T, T) row-major, lower triangle
    float* a0 = L + (size_t)T * T;
    float* g = a0 + T;
    float* w = g + T;
    float* y = w + T;
    float* gam = y + T;
    int* kidx = reinterpret_cast<int*>(gam + T);

    float xx = 0.f;
    for (int i = lane; i < p; i += 32) {
        const float v = X[(size_t)i * N + n];
        x[i] = v;
        r[i] = v;
        xx = fmaf(v, v, xx);
    }
    for (int e = lane; e < T * T; e += 32) L[e] = 0.f;
    for (int j = lane; j < T; j += 32) {
        a0[j] = 0.f;
        gam[j] = 0.f;
        kidx[j] = 0;
    }
    float err = warp_sum(xx);
    int nsel = 0;
    bool done = EPS_MODE && err <= eps2;
    __syncwarp();

    for (int t = 0; t < T && !done; ++t) {
        // --- selection: argmax |D^T r|, lowest index on ties
        float best = -1.f;
        int bk = K;
        for (int k = lane; k < K; k += 32) {
            const float* dcol = D + k;
            float c = 0.f;
#pragma unroll 8
            for (int i = 0; i < p; ++i) c = fmaf(dcol[(size_t)i * K], r[i], c);
            const float s = fabsf(c);
            if (s > best) {  // k rises within a thread: the first max stays
                best = s;
                bk = k;
            }
        }
        warp_argmax(best, bk);
        if (bk >= K) break;  // every |corr| NaN: no atom to read; freeze
        const int k = bk;

        // --- fetch d_k; a0_t = d_k . x
        float* dk = dsel + (size_t)t * p;
        float ax = 0.f;
        for (int i = lane; i < p; i += 32) {
            const float v = D[(size_t)i * K + k];
            dk[i] = v;
            ax = fmaf(v, x[i], ax);
        }
        const float a0t = warp_sum(ax);
        __syncwarp();

        // --- inverse-Cholesky append: g = Dsel d_k, w = Linv g
        for (int j = 0; j < t; ++j) {
            float s = 0.f;
            for (int i = lane; i < p; i += 32)
                s = fmaf(dsel[(size_t)j * p + i], dk[i], s);
            s = warp_sum(s);
            if (lane == 0) g[j] = s;
        }
        __syncwarp();
        for (int i = lane; i < t; i += 32) {
            float s = 0.f;
            for (int j = 0; j <= i; ++j) s = fmaf(L[i * T + j], g[j], s);
            w[i] = s;
        }
        __syncwarp();
        float ww = 0.f;
        for (int i = lane; i < t; i += 32) ww = fmaf(w[i], w[i], ww);
        const float nu = 1.f - warp_sum(ww);
        if (nu <= 1e-6f) break;  // frozen: rows >= t stay zero, state kept
        const float li = rsqrtf(fmaxf(nu, 1e-12f));
        for (int j = lane; j < t; j += 32) {
            float s = 0.f;
            for (int i = j; i < t; ++i) s = fmaf(w[i], L[i * T + j], s);
            L[t * T + j] = -li * s;
        }
        if (lane == 0) {
            L[t * T + t] = li;
            a0[t] = a0t;
            kidx[t] = k;
        }
        __syncwarp();

        // --- gamma = Linv^T (Linv a0) over the t + 1 selected atoms
        for (int i = lane; i <= t; i += 32) {
            float s = 0.f;
            for (int j = 0; j <= i; ++j) s = fmaf(L[i * T + j], a0[j], s);
            y[i] = s;
        }
        __syncwarp();
        for (int j = lane; j <= t; j += 32) {
            float s = 0.f;
            for (int i = j; i <= t; ++i) s = fmaf(L[i * T + j], y[i], s);
            gam[j] = s;
        }
        __syncwarp();

        // --- explicit residual and its energy
        float rr = 0.f;
        for (int i = lane; i < p; i += 32) {
            float v = x[i];
            for (int j = 0; j <= t; ++j)
                v = fmaf(-gam[j], dsel[(size_t)j * p + i], v);
            r[i] = v;
            rr = fmaf(v, v, rr);
        }
        err = warp_sum(rr);
        nsel = t + 1;
        if (EPS_MODE && err <= eps2) done = true;
        __syncwarp();
    }

    for (int j = lane; j < T; j += 32) {
        idx_out[n * T + j] = kidx[j];
        gam_out[n * T + j] = gam[j];
    }
    if (lane == 0) {
        err_out[n] = err;
        nsel_out[n] = nsel;
    }
}

template <bool EPS_MODE>
cudaError_t launch(const float* X, const float* D, int p, int K, int N, int T,
                   float eps2, int warps, int* idx, float* gam, float* err,
                   int* nsel, cudaStream_t stream) {
    const size_t smem = lane_floats(p, T) * sizeof(float) * warps;
    cudaError_t e = cudaFuncSetAttribute(
        omp_fused_kernel<EPS_MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const unsigned blocks = (unsigned)((N + warps - 1) / warps);
    omp_fused_kernel<EPS_MODE><<<blocks, 32 * warps, smem, stream>>>(
        X, D, p, K, N, T, eps2, idx, gam, err, nsel);
    return cudaGetLastError();
}

}  // namespace

// X (p, N) and D (p, K) row-major float32; idx, gamma (N, T); err, nsel (N,).
// `warps` lanes per block; returns cudaGetLastError() after the launch.
extern "C" int lyssa_omp_fused(const float* X, const float* D, int p, int K,
                               int N, int T, float eps2, int eps_mode,
                               int warps, int* idx, float* gam, float* err,
                               int* nsel, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = eps_mode
        ? launch<true>(X, D, p, K, N, T, eps2, warps, idx, gam, err, nsel, s)
        : launch<false>(X, D, p, K, N, T, eps2, warps, idx, gam, err, nsel, s);
    return static_cast<int>(e);
}
