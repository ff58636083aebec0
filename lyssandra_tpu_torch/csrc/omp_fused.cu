// Fused OMP in the Gram form: all pursuit steps of a block of lanes in one
// kernel.
//
// Replaces lyssandra_tpu/ops/pallas_omp.py::_kernel (fixed-T mode, K1) and
// ::_kernel_eps_exit (error-stopped mode with early exit, K2) as one kernel
// templated on EPS_MODE.
//
// Per lane (signal x, column n of X (p, N)), with G = D^T D (K, K) built by
// csrc/gram.cu before the launch and alpha0 = D^T x:
//   repeat t < T:
//     alpha  = alpha0 - sum_{j<t} gamma_j G[k_j, :]   (= D^T r)
//     k      = lowest index among the maxima of |alpha|
//     g_j    = G[k_j, k] (j < t);  w = Linv g;  nu = 1 - ||w||^2
//     nu <= 1e-6  -> the lane freezes (a dependent or repeated atom)
//     Linv  += row t = [-l (w^T Linv), l],  l = rsqrt(max(nu, 1e-12))
//     a0_t   = alpha0[k];  gamma = Linv^T (Linv a0)
//     err    = ||x - sum_j gamma_j d_j||^2, on the explicit residual (a
//              Gram-form energy cancels at small residuals, and K2's exit
//              and the denoiser's second phase read err); in EPS_MODE the
//              lane is done once err <= eps^2
//   (in EPS_MODE a lane with ||x||^2 <= eps^2 is done on entry)
// A frozen or done lane never changes its state again, so leaving the step
// loop at that point is exact: the rows it would have written are the
// zeros the buffers start with, and gamma is the last solve.
//
// What bounds it on an H100: in the Gram form the work is alpha0 (2 p K
// flops a lane) and, per step, one Gram row per selected atom (2 K t flops
// and 4 K t bytes).  The design:
//   - A block owns LANES lanes (16; 8 where K <= 256), one warp each.  It
//     first stages their x in shared memory, then computes their LANES x K
//     alpha0 with the register-tiled product of csrc/gemm_tile.cuh,
//     streaming D through shared memory in slices of 8 rows, two buffers,
//     once a block (not once a lane and step, as the residual form did).
//     alpha0 stays in shared memory (4 KB a lane at K=1,024) and never
//     reaches device memory.  In EPS_MODE a block whose lanes are all done
//     on entry skips the product.
//   - Each step reads the t Gram rows of the support from L2 (G is 4 MB at
//     K=1,024, resident in the 50 MB L2), 16-byte loads, four in flight a
//     thread, and fuses the first-index argmax into the same pass.  These
//     reads (28 rows of 4 KB a lane at T=8) bound the step loop: at the
//     bench shape they run at about 8 TB/s, and the alpha0 product, about a
//     third of the time, at about 16 TFLOP/s (PERF.md, section 6).
//   - The residual for err reads the support's atoms from Dt = D^T (K, p),
//     one contiguous row an atom.
// The per-lane state — alpha0 (K), Linv (T x T) and six T-vectors — sits
// in shared memory next to the block's x slab; p enters it only through
// that slab, so the envelope is the block's shared memory, not a cap on p.
// Reductions use xor butterflies, which give every thread the bitwise-same
// value, so the control flow of the step loop is warp-uniform.
#include <cuda_runtime.h>
#include <stddef.h>

#include "gemm_tile.cuh"

namespace {

constexpr int BP = 8;                  // rows of D per staged slice
constexpr int NSTAGE = 2;              // slices in the staging ring
constexpr int BN_WIDE = 512;           // columns of alpha0 per pass, K > 256
constexpr int STAGE_FLOATS = NSTAGE * BP * BN_WIDE;

__host__ __device__ inline int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}

// 4-byte words of shared memory a block of `lanes` lanes needs: the
// staging ring of D, the x slab (p rounded up to BP rows), and per lane
// alpha0 (K rounded up to 4), Linv and six T-vectors
__host__ __device__ inline size_t block_floats(int p, int K, int T,
                                               int lanes) {
    return STAGE_FLOATS + (size_t)round_up(p, BP) * lanes +
           (size_t)lanes *
               ((size_t)round_up(K, 4) + (size_t)T * T + 6 * (size_t)T);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// max |alpha| with the lowest index among equal values
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

__device__ __forceinline__ void take(float v, int k, float& best, int& bk) {
    const float s = fabsf(v);
    if (s > best) {  // k rises within a thread: the first max stays
        best = s;
        bk = k;
    }
}

// WIDE (K > 256): passes of 512 columns, 4 x 4 outputs a thread; else 256
// columns, 2 x 4 a thread, so that K=256 does not pay for a padded pass
template <int LANES, bool EPS_MODE, bool WIDE>
__global__ void __launch_bounds__(32 * LANES, 1024 / (32 * LANES))
omp_fused_kernel(const float* __restrict__ X, const float* __restrict__ D,
                 const float* __restrict__ Dt, const float* __restrict__ G,
                 int p, int K, int N, int T, float eps2,
                 int* __restrict__ idx_out, float* __restrict__ gam_out,
                 float* __restrict__ err_out, int* __restrict__ nsel_out) {
    constexpr int NT = 32 * LANES;
    constexpr int BN = WIDE ? BN_WIDE : BN_WIDE / 2;
    constexpr int TM = WIDE ? 4 : 2;
    using Tl = lyssa::Tile<LANES, BN, TM, 4>;
    static_assert(Tl::NT == NT, "the product uses every thread");
    extern __shared__ __align__(16) float smem[];
    const int KP = round_up(K, 4);
    const int PP = round_up(p, BP);
    float* Ds = smem;                        // [NSTAGE][BP][BN]
    float* xs = Ds + STAGE_FLOATS;           // (PP, LANES): column b is x_b
    float* a0 = xs + (size_t)PP * LANES;     // (LANES, KP): row b is alpha0
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const long long n0 = (long long)blockIdx.x * LANES;
    const long long n = n0 + warp;

    // --- the block's x, zero past p and past N
    for (int e = tid; e < PP * LANES; e += NT) {
        const int c = e / LANES;
        const long long m = n0 + e % LANES;
        xs[e] = (c < p && m < N) ? X[(size_t)c * N + m] : 0.f;
    }
    __syncthreads();
    float xx = 0.f;
    for (int i = lane; i < p; i += 32) {
        const float v = xs[i * LANES + warp];
        xx = fmaf(v, v, xx);
    }
    float err = warp_sum(xx);
    bool done = n >= N || (EPS_MODE && err <= eps2);

    // --- alpha0 = X^T D for the block's lanes, unless all are done: one
    // staging ring over (column pass, slice of p), so the next passes'
    // slices are in flight while this one is summed
    if (__syncthreads_or(!done)) {
        const int tx = tid % Tl::TX;
        const int ty = tid / Tl::TX;
        const bool vd = (K & 3) == 0 && ((size_t)D & 15) == 0;
        const int ns = PP / BP;
        float acc[TM][4];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        lyssa::pipeline<NSTAGE>(
            ns * ((K + BN - 1) / BN),
            [&](int it, int buf) {
                lyssa::stage_tile<BP, BN, NT>(Ds + buf * BP * BN, D, p, K,
                                              it % ns * BP, it / ns * BN, vd);
            },
            [&](int it, int buf) {
                const int s = it % ns;
                Tl::template mma<BP>(acc, xs + s * BP * LANES, LANES,
                                     Ds + buf * BP * BN, BN, ty, tx);
                if (s == ns - 1) {
                    // columns K .. KP - 1 come out zero (the staging
                    // zero-fills D past K)
                    const int k = it / ns * BN + Tl::col(tx, 0);
#pragma unroll
                    for (int i = 0; i < TM; ++i) {
                        if (k < KP)
                            *reinterpret_cast<float4*>(
                                a0 + (size_t)Tl::row(ty, i) * KP + k) =
                                make_float4(acc[i][0], acc[i][1], acc[i][2],
                                            acc[i][3]);
#pragma unroll
                        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
                    }
                }
            });
    }
    if (n >= N) return;  // warp-uniform: no block-level barrier follows

    float* L = a0 + (size_t)LANES * KP + (size_t)warp * (T * T + 6 * T);
    float* a0s = L + (size_t)T * T;  // (T, T) row-major, lower triangle
    float* g = a0s + T;
    float* w = g + T;
    float* y = w + T;
    float* gam = y + T;
    int* kidx = reinterpret_cast<int*>(gam + T);
    const float* ar = a0 + (size_t)warp * KP;
    for (int e = lane; e < T * T; e += 32) L[e] = 0.f;
    for (int j = lane; j < T; j += 32) {
        a0s[j] = 0.f;
        gam[j] = 0.f;
        kidx[j] = 0;
    }
    int nsel = 0;
    const bool vec = (K & 3) == 0 && ((size_t)G & 15) == 0;
    __syncwarp();

    for (int t = 0; t < T && !done; ++t) {
        // --- selection: argmax |alpha0 - G_I gamma|, lowest index on ties
        float best = -1.f;
        int bk = K;
        if (vec) {
            for (int base = 0; base < K; base += 512) {
                float4 v[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int k = base + 128 * u + 4 * lane;
                    v[u] = k < K ? *reinterpret_cast<const float4*>(ar + k)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
                }
                for (int j = 0; j < t; ++j) {
                    const float gj = -gam[j];
                    const float* Gr = G + (size_t)kidx[j] * K;
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        const int k = base + 128 * u + 4 * lane;
                        if (k < K) {
                            const float4 q =
                                __ldg(reinterpret_cast<const float4*>(Gr + k));
                            v[u].x = fmaf(gj, q.x, v[u].x);
                            v[u].y = fmaf(gj, q.y, v[u].y);
                            v[u].z = fmaf(gj, q.z, v[u].z);
                            v[u].w = fmaf(gj, q.w, v[u].w);
                        }
                    }
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int k = base + 128 * u + 4 * lane;
                    if (k < K) {
                        take(v[u].x, k, best, bk);
                        take(v[u].y, k + 1, best, bk);
                        take(v[u].z, k + 2, best, bk);
                        take(v[u].w, k + 3, best, bk);
                    }
                }
            }
        } else {
            for (int k = lane; k < K; k += 32) {
                float v = ar[k];
                for (int j = 0; j < t; ++j)
                    v = fmaf(-gam[j], __ldg(G + (size_t)kidx[j] * K + k), v);
                take(v, k, best, bk);
            }
        }
        warp_argmax(best, bk);
        if (bk >= K) break;  // every |alpha| NaN: no atom to take; freeze
        const int k = bk;

        // --- inverse-Cholesky append from the Gram column: g_j = G[k_j, k]
        for (int j = lane; j < t; j += 32) g[j] = G[(size_t)kidx[j] * K + k];
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
            a0s[t] = ar[k];
            kidx[t] = k;
        }
        __syncwarp();

        // --- gamma = Linv^T (Linv a0) over the t + 1 selected atoms
        for (int i = lane; i <= t; i += 32) {
            float s = 0.f;
            for (int j = 0; j <= i; ++j) s = fmaf(L[i * T + j], a0s[j], s);
            y[i] = s;
        }
        __syncwarp();
        for (int j = lane; j <= t; j += 32) {
            float s = 0.f;
            for (int i = j; i <= t; ++i) s = fmaf(L[i * T + j], y[i], s);
            gam[j] = s;
        }
        __syncwarp();

        // --- the explicit residual's energy, atoms from Dt's rows
        float rr = 0.f;
        for (int i = lane; i < p; i += 32) {
            float v = xs[i * LANES + warp];
            for (int j = 0; j <= t; ++j)
                v = fmaf(-gam[j], __ldg(Dt + (size_t)kidx[j] * p + i), v);
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

template <int LANES, bool EPS_MODE, bool WIDE>
cudaError_t launch(const float* X, const float* D, const float* Dt,
                   const float* G, int p, int K, int N, int T, float eps2,
                   int* idx, float* gam, float* err, int* nsel,
                   cudaStream_t stream) {
    const size_t smem = block_floats(p, K, T, LANES) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        omp_fused_kernel<LANES, EPS_MODE, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const unsigned blocks = (unsigned)((N + LANES - 1) / LANES);
    omp_fused_kernel<LANES, EPS_MODE, WIDE>
        <<<blocks, 32 * LANES, smem, stream>>>(
        X, D, Dt, G, p, K, N, T, eps2, idx, gam, err, nsel);
    return cudaGetLastError();
}

template <bool EPS_MODE, bool WIDE>
cudaError_t dispatch(int lanes, const float* X, const float* D,
                     const float* Dt, const float* G, int p, int K, int N,
                     int T, float eps2, int* idx, float* gam, float* err,
                     int* nsel, cudaStream_t s) {
    switch (lanes) {
        case 16:
            return launch<16, EPS_MODE, WIDE>(X, D, Dt, G, p, K, N, T, eps2, idx,
                                        gam, err, nsel, s);
        case 8:
            return launch<8, EPS_MODE, WIDE>(X, D, Dt, G, p, K, N, T, eps2, idx,
                                       gam, err, nsel, s);
        case 4:
            return launch<4, EPS_MODE, WIDE>(X, D, Dt, G, p, K, N, T, eps2, idx,
                                       gam, err, nsel, s);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// Bytes of shared memory a block of `lanes` lanes takes (the wrapper's
// block_smem_bytes must agree).
extern "C" size_t lyssa_omp_fused_smem_bytes(int p, int K, int T, int lanes) {
    return block_floats(p, K, T, lanes) * sizeof(float);
}

// X (p, N), D (p, K), Dt = D^T (K, p) and G = D^T D (K, K), row-major
// float32; idx, gamma (N, T); err, nsel (N,).  `lanes` (16, 8 or 4)
// lanes a block; returns cudaGetLastError() after the launch.
extern "C" int lyssa_omp_fused(const float* X, const float* D,
                               const float* Dt, const float* G, int p, int K,
                               int N, int T, float eps2, int eps_mode,
                               int lanes, int* idx, float* gam, float* err,
                               int* nsel, void* stream) {
    if (p < 1 || K < 1 || N < 1 || T < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool wide = K > BN_WIDE / 2;
    cudaError_t e =
        eps_mode
            ? (wide ? dispatch<true, true>(lanes, X, D, Dt, G, p, K, N, T,
                                           eps2, idx, gam, err, nsel, s)
                    : dispatch<true, false>(lanes, X, D, Dt, G, p, K, N, T,
                                            eps2, idx, gam, err, nsel, s))
            : (wide ? dispatch<false, true>(lanes, X, D, Dt, G, p, K, N, T,
                                            eps2, idx, gam, err, nsel, s)
                    : dispatch<false, false>(lanes, X, D, Dt, G, p, K, N, T,
                                             eps2, idx, gam, err, nsel, s));
    return static_cast<int>(e);
}
