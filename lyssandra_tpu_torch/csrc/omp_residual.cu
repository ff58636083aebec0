// Fused OMP in the residual form: all pursuit steps of a block of lanes in
// one kernel, for any K.
//
// Replaces lyssandra_tpu/ops/pallas_omp.py::_kernel (fixed-T mode, K1) and
// ::_kernel_eps_exit (error-stopped mode with early exit, K2) where the
// Gram form of csrc/omp_fused.cu cannot hold the shape: its lanes keep
// alpha0 (K floats each) in shared memory, which caps K (12,304 at p=64,
// T=8), while the TPU kernel takes any K at p <= 512.  Like the TPU kernel
// this one holds no K-proportional state: no G = D^T D, no alpha0, no
// (N, K) correlation.  Templated on EPS_MODE as omp_fused.cu is.
//
// Per lane (signal x, column n of X (p, N)), r = x at the start:
//   repeat t < T:
//     corr   = D^T r over all K atoms, streamed
//     k      = lowest index among the maxima of |corr|
//     g_j    = d_{k_j} . d_k (j < t);  w = Linv g;  nu = 1 - ||w||^2
//     nu <= 1e-6  -> the lane freezes (a dependent or repeated atom)
//     Linv  += row t = [-l (w^T Linv), l],  l = rsqrt(max(nu, 1e-12))
//     a0_t   = d_k . x;  gamma = Linv^T (Linv a0)
//     r      = x - sum_j gamma_j d_{k_j};  err = ||r||^2; in EPS_MODE the
//              lane is done once err <= eps^2
//   (in EPS_MODE a lane with ||x||^2 <= eps^2 is done on entry)
// A frozen or done lane never changes its state again; a block whose
// lanes are all frozen or done leaves the step loop, which is exact: the
// rows it would have written are the zeros the buffers start with.
//
// What bounds it on an H100: the selection product, 2 p K flops a lane and
// step (5.5e11 at p=64, K=16,384, T=8, N=32,768: 8.2 ms at the 67 TFLOP/s
// float32 peak), and D read from L2 once a block and step (4 MB at that
// shape).  The design:
//   - A block owns LANES lanes (16; 8 or 4 where the state of 16 does not
//     fit), one warp each.  x and r of its lanes sit in shared memory as
//     (p, LANES) slabs.
//   - Each step streams D through shared memory in slices of 8 rows by 512
//     atoms, two buffers filled by cp.async (csrc/gemm_tile.cuh's
//     stage_tile and pipeline, as omp_fused.cu's alpha0 product), and each
//     thread computes a 4 x 4 register tile of corr (Tile<LANES, 512, 4,
//     4>).  After the last slice of p a thread folds its tile into a
//     running maximum per lane, atoms rising within the thread and a
//     strict >, so the first maximum stays (csrc/select.cu's fold).  Once
//     all K atoms are seen, the 32 threads of a warp combine their maxima
//     with shuffles and the 4 warps that share a lane's row through shared
//     memory, the lower index on equal values.  No correlation leaves the
//     registers.
//   - Then one warp per lane does the small update, as omp_fused.cu's step
//     does, with the Gram entries g_j and a0_t computed as dot products of
//     the support's atoms, read as rows of Dt = D^T (K, p), which sit in
//     L2; the new residual goes back to the block's r slab.
//   - Per lane, shared memory holds x and r (p each, rounded up to 8),
//     Linv (T x T), six T-vectors and the lane's four partial maxima:
//     about 9 KB at p=512, T=32.  Nothing grows with K.
// Reductions use xor butterflies, which give every thread the bitwise-same
// value, so the control flow of the step loop is warp-uniform.
#include <cuda_runtime.h>
#include <stddef.h>

#include "gemm_tile.cuh"
#include "smem_opt_in.cuh"

namespace {

constexpr int BP = 8;                  // rows of D per staged slice
constexpr int NSTAGE = 2;              // slices in the staging ring
constexpr int BN = 512;                // atoms per pass
constexpr int TM = 4, TN = 4;          // a thread's tile of corr
constexpr int PARTS = BN / TN / 32;    // warps that share a lane's row
constexpr int STAGE_FLOATS = NSTAGE * BP * BN;

__host__ __device__ inline int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}

// 4-byte words a lane holds: its x and r (p rounded up to BP), Linv, six
// T-vectors and its PARTS partial maxima (value and index)
__host__ __device__ inline size_t lane_floats(int p, int T) {
    return 2 * (size_t)round_up(p, BP) + (size_t)T * T + 6 * (size_t)T +
           2 * PARTS;
}

// 4-byte words of shared memory a block of `lanes` lanes needs
__host__ __device__ inline size_t block_floats(int p, int T, int lanes) {
    return STAGE_FLOATS + (size_t)lanes * lane_floats(p, T);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// Fold one atom's |corr| into a lane's running maximum: a strict >, so the
// first of equal maxima stays (atoms come in rising order).  A NaN never
// replaces the maximum.
__device__ __forceinline__ void fold(float v, int k, float& best, int& idx) {
    const float s = fabsf(v);
    idx = s > best ? k : idx;
    best = fmaxf(best, s);
}

// Combine two running maxima: the larger value, the lower index on equal
// values.
__device__ __forceinline__ void combine(float ob, int oi, float& best,
                                        int& idx) {
    if (ob > best || (ob == best && oi < idx)) {
        best = ob;
        idx = oi;
    }
}

template <int LANES, bool EPS_MODE>
__global__ void __launch_bounds__(32 * LANES, 1024 / (32 * LANES))
omp_residual_kernel(const float* __restrict__ X, const float* __restrict__ D,
                    const float* __restrict__ Dt, int p, int K, int N, int T,
                    float eps2, int* __restrict__ idx_out,
                    float* __restrict__ gam_out, float* __restrict__ err_out,
                    int* __restrict__ nsel_out) {
    constexpr int NT = 32 * LANES;
    using Tl = lyssa::Tile<LANES, BN, TM, TN>;
    static_assert(Tl::NT == NT, "the product uses every thread");
    static_assert(Tl::TX == 32 * PARTS, "PARTS warps share a row");
    extern __shared__ __align__(16) float smem[];
    const int PP = round_up(p, BP);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    float* Ds = smem;                        // [NSTAGE][BP][BN]
    float* xs = Ds + STAGE_FLOATS;           // (PP, LANES): column b is x_b
    float* rs = xs + (size_t)PP * LANES;     // (PP, LANES): column b is r_b
    float* redv = rs + (size_t)PP * LANES;   // (LANES, PARTS) partial maxima
    int* redi = reinterpret_cast<int*>(redv + LANES * PARTS);
    float* L = reinterpret_cast<float*>(redi + LANES * PARTS) +
               (size_t)warp * (T * T + 6 * T);
    float* a0s = L + (size_t)T * T;  // L: (T, T) row-major, lower triangle
    float* g = a0s + T;
    float* w = g + T;
    float* y = w + T;
    float* gam = y + T;
    int* kidx = reinterpret_cast<int*>(gam + T);
    const long long n0 = (long long)blockIdx.x * LANES;
    const long long n = n0 + warp;

    // --- the block's x (and r = x), zero past p and past N; lane state
    for (int e = tid; e < PP * LANES; e += NT) {
        const int c = e / LANES;
        const long long m = n0 + e % LANES;
        const float v = (c < p && m < N) ? X[(size_t)c * N + m] : 0.f;
        xs[e] = v;
        rs[e] = v;
    }
    for (int e = lane; e < T * T; e += 32) L[e] = 0.f;
    for (int j = lane; j < T; j += 32) {
        a0s[j] = 0.f;
        gam[j] = 0.f;
        kidx[j] = 0;
    }
    __syncthreads();
    float xx = 0.f;
    for (int i = lane; i < p; i += 32) {
        const float v = xs[i * LANES + warp];
        xx = fmaf(v, v, xx);
    }
    float err = warp_sum(xx);
    bool done = n >= N || (EPS_MODE && err <= eps2);
    int nsel = 0;

    const int tx = Tl::tx_of(tid);
    const int ty = Tl::ty_of(tid);
    const int part = tx / 32;
    const bool vd = (K & 3) == 0 && ((size_t)D & 15) == 0;
    const int ns = PP / BP;
    const int passes = ns * ((K + BN - 1) / BN);

    for (int t = 0; t < T; ++t) {
        // block-uniform: leave once every lane is done or frozen
        if (!__syncthreads_or(!done)) break;

        // --- corr = D^T r for the block's lanes, folded into a running
        // maximum per lane as each pass over BN atoms completes
        float acc[TM][TN];
        float best[TM];
        int bidx[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            best[i] = -1.f;
            bidx[i] = K;
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
        }
        lyssa::pipeline<NSTAGE>(
            passes,
            [&](int it, int buf) {
                lyssa::stage_tile<BP, BN, NT>(Ds + buf * BP * BN, D, p, K,
                                              it % ns * BP, it / ns * BN, vd);
            },
            [&](int it, int buf) {
                const int s = it % ns;
                Tl::template mma<BP>(acc, rs + s * BP * LANES, LANES,
                                     Ds + buf * BP * BN, BN, ty, tx);
                if (s == ns - 1) {
                    const int k0 = it / ns * BN;
#pragma unroll
                    for (int i = 0; i < TM; ++i)
#pragma unroll
                        for (int j = 0; j < TN; ++j) {
                            const int k = k0 + Tl::col(tx, j);
                            if (k < K) fold(acc[i][j], k, best[i], bidx[i]);
                            acc[i][j] = 0.f;
                        }
                }
            });

        // --- the lanes' maxima: within a warp by shuffles, then across the
        // PARTS warps that share a row through shared memory
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int m = 16; m > 0; m >>= 1) {
                const float ob = __shfl_xor_sync(0xffffffffu, best[i], m);
                const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], m);
                combine(ob, oi, best[i], bidx[i]);
            }
        }
        if (lane == 0) {
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                const int row = Tl::row(ty, i);
                redv[row * PARTS + part] = best[i];
                redi[row * PARTS + part] = bidx[i];
            }
        }
        __syncthreads();
        if (done) continue;  // warp-uniform; no barrier before the next step

        float bv = redv[warp * PARTS];
        int k = redi[warp * PARTS];
#pragma unroll
        for (int q = 1; q < PARTS; ++q)
            combine(redv[warp * PARTS + q], redi[warp * PARTS + q], bv, k);
        if (k >= K) {  // every |corr| NaN: no atom to take; freeze
            done = true;
            continue;
        }
        const float* dk = Dt + (size_t)k * p;

        // --- inverse-Cholesky append: g_j = d_{k_j} . d_k
        for (int j = 0; j < t; ++j) {
            const float* dj = Dt + (size_t)kidx[j] * p;
            float s = 0.f;
            for (int i = lane; i < p; i += 32)
                s = fmaf(__ldg(dj + i), __ldg(dk + i), s);
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
        if (nu <= 1e-6f) {  // frozen: rows >= t stay zero, state kept
            done = true;
            continue;
        }
        const float li = rsqrtf(fmaxf(nu, 1e-12f));
        for (int j = lane; j < t; j += 32) {
            float s = 0.f;
            for (int i = j; i < t; ++i) s = fmaf(w[i], L[i * T + j], s);
            L[t * T + j] = -li * s;
        }
        float a = 0.f;
        for (int i = lane; i < p; i += 32)
            a = fmaf(__ldg(dk + i), xs[i * LANES + warp], a);
        a = warp_sum(a);
        if (lane == 0) {
            L[t * T + t] = li;
            a0s[t] = a;
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

        // --- the explicit residual, back into the r slab, and its energy
        float rr = 0.f;
        for (int i = lane; i < p; i += 32) {
            float v = xs[i * LANES + warp];
            for (int j = 0; j <= t; ++j)
                v = fmaf(-gam[j], __ldg(Dt + (size_t)kidx[j] * p + i), v);
            rs[i * LANES + warp] = v;
            rr = fmaf(v, v, rr);
        }
        err = warp_sum(rr);
        nsel = t + 1;
        if (EPS_MODE && err <= eps2) done = true;
        __syncwarp();
    }
    if (n >= N) return;

    for (int j = lane; j < T; j += 32) {
        idx_out[n * T + j] = kidx[j];
        gam_out[n * T + j] = gam[j];
    }
    if (lane == 0) {
        err_out[n] = err;
        nsel_out[n] = nsel;
    }
}

template <int LANES, bool EPS_MODE>
cudaError_t launch(const float* X, const float* D, const float* Dt, int p,
                   int K, int N, int T, float eps2, int* idx, float* gam,
                   float* err, int* nsel, cudaStream_t stream) {
    const size_t smem = block_floats(p, T, LANES) * sizeof(float);
    cudaError_t e =
        lyssa::opt_in_smem<omp_residual_kernel<LANES, EPS_MODE>>(smem);
    if (e != cudaSuccess) return e;
    const unsigned blocks = (unsigned)((N + LANES - 1) / LANES);
    omp_residual_kernel<LANES, EPS_MODE><<<blocks, 32 * LANES, smem, stream>>>(
        X, D, Dt, p, K, N, T, eps2, idx, gam, err, nsel);
    return cudaGetLastError();
}

template <bool EPS_MODE>
cudaError_t dispatch(int lanes, const float* X, const float* D,
                     const float* Dt, int p, int K, int N, int T, float eps2,
                     int* idx, float* gam, float* err, int* nsel,
                     cudaStream_t s) {
    switch (lanes) {
        case 16:
            return launch<16, EPS_MODE>(X, D, Dt, p, K, N, T, eps2, idx, gam,
                                        err, nsel, s);
        case 8:
            return launch<8, EPS_MODE>(X, D, Dt, p, K, N, T, eps2, idx, gam,
                                       err, nsel, s);
        case 4:
            return launch<4, EPS_MODE>(X, D, Dt, p, K, N, T, eps2, idx, gam,
                                       err, nsel, s);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// Bytes of shared memory a block of `lanes` lanes takes (the wrapper's
// residual_block_smem_bytes must agree); K does not enter.
extern "C" size_t lyssa_omp_residual_smem_bytes(int p, int T, int lanes) {
    return block_floats(p, T, lanes) * sizeof(float);
}

// X (p, N), D (p, K) and Dt = D^T (K, p), row-major float32; idx, gamma
// (N, T); err, nsel (N,).  `lanes` (16, 8 or 4) lanes a block; returns
// cudaGetLastError() after the launch.
extern "C" int lyssa_omp_residual(const float* X, const float* D,
                                  const float* Dt, int p, int K, int N, int T,
                                  float eps2, int eps_mode, int lanes,
                                  int* idx, float* gam, float* err, int* nsel,
                                  void* stream) {
    if (p < 1 || K < 1 || N < 1 || T < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t e =
        eps_mode ? dispatch<true>(lanes, X, D, Dt, p, K, N, T, eps2, idx, gam,
                                  err, nsel, s)
                 : dispatch<false>(lanes, X, D, Dt, p, K, N, T, eps2, idx,
                                   gam, err, nsel, s);
    return static_cast<int>(e);
}
