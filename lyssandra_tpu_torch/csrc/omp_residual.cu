// Fused OMP in the residual form, for any K: the pursuit of a chunk of
// lanes as a chain of launches on one stream, with no host read between
// them.
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
//     k      = lowest index among the maxima of |D^T r|
//     g_j    = d_{k_j} . d_k (j < t);  w = Linv g;  nu = 1 - ||w||^2
//     nu <= 1e-6  -> the lane freezes (a dependent or repeated atom)
//     Linv  += row t = [-l (w^T Linv), l],  l = rsqrt(max(nu, 1e-12))
//     a0_t   = d_k . x;  gamma = Linv^T (Linv a0)
//     r      = x - sum_j gamma_j d_{k_j};  err = ||r||^2; in EPS_MODE the
//              lane is done once err <= eps^2
//   (in EPS_MODE a lane with ||x||^2 <= eps^2 is done on entry)
// A frozen or done lane never changes its state again, so it leaves the
// pursuit: the rows it would have written are the zeros the outputs start
// with.  The TPU kernel's exit per block of lanes is its grid's constraint,
// not part of the result.
//
// What bounds it on an H100: the selection product, 2 p K flops a lane and
// step (5.5e11 at p=64, K=16,384, T=8, N=32,768: 8.2 ms at the 67 TFLOP/s
// float32 peak).  The design:
//   - init_kernel, once a chunk: x^T into rows (C, p), r = x, err = ||x||^2,
//     nsel = 0, and the list of the lanes that run step 0;
//   - each step, first the selection: K7's float32 kernel (csrc/select.cu,
//     lyssa_select_rows: 8 x 8 register tiles, warps of 4 x 8 threads, 128
//     lanes a block at p <= 256, 64 above) on the listed lanes only, its
//     atoms split over blocks so that few running lanes still fill the
//     card.  D is read from L2 once per 128 lanes and step, against once
//     per 16 in a block that also holds the lanes' factors;
//   - then step_kernel, one warp per listed lane: it combines the split
//     maxima (the larger value, the lower index on equal values, so the
//     first maximum stays), computes the Gram entries g_j and a0_t as dot
//     products of rows of Dt = D^T (K, p), which sit in L2, appends to
//     Linv, solves for gamma and writes the explicit residual, err and
//     nsel, and lists the lanes that run on for the next step: a
//     compaction on the device, one atomicAdd a block.  The next launches
//     read the count on the device; their blocks past it leave at once, so
//     the work follows the lanes still running;
//   - the state between launches is in device memory: x^T and r (C, p),
//     Linv (C, T, T), a0 (C, T), the lists and their counts; idx, gamma,
//     err and nsel are written in place to the outputs.
// Reductions use xor butterflies, which give every thread of a warp the
// bitwise-same value, so a lane's control flow is warp-uniform.
#include <cuda_runtime.h>
#include <stddef.h>

#include "smem_opt_in.cuh"

namespace {

constexpr int UW = 8;   // lanes (one warp each) a block of init and step

// 4-byte words of shared memory a step block takes: per warp g, w, y, gamma
// and the support's indices, T each
__host__ __device__ inline size_t step_floats(int T) {
    return (size_t)UW * 5 * T;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
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

// Append the lanes whose warp keeps running to list at *cnt, in warp order
// within the block, one atomicAdd a block.  Every thread of the block
// calls it; `keep` is read from each warp's first thread.
__device__ __forceinline__ void compact(bool keep, int c, int* list,
                                        int* cnt) {
    __shared__ int kept[UW];
    __shared__ int base;
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) kept[warp] = keep;
    __syncthreads();
    if (threadIdx.x == 0) {
        int n = 0;
        for (int w = 0; w < UW; ++w) n += kept[w];
        base = n ? atomicAdd(cnt, n) : 0;
    }
    __syncthreads();
    if (keep && (threadIdx.x & 31) == 0) {
        int pos = base;
        for (int w = 0; w < warp; ++w) pos += kept[w];
        list[pos] = c;
    }
}

// Lane c = the block's warp: x^T and r = x, err = ||x||^2, nsel = 0, and
// the lane into list unless it is done on entry.  err and nsel point at the
// chunk's first lane; X is the whole (p, N).
template <bool EPS_MODE>
__global__ void __launch_bounds__(32 * UW)
init_kernel(const float* __restrict__ X, int p, long long N, long long n0,
            int C, float eps2, float* __restrict__ xt, float* __restrict__ r,
            float* __restrict__ err_out, int* __restrict__ nsel_out,
            int* __restrict__ list, int* __restrict__ cnt) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int c = blockIdx.x * UW + warp;
    bool keep = false;
    if (c < C) {
        float xx = 0.f;
        for (int i = lane; i < p; i += 32) {
            const float v = X[(size_t)i * N + n0 + c];
            xt[(size_t)c * p + i] = v;
            r[(size_t)c * p + i] = v;
            xx = fmaf(v, v, xx);
        }
        const float err = warp_sum(xx);
        if (lane == 0) {
            err_out[c] = err;
            nsel_out[c] = 0;
        }
        keep = !(EPS_MODE && err <= eps2);
    }
    compact(keep, c, list, cnt);
}

// Step t of lane c with the selected atom k, by one warp; g, w, y, gm and
// kidx are its shared-memory vectors.  Returns whether the lane took the
// atom and is not done; a frozen lane returns false with its state kept.
template <bool EPS_MODE>
__device__ bool lane_step(const float* __restrict__ Dt,
                          const float* __restrict__ x, float* __restrict__ r,
                          float* __restrict__ L, float* __restrict__ a0,
                          int* __restrict__ ix, float* __restrict__ gam,
                          float* __restrict__ err_out,
                          int* __restrict__ nsel_out, int p, int T, int t,
                          int k, float eps2, float* g, float* w, float* y,
                          float* gm, int* kidx) {
    const int lane = threadIdx.x & 31;
    const float* dk = Dt + (size_t)k * p;
    for (int j = lane; j < t; j += 32) kidx[j] = ix[j];
    __syncwarp();

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
    if (nu <= 1e-6f) return false;  // frozen: rows >= t stay zero
    const float li = rsqrtf(fmaxf(nu, 1e-12f));
    for (int j = lane; j < t; j += 32) {
        float s = 0.f;
        for (int i = j; i < t; ++i) s = fmaf(w[i], L[i * T + j], s);
        L[t * T + j] = -li * s;
    }
    float a = 0.f;
    for (int i = lane; i < p; i += 32) a = fmaf(__ldg(dk + i), x[i], a);
    a = warp_sum(a);
    if (lane == 0) {
        L[t * T + t] = li;
        a0[t] = a;
        ix[t] = k;
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
        gm[j] = s;
        gam[j] = s;
    }
    __syncwarp();

    // --- the explicit residual and its energy
    float rr = 0.f;
    for (int i = lane; i < p; i += 32) {
        float v = x[i];
        for (int j = 0; j <= t; ++j)
            v = fmaf(-gm[j], __ldg(Dt + (size_t)kidx[j] * p + i), v);
        r[i] = v;
        rr = fmaf(v, v, rr);
    }
    const float err = warp_sum(rr);
    if (lane == 0) {
        *err_out = err;
        *nsel_out = t + 1;
    }
    return !(EPS_MODE && err <= eps2);
}

// Step t for the listed lanes: warp m of the grid takes list_in[m] (m <
// *cnt_in), its atom from the selection's `splits` partial maxima (ksel
// and bsel, C apart), and lists the lane in list_out if it runs on
// (list_out null at the last step).  idx, gam, err and nsel point at the
// chunk's first lane.
template <bool EPS_MODE>
__global__ void __launch_bounds__(32 * UW)
step_kernel(const float* __restrict__ Dt, const float* __restrict__ xt,
            float* __restrict__ r, float* __restrict__ Ls,
            float* __restrict__ a0s, const int* __restrict__ ksel,
            const float* __restrict__ bsel, int splits,
            const int* __restrict__ list_in, const int* __restrict__ cnt_in,
            int* __restrict__ list_out, int* __restrict__ cnt_out, int p,
            int C, int T, int t, float eps2, int* __restrict__ idx,
            float* __restrict__ gam, float* __restrict__ err_out,
            int* __restrict__ nsel_out) {
    extern __shared__ __align__(16) float smem[];
    const int count = *cnt_in;
    const int m0 = blockIdx.x * UW;
    if (m0 >= count) return;  // block-uniform: no listed lane here
    const int warp = threadIdx.x >> 5;
    const int m = m0 + warp;
    float* g = smem + (size_t)warp * 5 * T;
    float* w = g + T;
    float* y = w + T;
    float* gm = y + T;
    int* kidx = reinterpret_cast<int*>(gm + T);
    int c = 0;
    bool keep = false;
    if (m < count) {
        c = list_in[m];
        float bv = bsel[m];
        int k = ksel[m];
        for (int s = 1; s < splits; ++s)
            combine(bsel[(size_t)s * C + m], ksel[(size_t)s * C + m], bv, k);
        keep = lane_step<EPS_MODE>(
            Dt, xt + (size_t)c * p, r + (size_t)c * p, Ls + (size_t)c * T * T,
            a0s + (size_t)c * T, idx + (size_t)c * T, gam + (size_t)c * T,
            err_out + c, nsel_out + c, p, T, t, k, eps2, g, w, y, gm, kidx);
    }
    if (list_out != nullptr) compact(keep, c, list_out, cnt_out);
}

template <bool EPS_MODE>
cudaError_t launch_init(const float* X, int p, int N, int n0, int C,
                        float eps2, float* xt, float* r, float* err,
                        int* nsel, int* list, int* cnt, cudaStream_t s) {
    const unsigned blocks = (unsigned)((C + UW - 1) / UW);
    init_kernel<EPS_MODE><<<blocks, 32 * UW, 0, s>>>(
        X, p, N, n0, C, eps2, xt, r, err, nsel, list, cnt);
    return cudaGetLastError();
}

template <bool EPS_MODE>
cudaError_t launch_step(const float* Dt, const float* xt, float* r, float* L,
                        float* a0, const int* ksel, const float* bsel,
                        int splits, const int* list_in, const int* cnt_in,
                        int* list_out, int* cnt_out, int p, int C, int T,
                        int t, float eps2, int* idx, float* gam, float* err,
                        int* nsel, cudaStream_t s) {
    const size_t smem = step_floats(T) * sizeof(float);
    cudaError_t e = lyssa::opt_in_smem<step_kernel<EPS_MODE>>(smem);
    if (e != cudaSuccess) return e;
    const unsigned blocks = (unsigned)((C + UW - 1) / UW);
    step_kernel<EPS_MODE><<<blocks, 32 * UW, smem, s>>>(
        Dt, xt, r, L, a0, ksel, bsel, splits, list_in, cnt_in, list_out,
        cnt_out, p, C, T, t, eps2, idx, gam, err, nsel);
    return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a step block takes (the wrapper's
// residual_step_smem_bytes must agree); neither p nor K enters.
extern "C" size_t lyssa_omp_residual_step_smem_bytes(int T) {
    return step_floats(T) * sizeof(float);
}

// The chunk of C lanes n0 .. n0 + C - 1 of X (p, N), row-major float32:
// xt and r (C, p), err and nsel at the chunk's first lane, and list (C)
// with its count *cnt, which must be 0.  Returns cudaGetLastError() after
// the launch.
extern "C" int lyssa_omp_residual_init(const float* X, int p, int N, int n0,
                                       int C, float eps2, int eps_mode,
                                       float* xt, float* r, float* err,
                                       int* nsel, int* list, int* cnt,
                                       void* stream) {
    if (p < 1 || N < 1 || C < 1 || n0 < 0 || n0 + C > N)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t e =
        eps_mode ? launch_init<true>(X, p, N, n0, C, eps2, xt, r, err, nsel,
                                     list, cnt, s)
                 : launch_init<false>(X, p, N, n0, C, eps2, xt, r, err, nsel,
                                      list, cnt, s);
    return static_cast<int>(e);
}

// Step t (< T) for the lanes list_in[0 .. *cnt_in) of a chunk of at most C
// lanes: Dt = D^T (K, p); xt, r (C, p), L (C, T, T), a0 (C, T) the chunk's
// state; ksel and bsel (splits, C) the selection's partial maxima; idx,
// gamma (C, T), err, nsel (C) at the chunk's first lane.  The lanes that
// run on go to list_out at *cnt_out (null at the last step).  Returns
// cudaGetLastError() after the launch.
extern "C" int lyssa_omp_residual_step(
    const float* Dt, const float* xt, float* r, float* L, float* a0,
    const int* ksel, const float* bsel, int splits, const int* list_in,
    const int* cnt_in, int* list_out, int* cnt_out, int p, int C, int T,
    int t, float eps2, int eps_mode, int* idx, float* gam, float* err,
    int* nsel, void* stream) {
    if (p < 1 || C < 1 || T < 1 || t < 0 || t >= T || splits < 1 ||
        (list_out == nullptr) != (cnt_out == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t e =
        eps_mode
            ? launch_step<true>(Dt, xt, r, L, a0, ksel, bsel, splits, list_in,
                                cnt_in, list_out, cnt_out, p, C, T, t, eps2,
                                idx, gam, err, nsel, s)
            : launch_step<false>(Dt, xt, r, L, a0, ksel, bsel, splits,
                                 list_in, cnt_in, list_out, cnt_out, p, C, T,
                                 t, eps2, idx, gam, err, nsel, s);
    return static_cast<int>(e);
}
