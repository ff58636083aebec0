// Fused feature-sign cold start: the first Tun activations of one signal's
// lasso solve, unrolled, in one warp.
//
// Replaces lyssandra_tpu/ops/pallas_fs.py::_kernel_fs_cold (K6).  It computes
// what the Pallas kernel and the plain version (solvers/lasso.py::
// _fs_unrolled_state) compute, step for step, for
//     min_g ||x - D g||^2 + lam ||g||_1.
// The TPU-only layout is not carried over: no 3-way bf16 one-hot atom fetch
// (a direct column read is exact here), no lists of (1, Nb) rows, no padding
// of p and K to (8, 128) tiles or of the lanes to a block.
//
// Per lane (signal x, column n of X (p, N)), gr = 2 D^T (0 - x); the lane is
// done on entry when max |gr| <= lam + 1e-12.  Then for t < Tun, c = t + 1,
// while the lane is not done:
//   activation: k = the lowest index among the maxima of |gr| (gr is zero at
//     active slots); it is live when that max exceeds thr = lam (1 + 1e-4) +
//     1e-7.  Slot t takes d_k (zero when not live), a0 = d_k . x, theta =
//     -sign(gr_k), and row/column t of the compact Gram G = dsel dsel^T;
//   n_refine refinements at width c: the ridge-masked system
//     (mask G mask + (1 - mask) I + 1e-6 I) g = (a0 - lam theta / 2) mask
//     by exactly c + 1 CG iterations (closed form at c = 1); a line search
//     over the c + 1 candidates t = 1 and the zero crossings t_a in (0, 1),
//     the first minimum winning on a strict <; slots with |g| < 1e-12 leave
//     the active set;
//   gradient gr = 2 D^T (dsel^T g - x), zeroed at the active slots, and the
//     KKT check: done when no inactive |gr| exceeds thr and no active
//     |2 (G g - a0) + lam theta| exceeds 1e-4.
// A lane that is done keeps its state from then on (the plain version's
// freeze at the post-activation, pre-refinement snapshot: nothing is live
// after that), so the warp leaves the step loop; the slots it never reached
// stay zero, as the plain version leaves them.
//
// What bounds it on an H100: the gradient, 2 p K flops per lane and step,
// reads all of D (p K floats, 768 KB at p=192, K=1024) from L2: thread `lane`
// accumulates columns lane + 32 j for a chunk of CH columns per pass, so a
// warp load reads 32 consecutive floats of one row, and the lane's residual
// R is broadcast from shared memory.  Everything else is O(p Tun + Tun^2)
// per step: thread a owns slot a (Tun <= 32) and keeps its mask, sign,
// coefficient, a0 and G g in registers; the CG, matvec and line search read
// the compact Gram and the broadcast vectors from the warp's shared memory
// (odd row strides, so threads reading different rows hit different banks).
// Reductions are xor butterflies, so every thread holds the same values and
// control flow stays warp-uniform.  One warp per block, so as many lanes fit
// on an SM as its shared memory holds (7 at p=192, K=1024, Tun=28).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CH = 16;  // gradient columns per thread per pass

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, m));
    return v;
}

// (value, index) of the max (want_max) or min, lowest index on ties; lane
// 0's result is broadcast so that every thread agrees even on NaN
__device__ __forceinline__ void warp_arg(float& v, int& i, bool want_max) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
        const float ov = __shfl_xor_sync(FULL, v, m);
        const int oi = __shfl_xor_sync(FULL, i, m);
        const bool better = want_max ? ov > v : ov < v;
        if (better || (ov == v && oi < i)) {
            v = ov;
            i = oi;
        }
    }
    v = __shfl_sync(FULL, v, 0);
    i = __shfl_sync(FULL, i, 0);
}

__device__ __forceinline__ float sgn(float v) {
    return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// 4-byte words of shared memory one lane needs (lane_smem_bytes / 4 in
// ops/cuda_fs.py): x, R (p each); gr (K); dsel (Tun, p|1); G (Tun, Tun|1);
// four 32-wide broadcast vectors
__host__ __device__ inline size_t lane_floats(int p, int K, int tun) {
    return 2 * (size_t)p + (size_t)K + (size_t)tun * (size_t)(p | 1) +
           (size_t)tun * (size_t)(tun | 1) + 4 * 32;
}

// gr[k] = 2 sum_i D[i, k] R[i] for every k; D (p, K) row-major
__device__ void gradient(const float* __restrict__ D, const float* R, int p,
                         int K, float* gr, int lane) {
    for (int k0 = 0; k0 < K; k0 += 32 * CH) {
        float acc[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[c] = 0.f;
        const int kb = k0 + lane;
        if (k0 + 32 * CH <= K) {
            for (int i = 0; i < p; ++i) {
                const float ri = R[i];
                const float* row = D + (size_t)i * K + kb;
#pragma unroll
                for (int c = 0; c < CH; ++c)
                    acc[c] = fmaf(__ldg(row + 32 * c), ri, acc[c]);
            }
        } else {
            for (int i = 0; i < p; ++i) {
                const float ri = R[i];
                const float* row = D + (size_t)i * K;
#pragma unroll
                for (int c = 0; c < CH; ++c) {
                    const int k = kb + 32 * c;
                    if (k < K) acc[c] = fmaf(__ldg(row + k), ri, acc[c]);
                }
            }
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            const int k = kb + 32 * c;
            if (k < K) gr[k] = 2.f * acc[c];
        }
    }
    __syncwarp();
}

__global__ void fs_cold_kernel(const float* __restrict__ X,
                               const float* __restrict__ D, int p, int K,
                               int N, int tun, int n_refine, float lam,
                               float thr, float thr_done,
                               int* __restrict__ idx_out,
                               unsigned char* __restrict__ mask_out,
                               float* __restrict__ theta_out,
                               float* __restrict__ g_out,
                               float* __restrict__ gr_out,
                               unsigned char* __restrict__ done_out) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x;
    const long long n = blockIdx.x;
    if (n >= N) return;
    const int ps = p | 1;
    const int gl = tun | 1;

    float* x = smem;
    float* R = x + p;
    float* gr = R + p;
    float* dsel = gr + K;        // (tun, ps): row a = atom of slot a
    float* G = dsel + tun * ps;  // (tun, gl): compact Gram of the slots
    float* vb = G + tun * gl;    // matvec operand, broadcast
    float* gb = vb + 32;         // coefficients, broadcast
    float* db = gb + 32;         // line-search direction, broadcast
    float* mb = db + 32;         // slot masks, broadcast

    for (int i = lane; i < p; i += 32) {
        const float v = X[(size_t)i * N + n];
        x[i] = v;
        R[i] = -v;
    }
    __syncwarp();
    gradient(D, R, p, K, gr, lane);  // at g = 0
    float m0 = 0.f;
    for (int k = lane; k < K; k += 32) m0 = fmaxf(m0, fabsf(gr[k]));
    bool done = warp_max(m0) <= thr_done;

    // slot `lane` (zero until step `lane` fills it)
    int s_idx = 0;
    float s_m = 0.f, s_th = 0.f, s_g = 0.f, s_a0 = 0.f;

    for (int t = 0; t < tun && !done; ++t) {
        const int c = t + 1;
        // out = sum_{b < c} G[lane, b] v_b (0 for lanes >= c)
        auto matvec = [&](float v) -> float {
            vb[lane] = v;
            __syncwarp();
            float s = 0.f;
            if (lane < c) {
                const float* Gr = G + lane * gl;
                for (int b = 0; b < c; ++b) s = fmaf(Gr[b], vb[b], s);
            }
            __syncwarp();
            return s;
        };

        // --- activation: the largest |gr|, lowest index on ties
        float best = -1.f;
        int bk = K;
        for (int k = lane; k < K; k += 32) {
            const float v = fabsf(gr[k]);
            if (v > best) {  // k rises within a thread: the first max stays
                best = v;
                bk = k;
            }
        }
        warp_arg(best, bk, true);
        const bool live = bk < K && best > thr;
        const float livef = live ? 1.f : 0.f;
        float* dk = dsel + t * ps;
        float ax = 0.f;
        for (int i = lane; i < p; i += 32) {
            const float v = live ? D[(size_t)i * K + bk] : 0.f;
            dk[i] = v;
            ax = fmaf(v, x[i], ax);
        }
        ax = warp_sum(ax);
        const float thk = -sgn(bk < K ? gr[bk] : 0.f) * livef;
        __syncwarp();
        // --- grow the compact Gram: row and column t
        if (lane < c) {
            const float* dj = dsel + lane * ps;
            float s = 0.f;
            for (int i = 0; i < p; ++i) s = fmaf(dj[i], dk[i], s);
            G[t * gl + lane] = s;
            G[lane * gl + t] = s;
        }
        if (lane == t) {
            s_idx = live ? bk : 0;
            s_m = livef;
            s_th = thk;
            s_g = 0.f;
            s_a0 = ax;
        }
        __syncwarp();

        // --- n_refine refinements at width c
        float Hg = matvec(s_g);
        float m2 = s_m, th2 = s_th, g2 = s_g;
        for (int rf = 0; rf < n_refine; ++rf) {
            const float a0m = s_a0 * m2;
            const float rhs = (a0m - lam * th2 / 2.f) * m2;
            float gnew;
            if (c == 1) {
                gnew = lane == 0 ? rhs / (G[0] + 1e-6f) * m2 : 0.f;
            } else {
                // ridge-masked CG from g2, exactly c + 1 iterations
                float xv = g2 * m2;
                float r = rhs - (m2 * matvec(xv * m2) + (1.f - m2) * xv +
                                 1e-6f * xv);
                float pv = r;
                float rs = warp_sum(r * r);
                for (int it = 0; it <= c; ++it) {
                    const float Mp = m2 * matvec(pv * m2) + (1.f - m2) * pv +
                                     1e-6f * pv;
                    const float al = rs / (warp_sum(pv * Mp) + 1e-30f);
                    xv = xv + al * pv;
                    r = r - al * Mp;
                    const float rs2 = warp_sum(r * r);
                    pv = r + (rs2 / (rs + 1e-30f)) * pv;
                    rs = rs2;
                }
                gnew = xv * m2;
            }
            const float Hnew = matvec(gnew);

            // line search along g2 + s (gnew - g2): the smooth part is
            // s b + s^2 cq, the l1 part is summed per candidate
            const float diff = gnew - g2;
            const float Hd = Hnew - Hg;
            const float b_lin =
                2.f * (warp_sum(diff * Hg) - warp_sum(diff * a0m));
            const float cq = warp_sum(diff * Hd);
            const bool big = fabsf(diff) > 1e-15f;
            const float tc = big ? -g2 / diff : -1.f;
            const float ts = (tc > 0.f && tc < 1.f && m2 > 0.5f) ? tc : 1.f;
            gb[lane] = g2;
            db[lane] = diff;
            mb[lane] = m2;
            __syncwarp();
            float l1 = 0.f;
            for (int b = 0; b < c; ++b) l1 += fabsf(gb[b] + db[b]) * mb[b];
            const float obj0 = b_lin + cq + lam * l1;  // candidate t = 1
            float objc = INFINITY;
            int ci = 32;
            if (lane < c) {
                float l1c = 0.f;
                for (int b = 0; b < c; ++b)
                    l1c += fabsf(gb[b] + ts * db[b]) * mb[b];
                objc = ts * b_lin + ts * ts * cq + lam * l1c;
                ci = lane;
            }
            __syncwarp();
            warp_arg(objc, ci, false);
            const float tsel = __shfl_sync(FULL, ts, ci & 31);
            // candidate 0 wins ties (it comes first)
            const float tbest = (ci < c && objc < obj0) ? tsel : 1.f;

            // rounded as the plain version rounds them (a product, then a
            // sum; never one fma): at the chosen crossing gbest is a
            // rounding residue, and whether it lands on exactly 0 decides
            // whether the slot leaves the active set
            const float gbest = __fadd_rn(g2, __fmul_rn(tbest, diff));
            Hg = __fadd_rn(Hg, __fmul_rn(tbest, Hd));
            m2 = (m2 > 0.5f && fabsf(gbest) >= 1e-12f) ? 1.f : 0.f;
            g2 = m2 > 0.5f ? gbest : 0.f;
            th2 = m2 > 0.5f ? sgn(gbest) : 0.f;
        }

        // --- full gradient at the refined point, masked, and the KKT check
        gb[lane] = g2 * m2;
        __syncwarp();
        for (int i = lane; i < p; i += 32) {
            float v = 0.f;
            for (int a = 0; a < c; ++a) v = fmaf(gb[a], dsel[a * ps + i], v);
            R[i] = v - x[i];
        }
        __syncwarp();
        gradient(D, R, p, K, gr, lane);
        if (lane < c && m2 > 0.5f) gr[s_idx] = 0.f;
        __syncwarp();
        float mx = 0.f;
        for (int k = lane; k < K; k += 32) mx = fmaxf(mx, fabsf(gr[k]));
        const bool inact_viol = warp_max(mx) > thr;
        const float va =
            fabsf(2.f * (Hg - s_a0 * m2) * m2 + lam * th2) * m2;
        const bool act_viol = __any_sync(FULL, va > 1e-4f);
        done = !inact_viol && !act_viol;
        s_m = m2;
        s_th = th2;
        s_g = g2;
    }

    if (lane < tun) {
        const size_t o = (size_t)n * tun + lane;
        idx_out[o] = s_idx;
        mask_out[o] = s_m > 0.5f ? 1 : 0;
        theta_out[o] = s_th;
        g_out[o] = s_g;
    }
    for (int k = lane; k < K; k += 32) gr_out[(size_t)n * K + k] = gr[k];
    if (lane == 0) done_out[n] = done ? 1 : 0;
}

}  // namespace

// X (p, N) and D (p, K) row-major float32; idx (N, tun) int32, mask (N, tun)
// bytes 0/1, theta and gact (N, tun) float32, gr (N, K) float32 (the gradient
// at the handoff point, zero at active slots), done (N,) bytes 0/1.  thr and
// thr_done are the activation / KKT threshold lam (1 + 1e-4) + 1e-7 and the
// done-on-entry bound lam + 1e-12, rounded to float32 by the caller as the
// plain version rounds them.  1 <= tun <= 32; one lane (warp) per block.
// Returns cudaGetLastError() after the launch.
extern "C" int lyssa_fs_cold(const float* X, const float* D, int p, int K,
                             int N, int tun, int n_refine, float lam,
                             float thr, float thr_done, int* idx,
                             unsigned char* mask, float* theta, float* gact,
                             float* gr, unsigned char* done, void* stream) {
    if (tun < 1 || tun > 32 || n_refine < 0 || p < 1 || K < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = lane_floats(p, K, tun) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        fs_cold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fs_cold_kernel<<<(unsigned)N, 32, smem, s>>>(X, D, p, K, N, tun, n_refine,
                                                  lam, thr, thr_done, idx,
                                                  mask, theta, gact, gr, done);
    return static_cast<int>(cudaGetLastError());
}
