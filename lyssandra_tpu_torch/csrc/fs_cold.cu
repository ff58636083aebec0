// Fused feature-sign cold start in the Gram form: the first Tun activations
// of one signal's lasso solve, unrolled, in one warp.
//
// Replaces lyssandra_tpu/ops/pallas_fs.py::_kernel_fs_cold (K6).  It computes
// what the Pallas kernel and the plain version (solvers/lasso.py::
// _fs_unrolled_state) compute, step for step, for
//     min_g ||x - D g||^2 + lam ||g||_1,
// but from alpha0 = X^T D (N, K) and the Gram matrix G = D^T D (K, K), which
// the wrapper computes first with csrc/gram.cu.  The kernel never reads D or
// x.  The TPU-only layout is not carried over: no 3-way bf16 one-hot atom
// fetch, no lists of (1, Nb) rows, no padding of p and K to (8, 128) tiles or
// of the lanes to a block.
//
// Per lane (row n of alpha0), gr = -2 alpha0; the lane is done on entry when
// max |gr| <= lam + 1e-12.  Then for t < Tun, c = t + 1, while the lane is
// not done:
//   activation: k = the lowest index among the maxima of |gr| over the
//     inactive atoms; it is live when that max exceeds thr = lam (1 + 1e-4)
//     + 1e-7.  Slot t takes atom k (index 0 and a zero Gram row when not
//     live), a0 = alpha0[n, k], theta = -sign(gr_k), and row/column t of the
//     compact Gram, G[k, sel_b] for the live slots b <= t;
//   n_refine refinements at width c: the ridge-masked system
//     (mask G mask + (1 - mask) I + 1e-6 I) g = (a0 - lam theta / 2) mask
//     by exactly c + 1 CG iterations (closed form at c = 1); a line search
//     over the c + 1 candidates t = 1 and the zero crossings t_a in (0, 1),
//     the first minimum winning on a strict <, t = 1 winning ties; slots
//     with |g| < 1e-12 leave the active set;
//   gradient gr_k = 2 (sum_a G[sel_a, k] g_a - alpha0[n, k]), zero at the
//     active slots, and the KKT check: done when no inactive |gr| exceeds
//     thr and no active |2 (G g - a0) + lam theta| exceeds 1e-4.
// A lane that is done keeps its state from then on (the plain version's
// freeze at the post-activation, pre-refinement snapshot: nothing is live
// after that), so the warp leaves the step loop; the slots it never reached
// stay zero, as the plain version leaves them.
//
// What bounds it on an H100.  The gradient now reads the c Gram rows of the
// support (c K floats, coalesced: thread `lane` takes columns lane + 32 j,
// 16 of them per pass, so a row is 16 independent loads in flight) from L2,
// where the residual form read all of D (p K floats) per step; at K=1024
// that is 2 K c flops a step against 2 p K.  The lane's alpha0 row is
// staged in its shared memory at entry.  The same pass finds the next
// violator (max |gr| over the inactive atoms, tested against a bit set of
// the active atoms in shared memory) and the KKT test, so gr is never
// stored: the handoff gr is written by one more pass at the end.  What is
// left is latency: the gradient pass and the (c + 1)-iteration CG and line
// search, each iteration a c-long matvec from shared memory and
// xor-butterfly reductions.  Thread a owns slot a (Tun <= 32) and keeps its
// index, mask, sign, coefficient and a0 in registers; the compact Gram (odd
// row stride), the broadcast vectors and the alpha0 row sit in the warp's
// shared memory, 8 KB a lane at Tun=28, K=1024.  So the registers set how many lanes an SM
// holds: capped at 128 a thread, 4 blocks of 4 lanes fit.  Of 8, 16 or 32
// columns a pass, alpha0 in shared or global memory, and with or without
// that cap, no variant was fastest at both 2,048 lanes (one lasso-encoder
// block) and 16,384; this one was within 5% of the fastest at 2,048 and 11%
// at 16,384 (measured on an H100; PERF.md).  Reductions are xor butterflies, so
// every thread holds the same values and control flow stays warp-uniform.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "warp_reduce.cuh"

namespace {

using lyssa::FULL;
using lyssa::sgn;
using lyssa::warp_arg;
using lyssa::warp_sum;

constexpr int CH = 16;     // gradient columns per thread per pass
constexpr int WARPS = 4;   // lanes (warps) per block, at most

// 4-byte words of shared memory one lane needs (lane_smem_bytes / 4 in
// ops/cuda_fs.py): the compact Gram (Tun, Tun|1); four 32-wide broadcast
// vectors and the 32 slot indices; a bit per atom for the active set; the
// lane's alpha0 row
__host__ __device__ inline size_t lane_floats(int K, int tun) {
    return (size_t)tun * (size_t)(tun | 1) + 5 * 32 + ((size_t)K + 31) / 32 +
           (size_t)K;
}

// One pass over the gradient gr_k = 2 (sum_{a < c} G[sb_a, k] gb_a -
// a0s[k]) (a0s: the lane's alpha0 row in shared memory), zero at the atoms
// whose bit is set in `act`.  Returns, on every
// thread, the largest |gr_k| over the inactive atoms with the lowest such
// k (K and -1 when there is none) and sign(gr_k) there; writes gr to `out`
// when it is not null.
__device__ void gradient_scan(const float* __restrict__ G,
                              const float* a0s, int K, int c,
                              const float* gb, const int* sb,
                              const unsigned* act, float* __restrict__ out,
                              int lane, float& best, int& bk, float& bsign) {
    best = -1.f;
    bk = K;
    float bs = 0.f;
    for (int k0 = 0; k0 < K; k0 += 32 * CH) {
        float acc[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) acc[j] = 0.f;
        const int kb = k0 + lane;
        for (int a = 0; a < c; ++a) {
            const float ga = gb[a];
            if (ga == 0.f) continue;  // warp-uniform; adds nothing
            const float* row = G + (size_t)sb[a] * K + kb;
            if (k0 + 32 * CH <= K) {
#pragma unroll
                for (int j = 0; j < CH; ++j)
                    acc[j] = fmaf(__ldg(row + 32 * j), ga, acc[j]);
            } else {
#pragma unroll
                for (int j = 0; j < CH; ++j)
                    if (kb + 32 * j < K)
                        acc[j] = fmaf(__ldg(row + 32 * j), ga, acc[j]);
            }
        }
        // k rises within a thread: a strict > keeps the first maximum
#pragma unroll
        for (int j = 0; j < CH; ++j) {
            const int k = kb + 32 * j;
            if (k < K) {
                const bool active = (act[k >> 5] >> lane) & 1u;
                const float g = active ? 0.f : 2.f * (acc[j] - a0s[k]);
                if (out) out[k] = g;
                const float v = fabsf(g);
                if (!active && v > best) {
                    best = v;
                    bk = k;
                    bs = g;
                }
            }
        }
    }
    warp_arg(best, bk, true);
    // the winner's own signed value lives on the thread that owns column bk
    bs = __shfl_sync(FULL, bs, bk & 31);
    bsign = bk < K ? sgn(bs) : 0.f;
}

// at most WARPS warps a block, and registers capped so that 4 blocks fit an
// SM (123 a thread, no spills)
__global__ void __launch_bounds__(32 * WARPS, 4)
fs_cold_kernel(const float* __restrict__ A0, const float* __restrict__ G,
               int K, int N, int tun, int n_refine, float lam, float thr,
               float thr_done, int* __restrict__ idx_out,
               unsigned char* __restrict__ mask_out,
               float* __restrict__ theta_out, float* __restrict__ g_out,
               float* __restrict__ gr_out,
               unsigned char* __restrict__ done_out) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long n = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
    if (n >= N) return;  // warp-uniform: no block-level barrier follows
    const int gl = tun | 1;
    const int kw = (K + 31) / 32;

    float* Gc = smem + (size_t)warp * lane_floats(K, tun);  // (tun, gl)
    float* vb = Gc + tun * gl;   // matvec operand, broadcast
    float* gb = vb + 32;         // coefficients, broadcast
    float* db = gb + 32;         // line-search direction, broadcast
    float* mb = db + 32;         // slot masks, broadcast
    int* sb = reinterpret_cast<int*>(mb + 32);                // slot atoms
    unsigned* act = reinterpret_cast<unsigned*>(sb + 32);     // active bits
    float* a0s = reinterpret_cast<float*>(act + kw);          // alpha0 row

    for (int k = lane; k < K; k += 32) a0s[k] = A0[(size_t)n * K + k];
    for (int w = lane; w < kw; w += 32) act[w] = 0u;
    gb[lane] = 0.f;
    sb[lane] = 0;
    __syncwarp();

    // gr at g = 0 is -2 alpha0: the done-on-entry test and the first
    // violator
    float best, bsign;
    int bk;
    gradient_scan(G, a0s, K, 0, gb, sb, act, nullptr, lane, best, bk, bsign);
    bool done = best <= thr_done;
    int c_last = 0;  // slots in the last gradient (for the handoff pass)

    // slot `lane` (zero until step `lane` fills it)
    int s_idx = 0;
    bool s_live = false;
    float s_m = 0.f, s_th = 0.f, s_g = 0.f, s_a0 = 0.f;

    for (int t = 0; t < tun && !done; ++t) {
        const int c = t + 1;
        // out = sum_{b < c} G[lane, b] v_b (0 for lanes >= c)
        auto matvec = [&](float v) -> float {
            vb[lane] = v;
            __syncwarp();
            float s = 0.f;
            if (lane < c) {
                const float* Gr = Gc + lane * gl;
                for (int b = 0; b < c; ++b) s = fmaf(Gr[b], vb[b], s);
            }
            __syncwarp();
            return s;
        };

        // --- activation: the violator found by the last gradient pass
        const bool live = bk < K && best > thr;
        const float livef = live ? 1.f : 0.f;
        if (lane == t) {
            s_idx = live ? bk : 0;
            s_live = live;
            s_m = livef;
            s_th = -bsign * livef;
            s_g = 0.f;
            s_a0 = live ? a0s[bk] : 0.f;
        }
        // --- grow the compact Gram: row and column t (zero for a slot
        // that holds no atom)
        if (lane < c) {
            const float s =
                (live && s_live) ? __ldg(G + (size_t)bk * K + s_idx) : 0.f;
            Gc[t * gl + lane] = s;
            Gc[lane * gl + t] = s;
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
                gnew = lane == 0 ? rhs / (Gc[0] + 1e-6f) * m2 : 0.f;
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

        // --- gradient at the refined point over the active slots, the next
        // violator and the KKT check
        for (int w = lane; w < kw; w += 32) act[w] = 0u;
        gb[lane] = g2 * m2;
        sb[lane] = s_idx;
        __syncwarp();
        if (lane < c && m2 > 0.5f)
            atomicOr(&act[s_idx >> 5], 1u << (s_idx & 31));
        __syncwarp();
        gradient_scan(G, a0s, K, c, gb, sb, act, nullptr, lane, best, bk,
                      bsign);
        c_last = c;
        const bool inact_viol = best > thr;
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
    // the handoff gradient: the last pass again, written out (the same
    // operands in the same order, so the same values)
    gradient_scan(G, a0s, K, c_last, gb, sb, act, gr_out + (size_t)n * K,
                  lane, best, bk, bsign);
    if (lane == 0) done_out[n] = done ? 1 : 0;
}

}  // namespace

// alpha0 (N, K) = X^T D and G (K, K) = D^T D row-major float32; idx (N, tun)
// int32, mask (N, tun) bytes 0/1, theta and gact (N, tun) float32, gr (N, K)
// float32 (the gradient at the handoff point, zero at active slots), done
// (N,) bytes 0/1.  thr and thr_done are the activation / KKT threshold
// lam (1 + 1e-4) + 1e-7 and the done-on-entry bound lam + 1e-12, rounded to
// float32 by the caller as the plain version rounds them.  1 <= tun <= 32;
// `warps` lanes (warps) per block.  Returns cudaGetLastError() after the
// launch.
extern "C" int lyssa_fs_cold(const float* A0, const float* G, int K, int N,
                             int tun, int n_refine, float lam, float thr,
                             float thr_done, int warps, int* idx,
                             unsigned char* mask, float* theta, float* gact,
                             float* gr, unsigned char* done, void* stream) {
    if (tun < 1 || tun > 32 || n_refine < 0 || K < 1 || warps < 1 ||
        warps > WARPS)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = lane_floats(K, tun) * sizeof(float) * warps;
    cudaError_t e = cudaFuncSetAttribute(
        fs_cold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const unsigned blocks = (unsigned)((N + warps - 1) / warps);
    fs_cold_kernel<<<blocks, 32 * warps, smem, s>>>(
        A0, G, K, N, tun, n_refine, lam, thr, thr_done, idx, mask, theta,
        gact, gr, done);
    return static_cast<int>(cudaGetLastError());
}
