// Feature-sign search from the empty active set to each lane's own exit, in
// one launch: the in-loop coder of the online learner.
//
// Replaces no Pallas kernel.  The JAX package runs this loop as one
// lax.while_loop on the device (lyssandra_tpu/solvers/lasso.py::
// feature_sign_scan); the port's plain version (solvers/lasso.py::_fs_init
// + _fs_loop) turns every exit test of that loop into a host read and every
// CG step into a dozen small launches.  This kernel computes what _fs_loop
// computes, outer step by outer step and with its constants, for
//     min_g ||x - D g||^2 + lam ||g||_1,
// in the Gram form, from alpha0 = X^T D (N, K) and G = D^T D (K, K), which
// the wrapper computes first with csrc/gram.cu.  The kernel never reads D or
// x.  One difference: every loop exit is tested per lane.  A lane's
// refinements and CG stop on its own test, where the batched loop runs them
// while any lane of the batch needs them; there they only add rounds of a
// converged solve, so the codes agree up to rounding.
//
// Per lane (row n of alpha0), with A <= 64 slots: done on entry when
// max |2 alpha0| <= lam + 1e-12.  Then up to max_iter outer iterations while
// the lane is not done:
//   activation: k = the lowest index among the maxima of |gr| over the
//     inactive atoms; when that max exceeds thr = lam (1 + 1e-4) + 1e-7 and
//     a slot is free, the first free slot takes atom k, theta = -sign(gr_k),
//     g = 0, and row/column of the compact Gram M[a, b] = G[idx_a, idx_b];
//   up to max_inner refinements while the active-set KKT test fails at
//     5e-6: the ridge-masked CG (mask M mask + (1 - mask) I + 1e-6 I) g =
//     (a0 - lam theta / 2) mask from the current g, up to max_cg iterations
//     while rs > 1e-12; a line search over t = 1 and the zero crossings t_a
//     in (0, 1), the first minimum winning (t = 1 wins ties); slots with
//     |g| < 1e-12 leave the active set;
//   the gradient gr_k = 2 (sum_a G[idx_a, k] g_a - alpha0[n, k]), zero at
//     the active atoms, and the full KKT test: done when no inactive |gr|
//     exceeds thr and no active |2 (M g - a0) + lam theta| exceeds 1e-4;
//     overflow (and done) when an inactive atom still violates and all A
//     slots are taken.
// The kernel writes the dense codes (N, K) (zeroed by the caller), done and
// overflow.
//
// What bounds it on an H100.  Latency, not bytes or flops: a lane's work is
// a chain of dependent steps.  Each outer iteration reads the c Gram rows of
// the support (c K floats) from L2, where G (4 MB at K=1024) stays resident,
// and each CG iteration is a matvec of at most 64 x 64 from shared memory
// and two reductions.  The design: the lane's state never leaves the SM
// (the compact Gram with an odd row stride, 16.6 KB; the alpha0 row; a bit
// per atom for the active set; about 22 KB a lane at K=1024), the host
// reads nothing, and the slot work (activation, CG, line search) runs in
// the lane's leading warp, thread t holding slots t and t + 32 in
// registers.  The gradient pass, the longest chain of loads, is split over
// all the lane's threads: a block of four warps a lane, the other three
// warps idle outside the gradient pass.  It finds the next violator and the
// inactive half of the KKT test on the way, so gr is never stored.  A warp
// a lane (four lanes a block, 16 columns a thread a pass) was 1.2-1.5x
// slower at 1,024 and 4,096 lanes of config 4 (measured on an H100;
// PERF.md).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "smem_opt_in.cuh"
#include "warp_reduce.cuh"

namespace {

using lyssa::FULL;
using lyssa::sgn;
using lyssa::warp_arg;
using lyssa::warp_sum;

constexpr int MAXA = 64;       // slots a lane: two a thread of one warp
constexpr int LD = MAXA + 1;   // the compact Gram's odd row stride
constexpr int WPL = 4;         // warps a lane: a block is one lane
constexpr int THREADS = 32 * WPL;
constexpr int RED = 16;        // words of the lane's exchange area

// 4-byte words of shared memory one lane needs (lane_smem_bytes / 4 in
// ops/cuda_fs_scan.py): the compact Gram (64, 65); four 64-wide broadcast
// vectors, the slot atoms and the active list (atoms, coefficients); the
// exchange area; a bit per atom; the lane's alpha0 row
__host__ __device__ inline size_t lane_floats(int K) {
    return (size_t)MAXA * LD + 7 * MAXA + RED + ((size_t)K + 31) / 32 +
           (size_t)K;
}

// One pass over gr_k = 2 (sum_{a < c} G[lidx_a, k] lg_a - a0s[k]), zero at
// the atoms whose bit is set in `act`, by the block's threads (thread gt
// takes columns gt + THREADS j).  Returns, on every thread, the largest
// |gr_k| over the inactive atoms with the lowest such k (K and -1 when there
// is none) and sign(gr_k) there.
__device__ void gradient_pass(const float* __restrict__ G, const float* a0s,
                              int K, int c, const int* lidx, const float* lg,
                              const unsigned* act, float* red, int gt,
                              float& best, int& bk, float& bsign) {
    constexpr int CH = 8;   // columns a thread a pass
    const int lane = gt & 31;
    best = -1.f;
    bk = K;
    float bs = 0.f;
    for (int k0 = 0; k0 < K; k0 += THREADS * CH) {
        float acc[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) acc[j] = 0.f;
        const int kb = k0 + gt;
        const bool full = k0 + THREADS * CH <= K;
#pragma unroll 2
        for (int a = 0; a < c; ++a) {
            const float ga = lg[a];
            const float* row = G + (size_t)lidx[a] * K + kb;
            if (full) {
#pragma unroll
                for (int j = 0; j < CH; ++j)
                    acc[j] = fmaf(__ldg(row + THREADS * j), ga, acc[j]);
            } else {
#pragma unroll
                for (int j = 0; j < CH; ++j)
                    if (kb + THREADS * j < K)
                        acc[j] = fmaf(__ldg(row + THREADS * j), ga, acc[j]);
            }
        }
        // k rises within a thread: a strict > keeps the first maximum
#pragma unroll
        for (int j = 0; j < CH; ++j) {
            const int k = kb + THREADS * j;
            if (k < K) {
                const bool active = (act[k >> 5] >> (k & 31)) & 1u;
                const float g = active ? 0.f : 2.f * (acc[j] - a0s[k]);
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
    // the warps' winners, combined in warp order by every thread alike
    int* redi = reinterpret_cast<int*>(red);
    const int wig = gt >> 5;
    if (lane == 0) {
        red[wig] = best;
        redi[4 + wig] = bk;
        red[8 + wig] = bs;
    }
    __syncthreads();
    best = red[0];
    bk = redi[4];
    bs = red[8];
#pragma unroll
    for (int w = 1; w < WPL; ++w) {
        const float v = red[w];
        const int i = redi[4 + w];
        if (v > best || (v == best && i < bk)) {
            best = v;
            bk = i;
            bs = red[8 + w];
        }
    }
    bsign = bk < K ? sgn(bs) : 0.f;
}

// a block a lane; registers capped so that 8 blocks fit an SM (one wave
// at 1,024 lanes)
__global__ void __launch_bounds__(THREADS, 8)
fs_scan_kernel(const float* __restrict__ A0, const float* __restrict__ G,
               int K, int A, int max_iter, int max_inner, int max_cg,
               float lam, float thr, float thr_done,
               float* __restrict__ gamma_out,
               unsigned char* __restrict__ done_out,
               unsigned char* __restrict__ ovf_out) {
    extern __shared__ float smem[];
    const int gt = threadIdx.x;
    const int lane = gt & 31;
    const bool lead = gt < 32;   // the leading warp
    const size_t n = blockIdx.x;   // the grid is N blocks
    const int kw = (K + 31) / 32;

    float* Mc = smem;            // (64, LD)
    float* vb = Mc + MAXA * LD;  // matvec operand, broadcast
    float* gb = vb + MAXA;       // coefficients, broadcast
    float* db = gb + MAXA;       // line-search direction, broadcast
    float* mb = db + MAXA;       // slot masks, broadcast
    int* sidx = reinterpret_cast<int*>(mb + MAXA);    // slot atoms
    int* lidx = sidx + MAXA;                          // active list: atoms
    float* lg = reinterpret_cast<float*>(lidx + MAXA);  // and coefficients
    float* red = lg + MAXA;      // the warps' winners, list length, flags
    int* redi = reinterpret_cast<int*>(red);
    unsigned* act = reinterpret_cast<unsigned*>(red + RED);  // active bits
    float* a0s = reinterpret_cast<float*>(act + kw);         // alpha0 row

    for (int k = gt; k < K; k += THREADS) a0s[k] = A0[(size_t)n * K + k];
    for (int q = gt; q < kw; q += THREADS) act[q] = 0u;
    if (lead) {
        sidx[lane] = 0;
        sidx[lane + 32] = 0;
    }
    __syncthreads();

    // gr at g = 0 is -2 alpha0: the done-on-entry test and the first
    // violator
    float best, bsign;
    int bk;
    gradient_pass(G, a0s, K, 0, lidx, lg, act, red, gt, best, bk, bsign);
    bool done = best <= thr_done;
    bool ovf = false;

    // slots lane and lane + 32 of the leading warp; zero until filled
    int s_idx[2] = {0, 0};
    float s_m[2] = {0.f, 0.f}, s_th[2] = {0.f, 0.f}, s_g[2] = {0.f, 0.f},
          s_a0[2] = {0.f, 0.f}, Hg[2] = {0.f, 0.f};
    int w = 0;  // slots in use: [0, w), filled in order

    // o = M v over the slots in use (rows >= w: 0); the leading warp only
    auto matvec = [&](const float* v, float* o) {
        vb[lane] = v[0];
        vb[lane + 32] = v[1];
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int a = lane + 32 * h;
            float s = 0.f;
            if (a < w) {
                const float* Mr = Mc + a * LD;
                for (int b = 0; b < w; ++b) s = fmaf(Mr[b], vb[b], s);
            }
            o[h] = s;
        }
        __syncwarp();
    };
    // the active-set KKT test at tol on the current slots, Hg = M g
    auto kkt_fails = [&](float tol) {
        bool v = false;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float va = fabsf(2.f * (Hg[h] - s_a0[h]) * s_m[h] +
                                   lam * s_th[h]) * s_m[h];
            v = v || va > tol;
        }
        return __any_sync(FULL, v);
    };

    for (int it = 0; it < max_iter && !done; ++it) {
        if (lead) {
            // --- activation of the violator the last pass found
            if (bk < K && best > thr) {
                const unsigned f0 =
                    __ballot_sync(FULL, lane < A && s_m[0] == 0.f);
                const unsigned f1 =
                    __ballot_sync(FULL, lane + 32 < A && s_m[1] == 0.f);
                const int fs = f0 ? __ffs(f0) - 1 : (f1 ? 31 + __ffs(f1) : -1);
                if (fs >= 0) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        if (lane + 32 * h == fs) {
                            s_idx[h] = bk;
                            s_m[h] = 1.f;
                            s_th[h] = -bsign;
                            s_g[h] = 0.f;
                            s_a0[h] = a0s[bk];
                            sidx[fs] = bk;
                        }
                    }
                    w = max(w, fs + 1);
                    __syncwarp();
                    // row and column fs of the compact Gram (stale atoms in
                    // free slots give finite entries that the masks drop)
                    for (int b = lane; b < w; b += 32) {
                        const float v = __ldg(G + (size_t)bk * K + sidx[b]);
                        Mc[fs * LD + b] = v;
                        Mc[b * LD + fs] = v;
                    }
                    __syncwarp();
                }
            }

            // --- refinements while the active-set KKT test fails at 5e-6
            matvec(s_g, Hg);
            bool not_opt = kkt_fails(5e-6f);
            for (int rf = 0; rf < max_inner && not_opt; ++rf) {
                const float m[2] = {s_m[0], s_m[1]};
                float x[2], r[2], pv[2], Mp[2], t[2];
                // ridge-masked CG from the current g
                auto op = [&](const float* v, float* o) {
                    const float vm[2] = {v[0] * m[0], v[1] * m[1]};
                    matvec(vm, t);
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        o[h] = m[h] * t[h] + (1.f - m[h]) * v[h] + 1e-6f * v[h];
                };
#pragma unroll
                for (int h = 0; h < 2; ++h) x[h] = s_g[h] * m[h];
                op(x, Mp);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float rhs =
                        (s_a0[h] * m[h] - lam * s_th[h] / 2.f) * m[h];
                    r[h] = rhs - Mp[h];
                    pv[h] = r[h];
                }
                float rs = warp_sum(r[0] * r[0] + r[1] * r[1]);
                for (int i = 0; i < max_cg && rs > 1e-12f; ++i) {
                    op(pv, Mp);
                    const float al =
                        rs / (warp_sum(pv[0] * Mp[0] + pv[1] * Mp[1]) + 1e-30f);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        x[h] = x[h] + al * pv[h];
                        r[h] = r[h] - al * Mp[h];
                    }
                    const float rs2 = warp_sum(r[0] * r[0] + r[1] * r[1]);
                    const float beta = rs2 / (rs + 1e-30f);
#pragma unroll
                    for (int h = 0; h < 2; ++h) pv[h] = r[h] + beta * pv[h];
                    rs = rs2;
                }
                float gnew[2], Hnew[2];
#pragma unroll
                for (int h = 0; h < 2; ++h) gnew[h] = x[h] * m[h];
                matvec(gnew, Hnew);

                // line search along g + s (gnew - g): the smooth part is
                // s b + s^2 cq, the l1 part summed per candidate
                float diff[2], Hd[2], ts[2];
                float sb = 0.f, sa = 0.f, sc = 0.f;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    diff[h] = gnew[h] - s_g[h];
                    Hd[h] = Hnew[h] - Hg[h];
                    sb += diff[h] * Hg[h];
                    sa += diff[h] * (s_a0[h] * m[h]);
                    sc += diff[h] * Hd[h];
                    const bool big = fabsf(diff[h]) > 1e-15f;
                    const float tc = big ? -s_g[h] / diff[h] : -1.f;
                    ts[h] = (tc > 0.f && tc < 1.f && m[h] > 0.5f) ? tc : 1.f;
                    gb[lane + 32 * h] = s_g[h];
                    db[lane + 32 * h] = diff[h];
                    mb[lane + 32 * h] = m[h];
                }
                const float b_lin = 2.f * (warp_sum(sb) - warp_sum(sa));
                const float cq = warp_sum(sc);
                __syncwarp();
                // obj(s) = s b + s^2 cq + lam l1(s), as the plain version
                // rounds it, so that a crossing candidate at s = 1 ties
                // with candidate 0 exactly
                auto obj = [&](float s) {
                    float l1 = 0.f;
                    for (int b = 0; b < w; ++b)
                        l1 += fabsf(__fadd_rn(gb[b], __fmul_rn(s, db[b]))) *
                              mb[b];
                    return __fadd_rn(
                        __fadd_rn(__fmul_rn(s, b_lin),
                                  __fmul_rn(__fmul_rn(s, s), cq)),
                        __fmul_rn(lam, l1));
                };
                const float obj0 = obj(1.f);  // candidate t = 1
                float objc = INFINITY;
                int ci = MAXA;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int a = lane + 32 * h;
                    if (a < w) {
                        const float o = obj(ts[h]);
                        if (o < objc) {
                            objc = o;
                            ci = a;
                        }
                    }
                }
                __syncwarp();
                warp_arg(objc, ci, false);
                const float mine = (ci >> 5) ? ts[1] : ts[0];
                const float tsel = __shfl_sync(FULL, mine, ci & 31);
                // candidate 0 wins ties (it comes first)
                const float tbest = (ci < w && objc < obj0) ? tsel : 1.f;

                // rounded as the plain version rounds them (a product, then
                // a sum; never one fma): at the chosen crossing gbest is a
                // rounding residue, and whether it lands on exactly 0
                // decides whether the slot leaves the active set
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float gbest =
                        __fadd_rn(s_g[h], __fmul_rn(tbest, diff[h]));
                    Hg[h] = __fadd_rn(Hg[h], __fmul_rn(tbest, Hd[h]));
                    const bool keep = m[h] > 0.5f && fabsf(gbest) >= 1e-12f;
                    s_m[h] = keep ? 1.f : 0.f;
                    s_g[h] = keep ? gbest : 0.f;
                    s_th[h] = keep ? sgn(gbest) : 0.f;
                }
                not_opt = kkt_fails(5e-6f);
            }

            // --- publish the active atoms: their bits and the list of the
            // nonzero ones for the gradient pass
            for (int q = lane; q < kw; q += 32) act[q] = 0u;
            __syncwarp();
            const unsigned below = (1u << lane) - 1u;
            const unsigned b0 =
                __ballot_sync(FULL, s_m[0] > 0.5f && s_g[0] != 0.f);
            const unsigned b1 =
                __ballot_sync(FULL, s_m[1] > 0.5f && s_g[1] != 0.f);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (s_m[h] > 0.5f)
                    atomicOr(&act[s_idx[h] >> 5], 1u << (s_idx[h] & 31));
                const unsigned bal = h ? b1 : b0;
                if ((bal >> lane) & 1u) {
                    const int pos = (h ? __popc(b0) : 0) + __popc(bal & below);
                    lidx[pos] = s_idx[h];
                    lg[pos] = s_g[h];
                }
            }
            if (lane == 0) redi[12] = __popc(b0) + __popc(b1);
        }
        __syncthreads();

        // --- the gradient at the refined point, the next violator and the
        // full KKT test
        gradient_pass(G, a0s, K, redi[12], lidx, lg, act, red, gt, best, bk,
                      bsign);
        if (lead) {
            const bool inact_viol = best > thr;
            const bool act_viol = kkt_fails(1e-4f);
            const int n_act = __popc(__ballot_sync(FULL, s_m[0] > 0.5f)) +
                              __popc(__ballot_sync(FULL, s_m[1] > 0.5f));
            const bool over = inact_viol && n_act == A;
            if (lane == 0)
                redi[13] =
                    (!inact_viol && !act_viol) || over ? 1 + 2 * over : 0;
        }
        __syncthreads();
        const int flag = redi[13];
        done = flag != 0;
        ovf = ovf || (flag & 2);
    }

    if (lead) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
            if (s_m[h] > 0.5f) gamma_out[(size_t)n * K + s_idx[h]] = s_g[h];
        if (lane == 0) {
            done_out[n] = done ? 1 : 0;
            ovf_out[n] = ovf ? 1 : 0;
        }
    }
}

}  // namespace

// Bytes of shared memory a block (one lane) takes at K atoms.
extern "C" size_t lyssa_fs_scan_smem_bytes(int K) {
    return lane_floats(K) * sizeof(float);
}

// alpha0 (N, K) = X^T D and G (K, K) = D^T D row-major float32 (G
// symmetric); gamma (N, K) float32, zeroed, receives the codes; done and
// overflow (N,) bytes 0/1.  thr and thr_done are the activation / KKT
// threshold lam (1 + 1e-4) + 1e-7 and the done-on-entry bound lam + 1e-12,
// rounded to float32 by the caller as the plain version rounds them.
// 1 <= A <= 64 slots.  Returns cudaGetLastError() after the launch.
extern "C" int lyssa_fs_scan(const float* A0, const float* G, int K, int N,
                             int A, int max_iter, int max_inner, int max_cg,
                             float lam, float thr, float thr_done,
                             float* gamma, unsigned char* done,
                             unsigned char* ovf, void* stream) {
    if (A < 1 || A > MAXA || K < 1 || N < 0 || max_iter < 0 ||
        max_inner < 0 || max_cg < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (N == 0) return static_cast<int>(cudaSuccess);
    const size_t smem = lane_floats(K) * sizeof(float);
    cudaError_t e = lyssa::opt_in_smem<fs_scan_kernel>(smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fs_scan_kernel<<<(unsigned)N, THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        A0, G, K, A, max_iter, max_inner, max_cg, lam, thr, thr_done, gamma,
        done, ovf);
    return static_cast<int>(cudaGetLastError());
}
