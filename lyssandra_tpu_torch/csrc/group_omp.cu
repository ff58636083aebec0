// Fused group OMP in the Gram form: all T group-selection steps of one signal
// in one warp.
//
// Replaces lyssandra_tpu/ops/pallas_group.py::_kernel (K4) and
// ::_kernel_packed (K5).  The two compute the same thing and differ only in
// how a TPU lays out the inverse factor (single rows or sublane-packed
// tiles), so one kernel covers both.  The TPU-only layout tricks are not
// carried over: the slot-matrix stacks DsT/Ds, the gs one-hot matmuls of the
// member fetch, the padding of groups to 128 and of lanes to a 256 block.  A
// direct column read is exact here.
//
// Inputs: the slot dictionary Dp (p, ng*gs) row-major, column g*gs + s =
// atom s of group g (zero in a padded slot), built once per call by the
// wrapper; alpha0 = X^T Dp (N, ng*gs) and the slot Gram Gp = Dp^T Dp
// (ng*gs, ng*gs), computed first by csrc/gram.cu.  The reference pads the
// groups to 128 with zero atoms; a padded group scores 0 and has a higher
// index than every real group, and T <= ng, so it never wins a step: the
// port needs no padded groups.
//
// Per lane (signal x, column n of X (p, N)), with A = T gs slots:
//   repeat t < T:
//     corr   = alpha0 - Gp[:, sel] gam (gam the refined coefficients so far)
//     g      = lowest index among the maxima of sum_s corr_{g,s}^2 over the
//              groups not selected yet
//     slots t gs .. t gs + gs - 1 take the atoms of g; a slot is valid when
//              ||d||^2 = Gp[c, c] > 1e-12 (padded members are zero atoms)
//     block append to the inverse factor Linv, from Gp and alpha0:
//       W = Linv G_cross (G_cross = Gp[selected, new]),
//       S = G_nn - W^T W (+1 on the diagonal of an invalid slot),
//       Lb = chol(S + 1e-9 I); a pivot <= 1e-8 freezes the lane,
//       new rows = [-Lb^{-1} W^T Linv | Lb^{-1}]
//     gamma = Linv^T Linv a0, then two refinement rounds on the residual
//       gamma += Linv^T Linv (D_sel^T (x - D_sel gamma)); r = x - D_sel gamma
//   then a final solve over all slots with two refinement rounds; err is its
//   ||r||^2, gamma is masked by slot validity, nsel counts groups.
// A frozen lane keeps its state and its rows past the last good step stay
// zero, so leaving the step loop is exact (the final solve reproduces its
// retained solution).
//
// What bounds it on an H100.  The scores read, per lane and step, the lane's
// alpha0 row and the Gp rows of the t gs selected slots (K floats each,
// 2 K t gs flops), where the residual form read all of Dp (2 p K flops a
// step): 24 rows of 1,024 floats over T=4 steps at gs=4 against 4 x 64.
// Thread `lane` scores groups g = lane (mod 32) one at a time and reads a
// group's gs consecutive floats of a row as one 16-byte load at gs=4
// (float4 where gs is a multiple of 4, float2 where it is even), so a warp
// reads 32 gs contiguous floats of each row.  (Scoring 32 / gs groups per
// thread at once, to keep more loads in flight, took 140 registers a thread
// and ran slower on an H100; PERF.md.)  The factor's inputs are
// entries of Gp and alpha0, not p-long dot products.  The refinement rounds and the final
// err stay on the residual (O(A p) a step, the selected atoms in the warp's
// shared memory): Gram-form energies cancel at small residuals, and err is
// an output.  The block append and the solves are O(A^2) per step, thread j
// owning slot j (A <= 32); the factor and the small vectors sit in shared
// memory with odd row strides, so that threads reading different rows hit
// different banks.  The gs x gs factorization runs on lane 0 and is shared
// through shared memory; reductions over p use xor butterflies, so every
// thread holds the same values and control flow stays warp-uniform.  What
// is left is latency, one warp per lane: the L2 loads of the scores, and
// the serial p-long dot products and triangular solves of the refinement
// rounds; at 96 registers a thread an SM holds about 20 lanes.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// max score with the lowest index among equal values
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

// 4-byte words of shared memory one lane needs (lane_smem_bytes / 4 in
// ops/cuda_group.py): x, r; dsel (A, p|1); L (A, A|1); a0, valid, gam, y, v;
// Gc, W (A, gs|1); Sc, Lbi (gs, gs); V (gs, A); T group ids and a flag
__host__ __device__ inline size_t lane_floats(int p, int gs, int T) {
    const size_t A = (size_t)T * gs;
    return 2 * (size_t)p + A * (size_t)(p | 1) + A * (A | 1) + 5 * A +
           2 * A * (size_t)(gs | 1) + 2 * (size_t)gs * gs + (size_t)gs * A +
           (size_t)T + 1;
}

// out = Linv^T (Linv rhs) over the first hi slots (out may alias rhs)
__device__ __forceinline__ void solve(const float* L, int la, int hi,
                                      const float* rhs, float* y, float* out,
                                      int lane) {
    for (int i = lane; i < hi; i += 32) {
        float s = 0.f;
        for (int j = 0; j < hi; ++j) s = fmaf(L[i * la + j], rhs[j], s);
        y[i] = s;
    }
    __syncwarp();
    for (int j = lane; j < hi; j += 32) {
        float s = 0.f;
        for (int i = 0; i < hi; ++i) s = fmaf(L[i * la + j], y[i], s);
        out[j] = s;
    }
    __syncwarp();
}

// the gs consecutive floats at ptr (16-byte loads where gs allows: rows of
// alpha0 and Gp are ng gs floats long and start on 16-byte boundaries)
template <int GS>
__device__ __forceinline__ void load_group(const float* __restrict__ ptr,
                                           float (&v)[GS]) {
    if constexpr (GS % 4 == 0) {
#pragma unroll
        for (int i = 0; i < GS / 4; ++i) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(ptr) + i);
            v[4 * i] = q.x;
            v[4 * i + 1] = q.y;
            v[4 * i + 2] = q.z;
            v[4 * i + 3] = q.w;
        }
    } else if constexpr (GS % 2 == 0) {
#pragma unroll
        for (int i = 0; i < GS / 2; ++i) {
            const float2 q = __ldg(reinterpret_cast<const float2*>(ptr) + i);
            v[2 * i] = q.x;
            v[2 * i + 1] = q.y;
        }
    } else {
#pragma unroll
        for (int s = 0; s < GS; ++s) v[s] = __ldg(ptr + s);
    }
}

// r = x - sum_{j < hi} gam_j dsel_j; returns ||r||^2 (warp-uniform)
__device__ __forceinline__ float residual(const float* x, const float* dsel,
                                          int ps, const float* gam, int hi,
                                          int p, float* r, int lane) {
    float rr = 0.f;
    for (int i = lane; i < p; i += 32) {
        float v = x[i];
        for (int j = 0; j < hi; ++j) v = fmaf(-gam[j], dsel[j * ps + i], v);
        r[i] = v;
        rr = fmaf(v, v, rr);
    }
    __syncwarp();
    return warp_sum(rr);
}

// gam = Linv^T Linv a0 and two refinement rounds over the first hi slots;
// leaves the final residual in r and returns its energy
__device__ float refined_solve(const float* x, const float* dsel, int ps,
                               const float* L, int la, const float* a0,
                               int hi, int p, float* gam, float* y, float* v,
                               float* r, int lane) {
    solve(L, la, hi, a0, y, gam, lane);
    for (int round = 0; round < 2; ++round) {
        residual(x, dsel, ps, gam, hi, p, r, lane);
        for (int j = lane; j < hi; j += 32) {
            const float* dj = dsel + j * ps;
            float s = 0.f;
            for (int i = 0; i < p; ++i) s = fmaf(dj[i], r[i], s);
            v[j] = s;
        }
        __syncwarp();
        solve(L, la, hi, v, y, v, lane);
        for (int j = lane; j < hi; j += 32) gam[j] += v[j];
        __syncwarp();
    }
    return residual(x, dsel, ps, gam, hi, p, r, lane);
}

template <int GS>
__global__ void group_omp_kernel(const float* __restrict__ X,
                                 const float* __restrict__ Dp,
                                 const float* __restrict__ A0,
                                 const float* __restrict__ Gp, int p, int ng,
                                 int N, int T, float* __restrict__ gam_out,
                                 int* __restrict__ gidx_out,
                                 float* __restrict__ err_out,
                                 int* __restrict__ nsel_out) {
    constexpr int GP = GS | 1;
    extern __shared__ float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long n = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
    if (n >= N) return;  // warp-uniform: no block-level barrier follows
    const int A = T * GS;
    const int ps = p | 1;
    const int la = A | 1;
    const size_t ngs = (size_t)ng * GS;
    const float* A0n = A0 + (size_t)n * ngs;

    float* x = smem + warp * lane_floats(p, GS, T);
    float* r = x + p;
    float* dsel = r + p;              // (A, ps): row j = atom of slot j
    float* L = dsel + A * ps;         // (A, la): inverse factor, lower
    float* a0 = L + A * la;           // alpha0 of slot j (d_j . x)
    float* valid = a0 + A;            // 1 on a real member slot
    float* gam = valid + A;
    float* y = gam + A;
    float* v = y + A;
    float* Gc = v + A;                // (A, GP): Gp[slot j, new s], j < base
    float* W = Gc + A * GP;           // (A, GP): Linv Gc
    float* Sc = W + A * GP;           // (GS, GS): Schur block, then its factor
    float* Lbi = Sc + GS * GS;        // (GS, GS): inverse of the factor
    float* V = Lbi + GS * GS;         // (GS, A): Lbi W^T
    int* gids = reinterpret_cast<int*>(V + GS * A);  // (T) selected groups
    int* okp = gids + T;

    for (int i = lane; i < p; i += 32) {
        const float val = X[(size_t)i * N + n];
        x[i] = val;
        r[i] = val;
    }
    for (int e = lane; e < A * la; e += 32) L[e] = 0.f;
    for (int j = lane; j < A; j += 32) {
        a0[j] = 0.f;
        valid[j] = 0.f;
        gam[j] = 0.f;
    }
    for (int j = lane; j < T; j += 32) gids[j] = 0;
    int nsel = 0;
    __syncwarp();

    for (int t = 0; t < T; ++t) {
        // --- selection: argmax_g sum_s corr_{g,s}^2, lowest g on ties, with
        // corr = alpha0 - sum over the t gs selected slots of gam_j Gp[slot_j]
        float best = -1.f;
        int bg = ng;
        for (int g = lane; g < ng; g += 32) {
            bool taken = false;
            for (int j = 0; j < t; ++j) taken |= gids[j] == g;
            if (taken) continue;  // a selected group never wins again
            float c[GS];
            load_group<GS>(A0n + (size_t)g * GS, c);
            for (int j = 0; j < t; ++j) {
                const size_t slot0 = (size_t)gids[j] * GS;
#pragma unroll
                for (int s2 = 0; s2 < GS; ++s2) {
                    const float gj = gam[j * GS + s2];
                    float row[GS];
                    load_group<GS>(Gp + (slot0 + s2) * ngs + (size_t)g * GS,
                                   row);
#pragma unroll
                    for (int s = 0; s < GS; ++s)
                        c[s] = fmaf(-gj, row[s], c[s]);
                }
            }
            float sc = 0.f;
#pragma unroll
            for (int s = 0; s < GS; ++s) sc = fmaf(c[s], c[s], sc);
            if (sc > best) {  // g rises within a thread: the first max stays
                best = sc;
                bg = g;
            }
        }
        warp_argmax(best, bg);
        if (bg >= ng) break;  // every score NaN: nothing to read; freeze
        const int base = t * GS;
        const int hi = base + GS;
        const size_t cnew = (size_t)bg * GS;  // the new group's first column

        // --- fetch the group's atoms into slots base .. hi - 1 (for the
        // residual of the refinement rounds)
        for (int s = 0; s < GS; ++s)
            for (int i = lane; i < p; i += 32)
                dsel[(base + s) * ps + i] = Dp[(size_t)i * ngs + cnew + s];
        // thread j: G_cross row j (j < base), or slot j's validity and a0,
        // all entries of Gp and alpha0
        for (int j = lane; j < hi; j += 32) {
            if (j < base) {
                float row[GS];
                load_group<GS>(Gp + ((size_t)gids[j / GS] * GS + j % GS) * ngs
                                   + cnew, row);
#pragma unroll
                for (int s = 0; s < GS; ++s) Gc[j * GP + s] = row[s];
            } else {
                const size_t cj = cnew + (j - base);
                valid[j] = __ldg(Gp + cj * ngs + cj) > 1e-12f ? 1.f : 0.f;
                a0[j] = __ldg(A0n + cj);
            }
        }
        __syncwarp();
        // W = Linv G_cross over the base selected slots
        for (int i = lane; i < base; i += 32) {
            float acc[GS];
#pragma unroll
            for (int s = 0; s < GS; ++s) acc[s] = 0.f;
            for (int j = 0; j <= i; ++j) {
                const float lij = L[i * la + j];
#pragma unroll
                for (int s = 0; s < GS; ++s)
                    acc[s] = fmaf(lij, Gc[j * GP + s], acc[s]);
            }
#pragma unroll
            for (int s = 0; s < GS; ++s) W[i * GP + s] = acc[s];
        }
        __syncwarp();
        // Schur block, lower triangle: G_nn - W^T W (+1 for an invalid slot)
        for (int e = lane; e < GS * GS; e += 32) {
            const int s1 = e / GS, s2 = e % GS;
            if (s2 > s1) continue;
            float gnn = __ldg(Gp + (cnew + s1) * ngs + cnew + s2);
            if (s1 == s2) gnn += 1.f - valid[base + s1];
            float ww = 0.f;
            for (int i = 0; i < base; ++i)
                ww = fmaf(W[i * GP + s1], W[i * GP + s2], ww);
            Sc[s1 * GS + s2] = gnn - ww;
        }
        __syncwarp();
        // lane 0: unrolled Cholesky of the block in place (jitter 1e-9, a
        // pivot <= 1e-8 fails) and the inverse of the factor
        if (lane == 0) {
            int ok = 1;
#pragma unroll
            for (int i = 0; i < GS; ++i) {
                float s_ = Sc[i * GS + i] + 1e-9f;
                for (int k = 0; k < i; ++k)
                    s_ -= Sc[i * GS + k] * Sc[i * GS + k];
                ok &= s_ > 1e-8f;
                const float dii = sqrtf(fmaxf(s_, 1e-12f));
                Sc[i * GS + i] = dii;
                const float inv = 1.f / dii;
                for (int j2 = i + 1; j2 < GS; ++j2) {
                    float s2 = Sc[j2 * GS + i];
                    for (int k = 0; k < i; ++k)
                        s2 -= Sc[j2 * GS + k] * Sc[i * GS + k];
                    Sc[j2 * GS + i] = s2 * inv;
                }
            }
#pragma unroll
            for (int j2 = 0; j2 < GS; ++j2)
                for (int i = j2; i < GS; ++i) {
                    float acc = 0.f;
                    for (int k = j2; k < i; ++k)
                        acc -= Sc[i * GS + k] * Lbi[k * GS + j2];
                    if (i == j2) acc += 1.f;
                    Lbi[i * GS + j2] = acc / Sc[i * GS + i];
                }
            *okp = ok;
        }
        __syncwarp();
        if (!*okp) {  // frozen: the step leaves no trace; state kept
            for (int s = 0; s < GS; ++s)
                for (int i = lane; i < p; i += 32) dsel[(base + s) * ps + i] = 0.f;
            for (int j = base + lane; j < hi; j += 32) {
                a0[j] = 0.f;
                valid[j] = 0.f;
            }
            __syncwarp();
            break;
        }
        // V = Lbi W^T, then the new rows [-V Linv | Lbi]
        for (int i = lane; i < base; i += 32)
            for (int s = 0; s < GS; ++s) {
                float acc = 0.f;
                for (int s2 = 0; s2 <= s; ++s2)
                    acc = fmaf(Lbi[s * GS + s2], W[i * GP + s2], acc);
                V[s * A + i] = acc;
            }
        __syncwarp();
        for (int j = lane; j < hi; j += 32)
            for (int s = 0; s < GS; ++s) {
                float val;
                if (j < base) {
                    float acc = 0.f;
                    for (int i = 0; i < base; ++i)
                        acc = fmaf(V[s * A + i], L[i * la + j], acc);
                    val = -acc;
                } else {
                    const int s2 = j - base;
                    val = s2 <= s ? Lbi[s * GS + s2] : 0.f;
                }
                L[(base + s) * la + j] = val;
            }
        if (lane == 0) gids[t] = bg;
        __syncwarp();

        // --- solve + 2 refinement rounds; r for the next selection
        refined_solve(x, dsel, ps, L, la, a0, hi, p, gam, y, v, r, lane);
        nsel = t + 1;
    }

    const float err = refined_solve(x, dsel, ps, L, la, a0, nsel * GS, p,
                                    gam, y, v, r, lane);
    for (int j = lane; j < A; j += 32)
        gam_out[n * A + j] = gam[j] * valid[j];
    for (int j = lane; j < T; j += 32) gidx_out[n * T + j] = gids[j];
    if (lane == 0) {
        err_out[n] = err;
        nsel_out[n] = nsel;
    }
}

template <int GS>
cudaError_t launch(const float* X, const float* Dp, const float* A0,
                   const float* Gp, int p, int ng, int N, int T, int warps,
                   float* gam, int* gidx, float* err, int* nsel,
                   cudaStream_t stream) {
    const size_t smem = lane_floats(p, GS, T) * sizeof(float) * warps;
    cudaError_t e = cudaFuncSetAttribute(
        group_omp_kernel<GS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    const unsigned blocks = (unsigned)((N + warps - 1) / warps);
    group_omp_kernel<GS><<<blocks, 32 * warps, smem, stream>>>(
        X, Dp, A0, Gp, p, ng, N, T, gam, gidx, err, nsel);
    return cudaGetLastError();
}

}  // namespace

// X (p, N) and Dp (p, ng*gs) row-major float32, alpha0 = X^T Dp
// (N, ng*gs) and Gp = Dp^T Dp (ng*gs, ng*gs) row-major float32; gamma
// (N, T*gs), gidx (N, T) int32, err, nsel (N,).  1 <= gs <= 8 and
// T*gs <= 32; `warps` lanes per block.  Returns cudaGetLastError() after
// the launch.
extern "C" int lyssa_group_omp(const float* X, const float* Dp,
                               const float* A0, const float* Gp, int p,
                               int ng, int gs, int N, int T, int warps,
                               float* gam, int* gidx, float* err, int* nsel,
                               void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (T < 1 || T * gs > 32) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e;
#define LYSSA_GROUP_CASE(G_)                                                 \
    case G_:                                                                 \
        e = launch<G_>(X, Dp, A0, Gp, p, ng, N, T, warps, gam, gidx, err,    \
                       nsel, s);                                             \
        break;
    switch (gs) {
        LYSSA_GROUP_CASE(1)
        LYSSA_GROUP_CASE(2)
        LYSSA_GROUP_CASE(3)
        LYSSA_GROUP_CASE(4)
        LYSSA_GROUP_CASE(5)
        LYSSA_GROUP_CASE(6)
        LYSSA_GROUP_CASE(7)
        LYSSA_GROUP_CASE(8)
        default: e = cudaErrorInvalidValue;
    }
#undef LYSSA_GROUP_CASE
    return static_cast<int>(e);
}
