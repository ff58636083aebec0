// K-SVD's dense atom sweep at one atom a step (B=1) in one launch: atoms
// k = 0..K-1 in order, each seeing the atoms and the residual left by the
// ones before it.  For atom k, with g its code row, S = {n : g_n != 0} its
// users and d its atom:
//     d' = d (g . gt) + R_S gt_S,   d' <- d' / max(||d'||, 1e-12),
//     gt_S = g_S (d . d') + d'^T R_S,
// from gt = g, n_power times in turn; then R_S += d g_S - d' gt_S, D[:, k]
// = d' and Gamma[k, S] = gt_S.  An atom with no users keeps its atom and
// its row.  R = X - D Gamma is held transposed, Rt (N, p), made by the
// caller; D (p, K), Gamma (K, N), float32.
//
// Replaces no Pallas kernel.  The JAX package runs this sweep as a lax loop
// (lyssandra_tpu/dict_learning/ksvd.py); the port's dense form
// (dict_learning/ksvd.py::_sweep, replayed from a CUDA graph) makes about
// 21 kernels an atom, each over all N columns, about 98% of them zeros at
// config 2 (N=50,000, T=8, K=512: ~780 users an atom).  That dense sweep
// is the kernel's plain version (ops/cuda_ksvd_sweep.py runs it on the
// CPU).
//
// What bounds it on an H100: latency, not bytes or flops.  An atom's work
// is about three passes over its users' rows of Rt (p floats each, ~600 KB
// at config 2, in L2), but atom k + 1 needs what atom k wrote: a chain of K
// dependent steps, each a cross-SM reduction.  One cluster of C CTAs splits
// the N lanes: CTA i owns lanes [i L, (i + 1) L) and warp w of it a segment
// of Lw of them, so a lane's row of Rt is only ever read and written by one
// warp, each float of it by one thread, and needs no barrier.  Per atom and
// power step: each warp sums its users' rows times gt into a partial d'
// (each lane its p / 32 floats), g . gt and its user count; the CTA sums its
// warps' partials in a fixed order and sends the sum, 16 bytes a st.async,
// into every CTA's distributed shared memory, in one of two slots by the
// parity of the step, each counted in bytes on its own mbarrier; the CTA
// sums the C partials in the same order as every other CTA, so that all
// hold the same d' bit for bit; every warp forms d' and d . d' in registers
// and runs its own users: gt by a warp-wide dot product, and in the last
// power step the update of the user's row of Rt and its entry of Gamma out.
// The mbarriers stand in for barrier.cluster, whose release and acquire
// fence global memory (a GPU-wide MEMBAR and an L1 invalidation, which the
// atoms' rows of Rt would pay for); a slot is refilled for step t + 2 only
// after every CTA has sent step t + 1, so after its readers are done.  The
// work off the chain is hidden: code rows and atoms arrive by cp.async NB - 1
// atoms ahead, and between its sends and its wait each warp scans its
// segment of the next code row (ballots into a list of its users; the other
// entries go to Gamma out as they are) and prefetches those users' rows of
// Rt into L1.  Loads are issued in batches before their first use: a load
// used at once stalls its warp for its whole latency.  Every sum runs in a
// fixed order, with no atomics: two launches give the same bits.  D and
// Gamma are only read; D out and Gamma out are written whole.
//
// Measured on an H100 (PERF.md, section 6): 2.3 ms a sweep at config 2
// (about 4.5 us, ~9,000 cycles, an atom) and 1.1-1.3 ms at K=256, N=30,000.
// 16 warps and 16 CTAs were the fastest of 8 and 16 each, and 16 CTAs the
// fastest of 2-16 down to N=130, so both are constants here (which made the
// sweep ~15% faster than with both set at run time).  A barrier.cluster an
// atom (3.3 ms), bulk copies of the code rows with the atom in registers
// (3.0 ms) and batches of 2 users (2.8 ms) were slower, each against 2.7-2.9
// ms with run-time counts.
#include <cuda_runtime.h>
#include <stddef.h>

#include "smem_opt_in.cuh"
#include "warp_reduce.cuh"

namespace {

using lyssa::FULL;
using lyssa::warp_sum;

constexpr int W = 16;     // warps a CTA
constexpr int C = 16;     // CTAs the cluster (the non-portable size)
constexpr int NB = 3;     // code rows and atoms in flight: k .. k + NB - 1
constexpr int UB = 4;     // users whose rows of Rt a warp loads at once
constexpr int SB = 8;     // 32-lane chunks of a code row a warp scans at once

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// lanes a CTA owns: a multiple of 4, C of them cover N
__host__ __device__ inline int cta_lanes(int N) {
    return pad4((N + C - 1) / C);
}

// 4-byte words of shared memory a CTA needs (smem_bytes / 4 in
// ops/cuda_ksvd_sweep.py), with L its lanes, Lw = ceil(L / W) a warp's and
// qp = pad4(p + 2): the two slots' mbarriers (4 words); NB buffers of its
// slice of a code row and of an atom; two slots of the cluster's C
// partials, its own sum and one partial a warp (qp each); each warp's user
// lists, (lane, g) for two atoms and gt for one
__host__ __device__ inline size_t sweep_floats(int p, int N) {
    const int L = cta_lanes(N);
    const int Lw = (L + W - 1) / W;
    const int qp = pad4(p + 2);
    return 4 + NB * ((size_t)L + pad4(p)) + (2 * (size_t)C + 1 + W) * qp +
           5 * (size_t)W * Lw;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// this thread's cp.async groups done but the newest n
template <int n>
__device__ __forceinline__ void cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// every thread of every CTA of the cluster, once at the start and once at
// the end: its release and acquire fence global memory too (a GPU-wide
// fence and an L1 invalidation), so the atom steps signal through
// mbarriers instead
__device__ __forceinline__ void cluster_barrier() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(bar))
                 : "memory");
}

// the one arrival of the mbarrier's phase, which then waits for `bytes`
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
}

// until the mbarrier's phase of this parity is complete
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
    asm volatile(
        "{\n.reg .pred P1;\nLAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

__device__ __forceinline__ unsigned map_rank(const void* local,
                                             unsigned rank) {
    unsigned remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(smem_addr(local)), "r"(rank));
    return remote;
}

// store v at the address of `local` (16-byte aligned) in the shared memory
// of CTA `rank` of the cluster, and count its 16 bytes on that CTA's
// mbarrier at the address of `bar`
__device__ __forceinline__ void st_async4(float* local, unsigned rank,
                                          float4 v, unsigned long long* bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
        "{%1, %2, %3, %4}, [%5];\n" ::"r"(map_rank(local, rank)),
        "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(map_rank(bar, rank))
        : "memory");
}

// One cluster of C CTAs of 32 W threads; CTA i owns lanes
// [i L, min((i + 1) L, N)).  Lane `lane` of a warp holds entries lane + 32 m
// (m < MP) of an atom: p <= 32 MP.
template <int MP>
__global__ void __launch_bounds__(32 * W, 1)
    ksvd_sweep_kernel(const float* __restrict__ D,
                      const float* __restrict__ Gamma, float* Rt,
                      float* __restrict__ Dout, float* __restrict__ Gout,
                      int p, int K, int N, int n_power) {
    extern __shared__ float4 smem4[];
    const int L = cta_lanes(N), Lw = (L + W - 1) / W;
    const int pp = pad4(p), q = p + 2, qp = pad4(q), q4 = qp / 4;
    unsigned long long* const bars =
        reinterpret_cast<unsigned long long*>(smem4);         // 2
    float* const rowbuf = reinterpret_cast<float*>(smem4) + 4;  // NB x L
    float* const dbuf = rowbuf + NB * (size_t)L;              // NB x pp
    float* const slots = dbuf + NB * (size_t)pp;              // 2 x C x qp
    float* const sums = slots + 2 * (size_t)C * qp;           // qp
    float* const part = sums + qp;                            // W x qp
    int* const lidx = reinterpret_cast<int*>(part + (size_t)W * qp);
    float* const lg = reinterpret_cast<float*>(lidx + 2 * (size_t)W * Lw);
    float* const lgt = lg + 2 * (size_t)W * Lw;  // 2 x W x Lw, 2 x, 1 x
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const unsigned cr = cluster_rank();
    const int n0 = (int)cr * L;
    const int nl = max(0, min(L, N - n0));
    // this warp's segment of the CTA's lanes
    const int s0 = min(w * Lw, nl), s1 = min(s0 + Lw, nl);
    float* const mygt = lgt + (size_t)w * Lw;

    // one cp.async group: the CTA's slice of code row k and atom k into
    // buffer k % NB, or nothing past the last atom
    auto fetch = [&](int k) {
        if (k < K) {
            const float* src = Gamma + (size_t)k * N + n0;
            float* dst = rowbuf + (size_t)(k % NB) * L;
            int j0 = 0;          // 16 bytes a copy where src is aligned
            if ((reinterpret_cast<size_t>(src) & 15) == 0) {
                j0 = nl & ~3;
                for (int j = 4 * tid; j < j0; j += 4 * blockDim.x)
                    cp_async16(dst + j, src + j);
            }
            for (int j = j0 + tid; j < nl; j += blockDim.x)
                cp_async4(dst + j, src + j);
            for (int e = tid; e < p; e += blockDim.x)
                cp_async4(dbuf + (size_t)(k % NB) * pp + e,
                          D + (size_t)e * K + k);
        }
        cp_async_commit();
    };

    // the warp's users of atom k, in lane order, into list buffer k & 1;
    // their rows of Rt on their way to L1; the row's other entries to Gamma
    // out as they are.  Returns their count.
    auto scan = [&](int k) -> int {
        const float* row = rowbuf + (size_t)(k % NB) * L;
        int* const idx = lidx + ((size_t)(k & 1) * W + w) * Lw;
        float* const gl = lg + ((size_t)(k & 1) * W + w) * Lw;
        float* const grow = Gout + (size_t)k * N + n0;
        int cnt = 0;
        for (int b = s0; b < s1; b += 32 * SB) {
            float v[SB];
#pragma unroll
            for (int j = 0; j < SB; ++j) {
                const int i = b + 32 * j + lane;
                v[j] = i < s1 ? row[i] : 0.f;
            }
#pragma unroll
            for (int j = 0; j < SB; ++j) {
                const int i = b + 32 * j + lane;
                const bool nz = v[j] != 0.f;
                const unsigned mask = __ballot_sync(FULL, nz);
                if (nz) {
                    const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
                    idx[pos] = i;
                    gl[pos] = v[j];
                    const float* r = Rt + (size_t)(n0 + i) * p;
                    for (int e = 0; e < p; e += 32) prefetch_l1(r + e);
                } else if (i < s1) {
                    grow[i] = v[j];
                }
                cnt += __popc(mask);
            }
        }
        return cnt;
    };

    // the slots' mbarriers, each armed for the first step that uses it
    const unsigned slot_bytes = (unsigned)(C * qp * sizeof(float));
    if (tid == 0) {
        mbar_init(&bars[0]);
        mbar_init(&bars[1]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        mbar_expect(&bars[0], slot_bytes);
        mbar_expect(&bars[1], slot_bytes);
    }
    for (int k = 0; k + 1 < NB; ++k) fetch(k);
    cp_async_wait_all();
    __syncthreads();
    int cnt = scan(0);   // the warp's users of the current atom
    __syncwarp();
    cluster_barrier();   // every CTA and its mbarriers are ready

    int ph = 0;          // power steps so far: the slot is ph & 1
    for (int k = 0; k < K; ++k) {
        // into the buffer whose row was scanned during atom k - 2
        fetch(k + NB - 1);
        const int* const myidx = lidx + ((size_t)(k & 1) * W + w) * Lw;
        const float* const myg = lg + ((size_t)(k & 1) * W + w) * Lw;
        float* const grow = Gout + (size_t)k * N + n0;
        const float* dcol = dbuf + (size_t)(k % NB) * pp;
        float d[MP], dn[MP];
#pragma unroll
        for (int m = 0; m < MP; ++m) {
            const int e = lane + 32 * m;
            d[m] = e < p ? dcol[e] : 0.f;
            dn[m] = d[m];
        }
        int next = 0;    // the warp's users of atom k + 1
        for (int s = 0; s < n_power; ++s) {
            // the warp's partial d' = R_S gt_S, g . gt and user count, UB
            // users' rows in flight at once, summed in user order
            const float* const gts = s == 0 ? myg : mygt;
            float acc[MP];
#pragma unroll
            for (int m = 0; m < MP; ++m) acc[m] = 0.f;
            float a = 0.f;
            for (int u0 = 0; u0 < cnt; u0 += UB) {
                // past the last user, loads repeat user u0 and go unused
                float rv[UB][MP], gv[UB], gtv[UB];
                int iv[UB];
#pragma unroll
                for (int j = 0; j < UB; ++j) {
                    const int u = u0 + j < cnt ? u0 + j : u0;
                    iv[j] = myidx[u];
                    gv[j] = myg[u];
                    gtv[j] = gts[u];
                }
#pragma unroll
                for (int j = 0; j < UB; ++j) {
                    const float* r = Rt + (size_t)(n0 + iv[j]) * p;
#pragma unroll
                    for (int m = 0; m < MP; ++m) {
                        const int e = lane + 32 * m;
                        rv[j][m] = e < p ? r[e] : 0.f;
                    }
                }
#pragma unroll
                for (int j = 0; j < UB; ++j) {
                    if (u0 + j < cnt) {
#pragma unroll
                        for (int m = 0; m < MP; ++m)
                            acc[m] = fmaf(rv[j][m], gtv[j], acc[m]);
                        a = fmaf(gv[j], gtv[j], a);
                    }
                }
            }
            float* const mine = part + (size_t)w * qp;
#pragma unroll
            for (int m = 0; m < MP; ++m) {
                const int e = lane + 32 * m;
                if (e < p) mine[e] = acc[m];
            }
            if (lane == 0) {
                mine[p] = a;
                mine[p + 1] = (float)cnt;
            }
            // code row k + 1 is in: the barrier shows it to every thread
            if (s == 0) cp_async_wait_group<NB - 2>();
            __syncthreads();
            // the CTA's sum, warps in order, into every CTA's slot (all
            // loads first: a load used at once stalls the warp)
            for (int j = tid; j < q; j += blockDim.x) {
                float pv[W];
#pragma unroll
                for (int v = 0; v < W; ++v) pv[v] = part[(size_t)v * qp + j];
                float t = 0.f;
#pragma unroll
                for (int v = 0; v < W; ++v) t += pv[v];
                sums[j] = t;
            }
            __syncthreads();
            const int b = ph & 1;
            float* const slot = slots + (size_t)b * C * qp;
            for (int t = tid; t < q4 * C; t += blockDim.x) {
                const int j4 = t % q4;
                st_async4(slot + (size_t)cr * qp + 4 * j4, (unsigned)(t / q4),
                          reinterpret_cast<const float4*>(sums)[j4], &bars[b]);
            }
            if (s == 0 && k + 1 < K) next = scan(k + 1);
            // every CTA's sum is in: the mbarrier's (ph >> 1)-th phase,
            // which any CTA's step ph + 2 comes after; re-armed for it
            mbar_wait(&bars[b], (unsigned)(ph >> 1) & 1u);
            if (tid == 0) mbar_expect(&bars[b], slot_bytes);
            ++ph;

            // the cluster's sums, CTAs in order: the same bits everywhere
            for (int j4 = tid; j4 < q4; j4 += blockDim.x) {
                float4 sv[C];
                const float4* s4 = reinterpret_cast<const float4*>(slot) + j4;
#pragma unroll
                for (int r = 0; r < C; ++r) sv[r] = s4[(size_t)r * q4];
                float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
                for (int r = 0; r < C; ++r) {
                    t.x += sv[r].x;
                    t.y += sv[r].y;
                    t.z += sv[r].z;
                    t.w += sv[r].w;
                }
                reinterpret_cast<float4*>(sums)[j4] = t;
            }
            __syncthreads();
            if (sums[p + 1] == 0.f) break;     // no users: the atom stays
            const float gg = sums[p];
            float ss = 0.f;
#pragma unroll
            for (int m = 0; m < MP; ++m) {
                const int e = lane + 32 * m;
                if (e < p) {
                    dn[m] = d[m] * gg + sums[e];
                    ss = fmaf(dn[m], dn[m], ss);
                }
            }
            const float den = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
            float dd = 0.f;
#pragma unroll
            for (int m = 0; m < MP; ++m) {
                dn[m] = dn[m] / den;
                dd = fmaf(d[m], dn[m], dd);
            }
            dd = warp_sum(dd);

            // the warp's users: gt = g (d . d') + d'^T R_n; in the last
            // power step the user's row of Rt and its code
            const bool last = s + 1 == n_power;
            for (int u0 = 0; u0 < cnt; u0 += UB) {
                float rv[UB][MP], gv[UB], dot[UB];
                int iv[UB];
#pragma unroll
                for (int j = 0; j < UB; ++j) {
                    const int u = u0 + j < cnt ? u0 + j : u0;
                    iv[j] = myidx[u];
                    gv[j] = myg[u];
                }
#pragma unroll
                for (int j = 0; j < UB; ++j) {
                    const float* r = Rt + (size_t)(n0 + iv[j]) * p;
#pragma unroll
                    for (int m = 0; m < MP; ++m) {
                        const int e = lane + 32 * m;
                        rv[j][m] = e < p ? r[e] : 0.f;
                    }
                }
#pragma unroll
                for (int j = 0; j < UB; ++j) {
                    dot[j] = 0.f;
#pragma unroll
                    for (int m = 0; m < MP; ++m)
                        dot[j] = fmaf(dn[m], rv[j][m], dot[j]);
                }
#pragma unroll
                for (int j = 0; j < UB; ++j) dot[j] = warp_sum(dot[j]);
#pragma unroll
                for (int j = 0; j < UB; ++j) {
                    if (u0 + j < cnt) {
                        const float gt = gv[j] * dd + dot[j];
                        if (last) {
                            float* const r = Rt + (size_t)(n0 + iv[j]) * p;
#pragma unroll
                            for (int m = 0; m < MP; ++m) {
                                const int e = lane + 32 * m;
                                if (e < p)
                                    r[e] = (rv[j][m] + d[m] * gv[j]) -
                                           dn[m] * gt;
                            }
                            if (lane == 0) grow[iv[j]] = gt;
                        } else if (lane == 0) {
                            mygt[u0 + j] = gt;
                        }
                    }
                }
            }
            __syncwarp();
        }
        if (cr == 0 && w == 0) {
#pragma unroll
            for (int m = 0; m < MP; ++m) {
                const int e = lane + 32 * m;
                if (e < p) Dout[(size_t)e * K + k] = dn[m];
            }
        }
        cnt = next;
    }
    cluster_barrier();   // no CTA leaves while another could reach it
}

template <int MP>
cudaError_t allow_cluster_16() {
    constexpr int kMaxDevices = 64;
    static bool done[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (done[dev]) return cudaSuccess;
    e = cudaFuncSetAttribute(ksvd_sweep_kernel<MP>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e == cudaSuccess) done[dev] = true;
    return e;
}

template <int MP>
cudaError_t launch(const float* D, const float* Gamma, float* Rt, float* Dout,
                   float* Gout, int p, int K, int N, int n_power,
                   cudaStream_t stream) {
    const size_t smem = sweep_floats(p, N) * sizeof(float);
    cudaError_t e = lyssa::opt_in_smem<ksvd_sweep_kernel<MP>>(smem);
    if (e == cudaSuccess) e = allow_cluster_16<MP>();
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(C);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(C));
    cfg.blockDim = dim3(32u * static_cast<unsigned>(W));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, ksvd_sweep_kernel<MP>, D, Gamma, Rt, Dout,
                              Gout, p, K, N, n_power);
}

}  // namespace

// Bytes of shared memory each CTA takes at p rows and N lanes.
extern "C" size_t lyssa_ksvd_sweep_smem_bytes(int p, int N) {
    return sweep_floats(p, N) * sizeof(float);
}

// D (p, K) and Gamma (K, N) row-major float32, only read; Rt (N, p) = (X -
// D Gamma)^T, updated in place; Dout (p, K) and Gout (K, N) receive D and
// Gamma after one sweep of n_power power steps an atom.  1 <= p <= 256; one
// cluster of C = 16 CTAs (the non-portable size) of W = 16 warps each.
// Returns cudaGetLastError() after the launch.
extern "C" int lyssa_ksvd_sweep(const float* D, const float* Gamma, float* Rt,
                                float* Dout, float* Gout, int p, int K, int N,
                                int n_power, void* stream) {
    if (p < 1 || p > 256 || K < 1 || N < 1 || n_power < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    if (p <= 32)
        e = launch<1>(D, Gamma, Rt, Dout, Gout, p, K, N, n_power, s);
    else if (p <= 64)
        e = launch<2>(D, Gamma, Rt, Dout, Gout, p, K, N, n_power, s);
    else if (p <= 128)
        e = launch<4>(D, Gamma, Rt, Dout, Gout, p, K, N, n_power, s);
    else
        e = launch<8>(D, Gamma, Rt, Dout, Gout, p, K, N, n_power, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
