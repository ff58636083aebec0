// The online learner's atom sweep in one launch: n_sweeps Gauss-Seidel
// passes of block-coordinate descent over the atoms k = 0..K-1 in order,
//     u = d_k + (b_k - D a_k) / A_kk,   d_k <- u / max(||u||, 1),
// each atom seeing the atoms updated before it; an atom with A_kk < 1e-10
// (no use yet) keeps its value.  D (p, K), A (K, K), B (p, K), float32.
//
// Replaces no Pallas kernel.  The JAX package runs this sweep as a lax.scan
// (lyssandra_tpu/dict_learning/online.py::_dict_update_body); the port's
// plain version (ops/cuda_online_sweep.py::online_sweep_reference) makes
// about 8 small launches an atom, about 8,200 a sweep at K=1,024, and the
// device waits while the host queues them.
//
// What bounds it on an H100: latency, not flops or bytes.  A sweep is a
// chain of K dependent steps, each a (p x K) matrix-vector product and a
// norm over p (at p=192, K=1,024: 0.4 GFLOP a sweep, 6 us at the float32
// peak).  The design keeps D on chip and puts one cross-SM step in each
// atom.  One cluster of c CTAs splits D's rows: CTA i holds rows
// [i r, (i + 1) r), r = ceil(p / c), of every atom in shared memory, so
// atom k reads only the CTA's own rows and D's rows are never exchanged.
// Per atom, each warp forms D a_k for its rows (lanes stride over K in
// float4 columns), the lane that owns column k's float4 forms u for them
// and the partial ||u||^2; every warp writes its partial into every CTA's
// distributed shared memory, in a slot chosen by the parity of the cluster
// barriers passed, so that one barrier.cluster (arrive.release /
// wait.acquire) an atom is enough; then every warp sums the c x W partials
// in one fixed order, the same in every CTA, and the owner lane scales and
// stores d_k.  The owner lane is also the lane that reads column k in the
// next atoms' products, so the store needs no barrier of its own.  Column
// k of A is read as row k of a transposed copy A^T (made by the caller),
// contiguous, and fetched with cp.async while the atom before it computes,
// with the CTA's entries of B's column; the barrier of that atom makes
// them visible.  A is not assumed symmetric.  D is written out once, after
// the last sweep, into a new array.
//
// Measured on an H100 at config 4 (clusters of 16, 12 rows a CTA): about
// 4,500 cycles an atom, 2.3-2.4 ms a sweep.  The products take about 1,000
// (80 KB of shared-memory reads a CTA an atom: the rows and each warp's copy
// of the column), the cluster barrier about 1,100, the reductions and the
// owner lane's divisions the rest.  Overlapping the barrier with the next
// atom's products, plain loads in place of cp.async, and 12, 16 or 32 warps
// a CTA were each slower or within 4% (PERF.md, section 6).
#include <cuda_runtime.h>
#include <stddef.h>

#include "smem_opt_in.cuh"
#include "warp_reduce.cuh"

namespace {

using lyssa::FULL;
using lyssa::warp_sum;

constexpr int MAXW = 8;   // warps a CTA at most
constexpr int RG = 4;     // rows a warp accumulates at once

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// warps a CTA of r rows: one a row up to MAXW
__host__ __device__ inline int sweep_warps(int r) {
    return r < 1 ? 1 : (r < MAXW ? r : MAXW);
}

// 4-byte words of shared memory a CTA of r rows needs (smem_bytes / 4 in
// ops/cuda_online_sweep.py): its rows of D at a row stride of pad4(K); two
// buffers of A's column (pad4(K) each) and of B's entries (pad4(r) each);
// two slots of the cluster's c x W partials
__host__ __device__ inline size_t sweep_floats(int r, int K, int c) {
    return (size_t)r * pad4(K) + 2 * (size_t)pad4(K) + 2 * (size_t)pad4(r) +
           2 * (size_t)c * sweep_warps(r);
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

// every thread of every CTA of the cluster; orders each one's earlier
// writes (its own, remote and cp.async ones once waited for) before every
// later read
__device__ __forceinline__ void cluster_barrier() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

// store v at the address of `local` in the shared memory of CTA `rank` of
// the cluster
__device__ __forceinline__ void st_cluster(float* local, unsigned rank,
                                           float v) {
    unsigned remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(smem_addr(local)), "r"(rank));
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
                 : "memory");
}

// One cluster of c = gridDim.x CTAs of 32 W threads; CTA i owns rows
// [i r, min((i + 1) r, p)).
__global__ void __launch_bounds__(32 * MAXW)
    online_sweep_kernel(const float* __restrict__ D,
                        const float* __restrict__ AT,
                        const float* __restrict__ B, float* __restrict__ Dout,
                        int p, int K, int r, int n_sweeps) {
    extern __shared__ float4 smem4[];
    const int Kp = pad4(K), rp = pad4(r);
    const int c = gridDim.x;
    const int W = blockDim.x >> 5;
    float* const Ds = reinterpret_cast<float*>(smem4);   // r x Kp
    float* const abuf = Ds + (size_t)r * Kp;              // 2 x Kp
    float* const bbuf = abuf + 2 * (size_t)Kp;            // 2 x rp
    float* const part = bbuf + 2 * (size_t)rp;            // 2 x c x W
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const unsigned cr = cluster_rank();
    const int r0 = (int)cr * r;
    const int nr = max(0, min(r, p - r0));

    for (size_t e = tid; e < (size_t)nr * Kp; e += blockDim.x) {
        const int i = (int)(e / Kp), j = (int)(e % Kp);
        Ds[e] = j < K ? D[(size_t)(r0 + i) * K + j] : 0.f;
    }
    for (int j = K + tid; j < Kp; j += blockDim.x) {
        abuf[j] = 0.f;
        abuf[Kp + j] = 0.f;
    }

    // column k of A (row k of A^T) and the CTA's entries of B's column k
    // into buffer `buf`
    auto fetch = [&](int k, int buf) {
        const float* src = AT + (size_t)k * K;
        float* dst = abuf + (size_t)buf * Kp;
        if ((K & 3) == 0) {
            for (int q = tid; q < (K >> 2); q += blockDim.x)
                cp_async16(dst + 4 * q, src + 4 * q);
        } else {
            for (int j = tid; j < K; j += blockDim.x)
                cp_async4(dst + j, src + j);
        }
        for (int i = tid; i < nr; i += blockDim.x)
            cp_async4(bbuf + (size_t)buf * rp + i,
                      B + (size_t)(r0 + i) * K + k);
        cp_async_commit();
    };

    const long total = (long)n_sweeps * K;   // atom steps in all
    if (total > 0) fetch(0, 0);
    cp_async_wait_all();
    cluster_barrier();   // every CTA runs, and the first column is in

    int ph = 0;          // cluster barriers of the loop so far
    int k = 0;
    for (long t = 0; t < total; ++t, k = (k + 1 == K ? 0 : k + 1)) {
        const int cur = (int)(t & 1);
        if (t + 1 < total) fetch(k + 1 == K ? 0 : k + 1, cur ^ 1);
        const float* a = abuf + (size_t)cur * Kp;
        const float* b = bbuf + (size_t)cur * rp;
        const float akk = a[k];
        if (akk < 1e-10f) {      // the same in every CTA: the atom stays
            cp_async_wait_all();
            __syncthreads();
            continue;
        }
        // the owner lane of column k: the one whose float4 columns hold it
        const int owner = (k >> 2) & 31;
        float ss = 0.f;          // on the owner: sum of u_i^2, the warp's rows
        const float4* a4 = reinterpret_cast<const float4*>(a);
        for (int i0 = w; i0 < nr; i0 += W * RG) {
            float acc[RG];
#pragma unroll
            for (int g = 0; g < RG; ++g) acc[g] = 0.f;
#pragma unroll 4
            for (int q = lane; q < (Kp >> 2); q += 32) {
                const float4 av = a4[q];
#pragma unroll
                for (int g = 0; g < RG; ++g) {
                    const int i = i0 + g * W;
                    if (i < nr) {
                        const float4 dv = reinterpret_cast<const float4*>(
                            Ds + (size_t)i * Kp)[q];
                        acc[g] = fmaf(dv.x, av.x, acc[g]);
                        acc[g] = fmaf(dv.y, av.y, acc[g]);
                        acc[g] = fmaf(dv.z, av.z, acc[g]);
                        acc[g] = fmaf(dv.w, av.w, acc[g]);
                    }
                }
            }
#pragma unroll
            for (int g = 0; g < RG; ++g) {
                const int i = i0 + g * W;
                if (i < nr) {    // the same on every lane of the warp
                    const float dot = warp_sum(acc[g]);
                    if (lane == owner) {
                        float* dik = Ds + (size_t)i * Kp + k;
                        const float u = *dik + (b[i] - dot) / akk;
                        ss = fmaf(u, u, ss);
                        *dik = u;
                    }
                }
            }
        }
        ss = __shfl_sync(FULL, ss, owner);
        float* const slot = part + (size_t)(ph & 1) * c * W;
        if (lane < c) st_cluster(slot + (size_t)cr * W + w, lane, ss);
        cp_async_wait_all();
        cluster_barrier();
        ++ph;
        if (w < nr) {
            // ||u||^2: lane l sums partials l, l + 32, ... in order, then
            // the butterfly; the same values in the same lanes everywhere
            float s = 0.f;
            for (int j = lane; j < c * W; j += 32) s += slot[j];
            const float den = fmaxf(sqrtf(warp_sum(s)), 1.f);
            if (lane == owner)
                for (int i = w; i < nr; i += W) {
                    float* dik = Ds + (size_t)i * Kp + k;
                    *dik = *dik / den;
                }
        }
    }

    __syncthreads();
    for (size_t e = tid; e < (size_t)nr * K; e += blockDim.x) {
        const int i = (int)(e / K), j = (int)(e % K);
        Dout[(size_t)(r0 + i) * K + j] = Ds[(size_t)i * Kp + j];
    }
    cluster_barrier();   // no CTA leaves while another could reach it
}

cudaError_t allow_cluster_16() {
    constexpr int kMaxDevices = 64;
    static bool done[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (done[dev]) return cudaSuccess;
    e = cudaFuncSetAttribute(online_sweep_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e == cudaSuccess) done[dev] = true;
    return e;
}

}  // namespace

// Bytes of shared memory each CTA takes at p rows, K atoms and a cluster of
// c CTAs.
extern "C" size_t lyssa_online_sweep_smem_bytes(int p, int K, int c) {
    const int r = (p + c - 1) / c;
    return sweep_floats(r, K, c) * sizeof(float);
}

// D (p, K), AT (K, K) = A^T and B (p, K) row-major float32; Dout (p, K)
// receives D after n_sweeps sweeps (D, AT and B are only read).  A cluster
// of c CTAs, c in {2, 4, 8, 16} (16 with the non-portable attribute); K >= 2.
// Returns cudaGetLastError() after the launch.
extern "C" int lyssa_online_sweep(const float* D, const float* AT,
                                  const float* B, float* Dout, int p, int K,
                                  int n_sweeps, int c, void* stream) {
    if (p < 1 || K < 2 || n_sweeps < 0 ||
        (c != 2 && c != 4 && c != 8 && c != 16))
        return static_cast<int>(cudaErrorInvalidValue);
    const int r = (p + c - 1) / c;
    const size_t smem = sweep_floats(r, K, c) * sizeof(float);
    cudaError_t e = lyssa::opt_in_smem<online_sweep_kernel>(smem);
    if (e == cudaSuccess && c > 8) e = allow_cluster_16();
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(c);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(c));
    cfg.blockDim = dim3(32u * static_cast<unsigned>(sweep_warps(r)));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, online_sweep_kernel, D, AT, B, Dout, p, K, r,
                           n_sweeps);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
