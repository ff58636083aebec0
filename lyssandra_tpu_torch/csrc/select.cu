// Fused selection: k_n = the lowest index among the maxima of |r_n . d_k|
// over the atoms k, for every row n of r, without writing the (N, K)
// correlation to memory.
//
// Replaces lyssandra_tpu/ops/pallas_select.py::_kernel (K7), the OMP
// selection step behind greedy._omp_impl(fused_select=True).
//
// r (N, p) and D (p, K), both row-major float32; k_out (N,) int32.  Two
// modes, two kernels:
//
// float32 (the default).  What bounds it on an H100: the operations,
// 2 N p K flops (3.4e10 at N=262,144, p=64, K=1024: 0.51 ms at the
// 67 TFLOP/s float32 peak outside the tensor cores, against 68 MB of r read
// once, 0.020 ms at 3.35 TB/s).  So the design feeds the fma units: a block
// keeps its BM rows of r in shared memory (transposed, read once) and walks
// all K in tiles of 128 atoms; D's slices of 32 rows arrive by cp.async
// into two buffers (csrc/gemm_tile.cuh's stage_tile and pipeline), so the
// next slice's copy overlaps this slice's fmas.  Each thread keeps an 8 x 8
// register tile, and a warp spans 4 x 8 threads (Tile's WX = 8), so that a
// warp-wide 16-byte read of D's slice covers 128 contiguous bytes, one
// shared-memory wavefront: one 16-byte load of r and one of D per 32 fmas,
// with no bank conflicts.  BM = 128 rows (256 threads) while p, rounded up
// to 32, is at most 256, else 64 (128 threads), so that p = 512 fits.
// The same kernel serves the residual-form OMP's selection
// (lyssa_select_rows, csrc/omp_residual.cu): it reads the rows of r through
// a list whose length lives on the device, and splits the atoms over a
// second grid dimension, each block writing a partial maximum, so that a
// few hundred running rows still fill the card.
//
// bfloat16 (bf16 != 0): both operands rounded to bfloat16 (round to nearest
// even) and the products summed in float32 on the tensor cores (mma.sync
// m16n8k16, bf16 inputs, float32 accumulators, fed by ldmatrix); only the
// order and rounding of the sums differ from the plain version
// r.bfloat16().float() @ D.bfloat16().float().  The operations would take
// 0.035 ms at the 989 TFLOP/s bf16 peak and r's bytes 0.020 ms.  A first
// small kernel writes D^T rounded to bf16, p zero-filled to a multiple of
// 16 (Dh (K, pp), 128 KB at the bench shape), which the products read as
// their column operand.  At p = 64 a product is only 4 mma steps deep, so
// the abs/compare epilogue over the (N, K) outputs, three instructions an
// output on the integer/compare units (compare, max, select of the index),
// takes more issue slots than the products: what bounds the kernel is how
// well the epilogue of some warps overlaps the products of others.
//   * D resident (p up to 64 and D fits shared memory, as at the bench
//     shape): a block loads all of Dh once, then its 8 warps run with no
//     barrier, each taking 32 rows of r at a time (persistent, one block
//     an SM), holding their fragments in registers for the whole walk over
//     K and loading the next 32 rows during it.  The warps drift apart, so
//     one warp's epilogue overlaps another's products.
//   * D streamed (any other shape): a block of 8 warps keeps 128 rows of r
//     in shared memory as bf16 and walks all K in tiles of 128 atoms, p in
//     chunks of up to 64, three chunks in flight by cp.async; a warp owns
//     32 rows x 64 atoms of each tile (2 x 8 mma tiles).  Each block starts
//     its walk at its own atom tile, so that the blocks in flight read
//     different tiles of Dh from L2.  Its barrier a tile keeps the warps of
//     a block in step, products then epilogue, which is why the resident
//     kernel is about twice as fast at the bench shape (PERF.md).
// Rows of every staged tile are padded by 16 bytes, so ldmatrix's eight
// 16-byte rows fall in distinct shared-memory banks.
//
// Both modes: after each atom tile a thread folds |acc| into a running
// (best, index) per row, atoms rising within the thread and a strict >, so
// the first maximum stays; threads that share rows then combine with
// shuffles, and the two warps that share rows through shared memory,
// taking the lower index on equal values.  Shapes need no padding: rows
// past N, p and K are zero-filled or masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "gemm_tile.cuh"
#include "smem_opt_in.cuh"

namespace {

// Fold one atom's |corr| into a row's running maximum: a strict >, so the
// first of equal maxima stays (atoms come in rising order).
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

namespace f32 {

constexpr int BN = 128;     // atoms per tile
constexpr int BP = 32;      // rows of D per staged slice
constexpr int NSTAGE = 2;   // slices in the ring
constexpr int TM = 8, TN = 8, WX = 8;

__host__ __device__ inline int padded_p(int p) {
    return (p + BP - 1) / BP * BP;
}

__host__ __device__ inline int rows(int p) {
    return padded_p(p) <= 256 ? 128 : 64;
}

__host__ __device__ inline size_t smem_bytes(int p) {
    return sizeof(float) * ((size_t)padded_p(p) * (rows(p) + 4) +
                            (size_t)NSTAGE * BP * BN);
}

// LISTED (the residual-form OMP's selection, csrc/omp_residual.cu): row
// n < *count of the problem is row rows[n] of r, blocks past *count leave
// at once, and block (x, y) walks only the atom tiles y * tiles .. of its
// rows, writing its partial maximum (value and index) to row y of
// best_out and k_out (N apart); the caller combines the partials.
template <int BM, bool LISTED>
__global__ void __launch_bounds__(BM * BN / (TM * TN), 2)
select_kernel(const float* __restrict__ r, const int* __restrict__ rows,
              const int* __restrict__ count, const float* __restrict__ D,
              int p, int K, int N, int tiles, int* __restrict__ k_out,
              float* __restrict__ best_out) {
    using Tl = lyssa::Tile<BM, BN, TM, TN, WX>;
    constexpr int NT = Tl::NT;
    constexpr int LDA = BM + 4;   // row stride of the transposed r tile
    static_assert(Tl::TX / WX == 2, "two warps share each row");
    extern __shared__ __align__(16) float smem[];
    const int pp = padded_p(p);
    float* As = smem;                       // (pp, LDA): As[c][m] = r[n0+m][c]
    float* Bs = smem + (size_t)pp * LDA;    // (NSTAGE, BP, BN)
    const int tid = threadIdx.x;
    const int tx = Tl::tx_of(tid);
    const int ty = Tl::ty_of(tid);
    const long long n0 = (long long)blockIdx.x * BM;
    int n_rows = N;      // rows of the problem
    if constexpr (LISTED) {
        n_rows = *count;
        if (n0 >= n_rows) return;           // block-uniform
    }

    // the block's rows of r, read once (coalesced along p), zero past N, p
#pragma unroll 4
    for (int e = tid; e < BM * pp; e += NT) {
        const int m = e / pp;
        const int c = e - m * pp;
        const long long n = n0 + m;
        if constexpr (LISTED)
            As[c * LDA + m] = (n < n_rows && c < p)
                                  ? r[(long long)rows[n] * p + c] : 0.f;
        else
            As[c * LDA + m] = (n < N && c < p) ? r[n * p + c] : 0.f;
    }

    float best[TM];
    int bidx[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        best[i] = -1.f;
        bidx[i] = 0;
    }
    float acc[TM][TN];
    const int nc = pp / BP;                 // slices per atom tile
    int nk = (K + BN - 1) / BN;             // the block's atom tiles
    int kt0 = 0;                            // and its first
    if constexpr (LISTED) {
        kt0 = blockIdx.y * tiles;
        nk = min(nk - kt0, tiles);
    }
    const bool vec = (K & 3) == 0 && ((size_t)D & 15) == 0;

    lyssa::pipeline<NSTAGE>(
        nk * nc,
        [&](int s, int buf) {
            const int kt = s / nc;
            lyssa::stage_tile<BP, BN, NT>(Bs + buf * BP * BN, D, p, K,
                                          (s - kt * nc) * BP,
                                          (long long)(kt0 + kt) * BN, vec);
        },
        [&](int s, int buf) {
            const int kt = s / nc;
            const int cs = s - kt * nc;
            if (cs == 0) {
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
            }
            Tl::template mma<BP>(acc, As + cs * BP * LDA, LDA,
                                 Bs + buf * BP * BN, BN, ty, tx);
            if (cs == nc - 1) {
                const int k0 = (kt0 + kt) * BN;
                if (k0 + BN <= K) {
#pragma unroll
                    for (int j = 0; j < TN; ++j)
#pragma unroll
                        for (int i = 0; i < TM; ++i)
                            fold(acc[i][j], k0 + Tl::col(tx, j), best[i],
                                 bidx[i]);
                } else {
#pragma unroll
                    for (int j = 0; j < TN; ++j) {
                        const int k = k0 + Tl::col(tx, j);
                        if (k < K) {
#pragma unroll
                            for (int i = 0; i < TM; ++i)
                                fold(acc[i][j], k, best[i], bidx[i]);
                        }
                    }
                }
            }
        });

    // the 8 threads of a row group in a warp: lanes that differ in bits 0-2
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int m = 1; m < WX; m <<= 1)
            combine(__shfl_xor_sync(0xffffffffu, best[i], m),
                    __shfl_xor_sync(0xffffffffu, bidx[i], m), best[i],
                    bidx[i]);
    }
    // then the two warps of a row group, through shared memory (the
    // pipeline's last barrier freed it)
    float* xb = smem;
    int* xi = reinterpret_cast<int*>(smem + BM);
    const bool lead = tid % WX == 0;
    if (lead && tx >= WX) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            xb[Tl::row(ty, i)] = best[i];
            xi[Tl::row(ty, i)] = bidx[i];
        }
    }
    __syncthreads();
    if (lead && tx < WX) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int m = Tl::row(ty, i);
            combine(xb[m], xi[m], best[i], bidx[i]);
            if constexpr (LISTED) {
                if (n0 + m < n_rows) {
                    const size_t o = (size_t)blockIdx.y * N + n0 + m;
                    k_out[o] = bidx[i];
                    best_out[o] = best[i];
                }
            } else if (n0 + m < N) {
                k_out[n0 + m] = bidx[i];
            }
        }
    }
}

template <int BM>
cudaError_t launch(const float* r, const float* D, int p, int K, int N,
                   int* k_out, cudaStream_t stream) {
    const size_t smem = smem_bytes(p);
    const cudaError_t e =
        lyssa::opt_in_smem<select_kernel<BM, false>>(smem);
    if (e != cudaSuccess) return e;
    const unsigned blocks = (unsigned)((N + BM - 1) / BM);
    select_kernel<BM, false><<<blocks, BM * BN / (TM * TN), smem, stream>>>(
        r, nullptr, nullptr, D, p, K, N, 0, k_out, nullptr);
    return cudaGetLastError();
}

template <int BM>
cudaError_t launch_rows(const float* r, const int* rows, const int* count,
                        const float* D, int p, int K, int N, int splits,
                        int tiles, int* k_out, float* best_out,
                        cudaStream_t stream) {
    const size_t smem = smem_bytes(p);
    const cudaError_t e = lyssa::opt_in_smem<select_kernel<BM, true>>(smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((unsigned)((N + BM - 1) / BM), (unsigned)splits);
    select_kernel<BM, true><<<grid, BM * BN / (TM * TN), smem, stream>>>(
        r, rows, count, D, p, K, N, tiles, k_out, best_out);
    return cudaGetLastError();
}

}  // namespace f32

namespace bf {

constexpr int BM = 128;      // rows of r per block
constexpr int NI = 8;        // n8 mma tiles a warp
constexpr int WN = 8 * NI;   // atoms a warp (64)
constexpr int BN = 2 * WN;   // atoms per tile: two warps along the atoms
constexpr int CK = 64;       // most of p a staged chunk holds
constexpr int NSTAGE = 3;    // chunks in the ring
constexpr int THREADS = 2 * BM;  // warps: BM / 32 along the rows x 2 along
                                 // the atoms
constexpr int MIN_BLOCKS = BM <= 128 ? 2 : 1;
constexpr int MI = 2;        // m16 tiles a warp (32 rows)

__host__ __device__ inline int padded_p(int p) { return (p + 15) / 16 * 16; }

__host__ __device__ inline int chunk(int pp) { return pp < CK ? pp : CK; }

__host__ __device__ inline size_t smem_bytes(int p) {
    const int pp = padded_p(p);
    return sizeof(__nv_bfloat16) * ((size_t)BM * (pp + 8) +
                                    (size_t)NSTAGE * BN * (chunk(pp) + 8));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
        : "r"(s));
}

// d += a b for a 16 x 16 bf16 tile a (row-major fragment), a 16 x 8 bf16
// tile b (column-major fragment), float32 d
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Dh[n][c] = bf16(D[c][n]) for c < p, 0 for p <= c < pp: a 32 x 32 tile
// transposed through shared memory, reads and writes coalesced.
__global__ void __launch_bounds__(256)
convert_kernel(const float* __restrict__ D, int p, int K, int pp,
               __nv_bfloat16* __restrict__ Dh) {
    __shared__ float t[32][33];
    const int c0 = blockIdx.y * 32;
    const int n0 = blockIdx.x * 32;
    for (int y = threadIdx.y; y < 32; y += 8) {
        const int c = c0 + y;
        const int n = n0 + threadIdx.x;
        t[y][threadIdx.x] = (c < p && n < K) ? D[(size_t)c * K + n] : 0.f;
    }
    __syncthreads();
    for (int y = threadIdx.y; y < 32; y += 8) {
        const int n = n0 + y;
        const int c = c0 + threadIdx.x;
        if (n < K && c < pp)
            Dh[(size_t)n * pp + c] = __float2bfloat16_rn(t[threadIdx.x][y]);
    }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
select_kernel(const float* __restrict__ r,
              const __nv_bfloat16* __restrict__ Dh, int p, int K, int N,
              int* __restrict__ k_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int pp = padded_p(p);
    const int ck = chunk(pp);
    const int lda = pp + 8;                  // bf16, 16 bytes of padding
    const int ldb = ck + 8;
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (BM, lda)
    __nv_bfloat16* Bs = As + (size_t)BM * lda;   // (NSTAGE, BN, ldb)
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int wm = (tid >> 5) >> 1;          // warp row: rows 32 wm ..
    const int wn = (tid >> 5) & 1;           // warp column: atoms WN wn ..
    const int g = lane >> 2;                 // fragment row
    const int t = lane & 3;                  // fragment column pair
    const long long n0 = (long long)blockIdx.x * BM;

    // the block's rows of r, rounded to bf16 as they are staged (coalesced
    // along p), zero past N and p
    if (pp == p && ((size_t)r & 15) == 0) {
        const int q4 = pp / 4;
#pragma unroll 4
        for (int e = tid; e < BM * q4; e += THREADS) {
            const int m = e / q4;
            const int c = 4 * (e - m * q4);
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (n0 + m < N)
                v = *reinterpret_cast<const float4*>(r + (n0 + m) * p + c);
            __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
            __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
            uint2 u;
            u.x = *reinterpret_cast<uint32_t*>(&lo);
            u.y = *reinterpret_cast<uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(As + (size_t)m * lda + c) = u;
        }
    } else {
        const int q2 = pp / 2;
#pragma unroll 4
        for (int e = tid; e < BM * q2; e += THREADS) {
            const int m = e / q2;
            const int c = 2 * (e - m * q2);
            const long long n = n0 + m;
            float v0 = 0.f, v1 = 0.f;
            if (n < N) {
                if (c < p) v0 = r[n * p + c];
                if (c + 1 < p) v1 = r[n * p + c + 1];
            }
            *reinterpret_cast<__nv_bfloat162*>(As + (size_t)m * lda + c) =
                __floats2bfloat162_rn(v0, v1);
        }
    }

    // running maxima of the tiles walked so far.  Each block starts its walk
    // at atom tile kt0 = blockIdx.x mod nk, so that the blocks in flight
    // read different tiles of Dh from L2 rather than all the same one; the
    // maxima of tiles kt0 .. nk - 1 move to (hbest, hidx) when the walk
    // wraps to tile 0, and every index they hold is above those found after
    float best[MI][2], hbest[MI][2];
    int bidx[MI][2], hidx[MI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            best[mi][h] = hbest[mi][h] = -1.f;
            bidx[mi][h] = hidx[mi][h] = 0;
        }
    float acc[MI][NI][4];
    const int nc = (pp + ck - 1) / ck;       // chunks per atom tile
    const int nk = (K + BN - 1) / BN;
    const int kt0 = (int)(blockIdx.x % nk);
    auto tile_of = [&](int s) {              // the atom tile of step s
        const int kt = s / nc + kt0;
        return kt < nk ? kt : kt - nk;
    };

    // ldmatrix row addresses: r rows 32 wm + 16 mi + (lane & 15), columns
    // + 8 (lane >> 4); atoms WN wn + 16 nj + (lane & 7) + 8 (lane >> 4),
    // columns + 8 ((lane >> 3) & 1)
    const __nv_bfloat16* a_row =
        As + (size_t)(wm * 32 + (lane & 15)) * lda + (lane >> 4) * 8;
    const int b_off =
        (wn * WN + (lane & 7) + ((lane >> 4) << 3)) * ldb +
        ((lane >> 3) & 1) * 8;

    lyssa::pipeline<NSTAGE>(
        nk * nc,
        [&](int s, int buf) {
            const int kt = tile_of(s);
            const int c0 = (s % nc) * ck;
            const int pieces = min(ck, pp - c0) / 8;   // 16-byte copies a row
            __nv_bfloat16* dst = Bs + (size_t)buf * BN * ldb;
            for (int e = tid; e < BN * pieces; e += THREADS) {
                const int n = e / pieces;
                const int q = e - n * pieces;
                const long long k = (long long)kt * BN + n;
                const bool in = k < K;
                lyssa::cp_async16(dst + n * ldb + q * 8,
                                  in ? Dh + k * pp + c0 + q * 8 : Dh,
                                  in ? 16 : 0);
            }
        },
        [&](int s, int buf) {
            const int kt = tile_of(s);
            const int cs = s % nc;
            const int c0 = cs * ck;
            const int len = min(ck, pp - c0);
            if (cs == 0) {
#pragma unroll
                for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
                        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
                if (kt == 0 && kt0 > 0) {
#pragma unroll
                    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            hbest[mi][h] = best[mi][h];
                            hidx[mi][h] = bidx[mi][h];
                            best[mi][h] = -1.f;
                        }
                }
            }
            const __nv_bfloat16* Bb = Bs + (size_t)buf * BN * ldb + b_off;
#pragma unroll
            for (int kk = 0; kk < CK / 16; ++kk) {
                if (kk * 16 >= len) break;
                uint32_t a[MI][4];
                uint32_t b[NI][2];
#pragma unroll
                for (int mi = 0; mi < MI; ++mi)
                    ldmatrix_x4(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                                a_row + (size_t)mi * 16 * lda + c0 + kk * 16);
#pragma unroll
                for (int nj = 0; nj < NI / 2; ++nj)
                    ldmatrix_x4(b[2 * nj][0], b[2 * nj][1], b[2 * nj + 1][0],
                                b[2 * nj + 1][1],
                                Bb + (size_t)nj * 16 * ldb + kk * 16);
#pragma unroll
                for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                    for (int ni = 0; ni < NI; ++ni)
                        mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
            }
            if (cs == nc - 1) {
                // thread holds rows g, g + 8 of each m16 tile and atoms
                // kb + 8 ni + e (e = 0, 1) of each n8 tile: rising in
                // (ni, e).  Atoms past K need no mask: Dh is zero there,
                // so they score 0 and, having the highest indices, lose
                // every tie in `combine` to a real atom.
                const int kb = kt * BN + wn * WN + 2 * t;
#pragma unroll
                for (int ni = 0; ni < NI; ++ni)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int k = kb + 8 * ni + e;
#pragma unroll
                        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                            for (int h = 0; h < 2; ++h)
                                fold(acc[mi][ni][2 * h + e], k, best[mi][h],
                                     bidx[mi][h]);
                    }
            }
        });

    // the tiles before the wrap hold the higher atoms: they win only on a
    // strictly larger value
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            if (hbest[mi][h] > best[mi][h]) {
                best[mi][h] = hbest[mi][h];
                bidx[mi][h] = hidx[mi][h];
            }
    // the 4 threads of a fragment row (lanes that differ in bits 0-1)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int m = 1; m < 4; m <<= 1)
                combine(__shfl_xor_sync(0xffffffffu, best[mi][h], m),
                        __shfl_xor_sync(0xffffffffu, bidx[mi][h], m),
                        best[mi][h], bidx[mi][h]);
    // then the two warps of a row block, through shared memory (the
    // pipeline's last barrier freed it)
    float* xb = reinterpret_cast<float*>(smem_raw);
    int* xi = reinterpret_cast<int*>(xb + BM);
    if (t == 0 && wn == 1) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = wm * 32 + mi * 16 + h * 8 + g;
                xb[m] = best[mi][h];
                xi[m] = bidx[mi][h];
            }
    }
    __syncthreads();
    if (t == 0 && wn == 0) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = wm * 32 + mi * 16 + h * 8 + g;
                combine(xb[m], xi[m], best[mi][h], bidx[mi][h]);
                if (n0 + m < N) k_out[n0 + m] = bidx[mi][h];
            }
    }
}

}  // namespace bf

// bf16 with all of D resident in shared memory, where it fits (p up to 64
// and K up to about 1,340 at p=64: the Batch-OMP shape).  The streaming
// kernel above spends most of its time with its warps in step: one barrier
// a tile puts all of a block's warps on the tensor cores at once and then
// all on the compare/select epilogue, and each block waits for its rows
// of r before it starts.  Here a block loads D once, and then its 8 warps
// run on their own, with no barrier: a warp takes 32 rows of r at a time
// (persistent, striding over the row chunks), keeps their mma fragments in
// registers for the whole walk over K, loads the next 32 rows while it
// walks, and covers all K itself, so that its quad of threads finishes
// each row.  The warps drift apart, and one warp's epilogue overlaps
// another's products.
namespace bfr {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int NG = 64;        // atoms a group: 8 n8 mma tiles
constexpr int MI = 2;         // m16 tiles: 32 rows a warp
constexpr int NI = NG / 8;
constexpr size_t kSmemOptin = 232448;

__host__ __device__ inline int k_padded(int K) {
    return (K + NG - 1) / NG * NG;
}

__host__ __device__ inline size_t smem_bytes(int p, int K) {
    const int ld = bf::padded_p(p) + 8;
    return sizeof(__nv_bfloat16) *
           ((size_t)k_padded(K) * ld + (size_t)WARPS * 32 * ld);
}

__host__ __device__ inline bool fits(int p, int K) {
    return bf::padded_p(p) <= 64 && smem_bytes(p, K) <= kSmemOptin;
}

template <int KS>  // p rounded up to 16 is 16 KS
__global__ void __launch_bounds__(THREADS, 1)
select_kernel(const float* __restrict__ r,
              const __nv_bfloat16* __restrict__ Dh, int p, int K, int N,
              int* __restrict__ k_out) {
    constexpr int PP = 16 * KS;
    constexpr int LD = PP + 8;    // bf16; 16 bytes of padding a row
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    const int kp = k_padded(K);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    __nv_bfloat16* Aw = Ds + (size_t)kp * LD + warp * 32 * LD;  // (32, LD)

    // all of D once, zero past K (those atoms score 0 and lose every tie)
    for (int e = tid; e < kp * (PP / 8); e += THREADS) {
        const int n = e / (PP / 8);
        const int q = e - n * (PP / 8);
        const bool in = n < K;
        lyssa::cp_async16(Ds + n * LD + q * 8,
                          in ? Dh + (size_t)n * PP + q * 8 : Dh, in ? 16 : 0);
    }
    lyssa::cp_async_commit();

    // a warp's chunk of 32 rows, 16 KS floats a lane: group j of lane l is
    // columns c .. c + 3 of row m, (j 32 + l) 4 = m PP + c
    const int nchunks = (N + 31) / 32;
    const int stride = gridDim.x * WARPS;
    const bool vec = (p & 3) == 0 && ((size_t)r & 15) == 0;
    float4 pre[4 * KS];
    auto load = [&](int ch) {
#pragma unroll
        for (int j = 0; j < 4 * KS; ++j) {
            const int idx = (j * 32 + lane) * 4;
            const int m = idx / PP;
            const int c = idx - m * PP;
            const long long n = (long long)ch * 32 + m;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (ch < nchunks && n < N && c < p) {
                const float* src = r + n * p + c;
                if (vec) {
                    v = *reinterpret_cast<const float4*>(src);
                } else {
                    v.x = src[0];
                    if (c + 1 < p) v.y = src[1];
                    if (c + 2 < p) v.z = src[2];
                    if (c + 3 < p) v.w = src[3];
                }
            }
            pre[j] = v;
        }
    };
    int chunk = blockIdx.x * WARPS + warp;
    load(chunk);
    lyssa::cp_async_wait<0>();
    __syncthreads();   // D is in; from here on the warps run on their own

    for (; chunk < nchunks; chunk += stride) {
        // this chunk's rows, rounded to bf16, into the warp's slice
        __syncwarp();  // the last chunk's fragments are read
#pragma unroll
        for (int j = 0; j < 4 * KS; ++j) {
            const int idx = (j * 32 + lane) * 4;
            const int m = idx / PP;
            const int c = idx - m * PP;
            __nv_bfloat162 lo = __floats2bfloat162_rn(pre[j].x, pre[j].y);
            __nv_bfloat162 hi = __floats2bfloat162_rn(pre[j].z, pre[j].w);
            uint2 u;
            u.x = *reinterpret_cast<uint32_t*>(&lo);
            u.y = *reinterpret_cast<uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(Aw + m * LD + c) = u;
        }
        __syncwarp();
        load(chunk + stride);   // in flight during the walk
        uint32_t a[MI][KS][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
                bf::ldmatrix_x4(a[mi][ks][0], a[mi][ks][1], a[mi][ks][2],
                                a[mi][ks][3],
                                Aw + (mi * 16 + (lane & 15)) * LD + ks * 16 +
                                    (lane >> 4) * 8);
        float best[MI][2];
        int bidx[MI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                best[mi][h] = -1.f;
                bidx[mi][h] = 0;
            }
        const __nv_bfloat16* Db =
            Ds + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
        for (int k0 = 0; k0 < kp; k0 += NG) {
            float acc[MI][NI][4];
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                for (int ni = 0; ni < NI; ++ni)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                uint32_t b[NI][2];
#pragma unroll
                for (int nj = 0; nj < NI / 2; ++nj)
                    bf::ldmatrix_x4(b[2 * nj][0], b[2 * nj][1],
                                    b[2 * nj + 1][0], b[2 * nj + 1][1],
                                    Db + (k0 + nj * 16) * LD + ks * 16);
#pragma unroll
                for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                    for (int ni = 0; ni < NI; ++ni)
                        bf::mma_bf16(acc[mi][ni], a[mi][ks], b[ni][0],
                                     b[ni][1]);
            }
            // atoms k0 + 8 ni + 2 t + e, rising in (ni, e)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int k = k0 + 8 * ni + 2 * t + e;
#pragma unroll
                    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                        for (int h = 0; h < 2; ++h)
                            fold(acc[mi][ni][2 * h + e], k, best[mi][h],
                                 bidx[mi][h]);
                }
        }
        // the 4 threads of a fragment row hold all of K between them
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int m = 1; m < 4; m <<= 1)
                    combine(__shfl_xor_sync(0xffffffffu, best[mi][h], m),
                            __shfl_xor_sync(0xffffffffu, bidx[mi][h], m),
                            best[mi][h], bidx[mi][h]);
                const long long n = (long long)chunk * 32 + mi * 16 + h * 8 + g;
                if (t == 0 && n < N) k_out[n] = bidx[mi][h];
            }
    }
}

template <int KS>
cudaError_t launch(const __nv_bfloat16* Dh, const float* r, int p, int K,
                   int N, int* k_out, cudaStream_t stream) {
    const size_t smem = smem_bytes(p, K);
    cudaError_t e = lyssa::opt_in_smem<select_kernel<KS>>(smem);
    if (e != cudaSuccess) return e;
    // one block an SM (shared memory allows no second); the SM count is
    // read once per device
    constexpr int kMaxDevices = 64;
    static int sm_count[kMaxDevices] = {};
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (sm_count[dev] == 0) {
        e = cudaDeviceGetAttribute(&sm_count[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return e;
    }
    const int sms = sm_count[dev];
    const int chunks = (N + 31) / 32;
    const int want = (chunks + WARPS - 1) / WARPS;
    const int blocks = want < sms ? want : sms;
    select_kernel<KS><<<blocks, THREADS, smem, stream>>>(r, Dh, p, K, N,
                                                         k_out);
    return cudaGetLastError();
}

}  // namespace bfr

namespace bf {

cudaError_t launch(const float* r, const float* D, int p, int K, int N,
                   __nv_bfloat16* Dh, int* k_out, cudaStream_t stream) {
    const int pp = padded_p(p);
    const dim3 cgrid((unsigned)((K + 31) / 32), (unsigned)((pp + 31) / 32));
    convert_kernel<<<cgrid, dim3(32, 8), 0, stream>>>(D, p, K, pp, Dh);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (bfr::fits(p, K)) {
        switch (pp / 16) {
            case 1: return bfr::launch<1>(Dh, r, p, K, N, k_out, stream);
            case 2: return bfr::launch<2>(Dh, r, p, K, N, k_out, stream);
            case 3: return bfr::launch<3>(Dh, r, p, K, N, k_out, stream);
            default: return bfr::launch<4>(Dh, r, p, K, N, k_out, stream);
        }
    }
    const size_t smem = smem_bytes(p);
    e = lyssa::opt_in_smem<select_kernel>(smem);
    if (e != cudaSuccess) return e;
    const unsigned blocks = (unsigned)((N + BM - 1) / BM);
    select_kernel<<<blocks, THREADS, smem, stream>>>(r, Dh, p, K, N, k_out);
    return cudaGetLastError();
}

}  // namespace bf

}  // namespace

// The dynamic shared memory one block of the kernel the mode takes at
// signal length p over K atoms uses (what ops/cuda_select.py::smem_bytes
// must agree with).
extern "C" size_t lyssa_select_smem_bytes(int p, int K, int bf16) {
    if (!bf16) return f32::smem_bytes(p);
    return bfr::fits(p, K) ? bfr::smem_bytes(p, K) : bf::smem_bytes(p);
}

// r (N, p) and D (p, K) row-major float32; k_out (N,) int32.  bf16 != 0
// rounds both operands to bfloat16 and takes the products on the tensor
// cores; it needs Dh, scratch for K * (p rounded up to 16) bf16 values (null
// in the float32 mode).  Returns cudaGetLastError() after the launches.
extern "C" int lyssa_select_abs_argmax(const float* r, const float* D, int p,
                                       int K, int N, int bf16, void* Dh,
                                       int* k_out, void* stream) {
    if (p < 1 || p > 512 || K < 1 || N < 1 || (bf16 && Dh == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    if (bf16)
        e = bf::launch(r, D, p, K, N, static_cast<__nv_bfloat16*>(Dh), k_out,
                       s);
    else if (f32::rows(p) == 128)
        e = f32::launch<128>(r, D, p, K, N, k_out, s);
    else
        e = f32::launch<64>(r, D, p, K, N, k_out, s);
    return static_cast<int>(e);
}

// The float32 selection over a list of rows, the atoms split over blocks
// (the residual-form OMP's step, csrc/omp_residual.cu): for n < *count
// (count on the device, at most N), the row rows[n] of r (at least
// max(rows) + 1 rows of p floats) against D (p, K); the atoms in `splits`
// ranges of `tiles` tiles of 128 (the last one shorter), one block row
// each.  Writes split y's first maximum of |r . d_k| for row n, its index
// and value, to k_out[y * N + n] and best_out[y * N + n] (k_out and
// best_out hold splits * N entries).  Returns cudaGetLastError() after the
// launch.
extern "C" int lyssa_select_rows(const float* r, const int* rows,
                                 const int* count, const float* D, int p,
                                 int K, int N, int splits, int tiles,
                                 int* k_out, float* best_out, void* stream) {
    const int nk = (K + f32::BN - 1) / f32::BN;
    if (p < 1 || p > 512 || K < 1 || N < 1 || splits < 1 || tiles < 1 ||
        (long long)splits * tiles < nk || (splits - 1) * tiles >= nk)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t e =
        f32::rows(p) == 128
            ? f32::launch_rows<128>(r, rows, count, D, p, K, N, splits,
                                    tiles, k_out, best_out, s)
            : f32::launch_rows<64>(r, rows, count, D, p, K, N, splits,
                                   tiles, k_out, best_out, s);
    return static_cast<int>(e);
}
