// Fused patch pipeline: stride-1 extraction + DC removal + contrast
// normalization + optional whitening, in one pass over the image.
//
// Replaces lyssandra_tpu/ops/pallas_patches.py::_kernel.  For every patch
// position q = (i, j) of an (H, W) image, with v the p x p window at (i, j):
//   mean_q  = mean(v);             v <- v - mean_q       (do_dc)
//   scale_q = max(||v||_2, eps);   v <- v / scale_q      (do_norm)
//   X[:, q] = Wm v - off                                 (whitening, optional)
// Outputs X (p^2, Hp Wp) in the exact shape (no padding), means and scales
// (Hp Wp,) — each returned even when its stage is off.  The mean and the
// centred sum of squares (of v - mean rounded to float32, as the plain
// version computes it) accumulate in double and are rounded once, so the
// statistics do not depend on the summation order.  Never sum v^2 - n mean^2:
// on a flat patch that leaves about 1e-10 of cancellation in the sum of
// squares, which the eps clamp would turn into a scale of about 1e-5.
//
// What bounds it on an H100: memory.  X is p^2 times the image (64 x at
// p=8: 65 MB written for a 512^2 image, 0.020 ms at 3.35 TB/s), while the
// image itself (1 MB) stays in L2.  So the design keeps the writes of X
// coalesced and the rest off the memory system: a block of CB = 256
// threads owns a run of 256 consecutive patches of one patch row, one
// thread a patch, so every row of X is written in contiguous 1 KB pieces
// (4-byte stores: rows of X are Np apart and Np is odd at 512^2), and only
// the two ends of a run share a 32-byte sector with another block.  The
// block stages its p x (256 + p - 1) image tile in shared memory with
// 16-byte loads where the image's rows allow them, and each thread reads
// its window from there.  p = 8, the denoiser's patch size, is compiled
// apart: the thread holds its 64 values in registers, so it reads the tile
// once, the loops unroll, and each double sum runs as four partial sums,
// so that no chain of 64 dependent additions stalls the thread.  Any other
// p reads the window from the tile three times (mean, centred sum of
// squares, write), or from the image when the tile would not fit shared
// memory.
//
// Whitening is a product of Wm (p^2 x p^2, 16 KB at p=8, kept in shared
// memory) with each processed window, 2 p^4 flops a patch: at p=8 and
// 512^2, 2.1 GFLOP, 0.031 ms at the 67 TFLOP/s float32 peak, so above the
// bytes.  At p=8 each thread takes the product from its registers, one
// 16-byte broadcast read of a row of Wm per 4 fmas.  Any other p stages the
// processed window in shared memory (column-interleaved, so the reads are
// free of bank conflicts) with runs of 64 patches, as the window takes p^2
// floats a thread, and reads four rows of Wm (stored transposed) per value
// of the window.  Both take four rows at a time, so that four independent
// chains of fmas are in flight; each row still sums in order over c.
#include <cuda_runtime.h>
#include <stddef.h>

#include "smem_opt_in.cuh"

namespace {

constexpr int CB = 256;         // patches a block: a run of one patch row
constexpr int CB_WHITEN = 64;   // patches a block, whitening at p != 8
constexpr int FAST_P = 8;       // the patch size compiled apart
// dynamic shared memory a block may opt in to on sm_90 (H100, H200)
constexpr size_t kSmemOptin = 232448;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Floats of shared memory before the image tile: Wm, row-major at p = 8;
// for the generic whitening Wm transposed with its rows padded to a
// multiple of 4 (Wt[c][row], so four rows of one column are one 16-byte
// read), then the processed windows of the block's threads.  Both sizes
// are multiples of 4, so the tile stays 16-byte aligned.
__host__ __device__ inline size_t whiten_floats(int p, bool generic,
                                                int threads) {
    const int p2 = p * p;
    return generic ? (size_t)p2 * round4(p2) + (size_t)p2 * threads
                   : (size_t)p2 * p2;
}

// The image tile: p rows of round4(cb + p - 1) floats.
__host__ __device__ inline size_t tile_floats(int p, int cb) {
    return (size_t)p * round4(cb + p - 1);
}

template <int P>  // P > 0: the patch size at compile time; 0: p at run time
__global__ void __launch_bounds__(CB)
fused_patches_kernel(const float* __restrict__ img, int H, int W, int p_rt,
                     int Hp, int Wp, bool do_dc, bool do_norm, float eps,
                     const float* __restrict__ Wm,
                     const float* __restrict__ off, bool use_tile,
                     float* __restrict__ X, float* __restrict__ means,
                     float* __restrict__ scales) {
    extern __shared__ __align__(16) float smem[];
    const int p = P > 0 ? P : p_rt;
    const int p2 = p * p;
    const bool whiten = Wm != nullptr;
    const int cb = blockDim.x;
    const int tid = threadIdx.x;
    const int p2r = round4(p2);
    float* Ws = smem;           // (p2, p2) at P > 0; else Wt (p2, p2r)
    float* vs = smem + (size_t)p2 * p2r;              // (p2, cb), P == 0
    float* tile = smem + (whiten ? whiten_floats(p, P == 0, cb) : 0);
    // blockIdx.x runs over the runs of cb patches, row after patch row
    const int runs = (Wp + cb - 1) / cb;
    const int i = blockIdx.x / runs;
    const int j0 = (blockIdx.x - i * runs) * cb;
    const int ts = round4(cb + p - 1);                // tile row stride

    if (whiten) {
        if (P > 0) {
            for (int e = tid; e < p2 * p2; e += cb) Ws[e] = Wm[e];
        } else {
            for (int e = tid; e < p2 * p2r; e += cb) {
                const int c = e / p2r;
                const int row = e - c * p2r;
                Ws[e] = row < p2 ? Wm[row * p2 + c] : 0.f;
            }
        }
    }
    if (use_tile) {
        // image rows i .. i + p - 1 (all inside the image), columns
        // j0 .. j0 + ts - 1, zero past it; j0 is a multiple of 64, so a row
        // of the tile starts 16-byte aligned in the image when W is a
        // multiple of 4
        const bool vec = (W & 3) == 0 && ((size_t)img & 15) == 0;
        const int q4 = ts / 4;
        for (int e = tid; e < p * q4; e += cb) {
            const int r = e / q4;
            const int c = 4 * (e - r * q4);
            const int gj = j0 + c;
            const float* src = img + (size_t)(i + r) * W + gj;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (vec && gj + 3 < W) {
                v = *reinterpret_cast<const float4*>(src);
            } else {
                if (gj < W) v.x = src[0];
                if (gj + 1 < W) v.y = src[1];
                if (gj + 2 < W) v.z = src[2];
                if (gj + 3 < W) v.w = src[3];
            }
            *reinterpret_cast<float4*>(tile + r * ts + c) = v;
        }
    }
    if (whiten || use_tile) __syncthreads();

    const int j = j0 + tid;
    if (j >= Wp) return;  // no barrier follows
    const size_t Np = (size_t)Hp * Wp;
    const size_t q = (size_t)i * Wp + j;
    const float* win = use_tile ? tile + tid : img + (size_t)i * W + j;
    const size_t ws = use_tile ? (size_t)ts : (size_t)W;

    if constexpr (P > 0) {
        float v[P * P];
#pragma unroll
        for (int a = 0; a < P; ++a)
#pragma unroll
            for (int b = 0; b < P; ++b) v[a * P + b] = win[a * ws + b];
        double s4[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int e = 0; e < P * P; ++e) s4[e & 3] += v[e];
        const float mean = (float)(((s4[0] + s4[1]) + (s4[2] + s4[3])) /
                                   (P * P));
        const float shift = do_dc ? mean : 0.f;
        double ss4[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int e = 0; e < P * P; ++e) {
            v[e] = v[e] - shift;
            ss4[e & 3] += (double)v[e] * v[e];
        }
        const float scale = fmaxf(
            (float)sqrt((ss4[0] + ss4[1]) + (ss4[2] + ss4[3])), eps);
        means[q] = mean;
        scales[q] = scale;
        if (do_norm) {
#pragma unroll
            for (int e = 0; e < P * P; ++e) v[e] = v[e] / scale;
        }
        if (!whiten) {
#pragma unroll
            for (int e = 0; e < P * P; ++e) X[e * Np + q] = v[e];
            return;
        }
        // four rows at a time, each summed in order over c: four
        // independent chains of fmas
        for (int row = 0; row < P * P; row += 4) {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int c = 0; c < P * P; c += 4) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const float4 w4 = *reinterpret_cast<const float4*>(
                        Ws + (row + u) * (P * P) + c);
                    acc[u] = fmaf(w4.x, v[c], acc[u]);
                    acc[u] = fmaf(w4.y, v[c + 1], acc[u]);
                    acc[u] = fmaf(w4.z, v[c + 2], acc[u]);
                    acc[u] = fmaf(w4.w, v[c + 3], acc[u]);
                }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                X[(row + u) * Np + q] = acc[u] - off[row + u];
        }
    } else {
        double s = 0.0;
        for (int a = 0; a < p; ++a)
            for (int b = 0; b < p; ++b) s += win[a * ws + b];
        const float mean = (float)(s / p2);
        const float shift = do_dc ? mean : 0.f;
        double ss = 0.0;
        for (int a = 0; a < p; ++a)
            for (int b = 0; b < p; ++b) {
                const double v = win[a * ws + b] - shift;
                ss += v * v;
            }
        const float scale = fmaxf((float)sqrt(ss), eps);
        means[q] = mean;
        scales[q] = scale;
        for (int a = 0; a < p; ++a)
            for (int b = 0; b < p; ++b) {
                float v = win[a * ws + b] - shift;
                if (do_norm) v = v / scale;
                if (whiten)
                    vs[(size_t)(a * p + b) * cb + tid] = v;
                else
                    X[(size_t)(a * p + b) * Np + q] = v;
            }
        if (!whiten) return;
        // four rows at a time from Wt, each summed in order over c
        for (int row = 0; row < p2; row += 4) {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            for (int c = 0; c < p2; ++c) {
                const float x = vs[(size_t)c * cb + tid];
                const float4 w4 =
                    *reinterpret_cast<const float4*>(Ws + c * p2r + row);
                acc[0] = fmaf(w4.x, x, acc[0]);
                acc[1] = fmaf(w4.y, x, acc[1]);
                acc[2] = fmaf(w4.z, x, acc[2]);
                acc[3] = fmaf(w4.w, x, acc[3]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (row + u < p2)
                    X[(size_t)(row + u) * Np + q] = acc[u] - off[row + u];
        }
    }
}

template <int P>
cudaError_t launch(const float* img, int H, int W, int p, bool do_dc,
                   bool do_norm, float eps, const float* Wm, const float* off,
                   float* X, float* means, float* scales,
                   cudaStream_t stream) {
    const bool whiten = Wm != nullptr;
    const int Hp = H - p + 1;
    const int Wp = W - p + 1;
    const int cb = (whiten && P == 0) ? CB_WHITEN : CB;
    size_t smem =
        whiten ? whiten_floats(p, P == 0, cb) * sizeof(float) : 0;
    // the image tile where it fits beside the whitening state
    const size_t with_tile = smem + tile_floats(p, cb) * sizeof(float);
    const bool use_tile = with_tile <= kSmemOptin;
    if (use_tile) smem = with_tile;
    if (smem > 48 * 1024) {
        const cudaError_t e =
            lyssa::opt_in_smem<fused_patches_kernel<P>>(smem);
        if (e != cudaSuccess) return e;
    }
    const long long blocks = (long long)Hp * ((Wp + cb - 1) / cb);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    fused_patches_kernel<P><<<(unsigned)blocks, cb, smem, stream>>>(
        img, H, W, p, Hp, Wp, do_dc, do_norm, eps, Wm, off, use_tile, X,
        means, scales);
    return cudaGetLastError();
}

}  // namespace

// Shared memory the whitening state needs at patch size p (bytes; the
// generic path's, which is the larger): what the wrapper checks before it
// asks for whitening.  The image tile comes on top only where it fits.
extern "C" size_t lyssa_fused_patches_whiten_smem(int p) {
    return whiten_floats(p, true, CB_WHITEN) * sizeof(float);
}

// img (H, W) row-major float32; Wm (p^2, p^2) and off (p^2,) or both null;
// X (p^2, Hp Wp), means and scales (Hp Wp,).  Returns cudaGetLastError().
extern "C" int lyssa_fused_patches(const float* img, int H, int W, int p,
                                   int do_dc, int do_norm, float eps,
                                   const float* Wm, const float* off,
                                   float* X, float* means, float* scales,
                                   void* stream) {
    if (p < 1 || p > H || p > W)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t e =
        p == FAST_P
            ? launch<FAST_P>(img, H, W, p, do_dc != 0, do_norm != 0, eps, Wm,
                             off, X, means, scales, s)
            : launch<0>(img, H, W, p, do_dc != 0, do_norm != 0, eps, Wm, off,
                        X, means, scales, s);
    return static_cast<int>(e);
}
