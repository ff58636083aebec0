// Fused patch pipeline: stride-1 extraction + DC removal + contrast
// normalization + optional whitening, in one pass over the image.
//
// Replaces lyssandra_tpu/ops/pallas_patches.py::_kernel.  For every patch
// position q = (i, j) of an (H, W) image, with v the p x p window at (i, j):
//   mean_q  = mean(v);             v <- v - mean_q       (do_dc)
//   scale_q = max(||v||_2, eps);   v <- v / scale_q      (do_norm)
//   X[:, q] = Wm v - off                                 (whitening, optional)
// Outputs X (p^2, Hp Wp) in the exact shape (no padding), means and scales
// (Hp Wp,) — each returned even when its stage is off.
//
// What bounds it on an H100: memory.  X is p^2 times the image (64 x at
// p=8: 67 MB written for a 512^2 image), while the image itself (1 MB)
// stays in L1/L2.  So the design makes the writes of X coalesced: one
// thread per patch position, neighbouring threads on neighbouring columns
// q, so every row of X is written in contiguous 128-byte pieces and the
// image reads of a warp are contiguous too.  The thread reads its window
// three times (mean, centred sum of squares, write) from cache instead of
// keeping p^2 values in registers.  The two sums accumulate in double, so
// the statistics are correctly rounded whatever the summation order.  The
// whitening epilogue keeps Wm (p^2 x p^2, 16 KB at p=8) in shared memory
// and stages each thread's processed window there, column-interleaved so
// that the reads are free of bank conflicts.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;        // plain pass
constexpr int kWhitenThreads = 64;   // whitening epilogue

__global__ void fused_patches_kernel(const float* __restrict__ img, int W,
                                     int p, int Wp, int Np, bool do_dc,
                                     bool do_norm, float eps,
                                     const float* __restrict__ Wm,
                                     const float* __restrict__ off,
                                     float* __restrict__ X,
                                     float* __restrict__ means,
                                     float* __restrict__ scales) {
    extern __shared__ float smem[];
    const int p2 = p * p;
    const bool whiten = Wm != nullptr;
    float* Ws = smem;                    // (p2, p2), whitening only
    float* vs = smem + (size_t)p2 * p2;  // (p2, blockDim.x), whitening only
    if (whiten) {
        for (int e = threadIdx.x; e < p2 * p2; e += blockDim.x) Ws[e] = Wm[e];
        __syncthreads();
    }
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= Np) return;  // no barrier follows
    const int i = q / Wp;
    const int j = q - i * Wp;
    const float* win = img + (size_t)i * W + j;

    double s = 0.0;
    for (int a = 0; a < p; ++a)
        for (int b = 0; b < p; ++b) s += win[(size_t)a * W + b];
    const float mean = (float)(s / p2);
    const float shift = do_dc ? mean : 0.f;
    double ss = 0.0;
    for (int a = 0; a < p; ++a)
        for (int b = 0; b < p; ++b) {
            const double v = win[(size_t)a * W + b] - shift;
            ss += v * v;
        }
    const float scale = fmaxf((float)sqrt(ss), eps);
    means[q] = mean;
    scales[q] = scale;

    for (int a = 0; a < p; ++a)
        for (int b = 0; b < p; ++b) {
            float v = win[(size_t)a * W + b] - shift;
            if (do_norm) v = v / scale;
            if (whiten)
                vs[(size_t)(a * p + b) * blockDim.x + threadIdx.x] = v;
            else
                X[(size_t)(a * p + b) * Np + q] = v;
        }
    if (!whiten) return;
    for (int row = 0; row < p2; ++row) {
        float acc = 0.f;
        for (int c = 0; c < p2; ++c)
            acc = fmaf(Ws[row * p2 + c], vs[(size_t)c * blockDim.x + threadIdx.x],
                       acc);
        X[(size_t)row * Np + q] = acc - off[row];
    }
}

}  // namespace

// Shared memory the whitening epilogue needs at patch size p (bytes).
extern "C" size_t lyssa_fused_patches_whiten_smem(int p) {
    const size_t p2 = (size_t)p * p;
    return (p2 * p2 + p2 * kWhitenThreads) * sizeof(float);
}

// img (H, W) row-major float32; Wm (p^2, p^2) and off (p^2,) or both null;
// X (p^2, Hp Wp), means and scales (Hp Wp,).  Returns cudaGetLastError().
extern "C" int lyssa_fused_patches(const float* img, int H, int W, int p,
                                   int do_dc, int do_norm, float eps,
                                   const float* Wm, const float* off,
                                   float* X, float* means, float* scales,
                                   void* stream) {
    const int Hp = H - p + 1;
    const int Wp = W - p + 1;
    const int Np = Hp * Wp;
    const bool whiten = Wm != nullptr;
    const int threads = whiten ? kWhitenThreads : kThreads;
    const size_t smem = whiten ? lyssa_fused_patches_whiten_smem(p) : 0;
    if (whiten) {
        cudaError_t e = cudaFuncSetAttribute(
            fused_patches_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const unsigned blocks = (unsigned)((Np + threads - 1) / threads);
    fused_patches_kernel<<<blocks, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        img, W, p, Wp, Np, do_dc != 0, do_norm != 0, eps, Wm, off, X, means,
        scales);
    return static_cast<int>(cudaGetLastError());
}
