// Warp-wide reductions of the feature-sign kernels (fs_cold.cu, fs_scan.cu).
// They are xor butterflies, so every thread of the warp ends with the same
// value and control flow that depends on it stays warp-uniform.
#pragma once

#include <cuda_runtime.h>

namespace lyssa {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
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

}  // namespace lyssa
