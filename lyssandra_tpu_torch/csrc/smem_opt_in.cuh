// Opt a kernel in to more than 48 KB of dynamic shared memory once per
// device and size.  The attribute persists, so later launches skip the
// call: less host work a launch, and no attribute call while a CUDA graph
// captures the stream.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace lyssa {

template <auto Kernel>
cudaError_t opt_in_smem(size_t bytes) {
    constexpr int kMaxDevices = 64;
    static size_t done[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (bytes <= done[dev]) return cudaSuccess;
    e = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e == cudaSuccess) done[dev] = bytes;
    return e;
}

}  // namespace lyssa
