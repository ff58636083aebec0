// Error text for the codes the C entry points of this library return.
#include <cuda_runtime.h>

extern "C" const char* lyssa_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
