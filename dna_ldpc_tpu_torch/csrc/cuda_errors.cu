// Error text for the status codes the launch entry points return.
#include <cuda_runtime.h>

extern "C" const char* dna_cuda_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
