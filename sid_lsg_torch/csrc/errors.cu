// Error text for the cudaError_t codes that the kernels' C entries return.

#include <cuda_runtime.h>

extern "C" const char* sidlsg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
