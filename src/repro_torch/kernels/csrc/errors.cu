// The message for an error code that an entry point of this library
// returned, from the CUDA runtime that the library is linked with.
#include <cuda_runtime.h>

extern "C" const char* dlk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
