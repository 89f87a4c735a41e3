// Error strings for the return codes of the kernels' C entry points
// (each returns cudaGetLastError() after its launches).
#include <cuda_runtime.h>

extern "C" const char* scda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
