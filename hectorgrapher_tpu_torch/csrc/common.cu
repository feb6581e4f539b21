// Shared C entry points of the package's kernel library.
#include <cuda_runtime.h>

extern "C" const char* hg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
