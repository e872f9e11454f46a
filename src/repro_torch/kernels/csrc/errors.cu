// The C interface's error reporting: every entry point returns the
// cudaError_t of its launch as an int; this turns one into its message.
#include <cuda_runtime.h>

extern "C" const char* famous_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
