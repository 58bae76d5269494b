// Error reporting for the ctypes bindings: the entry points return a
// cudaError_t code, and the Python wrappers raise with this message.
#include <cuda_runtime.h>

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
