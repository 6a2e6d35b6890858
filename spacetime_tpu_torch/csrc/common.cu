// What the kernel library shares across its sources: the text of a CUDA
// error code, for the messages of every ctypes wrapper
// (spacetime_tpu_torch/ops/native.py `check`).

#include <cuda_runtime.h>

extern "C" {

const char* spacetime_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
