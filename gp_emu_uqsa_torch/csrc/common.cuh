// Shared by the port's CUDA kernels (built for sm_90a by ops/_build.py).
#pragma once
#include <cuda_runtime.h>

namespace gpemu {
// Widest feature count the kernels take: the serving and build gates of the
// Python package (kernels._FAST_MAX_D) send d <= 20 here, as the JAX package
// sends d <= 20 to its lane-packed Pallas kernels.
constexpr int kMaxD = 20;
}  // namespace gpemu

// Message for a code returned by an entry point (each returns
// cudaGetLastError() right after its launch).
extern "C" const char* gp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
