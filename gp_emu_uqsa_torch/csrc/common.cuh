// Shared by the port's CUDA kernels (built for sm_90a by ops/_build.py).
#pragma once
#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at
                    // run time, so nothing links against libcuda
#include <cuda_runtime.h>

namespace gpemu {
// Widest feature count the kernels take: the serving and build gates of the
// Python package (ops/kernel_matrix.MAX_D, read by the gates in kernels.py)
// send d <= 20 here, as the JAX package sends d <= 20 to its lane-packed
// Pallas kernels.
constexpr int kMaxD = 20;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (csrc/corr_quad.cu has its own copy)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return EncodeTiled{nullptr};
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// TMA map for stores into a row-major fp32 (rows, cols) array, cols a
// multiple of 4 (row strides are multiples of 16 bytes), in boxes of
// box_rows x box_cols with the 128-byte swizzle (box_cols * 4 <= 128);
// the parts of a box past the edge are not written
inline bool make_store_map(CUtensorMap* map, float* data, int rows, int cols,
                           int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, data, dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
}  // namespace gpemu

// Message for a code returned by an entry point (each returns
// cudaGetLastError() right after its launch).
extern "C" const char* gp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
