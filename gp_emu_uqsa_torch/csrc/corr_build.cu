// K1/K2: Gaussian correlation build, out[i, j] = exp(-sum_l (a_il - b_jl)^2)
// (+ nugget on i == j when add_nugget is set).
//
// Replaces gp_emu_uqsa_tpu/ops/kernel_matrix.py::gaussian_corr_self_pallas
// (K1, the training matrix A = c(X, X) + nugget I; a = b = X / delta) and
// ::gaussian_corr_pallas (K2, the cross block c(X1, X2); a = X1 / delta,
// b = X2 / delta). The wrapper in ops/kernel_matrix.py scales the inputs.
//
// Bound on the card: writing the m x n fp32 output (m n 4 bytes at HBM
// bandwidth). The distance costs 3d + 1 operations per entry, below the
// store time for d <= 20, so the design is about the store:
//  - each block owns a 64 x 128 output tile, each thread 8 x 4 entries;
//  - a warp stores 32 consecutive floats of one row per instruction
//    (128-byte coalesced stores);
//  - both sides' scaled rows are staged in shared memory transposed
//    ([feature][row]), so a warp's reads are broadcasts or consecutive
//    words (no bank conflicts);
//  - the distance is fp32 differences accumulated with FMAs in feature
//    order: exact to fp32, and (a - b)^2 == (b - a)^2 makes A exactly
//    symmetric when a == b. expf (not __expf) keeps full fp32 accuracy.
#include "common.cuh"

namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 128;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kRowsPerThread = kTileM / kThreadsY;   // 8
constexpr int kColsPerThread = kTileN / kThreadsX;   // 4

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
corr_build_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int m, int n, int d,
                  float nugget, int add_nugget) {
  __shared__ float sa[gpemu::kMaxD][kTileM];
  __shared__ float sb[gpemu::kMaxD][kTileN];
  const int row0 = blockIdx.y * kTileM;
  const int col0 = blockIdx.x * kTileN;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  constexpr int kThreads = kThreadsX * kThreadsY;

  // consecutive threads read consecutive words of the row-major inputs
  for (int e = tid; e < kTileM * d; e += kThreads) {
    const int r = e / d, l = e - r * d;
    const int gr = row0 + r;
    sa[l][r] = gr < m ? a[static_cast<size_t>(gr) * d + l] : 0.f;
  }
  for (int e = tid; e < kTileN * d; e += kThreads) {
    const int c = e / d, l = e - c * d;
    const int gc = col0 + c;
    sb[l][c] = gc < n ? b[static_cast<size_t>(gc) * d + l] : 0.f;
  }
  __syncthreads();

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  for (int l = 0; l < d; ++l) {
    float va[kRowsPerThread], vb[kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      va[i] = sa[l][threadIdx.y + kThreadsY * i];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      vb[j] = sb[l][threadIdx.x + kThreadsX * j];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float t = va[i] - vb[j];
        acc[i][j] = fmaf(t, t, acc[i][j]);
      }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int gr = row0 + threadIdx.y + kThreadsY * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int gc = col0 + threadIdx.x + kThreadsX * j;
      if (gc >= n) continue;
      float v = expf(-acc[i][j]);
      if (add_nugget && gr == gc) v += nugget;
      out[static_cast<size_t>(gr) * n + gc] = v;
    }
  }
}

}  // namespace

// a: (m, d), b: (n, d), out: (m, n); all fp32, row-major, on the device.
extern "C" int gp_corr_build(const float* a, const float* b, float* out,
                             int m, int n, int d, float nugget,
                             int add_nugget, void* stream) {
  const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
  const dim3 block(kThreadsX, kThreadsY);
  corr_build_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, m, n, d, nugget, add_nugget);
  return static_cast<int>(cudaGetLastError());
}
