// K4: quad(x*) = |W c(x*)|^2 with W = L^-1 lower-triangular (n, n), without
// writing the (m, n) correlation block; quad (m,).
//
// Replaces gp_emu_uqsa_tpu/ops/serve.py::corr_quad_pallas (its bodies
// _quad_kernel, _quad_kernel_bf16x3, _quad_epilogue and _corr_tile): the
// whitened variance quadratic t(x*)^T A^-1 t(x*) of the serving path.
//
// Bound on the card: operations. The lower triangle of W c costs
// m n (n + 1) fp32 operations (two per multiply-add) on the CUDA cores,
// against 2 n^2 bytes of W. The TPU grid's sequential axes (factor-row
// tile k, and j <= k inside it) become loops inside one block, so no
// reduction crosses blocks and there are no atomics:
//  - each block owns 64 queries and walks the factor rows in tiles of 64;
//  - for each k tile it sweeps j in chunks of 32 up to the tile's last row,
//    rebuilding c(i, j) in shared memory (fp32 differences, FMAs, expf) and
//    accumulating y(i, k) = sum_j c(i, j) W(k, j) in registers, 4 queries x
//    4 factor rows per thread, read as float4 from shared memory;
//  - entries of W with j > k are never read (they load as zeros), and
//    chunks past the tile's diagonal are skipped;
//  - each chunk's partial sum is added to y (two-level summation), and at
//    the end of each k tile y^2 folds into a per-query sum in registers;
//  - a warp shuffle sums the 16 threads that share a query, and the block
//    writes quad (m,) directly.
// Both precision tiers of the TPU kernel ("highest", "high") run this
// exact fp32 path; "high" only grants an error bound.
#include "common.cuh"

namespace {

constexpr int kTileQ = 64;    // queries per block
constexpr int kTileK = 64;    // factor rows per k tile
constexpr int kChunkJ = 32;   // factor columns per j chunk
constexpr int kPad = 4;       // keeps float4 rows aligned, spreads banks
constexpr int kThreads = 256;
constexpr int kGroups = 16;   // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
corr_quad_kernel(const float* __restrict__ xs, const float* __restrict__ xt,
                 const float* __restrict__ w, float* __restrict__ quad,
                 int m, int n, int d) {
  __shared__ float s_q[gpemu::kMaxD][kTileQ];
  __shared__ float s_t[gpemu::kMaxD][kChunkJ];
  __shared__ __align__(16) float s_c[kChunkJ][kTileQ + kPad];
  __shared__ __align__(16) float s_w[kChunkJ][kTileK + kPad];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTileQ;

  for (int e = tid; e < kTileQ * d; e += kThreads) {
    const int i = e / d, l = e - i * d;
    s_q[l][i] = q0 + i < m ? xs[static_cast<size_t>(q0 + i) * d + l] : 0.f;
  }
  // contraction: factor rows 4 tx .. 4 tx + 3, queries 4 ty .. 4 ty + 3
  const int tx = tid % kGroups;
  const int ty = tid / kGroups;
  // correlation rebuild: query ci (consecutive across a warp), chunk
  // columns cj + 4 s
  const int ci = tid % kTileQ;
  const int cj = tid / kTileQ;

  float sumsq[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < n; k0 += kTileK) {
    float y[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) y[a][b] = 0.f;
    const int j_end = min(n, k0 + kTileK);   // W(k, j) = 0 for j > k
    for (int j0 = 0; j0 < j_end; j0 += kChunkJ) {
      __syncthreads();   // the previous chunk's readers are done
      for (int e = tid; e < kChunkJ * d; e += kThreads) {
        const int j = e / d, l = e - j * d;
        s_t[l][j] = j0 + j < n ? xt[static_cast<size_t>(j0 + j) * d + l]
                               : 0.f;
      }
      // row k of W is contiguous in j: consecutive threads, consecutive j
      for (int e = tid; e < kTileK * kChunkJ; e += kThreads) {
        const int kk = e / kChunkJ, jj = e - kk * kChunkJ;
        const int gk = k0 + kk, gj = j0 + jj;
        s_w[jj][kk] = (gk < n && gj <= gk)
                          ? w[static_cast<size_t>(gk) * n + gj] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kChunkJ / (kThreads / kTileQ); ++s) {
        const int jj = cj + (kThreads / kTileQ) * s;
        float d2 = 0.f;
        for (int l = 0; l < d; ++l) {
          const float t = s_q[l][ci] - s_t[l][jj];
          d2 = fmaf(t, t, d2);
        }
        s_c[jj][ci] = expf(-d2);
      }
      __syncthreads();
      float part[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) part[a][b] = 0.f;
#pragma unroll 8
      for (int jj = 0; jj < kChunkJ; ++jj) {
        const float4 cv = *reinterpret_cast<const float4*>(&s_c[jj][4 * ty]);
        const float4 wv = *reinterpret_cast<const float4*>(&s_w[jj][4 * tx]);
        const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
        const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) part[a][b] = fmaf(cc[a], ww[b], part[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) y[a][b] += part[a][b];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sumsq[a] = fmaf(y[a][b], y[a][b], sumsq[a]);
  }

  // lanes 0-15 and 16-31 of a warp each hold one query group: sum over tx
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float v = sumsq[a];
#pragma unroll
    for (int off = kGroups / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    sumsq[a] = v;
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int gq = q0 + 4 * ty + a;
      if (gq < m) quad[gq] = sumsq[a];
    }
  }
}

}  // namespace

// xs: (m, d) delta-scaled queries, xt: (n, d) delta-scaled training inputs,
// w: (n, n) lower-triangular, quad: (m,); all fp32, row-major, on the device.
extern "C" int gp_corr_quad(const float* xs, const float* xt, const float* w,
                            float* quad, int m, int n, int d, void* stream) {
  const dim3 grid((m + kTileQ - 1) / kTileQ);
  corr_quad_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xs, xt, w, quad, m, n, d);
  return static_cast<int>(cudaGetLastError());
}
