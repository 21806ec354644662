// K3: out = exp(-D2(xs, xt)) @ rhs without writing the (m, n) correlation
// block, out (m, r), rhs (n, r) with r <= 128.
//
// Replaces gp_emu_uqsa_tpu/ops/serve.py::corr_matvec_pallas (its bodies
// _kernel_packed, _kernel_fp32 and _contract). Serving packs
// rhs = [e | A^-1 H], so one pass gives the posterior mean's c e and the
// R-term's c A^-1 H.
//
// Bound on the card: operations, m n (3d + 1 + 2r) fp32 operations against
// a few MB of inputs and outputs. The TPU kernel's sequential grid axis over
// n becomes a loop inside one block, so no reduction crosses blocks:
//  - each block owns 64 query rows and one slab of 16 rhs columns (the grid's
//    second axis covers r > 16), and walks n in chunks of 64 training rows;
//  - per chunk it builds the 64 x 64 correlation tile in shared memory
//    (fp32 differences with FMAs, expf) and contracts it at once against the
//    chunk's rhs rows, four columns per thread;
//  - each chunk's 64-term partial sum is added to the running total with
//    Kahan compensation: serving's e has large entries of both signs, and
//    an uncompensated fp32 running sum over n/64 chunks was the larger
//    part of the mean's rounding at n = 16384;
//  - padded training rows meet zero rhs rows, as in the TPU kernel, and
//    padded query rows are never stored.
#include "common.cuh"

namespace {

constexpr int kTileM = 64;     // query rows per block
constexpr int kTileN = 64;     // training rows per chunk
constexpr int kSlab = 16;      // rhs columns per block
constexpr int kThreads = 256;
constexpr int kColsPerThread = kSlab / (kThreads / kTileM);  // 4

__global__ void __launch_bounds__(kThreads)
corr_matvec_kernel(const float* __restrict__ xs, const float* __restrict__ xt,
                   const float* __restrict__ rhs, float* __restrict__ out,
                   int m, int n, int d, int r) {
  __shared__ float s_q[gpemu::kMaxD][kTileM];
  __shared__ float s_t[gpemu::kMaxD][kTileN];
  __shared__ float s_c[kTileM][kTileN + 1];   // +1: conflict-free row reads
  __shared__ float s_r[kTileN][kSlab];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTileM;
  const int c0 = blockIdx.y * kSlab;

  for (int e = tid; e < kTileM * d; e += kThreads) {
    const int i = e / d, l = e - i * d;
    s_q[l][i] = q0 + i < m ? xs[static_cast<size_t>(q0 + i) * d + l] : 0.f;
  }
  // tile build: column aj (consecutive across a warp), rows ai + 4 s
  const int aj = tid % kTileN;
  const int ai = tid / kTileN;
  // contraction: query row bi, rhs columns bc .. bc + 3 of the slab
  const int bi = tid / (kThreads / kTileM);
  const int bc = (tid % (kThreads / kTileM)) * kColsPerThread;

  float acc[kColsPerThread], comp[kColsPerThread];
#pragma unroll
  for (int q = 0; q < kColsPerThread; ++q) acc[q] = comp[q] = 0.f;

  for (int j0 = 0; j0 < n; j0 += kTileN) {
    __syncthreads();   // the previous chunk's readers are done
    for (int e = tid; e < kTileN * d; e += kThreads) {
      const int j = e / d, l = e - j * d;
      s_t[l][j] = j0 + j < n ? xt[static_cast<size_t>(j0 + j) * d + l] : 0.f;
    }
    for (int e = tid; e < kTileN * kSlab; e += kThreads) {
      const int j = e / kSlab, q = e - j * kSlab;
      const int gj = j0 + j, gc = c0 + q;
      s_r[j][q] = (gj < n && gc < r) ? rhs[static_cast<size_t>(gj) * r + gc]
                                     : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < kTileM / (kThreads / kTileN); ++s) {
      const int i = ai + (kThreads / kTileN) * s;
      float d2 = 0.f;
      for (int l = 0; l < d; ++l) {
        const float t = s_q[l][i] - s_t[l][aj];
        d2 = fmaf(t, t, d2);
      }
      s_c[i][aj] = expf(-d2);
    }
    __syncthreads();
    float part[kColsPerThread];
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) part[q] = 0.f;
#pragma unroll 8
    for (int j = 0; j < kTileN; ++j) {
      const float c = s_c[bi][j];
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q)
        part[q] = fmaf(c, s_r[j][bc + q], part[q]);
    }
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const float y = part[q] - comp[q];
      const float t = acc[q] + y;
      comp[q] = (t - acc[q]) - y;
      acc[q] = t;
    }
  }

  const int gi = q0 + bi;
  if (gi < m) {
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const int gc = c0 + bc + q;
      if (gc < r) out[static_cast<size_t>(gi) * r + gc] = acc[q];
    }
  }
}

}  // namespace

// xs: (m, d) delta-scaled queries, xt: (n, d) delta-scaled training inputs,
// rhs: (n, r), out: (m, r); all fp32, row-major, on the device.
extern "C" int gp_corr_matvec(const float* xs, const float* xt,
                              const float* rhs, float* out, int m, int n,
                              int d, int r, void* stream) {
  const dim3 grid((m + kTileM - 1) / kTileM, (r + kSlab - 1) / kSlab);
  corr_matvec_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      xs, xt, rhs, out, m, n, d, r);
  return static_cast<int>(cudaGetLastError());
}
