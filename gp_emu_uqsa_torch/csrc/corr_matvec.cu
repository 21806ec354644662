// K3: out = c(xs, xt) @ rhs without writing the (m, n) correlation block,
// out (m, r), rhs (n, r) with r <= 128; c is a correlation family of
// common.cuh on the squared distance D2: the Gaussian exp(-D2)
// (gp_corr_matvec) or the Matern 5/2 (gp_corr_matvec_matern52), one
// instance of the body each.
//
// Replaces gp_emu_uqsa_tpu/ops/serve.py::corr_matvec_pallas (its bodies
// _kernel_packed, _kernel_fp32 and _contract). Serving packs
// rhs = [e | A^-1 H], so one pass gives the posterior mean's c e and the
// R-term's c A^-1 H.
//
// Bound on the card: operations, m n (3d + 1 + 2r) fp32 operations (the
// Gaussian; the Matern 5/2's root, exp and polynomial count 3d + 8) against
// a few MB of inputs and outputs. Each entry of c is used r times and by one
// query only, so nothing is gained by sharing it between threads; what
// costs issue slots is every instruction beside the 2d + r FMAs and
// subtractions and the family's c. The design keeps those few:
//  - one query a thread, its d <= 20 coordinates in registers; a block of
//    256 queries stages 256 training points (coordinates, and their rhs
//    rows in a slab of R columns) in shared memory, which every thread
//    reads as float4 broadcasts. Each c(i, j) is formed in a register (fp32
//    differences with FMAs, then Family::corr) and at once FMA-ed into R register
//    accumulators: the correlation never touches shared memory;
//  - R is a template parameter: 1 (a vector rhs), 10 (serving's 1 + q at
//    d = 8 with a linear basis) and a general 16; wider rhs go through
//    slabs of 16 columns on grid.z;
//  - parallelism by splitting n, not by atomics: grid.y cuts the training
//    points into `segments` runs of whole chunks, chosen from the card's
//    occupancy so that the grid fills every SM's resident blocks twice
//    (at m = 65536, r = 10 on an NVIDIA H100 80GB HBM3 at 700 W: 4
//    segments, 1.92 ms against 2.10 ms for one, whose 256 blocks leave SMs
//    at two of their three resident blocks; tools/cuda_core_variants.py);
//    each segment
//    writes an (m, r) slice of an (segments, m, r) array of partials and
//    matvec_combine_kernel sums them in segment order, in fp64;
//  - inside a segment, each 64-term partial sum is added to the running
//    total with Kahan compensation: serving's e has large entries of both
//    signs, and an uncompensated fp32 running sum over n / 64 folds was the
//    larger part of the mean's rounding at n = 16384;
//  - padded training rows meet zero rhs rows, and padded query rows are
//    never stored.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // queries per block, one a thread
constexpr int kChunk = 256;     // training points staged per step
constexpr int kFold = 64;       // products summed before each compensated fold
constexpr int kSlab = 16;       // rhs columns of the widest body

// floats per staged rhs row: float4 rows for R > 1
template <int R>
__host__ __device__ constexpr int rhs_stride() { return R == 1 ? 1 : (R + 3) / 4 * 4; }

// out: (segments, m, r) partials, or (m, r) itself for one segment
template <int R, class Family>
__global__ void __launch_bounds__(kThreads)
corr_matvec_kernel(const float* __restrict__ xs, const float* __restrict__ xt,
                   const float* __restrict__ rhs, float* __restrict__ out,
                   int m, int n, int d, int r, int segments) {
  constexpr int kRS = rhs_stride<R>();
  __shared__ __align__(16) float s_t[kChunk * gpemu::kMaxD];   // [j][l]
  __shared__ __align__(16) float s_r[kChunk * kRS];            // [j][col]
  const int tid = threadIdx.x;
  const int gi = blockIdx.x * kThreads + tid;
  const int seg = blockIdx.y;
  const int c0 = blockIdx.z * kSlab;
  const int chunks = (n + kChunk - 1) / kChunk;
  const int ch_begin = static_cast<int>(static_cast<int64_t>(seg) * chunks / segments);
  const int ch_end = static_cast<int>(static_cast<int64_t>(seg + 1) * chunks / segments);

  // coordinates past d are zero on both sides, so they add (0 - 0)^2
  float q[gpemu::kMaxD];
#pragma unroll
  for (int l = 0; l < gpemu::kMaxD; ++l)
    q[l] = (l < d && gi < m) ? xs[static_cast<size_t>(gi) * d + l] : 0.f;
  float acc[R], comp[R];
#pragma unroll
  for (int c = 0; c < R; ++c) acc[c] = comp[c] = 0.f;

  for (int ch = ch_begin; ch < ch_end; ++ch) {
    const int j = ch * kChunk + tid;
    __syncthreads();   // the previous chunk's readers are done
#pragma unroll
    for (int l = 0; l < gpemu::kMaxD; ++l)
      s_t[tid * gpemu::kMaxD + l] =
          (l < d && j < n) ? xt[static_cast<size_t>(j) * d + l] : 0.f;
#pragma unroll
    for (int c = 0; c < kRS; ++c)
      s_r[tid * kRS + c] = (c < R && c0 + c < r && j < n)
                               ? rhs[static_cast<size_t>(j) * r + c0 + c] : 0.f;
    __syncthreads();
    for (int f = 0; f < kChunk; f += kFold) {
      float part[R];
#pragma unroll
      for (int c = 0; c < R; ++c) part[c] = 0.f;
#pragma unroll 4
      for (int jj = f; jj < f + kFold; ++jj) {
        const float4* t4 = reinterpret_cast<const float4*>(s_t + jj * gpemu::kMaxD);
        float d2 = 0.f;
#pragma unroll
        for (int v = 0; v < gpemu::kMaxD / 4; ++v) {
          if (4 * v >= d) break;
          const float4 t = t4[v];
          float u = q[4 * v] - t.x;
          d2 = fmaf(u, u, d2);
          u = q[4 * v + 1] - t.y;
          d2 = fmaf(u, u, d2);
          u = q[4 * v + 2] - t.z;
          d2 = fmaf(u, u, d2);
          u = q[4 * v + 3] - t.w;
          d2 = fmaf(u, u, d2);
        }
        const float cij = Family::corr(d2);
        if constexpr (R == 1) {
          part[0] = fmaf(cij, s_r[jj], part[0]);
        } else {
          const float4* r4 = reinterpret_cast<const float4*>(s_r + jj * kRS);
#pragma unroll
          for (int v = 0; v < kRS / 4; ++v) {
            const float4 rv = r4[v];
            const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (4 * v + e < R) part[4 * v + e] = fmaf(cij, rr[e], part[4 * v + e]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float yv = part[c] - comp[c];
        const float t = acc[c] + yv;
        comp[c] = (t - acc[c]) - yv;
        acc[c] = t;
      }
    }
  }

  if (gi < m) {
    float* o = out + (static_cast<size_t>(seg) * m + gi) * r + c0;
#pragma unroll
    for (int c = 0; c < R; ++c)
      if (c0 + c < r) o[c] = acc[c];
  }
}

// out(e) = sum over segments of partial(s, e), in segment order, in fp64
__global__ void matvec_combine_kernel(const float* __restrict__ partial,
                                      float* __restrict__ out, int64_t size,
                                      int segments) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= size) return;
  double s = 0.0;
  for (int p = 0; p < segments; ++p) s += partial[p * size + e];
  out[e] = static_cast<float>(s);
}

// the body that takes r columns: a vector, serving's 10, or slabs of 16
using MatvecKernel = void (*)(const float*, const float*, const float*,
                              float*, int, int, int, int, int);
template <class Family>
MatvecKernel body_for(int r) {
  if (r == 1) return corr_matvec_kernel<1, Family>;
  if (r == 10) return corr_matvec_kernel<10, Family>;
  return corr_matvec_kernel<kSlab, Family>;
}

// Segments of n for an (m, n, r) product on the current device: as many as
// fill every SM's resident blocks twice, at most one chunk each.
template <class Family>
int matvec_segments(int m, int n, int r) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, body_for<Family>(r),
                                                    kThreads, 0) != cudaSuccess)
    return 1;
  const int64_t blocks = static_cast<int64_t>((m + kThreads - 1) / kThreads) *
                         ((r + kSlab - 1) / kSlab);
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const int64_t s = (2 * resident + blocks - 1) / (blocks > 0 ? blocks : 1);
  return static_cast<int>(s < 1 ? 1 : (s > chunks ? chunks : s));
}

template <class Family>
int launch_matvec(const float* xs, const float* xt, const float* rhs,
                  float* partial, float* out, int m, int n, int d, int r,
                  int segments, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > gpemu::kMaxD || segments < 1 ||
      segments > (n + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slab = r == 1 || r == 10 ? r : kSlab;
  const dim3 grid((m + kThreads - 1) / kThreads, segments, (r + slab - 1) / slab);
  body_for<Family>(r)<<<grid, kThreads, 0, s>>>(
      xs, xt, rhs, segments > 1 ? partial : out, m, n, d, r, segments);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || segments == 1) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(m) * r;
  matvec_combine_kernel<<<static_cast<unsigned>((size + 255) / 256), 256, 0, s>>>(
      partial, out, size, segments);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Segments of n for an (m, n, r) product of the family's body on the current
// device.
extern "C" int gp_corr_matvec_segments(int m, int n, int r) {
  return matvec_segments<gpemu::Gaussian>(m, n, r);
}
extern "C" int gp_corr_matvec_segments_matern52(int m, int n, int r) {
  return matvec_segments<gpemu::Matern52>(m, n, r);
}

// xs: (m, d) delta-scaled queries, xt: (n, d) delta-scaled training inputs,
// rhs: (n, r), partial: (segments, m, r) scratch (unused for one segment),
// out: (m, r); all fp32, row-major, on the device; 1 <= d <= 20,
// 1 <= segments <= ceil(n / 256).
extern "C" int gp_corr_matvec(const float* xs, const float* xt,
                              const float* rhs, float* partial, float* out,
                              int m, int n, int d, int r, int segments,
                              void* stream) {
  return launch_matvec<gpemu::Gaussian>(xs, xt, rhs, partial, out, m, n, d, r,
                                        segments, stream);
}
extern "C" int gp_corr_matvec_matern52(const float* xs, const float* xt,
                                       const float* rhs, float* partial,
                                       float* out, int m, int n, int d, int r,
                                       int segments, void* stream) {
  return launch_matvec<gpemu::Matern52>(xs, xt, rhs, partial, out, m, n, d, r,
                                        segments, stream);
}
