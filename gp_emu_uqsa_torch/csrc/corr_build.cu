// K1/K2: Gaussian correlation builds, out[i, j] = exp(-sum_l (a_il - b_jl)^2)
// (+ nugget on i == j for K1).
//
// Replaces gp_emu_uqsa_tpu/ops/kernel_matrix.py::gaussian_corr_self_pallas
// (K1, the training matrix A = c(X, X) + nugget I; a = b = X / delta) and
// ::gaussian_corr_pallas (K2, the cross block c(X1, X2); a = X1 * (1/delta),
// b = X2 * (1/delta)). The kernels take the unscaled inputs, delta (d values)
// and the nugget (by value or as a pointer to one value on the device), so
// a wrapper call is one launch and never waits for the card.
//
// Bound on the card: writing the m x n fp32 output (m n 4 bytes at HBM
// bandwidth; 1.07 GB for K1 at n = 16384, 21 times the L2). The arithmetic
// is of the same size: at n = 16384, d = 8 an H100 takes about as long to
// compute the half of A that K1 builds as to store all of A (the "no
// stores" variant of tools/cuda_core_variants.py), and more at larger d.
// So the design halves the arithmetic and hides it behind the stores:
//  - output tiles of 64 x 64; a thread computes 4 x 4 entries from the two
//    blocks' scaled rows, staged in shared memory as [feature][row];
//  - K1 builds only the tile pairs (I, J) with I >= J (pair p of the lower
//    triangle: I = floor((sqrt(8p + 1) - 1) / 2), J = p - I (I + 1) / 2)
//    and stores each twice, at (I, J) and transposed at (J, I). That halves
//    the distance and exp work, and A is exactly symmetric by construction;
//  - each tile (and its transpose) is written to shared memory in the
//    layout of a TMA box of 64 rows x 32 columns with the 128-byte swizzle.
//    Threads are laid out so that both the tile's and the transpose's
//    16-byte writes are free of bank conflicts;
//  - the stores overlap the arithmetic: a persistent grid (as many blocks
//    as fit on the card) walks the tile pairs, the output tiles are double-
//    buffered, and a tile's store is issued before the next tile is
//    computed. Stores go by TMA (cp.async.bulk.tensor, whole 128-byte
//    lines, clipped at the ragged edge) or, with kTmaStore false and always
//    when a row is not a multiple of 16 bytes, as 16-byte evict-first
//    stores from the threads (st.global.cs.v4; scalar at a ragged row);
//  - the arithmetic is the plain versions' (ops/kernel_matrix.py): K1
//    scales by IEEE division, K2 by a correctly rounded reciprocal and
//    product; the distance is fp32 differences accumulated with FMAs in
//    feature order; expf (not __expf). Each entry is bitwise the plain
//    version's.
#include <cuda.h>   // CUtensorMap and its enums

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kTile = 64;                    // output tile rows and columns
constexpr int kThreads = 256;                // 4 x 4 entries a thread
constexpr int kBoxCols = 32;                 // TMA box: 64 rows x 128 bytes
constexpr int kTileFloats = kTile * kTile;
constexpr int kAlign = 1024;                 // 128-byte swizzle atoms
constexpr bool kMirror = true;               // K1: lower tiles, stored twice
constexpr bool kTmaStore = true;             // else st.global.cs.v4
constexpr bool kPersistent = true;           // else one block a tile pair

// tiles a block holds: two stages of a tile (and, for K1, its transpose)
__host__ __device__ constexpr int copies(bool self) {
  return self && kMirror ? 2 : 1;
}
constexpr size_t smem_bytes(bool self) {
  return sizeof(float) * (2 * copies(self) * kTileFloats +
                          2 * gpemu::kMaxD * kTile) + kAlign;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// offset (floats) of row r, 16-byte chunk c4 (0..15) in a tile laid out as
// two TMA boxes of 64 x 32 with the 128-byte swizzle
__device__ __forceinline__ int swz(int r, int c4) {
  return (c4 >> 3) * (kTile * kBoxCols) + r * kBoxCols +
         (((c4 & 7) ^ (r & 7)) << 2);
}

// pair p of the lower triangle of tiles, row-major: (ti, tj), ti >= tj
__device__ __forceinline__ void tri_pair(int p, int& ti, int& tj) {
  int i = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > p) --i;
  while ((i + 1) * (i + 2) / 2 <= p) ++i;
  ti = i;
  tj = p - i * (i + 1) / 2;
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const float* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
         "r"(c0), "r"(c1)
      : "memory");
}

// one 64 x 64 tile from shared memory to out[r0.., c0..] of (rows, cols),
// row stride ld; 16-byte stores when vec (ld % 4 == 0), else scalar
__device__ __forceinline__ void store_tile(const float* s, float* out, int ld,
                                           int rows, int cols, int r0, int c0,
                                           bool vec) {
  for (int q = threadIdx.x; q < kTileFloats / 4; q += kThreads) {
    const int r = q >> 4, c4 = q & 15;
    const int gr = r0 + r, gc = c0 + 4 * c4;
    if (gr >= rows || gc >= cols) continue;
    const float4 v = *reinterpret_cast<const float4*>(s + swz(r, c4));
    float* dst = out + static_cast<size_t>(gr) * ld + gc;
    if (vec) {
      __stcs(reinterpret_cast<float4*>(dst), v);
    } else {
      __stcs(dst, v.x);
      if (gc + 1 < cols) __stcs(dst + 1, v.y);
      if (gc + 2 < cols) __stcs(dst + 2, v.z);
      if (gc + 3 < cols) __stcs(dst + 3, v.w);
    }
  }
}

// K1 (kSelf): x1 = x2 = x (n, d), out (n, n), scaled by x / delta, nugget
// on the diagonal. K2: x1 (m, d), x2 (n, d), out (m, n), scaled by
// x * (1 / delta). All fp32 row-major on the device.
template <bool kSelf>
__global__ void __launch_bounds__(kThreads, 2)
corr_build_kernel(const __grid_constant__ CUtensorMap map,
                  const float* __restrict__ x1, const float* __restrict__ x2,
                  const float* __restrict__ delta,
                  const float* __restrict__ nugget_ptr, float nugget,
                  float* __restrict__ out, int m, int n, int d, int use_tma) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float s_scale[gpemu::kMaxD];
  float* base = reinterpret_cast<float*>(
      smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1)));
  constexpr int kCopies = copies(kSelf);
  constexpr bool kMirrored = kSelf && kMirror;
  float* sa = base + 2 * kCopies * kTileFloats;   // [l][row] of block I
  float* sb = sa + gpemu::kMaxD * kTile;          // [l][row] of block J

  const int tid = threadIdx.x;
  // 4 x 4 entries: rows 4 rg.., columns 4 cg..; each quarter warp holds 8
  // distinct rg and 8 distinct cg, so that the tile's rows (chunk cg) and
  // the transpose's rows (chunk rg) both land in 8 distinct swizzled chunks
  const int lane8 = tid & 7, oct = tid >> 3;
  const int cg = lane8 + 8 * (oct & 1);
  const int rg = (lane8 + (oct >> 1)) & 15;

  if (tid < d) s_scale[tid] = kSelf ? delta[tid] : __frcp_rn(delta[tid]);
  const float nu = kSelf ? (nugget_ptr != nullptr ? *nugget_ptr : nugget) : 0.f;
  const int tiles_m = (m + kTile - 1) / kTile;
  const int tiles_n = (n + kTile - 1) / kTile;
  const int pairs = kMirrored ? tiles_m * (tiles_m + 1) / 2 : tiles_m * tiles_n;
  const bool tma = kTmaStore && use_tma;
  const bool vec = (n & 3) == 0;
  __syncthreads();

  int it = 0;
  for (int p = blockIdx.x; p < pairs; p += gridDim.x, ++it) {
    int ti, tj;
    if (kMirrored) {
      tri_pair(p, ti, tj);
    } else {
      ti = p / tiles_n;
      tj = p - ti * tiles_n;
    }
    const int row0 = ti * kTile, col0 = tj * kTile;
    const bool mirrored = kMirrored && ti != tj;
    const bool diag = kSelf && ti == tj;

    // both blocks' scaled rows; consecutive threads fill consecutive words
    for (int e = tid; e < kTile * d; e += kThreads) {
      const int r = e & (kTile - 1), l = e / kTile;
      const int ga = row0 + r, gb = col0 + r;
      const float s = s_scale[l];
      float va = 0.f, vb = 0.f;
      if (ga < m) {
        const float v = x1[static_cast<size_t>(ga) * d + l];
        va = kSelf ? __fdiv_rn(v, s) : __fmul_rn(v, s);
      }
      if (gb < n) {
        const float v = x2[static_cast<size_t>(gb) * d + l];
        vb = kSelf ? __fdiv_rn(v, s) : __fmul_rn(v, s);
      }
      sa[l * kTile + r] = va;
      sb[l * kTile + r] = vb;
    }
    float* s_d = base + (it & 1) * kCopies * kTileFloats;
    float* s_t = s_d + kTileFloats;
    // the TMA stores that read this stage's buffers two tiles ago are done
    if (tma && tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int l = 0; l < d; ++l) {
      const float4 a4 = *reinterpret_cast<const float4*>(sa + l * kTile + 4 * rg);
      const float4 b4 = *reinterpret_cast<const float4*>(sb + l * kTile + 4 * cg);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float t = a[i] - b[j];
          acc[i][j] = fmaf(t, t, acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = expf(-acc[i][j]);
        if (diag && 4 * rg + i == 4 * cg + j) v += nu;
        acc[i][j] = v;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(s_d + swz(4 * rg + i, cg)) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (mirrored) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(s_t + swz(4 * cg + j, rg)) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    }
    // the threads' shared-memory writes, visible to the TMA unit
    if (tma) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    if (tma) {
      if (tid == 0) {
        tma_store_2d(&map, s_d, col0, row0);
        if (col0 + kBoxCols < n)
          tma_store_2d(&map, s_d + kTile * kBoxCols, col0 + kBoxCols, row0);
        if (mirrored) {
          tma_store_2d(&map, s_t, row0, col0);
          if (row0 + kBoxCols < n)
            tma_store_2d(&map, s_t + kTile * kBoxCols, row0 + kBoxCols, col0);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    } else {
      store_tile(s_d, out, n, m, n, row0, col0, vec);
      if (mirrored) store_tile(s_t, out, n, n, n, col0, row0, vec);
    }
  }
  if (tma && tid == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <bool kSelf>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(corr_build_kernel<kSelf>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(kSelf)));
}

// blocks of the launch: every tile pair when not persistent, else as many
// as are resident on the card at once (found once per process)
template <bool kSelf>
int grid_blocks(int pairs) {
  if (!kPersistent) return pairs;
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (allow_smem<kSelf>() != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, corr_build_kernel<kSelf>, kThreads, smem_bytes(kSelf)) !=
            cudaSuccess ||
        per_sm < 1)
      return pairs;   // the launch reports what is wrong
    resident = sms * per_sm;
  }
  return std::min(pairs, resident);
}

int tile_pairs(bool self, int m, int n) {
  const int tm = (m + kTile - 1) / kTile, tn = (n + kTile - 1) / kTile;
  return self && kMirror ? tm * (tm + 1) / 2 : tm * tn;
}

template <bool kSelf>
int launch(const float* x1, const float* x2, const float* delta,
           const float* nugget_ptr, float nugget, float* out, int m, int n,
           int d, void* stream) {
  if (m < 1 || n < 1 || d < 1 || d > gpemu::kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  int use_tma = 0;
  // TMA row strides are multiples of 16 bytes: other widths take the
  // threads' stores
  if (kTmaStore && n % 4 == 0) {
    if (!gpemu::make_store_map(&map, out, m, n, kTile, kBoxCols))
      return static_cast<int>(cudaErrorNotSupported);
    use_tma = 1;
  }
  const cudaError_t err = allow_smem<kSelf>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = grid_blocks<kSelf>(tile_pairs(kSelf, m, n));
  corr_build_kernel<kSelf><<<blocks, kThreads, smem_bytes(kSelf),
                             static_cast<cudaStream_t>(stream)>>>(
      map, x1, x2, delta, nugget_ptr, nugget, out, m, n, d, use_tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. x: (n, d); delta: (d,); out: (n, n); all fp32 on the device. The
// nugget is *nugget_ptr (one fp32 value on the device) when nugget_ptr is
// not null, else `nugget`.
extern "C" int gp_corr_self(const float* x, const float* delta,
                            const float* nugget_ptr, float nugget, float* out,
                            int n, int d, void* stream) {
  return launch<true>(x, x, delta, nugget_ptr, nugget, out, n, n, d, stream);
}

// K2. x1: (m, d); x2: (n, d); delta: (d,); out: (m, n); all fp32 on the
// device.
extern "C" int gp_corr_cross(const float* x1, const float* x2,
                             const float* delta, float* out, int m, int n,
                             int d, void* stream) {
  return launch<false>(x1, x2, delta, nullptr, 0.f, out, m, n, d, stream);
}

// The launch plan of K1 (self != 0) or K2 at (m, n): plan[0] tile pairs,
// plan[1] blocks, plan[2] dynamic shared memory bytes a block.
extern "C" int gp_corr_build_plan(int self, int m, int n, int* plan) {
  plan[0] = tile_pairs(self != 0, m, n);
  plan[1] = self ? grid_blocks<true>(plan[0]) : grid_blocks<false>(plan[0]);
  plan[2] = static_cast<int>(smem_bytes(self != 0));
  return 0;
}
