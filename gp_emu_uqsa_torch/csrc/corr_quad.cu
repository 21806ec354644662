// K4: quad(x*) = |W c(x*)|^2 with W = L^-1 lower-triangular (n, n), without
// writing the (m, n) correlation block; quad (m,).
//
// Replaces gp_emu_uqsa_tpu/ops/serve.py::corr_quad_pallas (its bodies
// _quad_kernel, _quad_kernel_bf16x3, _quad_epilogue and _corr_tile): the
// whitened variance quadratic t(x*)^T A^-1 t(x*) of the serving path. Two
// bodies, one per precision tier of the TPU kernel.
//
// "highest" (gp_corr_quad, _quad_kernel's counterpart): exact fp32 FMAs on
// the CUDA cores; no TF32, no split, no tensor cores. Bound on the card: the
// m n (n + 1) fp32 operations of the lower triangle of W c (two per
// multiply-add) at the fp32 peak, against 2 n^2 bytes of W. Every
// instruction that is not one of those FMAs takes an issue slot from them,
// and on the card the shared-memory loads that feed them cost more than
// their count (tools/cuda_core_variants.py on an NVIDIA H100 80GB HBM3 at
// 700 W: without the 2 c loads of each 64 FMAs the body ran 11% faster). So the design is an SGEMM-class loop
// that gives each loaded operand and each rebuilt correlation entry as
// many FMAs as the registers allow:
//  - one preparation pass per call (w_transpose_kernel) writes a scratch
//    copy Wt(j, k) = W(k, j) in which, for each j, the factor rows k are
//    contiguous; it zeroes W's strict upper triangle and pads to the tile,
//    so the diagonal tile needs no mask and a dirty upper triangle is never
//    read;
//  - a block owns 128 queries x 256 factor rows (a k tile), in two halves
//    of 128 rows; each of its 256 threads holds 8 queries x 8 factor rows
//    of y in each half (128 registers) and reads its operands as 4 float4
//    from shared memory for 64 FMAs (conflict-free: a warp reads 2
//    distinct c vectors and 16 consecutive W vectors). The halves run one
//    after the other on the same rebuilt c, sharing one 64-register
//    partial: 253 registers, no spills;
//  - each k tile sweeps j in chunks of 64 up to its last row through a
//    double-buffered ring (212 KB of shared memory): cp.async (16 bytes)
//    brings the next chunk's Wt rows and the coordinates of the chunk after
//    it, and the next chunk's c(i, j) is rebuilt into shared memory (fp32
//    differences with FMAs, expf; 32 entries a thread) while the current
//    chunk's FMAs run; one __syncthreads a chunk. A rebuilt entry feeds
//    256 FMAs (PR 1's body: 64), which halved the rebuild's cost against
//    a 128-row k tile; chunks of 32 and 16 columns took 7% and 17% longer;
//  - two-level summation: each chunk's 64-term partial is added to y in
//    fp32, and at the end of each k tile y^2 folds into a per-query sum;
//  - small m: the k tiles of one query tile are independent until the sum
//    of y^2, which has no cancellation. When the query tiles alone leave
//    SMs idle, grid.y spreads the k tiles over `splits` blocks, each block
//    taking tiles t and T-1-t of its pairs so every block gets the same
//    share of the triangle; each writes its (m,) partial of quad and
//    quad_combine_kernel sums them in a fixed order (no atomics). With one
//    split the block writes quad directly. (The m = 4096 request on the
//    same card: 4 splits, 28.4 ms, against 111.8 ms unsplit.)
//
// "high" (gp_corr_quad_tf32x3, _quad_kernel_bf16x3's counterpart): 3xTF32
// on the tensor cores through wgmma. Each operand x is split as
// hi = tf32(x), lo = tf32(x - hi), both rounded to nearest (ties away, as
// cvt.rna.tf32.f32); y = c_hi W_hi + c_hi W_lo + c_lo W_hi, the lo*lo term
// dropped: about 2^-21 relative per product. The tensor cores ignore the
// low 13 mantissa bits of an fp32 operand, so hi must be rounded before lo
// is formed. Bound on the card: the 3 m n (n + 1) operations at the dense
// TF32 rate. Design:
//  - summation: the tensor cores add into their fp32 accumulators without
//    rounding to nearest, and over a whole j sweep (up to n / 8 k8 steps
//    into one accumulator) that bias grew to 4e-2 absolute on quad at
//    n = 16384 on an H100, against the tier's budget of 4.7e-5
//    (docs/numerics.md). So the tensor cores sum only kFoldStages stages
//    (16 k8 steps, 48 products of 3 passes) into a register partial, and
//    the CUDA cores add each partial into y in fp32 (two-level summation,
//    as the "highest" body does);
//  - layout: wgmma takes TF32 operands K-major only, and here K = j. B is
//    W(k, j), row-major, so TMA boxes of 128 k-rows x 32 j-columns (128
//    bytes a row, 128-byte swizzle) are K-major as they stand. A is the
//    correlation tile; each consumer thread rebuilds the entries of its
//    m64n128k8 A fragments in registers (fp32 differences, FMAs, expf, the
//    split), so c never touches shared memory;
//  - tiles: a block is two consumer warpgroups of 64 queries each (128
//    queries) and a producer warpgroup. A k tile is 128 factor rows (the
//    wgmma N): the register partial (64 fp32 a thread) and the A fragments
//    of two stages (64 registers) fill the consumers' registers, and y for
//    64 queries x 128 rows lives in shared memory (64 KB for the block,
//    each thread's values 256 floats apart, conflict-free). A rebuilt
//    entry of c feeds 3 x 128 tensor-core products; 256 rows would halve
//    the rebuild but needs 128 more registers a thread for the partial;
//  - pipeline: the j sweep runs through a ring of 4 shared-memory stages
//    (W_hi, W_lo and the 32 training points' coordinates: 34.5 KB a
//    stage), filled by one TMA thread and handed over with mbarriers. The
//    producer warpgroup hands registers to the consumers (setmaxnreg). A
//    consumer warpgroup issues a stage's 12 products as one wgmma group
//    and rebuilds the next stage's A fragments while they run;
//  - W is split once per call in device memory (tf32_split_kernel, one
//    pass: 2 n^2 bytes read, 8 n^2 bytes written), which also zeroes the
//    strict upper triangle and the padding, so the diagonal tile needs no
//    mask and entries beyond n arrive as zeros (TMA fills out-of-range
//    boxes with zeros). Every query tile of 128 re-reads the lower
//    triangles of W_hi and W_lo (4 n^2 bytes); blocks walk the same (k, j)
//    order, so co-resident blocks meet the same tiles in the 50 MB L2;
//  - triangle: k tiles run in order and j stops at the tile's last row;
//  - epilogue: after each k tile, y^2 is summed across the tile's 128
//    columns into two per-thread row sums; a 4-lane shuffle finishes each
//    query's sum and quad (m,) is written directly, with no atomics.
#include <cuda.h>   // CUtensorMap and its enums; the driver entry point is
                    // fetched at run time, so nothing links against libcuda

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// "highest": exact fp32 on the CUDA cores
// ---------------------------------------------------------------------------

namespace fp {
constexpr int kTileQ = 128;     // queries per block
constexpr int kTileK = 256;     // factor rows per k tile
constexpr int kHalfK = 128;     // factor rows per half of a k tile
constexpr int kChunkJ = 64;     // factor columns per stage, one fp32 fold
constexpr int kThreads = 256;   // 16 x 16 threads, 8 x 8 outputs a half each
constexpr int kGroups = 16;     // threads that share a query group
constexpr int kRebuildJ = kChunkJ * kTileQ / kThreads;   // entries a thread
constexpr int kTransposeTile = 32;
constexpr int kSmemFloats = gpemu::kMaxD * kTileQ +      // s_q
                            2 * gpemu::kMaxD * kChunkJ + // s_t
                            2 * kChunkJ * kTileQ +       // s_c
                            2 * kChunkJ * kTileK;        // s_w
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
}  // namespace fp

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// W (n x n, row-major, W in its lower triangle) -> wt (ld x ld):
// wt[j][k] = W(k, j) for j <= k < n, else 0. Tiles of wt that no k tile's
// sweep reaches (j past the k tile's last row) are not written.
__global__ void __launch_bounds__(256)
w_transpose_kernel(const float* __restrict__ w, float* __restrict__ wt,
                   int n, int ld) {
  __shared__ float tile[fp::kTransposeTile][fp::kTransposeTile + 1];
  const int k0 = blockIdx.x * fp::kTransposeTile;
  const int j0 = blockIdx.y * fp::kTransposeTile;
  if (j0 > (k0 | (fp::kTileK - 1))) return;
  const int tx = threadIdx.x % fp::kTransposeTile;
  const int ty = threadIdx.x / fp::kTransposeTile;
  for (int r = ty; r < fp::kTransposeTile; r += 256 / fp::kTransposeTile) {
    const int k = k0 + r, j = j0 + tx;
    tile[r][tx] = (k < n && j <= k) ? w[static_cast<size_t>(k) * n + j] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < fp::kTransposeTile; r += 256 / fp::kTransposeTile)
    wt[static_cast<size_t>(j0 + r) * ld + k0 + tx] = tile[tx][r];
}

// First factor row of the block's k tile number idx: its pairs are
// p = split, split + splits, ..., each giving tiles p and tiles - 1 - p.
__device__ __forceinline__ int k_tile_start(int idx, int split, int splits,
                                            int tiles) {
  const int p = split + (idx >> 1) * splits;
  return ((idx & 1) ? tiles - 1 - p : p) * fp::kTileK;
}

// xt_t: (d, ld) the delta-scaled training inputs transposed, zero-padded;
// wt: (ld, ld) from w_transpose_kernel; out: (splits, m) partials of quad
// (quad itself for one split). ld is a multiple of kTileK.
__global__ void __launch_bounds__(fp::kThreads, 1)
corr_quad_fp32_kernel(const float* __restrict__ xs,
                      const float* __restrict__ xt_t,
                      const float* __restrict__ wt, float* __restrict__ out,
                      int m, int n, int d, int ld, int splits) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                                      // [l][query]
  float* s_t = s_q + gpemu::kMaxD * fp::kTileQ;           // [buf][l][j]
  float* s_c = s_t + 2 * gpemu::kMaxD * fp::kChunkJ;      // [buf][j][query]
  float* s_w = s_c + 2 * fp::kChunkJ * fp::kTileQ;        // [buf][j][k]
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * fp::kTileQ;
  const int split = blockIdx.y;
  const int tiles = ld / fp::kTileK;
  const int pairs = (tiles + 1) / 2;
  int my_tiles = 0;
  for (int p = split; p < pairs; p += splits)
    my_tiles += (tiles - 1 - p != p) ? 2 : 1;

  for (int e = tid; e < fp::kTileQ * d; e += fp::kThreads) {
    const int i = e / d, l = e - i * d;
    s_q[l * fp::kTileQ + i] =
        q0 + i < m ? xs[static_cast<size_t>(q0 + i) * d + l] : 0.f;
  }

  // the chunk stream: (local k tile, first factor row, first column)
  struct Chunk {
    int idx, k0, j0;
  };
  auto advance = [&](Chunk c) {
    c.j0 += fp::kChunkJ;
    if (c.j0 >= min(n, c.k0 + fp::kTileK)) {   // W(k, j) = 0 for j > k
      ++c.idx;
      c.j0 = 0;
      c.k0 = c.idx < my_tiles ? k_tile_start(c.idx, split, splits, tiles) : 0;
    }
    return c;
  };
  auto load_w = [&](const Chunk& c, int buf) {
    float* dst = s_w + buf * fp::kChunkJ * fp::kTileK;
    for (int e = tid; e < fp::kChunkJ * fp::kTileK / 4; e += fp::kThreads) {
      const int jj = e / (fp::kTileK / 4), k4 = e % (fp::kTileK / 4);
      cp_async16(dst + jj * fp::kTileK + 4 * k4,
                 wt + static_cast<size_t>(c.j0 + jj) * ld + c.k0 + 4 * k4);
    }
  };
  auto load_t = [&](const Chunk& c, int buf) {
    float* dst = s_t + buf * gpemu::kMaxD * fp::kChunkJ;
    for (int e = tid; e < d * (fp::kChunkJ / 4); e += fp::kThreads) {
      const int l = e / (fp::kChunkJ / 4), v = e % (fp::kChunkJ / 4);
      cp_async16(dst + l * fp::kChunkJ + 4 * v,
                 xt_t + static_cast<size_t>(l) * ld + c.j0 + 4 * v);
    }
  };
  // rebuild: query ci (consecutive across a warp), chunk columns
  // cj .. cj + kRebuildJ - 1 (the same for the whole warp: broadcasts)
  const int ci = tid % fp::kTileQ;
  const int cj = (tid / fp::kTileQ) * fp::kRebuildJ;
  auto rebuild = [&](int buf) {
    const float* st = s_t + buf * gpemu::kMaxD * fp::kChunkJ + cj;
    float d2[fp::kRebuildJ];
#pragma unroll
    for (int jj = 0; jj < fp::kRebuildJ; ++jj) d2[jj] = 0.f;
    for (int l = 0; l < d; ++l) {
      const float q = s_q[l * fp::kTileQ + ci];
      const float4* t4 = reinterpret_cast<const float4*>(st + l * fp::kChunkJ);
#pragma unroll
      for (int v = 0; v < fp::kRebuildJ / 4; ++v) {
        const float4 t = t4[v];
        float u = q - t.x;
        d2[4 * v] = fmaf(u, u, d2[4 * v]);
        u = q - t.y;
        d2[4 * v + 1] = fmaf(u, u, d2[4 * v + 1]);
        u = q - t.z;
        d2[4 * v + 2] = fmaf(u, u, d2[4 * v + 2]);
        u = q - t.w;
        d2[4 * v + 3] = fmaf(u, u, d2[4 * v + 3]);
      }
    }
    float* sc = s_c + buf * fp::kChunkJ * fp::kTileQ + ci;
#pragma unroll
    for (int jj = 0; jj < fp::kRebuildJ; ++jj)
      sc[(cj + jj) * fp::kTileQ] = expf(-d2[jj]);
  };

  // contraction: queries 4 ty .. 4 ty + 3 and 64 + 4 ty .. 64 + 4 ty + 3,
  // factor rows 4 tx .. and 64 + 4 tx .. of each half of the k tile
  const int tx = tid % fp::kGroups;
  const int ty = tid / fp::kGroups;
  float y[2][8][8], sumsq[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    sumsq[a] = 0.f;
#pragma unroll
    for (int b = 0; b < 8; ++b) y[0][a][b] = y[1][a][b] = 0.f;
  }

  Chunk cur{0, k_tile_start(0, split, splits, tiles), 0};
  Chunk nxt = advance(cur);
  load_w(cur, 0);
  load_t(cur, 0);
  if (nxt.idx < my_tiles) load_t(nxt, 1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();   // s_q, and the first stage
  rebuild(0);
  __syncthreads();
  // at the top of step g: c and Wt of chunk g in buffer g % 2, the
  // coordinates of chunk g + 1 in the other
  for (int b = 0; cur.idx < my_tiles; b ^= 1) {
    const Chunk nxt2 = advance(nxt);
    if (nxt.idx < my_tiles) {
      load_w(nxt, b ^ 1);
      if (nxt2.idx < my_tiles) load_t(nxt2, b);
      cp_async_commit();
      rebuild(b ^ 1);
    }
    const float* sc = s_c + b * fp::kChunkJ * fp::kTileQ;
    // the two halves of the k tile in turn, on the same rebuilt c
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* sw = s_w + b * fp::kChunkJ * fp::kTileK + h * fp::kHalfK;
      float part[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) part[a][bb] = 0.f;
#pragma unroll 16
      for (int jj = 0; jj < fp::kChunkJ; ++jj) {
        const float4 c0 = *reinterpret_cast<const float4*>(sc + jj * fp::kTileQ + 4 * ty);
        const float4 c1 = *reinterpret_cast<const float4*>(sc + jj * fp::kTileQ + 64 + 4 * ty);
        const float4 w0 = *reinterpret_cast<const float4*>(sw + jj * fp::kTileK + 4 * tx);
        const float4 w1 = *reinterpret_cast<const float4*>(sw + jj * fp::kTileK + 64 + 4 * tx);
        const float cc[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float ww[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int bb = 0; bb < 8; ++bb) part[a][bb] = fmaf(cc[a], ww[bb], part[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) y[h][a][bb] += part[a][bb];
    }
    if (nxt.idx != cur.idx) {   // the k tile's last chunk
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int bb = 0; bb < 8; ++bb) {
            sumsq[a] = fmaf(y[h][a][bb], y[h][a][bb], sumsq[a]);
            y[h][a][bb] = 0.f;
          }
    }
    cp_async_wait_all();
    __syncthreads();
    cur = nxt;
    nxt = nxt2;
  }

  // lanes 0-15 and 16-31 of a warp each hold one query group: sum over tx
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int off = fp::kGroups / 2; off > 0; off >>= 1)
      sumsq[a] += __shfl_xor_sync(0xffffffffu, sumsq[a], off);
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int gq = q0 + (a < 4 ? 4 * ty + a : 64 + 4 * ty + a - 4);
      if (gq < m) out[static_cast<size_t>(split) * m + gq] = sumsq[a];
    }
  }
}

// quad(i) = sum over splits of partial(s, i), in split order
__global__ void quad_combine_kernel(const float* __restrict__ partial,
                                    float* __restrict__ quad, int m,
                                    int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[static_cast<size_t>(p) * m + i];
  quad[i] = s;
}

// ---------------------------------------------------------------------------
// "high": 3xTF32 through wgmma
// ---------------------------------------------------------------------------

namespace tc {
constexpr int kWarpgroups = 2;                 // consumer warpgroups
constexpr int kTileQ = 64 * kWarpgroups;       // queries per block
constexpr int kTileK = 128;                    // factor rows per k tile (wgmma N)
constexpr int kAcc = kTileK / 2;               // fp32 accumulators a thread
constexpr int kChunkJ = 32;                    // factor columns per stage
constexpr int kSteps = kChunkJ / 8;            // wgmma k8 steps per stage
constexpr int kStages = 4;
constexpr int kFoldStages = 4;                // stages a partial sums on the tensor cores
constexpr int kConsumerWarps = 4 * kWarpgroups;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + a producer warpgroup
// registers a thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 64 K
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kWTile = kTileK * kChunkJ;       // floats in one W box
constexpr int kTTile = gpemu::kMaxD * kChunkJ; // floats in one coordinate box
constexpr int kAlign = 1024;                   // 128-byte swizzle atom
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr size_t kSmemBytes =
    kAlign + sizeof(float) * (2 * kStages * kWTile + kStages * kTTile +
                              kAcc * kConsumers + gpemu::kMaxD * kTileQ) +
    2 * kStages * sizeof(uint64_t);
}  // namespace tc

// fp32 -> TF32 rounded to nearest, ties away from zero (cvt.rna.tf32.f32
// on finite inputs), as an fp32 bit pattern with the low 13 bits zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that never
// ends would hang the card; after ~2^26 polls (seconds) the kernel traps,
// which the next synchronisation reports as an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// TMA: one 2-D box at coordinates (c0 innermost, c1) into shared memory,
// completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile written by TMA with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart. The leading
// byte offset is unused for this layout (1 by convention).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3ffff) >> 4) |
         (uint64_t{1} << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
__device__ __forceinline__ void fence_regs(float (&d)[tc::kAcc]) {
#pragma unroll
  for (int i = 0; i < tc::kAcc; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d(64 x 128) (+)= A(64 x 8, registers) * B(8 x 128, shared memory), TF32
// inputs, fp32 accumulators; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[tc::kAcc],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc_b,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// W (n x n, row-major) -> hi, lo (n x ld): TF32 split of the lower
// triangle; the strict upper triangle (never read) and the padding j >= n
// become zeros
__global__ void tf32_split_kernel(const float* __restrict__ w,
                                  float* __restrict__ hi,
                                  float* __restrict__ lo, int n, int ld) {
  const int64_t total = static_cast<int64_t>(n) * ld;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(e / ld);
    const int j = static_cast<int>(e - static_cast<int64_t>(k) * ld);
    uint32_t h = 0u, l = 0u;
    if (j <= k) {
      const float x = w[static_cast<int64_t>(k) * n + j];
      h = tf32_rna(x);
      l = tf32_rna(x - __uint_as_float(h));
    }
    hi[e] = __uint_as_float(h);
    lo[e] = __uint_as_float(l);
  }
}

// The A fragments of one stage's kSteps k8 steps: c(i, j) for rows `row`
// and `row + 8` of the warpgroup's queries and, in step s, columns
// j = 8 s + col and 8 s + col + 4 of the stage (st: its training points,
// [l][j]), split into TF32 hi and lo. Fragment order: (row, j),
// (row + 8, j), (row, j + 4), (row + 8, j + 4).
__device__ __forceinline__ void rebuild_a(const float* q_a, const float* q_b,
                                          const float* st, int col, int d,
                                          uint32_t (&hi)[tc::kSteps][4],
                                          uint32_t (&lo)[tc::kSteps][4]) {
  float d2[tc::kSteps][4];
#pragma unroll
  for (int s = 0; s < tc::kSteps; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) d2[s][i] = 0.f;
  for (int l = 0; l < d; ++l) {
    const float qa = q_a[l * tc::kTileQ], qb = q_b[l * tc::kTileQ];
    const float* tl = st + l * tc::kChunkJ + col;
#pragma unroll
    for (int s = 0; s < tc::kSteps; ++s) {
      const float ta = tl[8 * s], tb = tl[8 * s + 4];
      float u = qa - ta;
      d2[s][0] = fmaf(u, u, d2[s][0]);
      u = qb - ta;
      d2[s][1] = fmaf(u, u, d2[s][1]);
      u = qa - tb;
      d2[s][2] = fmaf(u, u, d2[s][2]);
      u = qb - tb;
      d2[s][3] = fmaf(u, u, d2[s][3]);
    }
  }
#pragma unroll
  for (int s = 0; s < tc::kSteps; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = expf(-d2[s][i]);
      hi[s][i] = tf32_rna(c);
      lo[s][i] = tf32_rna(c - __uint_as_float(hi[s][i]));
    }
}

__global__ void __launch_bounds__(tc::kThreads, 1)
corr_quad_tf32x3_kernel(const __grid_constant__ CUtensorMap w_hi_map,
                        const __grid_constant__ CUtensorMap w_lo_map,
                        const __grid_constant__ CUtensorMap t_map,
                        const float* __restrict__ xs,
                        float* __restrict__ quad, int m, int n, int d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((tc::kAlign - (smem_addr(smem_raw) & (tc::kAlign - 1))) & (tc::kAlign - 1));
  float* s_w = reinterpret_cast<float*>(base);   // [stage][hi, lo][k][j]
  float* s_t = s_w + 2 * tc::kStages * tc::kWTile;       // [stage][l][j]
  float* s_y = s_t + tc::kStages * tc::kTTile;           // [i][consumer]
  float* s_q = s_y + tc::kAcc * tc::kConsumers;          // [l][query]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_q + gpemu::kMaxD * tc::kTileQ);
  uint64_t* empty = full + tc::kStages;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * tc::kTileQ;
  if (tid == 0) {
    for (int s = 0; s < tc::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], tc::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < tc::kTileQ * d; e += tc::kThreads) {
    const int i = e / d, l = e - i * d;
    s_q[l * tc::kTileQ + i] =
        q0 + i < m ? xs[static_cast<size_t>(q0 + i) * d + l] : 0.f;
  }
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  if (warp >= tc::kConsumerWarps) {
    // producer warpgroup: gives up registers; one thread keeps the ring of
    // stages filled
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(tc::kProducerRegs));
    if (warp == tc::kConsumerWarps && lane == 0) {
      const uint32_t tx_bytes = sizeof(float) * (2 * tc::kWTile + d * tc::kChunkJ);
      int stage = 0;
      uint32_t phase = 0;
      for (int k0 = 0; k0 < n; k0 += tc::kTileK) {
        const int j_end = min(n, k0 + tc::kTileK);
        for (int j0 = 0; j0 < j_end; j0 += tc::kChunkJ) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], tx_bytes);
          tma_load_2d(s_w + (2 * stage) * tc::kWTile, &w_hi_map, &full[stage], j0, k0);
          tma_load_2d(s_w + (2 * stage + 1) * tc::kWTile, &w_lo_map, &full[stage], j0, k0);
          tma_load_2d(s_t + stage * tc::kTTile, &t_map, &full[stage], j0, 0);
          if (++stage == tc::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(tc::kConsumerRegs));
  // consumers: warpgroup wg owns queries 64 wg .. 64 wg + 63. In the
  // m64n128k8 fragments a thread holds rows `row` and `row + 8` (A: columns
  // col and col + 4 of each k8 step; y: two columns of every 8).
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int col = lane % 4;
  const float* q_a = s_q + row;
  const float* q_b = s_q + row + 8;
  float part[tc::kAcc];    // kFoldStages stages' products, tensor cores
#pragma unroll
  for (int i = 0; i < tc::kAcc; ++i) part[i] = 0.f;
  // y(i, k) for the k tile, summed on the CUDA cores: this thread's kAcc
  // values, tid apart (conflict-free)
  float* y = s_y + tid;
  float sum_a = 0.f, sum_b = 0.f;
  // A fragments of two stages: the next stage's are rebuilt in one set
  // while the products of this stage, which read the other, run
  uint32_t a_hi[2][tc::kSteps][4], a_lo[2][tc::kSteps][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int k0 = 0; k0 < n; k0 += tc::kTileK) {
    const int j_end = min(n, k0 + tc::kTileK);   // W(k, j) = 0 for j > k
    const int chunks = (j_end + tc::kChunkJ - 1) / tc::kChunkJ;
#pragma unroll
    for (int i = 0; i < tc::kAcc; ++i) y[i * tc::kConsumers] = 0.f;
    mbar_wait(&full[stage], phase);
    rebuild_a(q_a, q_b, s_t + stage * tc::kTTile, col, d, a_hi[0], a_lo[0]);
    // one stage: its 3 x kSteps products in one wgmma group, the next
    // stage's rebuild while they run; every kFoldStages stages (and at the
    // k tile's last) the tensor-core partial folds into y
    auto run_stage = [&](auto buf, int c) {
      constexpr int b = decltype(buf)::value;   // c % 2
      const uint64_t desc_hi = sw128_desc(s_w + (2 * stage) * tc::kWTile);
      const uint64_t desc_lo = sw128_desc(s_w + (2 * stage + 1) * tc::kWTile);
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < tc::kSteps; ++s) {
        // step s starts 8 columns (32 bytes, 2 descriptor units) further
        // into the swizzled rows
        const uint64_t koff = 2 * s;
        wgmma_m64n128k8_tf32(part, a_hi[b][s], desc_hi + koff,
                             s > 0 || c % tc::kFoldStages != 0);
        wgmma_m64n128k8_tf32(part, a_hi[b][s], desc_lo + koff, 1);
        wgmma_m64n128k8_tf32(part, a_lo[b][s], desc_hi + koff, 1);
      }
      wgmma_commit();
      const int next = stage + 1 == tc::kStages ? 0 : stage + 1;
      const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
      if (c + 1 < chunks) {
        mbar_wait(&full[next], next_phase);
        rebuild_a(q_a, q_b, s_t + next * tc::kTTile, col, d, a_hi[1 - b],
                  a_lo[1 - b]);
      }
      wgmma_wait_all();
      fence_regs(part);
      // this warp's products on the stage are done: hand it back
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      stage = next;
      phase = next_phase;
      if (c % tc::kFoldStages == tc::kFoldStages - 1 || c + 1 == chunks) {
#pragma unroll
        for (int i = 0; i < tc::kAcc; ++i) y[i * tc::kConsumers] += part[i];
      }
    };
    for (int c = 0; c < chunks; c += 2) {
      run_stage(std::integral_constant<int, 0>{}, c);
      if (c + 1 < chunks) run_stage(std::integral_constant<int, 1>{}, c + 1);
    }
    // y columns 8 g + 2 col + {0, 1}: y[4 g], y[4 g + 1] on row,
    // y[4 g + 2], y[4 g + 3] on row + 8
#pragma unroll
    for (int g8 = 0; g8 < tc::kAcc / 4; ++g8) {
      float v = y[(4 * g8) * tc::kConsumers];
      sum_a = fmaf(v, v, sum_a);
      v = y[(4 * g8 + 1) * tc::kConsumers];
      sum_a = fmaf(v, v, sum_a);
      v = y[(4 * g8 + 2) * tc::kConsumers];
      sum_b = fmaf(v, v, sum_b);
      v = y[(4 * g8 + 3) * tc::kConsumers];
      sum_b = fmaf(v, v, sum_b);
    }
  }
  // the 4 lanes that share a row hold its k tile's columns between them
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
  }
  if (col == 0) {
    if (q0 + row < m) quad[q0 + row] = sum_a;
    if (q0 + row + 8 < m) quad[q0 + row + 8] = sum_b;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up through the runtime
EncodeTiled encode_tiled() {
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

// TMA map of a row-major fp32 (rows, cols) array with a row stride of ld
// floats, in boxes of box_rows x box_cols; boxes past the edge read zeros
bool make_map(EncodeTiled encode, CUtensorMap* map, const float* data,
              int rows, int cols, int ld, int box_rows, int box_cols,
              CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(data), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The "highest" tier. xs: (m, d) delta-scaled queries; xt_t: (d, ld) the
// delta-scaled training inputs transposed, zero-padded; w: (n, n) with W in
// its lower triangle; wt: (ld, ld) scratch; partial: (splits, m) scratch,
// unused for one split; quad: (m,). All fp32 on the device, ld a multiple
// of 256 and >= n, 1 <= d <= 20, 1 <= splits <= (ld / 256 + 1) / 2.
extern "C" int gp_corr_quad(const float* xs, const float* xt_t, const float* w,
                            float* wt, float* partial, float* quad, int m,
                            int n, int d, int ld, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = ld / fp::kTileK;
  if (ld % fp::kTileK != 0 || ld < n || d < 1 || d > gpemu::kMaxD ||
      splits < 1 || splits > (tiles + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 tgrid(ld / fp::kTransposeTile, ld / fp::kTransposeTile);
  w_transpose_kernel<<<tgrid, 256, 0, s>>>(w, wt, n, ld);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(corr_quad_fp32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(fp::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + fp::kTileQ - 1) / fp::kTileQ, splits);
  corr_quad_fp32_kernel<<<grid, fp::kThreads, fp::kSmemBytes, s>>>(
      xs, xt_t, wt, splits > 1 ? partial : quad, m, n, d, ld, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  quad_combine_kernel<<<(m + 255) / 256, 256, 0, s>>>(partial, quad, m, splits);
  return static_cast<int>(cudaGetLastError());
}

// The "high" tier. xs: (m, d) delta-scaled queries; xt_t: (d, ld) the
// delta-scaled training inputs transposed; w: (n, n) with W in its lower
// triangle; w_split: (2, n, ld) scratch for W_hi, W_lo; quad: (m,). All
// fp32 on the device, 16-byte aligned, ld a multiple of 4 and >= n,
// 1 <= d <= 20.
extern "C" int gp_corr_quad_tf32x3(const float* xs, const float* xt_t,
                                   const float* w, float* w_split, float* quad,
                                   int m, int n, int d, int ld, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w_hi = w_split;
  float* w_lo = w_split + static_cast<size_t>(n) * ld;
  const int64_t total = static_cast<int64_t>(n) * ld;
  const int split_blocks =
      static_cast<int>(std::min<int64_t>((total + 255) / 256, 132 * 32));
  tf32_split_kernel<<<split_blocks, 256, 0, s>>>(w, w_hi, w_lo, n, ld);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap hi_map, lo_map, t_map;
  if (!make_map(encode, &hi_map, w_hi, n, n, ld, tc::kTileK, tc::kChunkJ,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(encode, &lo_map, w_lo, n, n, ld, tc::kTileK, tc::kChunkJ,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(encode, &t_map, xt_t, d, n, ld, d, tc::kChunkJ,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(corr_quad_tf32x3_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(tc::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + tc::kTileQ - 1) / tc::kTileQ);
  corr_quad_tf32x3_kernel<<<grid, tc::kThreads, tc::kSmemBytes, s>>>(
      hi_map, lo_map, t_map, xs, quad, m, n, d);
  return static_cast<int>(cudaGetLastError());
}
