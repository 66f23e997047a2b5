// C = k(X, Z): the materialized kernel matrix, for the `local` decide arm.
//
// Replaces repro/kernels/gram.py::gram_pallas (body _gram_kernel), the TPU
// kernel behind repro.kernels.ops.gram.
//
// What bounds it on an H100: operations. Each of the n * m outputs costs
// 2 d flops and is written once (4 bytes), so at d = 784 the kernel does
// ~390 flops per byte of C; in fp32 on the CUDA cores (no TF32, to keep the
// reference's fp32 bar) the card's 67 TFLOP/s is the limit, not its
// 3.35 TB/s. The design: one block per 64 x 64 output tile, a 4 x 4
// register sub-tile per thread, d staged through shared memory in slices of
// 32, so every value loaded from shared memory feeds 4 FMAs. No tensor
// cores yet (a wgmma/TMA version is later work).
#include "gram_tile.cuh"

namespace {

__global__ void __launch_bounds__(rt::THREADS)
gram_kernel(const float* __restrict__ x, const float* __restrict__ z,
            float* __restrict__ out, int n, int m, int d, int kind,
            float two_s2) {
  __shared__ rt::TileSmem s;
  const int row0 = blockIdx.x * rt::TILE;
  const int col0 = blockIdx.y * rt::TILE;
  float acc[rt::SUB][rt::SUB];
  rt::tile_dot(x, z, n, m, d, row0, col0, s, acc);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < rt::SUB; ++i) {
    const int r = ty + 16 * i;
    if (row0 + r >= n) continue;
#pragma unroll
    for (int j = 0; j < rt::SUB; ++j) {
      const int c = tx + 16 * j;
      if (col0 + c >= m) continue;
      out[(size_t)(row0 + r) * m + col0 + c] =
          rt::finish(acc[i][j], s.xn[r], s.zn[c], kind, two_s2);
    }
  }
}

}  // namespace

// x (n, d), z (m, d), out (n, m): contiguous fp32 on the calling thread's
// current CUDA device (the caller sets it). Launches on `stream` and returns
// the launch's cudaError_t (0 = success).
extern "C" int gram_launch(const float* x, const float* z, float* out, int n,
                           int m, int d, int kind, float two_s2,
                           void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const int row_tiles = (n + rt::TILE - 1) / rt::TILE;
  const int col_tiles = (m + rt::TILE - 1) / rt::TILE;
  if (col_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(row_tiles, col_tiles);
  gram_kernel<<<grid, rt::THREADS, 0, (cudaStream_t)stream>>>(
      x, z, out, n, m, d, kind, two_s2);
  return (int)cudaGetLastError();
}
