// One 64 x 64 tile of the kernel matrix k(X, Z), computed by 256 threads on
// the CUDA cores in IEEE fp32. Shared by gram.cu and kmvp.cu, so the fused
// matvec contracts exactly the values the materializing gram kernel writes.
//
// Thread (ty, tx) = (tid / 16, tid % 16) owns the 4 x 4 elements at rows
// ty + 16 i and columns tx + 16 j of the tile. d is walked in slices of
// BK = 32 staged through shared memory, each slice stored k-major so that in
// the inner loop a warp reads X by broadcast and Z from 16 consecutive words.
// Ragged edges are masked: rows of X past n, rows of Z past m and columns
// past d load as zeros.
//
// The squared-distance expansion |x|^2 + |z|^2 - 2 x.z is the reference's
// (repro.kernels.gram._gram_kernel). It cancels in fp32 when x and z are
// close and large, and the port keeps that behaviour rather than change
// the numbers.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

namespace rt {

constexpr int TILE = 64;      // tile rows (queries) and columns (basis points)
constexpr int BK = 32;        // d-slice staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int SUB = 4;        // each thread holds a SUB x SUB sub-tile
constexpr int GAUSSIAN = 0;
constexpr int LINEAR = 1;

struct TileSmem {
  float xs[BK][TILE + 1];     // +1 keeps the transposing stores conflict-free
  float zs[BK][TILE + 1];
  float xn[TILE];             // squared norms of the tile's X rows
  float zn[TILE];             // squared norms of the tile's Z rows
};

// Accumulates acc[i][j] = x_r . z_c over all of d (r = row0 + ty + 16 i,
// c = col0 + tx + 16 j) and leaves the rows' and columns' squared norms in
// s.xn / s.zn. Each sum runs over d in index order, whatever n is, so an
// element's value does not depend on the batch it was computed in.
__device__ __forceinline__ void tile_dot(
    const float* __restrict__ x, const float* __restrict__ z,
    int n, int m, int d, int row0, int col0, TileSmem& s,
    float (&acc)[SUB][SUB]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < SUB; ++i)
#pragma unroll
    for (int j = 0; j < SUB; ++j) acc[i][j] = 0.f;
  float norm = 0.f;  // threads 0..63: an X row's norm; 64..127: a Z row's

  for (int k0 = 0; k0 < d; k0 += BK) {
    // Stage a TILE x BK slice of X and of Z; a warp reads 32 consecutive
    // floats of one row, so the loads coalesce.
    for (int e = tid; e < TILE * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      const int gc = k0 + c;
      const int gx = row0 + r;
      const int gz = col0 + r;
      s.xs[c][r] = (gx < n && gc < d) ? x[(size_t)gx * d + gc] : 0.f;
      s.zs[c][r] = (gz < m && gc < d) ? z[(size_t)gz * d + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[SUB], b[SUB];
#pragma unroll
      for (int i = 0; i < SUB; ++i) a[i] = s.xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < SUB; ++j) b[j] = s.zs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < SUB; ++i)
#pragma unroll
        for (int j = 0; j < SUB; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (tid < TILE) {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float v = s.xs[k][tid];
        norm = fmaf(v, v, norm);
      }
    } else if (tid < 2 * TILE) {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float v = s.zs[k][tid - TILE];
        norm = fmaf(v, v, norm);
      }
    }
    __syncthreads();  // the next slice overwrites xs / zs
  }
  if (tid < TILE) {
    s.xn[tid] = norm;
  } else if (tid < 2 * TILE) {
    s.zn[tid - TILE] = norm;
  }
  __syncthreads();
}

// The kernel value from the accumulated cross term: exp(-max(d2, 0) / 2s^2)
// with d2 = |x|^2 + |z|^2 - 2 x.z (gaussian), or x.z itself (linear).
__device__ __forceinline__ float finish(float xz, float xn, float zn,
                                        int kind, float two_s2) {
  if (kind == LINEAR) return xz;
  const float d2 = fmaxf(xn + zn - 2.f * xz, 0.f);
  return expf(-d2 / two_s2);
}

}  // namespace rt
