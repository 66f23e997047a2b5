// G = k(X, Z)^T V with k(X, Z) never in device memory: TRON's C^T r and
// C^T (D C d) on the otf_shard plan.
//
// Replaces repro/kernels/kmvp.py::kmvp_t_pallas (body _kmvp_t_kernel, _tile,
// _finish_tile), the TPU kernel behind repro.kernels.ops.kmvp_t and
// otf_kmvp_t.
//
// What bounds it on an H100: operations. It reads X, Z and V once and
// writes only the (m, k) result; what is left is 2 n m d flops of gram
// tiles plus 2 n m k of contraction, in fp32 on the CUDA cores (no TF32, to
// keep the reference's fp32 bar): at (n, m, d, k) = (65536, 16384, 784, 10)
// that is 1.7e12 flops, 25 ms at the card's 67 TFLOP/s.
//
// The design. The TPU kernel adds into G across a sequential grid axis over
// row blocks; on Hopper blocks run in any order, so a block owns one
// 64-point tile of the basis and ALL k columns, and walks the 64-row tiles
// of one fixed span of N_SPLIT rows in order: it computes each gram tile in
// registers (gram_tile.cuh, bitwise the arithmetic of gram.cu and kmvp.cu),
// parks it in shared memory, and contracts E^T V into per-thread fp32
// accumulators. Spans go on blockIdx.y so that the card fills whatever n
// is; a second kernel sums the spans' partial results in span order. No
// float atomics. The tile, slice and span sizes are constants, never
// functions of n, so the result is bitwise the same from run to run.
// Rows past n and points past m are masked in the tile itself: masking V
// alone would not do, because a zero row of X has a nonzero gaussian value.
#include "gram_tile.cuh"

namespace {

constexpr int KMAX = 16;       // right-hand-side columns a block can carry
constexpr int N_SPLIT = 4096;  // rows per span (64 row tiles)

__global__ void __launch_bounds__(rt::THREADS)
kmvp_t_partial(const float* __restrict__ x, const float* __restrict__ z,
               const float* __restrict__ v, float* __restrict__ partial,
               int n, int m, int d, int k, int kind, float two_s2) {
  __shared__ rt::TileSmem s;
  __shared__ float es[rt::TILE][rt::TILE + 1];
  __shared__ float vs[rt::TILE][KMAX];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int col0 = blockIdx.x * rt::TILE;
  const int span0 = blockIdx.y * N_SPLIT;
  const int span1 = min(n, span0 + N_SPLIT);
  // Contraction layout: thread owns basis point c and columns g, g+4, g+8,
  // g+12; a warp reads 32 consecutive points of one tile row of es and
  // broadcasts one word of vs.
  const int c = tid & (rt::TILE - 1);
  const int g = tid >> 6;
  float o[KMAX / 4] = {0.f, 0.f, 0.f, 0.f};

  for (int row0 = span0; row0 < span1; row0 += rt::TILE) {
    float acc[rt::SUB][rt::SUB];
    rt::tile_dot(x, z, n, m, d, row0, col0, s, acc);
    for (int e = tid; e < rt::TILE * KMAX; e += rt::THREADS) {
      const int r = e / KMAX;
      const int kk = e % KMAX;
      vs[r][kk] = (row0 + r < n && kk < k) ? v[(size_t)(row0 + r) * k + kk]
                                           : 0.f;
    }
#pragma unroll
    for (int i = 0; i < rt::SUB; ++i) {
#pragma unroll
      for (int j = 0; j < rt::SUB; ++j) {
        const int rr = ty + 16 * i;
        const int cc = tx + 16 * j;
        es[rr][cc] = (row0 + rr < n && col0 + cc < m)
                         ? rt::finish(acc[i][j], s.xn[rr], s.zn[cc], kind,
                                      two_s2)
                         : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < rt::TILE; ++r) {
      const float e = es[r][c];
#pragma unroll
      for (int q = 0; q < KMAX / 4; ++q) o[q] = fmaf(e, vs[r][g + 4 * q], o[q]);
    }
    __syncthreads();  // the next tile overwrites es, vs, xn, zn
  }
  if (col0 + c < m) {
    float* dst = partial + ((size_t)blockIdx.y * m + col0 + c) * k;
#pragma unroll
    for (int q = 0; q < KMAX / 4; ++q) {
      const int kk = g + 4 * q;
      if (kk < k) dst[kk] = o[q];
    }
  }
}

// out[i] = sum over spans s = 0, 1, ... of partial[s][i], in that order.
__global__ void kmvp_t_reduce(const float* __restrict__ partial,
                              float* __restrict__ out, size_t mk, int spans) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mk) return;
  float acc = partial[i];
  for (int s = 1; s < spans; ++s) acc += partial[(size_t)s * mk + i];
  out[i] = acc;
}

}  // namespace

// Spans of N_SPLIT rows: the partial buffer holds spans * m * k floats.
extern "C" int kmvp_t_spans(int n) { return (n + N_SPLIT - 1) / N_SPLIT; }

extern "C" int kmvp_t_max_k() { return KMAX; }

// x (n, d), z (m, d), v (n, k), out (m, k), partial (spans, m, k): contiguous
// fp32 on the calling thread's current CUDA device (the caller sets it),
// n >= 1, 1 <= k <= KMAX. Launches both passes on `stream` and returns the
// first cudaError_t (0 = success).
extern "C" int kmvp_t_launch(const float* x, const float* z, const float* v,
                             float* out, float* partial, int n, int m, int d,
                             int k, int kind, float two_s2, void* stream) {
  if (m <= 0) return 0;
  if (n <= 0 || k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  const int spans = kmvp_t_spans(n);
  if (spans > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((m + rt::TILE - 1) / rt::TILE, spans);
  kmvp_t_partial<<<grid, rt::THREADS, 0, st>>>(x, z, v, partial, n, m, d, k,
                                               kind, two_s2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t mk = (size_t)m * k;
  const unsigned blocks = (unsigned)((mk + 255) / 256);
  kmvp_t_reduce<<<blocks, 256, 0, st>>>(partial, out, mk, spans);
  return (int)cudaGetLastError();
}
