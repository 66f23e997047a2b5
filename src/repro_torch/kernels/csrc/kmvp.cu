// O = k(X, Z) B with k(X, Z) never in device memory: the fused decide arm.
//
// Replaces repro/kernels/kmvp.py::kmvp_fwd_pallas (body _kmvp_fwd_kernel,
// _tile, _finish_tile), the TPU kernel behind repro.kernels.ops.kmvp_fwd
// and otf_kmvp_fwd.
//
// What bounds it on an H100: operations, as for gram.cu. It reads X, Z and
// B once and writes only the (n, k) margins, so its bytes are a factor
// ~m / k below the materializing path's; what is left is 2 n m d flops of
// gram tiles plus 2 n m k of contraction, in fp32 on the CUDA cores.
//
// The design. The TPU kernel adds into O across a sequential grid axis; on
// Hopper blocks run in any order, so a block owns 64 query rows and ALL k
// output columns, and loops over the 64-wide tiles of one fixed span of
// M_SPLIT basis points in order: it computes each gram tile in registers
// (gram_tile.cuh, the same arithmetic as gram.cu), parks it in shared
// memory, and contracts it with the tile's rows of B into a per-thread fp32
// accumulator. Spans are split over blockIdx.y so that a small batch still
// fills the card; a second kernel then sums the spans' partial margins in
// span order. No float atomics. The tile, slice and span sizes are
// constants, never functions of n, so a row's margin is bitwise the same
// in every batch that carries it, which the bucketed server relies on.
#include "gram_tile.cuh"

namespace {

constexpr int KMAX = 16;      // right-hand-side columns a block can carry
constexpr int M_SPLIT = 512;  // basis points per span (8 tiles)

__global__ void __launch_bounds__(rt::THREADS)
kmvp_fwd_partial(const float* __restrict__ x, const float* __restrict__ z,
                 const float* __restrict__ b, float* __restrict__ partial,
                 int n, int m, int d, int k, int kind, float two_s2) {
  __shared__ rt::TileSmem s;
  __shared__ float es[rt::TILE][rt::TILE + 1];
  __shared__ float bs[rt::TILE][KMAX];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * rt::TILE;
  const int span0 = blockIdx.y * M_SPLIT;
  const int span1 = min(m, span0 + M_SPLIT);
  // Contraction layout: thread owns row r and columns g, g+4, g+8, g+12.
  const int r = tid & (rt::TILE - 1);
  const int g = tid >> 6;
  float o[KMAX / 4] = {0.f, 0.f, 0.f, 0.f};

  for (int col0 = span0; col0 < span1; col0 += rt::TILE) {
    float acc[rt::SUB][rt::SUB];
    rt::tile_dot(x, z, n, m, d, row0, col0, s, acc);
    for (int e = tid; e < rt::TILE * KMAX; e += rt::THREADS) {
      const int c = e / KMAX;
      const int kk = e % KMAX;
      bs[c][kk] = (col0 + c < m && kk < k) ? b[(size_t)(col0 + c) * k + kk]
                                           : 0.f;
    }
#pragma unroll
    for (int i = 0; i < rt::SUB; ++i) {
#pragma unroll
      for (int j = 0; j < rt::SUB; ++j) {
        const int rr = ty + 16 * i;
        const int c = tx + 16 * j;
        es[rr][c] = (col0 + c < m)
                        ? rt::finish(acc[i][j], s.xn[rr], s.zn[c], kind, two_s2)
                        : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < rt::TILE; ++c) {
      const float e = es[r][c];
#pragma unroll
      for (int q = 0; q < KMAX / 4; ++q) o[q] = fmaf(e, bs[c][g + 4 * q], o[q]);
    }
    __syncthreads();  // the next tile overwrites es, bs, xn, zn
  }
  if (row0 + r < n) {
    float* dst = partial + ((size_t)blockIdx.y * n + row0 + r) * k;
#pragma unroll
    for (int q = 0; q < KMAX / 4; ++q) {
      const int kk = g + 4 * q;
      if (kk < k) dst[kk] = o[q];
    }
  }
}

// out[i] = sum over spans s = 0, 1, ... of partial[s][i], in that order.
__global__ void kmvp_fwd_reduce(const float* __restrict__ partial,
                                float* __restrict__ out, size_t nk,
                                int spans) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nk) return;
  float acc = partial[i];
  for (int s = 1; s < spans; ++s) acc += partial[(size_t)s * nk + i];
  out[i] = acc;
}

}  // namespace

// Spans of M_SPLIT basis points: the partial buffer holds spans * n * k floats.
extern "C" int kmvp_fwd_spans(int m) { return (m + M_SPLIT - 1) / M_SPLIT; }

extern "C" int kmvp_fwd_max_k() { return KMAX; }

// x (n, d), z (m, d), b (m, k), out (n, k), partial (spans, n, k): contiguous
// fp32 on the calling thread's current CUDA device (the caller sets it),
// 1 <= k <= KMAX. Launches both passes on `stream` and returns the first
// cudaError_t (0 = success).
extern "C" int kmvp_fwd_launch(const float* x, const float* z, const float* b,
                               float* out, float* partial, int n, int m, int d,
                               int k, int kind, float two_s2, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > KMAX || m <= 0) return (int)cudaErrorInvalidValue;
  const int spans = kmvp_fwd_spans(m);
  if (spans > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((n + rt::TILE - 1) / rt::TILE, spans);
  kmvp_fwd_partial<<<grid, rt::THREADS, 0, st>>>(x, z, b, partial, n, m, d, k,
                                                 kind, two_s2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t nk = (size_t)n * k;
  const unsigned blocks = (unsigned)((nk + 255) / 256);
  kmvp_fwd_reduce<<<blocks, 256, 0, st>>>(partial, out, nk, spans);
  return (int)cudaGetLastError();
}
