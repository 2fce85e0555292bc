// Gathers of a submatrix of the Gram for the compact block solve (Hopper,
// sm_90a).
//
// Contract (ops/gather.gather): out (R, C) float32 row-major from G, whose
// rows are ld floats apart,
//   trans == 0:  out[r, c] = G[rows[r], cols[c]]   (G[S, S]: rows = cols = S)
//   trans == 1:  out[r, c] = G[cols[c], rows[r]]   (G[j, S] read as G[S, j],
//                                                  the solver's column j)
// Each output entry is read once and written once: no (R, ld) or (ld, C)
// intermediate exists, which at npad 94,208 and a union of 61,440 would be
// 23 GB beside the 35.5 GB G.
//
// What bounds it on the H100: the bytes, 8 R C (a read and a write of every
// entry), at 3.35 TB/s.  The reads are gathers: row rows[r] of G at the
// ascending ids cols[c], whole 32-byte sectors where the ids are dense (the
// popular ranks) and a sector an entry where they are sparse.
//
// Design.  trans == 0: one block of 256 threads per output row; thread t
// takes the columns t, t + 256, ... (four loads in flight), so a warp's
// writes are 128 consecutive bytes and its reads come from one row of G.
// trans == 1: 32 x 32 tiles through shared memory: a warp reads 32 entries
// G[cols[c], rows[r0 .. r0 + 31]] (consecutive ranks for a block's
// targets: one row, consecutive bytes), and writes 32 consecutive entries
// of an output row after the transpose.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_THREADS = 256;
constexpr int TILE = 32;
constexpr int TILE_ROWS = 8;

__global__ void __launch_bounds__(ROW_THREADS)
gather_rows_kernel(const float* __restrict__ G, long long ld,
                   const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ cols, int C,
                   float* __restrict__ out) {
  const float* src = G + static_cast<long long>(rows[blockIdx.x]) * ld;
  float* dst = out + static_cast<long long>(blockIdx.x) * C;
#pragma unroll 4
  for (int c = threadIdx.x; c < C; c += ROW_THREADS) dst[c] = src[cols[c]];
}

__global__ void __launch_bounds__(TILE * TILE_ROWS)
gather_trans_kernel(const float* __restrict__ G, long long ld,
                    const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ cols, int R, int C,
                    float* __restrict__ out) {
  __shared__ float tile[TILE][TILE + 1];
  const int c0 = blockIdx.x * TILE, r0 = blockIdx.y * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r = r0 + tx;
  const long long rid = r < R ? rows[r] : 0;
#pragma unroll
  for (int i = ty; i < TILE; i += TILE_ROWS) {
    const int c = c0 + i;
    if (c < C && r < R)
      tile[i][tx] = G[static_cast<long long>(cols[c]) * ld + rid];
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < TILE; i += TILE_ROWS) {
    const int rr = r0 + i, c = c0 + tx;
    if (rr < R && c < C)
      out[static_cast<long long>(rr) * C + c] = tile[tx][i];
  }
}

}  // namespace

extern "C" int slim_gather(const float* G, long long ld, const int32_t* rows,
                           int R, const int32_t* cols, int C, int trans,
                           float* out, void* stream) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans) {
    const dim3 grid((C + TILE - 1) / TILE, (R + TILE - 1) / TILE);
    gather_trans_kernel<<<grid, dim3(TILE, TILE_ROWS), 0, s>>>(
        G, ld, rows, cols, R, C, out);
  } else {
    gather_rows_kernel<<<R, ROW_THREADS, 0, s>>>(G, ld, rows, cols, C, out);
  }
  return static_cast<int>(cudaGetLastError());
}
