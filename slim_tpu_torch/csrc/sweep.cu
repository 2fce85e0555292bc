// One cyclic coordinate-descent sweep for a block of B item columns against
// the shared Gram matrix G, row-major operands (Hopper, sm_90a).
//
// Replaces slim_tpu/ops/pallas_cd.py · _sweep_kernel / pallas_cd_sweeps:
// gj/x/q/act are (B, npad), regs (B, 5); 128-wide chunks are visited in
// perm order and skipped where has == 0.  (The coordinate-major wide-block
// sweep is csrc/sweep_large.cu.)
//
// Per chunk of 128 coordinates at `base`, for every live column b:
//   GS chain (in order i = 0..127, masked by act * live):
//     x_i <- max(gj_i - q_i + d_i x_i - l1, 0) / (d_i + l2)
//     q_j += dx_i * G[base+i, base+j] for the later j of the chunk
//   propagation: q[:, all npad] += dx(chunk) . G[chunk rows, :]
// and at the sweep end a column dies when sum(dx^2) < optTol or t0+1 >= cap.
//
// What bounds it on the H100: the propagation, 2*npad*B*128 FLOP per
// active chunk, while the GS chain is a latency-bound sequential recurrence
// per column.  At the synth path's npad 384 both are microseconds and the
// launches dominate.  Every active chunk's deltas reach every q row before
// the next chunk starts, in f32.
//
// Design: two launches per chunk on the caller's stream, looped on the host
// inside slim_cd_sweep (one ctypes call per sweep), both reading perm/has
// from device memory so no host sync is needed:
//   gs_kernel: one thread per column; the 128x128 diagonal block of G and
//     a per-thread copy of the chunk's q (layout [j][thread]) sit in shared
//     memory (96 KB); deltas go to dxbuf (128, B).
//   prop_kernel: a 128x128-tile register-blocked f32 FMA product
//     q(B x npad) += dxbuf^T G[chunk rows, :], whose G rows are shared by
//     all B columns of the tile (no per-column re-read of G).
// A chunk with has == 0 costs two empty launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

constexpr int CH = 128;          // coordinates per chunk
constexpr int GS_THREADS = 64;   // columns per GS block
constexpr int GS_SMEM = (CH * CH + CH * GS_THREADS) * 4;
constexpr int BM = 128, BN = 128, BK = 8, PT = 256;

__global__ void __launch_bounds__(GS_THREADS)
gs_kernel(const float* __restrict__ G,
          const float* __restrict__ gj, const int8_t* __restrict__ act,
          const float* __restrict__ diag, float* __restrict__ x,
          const float* __restrict__ q, const float* __restrict__ live,
          const float* __restrict__ regs, const int32_t* __restrict__ perm,
          const int32_t* __restrict__ has, int pos, int B, int npad,
          float* __restrict__ dxbuf, float* __restrict__ dltx) {
  if (has[pos] == 0) return;
  const int base = perm[pos] * CH;
  extern __shared__ float smem[];
  float* gcc = smem;             // [i][j]
  float* ql = smem + CH * CH;    // [j][thread]
  const int tid = threadIdx.x;
  const int b = blockIdx.x * GS_THREADS + tid;
  for (int e = tid; e < CH * CH; e += GS_THREADS) {
    gcc[e] = G[static_cast<long long>(base + e / CH) * npad + base + e % CH];
  }
  const bool valid = b < B;
  float l1 = 0.0f, l2 = 0.0f, lv = 0.0f;
  if (valid) {
    l1 = reg(regs, 0, 0, b, B);
    l2 = reg(regs, 0, 1, b, B);
    lv = live[b];
    for (int j = 0; j < CH; ++j) {
      ql[j * GS_THREADS + tid] = q[static_cast<long long>(b) * npad + base + j];
    }
  }
  __syncthreads();
  if (!valid) return;
  float dsum = 0.0f;
  for (int i = 0; i < CH; ++i) {
    const long long a = static_cast<long long>(b) * npad + base + i;
    const float xi = x[a];
    const float ok = static_cast<float>(act[a]) * lv;
    const float di = diag[base + i];
    const float num = gj[a] - ql[i * GS_THREADS + tid] + di * xi;
    const float cand = fmaxf(num - l1, 0.0f) / (di + l2);
    const float delta = ok * (cand - xi);
    if (delta != 0.0f) {
      const float* grow = gcc + i * CH;
      for (int j = i + 1; j < CH; ++j) {
        ql[j * GS_THREADS + tid] += delta * grow[j];
      }
    }
    x[a] = xi + delta;
    dxbuf[static_cast<long long>(i) * B + b] = delta;
    dsum += delta * delta;
  }
  dltx[b] += dsum;
}

// q (B x npad) += P^T Q with P = dxbuf (CH x B) and Q = G's chunk rows
// (CH x npad).
__global__ void __launch_bounds__(PT)
prop_kernel(const float* __restrict__ G, const float* __restrict__ dxbuf,
            float* __restrict__ C, const int32_t* __restrict__ perm,
            const int32_t* __restrict__ has, int pos, int B, int npad) {
  if (has[pos] == 0) return;
  const int base = perm[pos] * CH;
  const float* P = dxbuf;
  const float* Q = G + static_cast<long long>(base) * npad;
  const int M = B, N = npad;
  const int ldp = M, ldq = N;

  __shared__ float Ps[BK][BM];
  __shared__ float Qs[BK][BN];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < CH; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BK * BM) / PT; ++r) {
      const int e = tid + r * PT;
      const int kk = e / BM, mm = e % BM;
      const int gm = m0 + mm, gn = n0 + mm;
      Ps[kk][mm] = gm < M ? P[static_cast<long long>(k0 + kk) * ldp + gm] : 0.0f;
      Qs[kk][mm] = gn < N ? Q[static_cast<long long>(k0 + kk) * ldq + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], bq[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Ps[kk][ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bq[j] = Qs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * bq[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty * 8 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) C[static_cast<long long>(gm) * N + gn] += acc[i][j];
    }
  }
}

}  // namespace

// x and q are updated in place; dltx must arrive zeroed.  npos entries of
// perm/has, one per 128-wide chunk.
extern "C" int slim_cd_sweep(const void* G, const void* gj, const void* act,
                             const void* diag, void* x, void* q,
                             const void* live_in, const void* regs,
                             const void* perm, const void* has, int npos,
                             int B, int npad, void* dxbuf, void* live_out,
                             void* nit, void* dltx, void* stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GS_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 gs_grid((B + GS_THREADS - 1) / GS_THREADS);
  const dim3 p_grid((npad + BN - 1) / BN, (B + BM - 1) / BM);
  const float* Gf = static_cast<const float*>(G);
  const int32_t* pm = static_cast<const int32_t*>(perm);
  const int32_t* hs = static_cast<const int32_t*>(has);
  float* xf = static_cast<float*>(x);
  float* qf = static_cast<float*>(q);
  float* dx = static_cast<float*>(dxbuf);
  for (int pos = 0; pos < npos; ++pos) {
    gs_kernel<<<gs_grid, GS_THREADS, GS_SMEM, s>>>(
        Gf, static_cast<const float*>(gj), static_cast<const int8_t*>(act),
        static_cast<const float*>(diag), xf, qf,
        static_cast<const float*>(live_in), static_cast<const float*>(regs),
        pm, hs, pos, B, npad, dx, static_cast<float*>(dltx));
    prop_kernel<<<p_grid, PT, 0, s>>>(Gf, dx, qf, pm, hs, pos, B, npad);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sweep_end_kernel<<<(B + 255) / 256, 256, 0, s>>>(
      0, static_cast<const float*>(live_in), static_cast<const float*>(regs),
      static_cast<const float*>(dltx), static_cast<float*>(live_out),
      static_cast<float*>(nit), B);
  return static_cast<int>(cudaGetLastError());
}
