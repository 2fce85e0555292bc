// One cyclic coordinate-descent sweep over 512-wide coordinate groups,
// row-major operands (B, npad), with the q flush deferred over windows of K
// consecutive groups of the visit order (Hopper, sm_90a).
//
// Replaces two TPU kernels with one engine:
//   K = K_FLUSH = 4: slim_tpu/ops/pallas_cd.py · _sweep_kernel_large_v3 /
//                    pallas_cd_sweep_large_v3 (deferred-flush)
//   K = 1:           slim_tpu/ops/pallas_cd.py · _sweep_kernel_large /
//                    pallas_cd_sweep_large (eager: each group's deltas
//                    reach all of q right after the group)
//
// Window invariant (pallas_cd.py:619-626): q is exact with respect to every
// group before the current window; the window's own deltas wait in
// dX[slot] (K, GROUP, B).  For each group of the visit order whose `has`
// is set, at window slot s = pos % K:
//   1. load:  qt = q[:, group] + sum_{k < s, has} dX_k^T G[win_k, group]
//   2. GS chain over the group's four 128-wide sub-chunks (masked by
//      act * live); after each sub-chunk its deltas propagate to the later
//      sub-chunks of the tile: qt[:, later] += dx^T G[sub, later]
//   3. the group's deltas stay in dX[s]; a skipped group's slot is left
//      out of every sum (the TPU kernel zeroed it)
//   4. at the window's last slot, if any group of the window had work:
//      q[:, all npad] += sum_{k, has} dX_k^T G[win_k, :]
// and at the sweep end a column dies when sum(dx^2) < optTol or
// t0 + 1 >= cap.  The outputs are x' and q' = x'G, carried exactly.
//
// What bounds it on the H100: the flush, 2 * B * npad * K*512 FLOP per
// window with work (1.7e12 FLOP per all-active sweep at B = 1024,
// npad = 28672, whatever K), an f32 FMA product whose q read-modify-write
// shrinks with K; then the GS chain, a sequential recurrence per column.
// The TPU kernel's DMA, semaphore and panel double-buffering choreography
// staged operands through VMEM and has no counterpart here.  Design:
//   gs_panel_kernel: one thread per column, 64 columns per block.  The
//     128x128 diagonal block of G and the sub-chunk's x, gj, act and q tiles
//     sit in shared memory; the row-major tiles are staged by coalesced
//     loads along the coordinates and stored transposed ([i][column], pitch
//     65 so neither side has bank conflicts), so no chain step reads
//     device memory at a stride of npad.  Deltas go to dX[s] (k-major).
//   panel_gemm_kernel: C_out = C_in + P^T Q over a contraction that walks
//     the window's perm-gathered G row groups, a 128x128-tile
//     register-blocked f32 FMA product (the tile scheme of sweep.cu's
//     prop_kernel).  It serves the load (1), the in-group propagation (2)
//     and the flush (4).
// Every launch reads perm/has from device memory, so one ctypes call
// enqueues a whole sweep with no host sync; a skipped group costs empty
// launches.  Float32 throughout (the TPU dots ran at the MXU's default
// precision).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

constexpr int GROUP = 512;       // coordinates per group
constexpr int CH = 128;          // coordinates per GS sub-chunk
constexpr int GT = 64;           // columns per GS block
constexpr int PITCH = GT + 1;    // shared row pitch of the staged tiles
constexpr int GS_SMEM = CH * CH * 4 + 3 * CH * PITCH * 4 + CH * PITCH;
constexpr int BM = 128, BN = 128, BK = 8, PT = 256;

__global__ void __launch_bounds__(GT)
gs_panel_kernel(const float* __restrict__ G, const float* __restrict__ gj,
                const int8_t* __restrict__ act,
                const float* __restrict__ diag, float* __restrict__ x,
                const float* __restrict__ qt, const float* __restrict__ live,
                const float* __restrict__ regs,
                const int32_t* __restrict__ perm,
                const int32_t* __restrict__ has, int pos, int sub, int B,
                int npad, float* __restrict__ dx,
                float* __restrict__ dltx) {
  if (has[pos] == 0) return;
  const int o = sub * CH;
  const int base = perm[pos] * GROUP + o;   // first coordinate of the chunk
  extern __shared__ float smem[];
  float* gcc = smem;                        // [i][j]
  float* qs = gcc + CH * CH;                // [i][column]
  float* xs = qs + CH * PITCH;
  float* gs = xs + CH * PITCH;
  int8_t* as = reinterpret_cast<int8_t*>(gs + CH * PITCH);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * GT;
  for (int e = tid; e < CH * CH; e += GT) {
    gcc[e] = G[static_cast<long long>(base + e / CH) * npad + base + e % CH];
  }
  for (int e = tid; e < GT * CH; e += GT) {
    const int r = e / CH, i = e % CH;
    const int b = b0 + r;
    float xv = 0.0f, gv = 0.0f, qv = 0.0f;
    int8_t av = 0;
    if (b < B) {
      const long long a = static_cast<long long>(b) * npad + base + i;
      xv = x[a];
      gv = gj[a];
      av = act[a];
      qv = qt[static_cast<long long>(b) * GROUP + o + i];
    }
    xs[i * PITCH + r] = xv;
    gs[i * PITCH + r] = gv;
    qs[i * PITCH + r] = qv;
    as[i * PITCH + r] = av;
  }
  __syncthreads();
  const int b = b0 + tid;
  if (b < B) {
    const float l1 = regs[b * 5 + 0];
    const float l2 = regs[b * 5 + 1];
    const float lv = live[b];
    float dsum = 0.0f;
    for (int i = 0; i < CH; ++i) {
      const float xi = xs[i * PITCH + tid];
      const float ok = static_cast<float>(as[i * PITCH + tid]) * lv;
      const float di = diag[base + i];
      const float num = gs[i * PITCH + tid] - qs[i * PITCH + tid] + di * xi;
      const float cand = fmaxf(num - l1, 0.0f) / (di + l2);
      const float delta = ok * (cand - xi);
      if (delta != 0.0f) {
        const float* grow = gcc + i * CH;
        for (int j = i + 1; j < CH; ++j) {
          qs[j * PITCH + tid] += delta * grow[j];
        }
      }
      xs[i * PITCH + tid] = xi + delta;
      dx[static_cast<long long>(o + i) * B + b] = delta;
      dsum += delta * delta;
    }
    dltx[b] += dsum;
  }
  __syncthreads();
  for (int e = tid; e < GT * CH; e += GT) {
    const int r = e / CH, i = e % CH;
    if (b0 + r < B) {
      x[static_cast<long long>(b0 + r) * npad + base + i] = xs[i * PITCH + r];
    }
  }
}

// C_out[m, n] = C_in[m, n] + sum_{s < nslots, has[g0+s]} sum_{r < rlen}
//     P[(s * GROUP + r) * M + m] * G[perm[g0+s] * GROUP + roff + r, cb + n]
// for m < M, n < N, with cb = (col_pos >= 0 ? perm[col_pos] * GROUP : 0)
// + coff and C_in offset by perm[cin_pos] * GROUP columns when
// cin_pos >= 0.  The launch does nothing unless has[gate] (gate >= 0) or
// some has[g0+s] (gate < 0).  C_in and C_out may alias.
struct Panel {
  const float* P;
  const float* G;
  const int32_t* perm;
  const int32_t* has;
  const float* cin;
  float* cout;
  int npad, M, N, ldin, ldout;
  int g0, nslots, rlen, roff;
  int col_pos, coff, cin_pos, gate;
};

__global__ void __launch_bounds__(PT) panel_gemm_kernel(Panel a) {
  if (a.gate >= 0) {
    if (a.has[a.gate] == 0) return;
  } else {
    int any = 0;
    for (int s = 0; s < a.nslots; ++s) any |= a.has[a.g0 + s];
    if (any == 0) return;
  }
  const int cb = (a.col_pos >= 0 ? a.perm[a.col_pos] * GROUP : 0) + a.coff;
  const float* cin =
      a.cin + (a.cin_pos >= 0 ? a.perm[a.cin_pos] * GROUP : 0);
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

  for (int s = 0; s < a.nslots; ++s) {
    if (a.has[a.g0 + s] == 0) continue;
    const float* P = a.P + static_cast<long long>(s) * GROUP * a.M;
    const float* Q = a.G +
        static_cast<long long>(a.perm[a.g0 + s] * GROUP + a.roff) * a.npad +
        cb;
    for (int k0 = 0; k0 < a.rlen; k0 += BK) {
#pragma unroll
      for (int r = 0; r < (BK * BM) / PT; ++r) {
        const int e = tid + r * PT;
        const int kk = e / BM, mm = e % BM;
        const int gm = m0 + mm, gn = n0 + mm;
        Ps[kk][mm] = gm < a.M
            ? P[static_cast<long long>(k0 + kk) * a.M + gm] : 0.0f;
        Qs[kk][mm] = gn < a.N
            ? Q[static_cast<long long>(k0 + kk) * a.npad + gn] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float pa[8], qb[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) pa[i] = Ps[kk][ty * 8 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) qb[j] = Qs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += pa[i] * qb[j];
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty * 8 + i;
    if (gm >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < a.N) {
        a.cout[static_cast<long long>(gm) * a.ldout + gn] =
            cin[static_cast<long long>(gm) * a.ldin + gn] + acc[i][j];
      }
    }
  }
}

cudaError_t gemm(const Panel& p, cudaStream_t s) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  panel_gemm_kernel<<<grid, PT, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x and q are updated in place; dltx must arrive zeroed.  dX holds
// K * 512 * B floats and qt B * 512 floats of scratch.  ngroups entries of
// perm/has; ngroups % K must be 0 (no window is ever partial).
extern "C" int slim_cd_sweep_panel(int K, const void* G, const void* gj,
                                   const void* act, const void* diag,
                                   void* x, void* q, const void* live_in,
                                   const void* regs, const void* perm,
                                   const void* has, int ngroups, int B,
                                   int npad, void* dX, void* qt,
                                   void* live_out, void* nit, void* dltx,
                                   void* stream) {
  if (K < 1 || ngroups % K != 0 || ngroups * GROUP != npad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gs_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        GS_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Gf = static_cast<const float*>(G);
  const int32_t* pm = static_cast<const int32_t*>(perm);
  const int32_t* hs = static_cast<const int32_t*>(has);
  float* qf = static_cast<float*>(q);
  float* qtf = static_cast<float*>(qt);
  float* dXf = static_cast<float*>(dX);
  const dim3 gs_grid((B + GT - 1) / GT);
  for (int pos = 0; pos < ngroups; ++pos) {
    const int slot = pos % K;
    const int g0 = pos - slot;
    float* dxs = dXf + static_cast<long long>(slot) * GROUP * B;
    // 1. the group's q tile, corrected by the window's earlier slots
    cudaError_t e = gemm(Panel{dXf, Gf, pm, hs, qf, qtf, npad, B, GROUP, npad,
                               GROUP, g0, slot, GROUP, 0, pos, 0, pos, pos},
                         s);
    for (int sub = 0; sub < GROUP / CH && e == cudaSuccess; ++sub) {
      // 2. GS chain over one sub-chunk, then its deltas to the later ones
      gs_panel_kernel<<<gs_grid, GT, GS_SMEM, s>>>(
          Gf, static_cast<const float*>(gj), static_cast<const int8_t*>(act),
          static_cast<const float*>(diag), static_cast<float*>(x), qtf,
          static_cast<const float*>(live_in), static_cast<const float*>(regs),
          pm, hs, pos, sub, B, npad, dxs, static_cast<float*>(dltx));
      e = cudaGetLastError();
      const int o = sub * CH;
      if (e == cudaSuccess && o + CH < GROUP) {
        e = gemm(Panel{dxs + static_cast<long long>(o) * B, Gf, pm, hs,
                       qtf + o + CH, qtf + o + CH, npad, B, GROUP - o - CH,
                       GROUP, GROUP, pos, 1, CH, o, pos, o + CH, -1, pos},
                 s);
      }
    }
    // 4. the window's flush to every column of q
    if (e == cudaSuccess && slot == K - 1) {
      e = gemm(Panel{dXf, Gf, pm, hs, qf, qf, npad, B, npad, npad, npad, g0,
                     K, GROUP, 0, -1, 0, -1, -1},
               s);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sweep_end_kernel<<<(B + 255) / 256, 256, 0, s>>>(
      0, static_cast<const float*>(live_in), static_cast<const float*>(regs),
      static_cast<const float*>(dltx), static_cast<float*>(live_out),
      static_cast<float*>(nit), B);
  return static_cast<int>(cudaGetLastError());
}
