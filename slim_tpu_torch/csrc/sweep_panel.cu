// One cyclic coordinate-descent sweep over 512-wide coordinate groups,
// row-major operands (B, npad), with the q flush deferred over windows of K
// consecutive groups of the visit order and every product on the tensor
// cores (Hopper, sm_90a).
//
// Replaces two TPU kernels with one engine:
//   K = K_FLUSH = 4: slim_tpu/ops/pallas_cd.py · _sweep_kernel_large_v3
//                    (:601) / pallas_cd_sweep_large_v3 (pallas_call at
//                    :872), deferred flush
//   K = 1:           slim_tpu/ops/pallas_cd.py · _sweep_kernel_large
//                    (:313) / pallas_cd_sweep_large (pallas_call at :539),
//                    eager: each group's deltas reach all of q right after
//                    the group
//
// Window invariant (pallas_cd.py:619-626): q is exact with respect to every
// group before the current window; the window's own deltas wait in
// D[slot] (K, B, 512).  For each position pos of the visit order whose
// has[pos] is set, slot = pos % K:
//   1. load:  qt (B, 512) = q[:, group] + sum_{k < slot, has}
//             D_k . G[win_k rows, group cols]   (slots > 0 only: at a
//             window's first slot, and always for eager, the group kernel
//             reads q[:, group] itself)
//   2. group: GS chain over the group's four 128-wide sub-chunks (masked by
//             act * live); after each sub-chunk its deltas reach the later
//             coordinates of the tile: qt[:, later] += dx . G[sub, later]
//   3. flush at the window's last slot, if some slot of the window had work:
//             q[:, all npad] += sum_{k, has} D_k . G[win_k rows, :]
// A skipped group's slot is left out of every sum (the TPU kernel zeroed
// it).  At the sweep end a column dies when sum(dx^2) < optTol or
// t0 + 1 >= cap.  The outputs are x' and q' = x'G.
//
// G is a Gram matrix, so G[win_k rows, n] = G[n, win_k cols]: the flush
// and the load read G's rows n, contiguous along the window's coordinates,
// and both wgmma operands are K-major as in sweep_large.cu: A = the deltas
// (M = the B columns, 64 per warpgroup, rows past B zero-filled and never
// stored), B = G's rows (N = the coordinates); the output tile goes
// row-major into q (ld npad) or qt (ld 512).  The in-group product reads
// G[later, sub] for G[sub, later] the same way.
//
// What bounds it on the H100: each active group's deltas reaching all npad
// columns of q once, 2 * B * npad * 512 FLOP, plus the GS triangles: 2.31
// ms at 38 of 56 groups active and 3.41 ms all active (B 1024, npad 28672)
// at the 495 TFLOP/s TF32 tensor-core peak (operations; the bytes, G's
// active rows once plus the operands, take less).  The design is
// sweep_large.cu's (the building blocks live in wide_sweep.cuh):
//   * every product in bf16x3 on the tensor cores: G's halves come from the
//     wrapper (made once per G), the deltas' from the group kernel;
//   * panel_gemm_kernel (load and flush): wgmma m64nNk16 fed by a cp.async
//     ring in the 64-byte swizzle; the contraction walks the window's slots
//     with work through perm/has.  The flush takes 128 x 128 tiles (1,792
//     blocks at B 1024, npad 28672), the load 64 x 64 tiles (128 blocks);
//   * group_kernel<true>: one warp per column, four columns per block (256
//     blocks at B 1024, where one thread per column gave 16); the row-major
//     x / gj / act rows are contiguous along the coordinates, so a warp's
//     32 lanes read 128 bytes in one transaction; the in-group product on
//     mma.sync with the block's columns as n8.
// One ctypes call enqueues the sweep: a group launch per position (plus a
// load at slots > 0 for v3), a flush per window and the end-of-sweep
// kernel; every launch reads perm/has from device memory, so no host sync
// is needed and a skipped group costs empty launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_sweep.cuh"

namespace {

// C_out[b, n] = C_in[b, col0 + n] + sum_{s < nslots, has[g0+s]}
//     sum_{r < 512} D_s[b, r] * G[col0 + n, perm[g0+s]*512 + r]
// for b < B and the block tiles' n, G = Gh + Gl and D = Dh + Dl (bf16x3),
// with col0 = perm[colpos] * 512 when colpos >= 0, else 0.  The launch does
// nothing unless has[gate] (gate >= 0) or some slot has work (gate < 0).
// C_in and C_out may alias (then col0 is 0 and ldin = ldout).
struct Panel {
  const bf16* Gh;
  const bf16* Gl;
  const bf16* Dh;
  const bf16* Dl;
  const int32_t* perm;
  const int32_t* has;
  const float* cin;
  float* cout;
  int npad, B, ldin, ldout;
  int colpos, g0, nslots, gate;
};

// The Panel contract on wgmma (wg_mainloop): A = the deltas, B = G's rows
template <int WGS, int BN, int S>
__global__ void __launch_bounds__(WGS * 128) panel_gemm_kernel(Panel p) {
  using C = WgCfg<WGS, BN, S>;
  __shared__ int slots[KF];
  const int nact = window_slots(p.has, p.g0, p.nslots, slots);
  if (p.gate >= 0 ? p.has[p.gate] == 0 : nact == 0) return;

  extern __shared__ __align__(128) unsigned char wsm[];
  bf16* sm = wg_smem(wsm);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * BN;
  const int col0 = p.colpos >= 0 ? p.perm[p.colpos] * GROUP : 0;
  const long long dslot = static_cast<long long>(p.B) * GROUP;

  auto load = [&](int kt, bf16* ah, bf16* al, bf16* bh, bf16* bl) {
    const int s = slots[kt / (GROUP / BK)];
    const int kc = (kt % (GROUP / BK)) * BK;
    for (int e = tid; e < C::BM * (BK / 8); e += C::THREADS) {
      const int r = e / (BK / 8), c = e % (BK / 8);
      const bool in = m0 + r < p.B;     // columns past B read as zeros
      const long long src =
          in ? s * dslot + static_cast<long long>(m0 + r) * GROUP + kc + c * 8
             : 0;
      cp16(ah + swz(r, c), p.Dh + src, in ? 16 : 0);
      cp16(al + swz(r, c), p.Dl + src, in ? 16 : 0);
    }
    const long long acol =
        static_cast<long long>(p.perm[p.g0 + s]) * GROUP + kc;
    for (int e = tid; e < BN * (BK / 8); e += C::THREADS) {
      const int r = e / (BK / 8), c = e % (BK / 8);
      const long long src =
          static_cast<long long>(col0 + n0 + r) * p.npad + acol + c * 8;
      cp16(bh + swz(r, c), p.Gh + src, 16);
      cp16(bl + swz(r, c), p.Gl + src, 16);
    }
  };
  float acc[BN / 2];
  wg_mainloop<WGS, BN, S>(sm, nact * (GROUP / BK), load, acc);

  // accumulator row = column b, accumulator column = coordinate n
  const int w4 = t >> 5, lane = t & 31;
  const int m = m0 + 64 * wg + 16 * w4 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = m + 8 * h;
    if (b >= p.B) continue;
    const float* ci = p.cin + static_cast<long long>(b) * p.ldin + col0;
    float* co = p.cout + static_cast<long long>(b) * p.ldout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + (lane & 3) * 2;
      const float2 c = *reinterpret_cast<const float2*>(ci + n);
      *reinterpret_cast<float2*>(co + n) =
          make_float2(c.x + acc[4 * j + 2 * h], c.y + acc[4 * j + 2 * h + 1]);
    }
  }
}

// N (a multiple of BN) output coordinates for every column b < p.B.  The
// grid's x walks the column tiles, so the blocks that run together share a
// G tile (read from device memory once, then from L2) rather than a
// delta tile
template <int WGS, int BN, int S>
cudaError_t panel_gemm(const Panel& p, int N, cudaStream_t s) {
  using C = WgCfg<WGS, BN, S>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = set_smem(panel_gemm_kernel<WGS, BN, S>, C::SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((p.B + C::BM - 1) / C::BM, N / BN);
  panel_gemm_kernel<WGS, BN, S><<<grid, C::THREADS, C::SMEM, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x and q are updated in place; dltx must arrive zeroed.  Gh / Gl are the
// bf16 halves of G; qt holds B * 512 floats, Dh / Dl K * B * 512 bf16 each.
// ngroups entries of perm/has; ngroups % K must be 0 (no window is ever
// partial), K at most 4.
extern "C" int slim_cd_sweep_panel(
    int K, const void* G, const void* Gh, const void* Gl, const void* gj,
    const void* act, const void* diag, void* x, void* q, const void* live_in,
    const void* regs, const void* perm, const void* has, int ngroups, int B,
    int npad, void* qt, void* Dh, void* Dl, void* live_out, void* nit,
    void* dltx, void* stream) {
  if (K < 1 || K > KF || ngroups % K != 0 || ngroups * GROUP != npad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = set_smem(group_kernel<true>, GROUP_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* gh = static_cast<const bf16*>(Gh);
  const bf16* gl = static_cast<const bf16*>(Gl);
  bf16* dh = static_cast<bf16*>(Dh);
  bf16* dl = static_cast<bf16*>(Dl);
  const int32_t* pm = static_cast<const int32_t*>(perm);
  const int32_t* hs = static_cast<const int32_t*>(has);
  float* qf = static_cast<float*>(q);
  float* qtf = static_cast<float*>(qt);
  for (int pos = 0; pos < ngroups; ++pos) {
    const int slot = pos % K;
    const int g0 = pos - slot;
    cudaError_t e = cudaSuccess;
    // 1. the group's q tile: q itself at a window's first slot, else
    // corrected by the window's earlier slots into qt
    const bool direct = slot == 0;
    if (!direct) {
      e = panel_gemm<1, 64, 4>(Panel{gh, gl, dh, dl, pm, hs, qf, qtf, npad, B,
                                     npad, GROUP, pos, g0, slot, pos},
                               GROUP, s);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    // 2. GS chain and in-group propagation
    group_kernel<true><<<(B + GCOLS - 1) / GCOLS, GCOLS * 32, GROUP_SMEM,
                         s>>>(
        static_cast<const float*>(G), gh, gl, static_cast<const float*>(gj),
        static_cast<const int8_t*>(act), static_cast<const float*>(diag),
        static_cast<float*>(x), direct ? qf : qtf, direct ? npad : GROUP, 1,
        direct ? 1 : 0, static_cast<const float*>(live_in),
        static_cast<const float*>(regs), pm, hs, pos, slot, B, npad, dh, dl,
        static_cast<float*>(dltx));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    // 3. the window's flush to every column of q
    if (slot == K - 1) {
      e = panel_gemm<2, 128, 3>(Panel{gh, gl, dh, dl, pm, hs, qf, qf, npad,
                                      B, npad, npad, -1, g0, K, -1},
                                npad, s);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  sweep_end_kernel<<<(B + 255) / 256, 256, 0, s>>>(
      0, static_cast<const float*>(live_in), static_cast<const float*>(regs),
      static_cast<const float*>(dltx), static_cast<float*>(live_out),
      static_cast<float*>(nit), B);
  return static_cast<int>(cudaGetLastError());
}
