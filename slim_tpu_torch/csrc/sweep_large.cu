// One cyclic coordinate-descent sweep over 512-wide coordinate groups,
// coordinate-major operands (npad, B), with the q flush deferred over
// windows of K_FLUSH = 4 consecutive groups of the visit order and every
// product on the tensor cores (Hopper, sm_90a).
//
// Replaces slim_tpu/ops/pallas_cd.py · _sweep_kernel_large_v4 (:920) /
// pallas_cd_sweep_large_v4 (pallas_call at :1252).
//
// Window invariant (as in sweep_panel.cu, here coordinate-major): qT is
// exact with respect to every group before the current window; the
// window's own deltas wait in D[slot] (K_FLUSH, B, 512).  For each
// position pos of the visit order whose has[pos] is set, slot = pos % 4:
//   1. load:   qg (512, B) = qT[group rows] + sum_{k < slot, has}
//              G[group rows, win_k cols] . D_k
//   2. group:  GS chain over the group's four 128-wide sub-chunks (masked
//              by act * live); after each sub-chunk its deltas reach the
//              later rows of qg: qg[later] += G[later, sub cols] . dx
//   3. flush at the window's last slot, or at the sweep's last position (a
//      partial window), if some slot of the window had work:
//              qT[all npad rows] += sum_{k, has} G[:, win_k cols] . D_k
// A skipped group's slot is left out of every sum.  At the sweep end a
// column dies when sum(dx^2) < optTol or t0 + 1 >= cap.
//
// What bounds it on the H100: each active group's deltas reaching all npad
// rows of q once, 2 * B * npad * 512 FLOP (plus the GS triangles: 1.69e12
// per all-active sweep at B 1024, npad 28672; the load corrections and
// in-group products only bring forward part of that work), i.e. 3.4 ms at
// the 495 TFLOP/s TF32 tensor-core peak against 25 ms at the 67 TFLOP/s
// f32 CUDA-core rate; its bytes (G once, 3.3 GB, plus the operands) take
// 1.2 ms.  Design:
//   * Products in bf16x3 on the tensor cores (wide_sweep.cuh, shared with
//     the row-major sweep_panel.cu).  The f32 G feeds only the GS chain's
//     diagonal block.
//   * wg_gemm_kernel (load and flush): wgmma m64nNk16 (bf16 in, f32
//     accumulate), both operands K-major in shared memory in the 64-byte
//     swizzle, fed by a cp.async ring; one wgmma group stays in flight while
//     the next tile lands.  The contraction walks the window's slots with
//     work through perm/has.  The flush takes 128 x 128 tiles (1,792 blocks
//     at B 1024, npad 28672), the load 64 x 64 tiles (128 blocks).
//   * group_kernel<false> (wide_sweep.cuh): one warp per column, four
//     columns per block (256 blocks at B 1024), the chain's owner lane
//     broadcast with __shfl_sync, the division by d_i + l2 a multiply by a
//     reciprocal made before the chain (the IEEE division on the chain's
//     critical path cost ~40% of the launch, PERF.md; x moves by an ulp,
//     not a sweep count), the in-group product on mma.sync m16n8k16:
//     wgmma's 64-row tiles would need the group's G rows (up to 196 KB)
//     staged in shared memory per block.
// One ctypes call enqueues the sweep (a load and a group launch per
// position, a flush per window); every launch reads perm/has from device
// memory, so no host sync is needed and a skipped group costs two empty
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_sweep.cuh"

namespace {

// C_out[m, n] = C_in[row0 + m, n] + sum_{s < nslots, has[g0+s]}
//     sum_{r < 512} G[row0 + m, perm[g0+s]*512 + r] * D_s[n, r]
// for the block tiles of the grid, n < N, G = Gh + Gl and D = Dh + Dl
// (bf16x3), with row0 = perm[rowpos] * 512 when rowpos >= 0, else 0.  The
// launch does nothing unless has[gate] (gate >= 0) or some slot has work
// (gate < 0).
// C_in and C_out may alias (then row0 is 0).
struct Gemm {
  const bf16* Gh;
  const bf16* Gl;
  const bf16* Dh;
  const bf16* Dl;
  const int32_t* perm;
  const int32_t* has;
  const float* cin;
  float* cout;
  int npad, N, ldc;
  int rowpos, g0, nslots, gate;
};

// The Gemm contract on wgmma (wg_mainloop): A = G's rows, B = the deltas
template <int WGS, int BN, int S>
__global__ void __launch_bounds__(WGS * 128) wg_gemm_kernel(Gemm p) {
  using C = WgCfg<WGS, BN, S>;
  __shared__ int slots[KF];
  const int nact = window_slots(p.has, p.g0, p.nslots, slots);
  if (p.gate >= 0 ? p.has[p.gate] == 0 : nact == 0) return;

  extern __shared__ __align__(128) unsigned char wsm[];
  bf16* sm = wg_smem(wsm);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * BN;
  const int row0 = p.rowpos >= 0 ? p.perm[p.rowpos] * GROUP : 0;
  const long long dslot = static_cast<long long>(p.N) * GROUP;

  auto load = [&](int kt, bf16* ah, bf16* al, bf16* bh, bf16* bl) {
    const int s = slots[kt / (GROUP / BK)];
    const int kc = (kt % (GROUP / BK)) * BK;
    const long long acol =
        static_cast<long long>(p.perm[p.g0 + s]) * GROUP + kc;
    for (int e = tid; e < C::BM * (BK / 8); e += C::THREADS) {
      const int r = e / (BK / 8), c = e % (BK / 8);
      const long long src =
          static_cast<long long>(row0 + m0 + r) * p.npad + acol + c * 8;
      cp16(ah + swz(r, c), p.Gh + src, 16);
      cp16(al + swz(r, c), p.Gl + src, 16);
    }
    for (int e = tid; e < BN * (BK / 8); e += C::THREADS) {
      const int r = e / (BK / 8), c = e % (BK / 8);
      const bool in = n0 + r < p.N;     // columns past N read as zeros
      const long long src =
          in ? s * dslot + static_cast<long long>(n0 + r) * GROUP + kc + c * 8
             : 0;
      cp16(bh + swz(r, c), p.Dh + src, in ? 16 : 0);
      cp16(bl + swz(r, c), p.Dl + src, in ? 16 : 0);
    }
  };
  float acc[BN / 2];
  wg_mainloop<WGS, BN, S>(sm, nact * (GROUP / BK), load, acc);

  const int w4 = t >> 5, lane = t & 31;
  const int m = m0 + 64 * wg + 16 * w4 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* ci =
          p.cin + static_cast<long long>(row0 + m + 8 * h) * p.ldc;
      float* co = p.cout + static_cast<long long>(m + 8 * h) * p.ldc;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + (lane & 3) * 2 + e;
        if (n < p.N) co[n] = ci[n] + acc[4 * j + 2 * h + e];
      }
    }
}

template <int WGS, int BN, int S>
cudaError_t wg_gemm(const Gemm& p, int M, cudaStream_t s) {
  using C = WgCfg<WGS, BN, S>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = set_smem(wg_gemm_kernel<WGS, BN, S>, C::SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((p.N + BN - 1) / BN, M / C::BM);
  wg_gemm_kernel<WGS, BN, S><<<grid, C::THREADS, C::SMEM, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// xT and qT are updated in place; dltx must arrive zeroed.  Gh / Gl are the
// bf16 halves of G; qg holds 512 * B floats, Dh / Dl K_FLUSH * B * 512
// bf16 each.  ngroups entries of perm/has; the last window may be partial.
extern "C" int slim_cd_sweep_large(
    const void* G, const void* Gh, const void* Gl, const void* gjT,
    const void* actT, const void* diag, void* xT, void* qT,
    const void* live_in, const void* regsT, const void* perm, const void* has,
    int ngroups, int B, int npad, void* qg, void* Dh, void* Dl,
    void* live_out, void* nit, void* dltx, void* stream) {
  if (ngroups * GROUP != npad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e =
        set_smem(group_kernel<false>, group_smem<GROUP>());
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
  float* qf = static_cast<float*>(qT);
  float* qgf = static_cast<float*>(qg);
  for (int pos = 0; pos < ngroups; ++pos) {
    const int slot = pos % KF;
    const int g0 = pos - slot;
    // 1. the group's q tile, corrected by the window's earlier slots
    cudaError_t e = wg_gemm<1, 64, 4>(
        Gemm{gh, gl, dh, dl, pm, hs, qf, qgf, npad, B, B, pos, g0, slot, pos},
        GROUP, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    // 2. GS chain and in-group propagation
    group_kernel<false><<<(B + GCOLS - 1) / GCOLS, GCOLS * 32,
                          group_smem<GROUP>(), s>>>(
        static_cast<const float*>(G), gh, gl, static_cast<const float*>(gjT),
        static_cast<const int8_t*>(actT), static_cast<const float*>(diag),
        static_cast<float*>(xT), qgf, 1, B, 0,
        static_cast<const float*>(live_in),
        static_cast<const float*>(regsT), pm, hs, pos, slot, B, npad, dh, dl,
        static_cast<float*>(dltx));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    // 3. the window's flush to every row of qT
    if (slot == KF - 1 || pos == ngroups - 1) {
      e = wg_gemm<2, 128, 3>(Gemm{gh, gl, dh, dl, pm, hs, qf, qf, npad, B, B,
                                  -1, g0, slot + 1, -1},
                             npad, s);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  sweep_end_kernel<<<(B + 255) / 256, 256, 0, s>>>(
      1, static_cast<const float*>(live_in), static_cast<const float*>(regsT),
      static_cast<const float*>(dltx), static_cast<float*>(live_out),
      static_cast<float*>(nit), B);
  return static_cast<int>(cudaGetLastError());
}
