// One cyclic coordinate-descent sweep over GW-wide coordinate groups,
// row-major operands (B, npad), with the q flush deferred over windows of K
// consecutive groups of the visit order and every product on the tensor
// cores (Hopper, sm_90a).
//
// Replaces three TPU kernels with one engine:
//   GW = 512, K = K_FLUSH = 4: slim_tpu/ops/pallas_cd.py ·
//                    _sweep_kernel_large_v3 (:601) / pallas_cd_sweep_large_v3
//                    (pallas_call at :872), deferred flush
//   GW = 512, K = 1: slim_tpu/ops/pallas_cd.py · _sweep_kernel_large (:313)
//                    / pallas_cd_sweep_large (pallas_call at :539), eager:
//                    each group's deltas reach all of q right after the group
//   GW = 128, K = 1: slim_tpu/ops/pallas_cd.py · _sweep_kernel (:58) /
//                    pallas_cd_sweeps (pallas_call at :179), the whole-array
//                    sweep over 128-wide chunks (slim_cd_sweep)
//
// Window invariant (pallas_cd.py:619-626): q is exact with respect to every
// group before the current window; the window's own deltas wait in
// D[slot] (K, B, GW).  For each position pos of the visit order whose
// has[pos] is set, slot = pos % K:
//   1. load:  qt (B, GW) = q[:, group] + sum_{k < slot, has}
//             D_k . G[win_k rows, group cols]   (slots > 0 only: at a
//             window's first slot, and always for K = 1, the group kernel
//             reads q[:, group] itself)
//   2. group: GS chain over the group's 128-wide sub-chunks (masked by
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
// row-major into q (ld npad) or qt (ld GW).  The in-group product reads
// G[later, sub] for G[sub, later] the same way.
//
// What bounds it on the H100: each active group's deltas reaching all npad
// columns of q once, 2 * B * npad * GW FLOP, plus the GS triangles: 2.31
// ms at 38 of 56 groups active and 3.41 ms all active (B 1024, npad 28672)
// at the 495 TFLOP/s TF32 tensor-core peak (operations; the bytes, G's
// active rows once plus the operands, take less).  At the whole-array
// sweep's sizes (B 512, npad <= 4096) the bound is the bytes, tens of
// microseconds, and the time goes to the GS chain's latency and the
// launches.  The design is sweep_large.cu's (the building blocks live in
// wide_sweep.cuh):
//   * every product in bf16x3 on the tensor cores: G's halves come from the
//     wrapper (made once per G), the deltas' from the group kernel;
//   * panel_gemm_kernel (load and flush): wgmma m64nNk16 fed by a cp.async
//     ring in the 64-byte swizzle; the contraction walks the window's slots
//     with work through perm/has.  The flush takes 128 x 128 tiles (1,792
//     blocks at B 1024, npad 28672; 128 at B 512, npad 4096, where its
//     four k-tiles of a 128-wide group all load at once), the load 64 x 64
//     tiles (128 blocks);
//   * group_kernel<true, GW>: one warp per column, GCOLS = 4 columns per
//     block (256 blocks at B 1024, 128 at B 512); the row-major
//     x / gj / act rows are contiguous along the coordinates, so a warp's
//     32 lanes read 128 bytes in one transaction; the in-group product on
//     mma.sync with the block's columns as n8 (none at GW = 128).
// One ctypes call enqueues the sweep: a group launch per position (plus a
// load at slots > 0 for v3), a flush per window and the end-of-sweep
// kernel; every launch reads perm/has from device memory, so no host sync
// is needed and a skipped group costs empty launches (two at K = 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_sweep.cuh"

namespace {

// C_out[b, n] = C_in[b, col0 + n] + sum_{s < nslots, has[g0+s]}
//     sum_{r < GW} D_s[b, r] * G[col0 + n, perm[g0+s]*GW + r]
// for b < B and the block tiles' n, G = Gh + Gl and D = Dh + Dl (bf16x3),
// with col0 = perm[colpos] * GW when colpos >= 0, else 0.  The launch does
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
template <int WGS, int BN, int S, int GW>
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
  const int col0 = p.colpos >= 0 ? p.perm[p.colpos] * GW : 0;
  const long long dslot = static_cast<long long>(p.B) * GW;

  auto load = [&](int kt, bf16* ah, bf16* al, bf16* bh, bf16* bl) {
    const int s = slots[kt / (GW / BK)];
    const int kc = (kt % (GW / BK)) * BK;
    for (int e = tid; e < C::BM * (BK / 8); e += C::THREADS) {
      const int r = e / (BK / 8), c = e % (BK / 8);
      const bool in = m0 + r < p.B;     // columns past B read as zeros
      const long long src =
          in ? s * dslot + static_cast<long long>(m0 + r) * GW + kc + c * 8
             : 0;
      cp16(ah + swz(r, c), p.Dh + src, in ? 16 : 0);
      cp16(al + swz(r, c), p.Dl + src, in ? 16 : 0);
    }
    const long long acol =
        static_cast<long long>(p.perm[p.g0 + s]) * GW + kc;
    for (int e = tid; e < BN * (BK / 8); e += C::THREADS) {
      const int r = e / (BK / 8), c = e % (BK / 8);
      const long long src =
          static_cast<long long>(col0 + n0 + r) * p.npad + acol + c * 8;
      cp16(bh + swz(r, c), p.Gh + src, 16);
      cp16(bl + swz(r, c), p.Gl + src, 16);
    }
  };
  // accumulator row = column b, accumulator column = coordinate n
  const int w4 = t >> 5, lane = t & 31;
  const int m = m0 + 64 * wg + 16 * w4 + (lane >> 2);
  auto cin_at = [&](int h, int j) {
    const int b = m + 8 * h, n = n0 + 8 * j + (lane & 3) * 2;
    return reinterpret_cast<const float2*>(
        p.cin + static_cast<long long>(b) * p.ldin + col0 + n);
  };
  // C_in may alias C_out, so the epilogue's loads cannot pass its stores:
  // a 128-wide group's short contraction (four k-tiles) would wait on 32
  // serial round trips per thread, so its tile of C_in is read into
  // registers before the main loop
  constexpr bool PRELOAD = GW == CH;
  float2 cpre[2][BN / 8];
  if constexpr (PRELOAD) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        cpre[h][j] = m + 8 * h < p.B ? *cin_at(h, j) : make_float2(0.f, 0.f);
  }
  float acc[BN / 2];
  wg_mainloop<WGS, BN, S>(sm, nact * (GW / BK), load, acc);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = m + 8 * h;
    if (b >= p.B) continue;
    float* co = p.cout + static_cast<long long>(b) * p.ldout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + (lane & 3) * 2;
      float2 c;
      if constexpr (PRELOAD) {
        c = cpre[h][j];
      } else {
        c = *cin_at(h, j);
      }
      *reinterpret_cast<float2*>(co + n) =
          make_float2(c.x + acc[4 * j + 2 * h], c.y + acc[4 * j + 2 * h + 1]);
    }
  }
}

// N (a multiple of BN) output coordinates for every column b < p.B.  The
// grid's x walks the column tiles, so the blocks that run together share a
// G tile (read from device memory once, then from L2) rather than a
// delta tile
template <int WGS, int BN, int S, int GW>
cudaError_t panel_gemm(const Panel& p, int N, cudaStream_t s) {
  using C = WgCfg<WGS, BN, S>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e =
        set_smem(panel_gemm_kernel<WGS, BN, S, GW>, C::SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((p.B + C::BM - 1) / C::BM, N / BN);
  panel_gemm_kernel<WGS, BN, S, GW><<<grid, C::THREADS, C::SMEM, s>>>(p);
  return cudaGetLastError();
}

// One sweep of the engine: groups of GW coordinates, windows of K groups
// (arguments as slim_cd_sweep_panel).  At GW = CH (the whole-array sweep) K
// is 1, so there is no window load and qt is unused.
template <int GW>
int panel_sweep(int K, const void* G, const void* Gh, const void* Gl,
                const void* gj, const void* act, const void* diag, void* x,
                void* q, const void* live_in, const void* regs,
                const void* perm, const void* has, int ngroups, int B,
                int npad, void* qt, void* Dh, void* Dl, void* live_out,
                void* nit, void* dltx, void* stream) {
  if (K < 1 || K > KF || ngroups % K != 0 || ngroups * GW != npad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int SMEM = group_smem<GW>();
  // a 128-wide group's flush contracts over four k-tiles: a ring of six
  // stages has all four in flight at once (one latency per flush, one
  // 192 KB block per SM); a 512-wide window streams 16-64 k-tiles through
  // three stages, two blocks per SM
  constexpr int FLUSH_STAGES = GW == CH ? 6 : 3;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = set_smem(group_kernel<true, GW>, SMEM);
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
    if constexpr (GW != CH) {
      if (!direct) {
        e = panel_gemm<1, 64, 4, GW>(Panel{gh, gl, dh, dl, pm, hs, qf, qtf,
                                           npad, B, npad, GW, pos, g0, slot,
                                           pos},
                                     GW, s);
        if (e != cudaSuccess) return static_cast<int>(e);
      }
    }
    // 2. GS chain and in-group propagation
    group_kernel<true, GW><<<(B + GCOLS - 1) / GCOLS, GCOLS * 32, SMEM, s>>>(
        static_cast<const float*>(G), gh, gl, static_cast<const float*>(gj),
        static_cast<const int8_t*>(act), static_cast<const float*>(diag),
        static_cast<float*>(x), direct ? qf : qtf, direct ? npad : GW, 1,
        direct ? 1 : 0, static_cast<const float*>(live_in),
        static_cast<const float*>(regs), pm, hs, pos, slot, B, npad, dh, dl,
        static_cast<float*>(dltx));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    // 3. the window's flush to every column of q
    if (slot == K - 1) {
      e = panel_gemm<2, 128, FLUSH_STAGES, GW>(
          Panel{gh, gl, dh, dl, pm, hs, qf, qf, npad, B, npad, npad, -1, g0,
                K, -1},
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
  return panel_sweep<GROUP>(K, G, Gh, Gl, gj, act, diag, x, q, live_in,
                            regs, perm, has, ngroups, B, npad, qt, Dh, Dl,
                            live_out, nit, dltx, stream);
}

// The whole-array sweep: 128-wide chunks, each flushed to all of q right
// after its GS chain (windows of one).  Dh / Dl hold B * 128 bf16 each;
// npos entries of perm/has, npos * 128 = npad.
extern "C" int slim_cd_sweep(const void* G, const void* Gh, const void* Gl,
                             const void* gj, const void* act,
                             const void* diag, void* x, void* q,
                             const void* live_in, const void* regs,
                             const void* perm, const void* has, int npos,
                             int B, int npad, void* Dh, void* Dl,
                             void* live_out, void* nit, void* dltx,
                             void* stream) {
  return panel_sweep<CH>(1, G, Gh, Gl, gj, act, diag, x, q, live_in, regs,
                         perm, has, npos, B, npad, nullptr, Dh, Dl, live_out,
                         nit, dltx, stream);
}
