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
// What bounds it on the H100: the flush.  A window of four active groups
// makes three bf16 products (Gh.Dh + Gh.Dl + Gl.Dh) of 2 * npad * B * 2048
// operations, 3.61e11 at npad 28672, B 1024: 5.05e12 a sweep of 14
// windows, 5.11 ms at the 989 TFLOP/s dense bf16 peak, against 1.96 ms for
// its bytes at 3.35 TB/s (G's halves of the window's columns once, q read
// and written once, per window); the load and the group kernel's products
// only bring forward part of the flush's work.  Design:
//   * Products in bf16x3 on the tensor cores (wide_sweep.cuh, shared with
//     the row-major sweep_panel.cu).  The f32 G feeds only the GS chain's
//     diagonal block.
//   * The flush, wg_gemm_kernel_flush: one persistent block per SM, in
//     clusters of two along M, walking the (128 x BN) output tiles.  One
//     producer warp feeds a ring of 32-deep k-tiles (Gh, Gl, Dh, Dl) in
//     shared memory with TMA, completion on mbarriers, and keeps every
//     stage but the one being read in flight (3 ahead at BN 256, 5 at 128).
//     The D tile (the same for both blocks of a cluster) is multicast: each
//     block fetches half of it for both, so a block stages 128 G rows and
//     BN / 2 D rows a k-row.  Two consumer warpgroups (64 rows each) run
//     wgmma m64nBNk16 into accumulators that start from zero; the epilogue
//     adds the tile's q (prefetched into L2 by the producer while the last
//     k-tiles run) in IEEE f32 and stores once, in batches whose loads are
//     all in flight before their stores: no chain of load-after-store trips
//     on aliasing pointers.  Accumulators started from q lose the sweep:
//     the tensor cores' f32 sums drop low bits adding the small products
//     onto a large q (q 10x farther from the plain version, and the
//     ML-20M learn, its q carried across sweeps, never met optTol).
//     The 64-byte swizzle and 32-deep tiles, not the 128-byte one: both
//     halves of both operands make a 64-deep stage of 128 x 256 tiles 96 KB,
//     two stages of the 227 KB; 32-deep stages of 48 KB give four.
//     Tiles 128 x 256 stage 16 KB of G and 16 KB of D per block a k-tile
//     for 6.3 MFLOP: 192 operations a byte from L2 (the 128 x 128 tiles of
//     the cp.async flush before it: 98; 128 x 128 here: 128).  Measured on
//     an H100 80GB HBM3 at 700 W, a sweep's 14 windows at npad 28672, B
//     1024: the ring alone (feed_only) stages 5.5-5.6 TB/s from L2 in
//     4.69-4.74 ms, room for 108% of the bf16 peak at 128 x 256 (74% at
//     128 x 128, 6.9 ms), so these tiles; the flush takes 7.5-7.7 ms alone
//     (67% of its bound) and 6.8 ms inside the sweep (75%; the parent's
//     cp.async flush 9.8 ms), cuBLAS's bf16 product of the same operations
//     6.3 ms.  Clusters of four along M quarter the D rows a block fetches
//     (feed 3.9 ms) but only 30 fit (120 SMs): 8.3 ms.  Ring depths of 2-4
//     stages and releasing a stage one k-tile late move the time by less
//     than the runs' spread; the q epilogue costs 1-4% (with q read
//     before the main loop).
//     BN is 256 or 128, whichever gives the observed M and N the shortest
//     waves, a 128-wide column at 1.14 times a 256-wide one's cost
//     (ops/cd_sweep.flush_tile_n): 256 at npad 28672 and 8192, 128 at 6144
//     (B 1024).  Columns past N read zeros (TMA's out-of-bounds fill) and
//     are never written.
//   * wg_gemm_kernel (the window load): wgmma m64n64k16, both operands
//     K-major in shared memory in the 64-byte swizzle, fed by a cp.async
//     ring; 64 x 64 tiles (128 blocks at B 1024).
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_sweep.cuh"

namespace {

// C_out[m, n] = C_in[row0 + m, n] + sum_{s < nslots, has[g0+s]}
//     sum_{r < 512} G[row0 + m, perm[g0+s]*512 + r] * D_s[n, r]
// for the block tiles of the grid, n < N, G = Gh + Gl and D = Dh + Dl
// (bf16x3), with row0 = perm[rowpos] * 512.  The launch does nothing
// unless has[gate].
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
  if (p.has[p.gate] == 0) return;

  extern __shared__ __align__(128) unsigned char wsm[];
  bf16* sm = wg_smem(wsm);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * BN;
  const int row0 = p.perm[p.rowpos] * GROUP;
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

// ---------------------------------------------------------------------------
// The window flush: q[m, n] += sum_{s < nslots, has[g0+s]} sum_{r < 512}
// G[m, perm[g0+s]*512 + r] * D_s[n, r] for every m < M, n < N, in bf16x3
// (G = Gh + Gl, D = Dh + Dl; Gh.Dh + Gh.Dl + Gl.Dh, f32 accumulation).  q
// is (M, N) row-major.  Nothing happens unless some slot has work.

constexpr int FBM = 128;              // rows of an output tile
constexpr int FCL = 2;                // blocks of a cluster, along M
constexpr int FTHREADS = 384;         // two consumer warpgroups + producer
constexpr int FRING = 4 * 48 * 1024;  // bytes of the operand ring

template <int BN>
struct FlushCfg {
  static constexpr int TILE_A = FBM * BK;                  // bf16 a half
  static constexpr int TILE_B = BN * BK;
  static constexpr int STAGE = 4 * (TILE_A + TILE_B);      // bytes
  static constexpr int S = FRING / STAGE;                  // 4 or 6
  static constexpr int SMEM = S * STAGE + 2 * S * 8 + 1024;
};

struct Flush {
  const int32_t* perm;
  const int32_t* has;
  float* q;
  int M, N, g0, nslots;
  int feed_only;   // the ring alone: no q, no wgmma (the feed probe)
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// arrive on the barrier at bar's offset in the cluster's block cta
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, int cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// the same 3-d box into this offset of every block in mask, each block's
// barrier at bar's offset told of its bytes
__device__ __forceinline__ void tma_3d_mc(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

template <int BN>
__global__ void __launch_bounds__(FTHREADS, 1)
    wg_gemm_kernel_flush(const __grid_constant__ CUtensorMap tgh,
                         const __grid_constant__ CUtensorMap tgl,
                         const __grid_constant__ CUtensorMap tdh,
                         const __grid_constant__ CUtensorMap tdl, Flush p) {
  using C = FlushCfg<BN>;
  __shared__ int slots[KF];
  __shared__ int wcol[KF];
  const int nact = window_slots(p.has, p.g0, p.nslots, slots);
  if (nact == 0) return;
  extern __shared__ __align__(1024) unsigned char fsm[];
  unsigned char* ring = fsm + ((1024 - (smem_addr(fsm) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::S * C::STAGE);
  uint64_t* empty = full + C::S;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * FCL);    // both warpgroups of both blocks
    }
    for (int i = 0; i < nact; ++i) wcol[i] = p.perm[p.g0 + slots[i]] * GROUP;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();   // the peer's barriers exist before any multicast

  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int kts = nact * (GROUP / BK);
  const int nt = (p.N + BN - 1) / BN;
  const int pairs = p.M / (FBM * FCL) * nt;
  const int first = blockIdx.x / FCL, step = gridDim.x / FCL;

  if (tid >= 256) {
    // producer warpgroup: one thread drives the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = first; t < pairs; t += step) {
        const int m0 = ((t / nt) * FCL + rank) * FBM, n0 = (t % nt) * BN;
        for (int kt = 0; kt < kts; ++kt) {
          mbar_wait(empty + stage, phase ^ 1);
          unsigned char* st = ring + stage * C::STAGE;
          mbar_expect(full + stage, C::STAGE);
          const int s = kt / (GROUP / BK);
          const int kc = (kt % (GROUP / BK)) * BK;
          tma_2d(st, &tgh, full + stage, wcol[s] + kc, m0);
          tma_2d(st + 2 * C::TILE_A, &tgl, full + stage, wcol[s] + kc, m0);
          // this block's half of the D tile, for both blocks
          const int half = rank * (BN / FCL);
          unsigned char* bh = st + 4 * C::TILE_A + 2 * half * BK;
          const uint16_t mask = (1u << FCL) - 1;
          tma_3d_mc(bh, &tdh, full + stage, kc, n0 + half, slots[s], mask);
          tma_3d_mc(bh + 2 * C::TILE_B, &tdl, full + stage, kc, n0 + half,
                    slots[s], mask);
          if (++stage == C::S) {
            stage = 0;
            phase ^= 1;
          }
        }
        if (!p.feed_only) {
          // the tile's q rows into L2 while the consumers still have the
          // ring's k-tiles to go, ahead of their epilogue's loads
          const int n1 = min(n0 + BN, p.N);
          for (int r = 0; r < FBM; ++r) {
            const float* row = p.q + static_cast<long long>(m0 + r) * p.N;
            const uint64_t a = reinterpret_cast<uint64_t>(row + n0) & ~15ull;
            const uint64_t b =
                (reinterpret_cast<uint64_t>(row + n1) + 15) & ~15ull;
            asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                             a),
                         "r"(static_cast<uint32_t>(b - a))
                         : "memory");
          }
        }
      }
    }
  } else {
    // consumer warpgroups: 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid >> 7, t = tid & 127, w4 = t >> 5, lane = t & 31;
    const bool vec2 = (p.N & 1) == 0;   // float2 access is aligned
    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2];
    for (int tt = first; tt < pairs; tt += step) {
      const int m0 = ((tt / nt) * FCL + rank) * FBM, n0 = (tt % nt) * BN;
      const int mrow = m0 + 64 * wg + 16 * w4 + (lane >> 2);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int kt = 0; kt < kts; ++kt) {
        mbar_wait(full + stage, phase);
        if (!p.feed_only) {
          const bf16* ah = reinterpret_cast<const bf16*>(ring +
                                                         stage * C::STAGE) +
                           64 * wg * BK;
          const bf16* al = ah + C::TILE_A;
          const bf16* bh =
              reinterpret_cast<const bf16*>(ring + stage * C::STAGE) +
              2 * C::TILE_A;
          const bf16* bl = bh + C::TILE_B;
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks) {
            const int o = ks * 16;             // 32 bytes per k16 step
            const uint64_t dah = smem_desc(ah + o, WG_LBO, WG_SBO);
            const uint64_t dal = smem_desc(al + o, WG_LBO, WG_SBO);
            const uint64_t dbh = smem_desc(bh + o, WG_LBO, WG_SBO);
            const uint64_t dbl = smem_desc(bl + o, WG_LBO, WG_SBO);
            wgmma_k16<BN>(acc, dah, dbh);
            wgmma_k16<BN>(acc, dah, dbl);
            wgmma_k16<BN>(acc, dal, dbh);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        }
        // the stage is read: free it in both blocks
        if (t == 0) {
#pragma unroll
          for (int c = 0; c < FCL; ++c) mbar_arrive(empty + stage, c);
        }
        if (++stage == C::S) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (!p.feed_only) {
        // q + the tile's products, added in IEEE f32 (the tensor cores'
        // f32 sums lose low bits adding small products onto a large q, so
        // they start from zero); a batch's loads are all in flight before
        // its stores, no chain of dependent round trips
        constexpr int EB = BN / 8 < 16 ? BN / 8 : 16;
#pragma unroll
        for (int j0 = 0; j0 < BN / 8; j0 += EB) {
          float v[4 * EB];
#pragma unroll
          for (int j = 0; j < EB; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = n0 + 8 * (j0 + j) + (lane & 3) * 2;
              const float* src =
                  p.q + static_cast<long long>(mrow + 8 * h) * p.N + n;
              float a0 = 0.0f, a1 = 0.0f;
              if (vec2 && n + 1 < p.N) {
                const float2 w = *reinterpret_cast<const float2*>(src);
                a0 = w.x;
                a1 = w.y;
              } else {
                if (n < p.N) a0 = src[0];
                if (n + 1 < p.N) a1 = src[1];
              }
              v[4 * j + 2 * h] = a0;
              v[4 * j + 2 * h + 1] = a1;
            }
#pragma unroll
          for (int j = 0; j < EB; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = n0 + 8 * (j0 + j) + (lane & 3) * 2;
              float* dst =
                  p.q + static_cast<long long>(mrow + 8 * h) * p.N + n;
              const int i = 4 * (j0 + j) + 2 * h;
              const float a0 = v[4 * j + 2 * h] + acc[i];
              const float a1 = v[4 * j + 2 * h + 1] + acc[i + 1];
              if (vec2 && n + 1 < p.N) {
                *reinterpret_cast<float2*>(dst) = make_float2(a0, a1);
              } else {
                if (n < p.N) dst[0] = a0;
                if (n + 1 < p.N) dst[1] = a1;
              }
            }
        }
      }
    }
  }
  // no block leaves while its peer may still arrive on its barriers
  cluster_sync();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup, without
// linking libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult r;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &r);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &r);
#endif
    if (e == cudaSuccess && r == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(f);
    }
  }
  return fn;
}

// a bf16 tensor map of rank dims (innermost first), 32-deep K-major boxes
// in the 64-byte swizzle that swz() and smem_desc() describe
bool bf16_map(CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the flush's four maps: Gh / Gl (npad, npad) in (BK, FBM) boxes, Dh / Dl
// (KF, B, GROUP) in (BK, bn / FCL, 1) boxes, rows past B reading zeros
bool flush_maps(CUtensorMap* maps, const void* gh, const void* gl,
                const void* dh, const void* dl, int npad, int B, int bn) {
  const cuuint64_t gdims[2] = {static_cast<cuuint64_t>(npad),
                               static_cast<cuuint64_t>(npad)};
  const cuuint64_t gstr[1] = {static_cast<cuuint64_t>(npad) * 2};
  const cuuint32_t gbox[2] = {BK, FBM};
  const cuuint64_t ddims[3] = {GROUP, static_cast<cuuint64_t>(B), KF};
  const cuuint64_t dstr[2] = {GROUP * 2,
                              static_cast<cuuint64_t>(B) * GROUP * 2};
  const cuuint32_t dbox[3] = {BK, static_cast<cuuint32_t>(bn / FCL), 1};
  return bf16_map(maps, gh, 2, gdims, gstr, gbox) &&
         bf16_map(maps + 1, gl, 2, gdims, gstr, gbox) &&
         bf16_map(maps + 2, dh, 3, ddims, dstr, dbox) &&
         bf16_map(maps + 3, dl, 3, ddims, dstr, dbox);
}

template <int BN>
cudaLaunchConfig_t flush_config(int clusters, cudaLaunchAttribute* at,
                                cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * FCL);
  cfg.blockDim = dim3(FTHREADS);
  cfg.dynamicSmemBytes = FlushCfg<BN>::SMEM;
  cfg.stream = s;
  at->id = cudaLaunchAttributeClusterDimension;
  at->val.clusterDim.x = FCL;
  at->val.clusterDim.y = 1;
  at->val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of the flush that fit on the card at once (one block per SM)
template <int BN>
int flush_clusters() {
  static int n = 0;
  if (n == 0) {
    if (set_smem(wg_gemm_kernel_flush<BN>, FlushCfg<BN>::SMEM) !=
        cudaSuccess) {
      return -1;
    }
    cudaLaunchAttribute at;
    const cudaLaunchConfig_t cfg = flush_config<BN>(1, &at, nullptr);
    if (cudaOccupancyMaxActiveClusters(
            &n, reinterpret_cast<const void*>(wg_gemm_kernel_flush<BN>),
            &cfg) != cudaSuccess ||
        n <= 0) {
      n = 0;
      return -1;
    }
  }
  return n;
}

template <int BN>
cudaError_t flush_launch(const CUtensorMap* maps, Flush p, cudaStream_t s) {
  const int clusters = flush_clusters<BN>();
  if (clusters <= 0) return cudaErrorInvalidConfiguration;
  const int pairs = p.M / (FBM * FCL) * ((p.N + BN - 1) / BN);
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg =
      flush_config<BN>(clusters < pairs ? clusters : pairs, &at, s);
  void* args[] = {const_cast<CUtensorMap*>(maps),
                  const_cast<CUtensorMap*>(maps + 1),
                  const_cast<CUtensorMap*>(maps + 2),
                  const_cast<CUtensorMap*>(maps + 3), &p};
  const cudaError_t e = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(wg_gemm_kernel_flush<BN>), args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

cudaError_t flush(const CUtensorMap* maps, int bn, const Flush& p,
                  cudaStream_t s) {
  if (bn == 256) return flush_launch<256>(maps, p, s);
  if (bn == 128) return flush_launch<128>(maps, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Clusters of the flush that the card holds at once, or -1
extern "C" int slim_flush_clusters() { return flush_clusters<256>(); }

// One window's flush alone (q (npad, B) updated in place): the kernel of
// step 3 at tile width bn (256 or 128); feed_only runs the TMA ring with
// no q access and no product, to time the feed.
extern "C" int slim_flush(const void* Gh, const void* Gl, const void* Dh,
                          const void* Dl, const void* perm, const void* has,
                          void* q, int npad, int B, int g0, int nslots,
                          int bn, int feed_only, void* stream) {
  CUtensorMap maps[4];
  if (npad % (FBM * FCL) != 0 ||
      !flush_maps(maps, Gh, Gl, Dh, Dl, npad, B, bn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Flush p{static_cast<const int32_t*>(perm),
                static_cast<const int32_t*>(has), static_cast<float*>(q),
                npad, B, g0, nslots, feed_only};
  return static_cast<int>(
      flush(maps, bn, p, static_cast<cudaStream_t>(stream)));
}

// xT and qT are updated in place; dltx must arrive zeroed.  Gh / Gl are the
// bf16 halves of G; qg holds 512 * B floats, Dh / Dl K_FLUSH * B * 512
// bf16 each.  ngroups entries of perm/has; the last window may be partial.
// The flush runs at tile width flush_bn (256 or 128); *flushes receives the
// number of flush launches enqueued (one a window).
extern "C" int slim_cd_sweep_large(
    const void* G, const void* Gh, const void* Gl, const void* gjT,
    const void* actT, const void* diag, void* xT, void* qT,
    const void* live_in, const void* regsT, const void* perm, const void* has,
    int ngroups, int B, int npad, void* qg, void* Dh, void* Dl,
    void* live_out, void* nit, void* dltx, int flush_bn, void* flushes,
    void* stream) {
  CUtensorMap maps[4];
  if (ngroups * GROUP != npad ||
      !flush_maps(maps, Gh, Gl, Dh, Dl, npad, B, flush_bn)) {
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
  int* nflush = static_cast<int*>(flushes);
  *nflush = 0;
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
      e = flush(maps, flush_bn, Flush{pm, hs, qf, npad, B, g0, slot + 1, 0},
                s);
      if (e != cudaSuccess) return static_cast<int>(e);
      ++*nflush;
    }
  }
  sweep_end_kernel<<<(B + 255) / 256, 256, 0, s>>>(
      1, static_cast<const float*>(live_in), static_cast<const float*>(regsT),
      static_cast<const float*>(dltx), static_cast<float*>(live_out),
      static_cast<float*>(nit), B);
  return static_cast<int>(cudaGetLastError());
}
