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
//   * Products in bf16x3 on the tensor cores: G = Gh + Gl and dx = Dh + Dl
//     in bf16, G . dx ~ Gh.Dh + Gh.Dl + Gl.Dh with f32 accumulation (about
//     2^-17 relative per term, the same order as an f32 sum of 512 terms).
//     The wrapper splits G once per G (loop-invariant); the group kernel
//     writes Dh / Dl.  The f32 G feeds only the GS chain's diagonal block.
//   * wg_gemm_kernel (load and flush): wgmma m64nNk16 (bf16 in, f32
//     accumulate), both operands K-major in shared memory in the 64-byte
//     swizzle, fed by a cp.async ring; one wgmma group stays in flight while
//     the next tile lands.  The contraction walks the window's slots with
//     work through perm/has.  The flush takes 128 x 128 tiles (1,792 blocks
//     at B 1024, npad 28672), the load 64 x 64 tiles (128 blocks).
//   * group_kernel: one warp per column, four columns per block (256 blocks
//     at B 1024).  Lane l holds q_j for j = l mod 32 of the sub-chunk in
//     registers; each lane evaluates its own coordinate's update and the
//     step's owner lane is broadcast with __shfl_sync, so every q_j still
//     receives its deltas in the order of i, as in _gs_chain.  The
//     division by d_i + l2 is a multiply by its reciprocal, made before the
//     chain: the IEEE division on the chain's critical path cost ~40% of
//     the launch (PERF.md); x moves by an ulp, not a sweep count.
//     The 128 x 128 diagonal block sits in shared memory (cp.async; the
//     next sub-chunk's block lands while the in-group product runs).  The
//     in-group product's N is the block's four columns, so it runs on
//     mma.sync m16n8k16 fed from registers: wgmma's 64-row tiles would need
//     the group's G rows (up to 196 KB) staged in shared memory per block.
// One ctypes call enqueues the sweep (a load and a group launch per
// position, a flush per window); every launch reads perm/has from device
// memory, so no host sync is needed and a skipped group costs two empty
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

constexpr int GROUP = 512;       // coordinates per group
constexpr int CH = 128;          // coordinates per GS sub-chunk
constexpr int KF = 4;            // groups per flush window
constexpr int GCOLS = 4;         // columns (warps) per group-kernel block
constexpr int DPITCH = CH + 8;   // bf16 pitch of the staged deltas
constexpr int GROUP_SMEM =
    (CH * CH + GCOLS * GROUP) * 4 + 2 * 8 * DPITCH * 2;

constexpr int BK = 32;           // contraction depth of a wg_gemm stage

// A staged tile row holds BK = 32 bf16 (four 16-byte chunks); chunk c of
// row r sits at c ^ ((r >> 1) & 3): wgmma's 64-byte swizzle, with the tiles
// aligned to 512 bytes
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ ((r >> 1) & 3)) << 3);
}

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a . b for one m16n8k16 tile (bf16 operands, f32 accumulator)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

// d (64 x N, f32, the wgmma accumulator layout) += A . B^T for one k16
// step, A (64 x 16) and B (N x 16) bf16 in shared memory, both K-major,
// described by da / db
template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t da,
                                          uint64_t db);

template <>
__device__ __forceinline__ void wgmma_k16<64>(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_k16<128>(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// shared-memory matrix descriptor of a K-major tile in the 64-byte swizzle
// (layout type 2) that swz() lays out: 64-byte rows, 8-row groups sbo = 512
// bytes apart; the start address steps 32 bytes per k16 inside a row
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo,
                                              int sbo) {
  return ((static_cast<uint64_t>(smem_addr(p)) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
}

constexpr int WG_LBO = 16, WG_SBO = 8 * BK * 2;

// The Gemm contract on wgmma: (64 WGS) x BN block tiles, WGS warpgroups
// of 64 rows each, an S-stage cp.async ring; one wgmma group stays in
// flight while the next tile loads
template <int WGS, int BN, int S>
struct WgCfg {
  static constexpr int THREADS = WGS * 128;
  static constexpr int BM = 64 * WGS, TILE_A = BM * BK, TILE_B = BN * BK;
  static constexpr int STAGE = 2 * (TILE_A + TILE_B);          // bf16
  static constexpr int SMEM = S * STAGE * 2 + 512;             // + alignment
};

template <int WGS, int BN, int S>
__global__ void __launch_bounds__(WGS * 128) wg_gemm_kernel(Gemm p) {
  using C = WgCfg<WGS, BN, S>;
  __shared__ int slots[KF];
  __shared__ int nact_s;
  const int tid = threadIdx.x;
  if (tid == 0) {
    int n = 0;
    for (int s = 0; s < p.nslots; ++s) {
      if (p.has[p.g0 + s]) slots[n++] = s;
    }
    nact_s = n;
  }
  __syncthreads();
  const int nact = nact_s;
  if (p.gate >= 0 ? p.has[p.gate] == 0 : nact == 0) return;

  extern __shared__ __align__(128) unsigned char wsm[];
  // the swizzle repeats every 512 bytes: align the tiles to it
  bf16* sm = reinterpret_cast<bf16*>(
      wsm + ((512 - (smem_addr(wsm) & 511)) & 511));
  const int wg = tid >> 7, t = tid & 127;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * BN;
  const int row0 = p.rowpos >= 0 ? p.perm[p.rowpos] * GROUP : 0;
  const long long dslot = static_cast<long long>(p.N) * GROUP;
  const int ntiles = nact * (GROUP / BK);

  auto load = [&](int kt, int st) {
    bf16* ah = sm + st * C::STAGE;
    bf16* al = ah + C::TILE_A;
    bf16* bh = al + C::TILE_A;
    bf16* bl = bh + C::TILE_B;
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
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int st = 0; st < S - 2; ++st) {
    if (st < ntiles) load(st, st);
    cp_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_wait<S - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // tile kt has landed, and every warpgroup's wgmma of tile kt - 2 is
    // done, so its stage takes tile kt + S - 2
    __syncthreads();
    if (kt + S - 2 < ntiles) load(kt + S - 2, (kt + S - 2) % S);
    cp_commit();
    const bf16* ah = sm + (kt % S) * C::STAGE + swz(64 * wg, 0);
    const bf16* al = ah + C::TILE_A;
    const bf16* bh = sm + (kt % S) * C::STAGE + 2 * C::TILE_A;
    const bf16* bl = bh + C::TILE_B;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int o = ks * 16;                 // 32 bytes per k16 step
      const uint64_t dah = smem_desc(ah + o, WG_LBO, WG_SBO);
      const uint64_t dal = smem_desc(al + o, WG_LBO, WG_SBO);
      const uint64_t dbh = smem_desc(bh + o, WG_LBO, WG_SBO);
      const uint64_t dbl = smem_desc(bl + o, WG_LBO, WG_SBO);
      wgmma_k16<BN>(acc, dah, dbh);
      wgmma_k16<BN>(acc, dah, dbl);
      wgmma_k16<BN>(acc, dal, dbh);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  cp_wait<0>();

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

// Dynamic shared memory above 48 KB, and the largest shared-memory carveout
// so that two blocks fit on an SM
template <typename F>
cudaError_t set_smem(F* kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
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

// GS chain and in-group propagation of the group at position pos, one warp
// per column.  qg holds the group's corrected q tile (512, B); the deltas
// update xT in place and go, split into bf16 halves, to D[slot] (B, 512).
__global__ void __launch_bounds__(GCOLS * 32)
group_kernel(const float* __restrict__ G, const bf16* __restrict__ Gh,
             const bf16* __restrict__ Gl, const float* __restrict__ gjT,
             const int8_t* __restrict__ actT, const float* __restrict__ diag,
             float* __restrict__ xT, const float* __restrict__ qg,
             const float* __restrict__ live, const float* __restrict__ regsT,
             const int32_t* __restrict__ perm,
             const int32_t* __restrict__ has, int pos, int slot, int B,
             int npad, bf16* __restrict__ Dh,
             bf16* __restrict__ Dl, float* __restrict__ dltx) {
  if (has[pos] == 0) return;
  extern __shared__ __align__(16) float gsm[];
  float* gcc = gsm;                       // [i][j] diagonal block
  float* qs = gcc + CH * CH;              // [column][512] q tile
  bf16* dh = reinterpret_cast<bf16*>(qs + GCOLS * GROUP);  // [n][k] deltas
  bf16* dl = dh + 8 * DPITCH;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x * GCOLS + w;
  const bool valid = b < B;
  const int base = perm[pos] * GROUP;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int e = tid; e < 8 * DPITCH; e += GCOLS * 32) {
    dh[e] = zero;       // columns GCOLS..7 of the mma's n8 stay zero
    dl[e] = zero;
  }
  float lv = 0.0f, l1 = 0.0f, l2 = 0.0f;
  if (valid) {
    lv = live[b];
    l1 = reg(regsT, 1, 0, b, B);
    l2 = reg(regsT, 1, 1, b, B);
  }
  // the diagonal block of G for a sub-chunk, staged asynchronously
  auto stage_gcc = [&](int c0) {
#pragma unroll 4
    for (int e = tid * 4; e < CH * CH; e += GCOLS * 32 * 4) {
      cp16(gcc + e,
           G + static_cast<long long>(c0 + e / CH) * npad + c0 + e % CH, 16);
    }
    cp_commit();
  };
  stage_gcc(base);
#pragma unroll
  for (int t = 0; t < GROUP / 32; ++t) {
    const int r = lane + 32 * t;
    qs[w * GROUP + r] = valid ? qg[static_cast<long long>(r) * B + b] : 0.0f;
  }
  float dsum = 0.0f;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  for (int o = 0; o < GROUP; o += CH) {
    const int c0 = base + o;
    float xr[4], gr[4], okr[4], dr[4], rinv[4], qr[4], dxr[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = lane + 32 * t;
      const long long a = static_cast<long long>(c0 + j) * B + b;
      xr[t] = valid ? xT[a] : 0.0f;
      gr[t] = valid ? gjT[a] : 0.0f;
      okr[t] = valid ? static_cast<float>(actT[a]) * lv : 0.0f;
      dr[t] = diag[c0 + j];
      rinv[t] = 1.0f / (dr[t] + l2);
      dxr[t] = 0.0f;
    }
    cp_wait<0>();
    __syncthreads();   // gcc staged; qs holds the previous products
#pragma unroll
    for (int t = 0; t < 4; ++t) qr[t] = qs[w * GROUP + o + lane + 32 * t];
    if (valid && lv != 0.0f) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int s = 0; s < 32; ++s) {
          const int i = 32 * t + s;
          // every lane evaluates its own coordinate; lane s's is step i's
          // (x_i = max(gj_i - q_i + d_i x_i - l1, 0) / (d_i + l2), the
          // division by a reciprocal made before the chain)
          const float num = gr[t] - qr[t] + dr[t] * xr[t];
          const float cand = fmaxf(num - l1, 0.0f) * rinv[t];
          const float delta = __shfl_sync(0xffffffffu,
                                          okr[t] * (cand - xr[t]), s);
          const float* grow = gcc + i * CH + lane;
#pragma unroll
          for (int u = t; u < 4; ++u) {
            if (32 * u + lane > i) qr[u] += delta * grow[32 * u];
          }
          if (lane == s) {
            xr[t] += delta;
            dxr[t] = delta;
          }
        }
      }
    }
    __syncthreads();   // every chain is done with gcc
    if (o + CH < GROUP) stage_gcc(c0 + CH);   // lands during the product
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = lane + 32 * t;
      const bf16 hi = __float2bfloat16_rn(dxr[t]);
      const bf16 lo = __float2bfloat16_rn(dxr[t] - __bfloat162float(hi));
      dh[w * DPITCH + j] = hi;
      dl[w * DPITCH + j] = lo;
      dsum += dxr[t] * dxr[t];
      if (valid) {
        const long long a =
            (static_cast<long long>(slot) * B + b) * GROUP + o + j;
        xT[static_cast<long long>(c0 + j) * B + b] = xr[t];
        Dh[a] = hi;
        Dl[a] = lo;
      }
    }
    __syncthreads();   // staged deltas complete
    // qg[later rows] += G[later rows, sub-chunk cols] . dx on the tensor
    // cores (mma.sync), one m16 row tile per warp at a time, the block's
    // columns as n8
    const int r0 = o + CH;
    for (int mt = w; mt < (GROUP - r0) / 16; mt += GCOLS) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const long long ra =
          static_cast<long long>(base + r0 + mt * 16 + g) * npad;
      const long long rb = ra + 8LL * npad;
#pragma unroll
      for (int kk = 0; kk < CH; kk += 16) {
        const int col = c0 + kk + c2;
        const uint32_t ah[4] = {ld32(Gh + ra + col), ld32(Gh + rb + col),
                                ld32(Gh + ra + col + 8),
                                ld32(Gh + rb + col + 8)};
        const uint32_t al[4] = {ld32(Gl + ra + col), ld32(Gl + rb + col),
                                ld32(Gl + ra + col + 8),
                                ld32(Gl + rb + col + 8)};
        const int kb = g * DPITCH + kk + c2;
        const uint32_t bh0 = ld32(dh + kb), bh1 = ld32(dh + kb + 8);
        const uint32_t bl0 = ld32(dl + kb), bl1 = ld32(dl + kb + 8);
        mma(acc, ah, bh0, bh1);
        mma(acc, ah, bl0, bl1);
        mma(acc, al, bh0, bh1);
      }
      const int lr = r0 + mt * 16 + g;
      if (c2 < GCOLS) {
        qs[c2 * GROUP + lr] += acc[0];
        qs[c2 * GROUP + lr + 8] += acc[2];
      }
      if (c2 + 1 < GCOLS) {
        qs[(c2 + 1) * GROUP + lr] += acc[1];
        qs[(c2 + 1) * GROUP + lr + 8] += acc[3];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
  }
  if (valid && lane == 0) dltx[b] += dsum;
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
    const cudaError_t e = set_smem(group_kernel, GROUP_SMEM);
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
    group_kernel<<<(B + GCOLS - 1) / GCOLS, GCOLS * 32, GROUP_SMEM, s>>>(
        static_cast<const float*>(G), gh, gl, static_cast<const float*>(gjT),
        static_cast<const int8_t*>(actT), static_cast<const float*>(diag),
        static_cast<float*>(xT), qgf, static_cast<const float*>(live_in),
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
