// Building blocks of the sweep engines (sweep_large.cu, coordinate-major;
// sweep_panel.cu, row-major), sm_90a: cp.async copies, the 64-byte swizzle
// and wgmma descriptors of K-major bf16 tiles, wgmma m64nNk16 and mma.sync
// m16n8k16 (bf16 in, f32 accumulate), the cp.async-fed wgmma main loop of
// the bf16x3 window products, the group kernel (GS chain + in-group
// product) in both layouts, and the end-of-sweep kernel.
//
// bf16x3: G = Gh + Gl and dx = Dh + Dl in bf16, G . dx ~ Gh.Dh + Gh.Dl +
// Gl.Dh with f32 accumulation (about 2^-17 relative per term, the same
// order as an f32 sum of 512 terms).  The wrapper splits G once per G; the
// group kernel writes Dh / Dl in the (slot, column, coordinate) layout
// (K, B, GW) in both engines, GW the group width (512 for the wide-block
// sweeps, 128 for the whole-array row-major sweep).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 512;       // coordinates per group (wide blocks)
constexpr int CH = 128;          // coordinates per GS sub-chunk
constexpr int KF = 4;            // most groups in a flush window
constexpr int GCOLS = 4;         // columns (warps) per group-kernel block
constexpr int DPITCH = CH + 8;   // bf16 pitch of the staged deltas

// dynamic shared memory of a group kernel of width GW
template <int GW>
constexpr int group_smem() {
  return (CH * CH + GCOLS * GW) * 4 + 2 * 8 * DPITCH * 2;
}

constexpr int BK = 32;           // contraction depth of a wgmma stage

// per-column register k of column b: regs is (B, 5) in layout 0 (row-major
// sweeps) and (5, B) in layout 1 (coordinate-major); k = l1r, l2r, cap, t0,
// optTol
__device__ __forceinline__ float reg(const float* regs, int layout, int k,
                                     int b, int B) {
  return layout == 0 ? regs[b * 5 + k] : regs[k * B + b];
}

// end of sweep: nit = live at sweep start; a column dies when
// sum(dx^2) < optTol or t0 + 1 >= cap
__global__ void sweep_end_kernel(int layout, const float* __restrict__ live_in,
                                 const float* __restrict__ regs,
                                 const float* __restrict__ dltx,
                                 float* __restrict__ live_out,
                                 float* __restrict__ nit, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float lv = live_in[b];
  const float cap = reg(regs, layout, 2, b, B);
  const float t0 = reg(regs, layout, 3, b, B);
  const float tol = reg(regs, layout, 4, b, B);
  const float keep = (dltx[b] < tol ? 0.0f : 1.0f) *
                     ((t0 + 1.0f) < cap ? 1.0f : 0.0f);
  nit[b] = lv;
  live_out[b] = lv * keep;
}

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

template <>
__device__ __forceinline__ void wgmma_k16<256>(float (&d)[128], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
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

// A wgmma product of (64 WGS) x BN block tiles: WGS warpgroups of 64 rows
// each, an S-stage cp.async ring; one wgmma group stays in flight while
// the next tile loads
template <int WGS, int BN, int S>
struct WgCfg {
  static constexpr int THREADS = WGS * 128;
  static constexpr int BM = 64 * WGS, TILE_A = BM * BK, TILE_B = BN * BK;
  static constexpr int STAGE = 2 * (TILE_A + TILE_B);          // bf16
  static constexpr int SMEM = S * STAGE * 2 + 512;             // + alignment
};

// the dynamic shared memory of a wgmma block, aligned to the 512 bytes over
// which the swizzle repeats
__device__ __forceinline__ bf16* wg_smem(unsigned char* raw) {
  return reinterpret_cast<bf16*>(raw + ((512 - (smem_addr(raw) & 511)) & 511));
}

// slots[0..n) = the slots s < nslots of the window at g0 whose has[g0 + s]
// is set, in order; returns n to every thread of the block
__device__ __forceinline__ int window_slots(const int32_t* has, int g0,
                                            int nslots, int* slots) {
  __shared__ int n_s;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int s = 0; s < nslots; ++s) {
      if (has[g0 + s]) slots[n++] = s;
    }
    n_s = n;
  }
  __syncthreads();
  return n_s;
}

// acc (this warpgroup's 64 rows of the block tile, wgmma accumulator
// layout) = sum over k-tiles kt < ntiles of A_kt . B_kt^T in bf16x3, A the
// (64 WGS) x BK tile of the block rows and B the BN x BK tile, both
// K-major in swz() layout; load(kt, ah, al, bh, bl) issues the cp.async
// copies of tile kt's hi / lo halves into a stage
template <int WGS, int BN, int S, typename Load>
__device__ __forceinline__ void wg_mainloop(bf16* sm, int ntiles,
                                            const Load& load,
                                            float (&acc)[BN / 2]) {
  using C = WgCfg<WGS, BN, S>;
  const int wg = threadIdx.x >> 7;
  auto stage = [&](int kt) {
    bf16* ah = sm + (kt % S) * C::STAGE;
    load(kt, ah, ah + C::TILE_A, ah + 2 * C::TILE_A,
         ah + 2 * C::TILE_A + C::TILE_B);
  };
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int st = 0; st < S - 2; ++st) {
    if (st < ntiles) stage(st);
    cp_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_wait<S - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // tile kt has landed, and every warpgroup's wgmma of tile kt - 2 is
    // done, so its stage takes tile kt + S - 2
    __syncthreads();
    if (kt + S - 2 < ntiles) stage(kt + S - 2);
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

// GS chain and in-group propagation of the group of GW coordinates at
// position pos, one warp per column, GCOLS columns per block.  x / gj / act
// are (B, npad) in ROW_MAJOR, else (npad, B), and regs (B, 5) or (5, B) to
// match.  Column b's q tile of the group is qt[b * qsb + r * qsr], r < GW,
// with qt offset by perm[pos] * GW coordinates when qperm is set (a tile
// read straight from q).  The deltas update x in place and go, split into
// bf16 halves, to D[slot] (B, GW).  At GW = CH the group is one sub-chunk
// and there is no in-group product.
//
// Lane l holds q_j for j = l mod 32 of the sub-chunk in registers; each
// lane evaluates its own coordinate's update and the step's owner lane is
// broadcast with __shfl_sync, so every q_j still receives its deltas in the
// order of i, as in the plain chain.  The division by d_i + l2 is a
// multiply by its reciprocal, made before the chain.  The 128 x 128
// diagonal block sits in shared memory (cp.async; the next sub-chunk's
// block lands while the in-group product runs).  The in-group product
// qt[later] += G[later, sub] . dx has the block's GCOLS columns as N, so it
// runs on mma.sync m16n8k16 fed from registers.
template <bool ROW_MAJOR, int GW = GROUP>
__global__ void __launch_bounds__(GCOLS * 32)
group_kernel(const float* __restrict__ G, const bf16* __restrict__ Gh,
             const bf16* __restrict__ Gl, const float* __restrict__ gj,
             const int8_t* __restrict__ act, const float* __restrict__ diag,
             float* __restrict__ x, const float* __restrict__ qt,
             long long qsb, long long qsr, int qperm,
             const float* __restrict__ live, const float* __restrict__ regs,
             const int32_t* __restrict__ perm,
             const int32_t* __restrict__ has, int pos, int slot, int B,
             int npad, bf16* __restrict__ Dh, bf16* __restrict__ Dl,
             float* __restrict__ dltx) {
  if (has[pos] == 0) return;
  extern __shared__ __align__(16) float gsm[];
  float* gcc = gsm;                       // [i][j] diagonal block
  float* qs = gcc + CH * CH;              // [column][GW] q tile
  bf16* dh = reinterpret_cast<bf16*>(qs + GCOLS * GW);  // [n][k] deltas
  bf16* dl = dh + 8 * DPITCH;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x * GCOLS + w;
  const bool valid = b < B;
  const int base = perm[pos] * GW;
  // element (coordinate c, column b) of x / gj / act
  auto at = [&](int c) {
    return ROW_MAJOR ? static_cast<long long>(b) * npad + c
                     : static_cast<long long>(c) * B + b;
  };
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int e = tid; e < 8 * DPITCH; e += GCOLS * 32) {
    dh[e] = zero;       // columns GCOLS..7 of the mma's n8 stay zero
    dl[e] = zero;
  }
  float lv = 0.0f, l1 = 0.0f, l2 = 0.0f;
  if (valid) {
    lv = live[b];
    l1 = reg(regs, ROW_MAJOR ? 0 : 1, 0, b, B);
    l2 = reg(regs, ROW_MAJOR ? 0 : 1, 1, b, B);
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
  const float* qcol =
      qt + (qperm ? base * qsr : 0) + static_cast<long long>(b) * qsb;
#pragma unroll
  for (int t = 0; t < GW / 32; ++t) {
    const int r = lane + 32 * t;
    qs[w * GW + r] = valid ? qcol[r * qsr] : 0.0f;
  }
  float dsum = 0.0f;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  for (int o = 0; o < GW; o += CH) {
    const int c0 = base + o;
    float xr[4], gr[4], okr[4], dr[4], rinv[4], qr[4], dxr[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = lane + 32 * t;
      const long long a = at(c0 + j);
      xr[t] = valid ? x[a] : 0.0f;
      gr[t] = valid ? gj[a] : 0.0f;
      okr[t] = valid ? static_cast<float>(act[a]) * lv : 0.0f;
      dr[t] = diag[c0 + j];
      rinv[t] = 1.0f / (dr[t] + l2);
      dxr[t] = 0.0f;
    }
    cp_wait<0>();
    __syncthreads();   // gcc staged; qs holds the previous products
#pragma unroll
    for (int t = 0; t < 4; ++t) qr[t] = qs[w * GW + o + lane + 32 * t];
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
    if (o + CH < GW) stage_gcc(c0 + CH);   // lands during the product
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
            (static_cast<long long>(slot) * B + b) * GW + o + j;
        x[at(c0 + j)] = xr[t];
        Dh[a] = hi;
        Dl[a] = lo;
      }
    }
    __syncthreads();   // staged deltas complete
    // qs[later rows] += G[later rows, sub-chunk cols] . dx on the tensor
    // cores (mma.sync), one m16 row tile per warp at a time, the block's
    // columns as n8
    const int r0 = o + CH;
    for (int mt = w; mt < (GW - r0) / 16; mt += GCOLS) {
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
        qs[c2 * GW + lr] += acc[0];
        qs[c2 * GW + lr + 8] += acc[2];
      }
      if (c2 + 1 < GCOLS) {
        qs[(c2 + 1) * GW + lr] += acc[1];
        qs[(c2 + 1) * GW + lr + 8] += acc[3];
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
