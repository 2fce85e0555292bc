// Ragged compaction of a solved block for the harvest (Hopper, sm_90a).
//
// Replaces: slim_tpu/ops/pallas_pack.py · _pack_kernel / pallas_pack.
// Contract (cd_kernel.pack_flat): the entries x[b, k] > eps of row b land at
// [off[b], off[b] + cnt[b]) in ascending k, as (value, column id) pairs;
// positions >= Tpad are dropped.  The caller zero-fills vals/ids, so the
// tail [T, Tpad) stays 0.
//
// What bounds it on the H100: reading x once (B*K*4 bytes, 117 MB for a
// (1024, 28672) block, ~35 us at 3.35 TB/s); the writes are only the
// nonzeros.  The TPU kernel built in-group ranks and group prefixes with
// one-hot MXU products; here a thread counts its own entries and one block
// scan per tile places them.
//
// Design: one block of 512 threads per row b walks the row in tiles of
// 8,192 columns (a 28,672-wide row takes four).  In a tile, thread t issues
// its four 16-byte loads up front: load u covers the columns
// k0 + 4 (512 u + t) .. + 3, so each load instruction of a warp reads 512
// consecutive bytes, and the tile's columns ascend in the order (u, t,
// element).  Each thread counts its entries per load (0..4), packs the
// four counts into 16-bit fields of one 64-bit word (a field's tile total
// is at most 2,048), and one block-wide exclusive scan of that word (warp
// __shfl_up_sync, then the 16 warp totals) gives every load's prefix at
// once; a load's base is the tile totals of the loads before it.  Values
// and ids are written from registers, bit for bit.  A K that is not a
// multiple of 4, or an x that is not 16-byte aligned, takes the same
// kernel with scalar loads (VEC = false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int LOADS = 4;                    // 16-byte loads per thread
constexpr int TILE = THREADS * 4 * LOADS;   // columns per tile

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
pack_kernel(const float* __restrict__ x, const int32_t* __restrict__ off,
            int K, int Tpad, float eps, float* __restrict__ vals,
            int32_t* __restrict__ ids) {
  __shared__ unsigned long long warp_incl[NWARPS];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const float* row = x + static_cast<long long>(blockIdx.x) * K;
  int run = off[blockIdx.x];
  for (int k0 = 0; k0 < K; k0 += TILE) {
    float v[LOADS][4];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int c = k0 + 4 * (u * THREADS + tid);
      if (VEC) {
        // K % 4 == 0: a load is wholly inside the row or wholly past it
        const float4 f = c < K ? *reinterpret_cast<const float4*>(row + c)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        v[u][0] = f.x;
        v[u][1] = f.y;
        v[u][2] = f.z;
        v[u][3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[u][e] = c + e < K ? row[c + e] : 0.0f;
      }
    }
    unsigned bits[LOADS];
    unsigned long long mine = 0;
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int c = k0 + 4 * (u * THREADS + tid);
      bits[u] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e < K && v[u][e] > eps) bits[u] |= 1u << e;
      }
      mine |= static_cast<unsigned long long>(__popc(bits[u])) << (16 * u);
    }
    // block-wide inclusive scan of the packed counts
    unsigned long long incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) warp_incl[wid] = incl;
    __syncthreads();
    if (wid == 0) {
      unsigned long long s = lane < NWARPS ? warp_incl[lane] : 0ull;
#pragma unroll
      for (int d = 1; d < NWARPS; d <<= 1) {
        const unsigned long long t = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += t;
      }
      if (lane < NWARPS) warp_incl[lane] = s;
    }
    __syncthreads();
    const unsigned long long excl =
        (wid > 0 ? warp_incl[wid - 1] : 0ull) + incl - mine;
    const unsigned long long total = warp_incl[NWARPS - 1];
    int base = run;
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int c = k0 + 4 * (u * THREADS + tid);
      int pos = base + static_cast<int>((excl >> (16 * u)) & 0xffffu);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (bits[u] & (1u << e)) {
          if (pos >= 0 && pos < Tpad) {
            vals[pos] = v[u][e];
            ids[pos] = c + e;
          }
          ++pos;
        }
      }
      base += static_cast<int>((total >> (16 * u)) & 0xffffu);
    }
    run = base;
    __syncthreads();  // warp_incl is rewritten by the next tile
  }
}

}  // namespace

extern "C" int slim_pack(const void* x, const void* off, int B, int K,
                         int Tpad, float eps, void* vals, void* ids,
                         void* stream) {
  if (B > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    const int32_t* of = static_cast<const int32_t*>(off);
    float* vf = static_cast<float*>(vals);
    int32_t* id = static_cast<int32_t*>(ids);
    // 16-byte loads need every row start 16-byte aligned
    const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (vec) {
      pack_kernel<true><<<B, THREADS, 0, s>>>(xf, of, K, Tpad, eps, vf, id);
    } else {
      pack_kernel<false><<<B, THREADS, 0, s>>>(xf, of, K, Tpad, eps, vf, id);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
